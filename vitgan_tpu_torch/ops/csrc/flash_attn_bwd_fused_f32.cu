// Flash-attention backward dQ, dK and dV in one sweep in f32, `dot` and `l2`
// scores, for Hopper (sm_90a): flash_f32_bwd.cuh's k-block kernel
// (flash_bwd_kv_tf32_kernel, FUSED = true) on TF32 wgmma.
// Replaces the TPU kernel `_flash_bwd_fused_kernel` / `_flash_backward_fused`
// (vitgan_tpu/ops/attention.py:507-621, pallas_call at :606) at f32 inputs:
// five products a tile.  dQ sums over a head's key blocks (128 keys at Dh <=
// 64, 64 above), which the TPU kernel adds in sequential grid order; here
// the key blocks of a head add in key-block order on one int32 flag per
// (batch*head, query tile), each block's place taken from an atomic ticket,
// one more int32 after the flags, in groups of 32 heads; this entry zeroes
// them where a head has more than one key block.  So dQ is
// bit-deterministic, and the launch finishes in any dispatch order.
//
// Bound on this card (4-byte operands): five products of 2 N^2 Dh flops a
// head at 494.7 TFLOP/s TF32 against q/k/v/dO read and dQ, dK, dV written
// (7 N Dh 4 bytes) and the rows at 3.35 TB/s; at highres256p4's G (8 x 6
// heads of 4,096 tokens, Dh 64) 1.04 ms of products, at the v1 generator's
// shape (128 x 4 heads, 32 tokens, Dh 96) the bytes bound it.
#include "flash_f32_bwd.cuh"

// q, k, v, dout: (bh, n, d) f32, contiguous, 16-byte aligned, d a multiple of
// 4, 4 <= d <= 128; lse (natural log) and delta: (bh, n) f32; dq, dk, dv:
// (bh, n, d) f32.  dq_acc: an f32 scratch buffer of dq's shape, and dq_order
// an int32 scratch buffer of bh * ceil(n / tile) flags and the ticket after
// them (zeroed here), both needed past one key block
// (ops/attention.fused_dq_schedule).  mode 0 `dot`, 1 `l2`.  The bf16
// entry's signature: its `l2` persistent grid is taken and not read.
extern "C" int flash_attn_bwd_fused_f32(const void* q, const void* k, const void* v,
                                        const void* dout, const void* lse, const void* delta,
                                        void* dq, void* dk, void* dv, void* dq_acc,
                                        void* dq_order, int bh, int n, int d, float inv_scale,
                                        int mode, int, void* stream) {
  return vk::f32bwd::dispatch<true>(q, k, v, dout, lse, delta, dk, dv, dq_acc, dq, dq_order, bh,
                                    n, d, inv_scale, mode, static_cast<cudaStream_t>(stream));
}
