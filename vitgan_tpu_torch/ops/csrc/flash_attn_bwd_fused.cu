// Flash-attention backward dQ, dK and dV in one sweep, `dot` and `l2` scores,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel `_flash_bwd_fused_kernel` / `_flash_backward_fused`
// (vitgan_tpu/ops/attention.py:507-621, launched at :606): five products a
// tile instead of the two-pass route's seven.  dQ sums over a head's key
// blocks, which the TPU kernel adds in sequential grid order; here the key
// blocks of a head add in key-block order on one int32 flag per (batch*head,
// 64-query tile), each block's or unit's place in that order taken from an
// atomic ticket, one more int32 after the flags; this entry zeroes them all
// where a head has more than one key block.  So dQ is bit-deterministic in
// both modes, as the TPU kernel's is, and the launch finishes in any
// dispatch order.
//   - `dot`: the k-block kernel of flash_attn_bwd.cuh with FUSED = true (the
//     wgmma/TMA kernel, 128 keys a block); the last k-block scales the sum by
//     inv_scale and stores bf16 dQ itself.
//   - `l2`: the persistent single pass of flash_l2_bwd.cuh
//     (flash_bwd_fused_l2_kernel), which reads and writes the unpadded (B, H,
//     N, 108) tensors of the v1 discriminator: at N <= 64 a unit is a whole
//     head and dQ = 2 inv_scale (dS K - rowsum(dS) q) is finished in the
//     block (no scratch, no memset); past 64 keys the last 64-key block
//     finishes it.
//
// Bound on this card.  At the highres128 generator's shape (32*6 heads,
// 1,024 tokens, Dh 64) a launch does five products of 2*N*N*Dh flops per
// head, 1.29e11 flops, on 178 MB of q/k/v/dO/dq/dk/dv and rows: 0.13 ms of
// tensor-core time against 0.05 ms of HBM time.  The `dot` kernel's dQ
// additions are N/128 * N * Dh per head (1.0e8 at this shape): the first
// k-block's tile stored, the middle ones' added four floats a RED through
// the L2, the last one's read back with the sum and stored as bf16.  At the
// v1 discriminator's `l2` shape (256*4 heads, 50 tokens, Dh 108) 89 MB of
// q/k/v/dO/dq/dk/dv and rows bound it (0.0265 ms) against 1.4e9 flops.
//
// ptxas -v (sm_90a, CUDA 12.8): the `dot` instantiations launch at 168
// registers a thread (the producer warpgroup drops to 40, the consumers take
// 232 by setmaxnreg); at DP 80-128 32 bytes of spill stores and 44 of loads
// (the last k-block's sums of a 128-column tile) and wgmmas serialised for
// want of registers (C7512), at DP <= 64 neither; dynamic shared memory
// 151,128 bytes at DP <= 64, 165,928 at DP 80-128.  The `l2` kernel: PERF.md.
#include "flash_attn_bwd.cuh"
#include "flash_l2_bwd.cuh"

// q, k, v, dout: (bh, n, d) bf16, contiguous; `dot`: 16-byte aligned, d a
// multiple of 8 and at most 128; `l2`: 8-byte aligned, d a multiple of 4 and
// at most 128, `grid` the persistent blocks (ops/attention.l2_grid).  lse
// (natural log) and delta: (bh, n) f32.  dq, dk, dv: (bh, n, d) bf16.
// dq_acc: an f32 scratch buffer of dq's shape, and dq_order an int32 scratch
// buffer of bh * ceil(n / 64) flags and the ticket after them (zeroed here),
// both needed past one key block (128 keys for `dot`, 64 for `l2`).
// inv_scale multiplies q.k (`dot`) or the distance; mode 0 `dot`, 1 `l2`.
extern "C" int flash_attn_bwd_fused(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dq, void* dk, void* dv, void* dq_acc, void* dq_order,
                                    int bh, int n, int d, float inv_scale, int mode, int grid,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (n + 63) / 64;
  const int kblocks = mode == vk::kDot ? (n + vk::bwd::wg::KEYS - 1) / vk::bwd::wg::KEYS : tiles;
  if (kblocks > 1 && (dq_acc == nullptr || dq_order == nullptr)) return (int)cudaErrorInvalidValue;
  if (kblocks > 1) cudaMemsetAsync(dq_order, 0, ((long)bh * tiles + 1) * sizeof(uint32_t), s);
  switch (mode) {
    case vk::kDot:
      if (d % 8 != 0) return (int)cudaErrorInvalidValue;
      return vk::bwd::wg::dispatch<true>(q, k, v, dout, lse, delta, dk, dv, dq_acc, dq, dq_order,
                                         bh, n, d, inv_scale, s);
    case vk::kL2:
      return vk::l2::dispatch<vk::l2::kFused>(q, k, v, dout, lse, delta, dq, dk, dv, dq_acc,
                                              dq_order, bh, n, d, inv_scale, grid, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
