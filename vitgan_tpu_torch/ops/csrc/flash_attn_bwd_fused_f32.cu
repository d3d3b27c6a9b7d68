// Flash-attention backward dQ, dK and dV in one sweep in f32, `dot` and `l2`
// scores, for Hopper (sm_90a): flash_f32.cuh's k-block kernel
// (flash_bwd_kv_f32_kernel, FUSED = true), TF32 products on mma.sync.
// Replaces the TPU kernel `_flash_bwd_fused_kernel` / `_flash_backward_fused`
// (vitgan_tpu/ops/attention.py:507-621, pallas_call at :606) at f32 inputs:
// five products a tile.  dQ sums over a head's 64-key blocks, which the TPU
// kernel adds in sequential grid order; here the key blocks of a head add in
// key-block order on one int32 flag per (batch*head, 64-query tile), each
// block's place taken from an atomic ticket, one more int32 after the flags;
// this entry zeroes them where a head has more than one key block.  So dQ is
// bit-deterministic, and the launch finishes in any dispatch order.
//
// Bound on this card (4-byte operands): five products of 2 N^2 Dh flops a
// head at 494.7 TFLOP/s TF32 against q/k/v/dO read and dQ, dK, dV written
// (7 N Dh 4 bytes) and the rows at 3.35 TB/s; at the v1 generator's shape
// (128 x 4 heads, 32 tokens, Dh 96) the bytes bound it.
#include "flash_f32.cuh"

// q, k, v, dout: (bh, n, d) f32, contiguous, 16-byte aligned, d a multiple of
// 4, 4 <= d <= 128; lse (natural log) and delta: (bh, n) f32; dq, dk, dv:
// (bh, n, d) f32.  dq_acc: an f32 scratch buffer of dq's shape, and dq_order
// an int32 scratch buffer of bh * ceil(n / 64) flags and the ticket after
// them (zeroed here), both needed past one key block (64 keys).  mode 0
// `dot`, 1 `l2`.  The bf16 entry's signature: its `l2` persistent grid is
// taken and not read.
extern "C" int flash_attn_bwd_fused_f32(const void* q, const void* k, const void* v,
                                        const void* dout, const void* lse, const void* delta,
                                        void* dq, void* dk, void* dv, void* dq_acc,
                                        void* dq_order, int bh, int n, int d, float inv_scale,
                                        int mode, int, void* stream) {
  using namespace vk::f32;
  if (!shape_ok(bh, n, d) || (mode != vk::kDot && mode != vk::kL2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ntiles = (n + TILE - 1) / TILE, stages = ntiles > 1 ? 2 : 1;
  if (ntiles > 1 && (dq_acc == nullptr || dq_order == nullptr)) return (int)cudaErrorInvalidValue;
  if (ntiles > 1) {
    const cudaError_t err =
        cudaMemsetAsync(dq_order, 0, ((long)bh * ntiles + 1) * sizeof(uint32_t), s);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(ntiles * bh);  // in the ticket's order (flash_f32.cuh)
  const float sl = inv_scale * LOG2E;
  return by_width(d, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    const int floats = kv_floats<DP, true>(stages);
    auto go = [&](auto kernel) {
      return launch(kernel, grid, floats, s, q, k, v, dout, lse, delta, dk, dv, dq_acc, dq,
                    dq_order, n, d, sl, inv_scale);
    };
    return mode == vk::kDot ? go(flash_bwd_kv_f32_kernel<DP, vk::kDot, true>)
                            : go(flash_bwd_kv_f32_kernel<DP, vk::kL2, true>);
  });
}
