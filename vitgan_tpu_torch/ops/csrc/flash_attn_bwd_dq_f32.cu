// Flash-attention backward dQ in f32, `dot` and `l2` scores, for Hopper
// (sm_90a): flash_f32.cuh's q-block kernel (flash_bwd_dq_f32_kernel), TF32
// products on mma.sync.  Replaces the TPU kernels `_flash_bwd_dq_kernel` and
// `_flash_bwd_dq_kernel_dma` (vitgan_tpu/ops/attention.py:324-431, pallas_call
// at :701) at f32 inputs, the two-pass route's first pass.
//
// Bound on this card (4-byte operands): three products of 2 N^2 Dh flops a
// head (S, dP, dQ) at 494.7 TFLOP/s TF32 against q/k/v/dO read and dQ
// written (5 N Dh 4 bytes) and the rows at 3.35 TB/s.  At highres128's D
// (32 x 6 heads, 1,025 tokens, Dh 64) the products bound it.
#include "flash_f32.cuh"

// q, k, v, dout: (bh, n, d) f32, contiguous, 16-byte aligned, d a multiple of
// 4, 4 <= d <= 128; lse (natural log) and delta = rowsum(dO * O): (bh, n)
// f32; dq: (bh, n, d) f32.  mode 0 `dot`, 1 `l2`.  The bf16 entry's
// signature: its `l2` persistent grid is taken and not read.
extern "C" int flash_attn_bwd_dq_f32(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dq, int bh, int n, int d, float inv_scale, int mode,
                                     int, void* stream) {
  using namespace vk::f32;
  if (!shape_ok(bh, n, d) || (mode != vk::kDot && mode != vk::kL2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ntiles = (n + TILE - 1) / TILE, stages = ntiles > 1 ? 2 : 1;
  const dim3 grid(ntiles, bh);
  const float sl = inv_scale * LOG2E;
  return by_width(d, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    const int floats = dq_floats<DP>(stages);
    auto go = [&](auto kernel) {
      return launch(kernel, grid, floats, s, q, k, v, dout, lse, delta, dq, n, d, sl, inv_scale);
    };
    return mode == vk::kDot ? go(flash_bwd_dq_f32_kernel<DP, vk::kDot>)
                            : go(flash_bwd_dq_f32_kernel<DP, vk::kL2>);
  });
}
