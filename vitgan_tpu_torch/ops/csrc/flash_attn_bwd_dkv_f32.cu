// Flash-attention backward dK and dV in f32, `dot` and `l2` scores, for
// Hopper (sm_90a): flash_f32.cuh's k-block kernel (flash_bwd_kv_f32_kernel,
// FUSED = false), TF32 products on mma.sync.  Replaces the TPU kernels
// `_flash_bwd_dkv_kernel` and `_flash_bwd_dkv_kernel_dma`
// (vitgan_tpu/ops/attention.py:434-504, pallas_call at :727) at f32 inputs,
// the two-pass route's second pass.
//
// Bound on this card (4-byte operands): four products of 2 N^2 Dh flops a
// head (S^T, dP^T, dV, dK) at 494.7 TFLOP/s TF32 against q/k/v/dO read and
// dK, dV written (6 N Dh 4 bytes) and the rows at 3.35 TB/s.
#include "flash_f32.cuh"

// Arguments as flash_attn_bwd_dq_f32's; dk, dv: (bh, n, d) f32.
extern "C" int flash_attn_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dk, void* dv, int bh, int n, int d, float inv_scale,
                                      int mode, int, void* stream) {
  using namespace vk::f32;
  if (!shape_ok(bh, n, d) || (mode != vk::kDot && mode != vk::kL2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ntiles = (n + TILE - 1) / TILE, stages = ntiles > 1 ? 2 : 1;
  const dim3 grid(ntiles, bh);
  const float sl = inv_scale * LOG2E;
  void* none = nullptr;
  return by_width(d, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    const int floats = kv_floats<DP, false>(stages);
    auto go = [&](auto kernel) {
      return launch(kernel, grid, floats, s, q, k, v, dout, lse, delta, dk, dv, none, none, none,
                    n, d, sl, inv_scale);
    };
    return mode == vk::kDot ? go(flash_bwd_kv_f32_kernel<DP, vk::kDot, false>)
                            : go(flash_bwd_kv_f32_kernel<DP, vk::kL2, false>);
  });
}
