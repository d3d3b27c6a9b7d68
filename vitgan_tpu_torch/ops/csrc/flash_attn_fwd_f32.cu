// Flash-attention forward in f32, `dot`, `l2` and `l2ref` scores, for Hopper
// (sm_90a): flash_f32.cuh's q-block kernel (flash_fwd_f32_kernel), TF32
// products on mma.sync.  Replaces the TPU kernels `_flash_kernel` /
// `_flash_forward` (vitgan_tpu/ops/attention.py:64-105, pallas_call at :252)
// and their K/V-streaming variant `_flash_kernel_dma` (:108-169, pallas_call
// at :179) at f32 inputs: K and V stream through shared memory one 64-key
// tile at a time at any length.
//
// Bound on this card (4-byte operands): 4 N^2 Dh flops a head at 494.7
// TFLOP/s TF32 against 4 (3 + 1) N Dh bytes and the LSE at 3.35 TB/s; at
// the v1 generator's shape (128 x 4 heads, 32 tokens, Dh 96) 25 MB of q/k/v/o
// bound it (7.5 us).  ptxas -v: chip_smoke.py prints registers and spills.
#include "flash_f32.cuh"

// q, k, v: (bh, n, d) f32, contiguous, 16-byte aligned; d a multiple of 4,
// 4 <= d <= 128 (zero-filled to 32, 64, 96 or 128 in shared memory only).
// o: (bh, n, d) f32, or with out_bnhd (bh / heads, n, heads * d), the
// megablock's layout (`dot`, d a multiple of 8); lse: (bh, n) f32, the
// natural-log log-sum-exp of the scores.  inv_scale multiplies q.k (`dot`)
// or the distance; mode 0 `dot`, 1 `l2`, 2 `l2ref`.
extern "C" int flash_attn_fwd_f32(const void* q, const void* k, const void* v, void* o,
                                  void* lse, int bh, int n, int d, float inv_scale, int mode,
                                  int heads, int out_bnhd, void* stream) {
  using namespace vk::f32;
  if (!shape_ok(bh, n, d) || mode < vk::kDot || mode > vk::kL2Ref || heads < 1 ||
      (out_bnhd && (mode != vk::kDot || d % 8 || bh % heads)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ntiles = (n + TILE - 1) / TILE, stages = ntiles > 1 ? 2 : 1;
  const dim3 grid(ntiles, bh);
  const float sl = inv_scale * LOG2E;
  return by_width(d, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    const int floats = fwd_floats<DP>(stages);
    auto go = [&](auto kernel) {
      return launch(kernel, grid, floats, s, q, k, v, o, lse, n, d, sl, heads, out_bnhd);
    };
    switch (mode) {
      case vk::kDot: return go(flash_fwd_f32_kernel<DP, vk::kDot>);
      case vk::kL2: return go(flash_fwd_f32_kernel<DP, vk::kL2>);
      default: return go(flash_fwd_f32_kernel<DP, vk::kL2Ref>);
    }
  });
}
