// The LN2 backward in f32 for Hopper (sm_90a): ln_rows.cuh's
// ln_bwd_rows_kernel<kDx1> on f32 rows, after dy2 = megablock_bwd_dy_f32(dz1,
// w1).  Replaces, at f32 inputs, dx1 = g + LN2^T(dy2), da = dx1 * m1, y2 =
// LN2(x1) and the dln2 column sums of `_bwd_kernel`
// (vitgan_tpu/ops/fused_block.py:548-554, pallas_call at :700), the
// statistics from x1 in two passes, a row of (dy2 yhat2, dy2) partials a
// 64-row tile for sum_partials.  Every E a multiple of 8.  Bound on this card:
// bytes (dy2, g, x1, m1 read; dx1, da, y2 written: ~352 MB at highres128's G,
// 0.105 ms).
#include "ln_rows.cuh"

// dy2: (m, e) f32; g, x1: (m, e) f32; m1: (m, e) f32 or NULL; ln_s, ln_b: (e,)
// f32.  Out: dx1, da, y2 (m, e) f32, part (ceil(m / 64), 2 e) f32.  Bases
// 16-byte aligned; e a multiple of 8.
extern "C" int megablock_bwd_mlp_dx1_rows_f32(const void* dy2, const void* g, const void* m1,
                                              const void* x1, const void* ln_s, const void* ln_b,
                                              void* dx1, void* da, void* y2, void* part, int m,
                                              int e, float eps, void* stream) {
  using namespace vk::lnrows;
  BwdParamsT<float> p{};
  p.m = m, p.e = e;
  p.dy = static_cast<const float*>(dy2);
  p.x = static_cast<const float*>(x1);
  p.g = static_cast<const float*>(g);
  p.m1 = static_cast<const float*>(m1);
  p.ln_s = static_cast<const float*>(ln_s);
  p.ln_b = static_cast<const float*>(ln_b);
  p.eps = eps;
  p.dx1 = static_cast<float*>(dx1);
  p.out = static_cast<float*>(da);
  p.y = static_cast<float*>(y2);
  p.part = static_cast<float*>(part);
  return ln_bwd_rows<kDx1>(p, stream);
}
