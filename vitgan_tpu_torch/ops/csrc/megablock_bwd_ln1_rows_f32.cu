// The LN1 backward in f32 for Hopper (sm_90a): ln_rows.cuh's
// ln_bwd_rows_kernel<kLn1> on f32 rows, after dy1 =
// megablock_bwd_dy_f32(dqkv, wqkv).  Replaces, at f32 inputs, dx = dx1 +
// LN1^T(dy1), y1 = LN1(x) and the dln1 column sums at the end of
// `_bwd_kernel` (vitgan_tpu/ops/fused_block.py:624-628, pallas_call at :700),
// the statistics from x in two passes, a row of (dy1 yhat1, dy1) partials a
// 64-row tile for sum_partials.  Every E a multiple of 8.  Bound on this card:
// bytes (dy1, x, dx1 read; dx, y1 written: ~252 MB at highres128's G,
// 0.075 ms).
#include "ln_rows.cuh"

// dy1, dx1: (m, e) f32; x: (m, e) f32; ln_s, ln_b: (e,) f32.  Out: dx and
// y1 (m, e) f32, part (ceil(m / 64), 2 e) f32.  Bases 16-byte aligned; e a
// multiple of 8.
extern "C" int megablock_bwd_ln1_rows_f32(const void* dy1, const void* x, const void* dx1,
                                          const void* ln_s, const void* ln_b, void* dx, void* y1,
                                          void* part, int m, int e, float eps, void* stream) {
  using namespace vk::lnrows;
  BwdParamsT<float> p{};
  p.m = m, p.e = e;
  p.dy = static_cast<const float*>(dy1);
  p.x = static_cast<const float*>(x);
  p.res = static_cast<const float*>(dx1);
  p.ln_s = static_cast<const float*>(ln_s);
  p.ln_b = static_cast<const float*>(ln_b);
  p.eps = eps;
  p.out = static_cast<float*>(dx);
  p.y = static_cast<float*>(y1);
  p.part = static_cast<float*>(part);
  return ln_bwd_rows<kLn1>(p, stream);
}
