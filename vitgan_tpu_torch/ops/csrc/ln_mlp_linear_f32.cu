// The LN->MLP's linear stage in f32 for Hopper (sm_90a): tile_f32.cuh's A .
// W^T tile on TF32 wgmma with the bias [x mask] [+ residual] epilogue.
// Replaces, at f32 inputs, fc2 of the TPU kernels
// `_kernel` of vitgan_tpu/ops/fused_mlp.py:72-107 (pallas_call at :133) and
// the megablock's out-projection and fc2, with their dropout masks
// (vitgan_tpu/ops/fused_block.py:93-211, pallas_call at :408).  Bound on
// this card: bytes at highres128's shapes (ln_f32.cuh).
#include "ln_f32.cuh"

// out (m, n) f32 = [res +] [mask *] (a . w + bias).  a: (m, k) f32; wt: (n,
// k) f32, w K-major; bias: (n,) f32; res: (m, n) f32 or NULL.  With mask !=
// NULL the f32 multiply-mask of Philox stream mask_id is drawn from the
// int64 at seed (element row * n + col of the row's place in the global
// batch: the bits of ln_mlp_fwd.cu's ln_mlp_linear), applied and written to
// mask (m, n).  Bases 16-byte aligned; k, n multiples of 8.
extern "C" int ln_mlp_linear_f32(const void* a, const void* wt, const void* bias, const void* res,
                                 const void* seed, void* out, void* mask, int m, int k, int n,
                                 int mask_id, unsigned int threshold, float inv_keep, int rps,
                                 int local, int global, int first, void* stream) {
  using namespace vk::tilef32;
  if (!dims_ok(m, k, n) || (mask != nullptr && seed == nullptr) || rps < 1 || local < 1 ||
      global < local || first < 0 || first + local > global)
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.m = m, p.k = k, p.n = n, p.ncol = BN;
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<float*>(out);
  p.res = static_cast<const float*>(res);
  p.mask = static_cast<float*>(mask);
  p.seed = static_cast<const long long*>(seed);
  p.mask_id = (uint32_t)mask_id;
  p.threshold = threshold;
  p.inv_keep = inv_keep;
  p.rps = rps, p.local = local, p.global = global, p.first = first;
  return launch<kLinear>(a, wt, nullptr, nullptr, p, stream);
}
