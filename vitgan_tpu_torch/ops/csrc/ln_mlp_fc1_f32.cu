// LN -> fc1 -> act in f32 for Hopper (sm_90a): ln_f32.cuh's LayerNorm rows,
// then tile_f32.cuh's A . W^T tile on TF32 wgmma with the fc1 epilogue
// (bias, [z1], act).  Replaces, at f32 inputs, the LN -> fc1 half of the
// TPU kernels `_kernel` of vitgan_tpu/ops/fused_mlp.py:72-107 (pallas_call
// at :133) and of the megablock (vitgan_tpu/ops/fused_block.py:93-211,
// pallas_call at :408).  Bound on this card: bytes at highres128's shapes
// (ln_f32.cuh).
#include "ln_f32.cuh"

// h (m, hidden) f32 = act(LN(a) . w1 + b1) and, when z1 != NULL, z1 (m,
// hidden) f32 = LN(a) . w1 + b1.  a: (m, e) f32; w1t: (hidden, e) f32, w1
// K-major; ln_s, ln_b: (e,) and b1: (hidden,) f32; y: (m, e) f32 scratch,
// the rows LN(a).  Bases 16-byte aligned; e, hidden multiples of 8 (any e:
// the rows stream); act 0 gelu, 1 relu, 2 tanh, 3 sigmoid.
extern "C" int ln_mlp_fc1_f32(const void* a, const void* ln_s, const void* ln_b, const void* w1t,
                              const void* b1, void* h, void* z1, void* y, int m, int e,
                              int hidden, float eps, int act, void* stream) {
  using namespace vk::tilef32;
  if (!dims_ok(m, e, hidden) || act < vk::kGelu || act > vk::kSigmoid)
    return (int)cudaErrorInvalidValue;
  int err = vk::lnf32::norm_rows(a, ln_s, ln_b, y, m, e, eps, stream);
  if (err) return err;
  Params p{};
  p.m = m, p.k = e, p.n = hidden, p.ncol = BN;
  p.bias = static_cast<const float*>(b1);
  p.out = static_cast<float*>(h);
  p.z1 = static_cast<float*>(z1);
  switch (act) {
    case vk::kGelu: return launch<kFc1, vk::kGelu>(y, w1t, nullptr, nullptr, p, stream);
    case vk::kRelu: return launch<kFc1, vk::kRelu>(y, w1t, nullptr, nullptr, p, stream);
    case vk::kTanh: return launch<kFc1, vk::kTanh>(y, w1t, nullptr, nullptr, p, stream);
    default: return launch<kFc1, vk::kSigmoid>(y, w1t, nullptr, nullptr, p, stream);
  }
}
