// LN -> fc1 -> act in f32 for Hopper (sm_90a): ln_f32.cuh's tile GEMM with the
// LayerNorm prologue and the fc1 epilogue (bias, [z1], act).  Replaces, at
// f32 inputs, the LN -> fc1 half of the TPU kernels `_kernel` of
// vitgan_tpu/ops/fused_mlp.py:72-107 (pallas_call at :133) and of the
// megablock (vitgan_tpu/ops/fused_block.py:93-211, pallas_call at :408).
// Bound on this card: bytes at highres128's shapes (ln_f32.cuh).
#include "ln_f32.cuh"

// h (m, hidden) f32 = act(LN(a) . w1 + b1) and, when z1 != NULL, z1 (m,
// hidden) f32 = LN(a) . w1 + b1.  a: (m, e) f32; w1: (e, hidden) f32; ln_s,
// ln_b: (e,) and b1: (hidden,) f32; stats: (m, 2) f32 scratch, the rows'
// (mean, rstd).  Bases 16-byte aligned; e, hidden multiples of 8 (any e: A
// streams); act 0 gelu, 1 relu, 2 tanh, 3 sigmoid.
extern "C" int ln_mlp_fc1_f32(const void* a, const void* ln_s, const void* ln_b, const void* w1,
                              const void* b1, void* h, void* z1, void* stats, int m, int e,
                              int hidden, float eps, int act, void* stream) {
  using namespace vk::lnf32;
  if (!dims_ok(m, e, hidden)) return (int)cudaErrorInvalidValue;
  Params p{};
  p.a = static_cast<const float*>(a);
  p.w = static_cast<const float*>(w1);
  p.bias = static_cast<const float*>(b1);
  p.m = m, p.k = e, p.n = hidden;
  p.ln_s = static_cast<const float*>(ln_s);
  p.ln_b = static_cast<const float*>(ln_b);
  p.stats = static_cast<const float2*>(stats);
  p.eps = eps;
  p.out = static_cast<float*>(h);
  p.z1 = static_cast<float*>(z1);
  switch (act) {
    case vk::kGelu: return launch<true, kFc1, vk::kGelu>(p, stream);
    case vk::kRelu: return launch<true, kFc1, vk::kRelu>(p, stream);
    case vk::kTanh: return launch<true, kFc1, vk::kTanh>(p, stream);
    case vk::kSigmoid: return launch<true, kFc1, vk::kSigmoid>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
