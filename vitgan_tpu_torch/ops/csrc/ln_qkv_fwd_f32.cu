// LN1 -> qkv in f32 for Hopper (sm_90a): ln_f32.cuh's tile GEMM with the
// LayerNorm prologue and the (3, B, H, N, Dh) scatter epilogue.  Replaces, at
// f32 inputs, the attention half's front of the megablock `_kernel`
// (vitgan_tpu/ops/fused_block.py:93-141, pallas_call at :408): y = LN1(x),
// qkv = y . wqkv + bqkv, each result at its place in the layout the flash
// kernels read.  Bound on this card: bytes at highres128's shapes
// (ln_f32.cuh).
#include "ln_f32.cuh"

// qkv (3, batch, heads, n, dh) f32 = LN1(x) . w + bias.  x: (batch*n, e)
// f32; w: (e, 3*heads*dh) f32, columns in `_pad_params` order; ln_s, ln_b:
// (e,) and bias: (3*heads*dh,) f32; stats: (batch*n, 2) f32 scratch, the
// rows' (mean, rstd).  Bases 16-byte aligned; e, dh multiples of 8 (any e:
// x streams).
extern "C" int ln_qkv_fwd_f32(const void* x, const void* ln_s, const void* ln_b, const void* w,
                              const void* bias, void* qkv, void* stats, int batch, int n, int e,
                              int heads, int dh, float eps, void* stream) {
  using namespace vk::lnf32;
  if (batch < 1 || n < 1 || heads < 1 || dh < 8 || dh % 8 || (long)batch * n > 0x7fffffffL ||
      !dims_ok(batch * n, e, 3 * heads * dh))
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.a = static_cast<const float*>(x);
  p.w = static_cast<const float*>(w);
  p.bias = static_cast<const float*>(bias);
  p.m = batch * n, p.k = e, p.n = 3 * heads * dh;
  p.ln_s = static_cast<const float*>(ln_s);
  p.ln_b = static_cast<const float*>(ln_b);
  p.stats = static_cast<const float2*>(stats);
  p.eps = eps;
  p.out = static_cast<float*>(qkv);
  p.batch = batch, p.tokens = n, p.heads = heads, p.dh = dh;
  return launch<true, kQkv, 0>(p, stream);
}
