// LN1 -> qkv in f32 for Hopper (sm_90a): ln_f32.cuh's LayerNorm rows, then
// tile_f32.cuh's A . W^T tile on TF32 wgmma with the (3, B, H, N, Dh)
// scatter epilogue.  Replaces, at f32 inputs, the attention half's front of
// the megablock `_kernel` (vitgan_tpu/ops/fused_block.py:93-141, pallas_call
// at :408): y = LN1(x), qkv = y . wqkv + bqkv, each result at its place in
// the layout the flash kernels read.  Bound on this card: bytes at
// highres128's shapes (ln_f32.cuh).
#include "ln_f32.cuh"

// qkv (3, batch, heads, n, dh) f32 = LN1(x) . w + bias.  x: (batch*n, e)
// f32; wt: (3*heads*dh, e) f32, w K-major (rows in `_pad_params`' column
// order); ln_s, ln_b: (e,) and bias: (3*heads*dh,) f32; y: (batch*n, e) f32
// scratch, the rows LN1(x).  Bases 16-byte aligned; e, dh multiples of 8
// (any e: the rows stream).
extern "C" int ln_qkv_fwd_f32(const void* x, const void* ln_s, const void* ln_b, const void* wt,
                              const void* bias, void* qkv, void* y, int batch, int n, int e,
                              int heads, int dh, float eps, void* stream) {
  using namespace vk::tilef32;
  if (batch < 1 || n < 1 || heads < 1 || dh < 8 || dh % 8 || (long)batch * n > 0x7fffffffL ||
      !dims_ok(batch * n, e, 3 * heads * dh))
    return (int)cudaErrorInvalidValue;
  int err = vk::lnf32::norm_rows(x, ln_s, ln_b, y, batch * n, e, eps, stream);
  if (err) return err;
  Params p{};
  p.m = batch * n, p.k = e, p.n = 3 * heads * dh, p.ncol = BN;
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<float*>(qkv);
  p.batch = batch, p.tokens = n, p.heads = heads, p.dh = dh;
  return launch<kQkv>(y, wt, nullptr, nullptr, p, stream);
}
