// The MLP half's dz1 in f32 for Hopper (sm_90a): tile_f32.cuh's A . W^T tile
// on TF32 wgmma with the kDz1 epilogue.  Replaces, at f32 inputs, dz1 = (dmlp
// . w2^T) * gelu'(z1) and h1 = gelu(z1) of `_bwd_kernel`
// (vitgan_tpu/ops/fused_block.py:530, :535-538; pallas_call at :700).  Bound
// on this card: bytes at highres128's G (tile_f32.cuh).
#include "tile_f32.cuh"

// dz1 (m, hidden) f32 = (dmlp . w2^T) * gelu'(z1), h1 (m, hidden) f32 =
// gelu(z1).  dmlp: (m, e) f32 (g * m2, or g without dropout); z1: (m,
// hidden) f32; w2: (hidden, e) f32.  Bases 16-byte aligned; e, hidden
// multiples of 8 (any e: the rows stream).
extern "C" int megablock_bwd_mlp_dz1_f32(const void* dmlp, const void* z1, const void* w2,
                                         void* dz1, void* h1, int m, int e, int hidden,
                                         void* stream) {
  using namespace vk::tilef32;
  if (!dims_ok(m, e, hidden)) return (int)cudaErrorInvalidValue;
  Params p{};
  p.m = m, p.k = e, p.n = hidden, p.ncol = BN;
  p.out = static_cast<float*>(dz1);
  p.h1 = static_cast<float*>(h1);
  return launch<kDz1>(dmlp, w2, z1, nullptr, p, stream);
}
