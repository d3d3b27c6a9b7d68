// The MLP half's dao and delta in f32 for Hopper (sm_90a): tile_f32.cuh's
// A . W^T tile on TF32 wgmma with the kDao epilogue.  Replaces, at f32
// inputs, dao = da . wout^T and the flash backward's delta = each head's sum
// of dao * ao in `_bwd_kernel` (vitgan_tpu/ops/fused_block.py:559-561 and
// :602, pallas_call at :700).  Bound on this card: bytes at highres128's G
// (tile_f32.cuh).
#include "tile_f32.cuh"

// dao (batch, heads, n, dh) f32 = da . wout^T and delta (batch, heads, n) f32
// = the sum over each head's dh columns of dao * ao.  da: (batch n, e) f32;
// ao: (batch n, heads dh) f32; wout: (heads dh, e) f32.  Bases 16-byte
// aligned; e a multiple of 8, dh a multiple of 8 up to 128 (a tile owns
// whole heads).
extern "C" int megablock_bwd_mlp_dao_f32(const void* da, const void* ao, const void* wout,
                                         void* dao, void* delta, int batch, int n, int e,
                                         int heads, int dh, void* stream) {
  using namespace vk::tilef32;
  if (batch < 0 || n < 1 || heads < 1 || dh < 8 || dh % 8 || dh > BN ||
      (long)batch * n > 0x7fffffffL || !dims_ok(batch * n, e, heads * dh))
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.m = batch * n, p.k = e, p.n = heads * dh, p.ncol = BN / dh * dh;
  p.dao = static_cast<float*>(dao);
  p.delta = static_cast<float*>(delta);
  p.tokens = n, p.heads = heads, p.dh = dh;
  return launch<kDao>(da, wout, ao, nullptr, p, stream);
}
