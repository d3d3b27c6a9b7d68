// dy = a . w^T in f32 for Hopper (sm_90a): tile_f32.cuh's A . W^T tile on
// TF32 wgmma with the plain store (kDy).  Replaces, at f32 inputs, the two
// products of `_bwd_kernel` that feed a LayerNorm backward
// (vitgan_tpu/ops/fused_block.py, pallas_call at :700): dy2 = dz1 . w1^T
// (:545-547) before the LN2 backward and dy1 = dqkv . wqkv^T (:621-623)
// before the LN1 backward.  dy goes through device memory in f32 to
// ln_rows.cuh's LayerNorm-backward rows.  Bound on this card: operations for
// dy2, bytes for dy1 at highres128's G (tile_f32.cuh).
#include "tile_f32.cuh"

// dy (m, n) f32 = a . w^T: a (m, k) f32, w (n, k) f32 (K-major as it lies),
// bases 16-byte aligned, k and n multiples of 8.
extern "C" int megablock_bwd_dy_f32(const void* a, const void* w, void* dy, int m, int k, int n,
                                    void* stream) {
  using namespace vk::tilef32;
  if (!dims_ok(m, k, n)) return (int)cudaErrorInvalidValue;
  Params p{};
  p.m = m, p.k = k, p.n = n, p.ncol = BN;
  return launch<kDy>(a, w, nullptr, dy, p, stream);
}
