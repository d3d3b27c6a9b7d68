// The LayerNorm family's forward in f32 for Hopper (sm_90a): tile_f32.cuh's
// A . W^T tile on TF32 wgmma with three epilogues, after a LayerNorm rows
// launch for the LN entries.  The three entries (ln_mlp_fc1_f32.cu,
// ln_mlp_linear_f32.cu, ln_qkv_fwd_f32.cu) replace, at f32 inputs, the TPU
// kernels that compute in their input dtype (runtime.compute_dtype=float32):
//   ln_mlp_fc1_f32:    h = act(LN(x) . w1 + b1) [and z1]      the LN -> fc1 half of
//       `_kernel` (vitgan_tpu/ops/fused_mlp.py:72-107, pallas_call at :133) and
//       of the megablock `_kernel` (vitgan_tpu/ops/fused_block.py:93-211,
//       pallas_call at :408);
//   ln_mlp_linear_f32: out = [res +] [mask *] (a . w + bias)  fc2 of both, and
//       the megablock's out-projection x1 = x + m1 * (attn . wout + bout);
//   ln_qkv_fwd_f32:    qkv = LN1(x) . wqkv + bqkv            the megablock's LN1 ->
//       qkv front, written into the (3, B, H, N, Dh) layout the flash kernels
//       read (column (p H + h) Dh + d is part p of head h, feature d).
// The bf16 kernels (ln_mlp_fwd.cu, ln_qkv_fwd.cu, ln_rows.cuh) stay as they
// are; the wrappers (ops/fused_mlp.py, ops/fused_block.py) send each call to
// one or the other by its dtype.
//
// Math (fused_mlp.py:80-107): the LayerNorm in f32 over the real width, mean
// first, then the mean of the centred squares (two passes over the row, in
// one order: the same bits every call); y = (x - mean) rstd gamma + beta;
// every product TF32 x TF32 with f32 accumulation, each operand rounded to
// TF32 to nearest as it lands in shared memory (the tensor core would
// truncate the raw f32 bits, which doubles the error); bias, activation
// (common.cuh activate: GELU the exact erf form), mask and residual in f32;
// every output f32.  The linear stage's mask: tile_f32.cuh.
//
// Design.  Each entry is tile_f32.cuh's persistent A . W^T tile (a TMA
// producer thread, a ring of 32-float SW128 boxes of A and W with TFLOAT32
// maps, so that the TMA unit rounds each operand and no thread rewrites a
// stage, two consumer warpgroups on m64n128k8 TF32 wgmma, two epilogue
// warpgroups taking each tile from a staged copy while the next tile's
// products run) with the epilogue kFc1, kLinear or kQkv.  TF32 wgmma reads
// both shared operands K-major only, and the forward's weights lie (k, n),
// N-major: the wrappers hand the entries a K-major copy (n, k), made in each
// call (w.t().contiguous(), and for wqkv (3, H, E, Dh) permuted to (3 H Dh,
// E)), since a copy kept beside the parameter would go stale where a
// captured step updates the weights in place.  The TMA unit's rounding
// applies to what lands, so LN(x) cannot be formed in the stage without a
// rewrite pass: the LN entries first run ln_norm_f32_kernel (a warp a row:
// the two passes of the statistics, then y written in f32 into an (m, k)
// scratch the wrapper allocates, each row reduced once) and the tile reads y
// like any A.  That costs m k 4 bytes written and read again (50 MB each way
// at highres128's G).  Every k and n that is a multiple of 8 takes this one
// kernel (no resident tile, no wide variant): TMA's zero fill takes rows
// past m, k not a multiple of 32 (E 520) and n not a multiple of 128 (hidden
// 1,040 and 768); the epilogues write no row past m and no column past n.
//
// Bound on this card (4-byte operands, 494.7 TFLOP/s TF32, 3.35 TB/s), each
// input read once and each output written once: at highres128's G (32,768
// rows, E 384, hidden 1,536, 6 heads of 64) LN -> fc1 with z1 does 3.87e10
// flops on ~455 MB (0.136 ms by its bytes), the fc2 linear with residual and
// mask ~354 MB (0.106 ms), LN -> qkv 2.9e10 flops on ~203 MB (0.061 ms):
// bytes bound them all.  Times against the bounds: PERF.md, chip_smoke.py
// [f32 ln kernels], scripts/kernel_ab.py --f32-ln.
#pragma once

#include "tile_f32.cuh"

namespace vk {
namespace lnf32 {

__device__ inline float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// y row r = (x - mean) rstd ln_s + ln_b of x row r, one warp a row: the sum,
// then the sum of the centred squares (from L1), each in one lane order and
// one xor tree, then y in f32.
__global__ void __launch_bounds__(256) ln_norm_f32_kernel(const float* __restrict__ a,
                                                          const float* __restrict__ ln_s,
                                                          const float* __restrict__ ln_b, int m,
                                                          int k, float eps, float* __restrict__ y) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= m) return;
  const float* x = a + (long)row * k;
  float s = 0.f;
  for (int c = 4 * lane; c < k; c += 128) {
    const float4 v = *reinterpret_cast<const float4*>(x + c);
    s += (v.x + v.y) + (v.z + v.w);
  }
  const float mu = warp_sum(s) / k;
  float q = 0.f;
  for (int c = 4 * lane; c < k; c += 128) {
    const float4 v = *reinterpret_cast<const float4*>(x + c);
    const float d0 = v.x - mu, d1 = v.y - mu, d2 = v.z - mu, d3 = v.w - mu;
    q += (d0 * d0 + d1 * d1) + (d2 * d2 + d3 * d3);
  }
  const float rs = rsqrtf(warp_sum(q) / k + eps);
  float* yr = y + (long)row * k;
  for (int c = 4 * lane; c < k; c += 128) {
    const float4 v = *reinterpret_cast<const float4*>(x + c);
    const float4 g = __ldg(reinterpret_cast<const float4*>(ln_s + c));
    const float4 b = __ldg(reinterpret_cast<const float4*>(ln_b + c));
    *reinterpret_cast<float4*>(yr + c) =
        make_float4((v.x - mu) * rs * g.x + b.x, (v.y - mu) * rs * g.y + b.y,
                    (v.z - mu) * rs * g.z + b.z, (v.w - mu) * rs * g.w + b.w);
  }
}

// y = LN(a): the LN entries' first launch.
inline int norm_rows(const void* a, const void* ln_s, const void* ln_b, void* y, int m, int k,
                     float eps, void* stream) {
  if (m == 0) return 0;
  ln_norm_f32_kernel<<<(m + 7) / 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(ln_s),
      static_cast<const float*>(ln_b), m, k, eps, static_cast<float*>(y));
  return (int)cudaGetLastError();
}

}  // namespace lnf32
}  // namespace vk
