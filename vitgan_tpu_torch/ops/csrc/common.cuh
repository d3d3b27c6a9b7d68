// Shared device helpers of the port's hand-written Hopper kernels: bf16
// packing, cp.async, the flash kernels' score modes, the exact-erf GELU and
// the Philox dropout bits.  hopper.cuh adds the TMA, mbarrier and wgmma
// helpers every kernel is built on.  Each source is built on its own into a
// shared library with a plain C interface (ops/build.py); every C entry
// returns cudaGetLastError() after its launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vk {

using bf16 = __nv_bfloat16;

__device__ inline uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy into shared memory, zero-filled when !valid
// (then nothing is read: `gmem` only has to be a valid address).
__device__ inline void cp_async16(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(valid ? 16 : 0));
}
__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Two floats as one bf16x2 register, the first in the low half.
__device__ inline uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Score modes of the flash kernels (vitgan_tpu/ops/attention.py:50-61):
// kDot s = inv q.k; kL2 s = -inv d2; kL2Ref s = inv sqrt(d2 + 1e-12), with
// d2 = max(|q|^2 + |k|^2 - 2 q.k, 0).  The kernels work in log2 units, so
// `scale_log2` = inv * log2(e) multiplies the mode's distance term.
enum ScoreMode : int { kDot = 0, kL2 = 1, kL2Ref = 2 };

template <int MODE>
__device__ inline float score_log2(float qk, float qq, float kk, float scale_log2) {
  if constexpr (MODE == kDot) {
    return qk * scale_log2;
  } else {
    const float d2 = fmaxf(qq + kk - 2.f * qk, 0.f);
    if constexpr (MODE == kL2) return -d2 * scale_log2;
    float r;  // sqrt.approx (relative error ~2^-23): the IEEE sqrtf costs a Newton step
    asm("sqrt.approx.f32 %0, %1;" : "=f"(r) : "f"(d2 + 1e-12f));
    return r * scale_log2;
  }
}

// Exact-erf GELU, as torch's nn.GELU() and the JAX package's XLA path compute
// it.  The TPU kernels evaluate erf with the Abramowitz-Stegun 7.1.26
// polynomial instead (Mosaic has no erf); the two differ by less than 1.5e-7.
__device__ inline float gelu(float z) { return 0.5f * z * (1.f + erff(z * 0.70710678118654752f)); }

// Its exact derivative, 0.5 (1 + erf(z / sqrt 2)) + z phi(z).  (The TPU
// kernels differentiate their erf polynomial instead; the two differ by less
// than 1e-6.)
__device__ inline float gelu_grad(float z) {
  return 0.5f * (1.f + erff(z * 0.70710678118654752f)) +
         z * 0.39894228040143268f * __expf(-0.5f * z * z);
}

// fc1's activation, by the C entries' `act` (ops/fused_mlp.ACTIVATIONS): the
// JAX `_ACTS` (vitgan_tpu/ops/fused_mlp.py:63-69) on the f32 pre-activation
// (ln_mlp_fwd.cu and ln_f32.cuh).
enum Act : int { kGelu = 0, kRelu = 1, kTanh = 2, kSigmoid = 3 };
template <int ACT>
__device__ inline float activate(float z) {
  if constexpr (ACT == kGelu) return gelu(z);
  else if constexpr (ACT == kRelu) return fmaxf(z, 0.f);
  else if constexpr (ACT == kTanh) return tanhf(z);
  else return 1.f / (1.f + __expf(-z));
}

// --- dropout bits: Philox4x32-10 (Salmon et al., SC'11) ---------------------
// Counter-based: the 32 bits of element i of mask `id` are word i % 4 of
// philox(counter (i / 4 low, i / 4 high, id, 0), key (seed low, seed high)), so
// they depend on nothing but the seed and the element's place.  The plain
// version (ops/fused_block.philox4x32_10) gives the same bits.
__device__ inline uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// The key from the seed, a one-element int64 device tensor (read on the card:
// the host never waits for it).
__device__ inline uint2 seed_key(const long long* seed) {
  const unsigned long long s = static_cast<unsigned long long>(*seed);
  return make_uint2(static_cast<uint32_t>(s), static_cast<uint32_t>(s >> 32));
}

// Inverted-dropout multiply-masks of elements idx and idx + 1 (idx even) of
// mask `id`: inv_keep where the bits are >= threshold, else 0 (the TPU
// kernel's rule, vitgan_tpu/ops/fused_block.py:115-123).
__device__ inline float2 dropout_pair(uint2 key, uint32_t id, long long idx, uint32_t threshold,
                                      float inv_keep) {
  const unsigned long long q = static_cast<unsigned long long>(idx) >> 2;
  const uint4 w = philox4x32_10(
      make_uint4(static_cast<uint32_t>(q), static_cast<uint32_t>(q >> 32), id, 0u), key);
  const uint32_t b0 = (idx & 2) ? w.z : w.x, b1 = (idx & 2) ? w.w : w.y;
  return make_float2(b0 >= threshold ? inv_keep : 0.f, b1 >= threshold ? inv_keep : 0.f);
}

}  // namespace vk

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
