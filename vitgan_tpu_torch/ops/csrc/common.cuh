// Shared device helpers of the port's hand-written Hopper kernels.
//
// Every kernel takes bf16 operands and accumulates in f32 on the tensor cores
// through mma.sync m16n8k16, its operands fetched from shared memory by
// ldmatrix and its tiles brought in by cp.async.  Shared-memory tiles carry a
// skew of 8 bf16 (16 bytes) per row, which keeps every ldmatrix row address
// 16-byte aligned and spreads the 8 rows of a matrix over all the banks.
// Each source is built on its own into a shared library with a plain C
// interface (ops/build.py); every C entry returns cudaGetLastError() after
// its launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vk {

using bf16 = __nv_bfloat16;

__host__ __device__ inline int ceil_to(int x, int m) { return (x + m - 1) / m * m; }

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Row LayerNorm of `rows` rows over the e real features (e <= 32 * MAXC),
// f32 statistics (mean, then the mean of squared deviations: the JAX
// package's order), writing bf16 rows of y (leading dimension ldy) with
// zeros in the padded columns [e, ep).  get(r, c) reads input element (r, c)
// as float.  One warp per row; each lane reads its elements once, before any
// write, so y may be the input tile itself.
template <int MAXC, class Get>
__device__ inline void layer_norm_rows(Get get, bf16* y, int ldy, int rows, int e, int ep,
                                       const float* __restrict__ g,
                                       const float* __restrict__ b, float eps) {
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  for (int r = threadIdx.x >> 5; r < rows; r += nw) {
    float v[MAXC];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < MAXC; ++i) {
      const int c = lane + 32 * i;
      v[i] = c < e ? get(r, c) : 0.f;
      s += v[i];
    }
    const float mean = warp_sum(s) / e;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < MAXC; ++i) {
      const int c = lane + 32 * i;
      const float d = c < e ? v[i] - mean : 0.f;
      q += d * d;
    }
    const float rstd = rsqrtf(warp_sum(q) / e + eps);
#pragma unroll
    for (int i = 0; i < MAXC; ++i) {
      const int c = lane + 32 * i;
      if (c < ep)
        y[r * ldy + c] = c < e ? __float2bfloat16((v[i] - mean) * rstd * g[c] + b[c])
                               : __float2bfloat16(0.f);
    }
  }
}

// --- mma.sync building blocks ----------------------------------------------
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A 16x16 row-major: a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..)
//   B 16x8 "col":      b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g)
//   C 16x8 f32:        c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1)
// ldmatrix x4 serves four 8x8 matrices, lanes 8i..8i+7 giving the row
// addresses of matrix i; with .trans each is transposed on the way.

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

__device__ inline void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ inline void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a . b on the tensor cores (bf16 operands, f32 accumulation).
__device__ inline void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as one bf16x2 register, the first in the low half.
__device__ inline uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A operand (16x16) at (row0, col0) of a row-major bf16 tile (leading dim ld).
__device__ inline void load_a(uint32_t (&a)[4], const bf16* tile, int ld, int row0, int col0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(a, tile + (row0 + (lane & 15)) * ld + col0 + (lane >> 4) * 8);
}

// B operands of two adjacent n-tiles (k 16 x n 16) at (k0, n0) of a
// row-major [k][n] bf16 tile: {b[0], b[1]} for columns n0..n0+7, {b[2], b[3]}
// for n0+8..n0+15.
__device__ inline void load_b_kn(uint32_t (&b)[4], const bf16* tile, int ld, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_t(b, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 + (lane >> 4) * 8);
}

// A operand (16x16) at (m0, k0) of A stored transposed, as a row-major [k][m]
// tile (the row-summed operand of a weight gradient A^T . B).
__device__ inline void load_a_km(uint32_t (&a)[4], const bf16* tile, int ld, int m0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_t(a, tile + (k0 + (lane & 7) + ((lane >> 4) << 3)) * ld + m0 + ((lane >> 3) & 1) * 8);
}

// The same from a row-major [n][k] tile (B^T stored, as K for q.k^T).
__device__ inline void load_b_nk(uint32_t (&b)[4], const bf16* tile, int ld, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(b, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 + ((lane >> 3) & 1) * 8);
}

// Asynchronously copies a rows x cols tile (cols a multiple of 8) of the
// row-major bf16 matrix `src` (leading dimension lds, a multiple of 8, base
// 16-byte aligned) starting at (row0, col0) into shared memory (leading
// dimension ldd, a multiple of 8).  Rows >= rmax and 8-column groups at or
// past cmax (a multiple of 8) are zero-filled.  The (row, 8-column group) of
// each copy advances by a fixed step, so the loop divides only once.
__device__ inline void cp_tile(bf16* dst, int ldd, const bf16* __restrict__ src, long lds,
                               int row0, int col0, int rows, int cols, int rmax, int cmax) {
  const int per_row = cols >> 3;
  const int step_r = blockDim.x / per_row, step_c = blockDim.x - step_r * per_row;
  int r = threadIdx.x / per_row, c = threadIdx.x - r * per_row;
  for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
    const int gr = row0 + r, gc = col0 + (c << 3);
    const bool ok = gr < rmax && gc < cmax;
    cp_async16(dst + r * ldd + (c << 3), ok ? src + (long)gr * lds + gc : src, ok);
    r += step_r;
    c += step_c;
    if (c >= per_row) {
      c -= per_row;
      ++r;
    }
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
