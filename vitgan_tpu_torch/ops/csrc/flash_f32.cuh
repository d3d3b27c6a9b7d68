// Flash attention in f32, `dot`, `l2` and `l2ref` scores, for Hopper (sm_90a):
// the forward and the dq pass on mma.sync TF32 tensor-core products, and the
// helpers the f32 k-block kernel shares (flash_f32_bwd.cuh: dk/dv and the
// single pass on TF32 wgmma).  The entries flash_attn_fwd_f32.cu and
// flash_attn_bwd_dq_f32.cu replace the TPU kernels of
// vitgan_tpu/ops/attention.py at f32 inputs, which they compute in their
// input dtype (runtime.compute_dtype=float32): `_flash_kernel` /
// `_flash_kernel_dma` (pallas_call at :252 and :179) and
// `_flash_bwd_dq_kernel(_dma)` (:701).  The bf16 kernels (flash_attn_*.cu,
// flash_l2*.cuh) stay as they are; the wrappers (ops/attention.py) send each
// call to one or the other by its dtype.
//
// Math (attention.py:53-105, 280-330): every product runs TF32 x TF32 with
// f32 accumulation; each operand is rounded to TF32 with cvt.rna (the tensor
// core would truncate the raw f32 bits, which doubles the error); the
// softmax, the LSE (natural log, l clamped at 1e-30), delta, dS and the `l2`
// norms stay f32.  The tiles are rounded once in shared memory after they
// land, and |q|^2, |k|^2 are taken from the rounded rows, so that
// d2 = |q|^2 + |k|^2 - 2 q.k is |q - k|^2 of the rounded rows.  P and dS are
// rounded to TF32 before their products, as the TPU kernels cast them to the
// input dtype (f32 there; TF32 the product's operand here).
//
// Design (a simple kernel first; TF32 wgmma for these two is ROADMAP.md queue
// 2 item 6p).  One block of 4 warps owns 64 queries of one (batch*head), 16
// a warp, and streams the keys 64 a tile through two cp.async stages (one
// where a single tile covers n).  Tiles lie in shared memory row-major at a
// stride of DP + 4 floats (DP: the head width rounded up to 32, zero columns
// past d; rows past n zero).  mma.sync m16n8k8 TF32 reads A (16 x 8) and B
// (8 x 8) fragments that each thread loads by hand, in either orientation:
//   K-major  (row = g, column = t, t + 4 of an 8-wide chunk):  address
//            g S + t, conflict-free since S / 4 is odd;
//   MN-major (B[k][n] = X[k][n], the summed rows): the chunk's rows are taken
//            in the order 2t, 2t + 1 for the fragment's k = t, t + 4 (a
//            permutation of the summed index, the same in A), address
//            2t S + g, conflict-free for the same reason.  An accumulator
//            fragment (row g, columns 2t, 2t + 1) is then the A fragment of
//            the next product as it lies in registers: P in O += P V, dS in
//            dQ += dS K.
//
//   forward (q-block): S = Q K^T, online softmax in log2 units, O += P V;
//   dq (q-block):      S = Q K^T, dP = dO V^T, dS = P (dP - delta), dQ += dS K.
// `l2` gradient: dQ = 2 inv (dS K - rowsum(dS) q) (attention.py:290-292,
// 425-431); `dot`: inv dS K.
//
// Bound on this card: 4-byte operands at 494.7 TFLOP/s TF32 against 3.35
// TB/s.  At the v1 shapes (128 x 4 heads of 32 tokens, Dh 96; 256 x 4 of 50,
// Dh 108) every kernel is bound by its bytes, a few microseconds, and runs
// latency-bound on one or two tiles a block; at highres256p4's 4,096 tokens
// (Dh 64) by the products.  Times against the bounds: PERF.md, chip_smoke.py
// [f32 kernels].
#pragma once

#include <type_traits>

#include "hopper.cuh"

namespace vk {
namespace f32 {

constexpr int ROWS = 64;     // resident rows of a block: 4 warps x 16
constexpr int TILE = 64;     // streamed rows of a tile
constexpr int THREADS = 128;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// A shared tile: TILE rows of DP floats at stride S = DP + 4.
template <int DP>
struct Geo {
  static constexpr int S = DP + 4;
  static constexpr int FLOATS = TILE * S;
  static constexpr int NJ = DP / 8;  // 8-column output fragments across the head
};

__device__ inline uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ inline uint32_t bits(float x) { return __float_as_uint(x); }

// c += a . b, m16n8k8, TF32 operands, f32 accumulators.
__device__ inline void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows [r0, r0 + TILE) of a row-major (n, d) f32 matrix into `tile` by
// cp.async, 16 bytes a copy; rows past n and columns d .. DP zero-filled.
template <int DP>
__device__ inline void load_tile(float* tile, const float* src, int r0, int n, int d) {
  constexpr int G = DP / 4;
  for (int i = threadIdx.x; i < TILE * G; i += THREADS) {
    const int r = i / G, c = 4 * (i % G);
    const bool ok = r0 + r < n && c < d;
    cp_async16(tile + r * Geo<DP>::S + c, ok ? src + (long)(r0 + r) * d + c : src, ok);
  }
}

// Round the granules this thread loaded (load_tile's mapping) to TF32 in
// place, once its copies have landed (cp_async_wait); the block barrier after
// it publishes them.
template <int DP>
__device__ inline void round_tile(float* tile) {
  constexpr int G = DP / 4;
  for (int i = threadIdx.x; i < TILE * G; i += THREADS) {
    float4* p = reinterpret_cast<float4*>(tile + (i / G) * Geo<DP>::S + 4 * (i % G));
    float4 v = *p;
    v = make_float4(__uint_as_float(tf32(v.x)), __uint_as_float(tf32(v.y)),
                    __uint_as_float(tf32(v.z)), __uint_as_float(tf32(v.w)));
    *p = v;
  }
}

// |row|^2 of a tile's TILE rows into out[TILE], two threads a row.
template <int DP>
__device__ inline void row_norms(const float* tile, float* out) {
  const int r = threadIdx.x >> 1, h = threadIdx.x & 1;
  const float* p = tile + r * Geo<DP>::S + h * (DP / 2);
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < DP / 2; c += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + c);
    s += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
  }
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  if (h == 0) out[r] = s;
}

// A fragment, K-major: rows m0 + g (+ 8) of `x`, columns c0 + t (+ 4).
template <int S>
__device__ inline void frag_a(uint32_t (&a)[4], const float* x, int m0, int c0, int g, int t) {
  const float* p = x + (m0 + g) * S + c0 + t;
  a[0] = bits(p[0]);
  a[1] = bits(p[8 * S]);
  a[2] = bits(p[4]);
  a[3] = bits(p[8 * S + 4]);
}

// An accumulator fragment as the A fragment of the next product, summed
// index permuted (the head note), rounded to TF32.
__device__ inline void frag_a_acc(uint32_t (&a)[4], const float (&c)[4]) {
  a[0] = tf32(c[0]);
  a[1] = tf32(c[2]);
  a[2] = tf32(c[1]);
  a[3] = tf32(c[3]);
}

// acc[j] (+)= A . B over the head width, B K-major from rows n0 + 8 j + g of
// `y` (S^T = K Q^T, S = Q K^T, dP = dO V^T, ...): 16 rows x 8 NJ columns.
template <int DP, int NJ>
__device__ inline void product_kmajor(float (&acc)[NJ][4], const float* x, int m0,
                                      const float* y, int n0, int g, int t) {
  constexpr int S = Geo<DP>::S;
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk) {
    uint32_t a[4];
    frag_a<S>(a, x, m0, 8 * kk, g, t);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float* p = y + (n0 + 8 * j + g) * S + 8 * kk + t;
      mma(acc[j], a, bits(p[0]), bits(p[4]));
    }
  }
}

// acc[i] += A_j . B over 8 summed rows r0 + 8 j + (2t, 2t + 1) of `y`
// (MN-major), i over the head width: one chunk of P V, P^T dO, dS^T Q, dS K.
template <int DP, int NI>
__device__ inline void product_mnmajor(float (&acc)[NI][4], const uint32_t (&a)[4], const float* y,
                                       int r0, int c0, int g, int t) {
  constexpr int S = Geo<DP>::S;
  const float* p = y + (r0 + 2 * t) * S + c0 + g;
#pragma unroll
  for (int i = 0; i < NI; ++i) mma(acc[i], a, bits(p[8 * i]), bits(p[S + 8 * i]));
}

// --- forward -----------------------------------------------------------------

template <int DP>
constexpr int fwd_floats(int stages) {
  return (1 + 2 * stages) * Geo<DP>::FLOATS + TILE + 2 * TILE;
}

// O = softmax(S) V and LSE for 64 queries of one (batch*head) a block.  O
// goes to (bh, n, d), or with out_bnhd to (b, n, heads * d) (the megablock's
// out-projection rows; bh = b heads + h).
template <int DP, int MODE>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int n, int d, float scale_log2, int heads,
                     int out_bnhd) {
  using G = Geo<DP>;
  constexpr int NJ = G::NJ;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* kv = qs + G::FLOATS;  // stage s: K at kv + 2 s FLOATS, V after it
  const int ntiles = (n + TILE - 1) / TILE, stages = ntiles > 1 ? 2 : 1;
  float* qn = kv + 2 * stages * G::FLOATS;  // |q|^2 of the block's rows
  float* kn = qn + TILE;                    // |k|^2 of stage s's keys at kn + s TILE
  const int bh = blockIdx.y, q0 = blockIdx.x * ROWS;
  const long base = (long)bh * n * d;
  const float *qb = q + base, *kb = k + base, *vb = v + base;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int m0 = 16 * warp;

  load_tile<DP>(qs, qb, q0, n, d);
  load_tile<DP>(kv, kb, 0, n, d);
  load_tile<DP>(kv + G::FLOATS, vb, 0, n, d);
  cp_async_commit();

  float oacc[NJ][4];
#pragma unroll
  for (int i = 0; i < NJ; ++i) oacc[i][0] = oacc[i][1] = oacc[i][2] = oacc[i][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, qq[2] = {0.f, 0.f};

  for (int kt = 0; kt < ntiles; ++kt) {
    const int s = kt & 1;
    float* ks = kv + 2 * s * G::FLOATS;
    float* vs = ks + G::FLOATS;
    if (kt + 1 < ntiles) {
      float* nk = kv + 2 * (s ^ 1) * G::FLOATS;
      load_tile<DP>(nk, kb, (kt + 1) * TILE, n, d);
      load_tile<DP>(nk + G::FLOATS, vb, (kt + 1) * TILE, n, d);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if (kt == 0) round_tile<DP>(qs);
    round_tile<DP>(ks);
    round_tile<DP>(vs);
    __syncthreads();
    if constexpr (MODE != kDot) {
      if (kt == 0) row_norms<DP>(qs, qn);
      row_norms<DP>(ks, kn + s * TILE);
      __syncthreads();
      if (kt == 0) qq[0] = qn[m0 + g], qq[1] = qn[m0 + g + 8];
    }
    // S = Q K^T: this warp's 16 queries x the tile's 64 keys
    float sacc[8][4];
    product_kmajor<DP, 8>(sacc, qs, m0, ks, 0, g, t);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 8 * j + 2 * t + (e & 1);
        const float sc = kt * TILE + key < n
                             ? score_log2<MODE>(sacc[j][e], qq[e >> 1], kn[s * TILE + key],
                                                scale_log2)
                             : -INFINITY;
        sacc[j][e] = sc;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc);
      }
    float ls[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = exp2f(m[h] - mx[h]);
      m[h] = mx[h];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sacc[j][e] - m[e >> 1]);
        sacc[j][e] = p;
        ls[e >> 1] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + ls[h];
#pragma unroll
    for (int i = 0; i < NJ; ++i) {
      oacc[i][0] *= alpha[0];
      oacc[i][1] *= alpha[0];
      oacc[i][2] *= alpha[1];
      oacc[i][3] *= alpha[1];
    }
    // O += P V: P from the accumulators, V MN-major
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t a[4];
      frag_a_acc(a, sacc[j]);
      product_mnmajor<DP, NJ>(oacc, a, vs, 8 * j, 0, g, t);
    }
    __syncthreads();  // the stage is free for tile kt + 2
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int row = q0 + m0 + g + 8 * h;
    if (row >= n) continue;
    const float lc = fmaxf(l[h], 1e-30f), inv_l = 1.f / lc;
    float* orow = out_bnhd ? o + (((long)(bh / heads) * n + row) * heads + bh % heads) * d
                           : o + base + (long)row * d;
#pragma unroll
    for (int i = 0; i < NJ; ++i) {
      const int col = 8 * i + 2 * t;  // d is a multiple of 4: col + 1 < d too
      if (col < d)
        *reinterpret_cast<float2*>(orow + col) =
            make_float2(oacc[i][2 * h] * inv_l, oacc[i][2 * h + 1] * inv_l);
    }
    if (t == 0) lse[(long)bh * n + row] = (m[h] + log2f(lc)) * LN2;
  }
}

// --- dq (q-block) ------------------------------------------------------------

template <int DP>
constexpr int dq_floats(int stages) {
  return (2 + 2 * stages) * Geo<DP>::FLOATS + TILE + 2 * TILE;
}

template <int DP, int MODE>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dq, int n, int d, float scale_log2, float inv_scale) {
  using G = Geo<DP>;
  constexpr int S = G::S, NJ = G::NJ;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* dos = qs + G::FLOATS;
  float* kv = dos + G::FLOATS;
  const int ntiles = (n + TILE - 1) / TILE, stages = ntiles > 1 ? 2 : 1;
  float* qn = kv + 2 * stages * G::FLOATS;
  float* kn = qn + TILE;
  const int bh = blockIdx.y, q0 = blockIdx.x * ROWS;
  const long base = (long)bh * n * d;
  const float *kb = k + base, *vb = v + base;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int m0 = 16 * warp;

  load_tile<DP>(qs, q + base, q0, n, d);
  load_tile<DP>(dos, dout + base, q0, n, d);
  load_tile<DP>(kv, kb, 0, n, d);
  load_tile<DP>(kv + G::FLOATS, vb, 0, n, d);
  cp_async_commit();

  float lse2[2], dl[2], qq[2] = {0.f, 0.f}, rs[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + m0 + g + 8 * h;
    lse2[h] = row < n ? lse[(long)bh * n + row] * LOG2E : INFINITY;
    dl[h] = row < n ? delta[(long)bh * n + row] : 0.f;
  }
  float acc[NJ][4];
#pragma unroll
  for (int i = 0; i < NJ; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int kt = 0; kt < ntiles; ++kt) {
    const int s = kt & 1;
    float* ks = kv + 2 * s * G::FLOATS;
    float* vs = ks + G::FLOATS;
    if (kt + 1 < ntiles) {
      float* nk = kv + 2 * (s ^ 1) * G::FLOATS;
      load_tile<DP>(nk, kb, (kt + 1) * TILE, n, d);
      load_tile<DP>(nk + G::FLOATS, vb, (kt + 1) * TILE, n, d);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if (kt == 0) {
      round_tile<DP>(qs);
      round_tile<DP>(dos);
    }
    round_tile<DP>(ks);
    round_tile<DP>(vs);
    __syncthreads();
    if constexpr (MODE != kDot) {
      if (kt == 0) row_norms<DP>(qs, qn);
      row_norms<DP>(ks, kn + s * TILE);
      __syncthreads();
      if (kt == 0) qq[0] = qn[m0 + g], qq[1] = qn[m0 + g + 8];
    }
    float sacc[8][4], pacc[8][4];
    product_kmajor<DP, 8>(sacc, qs, m0, ks, 0, g, t);   // S = Q K^T
    product_kmajor<DP, 8>(pacc, dos, m0, vs, 0, g, t);  // dP = dO V^T
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 8 * j + 2 * t + (e & 1), h = e >> 1;
        const float p =
            kt * TILE + key < n
                ? exp2f(score_log2<MODE>(sacc[j][e], qq[h], kn[s * TILE + key], scale_log2) -
                        lse2[h])
                : 0.f;
        const float ds = p * (pacc[j][e] - dl[h]);
        pacc[j][e] = ds;
        rs[h] += ds;
      }
      uint32_t a[4];
      frag_a_acc(a, pacc[j]);
      product_mnmajor<DP, NJ>(acc, a, ks, 8 * j, 0, g, t);  // dQ += dS K
    }
    __syncthreads();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
    rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
    const int row = q0 + m0 + g + 8 * h;
    if (row >= n) continue;
    float* out = dq + base + (long)row * d;
    const float* qr = qs + (m0 + g + 8 * h) * S;
#pragma unroll
    for (int i = 0; i < NJ; ++i) {
      const int col = 8 * i + 2 * t;
      if (col >= d) continue;
      float2 r;
      if constexpr (MODE == kDot) {
        r = make_float2(inv_scale * acc[i][2 * h], inv_scale * acc[i][2 * h + 1]);
      } else {
        r = make_float2(2.f * inv_scale * (acc[i][2 * h] - rs[h] * qr[col]),
                        2.f * inv_scale * (acc[i][2 * h + 1] - rs[h] * qr[col + 1]));
      }
      *reinterpret_cast<float2*>(out + col) = r;
    }
  }
}

// --- launches ------------------------------------------------------------------

// The instantiation for head width d: DP = d rounded up to 32 (d a multiple
// of 4, 4 <= d <= 128); -1 where d is not taken.
inline int padded_width(int d) {
  if (d < 4 || d > 128 || d % 4) return -1;
  return (d + 31) / 32 * 32;
}

// Calls f(std::integral_constant<int, DP>{}) at the instantiation for d.
template <typename F>
int by_width(int d, F&& f) {
  switch (padded_width(d)) {
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 96: return f(std::integral_constant<int, 96>{});
    case 128: return f(std::integral_constant<int, 128>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

// Launch `kernel` on 4 warps a block with `floats` of dynamic shared memory.
template <typename... P, typename... A>
int launch(void (*kernel)(P...), dim3 grid, int floats, cudaStream_t stream, A... args) {
  const int bytes = floats * (int)sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, bytes, stream>>>(static_cast<P>(args)...);
  return (int)cudaGetLastError();
}

inline bool shape_ok(int bh, int n, int d) {
  return bh >= 1 && bh <= 65535 && n >= 1 && padded_width(d) > 0;
}

}  // namespace f32
}  // namespace vk
