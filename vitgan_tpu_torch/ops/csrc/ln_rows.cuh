// Row kernels of the wide LayerNorm variants (E > 384) for Hopper (sm_90a):
// the passes that the resident kernels do on a tile held whole in shared
// memory, done here on rows in device memory, so that E has no bound but
// TMA's multiple of 8.  Three kernels, each a plain grid of 256-thread blocks
// (mask_rows_kernel and ln_bwd_rows_kernel templated on the rows' element
// type: bf16, or f32 for the saved backward in f32 beside tile_f32.cuh, where
// they serve every E):
//   ln_rows_kernel: y = LN(x) in bf16 (LN -> fc1 and LN -> qkv; the streamed
//       products then read y as any activation);
//   mask_rows_kernel: out = g * m2 in bf16 (the dz1 stage's dmlp);
//   ln_bwd_rows_kernel<KIND>: the LayerNorm backward after dy = a . w^T
//       (written in f32 by megablock_bwd_mlp.cu's streamed product), with the
//       epilogue of the resident body ln_bwd_tile.cuh:
//         kDx1: dx1 = g + LN^T(dy) f32, da = dx1 * m1, y = LN(x)
//         kLn1: dx  = dx1 + LN^T(dy) bf16,              y = LN(x)
//       and each 64-row tile's column sums of dy * yhat and of dy, a row of
//       part (ceil(M / 64), 2 E) f32, the layout sum_partials reads.
// The statistics are taken eight lanes a row in hopper.cuh ln_row8's order
// (lane l of the row sums chunks l, l + 8, .. of 8 columns, the pairs added
// in turn, then three xor shuffles), so that LN(x) and the backward's yhat
// have the resident kernels' statistics bit for bit.  Every sum is taken in
// one order, no atomics: two calls give the same bits.
//
// Bound on this card: bytes.  A row is read two to three times, the later
// reads from L1 (a block's 32 or 64 rows are 48-192 KB at E 768).  At
// DeiT-B's G (16,384 rows, E 768) ln_rows moves 50 MB (0.015 ms) and ran
// 0.032 ms (F.layer_norm 0.041); mask_rows 0.044 against 0.030; the dx1 and
// LN1 rows move 50 MB of dy, 25 MB of x, 25-50 MB of the residual in and
// 75-100 MB out (0.076 and 0.053 ms) and ran 0.18 and 0.14 ms (H100 80GB
// HBM3 at 700 W, chip_smoke.py [wide kernels]).  A thread a column sums a
// tile's partials, so the dx1 and LN1 rows read dy and x twice.
#pragma once

#include "hopper.cuh"

namespace vk {
namespace lnrows {

using namespace vk::hopper;

constexpr int THREADS = 256;  // eight warps, four rows each at a time
constexpr int ROWS = 32;      // rows a block of ln_rows_kernel
constexpr int TILE = 64;      // rows a block of ln_bwd_rows_kernel: one row of partials

// The eight bf16 of a 16-byte chunk as floats.
__device__ inline void load8(const bf16* p, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&words[q]));
    v[2 * q] = f.x;
    v[2 * q + 1] = f.y;
  }
}
__device__ inline void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p), b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ inline void store8(bf16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                            pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}
__device__ inline void store8(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ inline float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ inline float to_f32(float v) { return v; }

// The f32 statistics of one row of e bf16 (or f32) in device memory, eight
// lanes a row in ln_row8's order (so the same bits); every lane of the warp
// calls it (the shuffles), a lane of a row past the matrix with live false.
template <typename T>
__device__ inline void row_stats8(const T* row, int e, float eps, bool live, float& mean,
                                  float& rstd) {
  const int l8 = threadIdx.x & 7, nch = live ? e >> 3 : 0;
  float v[8], s = 0.f;
  for (int c = l8; c < nch; c += 8) {
    load8(row + 8 * c, v);
#pragma unroll
    for (int q = 0; q < 4; ++q) s += v[2 * q] + v[2 * q + 1];
  }
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  mean = s / e;
  float sq = 0.f;
  for (int c = l8; c < nch; c += 8) {
    load8(row + 8 * c, v);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float d = v[k] - mean;
      sq += d * d;
    }
  }
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  rstd = rsqrtf(sq / e + eps);
}

// y (m, e) bf16 = LN(x) (ln_resident's arithmetic): a warp takes four rows,
// eight lanes each.
__global__ void __launch_bounds__(THREADS)
ln_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ g,
               const float* __restrict__ b, bf16* __restrict__ y, int m, int e, float eps) {
  const int lane = threadIdx.x & 31, l8 = lane & 7;
  const int row = blockIdx.x * ROWS + (threadIdx.x >> 5) * 4 + (lane >> 3);
  const bool live = row < m;
  const long base = live ? (long)row * e : 0;
  float mean, rstd;
  row_stats8(x + base, e, eps, live, mean, rstd);
  if (!live) return;
  for (int c = l8; c < e >> 3; c += 8) {
    float v[8], gs[8], bs[8];
    load8(x + base + 8 * c, v);
    load8(g + 8 * c, gs);
    load8(b + 8 * c, bs);
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = (v[k] - mean) * rstd * gs[k] + bs[k];
    store8(y + base + 8 * c, v);
  }
}

// out (n8 chunks of 8) = g * m2 in g's type, each product rounded once (the
// resident dz1 stage's mask_rows arithmetic; in f32 not rounded).
template <typename T>
__global__ void __launch_bounds__(THREADS)
mask_rows_kernel(const T* __restrict__ g, const float* __restrict__ m2, T* __restrict__ out,
                 long n8) {
  for (long i = (long)blockIdx.x * THREADS + threadIdx.x; i < n8; i += (long)gridDim.x * THREADS) {
    float v[8], f[8];
    load8(g + 8 * i, v);
    load8(m2 + 8 * i, f);
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] *= f[k];
    store8(out + 8 * i, v);
  }
}

enum { kDx1 = 0, kLn1 = 1 };

// T: the rows' element type, bf16 (the wide variants) or f32.
template <typename T>
struct BwdParamsT {
  int m, e;
  const float* dy;     // (m, e) f32: a . w^T
  const T* x;          // (m, e): the LayerNorm's input
  const T* g;          // kDx1: the residual g (m, e)
  const float* res;    // kLn1: the residual dx1 (m, e) f32
  const float* m1;     // kDx1: (m, e) f32, or null (no dropout)
  const float* ln_s;
  const float* ln_b;
  float eps;
  float* dx1;          // kDx1: (m, e) f32 out
  T* out;              // kDx1: da; kLn1: dx (m, e)
  T* y;                // LN(x) (m, e)
  float* part;         // (ceil(m / 64), 2 e) f32
};
using BwdParams = BwdParamsT<bf16>;

// A 64-row tile a block.  First each row, eight lanes: its statistics, then
// sum t and sum t yhat (t = dy gamma), then dx = res + rstd (t - mean(t) -
// yhat mean(t yhat)) (_ln_bwd, fused_block.py:464-470) and the outputs.  Then
// each column's sums over the tile's rows in row order, a thread a column.
template <int KIND, typename T>
__global__ void __launch_bounds__(THREADS) ln_bwd_rows_kernel(const BwdParamsT<T> p) {
  __shared__ float2 stats[TILE];  // (mean, rstd) of each row of the tile
  const int lane = threadIdx.x & 31, l8 = lane & 7, nch = p.e >> 3;
  const int m0 = blockIdx.x * TILE;
  const float inv_e = 1.f / p.e;
  for (int r1 = 0; r1 < TILE; r1 += 32) {
    const int r = r1 + (threadIdx.x >> 5) * 4 + (lane >> 3), row = m0 + r;
    const bool live = row < p.m;
    const long base = live ? (long)row * p.e : 0;
    float mean, rstd;
    row_stats8(p.x + base, p.e, p.eps, live, mean, rstd);
    if (l8 == 0) stats[r] = make_float2(mean, rstd);
    float st = 0.f, sty = 0.f;
    for (int c = l8; live && c < nch; c += 8) {
      float xv[8], d[8], gm[8];
      load8(p.x + base + 8 * c, xv);
      load8(p.dy + base + 8 * c, d);
      load8(p.ln_s + 8 * c, gm);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float t = d[k] * gm[k];
        st += t;
        sty += t * ((xv[k] - mean) * rstd);
      }
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) {
      st += __shfl_xor_sync(0xffffffffu, st, o);
      sty += __shfl_xor_sync(0xffffffffu, sty, o);
    }
    const float mt = st * inv_e, mty = sty * inv_e;
    for (int c = l8; live && c < nch; c += 8) {
      float xv[8], d[8], gm[8], bt[8], rs[8], y[8];
      load8(p.x + base + 8 * c, xv);
      load8(p.dy + base + 8 * c, d);
      load8(p.ln_s + 8 * c, gm);
      load8(p.ln_b + 8 * c, bt);
      if (KIND == kDx1)
        load8(p.g + base + 8 * c, rs);
      else
        load8(p.res + base + 8 * c, rs);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float yh = (xv[k] - mean) * rstd;
        rs[k] += (d[k] * gm[k] - mt - yh * mty) * rstd;  // dx
        y[k] = yh * gm[k] + bt[k];
      }
      store8(p.y + base + 8 * c, y);
      if (KIND == kDx1) {
        store8(p.dx1 + base + 8 * c, rs);
        if (p.m1 != nullptr) {
          float mk[8];
          load8(p.m1 + base + 8 * c, mk);
#pragma unroll
          for (int k = 0; k < 8; ++k) rs[k] *= mk[k];
        }
      }
      store8(p.out + base + 8 * c, rs);  // da, or dx
    }
  }
  __syncthreads();
  const int rows = min(TILE, p.m - m0);
  for (int c = threadIdx.x; c < p.e; c += THREADS) {
    float sy = 0.f, sb = 0.f;
    for (int r = 0; r < rows; ++r) {
      const long i = (long)(m0 + r) * p.e + c;
      const float d = p.dy[i];
      const float2 s = stats[r];
      sy += d * ((to_f32(p.x[i]) - s.x) * s.y);
      sb += d;
    }
    p.part[(long)blockIdx.x * 2 * p.e + c] = sy;
    p.part[(long)blockIdx.x * 2 * p.e + p.e + c] = sb;
  }
}

// Launches of the three kernels on `stream`; each returns a CUDA error code.
inline int ln_rows(const void* x, const void* g, const void* b, void* y, int m, int e, float eps,
                   void* stream) {
  if (m < 0 || e < 8 || e % 8) return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  ln_rows_kernel<<<(m + ROWS - 1) / ROWS, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(g), static_cast<const float*>(b),
      static_cast<bf16*>(y), m, e, eps);
  return (int)cudaGetLastError();
}

template <typename T = bf16>
inline int mask_rows(const void* g, const void* m2, void* out, int m, int e, void* stream) {
  if (m < 0 || e < 8 || e % 8) return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  const long n8 = (long)m * e / 8;
  const long blocks = (n8 + THREADS - 1) / THREADS;
  const int grid = blocks < 8L * sm_count() ? (int)blocks : 8 * sm_count();
  mask_rows_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(g), static_cast<const float*>(m2), static_cast<T*>(out), n8);
  return (int)cudaGetLastError();
}

template <int KIND, typename T>
inline int ln_bwd_rows(const BwdParamsT<T>& p, void* stream) {
  if (p.m < 0 || p.e < 8 || p.e % 8) return (int)cudaErrorInvalidValue;
  if (p.m == 0) return 0;
  ln_bwd_rows_kernel<KIND, T><<<(p.m + TILE - 1) / TILE, THREADS, 0,
                                static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace lnrows
}  // namespace vk
