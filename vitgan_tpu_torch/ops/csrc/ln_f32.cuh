// The LayerNorm family's forward in f32 for Hopper (sm_90a): one tile GEMM on
// mma.sync TF32 with an optional LayerNorm prologue and three epilogues.  The
// three entries (ln_mlp_fc1_f32.cu, ln_mlp_linear_f32.cu, ln_qkv_fwd_f32.cu)
// replace, at f32 inputs, the TPU kernels that compute in their input dtype
// (runtime.compute_dtype=float32):
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
// TF32 with cvt.rna as it lands in shared memory (the tensor core would
// truncate the raw f32 bits, which doubles the error); bias, activation
// (common.cuh activate: GELU the exact erf form), mask and residual in f32;
// every output f32.  The linear stage's mask is common.cuh dropout_pair on
// the element's place in the global batch (row r of sample s = r / rps keyed
// as row (s / local * global + first + s % local) rps + r % rps), the bits
// ln_mlp_fwd.cu's linear stage draws: the two masks are bit-equal at one
// seed, mask id and rows, whatever the dtype.
//
// Design (a simple kernel first; TF32 wgmma is ROADMAP.md queue 2 item 6q).
// A block of 8 warps owns a 128 x 128 output tile, a warp 64 x 32 of it, and
// streams the summed width 32 columns at a time through two cp.async stages:
// A (128 rows x 32) at a stride of 36 floats and W (32 x 128, N contiguous
// as it lies in device memory) at a stride of 136.  mma.sync m16n8k8 reads
// its fragments by hand: A K-major at g S + t (S / 4 odd: the 32 lanes hit
// 32 banks, flash_f32.cuh frag_a), B at (k = t, n = g) from W's rows, t SB +
// g with SB = 8 mod 32 (again 32 banks).  TF32 wgmma reads both shared
// operands K-major only, and W lies N-major: here no tile is re-laid.  Each
// thread transforms the 16-byte granules it copied once its copies have
// landed, so that only one block barrier stands between the copies and the
// products: A's through the LayerNorm and both operands' through cvt.rna.
// The LayerNorm's statistics come first, from a launch of their own in the
// same entry (ln_stats_f32_kernel: one warp a row, (mean, rstd) into an f32
// scratch the wrapper allocates); each block reads its 128 rows' pairs while
// its first stage lands.  (Taken in each block's prologue instead, every
// one of a row tile's output-column blocks reduced the same rows again, one
// row after another: LN -> fc1 ran 0.85 ms at highres128's G against the
// linear stage's 0.48 for the same flops.)  The A tile streams, so
// every E that is a multiple of 8 takes this one kernel: no resident tile
// (an f32 128-row tile at E 768 would be 384 KB) and no LN(x) rows written
// out, as the bf16 wide variant writes them.  Rows past M and columns past K land as zeros (cp.async zero-fill;
// a normalised column past K is set to 0); the epilogue writes no row past
// M and no column past N.  Outputs go straight from the accumulators as
// float2: a quad of lanes writes 32 contiguous bytes, a whole sector.
//
// Bound on this card (4-byte operands, 494.7 TFLOP/s TF32, 3.35 TB/s): at
// highres128's G (32,768 rows, E 384, hidden 1,536, 6 heads of 64) LN -> fc1
// with z1 does 3.87e10 flops on ~455 MB (0.136 ms by its bytes), the fc2
// linear with residual and mask ~354 MB (0.106 ms), LN -> qkv 2.9e10 flops on
// ~203 MB (0.061 ms): bytes bound them all.  Times against the bounds:
// PERF.md, chip_smoke.py [f32 ln kernels].
#pragma once

#include "flash_f32.cuh"

namespace vk {
namespace lnf32 {

using f32::bits;
using f32::mma;
using f32::tf32;

constexpr int BM = 128;       // rows a block
constexpr int BN = 128;       // output columns a block
constexpr int BK = 32;        // summed columns a stage
constexpr int THREADS = 256;  // 8 warps: 2 (rows) x 4 (columns), 64 x 32 each
constexpr int SA = BK + 4;    // A tile stride, floats
constexpr int SB = BN + 8;    // W tile stride, floats
constexpr int A_FLOATS = BM * SA;
constexpr int STAGE = A_FLOATS + BK * SB;
constexpr int SMEM = (2 * STAGE + 2 * BM) * (int)sizeof(float);  // 72,704 bytes

enum Epi : int { kFc1 = 0, kLinear = 1, kQkv = 2 };

struct Params {
  const float* a;     // (m, k) rows, contiguous
  const float* w;     // (k, n) row-major
  const float* bias;  // (n,)
  int m, k, n;
  const float* ln_s;  // the LayerNorm prologue's gamma and beta (k,)
  const float* ln_b;
  const float2* stats;  // its rows' (mean, rstd), from ln_stats_f32_kernel
  float eps;
  float* out;         // kFc1 h, kLinear out: (m, n); kQkv: (3, batch, heads, tokens, dh)
  float* z1;          // kFc1: the pre-activation (m, n), or null
  const float* res;   // kLinear: the (m, n) residual, or null
  float* mask;        // kLinear: the (m, n) multiply-mask, or null: no dropout
  const long long* seed;
  uint32_t mask_id, threshold;
  float inv_keep;
  int rps, local, global, first;  // the mask's rows in the global batch
  int batch, tokens, heads, dh;   // kQkv
};

__device__ inline float4 round4(float4 v) {
  return make_float4(__uint_as_float(tf32(v.x)), __uint_as_float(tf32(v.y)),
                     __uint_as_float(tf32(v.z)), __uint_as_float(tf32(v.w)));
}

__device__ inline float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// Stage kt's A rows [r0, r0 + BM) x [k0, k0 + BK) and W rows [k0, k0 + BK) x
// [n0, n0 + BN) into `st` by cp.async, 16 bytes a copy, zero past m, k, n.
__device__ inline void load_stage(float* st, const Params& p, int r0, int n0, int k0) {
  for (int i = threadIdx.x; i < BM * BK / 4; i += THREADS) {
    const int r = i / (BK / 4), c = 4 * (i % (BK / 4));
    const bool ok = r0 + r < p.m && k0 + c < p.k;
    cp_async16(st + r * SA + c, ok ? p.a + (long)(r0 + r) * p.k + k0 + c : p.a, ok);
  }
  float* ws = st + A_FLOATS;
  for (int i = threadIdx.x; i < BK * BN / 4; i += THREADS) {
    const int r = i / (BN / 4), c = 4 * (i % (BN / 4));
    const bool ok = k0 + r < p.k && n0 + c < p.n;
    cp_async16(ws + r * SB + c, ok ? p.w + (long)(k0 + r) * p.n + n0 + c : p.w, ok);
  }
}

// The granules this thread copied into `st` (load_stage's mapping), once
// they have landed: A through the LayerNorm when LN, both operands rounded
// to TF32.  The block barrier after it publishes them.
template <bool LN>
__device__ inline void prepare_stage(float* st, const Params& p, const float* mean,
                                     const float* rstd, int k0) {
  for (int i = threadIdx.x; i < BM * BK / 4; i += THREADS) {
    const int r = i / (BK / 4), c = 4 * (i % (BK / 4));
    float4* q = reinterpret_cast<float4*>(st + r * SA + c);
    float4 v = *q;
    if constexpr (LN) {
      if (k0 + c < p.k) {
        const float4 s = __ldg(reinterpret_cast<const float4*>(p.ln_s + k0 + c));
        const float4 b = __ldg(reinterpret_cast<const float4*>(p.ln_b + k0 + c));
        const float mu = mean[r], rs = rstd[r];
        v = make_float4((v.x - mu) * rs * s.x + b.x, (v.y - mu) * rs * s.y + b.y,
                        (v.z - mu) * rs * s.z + b.z, (v.w - mu) * rs * s.w + b.w);
      } else {
        v = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    *q = round4(v);
  }
  float* ws = st + A_FLOATS;
  for (int i = threadIdx.x; i < BK * BN / 4; i += THREADS) {
    float4* q = reinterpret_cast<float4*>(ws + (i / (BN / 4)) * SB + 4 * (i % (BN / 4)));
    *q = round4(*q);
  }
}

// mean and rstd of row r into stats[r] (a float2), one warp a row: the sum,
// then the sum of the centred squares (from L1), each in one lane order and
// one xor tree.  The LayerNorm prologue's own launch: every output-column
// block of a row tile reads its rows' statistics from here, so no row is
// reduced more than once.
__global__ void __launch_bounds__(256) ln_stats_f32_kernel(const float* __restrict__ a, int m,
                                                           int k, float eps,
                                                           float2* __restrict__ stats) {
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
  if (lane == 0) stats[row] = make_float2(mu, rs);
}

__device__ inline void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

// out tile (blockIdx.y, blockIdx.x) = [LN](A) . W + bias, then EPI.
template <bool LN, int EPI, int ACT>
__global__ void __launch_bounds__(THREADS, 2) ln_gemm_f32_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* mean = sm + 2 * STAGE;
  float* rstd = mean + BM;
  const int n0 = blockIdx.x * BN, r0 = blockIdx.y * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wm = 64 * (warp >> 2), wn = 32 * (warp & 3);
  const int ktiles = (p.k + BK - 1) / BK;

  load_stage(sm, p, r0, n0, 0);
  cp_async_commit();
  if constexpr (LN) {
    if (threadIdx.x < BM) {
      const float2 st = r0 + (int)threadIdx.x < p.m ? p.stats[r0 + threadIdx.x]
                                                    : make_float2(0.f, 0.f);
      mean[threadIdx.x] = st.x;
      rstd[threadIdx.x] = st.y;
    }
    __syncthreads();
  }

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int kt = 0; kt < ktiles; ++kt) {
    float* st = sm + (kt & 1) * STAGE;
    if (kt + 1 < ktiles) {
      load_stage(sm + ((kt + 1) & 1) * STAGE, p, r0, n0, (kt + 1) * BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    prepare_stage<LN>(st, p, mean, rstd, kt * BK);
    __syncthreads();
    const float* ws = st + A_FLOATS;
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) f32::frag_a<SA>(a[i], st, wm + 16 * i, 8 * kk, g, t);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* q = ws + (8 * kk + t) * SB + wn + 8 * j + g;
        b[j][0] = bits(q[0]);
        b[j][1] = bits(q[4 * SB]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma(acc[i][j], a[i], b[j][0], b[j][1]);
    }
    __syncthreads();  // the stage is free for tile kt + 2
  }

  // epilogue: this thread holds rows wm + 16 i + g (+ 8) and columns
  // wn + 8 j + 2 t (+ 1) of the tile
  uint2 key = make_uint2(0u, 0u);
  if constexpr (EPI == kLinear) {
    if (p.mask != nullptr) key = seed_key(p.seed);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + wm + 16 * i + g + 8 * h;
      if (row >= p.m) continue;
      long goff = 0;  // the row's place in the global batch less its own, in elements
      if constexpr (EPI == kLinear) {
        if (p.mask != nullptr && p.local != p.global) {
          const int s = row / p.rps;
          const long grow =
              ((long)(s / p.local) * p.global + p.first + s % p.local) * p.rps + row % p.rps;
          goff = (grow - row) * p.n;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + wn + 8 * j + 2 * t;  // n is a multiple of 8: col + 1 < n too
        if (col >= p.n) continue;
        const float2 bias = __ldg(reinterpret_cast<const float2*>(p.bias + col));
        float v0 = acc[i][j][2 * h] + bias.x, v1 = acc[i][j][2 * h + 1] + bias.y;
        if constexpr (EPI == kFc1) {
          const long idx = (long)row * p.n + col;
          if (p.z1 != nullptr) store2(p.z1 + idx, v0, v1);
          store2(p.out + idx, activate<ACT>(v0), activate<ACT>(v1));
        } else if constexpr (EPI == kLinear) {
          const long idx = (long)row * p.n + col;
          if (p.mask != nullptr) {
            const float2 mk = dropout_pair(key, p.mask_id, idx + goff, p.threshold, p.inv_keep);
            v0 *= mk.x;
            v1 *= mk.y;
            *reinterpret_cast<float2*>(p.mask + idx) = mk;
          }
          if (p.res != nullptr) {
            const float2 r = *reinterpret_cast<const float2*>(p.res + idx);
            v0 += r.x;
            v1 += r.y;
          }
          store2(p.out + idx, v0, v1);
        } else {
          // column (part H + head) Dh + d of row (b, tok): Dh even, so the pair
          // stays in one head
          const int hd = p.heads * p.dh, part = col / hd, head = (col - part * hd) / p.dh;
          const int d = col - part * hd - head * p.dh, b = row / p.tokens;
          const long dst =
              (((long)(part * p.batch + b) * p.heads + head) * p.tokens + row - b * p.tokens) *
                  p.dh + d;
          store2(p.out + dst, v0, v1);
        }
      }
    }
  }
}

// m rows of width k into n columns: k, n multiples of 8 (16-byte granules),
// the grid's rows within CUDA's y limit.
inline bool dims_ok(int m, int k, int n) {
  return m >= 0 && k >= 8 && k % 8 == 0 && n >= 8 && n % 8 == 0 && (m + BM - 1) / BM <= 65535;
}

// The LayerNorm's statistics (LN) into p.stats, then the tile GEMM: two
// kernels, one entry call.
template <bool LN, int EPI, int ACT>
int launch(const Params& p, void* stream) {
  if (p.m == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (LN) {
    ln_stats_f32_kernel<<<(p.m + 7) / 8, 256, 0, s>>>(p.a, p.m, p.k, p.eps,
                                                       const_cast<float2*>(p.stats));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((p.n + BN - 1) / BN, (p.m + BM - 1) / BM);
  cudaError_t err = cudaFuncSetAttribute(ln_gemm_f32_kernel<LN, EPI, ACT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  ln_gemm_f32_kernel<LN, EPI, ACT><<<grid, THREADS, SMEM, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace lnf32
}  // namespace vk
