// The megablock's saved-residual backward in f32 for Hopper (sm_90a): the
// products of #8 on mma.sync TF32, built on ln_f32.cuh's tile core.  Two
// kernels:
//   dy_gemm_f32_kernel<EPI>: C = A . W^T with W (n, k) read K-major as it lies
//       (every weight of the backward's dy products is (in, out) = (n, k) row
//       by row), and three epilogues:
//         kDz1: dz1 = C * gelu'(z1) and h1 = gelu(z1)   (C = dmlp . w2^T)
//         kDy:  dy = C, a plain f32 store               (dy2 = dz1 . w1^T,
//               dy1 = dqkv . wqkv^T)
//         kDao: dao = C scattered into (B, H, N, Dh) and delta (B, H, N) =
//               each head's sum of dao * ao             (C = da . wout^T)
//   wgrad_f32_kernel (wgrad_gemm_f32.cu, on this tile core): dW = A^T . B and
//       db = the column sums of B, both summed over rows, as per-split
//       partials in wgrad_gemm.cu's scratch layout, which wgrad_reduce.cuh
//       sums in its fixed order.
// Seven entries, each its own source, replace at f32 inputs the TPU kernel
// `_bwd_kernel` (vitgan_tpu/ops/fused_block.py:484-628, pallas_call at :700),
// which computes in its input dtype (runtime.compute_dtype=float32):
// megablock_bwd_mask_rows_f32 (dmlp = g * m2, ln_rows.cuh),
// megablock_bwd_mlp_dz1_f32 (kDz1), megablock_bwd_dy_f32 (kDy),
// megablock_bwd_mlp_dx1_rows_f32 and megablock_bwd_ln1_rows_f32 (ln_rows.cuh's
// LayerNorm-backward rows on f32 rows), megablock_bwd_mlp_dao_f32 (kDao) and
// wgrad_gemm_f32.  The bf16 kernels stay as they are; the wrappers
// (ops/fused_block.py, ops/wgrad.py) send each call to one or the other by
// its dtype.
//
// Math (`_bwd_kernel`): every product TF32 x TF32 with f32 accumulation,
// each operand rounded with cvt.rna as it lands in shared memory; GELU' the
// exact erf derivative (common.cuh gelu_grad); delta, db and the column sums
// plain f32 adds in a fixed order; every output f32.  No atomics: two calls
// give the same bits.
//
// Design (a simple kernel first; TF32 wgmma is ROADMAP.md queue 2 item 6r).
// dy_gemm_f32_kernel is ln_f32.cuh's tile (8 warps, a 128 x 128 output tile,
// 64 x 32 a warp, the summed width 32 columns a stage through two cp.async
// stages) with W's tile K-major like A's: both at a stride of BK + 4 floats,
// so B's fragment (k = t, n = g) at (n0 + g) S + t hits 32 banks as A's
// does.  A kDao block owns whole heads: floor(128 / Dh) of them, its
// columns past them zero-filled (every Dh <= 128 that is a multiple of 8).
// Its epilogue writes dao * ao into the freed stage buffers, and after one
// barrier a thread a (row, head) sums its Dh products in column order.
// wgrad_f32_kernel sums over rows, so both operands lie MN-major: 32 rows of
// A's 128 columns and of B's a stage at a stride of 136 floats, A's
// fragment (m = g, k = t) at t S + g, B's at t S + g (32 banks each).  The
// rows split over the grid's z as wgrad.plan chooses (ranges of whole
// 64-row stages); rows past the split land as zeros.  db: the block of
// output-row tile y sums the stages c with c % (row tiles) == y from the
// raw f32 tile before it is rounded, a thread its four columns over its
// rows, then the eight threads of a column group in order through shared
// memory.
//
// Bound on this card (4-byte operands, 494.7 TFLOP/s TF32, 3.35 TB/s) at
// highres128's G (32,768 rows, E 384, hidden 1,536, 6 heads of 64): dz1
// with dmlp read and dz1, h1 written ~757 MB (0.226 ms); dy2 3.87e10 flops
// (0.078 ms); dao with delta ~152 MB (0.045 ms); dy1 ~201 MB (0.060 ms);
// wgrad_gemm_f32 dW2 and dW1 0.078 ms each, dWout 0.030, dWqkv 0.060.
// Times against the bounds: PERF.md, chip_smoke.py [f32 bwd kernels].
#pragma once

#include "ln_f32.cuh"

namespace vk {
namespace bwdf32 {

using f32::bits;
using f32::mma;
using f32::tf32;
using lnf32::BK;
using lnf32::BM;
using lnf32::BN;
using lnf32::dims_ok;  // k, n multiples of 8, the grid's rows within CUDA's y limit
using lnf32::round4;
using lnf32::store2;
using lnf32::THREADS;

// --- C = A . W^T ------------------------------------------------------------------

constexpr int S = BK + 4;           // A's and W's tile stride (both K-major), floats
constexpr int TILE_FLOATS = BM * S;  // one operand's tile of a stage (BN == BM)
constexpr int STAGE = 2 * TILE_FLOATS;
constexpr int SMEM = 2 * STAGE * (int)sizeof(float);  // 73,728 bytes
constexpr int SP = BN + 1;  // kDao: the dao * ao products' stride in the freed stages
static_assert(BM * SP <= 2 * STAGE, "kDao's products fit the stage buffers");

enum Epi : int { kDz1 = 0, kDy = 1, kDao = 2 };

struct Params {
  const float* a;    // (m, k) rows, contiguous
  const float* w;    // (n, k) rows: W^T's columns, K-major
  int m, k, n;
  int ncol;          // output columns a block: BN, or kDao's whole heads
  float* out;        // kDz1 dz1, kDy dy: (m, n); kDao dao: (batch, heads, tokens, dh)
  const float* z1;   // kDz1: (m, n)
  float* h1;         // kDz1: (m, n)
  const float* ao;   // kDao: (m, n)
  float* delta;      // kDao: (batch, heads, tokens)
  int tokens, heads, dh;
};

// Stage A rows [r0, r0 + BM) x [k0, k0 + BK) and W rows [n0, nend) x the same
// columns into `st` by cp.async, 16 bytes a copy, zero past m, nend and k.
__device__ inline void load_stage(float* st, const Params& p, int r0, int n0, int nend, int k0) {
  for (int i = threadIdx.x; i < BM * BK / 4; i += THREADS) {
    const int r = i / (BK / 4), c = 4 * (i % (BK / 4));
    const bool ok = r0 + r < p.m && k0 + c < p.k;
    cp_async16(st + r * S + c, ok ? p.a + (long)(r0 + r) * p.k + k0 + c : p.a, ok);
  }
  float* ws = st + TILE_FLOATS;
  for (int i = threadIdx.x; i < BN * BK / 4; i += THREADS) {
    const int r = i / (BK / 4), c = 4 * (i % (BK / 4));
    const bool ok = n0 + r < nend && k0 + c < p.k;
    cp_async16(ws + r * S + c, ok ? p.w + (long)(n0 + r) * p.k + k0 + c : p.w, ok);
  }
}

// The granules this thread copied (load_stage's mapping), once landed,
// rounded to TF32 in place; the block barrier after it publishes them.
__device__ inline void round_stage(float* st) {
  for (int i = threadIdx.x; i < 2 * BM * BK / 4; i += THREADS) {
    float4* q = reinterpret_cast<float4*>(st + (i / (BK / 4)) * S + 4 * (i % (BK / 4)));
    *q = round4(*q);
  }
}

// out tile (blockIdx.y, blockIdx.x) = A . W^T, then EPI.
template <int EPI>
__global__ void __launch_bounds__(THREADS, 2) dy_gemm_f32_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int n0 = blockIdx.x * p.ncol, r0 = blockIdx.y * BM;
  const int nend = min(p.n, n0 + p.ncol);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wm = 64 * (warp >> 2), wn = 32 * (warp & 3);
  const int ktiles = (p.k + BK - 1) / BK;

  load_stage(sm, p, r0, n0, nend, 0);
  cp_async_commit();

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int kt = 0; kt < ktiles; ++kt) {
    float* st = sm + (kt & 1) * STAGE;
    if (kt + 1 < ktiles) {
      load_stage(sm + ((kt + 1) & 1) * STAGE, p, r0, n0, nend, (kt + 1) * BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    round_stage(st);
    __syncthreads();
    const float* ws = st + TILE_FLOATS;
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) f32::frag_a<S>(a[i], st, wm + 16 * i, 8 * kk, g, t);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* q = ws + (wn + 8 * j + g) * S + 8 * kk + t;
        b[j][0] = bits(q[0]);
        b[j][1] = bits(q[4]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma(acc[i][j], a[i], b[j][0], b[j][1]);
    }
    __syncthreads();  // the stage is free for tile kt + 2 (or, last, for kDao's products)
  }

  // epilogue: this thread holds rows wm + 16 i + g (+ 8) and columns
  // wn + 8 j + 2 t (+ 1) of the tile
  float* prod = sm;  // kDao: (BM, SP) products dao * ao
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = wm + 16 * i + g + 8 * h, row = r0 + rl;
      if (row >= p.m) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cl = wn + 8 * j + 2 * t, col = n0 + cl;  // n even: col + 1 < nend too
        if (col >= nend) continue;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        const long idx = (long)row * p.n + col;
        if constexpr (EPI == kDz1) {
          const float2 z = *reinterpret_cast<const float2*>(p.z1 + idx);
          store2(p.out + idx, v0 * gelu_grad(z.x), v1 * gelu_grad(z.y));
          store2(p.h1 + idx, gelu(z.x), gelu(z.y));
        } else if constexpr (EPI == kDy) {
          store2(p.out + idx, v0, v1);
        } else {
          // column head Dh + d of row (b, tok): Dh even, so the pair stays in one head
          const int head = col / p.dh, d = col - head * p.dh, b = row / p.tokens;
          const long dst = (((long)b * p.heads + head) * p.tokens + row - b * p.tokens) * p.dh + d;
          store2(p.out + dst, v0, v1);
          const float2 a = *reinterpret_cast<const float2*>(p.ao + idx);
          prod[rl * SP + cl] = v0 * a.x;
          prod[rl * SP + cl + 1] = v1 * a.y;
        }
      }
    }
  }
  if constexpr (EPI == kDao) {
    __syncthreads();
    const int hpb = p.ncol / p.dh, head0 = n0 / p.dh;
    for (int task = threadIdx.x; task < BM * hpb; task += THREADS) {
      const int rl = task % BM, hh = task / BM, row = r0 + rl, head = head0 + hh;
      if (row >= p.m || head >= p.heads) continue;
      const float* q = prod + rl * SP + hh * p.dh;
      float s = 0.f;
      for (int d = 0; d < p.dh; ++d) s += q[d];
      const int b = row / p.tokens;
      p.delta[((long)b * p.heads + head) * p.tokens + row - b * p.tokens] = s;
    }
  }
}

template <int EPI>
int launch(const Params& p, void* stream) {
  if (p.m == 0) return 0;
  const dim3 grid((p.n + p.ncol - 1) / p.ncol, (p.m + BM - 1) / BM);
  cudaError_t err = cudaFuncSetAttribute(dy_gemm_f32_kernel<EPI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  dy_gemm_f32_kernel<EPI><<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace bwdf32
}  // namespace vk
