// Flash-attention backward dQ, `dot` and `l2` scores, for Hopper (sm_90a).
//
// Replaces the TPU kernels `_flash_bwd_dq_kernel` and its K/V-streaming
// variant `_flash_bwd_dq_kernel_dma` (vitgan_tpu/ops/attention.py:324-389,
// launched at :701): here K and V always stream through shared memory one
// tile at a time, at any length.
//
// Computes, per (batch*head, query):  dQ = inv_scale * dS K with
// dS = P * (dO V^T - delta), P = exp(S - lse) recomputed from the forward's
// natural-log LSE (flash_attn_bwd.cuh has the formulas).  For `l2` (a
// template parameter) S is recomputed from |q|^2 (the warp's rows, once) and
// |k|^2 (each streamed K tile, from shared memory behind a second barrier),
// the f32 row sums of dS are kept beside the dQ accumulator, and the
// epilogue writes dQ = 2 inv_scale (dS K - rowsum(dS) q) with q read back
// from the resident Q tile (attention.py:316-321).
//
// Design.  One block of 4 warps per (64-query tile, batch*head); each warp
// owns 16 queries, whose Q and dO fragments stay in registers with the f32
// dQ accumulator.  64-key K/V tiles stream through a two-stage cp.async ring
// with one barrier a tile.  S = Q K^T and dP = dO V^T run on the tensor cores
// (mma.sync m16n8k16), P and dS are formed on their accumulators in f32 (log2
// units, keys past n masked), and dS, cast to bf16, is the A operand of
// dQ += dS K straight from registers.
//
// Bound on this card.  At the highres128 discriminator's shape (64*6 heads,
// 1,025 tokens, Dh 64) a launch does three products of 2*N*N*Dh flops per
// head, 1.55e11 flops, on 255 MB of q/k/v/dO/dq and rows: 0.16 ms of
// tensor-core time against 0.08 ms of HBM time.
#include "flash_attn_bwd.cuh"

using namespace vk;
using vk::bwd::BK;
using vk::bwd::BQ;
using vk::bwd::LOG2E;
using vk::bwd::NWARP;

namespace {

template <int DP, int MODE>
constexpr size_t dq_smem_bytes() {
  // Q, dO + two stages of K and V (+ |k|^2 of the current K tile)
  return (size_t)(2 * BQ + 4 * BK) * (DP + 8) * 2 + (MODE != kDot ? BK * sizeof(float) : 0);
}

template <int DP, int MODE>
__global__ void __launch_bounds__(NWARP * 32)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int n, int d, float scale_log2, float inv_scale) {
  constexpr int LD = DP + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + BQ * LD;
  bf16* ks = dos + BQ * LD;      // stage s at ks + s * BK * LD
  bf16* vs = ks + 2 * BK * LD;
  float* kk_s = reinterpret_cast<float*>(vs + 2 * BK * LD);  // l2: |k|^2 of the tile

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const long bh = blockIdx.y;
  const long base = bh * (long)n * d;
  const bf16* kb = k + base;
  const bf16* vb = v + base;

  cp_tile(qs, LD, q + base, d, q0, 0, BQ, DP, n, d);
  cp_tile(dos, LD, dout + base, d, q0, 0, BQ, DP, n, d);
  cp_tile(ks, LD, kb, d, 0, 0, BK, DP, n, d);
  cp_tile(vs, LD, vb, d, 0, 0, BK, DP, n, d);
  cp_async_commit();

  float lse2[2], dl[2];  // rows g and g+8 of the warp
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + warp * 16 + g + 8 * h;
    lse2[h] = row < n ? lse[bh * n + row] * LOG2E : 0.f;
    dl[h] = row < n ? delta[bh * n + row] : 0.f;
  }

  uint32_t qf[DP / 16][4], dof[DP / 16][4];
  float acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float qq[2] = {0.f, 0.f}, rs[2] = {0.f, 0.f};  // l2: |q|^2 and this lane's part of rowsum(dS)

  const int ntiles = (n + BK - 1) / BK;
  for (int kt = 0; kt < ntiles; ++kt) {
    const int cur = kt & 1;
    // One barrier a tile: after it tile kt (and Q, dO) have landed and every
    // warp is done with tile kt - 1, whose stage takes tile kt + 1.
    cp_async_wait<0>();
    __syncthreads();
    if (kt + 1 < ntiles) {
      cp_tile(ks + (cur ^ 1) * BK * LD, LD, kb, d, (kt + 1) * BK, 0, BK, DP, n, d);
      cp_tile(vs + (cur ^ 1) * BK * LD, LD, vb, d, (kt + 1) * BK, 0, BK, DP, n, d);
    }
    cp_async_commit();
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        load_a(qf[kk], qs, LD, warp * 16, kk * 16);
        load_a(dof[kk], dos, LD, warp * 16, kk * 16);
      }
      if constexpr (MODE == kL2) frag_row_sq_norms<DP>(qq, qs, LD, warp * 16);
    }
    const bf16* k_s = ks + cur * BK * LD;
    const bf16* v_s = vs + cur * BK * LD;
    if constexpr (MODE == kL2) {
      row_sq_norms<DP>(kk_s, k_s, LD, BK);
      __syncthreads();
    }

    // S = Q K^T and dP = dO V^T: 16 x 64 per warp.
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < BK / 8; j += 2) {
        uint32_t b[4];
        load_b_nk(b, k_s, LD, kk * 16, j * 8);
        mma16816(s[j], qf[kk], b[0], b[1]);
        mma16816(s[j + 1], qf[kk], b[2], b[3]);
        load_b_nk(b, v_s, LD, kk * 16, j * 8);
        mma16816(dp[j], dof[kk], b[0], b[1]);
        mma16816(dp[j + 1], dof[kk], b[2], b[3]);
      }
    }
    // dS = P * (dP - delta): rows g (e = 0, 1) and g+8 (e = 2, 3), keys
    // kt*BK + 8j + 2t + (e & 1).
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1);
        const int key = kt * BK + col;
        const float p =
            key < n ? exp2f(score_log2<MODE>(s[j][e], qq[e >> 1],
                                             MODE == kL2 ? kk_s[col] : 0.f, scale_log2) -
                            lse2[e >> 1])
                    : 0.f;
        s[j][e] = p * (dp[j][e] - dl[e >> 1]);
        if constexpr (MODE == kL2) rs[e >> 1] += s[j][e];
      }
    }
    // dQ += dS K.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < DP / 8; j += 2) {
        uint32_t b[4];
        load_b_kn(b, k_s, LD, kk * 16, j * 8);
        mma16816(acc[j], a, b[0], b[1]);
        mma16816(acc[j + 1], a, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if constexpr (MODE == kL2) {  // the full rowsum: the lane's group of four
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
    }
    const int lrow = warp * 16 + g + 8 * h;
    const int row = q0 + lrow;
    if (row >= n) continue;
    bf16* dst = dq + base + (long)row * d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = j * 8 + 2 * t;
      if (col >= d) continue;
      if constexpr (MODE == kL2) {
        const float2 qv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(qs + lrow * LD + col));
        *reinterpret_cast<uint32_t*>(dst + col) =
            pack_bf16(2.f * inv_scale * (acc[j][2 * h] - rs[h] * qv.x),
                      2.f * inv_scale * (acc[j][2 * h + 1] - rs[h] * qv.y));
      } else {
        *reinterpret_cast<uint32_t*>(dst + col) =
            pack_bf16(acc[j][2 * h] * inv_scale, acc[j][2 * h + 1] * inv_scale);
      }
    }
  }
}

template <int DP, int MODE>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* dq, int bh, int n, int d, float inv_scale,
           cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<DP, MODE>();
  cudaFuncSetAttribute(flash_bwd_dq_kernel<DP, MODE>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid((n + BQ - 1) / BQ, bh);
  flash_bwd_dq_kernel<DP, MODE><<<grid, NWARP * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), n, d, inv_scale * LOG2E,
      inv_scale);
  return (int)cudaGetLastError();
}

template <int MODE>
int dispatch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
             const void* delta, void* dq, int bh, int n, int d, float inv_scale, cudaStream_t s) {
  switch ((d + 15) / 16) {
    case 1: return launch<16, MODE>(q, k, v, dout, lse, delta, dq, bh, n, d, inv_scale, s);
    case 2: return launch<32, MODE>(q, k, v, dout, lse, delta, dq, bh, n, d, inv_scale, s);
    case 3: return launch<48, MODE>(q, k, v, dout, lse, delta, dq, bh, n, d, inv_scale, s);
    case 4: return launch<64, MODE>(q, k, v, dout, lse, delta, dq, bh, n, d, inv_scale, s);
    case 5: return launch<80, MODE>(q, k, v, dout, lse, delta, dq, bh, n, d, inv_scale, s);
    case 6: return launch<96, MODE>(q, k, v, dout, lse, delta, dq, bh, n, d, inv_scale, s);
    case 7: return launch<112, MODE>(q, k, v, dout, lse, delta, dq, bh, n, d, inv_scale, s);
    case 8: return launch<128, MODE>(q, k, v, dout, lse, delta, dq, bh, n, d, inv_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, dout: (bh, n, d) bf16, contiguous, 16-byte aligned, d a multiple
// of 8 and at most 128.  lse (natural log) and delta: (bh, n) f32.  dq:
// (bh, n, d) bf16.  inv_scale multiplies q.k (`dot`) or the distance; mode 0
// `dot`, 1 `l2`.
extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dq, int bh, int n,
                                 int d, float inv_scale, int mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d % 8 != 0) return (int)cudaErrorInvalidValue;
  switch (mode) {
    case kDot: return dispatch<kDot>(q, k, v, dout, lse, delta, dq, bh, n, d, inv_scale, s);
    case kL2: return dispatch<kL2>(q, k, v, dout, lse, delta, dq, bh, n, d, inv_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
