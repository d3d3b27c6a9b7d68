// Flash-attention backward dQ, `dot` scores, for Hopper (sm_90a).
//
// Replaces the TPU kernels `_flash_bwd_dq_kernel` and its K/V-streaming
// variant `_flash_bwd_dq_kernel_dma` (vitgan_tpu/ops/attention.py:324-389,
// launched at :701): here K and V always stream through shared memory one
// tile at a time, at any length.
//
// Computes, per (batch*head, query):  dQ = inv_scale * dS K with
// dS = P * (dO V^T - delta), P = exp(inv_scale * Q K^T - lse) recomputed from
// the forward's natural-log LSE (flash_attn_bwd.cuh has the formulas).
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

template <int DP>
constexpr size_t dq_smem_bytes() {
  return (size_t)(2 * BQ + 4 * BK) * (DP + 8) * 2;  // Q, dO + two stages of K and V
}

template <int DP>
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
    }
    const bf16* k_s = ks + cur * BK * LD;
    const bf16* v_s = vs + cur * BK * LD;

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
        const int key = kt * BK + j * 8 + 2 * t + (e & 1);
        const float p = key < n ? exp2f(s[j][e] * scale_log2 - lse2[e >> 1]) : 0.f;
        s[j][e] = p * (dp[j][e] - dl[e >> 1]);
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
    const int row = q0 + warp * 16 + g + 8 * h;
    if (row >= n) continue;
    bf16* dst = dq + base + (long)row * d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = j * 8 + 2 * t;
      if (col < d)
        *reinterpret_cast<uint32_t*>(dst + col) =
            pack_bf16(acc[j][2 * h] * inv_scale, acc[j][2 * h + 1] * inv_scale);
    }
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* dq, int bh, int n, int d, float inv_scale,
           cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<DP>();
  cudaFuncSetAttribute(flash_bwd_dq_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid((n + BQ - 1) / BQ, bh);
  flash_bwd_dq_kernel<DP><<<grid, NWARP * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), n, d, inv_scale * LOG2E,
      inv_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, dout: (bh, n, d) bf16, contiguous, 16-byte aligned, d a multiple
// of 8 and at most 128.  lse (natural log) and delta: (bh, n) f32.  dq:
// (bh, n, d) bf16.  inv_scale multiplies q.k.
extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dq, int bh, int n,
                                 int d, float inv_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d % 8 != 0) return (int)cudaErrorInvalidValue;
  switch ((d + 15) / 16) {
    case 1: return launch<16>(q, k, v, dout, lse, delta, dq, bh, n, d, inv_scale, s);
    case 2: return launch<32>(q, k, v, dout, lse, delta, dq, bh, n, d, inv_scale, s);
    case 3: return launch<48>(q, k, v, dout, lse, delta, dq, bh, n, d, inv_scale, s);
    case 4: return launch<64>(q, k, v, dout, lse, delta, dq, bh, n, d, inv_scale, s);
    case 5: return launch<80>(q, k, v, dout, lse, delta, dq, bh, n, d, inv_scale, s);
    case 6: return launch<96>(q, k, v, dout, lse, delta, dq, bh, n, d, inv_scale, s);
    case 7: return launch<112>(q, k, v, dout, lse, delta, dq, bh, n, d, inv_scale, s);
    case 8: return launch<128>(q, k, v, dout, lse, delta, dq, bh, n, d, inv_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
