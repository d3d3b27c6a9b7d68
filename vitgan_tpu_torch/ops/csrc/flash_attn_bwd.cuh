// Flash-attention backward, `dot` and `l2` scores, for Hopper (sm_90a): the
// k-block kernel shared by csrc/flash_attn_bwd_dkv.cu (FUSED = false) and
// csrc/flash_attn_bwd_fused.cu (FUSED = true).  csrc/flash_attn_bwd_dq.cu has
// the q-block kernel.
//
// With the forward's natural-log LSE and delta = rowsum(dO * O):
//   P  = exp(S - lse),  S = inv_scale * Q K^T (`dot`) or -inv_scale * d2 (`l2`,
//        d2 = max(|q|^2 + |k|^2 - 2 Q K^T, 0))
//   dV = P^T dO,  dS = P * (dO V^T - delta)
//   dot: dK = inv_scale * dS^T Q,  dQ = inv_scale * dS K
//   l2:  dK = 2 inv_scale (dS^T Q - colsum(dS) k),
//        dQ = 2 inv_scale (dS K - rowsum(dS) q)   (attention.py:290-292)
// P and dS are cast to bf16 before their products and every product
// accumulates in f32, as the TPU kernels do (attention.py:392-422); the sums
// of dS add the f32 values, as there.  The score mode is a template
// parameter; the `dot` instantiations carry none of the `l2` terms.
//
// Design of the k-block kernel.  One block of 4 warps owns 64 keys of one
// (batch*head); each warp owns 16 keys, whose K and V fragments stay in
// registers with the f32 dK and dV accumulators (and, for `l2`, its keys'
// |k|^2 and the lane's part of colsum(dS)).  Q, dO and the rows' LSE and
// delta stream through a two-stage ring, 64 queries a tile: the next tile's
// cp.async copies are in flight while the current one is used, with one
// barrier a tile.  The warp computes S^T = K Q^T (16 x 64), P^T, dV += P^T dO,
// dP^T = V dO^T, dS^T and dK += dS^T Q on the tensor cores (mma.sync m16n8k16,
// operands by ldmatrix), P^T and dS^T passing from accumulators to A operands
// in registers.  Padded queries read an LSE of +inf (P = 0) and keys past n
// are masked, so N need not be a multiple of 64 (N 1,025 is ragged).  The
// head dimension is padded to a multiple of 16 in shared memory only.  For
// `l2`, |q|^2 of each streamed Q tile is formed from its shared-memory copy
// into a 64-float array behind a second barrier; the epilogue reads k back
// from the resident K tile.
//
// FUSED adds dQ: the blocks run concurrently in no order, where the TPU
// kernel summed dQ over k-blocks in sequential grid order through VMEM
// (attention.py:507-590).  Here each tile's dS^T goes to shared memory as
// dS (queries x keys), the four warps form dS K for 16 queries each, and add
// it into an f32 buffer in device memory with float2 atomics; the entry point then
// scales and casts the buffer to bf16 in a second pass.  The order of the
// atomic additions varies from run to run, so dQ's bits do too.  For `l2`
// each warp also sums its 16 keys' f32 dS per query with shuffles and adds
// the sums into one f32 per row with atomics (the rowsum the TPU kernel keeps
// in VMEM, attention.py:571-574); the second pass applies the `l2` finish,
// so the `l2` dQ is not bit-deterministic either.
#pragma once

#include "common.cuh"

namespace vk {
namespace bwd {

constexpr int BK = 64;    // keys per block (k-block kernel) / per tile (q-block kernel)
constexpr int BQ = 64;    // queries per tile (k-block kernel) / per block (q-block kernel)
constexpr int NWARP = 4;  // 16 rows per warp
constexpr float LOG2E = 1.4426950408889634f;

// Rows [q0, q0 + BQ) of lse (in log2 units, +inf past n) and delta (0 past n)
// into shared memory: lse2[0..BQ), delta at lse2 + BQ.
__device__ inline void load_rows(float* lse2, const float* __restrict__ lse,
                                 const float* __restrict__ delta, int q0, int n) {
  for (int i = threadIdx.x; i < BQ; i += blockDim.x) {
    const int r = q0 + i;
    lse2[i] = r < n ? lse[r] * LOG2E : INFINITY;
    lse2[BQ + i] = r < n ? delta[r] : 0.f;
  }
}

template <int DP, bool FUSED, int MODE>
constexpr size_t kv_smem_bytes() {
  return (size_t)(2 * BK + 4 * BQ) * (DP + 8) * 2 + (FUSED ? (size_t)BQ * (BK + 8) * 2 : 0) +
         (4 + (MODE != kDot ? 1 : 0)) * BQ * sizeof(float);
}

template <int DP, bool FUSED, int MODE>
__global__ void __launch_bounds__(NWARP * 32)
flash_bwd_kv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dk, bf16* __restrict__ dv, float* __restrict__ dq_acc,
                    float* __restrict__ rs_acc, int n, int d, float scale_log2,
                    float inv_scale) {
  constexpr int LD = DP + 8;
  constexpr int LDS = BK + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + BK * LD;
  bf16* qs = vs + BK * LD;        // stage s at qs + s * BQ * LD
  bf16* dos = qs + 2 * BQ * LD;   // stage s at dos + s * BQ * LD
  bf16* dss = dos + 2 * BQ * LD;  // FUSED: dS of the tile, [query][key]
  float* rows = reinterpret_cast<float*>(dss + (FUSED ? BQ * LDS : 0));  // stage s at + 2*BQ*s
  float* qq_s = rows + 4 * BQ;  // l2: |q|^2 of the current Q tile

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * BK;
  const long bh = blockIdx.y;
  const long base = bh * (long)n * d;
  const bf16* qb = q + base;
  const bf16* dob = dout + base;
  const float* lseb = lse + bh * n;
  const float* deltab = delta + bh * n;

  cp_tile(ks, LD, k + base, d, k0, 0, BK, DP, n, d);
  cp_tile(vs, LD, v + base, d, k0, 0, BK, DP, n, d);
  cp_tile(qs, LD, qb, d, 0, 0, BQ, DP, n, d);
  cp_tile(dos, LD, dob, d, 0, 0, BQ, DP, n, d);
  cp_async_commit();
  load_rows(rows, lseb, deltab, 0, n);

  uint32_t kf[DP / 16][4], vf[DP / 16][4];
  float dk_acc[DP / 8][4], dv_acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;
  float ksq[2] = {0.f, 0.f}, cs[2] = {0.f, 0.f};  // l2: |k|^2 and this lane's part of colsum(dS)

  const int ntiles = (n + BQ - 1) / BQ;
  for (int qt = 0; qt < ntiles; ++qt) {
    const int cur = qt & 1;
    // One barrier a tile: after it tile qt has landed and every warp is done
    // with tile qt - 1 (and its dS), whose stage takes tile qt + 1.
    cp_async_wait<0>();
    __syncthreads();
    if (qt + 1 < ntiles) {
      cp_tile(qs + (cur ^ 1) * BQ * LD, LD, qb, d, (qt + 1) * BQ, 0, BQ, DP, n, d);
      cp_tile(dos + (cur ^ 1) * BQ * LD, LD, dob, d, (qt + 1) * BQ, 0, BQ, DP, n, d);
      load_rows(rows + (cur ^ 1) * 2 * BQ, lseb, deltab, (qt + 1) * BQ, n);
    }
    cp_async_commit();
    if (qt == 0) {
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        load_a(kf[kk], ks, LD, warp * 16, kk * 16);
        load_a(vf[kk], vs, LD, warp * 16, kk * 16);
      }
      if constexpr (MODE == kL2) frag_row_sq_norms<DP>(ksq, ks, LD, warp * 16);
    }
    const bf16* q_s = qs + cur * BQ * LD;
    const bf16* do_s = dos + cur * BQ * LD;
    const float* lse2 = rows + cur * 2 * BQ;
    const float* dl = lse2 + BQ;
    if constexpr (MODE == kL2) {
      row_sq_norms<DP>(qq_s, q_s, LD, BQ);
      __syncthreads();
    }

    // S^T = K Q^T: 16 keys x 64 queries per warp.
    float s[BQ / 8][4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < BQ / 8; j += 2) {
        uint32_t b[4];
        load_b_nk(b, q_s, LD, kk * 16, j * 8);
        mma16816(s[j], kf[kk], b[0], b[1]);
        mma16816(s[j + 1], kf[kk], b[2], b[3]);
      }
    }
    // P^T: this lane holds keys g (e = 0, 1) and g+8 (e = 2, 3) of the warp,
    // queries 8j + 2t + (e & 1) of the tile.
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + warp * 16 + g + 8 * (e >> 1);
        const int col = j * 8 + 2 * t + (e & 1);
        s[j][e] = key < n ? exp2f(score_log2<MODE>(s[j][e], MODE == kL2 ? qq_s[col] : 0.f,
                                                   ksq[e >> 1], scale_log2) -
                                  lse2[col])
                          : 0.f;
      }
    }
    // dV += P^T dO.
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < DP / 8; j += 2) {
        uint32_t b[4];
        load_b_kn(b, do_s, LD, kk * 16, j * 8);
        mma16816(dv_acc[j], a, b[0], b[1]);
        mma16816(dv_acc[j + 1], a, b[2], b[3]);
      }
    }
    // dP^T = V dO^T, then dS^T = P^T * (dP^T - delta) in place.
    float ds[BQ / 8][4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) ds[j][0] = ds[j][1] = ds[j][2] = ds[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < BQ / 8; j += 2) {
        uint32_t b[4];
        load_b_nk(b, do_s, LD, kk * 16, j * 8);
        mma16816(ds[j], vf[kk], b[0], b[1]);
        mma16816(ds[j + 1], vf[kk], b[2], b[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ds[j][e] = s[j][e] * (ds[j][e] - dl[j * 8 + 2 * t + (e & 1)]);
        if constexpr (MODE == kL2) cs[e >> 1] += ds[j][e];
      }
    // dK += dS^T Q.
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(ds[2 * kk][0], ds[2 * kk][1]),
                             pack_bf16(ds[2 * kk][2], ds[2 * kk][3]),
                             pack_bf16(ds[2 * kk + 1][0], ds[2 * kk + 1][1]),
                             pack_bf16(ds[2 * kk + 1][2], ds[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < DP / 8; j += 2) {
        uint32_t b[4];
        load_b_kn(b, q_s, LD, kk * 16, j * 8);
        mma16816(dk_acc[j], a, b[0], b[1]);
        mma16816(dk_acc[j + 1], a, b[2], b[3]);
      }
    }
    if constexpr (FUSED && MODE == kL2) {
      // rowsum(dS) over the warp's 16 keys for each query of the tile: the
      // lane's two keys, then the eight lanes g of each query column; lanes
      // 0-3 add the sums for queries 8j + 2t + c into rs_acc.
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float r = ds[j][c] + ds[j][2 + c];
          r += __shfl_xor_sync(0xffffffffu, r, 4);
          r += __shfl_xor_sync(0xffffffffu, r, 8);
          r += __shfl_xor_sync(0xffffffffu, r, 16);
          const int row = qt * BQ + j * 8 + 2 * t + c;
          if (g == 0 && row < n) atomicAdd(rs_acc + bh * n + row, r);
        }
      }
    }
    if constexpr (FUSED) {
      // dS of the tile into shared memory as [query][key] ...
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dss[(j * 8 + 2 * t + (e & 1)) * LDS + warp * 16 + g + 8 * (e >> 1)] =
              __float2bfloat16(ds[j][e]);
      __syncthreads();
      // ... then dS K for queries 16 * warp .. 16 * warp + 15 of the tile,
      // added into dq_acc.
      float dq[DP / 8][4];
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[4];
        load_a(a, dss, LDS, warp * 16, kk * 16);
#pragma unroll
        for (int j = 0; j < DP / 8; j += 2) {
          uint32_t b[4];
          load_b_kn(b, ks, LD, kk * 16, j * 8);
          mma16816(dq[j], a, b[0], b[1]);
          mma16816(dq[j + 1], a, b[2], b[3]);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = qt * BQ + warp * 16 + g + 8 * h;
        if (row >= n) continue;
        float* dst = dq_acc + base + (long)row * d;
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
          const int col = j * 8 + 2 * t;
          if (col < d)  // one 8-byte atomic for the lane's two columns (sm_90)
            atomicAdd(reinterpret_cast<float2*>(dst + col),
                      make_float2(dq[j][2 * h], dq[j][2 * h + 1]));
        }
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if constexpr (MODE == kL2) {  // the full colsum: the lane's group of four
      cs[h] += __shfl_xor_sync(0xffffffffu, cs[h], 1);
      cs[h] += __shfl_xor_sync(0xffffffffu, cs[h], 2);
    }
    const int lkey = warp * 16 + g + 8 * h;
    const int key = k0 + lkey;
    if (key >= n) continue;
    bf16* dkr = dk + base + (long)key * d;
    bf16* dvr = dv + base + (long)key * d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = j * 8 + 2 * t;
      if (col < d) {
        if constexpr (MODE == kL2) {
          const float2 kv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(ks + lkey * LD + col));
          *reinterpret_cast<uint32_t*>(dkr + col) =
              pack_bf16(2.f * inv_scale * (dk_acc[j][2 * h] - cs[h] * kv.x),
                        2.f * inv_scale * (dk_acc[j][2 * h + 1] - cs[h] * kv.y));
        } else {
          *reinterpret_cast<uint32_t*>(dkr + col) =
              pack_bf16(dk_acc[j][2 * h] * inv_scale, dk_acc[j][2 * h + 1] * inv_scale);
        }
        *reinterpret_cast<uint32_t*>(dvr + col) = pack_bf16(dv_acc[j][2 * h], dv_acc[j][2 * h + 1]);
      }
    }
  }
}

template <int DP, bool FUSED, int MODE>
int launch_kv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dk, void* dv, void* dq_acc, void* rs_acc, int bh, int n,
              int d, float inv_scale, cudaStream_t stream) {
  const size_t smem = kv_smem_bytes<DP, FUSED, MODE>();
  cudaFuncSetAttribute(flash_bwd_kv_kernel<DP, FUSED, MODE>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid((n + BK - 1) / BK, bh);
  flash_bwd_kv_kernel<DP, FUSED, MODE><<<grid, NWARP * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      static_cast<float*>(dq_acc), static_cast<float*>(rs_acc), n, d, inv_scale * LOG2E,
      inv_scale);
  return (int)cudaGetLastError();
}

template <bool FUSED, int MODE>
int dispatch_kv_mode(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dk, void* dv, void* dq_acc,
                     void* rs_acc, int bh, int n, int d, float inv_scale, cudaStream_t s) {
#define VK_KV(DP) \
  launch_kv<DP, FUSED, MODE>(q, k, v, dout, lse, delta, dk, dv, dq_acc, rs_acc, bh, n, d, \
                             inv_scale, s)
  switch ((d + 15) / 16) {
    case 1: return VK_KV(16);
    case 2: return VK_KV(32);
    case 3: return VK_KV(48);
    case 4: return VK_KV(64);
    case 5: return VK_KV(80);
    case 6: return VK_KV(96);
    case 7: return VK_KV(112);
    case 8: return VK_KV(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef VK_KV
}

// mode 0 `dot`, 1 `l2`; rs_acc (FUSED `l2` only) is the rows' dS sums.
template <bool FUSED>
int dispatch_kv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                const void* delta, void* dk, void* dv, void* dq_acc, void* rs_acc, int bh, int n,
                int d, float inv_scale, int mode, cudaStream_t s) {
  if (d % 8 != 0) return (int)cudaErrorInvalidValue;
  switch (mode) {
    case kDot:
      return dispatch_kv_mode<FUSED, kDot>(q, k, v, dout, lse, delta, dk, dv, dq_acc, rs_acc,
                                           bh, n, d, inv_scale, s);
    case kL2:
      return dispatch_kv_mode<FUSED, kL2>(q, k, v, dout, lse, delta, dk, dv, dq_acc, rs_acc,
                                          bh, n, d, inv_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace bwd
}  // namespace vk
