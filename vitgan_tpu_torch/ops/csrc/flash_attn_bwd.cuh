// Flash-attention backward, `dot` and `l2` scores, for Hopper (sm_90a): the
// k-block kernel shared by csrc/flash_attn_bwd_dkv.cu (FUSED = false) and
// csrc/flash_attn_bwd_fused.cu (FUSED = true).  csrc/flash_attn_bwd_dq.cu has
// the q-block kernel.  Replaces the TPU kernels `_flash_bwd_dkv_kernel(_dma)`
// (vitgan_tpu/ops/attention.py:434-504, pallas_call at :727) and
// `_flash_bwd_fused_kernel` (:507-590, pallas_call at :606); the two entries'
// head notes give the bound on this card and what ptxas -v reports.
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
// of dS add the f32 values, as there.
//
// Two designs, one for each score mode.  `dot` (the highres128 and
// v1-generator path) runs the wgmma kernel below (namespace wg); `l2` (the v1
// discriminator, host-bound at 50 tokens) runs the mma.sync kernel,
// flash_bwd_kv_kernel, which carries the `l2` terms.
//
// The `dot` k-block kernel (flash_bwd_kv_wgmma_kernel<DP, FUSED>).  One block
// of 384 threads owns 128 keys of one (batch*head).  Warpgroup 0 produces:
// warp 0 loads the block's K and V once by TMA (3-D tensor maps over (d, n,
// bh), so keys and queries past n read zeros), then streams Q and dO, 64
// queries a tile, through a ring of 5 stages (2 at DP > 64) on full/empty
// mbarriers; warp 1 stores the tile's LSE (log2 units, +inf past n) and
// delta beside them, the next tile's loads in flight.  Warpgroups 1 and 2
// consume, 64 keys each, with dK and dV in f32 registers:
//   S^T = K Q^T and dP^T = V dO^T   wgmma m64n64k16, both operands K-major in
//                                   shared memory (128-byte swizzle);
//   P^T, dS^T                       on the accumulators, keys and queries
//                                   past n masked to P = 0;
//   dV += P^T dO, dK += dS^T Q      wgmma with A (P^T, dS^T in bf16) from
//                                   registers, B N-major from the same tiles;
// the stage is released once a tile's dV and dK retire, the other
// warpgroup's products overlapping this one's exp and dS.  The head
// dimension runs DP (a multiple of 16) deep in S and dP and 64 or 128 wide
// (zero columns) in dV, dK and dQ: 64-column boxes, two past Dh 64.
// FUSED adds dQ, which the TPU kernel summed over k-blocks in sequential
// grid order (attention.py:507-590): both warpgroups write their dS^T into
// one of two swizzled shared buffers, meet at a named barrier, and one
// warpgroup a tile in turn forms dQ = dS K over the block's 128 keys (wgmma,
// A M-major from the dS^T buffer, B N-major from the resident K) and adds it
// into an f32 buffer with vector RED (float4 atomicAdd, lanes pairing their
// fragments); the entry point scales and casts it.  The order of the
// additions varies from run to run, so dQ's bits do too; dK and dV are
// bit-deterministic.
//
// What held the mma.sync design back, and what this does about it: 64 keys a
// block on 4 warps, each reading every streamed Q and dO tile from shared
// memory by ldmatrix for 16 keys (now 128 keys on two warpgroups, operands
// read by wgmma's descriptors); a two-stage cp.async ring behind one block
// barrier a tile (now TMA on mbarriers, the producer apart); dQ by float2
// atomics of every warp, 16 keys deep (now 128 keys deep, four floats a
// RED: half the additions).
//
// The `l2` kernel (flash_bwd_kv_kernel<DP, FUSED>).  One block of 4
// warps owns 64 keys; each warp owns 16 keys, whose K and V fragments stay in
// registers with the f32 dK and dV accumulators, its keys' |k|^2 and the
// lane's part of colsum(dS).  Q, dO and the rows' LSE and delta stream
// through a two-stage cp.async ring, 64 queries a tile, one barrier a tile;
// mma.sync m16n8k16 with ldmatrix operands; |q|^2 of each streamed Q tile is
// formed from its shared-memory copy behind a second barrier; the epilogue
// reads k back from the resident K tile.  FUSED: each tile's dS goes to
// shared memory, the four warps form dS K for 16 queries each and add it into
// the f32 buffer with float2 atomics; each warp also adds its 16 keys' f32 dS
// per query into one f32 per row (the rowsum the TPU kernel keeps in VMEM,
// attention.py:571-574), and the second pass applies the `l2` finish, so the
// `l2` dQ is not bit-deterministic either.
#pragma once

#include "hopper.cuh"

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

template <int DP, bool FUSED>
constexpr size_t kv_smem_bytes() {
  return (size_t)(2 * BK + 4 * BQ) * (DP + 8) * 2 + (FUSED ? (size_t)BQ * (BK + 8) * 2 : 0) +
         5 * BQ * sizeof(float);
}

template <int DP, bool FUSED>
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
  float* qq_s = rows + 4 * BQ;  // |q|^2 of the current Q tile

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
  float ksq[2] = {0.f, 0.f}, cs[2] = {0.f, 0.f};  // |k|^2 and this lane's part of colsum(dS)

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
      frag_row_sq_norms<DP>(ksq, ks, LD, warp * 16);
    }
    const bf16* q_s = qs + cur * BQ * LD;
    const bf16* do_s = dos + cur * BQ * LD;
    const float* lse2 = rows + cur * 2 * BQ;
    const float* dl = lse2 + BQ;
    row_sq_norms<DP>(qq_s, q_s, LD, BQ);
    __syncthreads();

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
        s[j][e] = key < n ? exp2f(score_log2<kL2>(s[j][e], qq_s[col], ksq[e >> 1], scale_log2) -
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
        cs[e >> 1] += ds[j][e];
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
    if constexpr (FUSED) {
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
    // the full colsum: the lane's group of four
    cs[h] += __shfl_xor_sync(0xffffffffu, cs[h], 1);
    cs[h] += __shfl_xor_sync(0xffffffffu, cs[h], 2);
    const int lkey = warp * 16 + g + 8 * h;
    const int key = k0 + lkey;
    if (key >= n) continue;
    bf16* dkr = dk + base + (long)key * d;
    bf16* dvr = dv + base + (long)key * d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = j * 8 + 2 * t;
      if (col < d) {
        const float2 kv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(ks + lkey * LD + col));
        *reinterpret_cast<uint32_t*>(dkr + col) =
            pack_bf16(2.f * inv_scale * (dk_acc[j][2 * h] - cs[h] * kv.x),
                      2.f * inv_scale * (dk_acc[j][2 * h + 1] - cs[h] * kv.y));
        *reinterpret_cast<uint32_t*>(dvr + col) = pack_bf16(dv_acc[j][2 * h], dv_acc[j][2 * h + 1]);
      }
    }
  }
}

template <int DP, bool FUSED>
int launch_kv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dk, void* dv, void* dq_acc, void* rs_acc, int bh, int n,
              int d, float inv_scale, cudaStream_t stream) {
  const size_t smem = kv_smem_bytes<DP, FUSED>();
  cudaFuncSetAttribute(flash_bwd_kv_kernel<DP, FUSED>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid((n + BK - 1) / BK, bh);
  flash_bwd_kv_kernel<DP, FUSED><<<grid, NWARP * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      static_cast<float*>(dq_acc), static_cast<float*>(rs_acc), n, d, inv_scale * LOG2E,
      inv_scale);
  return (int)cudaGetLastError();
}

template <bool FUSED>
int dispatch_kv_l2(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dk, void* dv, void* dq_acc,
                   void* rs_acc, int bh, int n, int d, float inv_scale, cudaStream_t s) {
#define VK_KV(DP) \
  launch_kv<DP, FUSED>(q, k, v, dout, lse, delta, dk, dv, dq_acc, rs_acc, bh, n, d, inv_scale, s)
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

// --- the `dot` k-block kernel: wgmma, TMA and mbarrier rings -----------------

namespace wg {

constexpr int KEYS = 128;     // keys per block: two consumer warpgroups of 64
constexpr int TQ = 64;        // queries per streamed tile
constexpr int THREADS = 384;  // producer warpgroup + two consumer warpgroups

// Shared-memory geometry for a head dimension padded to DP (a multiple of
// 16): NB boxes of 64 columns per row (zero-filled past d), so the dV, dK
// and dQ products run N = DPAD = 64 NB columns.
template <int DP>
struct Geo {
  static constexpr int NB = (DP + 63) / 64;
  static constexpr int DPAD = 64 * NB;
  static constexpr int STAGES = NB == 1 ? 5 : 2;
  static constexpr int KBOX = KEYS * 128;  // one 64-column box of K or V, bytes
  static constexpr int QBOX = TQ * 128;    // one box of a Q or dO tile
  static constexpr int STAGE = 2 * NB * QBOX;
  static constexpr int DS = KEYS * 128;    // one dS^T buffer: 128 keys x 64 queries
};

template <int DP, bool FUSED>
constexpr int smem_bytes() {
  using G = Geo<DP>;
  return 1024 + 2 * G::NB * G::KBOX + G::STAGES * G::STAGE + (FUSED ? 2 * G::DS : 0) +
         G::STAGES * 2 * TQ * 4 + (2 * G::STAGES + 1) * 8;
}

// m64nNk16 products with N = 64 or 128 (the accumulator holds N / 2 floats).
template <int N, int TA, int TB>
__device__ inline void mma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (N == 64) {
    hopper::wgmma_ss64<TA, TB>(d, a, b, scale_d);
  } else {
    hopper::wgmma_ss128<TA, TB>(d, a, b, scale_d);
  }
}
template <int N>
__device__ inline void mma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 64) {
    hopper::wgmma_rs64<1>(d, a, b);
  } else {
    hopper::wgmma_rs128<1>(d, a, b);
  }
}

template <int DP, bool FUSED>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_kv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          float* __restrict__ dq_acc, int n, int d, float scale_log2,
                          float inv_scale) {
  using namespace hopper;
  using G = Geo<DP>;
  constexpr int NB = G::NB, DPAD = G::DPAD, ST = G::STAGES, NA = DPAD / 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* ks = smem;
  unsigned char* vs = ks + NB * G::KBOX;
  unsigned char* stages = vs + NB * G::KBOX;  // stage s: NB boxes of Q, then NB of dO
  unsigned char* dss = stages + ST * G::STAGE;  // FUSED: two dS^T buffers
  float* rows = reinterpret_cast<float*>(dss + (FUSED ? 2 * G::DS : 0));  // stage s: lse2, delta
  uint64_t* full = reinterpret_cast<uint64_t*>(rows + ST * 2 * TQ);
  uint64_t* empty = full + ST;
  uint64_t* kvbar = empty + ST;

  const int wgi = threadIdx.x >> 7, lane = threadIdx.x & 31;
  const int k0 = blockIdx.x * KEYS, bh = blockIdx.y;
  const int ntiles = (n + TQ - 1) / TQ;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 33);  // warp 0's lane 0 (with the TMA bytes), warp 1's 32 lanes
      mbar_init(&empty[s], 2);  // the two consumer warpgroups
    }
    mbar_init(kvbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wgi == 0) {  // producer: warp 0 issues the TMA loads, warp 1 the rows' LSE and delta
    reg_dealloc<40>();
    if (threadIdx.x == 0) {
      mbar_arrive_tx(kvbar, 2 * NB * G::KBOX);
      for (int b = 0; b < NB; ++b) {
        tma_load_3d(ks + b * G::KBOX, &tk, kvbar, 64 * b, k0, bh);
        tma_load_3d(vs + b * G::KBOX, &tv, kvbar, 64 * b, k0, bh);
      }
      for (int qt = 0; qt < ntiles; ++qt) {
        const int s = qt % ST;
        if (qt >= ST) mbar_wait(&empty[s], ((qt / ST) - 1) & 1);
        unsigned char* st = stages + s * G::STAGE;
        mbar_arrive_tx(&full[s], 2 * NB * G::QBOX);
        for (int b = 0; b < NB; ++b) {
          tma_load_3d(st + b * G::QBOX, &tq, &full[s], 64 * b, qt * TQ, bh);
          tma_load_3d(st + (NB + b) * G::QBOX, &tdo, &full[s], 64 * b, qt * TQ, bh);
        }
      }
    } else if ((threadIdx.x >> 5) == 1) {
      // lse in log2 units (+inf past n) and delta (0 past n), two rows a
      // lane, the next tile's loads in flight while this one's are stored
      const float* lseb = lse + (long)bh * n;
      const float* deltab = delta + (long)bh * n;
      auto fetch = [&](int qt, float (&v)[4]) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = qt * TQ + lane + 32 * h;
          v[h] = r < n ? lseb[r] * LOG2E : INFINITY;
          v[2 + h] = r < n ? deltab[r] : 0.f;
        }
      };
      float cur[4], nxt[4];
      fetch(0, cur);
      for (int qt = 0; qt < ntiles; ++qt) {
        const int s = qt % ST;
        if (qt + 1 < ntiles) fetch(qt + 1, nxt);
        if (qt >= ST) mbar_wait(&empty[s], ((qt / ST) - 1) & 1);
        float* rw = rows + s * 2 * TQ;
        rw[lane] = cur[0];
        rw[lane + 32] = cur[1];
        rw[TQ + lane] = cur[2];
        rw[TQ + lane + 32] = cur[3];
        mbar_arrive(&full[s]);
#pragma unroll
        for (int i = 0; i < 4; ++i) cur[i] = nxt[i];
      }
    }
    return;
  }

  // consumers: warpgroup w owns keys k0 + 64 w .. + 63
  reg_alloc<232>();
  const int w = wgi - 1, ct = threadIdx.x & 127, wr = ct >> 5, g = lane >> 2, t = lane & 3;
  float dka[NA], dva[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) dka[i] = dva[i] = 0.f;
  const unsigned char* kw = ks + w * 64 * 128;  // the warpgroup's keys in each K box
  const unsigned char* vw = vs + w * 64 * 128;
  mbar_wait(kvbar, 0);

  for (int qt = 0; qt < ntiles; ++qt) {
    const int s = qt % ST;
    mbar_wait(&full[s], (qt / ST) & 1);
    const unsigned char* qs = stages + s * G::STAGE;
    const unsigned char* dos = qs + NB * G::QBOX;
    // S^T = K Q^T and dP^T = V dO^T (64 keys x 64 queries; Q and dO K-major),
    // one wgmma group each.  The first step overwrites the accumulators
    // (scale_d 0): no other instruction writes them while wgmmas are in flight.
    float sa[32], pa[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss64<0, 0>(sa, desc_sw128(kw + (kk >> 2) * G::KBOX + (kk & 3) * 32, 16, 1024),
                       desc_sw128(qs + (kk >> 2) * G::QBOX + (kk & 3) * 32, 16, 1024), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss64<0, 0>(pa, desc_sw128(vw + (kk >> 2) * G::KBOX + (kk & 3) * 32, 16, 1024),
                       desc_sw128(dos + (kk >> 2) * G::QBOX + (kk & 3) * 32, 16, 1024), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // S
    fence_regs(sa);
    // P^T in place: this thread holds keys 16 wr + g + 8 (e >> 1) of the
    // warpgroup, queries 8 j + 2 t + (e & 1) of the tile
    const float* lse2 = rows + s * 2 * TQ;
    const float* dl = lse2 + TQ;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * t;
      const float2 l = *reinterpret_cast<const float2*>(lse2 + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 64 * w + 16 * wr + g + 8 * (e >> 1);
        const bool ok = key < n && qt * TQ + col + (e & 1) < n;
        sa[4 * j + e] = ok ? exp2f(sa[4 * j + e] * scale_log2 - ((e & 1) ? l.y : l.x)) : 0.f;
      }
    }
    // dV += P^T dO (A: P^T in bf16 from registers, 16 queries a step; B: dO N-major)
    uint32_t pf[4][4], df[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) pf[kk][r] = pack_bf16(sa[8 * kk + 2 * r], sa[8 * kk + 2 * r + 1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_rs<DPAD>(dva, pf[kk], desc_sw128(dos + kk * 2048, G::QBOX, 1024));
    wgmma_commit();
    wgmma_wait<1>();  // dP
    fence_regs(pa);
    // dS^T = P^T * (dP^T - delta) in place
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 dd = *reinterpret_cast<const float2*>(dl + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pa[4 * j + e] = sa[4 * j + e] * (pa[4 * j + e] - ((e & 1) ? dd.y : dd.x));
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) df[kk][r] = pack_bf16(pa[8 * kk + 2 * r], pa[8 * kk + 2 * r + 1]);
    if constexpr (FUSED) {
      // dS^T into this tile's buffer, row = key, 64 queries a 128-byte swizzled row
      unsigned char* dsb = dss + (qt & 1) * G::DS;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 64 * w + 16 * wr + g + 8 * h;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<uint32_t*>(dsb + r * 128 + ((j ^ (r & 7)) << 4) + 4 * t) =
              pack_bf16(pa[4 * j + 2 * h], pa[4 * j + 2 * h + 1]);
      }
    }
    // dK += dS^T Q (B: Q N-major)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_rs<DPAD>(dka, df[kk], desc_sw128(qs + kk * 2048, G::QBOX, 1024));
    wgmma_commit();
    // dV and dK retire within the tile: then the stage's Q, dO, lse and delta
    // are free.  (Keeping them in flight under the next tile's S and dP made
    // ptxas serialise every wgmma of the loop, C7515/C7520: slower.)
    wgmma_wait<0>();
    fence_frags(pf);
    fence_frags(df);
    if (ct == 0) mbar_arrive(&empty[s]);

    if constexpr (FUSED) {
      // dQ of the tile = dS K over the block's 128 keys, by one warpgroup a
      // tile in turn, added into dq_acc four columns a thread (vector RED)
      fence_proxy_async();
      named_bar_sync(1, 256);
      if (w == (qt & 1)) {
        const unsigned char* dsb = dss + (qt & 1) * G::DS;
        float qa[NA];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KEYS / 16; ++kk)
          mma_ss<DPAD, 1, 1>(qa, desc_sw128(dsb + kk * 2048, G::DS, 1024),
                             desc_sw128(ks + kk * 2048, G::KBOX, 1024), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(qa);
#pragma unroll
        for (int j = 0; j < DPAD / 8; ++j) {
          // lanes t and t ^ 1 swap halves: even t takes row g, odd t row g + 8
          const float x0 = (t & 1) ? qa[4 * j] : qa[4 * j + 2];
          const float x1 = (t & 1) ? qa[4 * j + 1] : qa[4 * j + 3];
          const float y0 = __shfl_xor_sync(0xffffffffu, x0, 1);
          const float y1 = __shfl_xor_sync(0xffffffffu, x1, 1);
          const int row = qt * TQ + 16 * wr + g + ((t & 1) ? 8 : 0);
          const int col = 8 * j + 2 * (t & 2);
          const float4 v = (t & 1) ? make_float4(y0, y1, qa[4 * j + 2], qa[4 * j + 3])
                                   : make_float4(qa[4 * j], qa[4 * j + 1], y0, y1);
          if (row < n && col < d)
            atomicAdd(reinterpret_cast<float4*>(dq_acc + ((long)bh * n + row) * d + col), v);
        }
      }
    }
  }

  wgmma_wait<0>();
  fence_regs(dva);
  fence_regs(dka);

  // dK = inv_scale dS^T Q and dV, bf16, keys < n and columns < d
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + 64 * w + 16 * wr + g + 8 * h;
    if (key >= n) continue;
    bf16* dkr = dk + ((long)bh * n + key) * d;
    bf16* dvr = dv + ((long)bh * n + key) * d;
#pragma unroll
    for (int j = 0; j < DPAD / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (col < d) {
        *reinterpret_cast<uint32_t*>(dkr + col) =
            pack_bf16(dka[4 * j + 2 * h] * inv_scale, dka[4 * j + 2 * h + 1] * inv_scale);
        *reinterpret_cast<uint32_t*>(dvr + col) = pack_bf16(dva[4 * j + 2 * h], dva[4 * j + 2 * h + 1]);
      }
    }
  }
}

template <int DP, bool FUSED>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* dk, void* dv, void* dq_acc, int bh, int n, int d,
           float inv_scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  const uint64_t dims[3] = {(uint64_t)d, (uint64_t)n, (uint64_t)bh};
  const uint64_t strides[2] = {(uint64_t)d * 2, (uint64_t)n * d * 2};
  const uint32_t qbox[3] = {64, TQ, 1}, kbox[3] = {64, KEYS, 1};
  int err = hopper::make_tmap_bf16(&tq, q, 3, dims, strides, qbox);
  if (!err) err = hopper::make_tmap_bf16(&tdo, dout, 3, dims, strides, qbox);
  if (!err) err = hopper::make_tmap_bf16(&tk, k, 3, dims, strides, kbox);
  if (!err) err = hopper::make_tmap_bf16(&tv, v, 3, dims, strides, kbox);
  if (err) return err;
  constexpr int smem = smem_bytes<DP, FUSED>();
  cudaFuncSetAttribute(flash_bwd_kv_wgmma_kernel<DP, FUSED>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((n + KEYS - 1) / KEYS, bh);
  flash_bwd_kv_wgmma_kernel<DP, FUSED><<<grid, THREADS, smem, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), static_cast<float*>(dq_acc), n, d,
      inv_scale * LOG2E, inv_scale);
  return (int)cudaGetLastError();
}

template <bool FUSED>
int dispatch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
             const void* delta, void* dk, void* dv, void* dq_acc, int bh, int n, int d,
             float inv_scale, cudaStream_t s) {
#define VK_WG(DP) launch<DP, FUSED>(q, k, v, dout, lse, delta, dk, dv, dq_acc, bh, n, d, inv_scale, s)
  switch ((d + 15) / 16) {
    case 1: return VK_WG(16);
    case 2: return VK_WG(32);
    case 3: return VK_WG(48);
    case 4: return VK_WG(64);
    case 5: return VK_WG(80);
    case 6: return VK_WG(96);
    case 7: return VK_WG(112);
    case 8: return VK_WG(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef VK_WG
}

}  // namespace wg

// mode 0 `dot`, 1 `l2`; rs_acc (FUSED `l2` only) is the rows' dS sums.
template <bool FUSED>
int dispatch_kv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                const void* delta, void* dk, void* dv, void* dq_acc, void* rs_acc, int bh, int n,
                int d, float inv_scale, int mode, cudaStream_t s) {
  if (d % 8 != 0) return (int)cudaErrorInvalidValue;
  switch (mode) {
    case kDot:
      return wg::dispatch<FUSED>(q, k, v, dout, lse, delta, dk, dv, dq_acc, bh, n, d, inv_scale,
                                 s);
    case kL2:
      return dispatch_kv_l2<FUSED>(q, k, v, dout, lse, delta, dk, dv, dq_acc, rs_acc, bh, n, d,
                                   inv_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace bwd
}  // namespace vk
