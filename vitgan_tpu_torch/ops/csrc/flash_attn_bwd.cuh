// Flash-attention backward, `dot` scores, for Hopper (sm_90a): the `dot`
// k-block kernel shared by csrc/flash_attn_bwd_dkv.cu (FUSED = false) and
// csrc/flash_attn_bwd_fused.cu (FUSED = true).  csrc/flash_attn_bwd_dq.cu has
// the `dot` q-block kernel; csrc/flash_l2_bwd.cuh the `l2` kernels (the
// single pass, dq and dk/dv) on the persistent skeleton of flash_l2.cuh.
// Replaces the TPU kernels `_flash_bwd_dkv_kernel(_dma)`
// (vitgan_tpu/ops/attention.py:434-504, pallas_call at :727) and
// `_flash_bwd_fused_kernel` (:507-590, pallas_call at :606) in the `dot` mode;
// the two entries' head notes give the bound on this card and what ptxas -v
// reports.
//
// With the forward's natural-log LSE and delta = rowsum(dO * O):
//   P  = exp(S - lse),  S = inv_scale * Q K^T
//   dV = P^T dO,  dS = P * (dO V^T - delta)
//   dK = inv_scale * dS^T Q,  dQ = inv_scale * dS K
// P and dS are cast to bf16 before their products and every product
// accumulates in f32, as the TPU kernels do (attention.py:392-422).
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
// A M-major from the dS^T buffer, B N-major from the resident K).  The
// k-blocks of a head add a tile's dQ in key-block order (below), so dQ is
// bit-deterministic, as dK and dV are: k-block 0 stores its f32 tile, the
// middle ones add theirs with vector RED (float4 atomicAdd, lanes pairing
// their fragments), and the last one reads the sum, adds its own, scales by
// inv_scale and stores bf16 dQ (one k-block: it stores bf16 dQ at once).
//
// The order of dQ's additions (ops/attention.fused_dq_schedule models it).
// An int32 flag per (batch*head, 64-query tile), zeroed by the entry, counts
// the k-blocks that have added the tile.  Warp 2 of the producer warpgroup
// keeps the order for consumer warpgroup 0, warp 3 for warpgroup 1, so that
// each has two tiles' time a round: before tile qt it waits (ld.acquire)
// until the flag reads this block's k-block index kb and meets the tile's dQ
// warpgroup at a named barrier, which then adds; after the adds both meet at
// a second barrier and the warp stores kb + 1 (st.release).  The acquire,
// the barriers and the release order k-block kb's additions before kb + 1's,
// so every element's sum is t0 + t1 + ... in key-block order.  The last
// k-block issues all its loads of the sums before any add (one after another,
// behind each store, they had cost the single pass at G 13%, PERF.md).
//
// Each block's place in that order is its ticket: one more int32 after the
// flags, zeroed with them, from which thread 0 takes atomicAdd(ticket, 1) as
// the block's linear index (where a head has more than one k-block; else
// blockIdx.x).  The linear order runs in groups of GROUP_HEADS heads, k-block
// slowest within a group: index group * K * GH + kb * GH + h % GH (GH the
// group's heads), so a block waits only on the block GH indices below it,
// which is some tiles ahead of it: the wait is then mostly a flag found set
// (with k-block fastest, a head's k-blocks ran side by side and waited a
// flag's round trip on every tile).  A group's 32 heads keep their Q, dO and
// dQ sums (8 MB at G) in the L2.  The ticket guarantees progress in any
// dispatch order: a block waits only on a lower index, taken by a block that
// had already started, which holds its place on the card until it finishes,
// and whose own waits are on lower indices still.  The order of the
// additions is the key-block order whatever the tickets, so dQ stays
// bit-deterministic.
//
// What held the first (mma.sync) design back, and what this does about it: 64
// keys a block on 4 warps, each reading every streamed Q and dO tile from
// shared memory by ldmatrix for 16 keys (now 128 keys on two warpgroups,
// operands read by wgmma's descriptors); a two-stage cp.async ring behind one
// block barrier a tile (now TMA on mbarriers, the producer apart); dQ by
// float2 atomics of every warp, 16 keys deep (now 128 keys deep, four floats
// a RED: half the additions).
#pragma once

#include "hopper.cuh"

namespace vk {
namespace bwd {

constexpr float LOG2E = 1.4426950408889634f;

// The single pass's block order (the head note): thread 0 stores into *index
// the block's linear index, its ticket atomicAdd(ticket, 1) where a head has
// more than one k-block, else blockIdx.x; the caller synchronises the block
// before reading it.
__device__ inline void take_ticket(int* index, uint32_t* ticket, int nkb) {
  if (threadIdx.x == 0) *index = nkb > 1 ? (int)atomicAdd(ticket, 1u) : (int)blockIdx.x;
}

// --- the `dot` k-block kernel: wgmma, TMA and mbarrier rings -----------------

namespace wg {

constexpr int KEYS = 128;     // keys per block: two consumer warpgroups of 64
constexpr int TQ = 64;        // queries per streamed tile
constexpr int THREADS = 384;  // producer warpgroup + two consumer warpgroups
// Named barriers: 1 the two consumer warpgroups' dS^T exchange; GO + w and
// DONE + w the dQ order warp with consumer warpgroup w (128 + 32 threads).
constexpr int BAR_DS = 1, BAR_GO = 2, BAR_DONE = 4, ORDER_THREADS = 160;
// FUSED: heads a group of the grid's order (ops/attention.FUSED_GROUP_HEADS)
constexpr int GROUP_HEADS = 32;

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

template <int DP, bool FUSED>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_kv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          float* __restrict__ dq_acc, bf16* __restrict__ dq,
                          uint32_t* __restrict__ dq_order, int n, int d, float scale_log2,
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

  __shared__ int order_index;
  const int wgi = threadIdx.x >> 7, lane = threadIdx.x & 31;
  const int nkb = (n + KEYS - 1) / KEYS;
  const int ntiles = (n + TQ - 1) / TQ;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 33);  // warp 0's lane 0 (with the TMA bytes), warp 1's 32 lanes
      mbar_init(&empty[s], 2);  // the two consumer warpgroups
    }
    mbar_init(kvbar, 1);
    mbar_fence_init();
  }
  if constexpr (FUSED) take_ticket(&order_index, dq_order + (long)(gridDim.x / nkb) * ntiles, nkb);
  __syncthreads();
  int kb = blockIdx.x, bh = blockIdx.y;
  if constexpr (FUSED) {  // the grouped order of the ticket (the head note)
    const int span = nkb * GROUP_HEADS, group = order_index / span, base = group * GROUP_HEADS;
    const int gh = min(GROUP_HEADS, (int)(gridDim.x / nkb) - base);
    const int r = order_index - group * span;
    kb = r / gh;
    bh = base + r % gh;
  }
  const int k0 = kb * KEYS;

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
    } else if (FUSED && (threadIdx.x >> 5) >= 2 && nkb > 1) {
      // the order of dQ's additions: warp 2 + w keeps it for consumer
      // warpgroup w, which adds the dQ of tiles qt = w, w + 2, ...: it adds
      // once k-block kb - 1 has, and k-block kb + 1 may add once it has
      const int w = (threadIdx.x >> 5) - 2;
      uint32_t* flags = dq_order + (long)bh * ntiles;
      for (int qt = w; qt < ntiles; qt += 2) {
        if (kb > 0) {
          if (lane == 0)
            while (ld_acquire_gpu(flags + qt) < (uint32_t)kb) {
            }
          __syncwarp();
          named_bar_sync(BAR_GO + w, ORDER_THREADS);
        }
        if (kb < nkb - 1) {
          named_bar_sync(BAR_DONE + w, ORDER_THREADS);
          if (lane == 0) st_release_gpu(flags + qt, kb + 1);
        }
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
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<DPAD, 1>(dva, pf[kk], desc_sw128(dos + kk * 2048, G::QBOX, 1024));
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
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<DPAD, 1>(dka, df[kk], desc_sw128(qs + kk * 2048, G::QBOX, 1024));
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
      // tile in turn, four columns a thread, added in key-block order
      fence_proxy_async();
      named_bar_sync(BAR_DS, 256);
      if (w == (qt & 1)) {
        const unsigned char* dsb = dss + (qt & 1) * G::DS;
        float qa[NA];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KEYS / 16; ++kk)
          wgmma_ss<DPAD, 1, 1>(qa, desc_sw128(dsb + kk * 2048, G::DS, 1024),
                             desc_sw128(ks + kk * 2048, G::KBOX, 1024), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(qa);
        // lanes t and t ^ 1 swap halves: even t takes row g, odd t row g + 8,
        // four columns 8 j + 2 (t & 2) .. + 3 each
        float4 v[DPAD / 8];
#pragma unroll
        for (int j = 0; j < DPAD / 8; ++j) {
          const float x0 = (t & 1) ? qa[4 * j] : qa[4 * j + 2];
          const float x1 = (t & 1) ? qa[4 * j + 1] : qa[4 * j + 3];
          const float y0 = __shfl_xor_sync(0xffffffffu, x0, 1);
          const float y1 = __shfl_xor_sync(0xffffffffu, x1, 1);
          v[j] = (t & 1) ? make_float4(y0, y1, qa[4 * j + 2], qa[4 * j + 3])
                         : make_float4(qa[4 * j], qa[4 * j + 1], y0, y1);
        }
        const int row = qt * TQ + 16 * wr + g + ((t & 1) ? 8 : 0);
        float* acc = dq_acc + ((long)bh * n + row) * d + 2 * (t & 2);
        const bool in_row = row < n;
        if (kb > 0) named_bar_sync(BAR_GO + w, ORDER_THREADS);  // k-block kb - 1 has added
        if (kb == nkb - 1) {  // the last k-block finishes dQ: sum, scale, bf16
          if (nkb > 1) {  // every load in flight at once, then the adds
            float4 a[DPAD / 8];
#pragma unroll
            for (int j = 0; j < DPAD / 8; ++j)
              a[j] = in_row && 8 * j < d ? __ldcg(reinterpret_cast<const float4*>(acc + 8 * j))
                                         : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
            for (int j = 0; j < DPAD / 8; ++j)
              v[j] = make_float4(a[j].x + v[j].x, a[j].y + v[j].y, a[j].z + v[j].z,
                                 a[j].w + v[j].w);
          }
          bf16* out = dq + ((long)bh * n + row) * d + 2 * (t & 2);
#pragma unroll
          for (int j = 0; j < DPAD / 8; ++j)
            if (in_row && 8 * j < d)
              *reinterpret_cast<uint2*>(out + 8 * j) =
                  make_uint2(pack_bf16(v[j].x * inv_scale, v[j].y * inv_scale),
                             pack_bf16(v[j].z * inv_scale, v[j].w * inv_scale));
        } else if (kb == 0) {
#pragma unroll
          for (int j = 0; j < DPAD / 8; ++j)
            if (in_row && 8 * j < d) *reinterpret_cast<float4*>(acc + 8 * j) = v[j];
        } else {
#pragma unroll
          for (int j = 0; j < DPAD / 8; ++j)
            if (in_row && 8 * j < d) atomicAdd(reinterpret_cast<float4*>(acc + 8 * j), v[j]);
        }
        if (kb < nkb - 1) named_bar_sync(BAR_DONE + w, ORDER_THREADS);  // kb + 1 may add
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
           const void* delta, void* dk, void* dv, void* dq_acc, void* dq, void* dq_order,
           int bh, int n, int d, float inv_scale, cudaStream_t stream) {
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
  // FUSED: one dimension in the grouped order (the head note); else (k-blocks, heads)
  const int nkb = (n + KEYS - 1) / KEYS;
  const dim3 grid = FUSED ? dim3(nkb * bh) : dim3(nkb, bh);
  flash_bwd_kv_wgmma_kernel<DP, FUSED><<<grid, THREADS, smem, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), static_cast<float*>(dq_acc),
      static_cast<bf16*>(dq), static_cast<uint32_t*>(dq_order), n, d, inv_scale * LOG2E,
      inv_scale);
  return (int)cudaGetLastError();
}

template <bool FUSED>
int dispatch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
             const void* delta, void* dk, void* dv, void* dq_acc, void* dq, void* dq_order,
             int bh, int n, int d, float inv_scale, cudaStream_t s) {
#define VK_WG(DP) \
  launch<DP, FUSED>(q, k, v, dout, lse, delta, dk, dv, dq_acc, dq, dq_order, bh, n, d, inv_scale, s)
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

}  // namespace bwd
}  // namespace vk
