// The `l2` flash backward for Hopper (sm_90a): the persistent single pass
// (dQ, dK, dV) and the two-pass dk/dv and dq kernels, one body on the
// skeleton of flash_l2.cuh.
//   - csrc/flash_attn_bwd_fused.cu launches flash_bwd_fused_l2_kernel,
//     replacing the TPU kernel `_flash_bwd_fused_kernel`
//     (vitgan_tpu/ops/attention.py:507-590; pallas_call at :606);
//   - csrc/flash_attn_bwd_dkv.cu launches flash_bwd_dkv_l2_kernel, replacing
//     `_flash_bwd_dkv_kernel` (:434, with `_dkv_block_update` :392-422 and
//     the `l2` finish of `_dkv_finalize` :425-431; pallas_call at :727);
//   - csrc/flash_attn_bwd_dq.cu launches flash_bwd_dq_l2_kernel, replacing
//     `_flash_bwd_dq_kernel` (:324-346, with `_dq_block_update` :297 and
//     `_dq_finalize` :316-321; pallas_call at :701).
//
// With the forward's natural-log LSE and the given delta = rowsum(dO * O):
//   P  = exp(S - lse),  S = -inv * max(|q|^2 + |k|^2 - 2 q.k, 0), in f32 from
//        bf16 operands;
//   dS = P * (dO V^T - delta);
//   dV = P^T dO,  dK = 2 inv (dS^T Q - colsum(dS) k);
//   dQ = 2 inv (dS K - rowsum(dS) q).
// P and dS are cast to bf16 before their products, every product accumulates
// in f32 and the sums of dS add the f32 values, as the TPU kernels do
// (attention.py:549-577).
//
// What bounds it on this card.  At the v1 discriminator's shape (256 * 4
// heads, 50 tokens, Dh 108) the single pass does 1.4e9 flops (0.0014 ms of
// tensor time) against 89 MB of q, k, v, dO, rows and outputs (0.0265 ms of
// HBM time), the two-pass kernels 55-66 MB (0.017-0.020 ms): bytes bound
// them, and what loses time is latency, which the skeleton's persistent
// blocks hide (flash_l2.cuh).
//
// The roles.  A unit keeps R rows of one pair of tensors resident (their
// mma fragments in registers: the A operand of S = R1 T1^T and dP = R2
// T2^T) and streams the head's rows of the other pair, 64 a tile:
//   single pass and dk/dv: R1, R2 = K, V resident; T1, T2 = Q, dO streamed
//     with the rows' LSE and delta; out1 = dK, out2 = dV;
//   dq: R1, R2 = Q, dO resident with their LSE and delta; T1, T2 = K, V;
//     out1 = dQ.
// A tile:
//              S, dP                          wgmma m64n64k16, A from
//                                             registers, B K-major;
//              |t|^2 of the tile's rows       from the swizzled tile, under
//                                             the products;
//              P, then dS = P (dP - delta)    on the accumulators, rows and
//                                             columns past n masked to P = 0,
//                                             the row sums of dS in f32;
//              dk/dv: dV += P^T T2, dK += dS^T T1;  dq: dQ += dS T1
//                                             wgmma with A (P, dS in bf16)
//                                             from registers, B MN-major.
// The epilogue applies the `l2` finish with x, the resident rows of R1 (k or
// q), and stages bf16 rows < n, columns < d in the unit's resident entry for
// the producer's bulk stores.  Ping-pong (n <= 64): each warpgroup forms every
// 64-column box of the outputs in turn, 32 accumulator registers each (P and
// dS held in bf16), x from the resident fragments (they hold the
// accumulator's rows and columns).  Lockstep (n > 64): dK and dV (or dQ) stay
// in f32 registers across the tiles, each warpgroup a column box (Dh > 64) or
// 64 of the resident rows (Dh <= 64), x read from the entry.  dK, dV and the
// two-pass dQ take no atomics; the single pass's dQ adds in a fixed order
// (below): two calls are bit-equal.
//
// The single pass's dQ.  In this orientation dQ = dS K needs dS (queries x
// keys) and K as shared-memory operands: each warpgroup writes its tile's
// dS^T in bf16 to a swizzled buffer of its own (keys x 64 queries, M-major
// for the product) and the f32 sums of dS over its warps' keys for each
// query to a small array, summed over the four warps in one fixed order;
// K is laid out once a unit in a swizzled box (ping-pong: from its resident
// fragments into the warpgroup's dO boxes, free once dV is formed; lockstep:
// re-laid from the entry into the warpgroup's own box).  Each warpgroup then forms c = dS K - rowsum(dS) q over its keys (q
// from the swizzled tile), box by box.
//   - n <= 64, the v1 discriminator (a unit is a whole head): dQ = 2 inv c is
//     finished in the block, staged as bf16 rows in the warpgroup's dO boxes
//     (free once the product has read K there) and bulk-stored by one of its
//     threads, whose store has read them before the next tile is re-laid.  No
//     f32 sums, no memset, no flags, no second launch.
//   - n > 64: dQ sums over a head's 64-key blocks.  The units are taken in
//     the order of an atomic ticket (one int32 after the flags), key block
//     fastest; a 64-key block adds each tile's c in key-block order on one
//     int32 flag per (batch*head, 64-query tile) (ld.acquire until it reads
//     the block's index; the two warpgroups then add, in warpgroup order where
//     each holds its own keys; st.release of the next index): the first
//     stores its f32 c, the middle ones add with vector RED, the last one
//     reads the sum, adds its own, scales by 2 inv and stores bf16 dQ.  So dQ
//     is bit-deterministic, and a unit waits only on a unit of a lower
//     ticket, taken by a block that has started and processes its units in
//     ticket order: any dispatch order finishes (ops/attention.l2_units and
//     fused_dq_schedule model it; tests/test_torch_flash_edges.py simulates
//     it).  Why not one block a head past 64 keys: the ragged shape (16 heads
//     of 1,025 tokens) would then run on 16 of 132 SMs.
//
// ptxas -v: PERF.md records the registers, spills and warnings of the three
// kernels at DP 112 and 64; chip_smoke.py prints them and fails on a spill
// or a performance warning there.
#pragma once

#include "flash_l2.cuh"

namespace vk {
namespace l2 {

enum Kind : int { kDq = 0, kDkv = 1, kFused = 2 };

// The single pass's own shared memory: each warpgroup's dS^T buffer (64 keys
// x 64 queries, swizzled), its warps' sums of dS (4 x 64 floats) and, in
// lockstep, its K box.
constexpr int DS_BYTES = TILE * 128;
constexpr int RSW_BYTES = 4 * TILE * 4;
constexpr int OFF_KBOX = 2 * DS_BYTES + 2 * RSW_BYTES;  // a multiple of 1024
__host__ __device__ inline int fused_extra(int n) {
  return OFF_KBOX + (pingpong_at(n) ? 0 : 2 * TILE * 128);
}

// What each kernel keeps in its ring entries.
template <int KIND>
__host__ __device__ constexpr Entry entry_of() {
  return KIND == kDq ? Entry{2, true, false} : Entry{2, false, true};
}

// The single pass's dQ: where it goes and, past 64 keys, its f32 sums and
// the flags of their order.
struct DqOut {
  bf16* dq;
  float* acc;
  uint32_t* flags;
};

// P = exp2(-scale_log2 max(nr + nc - 2 S, 0) - lse2) in place over S, rows
// past n (row_ok) and tile columns at or past `cols` masked to 0; lse2 of a
// column from `lc` (dk/dv: the tile's LSE) or of a row from `lr` (dq).
template <bool DKV>
__device__ __forceinline__ void probs(float (&sa)[32], const float (&nr)[2], const float* nc,
                                      const float* lse_cols, const float (&lr)[2],
                                      const bool (&row_ok)[2], int cols, float scale_log2) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * t;
    const float2 ncv = *reinterpret_cast<const float2*>(nc + col);
    float2 lc = make_float2(0.f, 0.f);
    if constexpr (DKV) lc = *reinterpret_cast<const float2*>(lse_cols + col);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      const bool ok = row_ok[h] && col + (e & 1) < cols;
      const float x = fmaxf(nr[h] + ((e & 1) ? ncv.y : ncv.x) - 2.f * sa[4 * j + e], 0.f);
      const float l2 = DKV ? ((e & 1) ? lc.y : lc.x) * LOG2E : lr[h];
      sa[4 * j + e] = ok ? exp2f(fmaf(-x, scale_log2, -l2)) : 0.f;
    }
  }
}

// dS = P (dP - delta) in place over dP, and its f32 sums along the rows into
// sum; delta of a column from `dcols` (dk/dv) or of a row from `dr` (dq).
template <bool DKV>
__device__ __forceinline__ void dsoft(float (&pa)[32], const float (&sa)[32],
                                      const float* dcols, const float (&dr)[2],
                                      float (&sum)[2]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float2 dd = make_float2(0.f, 0.f);
    if constexpr (DKV) dd = *reinterpret_cast<const float2*>(dcols + 8 * j + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float dl = DKV ? ((e & 1) ? dd.y : dd.x) : dr[e >> 1];
      pa[4 * j + e] = sa[4 * j + e] * (pa[4 * j + e] - dl);
      sum[e >> 1] += pa[4 * j + e];
    }
  }
}

// The single pass: dS^T of the tile (this thread's keys 16 wr + g + 8 h,
// queries 8 j + 2 t + c) into the warpgroup's swizzled buffer in bf16, and
// the f32 sums of dS over the warp's 16 keys for each query into rsw[wr][.]:
// the lane's two keys of each of its 16 columns, then a butterfly over the
// eight lanes g of a column (16 values exchanged by lane ^ 16, 8 by ^ 8, 4
// by ^ 4, each lane keeping the half its bit selects), which leaves lane
// (g, t) the sums of columns 8 g + 2 t, + 1.
__device__ __forceinline__ void stash_ds(unsigned char* dsb, float* rsw, const float (&pa)[32]) {
  using namespace hopper;
  const int lane = threadIdx.x & 31, wr = (threadIdx.x & 127) >> 5, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(dsb + swz(16 * wr + g + 8 * h, j, t)) =
          pack_bf16(pa[4 * j + 2 * h], pa[4 * j + 2 * h + 1]);
  float r[16];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) r[2 * j + c] = pa[4 * j + c] + pa[4 * j + 2 + c];
#pragma unroll
  for (int half = 8; half >= 1; half >>= 1) {  // lane bit 16, 8, 4: g's bit 2, 1, 0
    const bool hi = lane & (2 * half);
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = hi ? r[i] : r[half + i];
      const float keep = hi ? r[half + i] : r[i];
      r[i] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * half);
    }
  }
  *reinterpret_cast<float2*>(rsw + wr * TILE + 8 * g + 2 * t) = make_float2(r[0], r[1]);
  fence_proxy_async();  // the buffer, before the dQ products read it
}

// rowsum(dS) over the warpgroup's keys of query row r: its four warps' sums
// in one fixed order.
__device__ __forceinline__ float row_sum(const float* rsw, int r) {
  return ((rsw[r] + rsw[TILE + r]) + rsw[2 * TILE + r]) + rsw[3 * TILE + r];
}

// The single pass: dS K over the warpgroup's keys for the tile's 64 queries
// and N columns (A the dS^T buffer, M-major; B the K boxes from kbox, 64
// columns a box, N-major), into acc.
template <int N>
__device__ __forceinline__ void ds_k(float (&acc)[N / 2], const unsigned char* dsb,
                                     const unsigned char* kbox) {
  using namespace hopper;
#pragma unroll
  for (int k = 0; k < N / 2; ++k) acc[k] = 0.f;
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss<N, 1, 1>(acc, desc_sw128(dsb + kk * 2048, DS_BYTES, 1024),
                      desc_sw128(kbox + kk * 2048, TILE * 128, 1024), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}


// S = A1 T1^T and dP = A2 T2^T, 64 x 64: A from registers (the resident rows'
// fragments), the tile pair swizzled and K-major at sw; two wgmma groups, the
// accumulators zeroed first (left undefined ahead of the fence, ptxas
// serialised every wgmma of the kernel, C7511).
template <int DP>
__device__ __forceinline__ void scores(float (&sa)[32], float (&pa)[32],
                                       const uint32_t (&a1)[DP / 16][4],
                                       const uint32_t (&a2)[DP / 16][4], const unsigned char* sw) {
  using namespace hopper;
  using G = Geo<DP>;
#pragma unroll
  for (int k = 0; k < 32; ++k) sa[k] = pa[k] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    wgmma_rs<64, 0>(sa, a1[kk], desc_sw128(sw + (kk >> 2) * G::SBOX + (kk & 3) * 32, 16, 1024));
  wgmma_commit();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    wgmma_rs<64, 0>(pa, a2[kk],
                    desc_sw128(sw + (G::NB + (kk >> 2)) * G::SBOX + (kk & 3) * 32, 16, 1024));
  wgmma_commit();
}

// Ping-pong consumers (one 64-row tile a unit, n <= 64, a unit a head):
// warpgroup w takes the block's units w, w + 2, ..., whole: it re-lays the
// unit's tile into its own swizzled pair, forms S and dP of the unit's rows
// against it, P and dS, then each 64-column box of the outputs in turn, 32
// accumulator registers each (P and dS held in bf16).  Outputs are staged in
// the unit's resident entry as its rows as they are formed: out2 (dv) in the
// R2 half, out1 in the R1 half (the `l2` finish reads x from the resident
// fragments, so nothing reads the entry after them).  The single pass then
// forms dQ of the
// head's queries, all columns in one product, stages it in its dO boxes (K's
// by then) and one of its threads bulk-stores it.
template <int DP, int KIND>
__device__ __forceinline__ void consume_units(const Shared<DP>& sh, int w, DqOut dqo) {
  using namespace hopper;
  using G = Geo<DP>;
  constexpr bool DKV = KIND != kDq, FUSED = KIND == kFused;
  constexpr int NB = G::NB;
  const int n = sh.n, d = sh.d;
  const int ct = threadIdx.x & 127, lane = threadIdx.x & 31;
  const int wr = ct >> 5, g = lane >> 2, t = lane & 3;
  const int lrow = 16 * wr + g;               // this thread's rows lrow, lrow + 8
  const int orow = lrow + ((t & 1) ? 8 : 0);  // the row whose outputs this lane stores
  const bool row_ok[2] = {lrow < n, lrow + 8 < n};
  unsigned char* sw = sh.swz + w * G::SWZ;
  float* rows = sh.trows + w * 3 * TILE;  // the tile's LSE and delta (dk/dv), its norms
  unsigned char* dsb = sh.extra + w * DS_BYTES;
  float* rsw = reinterpret_cast<float*>(sh.extra + 2 * DS_BYTES + w * RSW_BYTES);
  for (int i = w;; i += 2) {
    mbar_wait(sh.rfull(i % sh.g.rn), (i / sh.g.rn) & 1);
    const int bh = sh.unit(i);
    if constexpr (FUSED) {  // the previous unit's dQ store has read the dO boxes
      if (ct == 0) hopper::bulk_wait_read<0>();
      named_bar_sync(BAR_WG + w, 128);
    }
    if (bh < 0) break;
    const int off = sh.off(bh, 0);
    unsigned char* x1 = sh.rent(i) + off;  // the unit's R1 rows, then R2
    unsigned char* x2 = x1 + sh.g.rtensor;
    uint32_t a1[DP / 16][4], a2[DP / 16][4];
    load_frags<DP>(a1, x1, lrow, n, d);
    load_frags<DP>(a2, x2, lrow, n, d);
    float nr[2], lr[2] = {0.f, 0.f}, dr[2] = {0.f, 0.f};
    frag_norms(a1, nr);
    if constexpr (!DKV) {  // dq: the rows' LSE (log2 units) and delta
      const float* rr = reinterpret_cast<const float*>(sh.rent(i) + 2 * sh.g.rtensor);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        lr[h] = rr[lrow + 8 * h] * LOG2E;
        dr[h] = rr[sh.g.rrows + lrow + 8 * h];
      }
    }
    // the tile: re-laid into this warpgroup's swizzled pair; its entry is free
    mbar_wait(sh.tfull(i % sh.g.tn), (i / sh.g.tn) & 1);
    const unsigned char* te = sh.tent(i);
    // (this warpgroup's pair keeps its zero rows and columns after its first unit)
    relayout<G::DPAD>(sw, G::SBOX, te + off, n, d, 2 * d, ct, i == w);
    relayout<G::DPAD>(sw + NB * G::SBOX, G::SBOX, te + sh.g.ttensor + off, n, d, 2 * d, ct,
                      i == w);
    if constexpr (DKV) {
      const float* rw = reinterpret_cast<const float*>(te + 2 * sh.g.ttensor);
      if (ct < TILE) {
        rows[ct] = ct < n ? rw[ct] : 0.f;
        rows[TILE + ct] = ct < n ? rw[sh.g.trows + ct] : 0.f;
      }
    }
    fence_proxy_async();  // the re-laid tile before the wgmmas read it
    named_bar_sync(BAR_WG + w, 128);
    if (ct == 0) mbar_arrive(sh.tfree(i % sh.g.tn));
    float sa[32], pa[32];
    scores<DP>(sa, pa, a1, a2, sw);
    {  // the tile's |t|^2, two threads a row, under the products
      const float v = row_norm<DP, 2>(sw, G::SBOX, ct >> 1);
      if ((ct & 1) == 0) rows[2 * TILE + (ct >> 1)] = v;
    }
    named_bar_sync(BAR_WG + w, 128);
    wgmma_wait<1>();  // S
    fence_regs(sa);
    probs<DKV>(sa, nr, rows + 2 * TILE, rows, lr, row_ok, n, sh.scale_log2);
    wgmma_wait<0>();  // dP
    fence_regs(pa);
    fence_frags(a1);
    fence_frags(a2);
    float sum[2] = {0.f, 0.f};
    dsoft<DKV>(pa, sa, rows + TILE, dr, sum);
    if constexpr (FUSED) stash_ds(dsb, rsw, pa);
    uint32_t pf[4][4], df[4][4];
    pack_frags(pf, sa);
    pack_frags(df, pa);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    }
    const float two = 2.f * sh.inv_scale;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      // dK (dk/dv) or dQ (dq) and dV, columns 64 b .. 64 b + 63: B the
      // tile's box b, MN-major
      // (the zeroed accumulators pinned ahead of the fence: else ptxas
      // injects another, C7519)
      float a1c[32], a2c[DKV ? 32 : 1];
#pragma unroll
      for (int k = 0; k < 32; ++k) a1c[k] = 0.f;
      fence_regs(a1c);
      if constexpr (DKV) {
#pragma unroll
        for (int k = 0; k < 32; ++k) a2c[k] = 0.f;
        fence_regs(a2c);
      }
      wgmma_fence();
      if constexpr (DKV) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs<64, 1>(a2c, pf[kk],
                          desc_sw128(sw + (NB + b) * G::SBOX + kk * 2048, G::SBOX, 1024));
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<64, 1>(a1c, df[kk], desc_sw128(sw + b * G::SBOX + kk * 2048, G::SBOX, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(a1c);
      if constexpr (DKV) fence_regs(a2c);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // out1 = 2 inv (acc - sum x), finished in place and staged at once:
        // x, the resident R1 row's value, from its fragments, which hold the
        // accumulator's rows and columns (a1[4 b + j / 2][2 (j % 2) + h]), so
        // nothing reads x1 again; then lanes trade halves for 8-byte stores
        const int col = 64 * b + 8 * j + 2 * (t & 2);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t xw =
              64 * b + 8 * j < DP ? a1[min(4 * b + j / 2, DP / 16 - 1)][2 * (j & 1) + h] : 0u;
          const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xw));
          a1c[4 * j + 2 * h] = two * (a1c[4 * j + 2 * h] - sum[h] * x.x);
          a1c[4 * j + 2 * h + 1] = two * (a1c[4 * j + 2 * h + 1] - sum[h] * x.y);
        }
        const float4 v1 = row_quad(a1c, j);
        if (orow < n && col < d)
          *reinterpret_cast<uint2*>(x1 + orow * d * 2 + col * 2) =
              make_uint2(pack_bf16(v1.x, v1.y), pack_bf16(v1.z, v1.w));
        if constexpr (DKV) {
          const float4 v2 = row_quad(a2c, j);
          if (orow < n && col < d)
            *reinterpret_cast<uint2*>(x2 + orow * d * 2 + col * 2) =
                make_uint2(pack_bf16(v2.x, v2.y), pack_bf16(v2.z, v2.w));
        }
      }
    }
    fence_frags(pf);
    fence_frags(df);
    if constexpr (FUSED) {
      // K from its fragments into this warpgroup's dO boxes, once every
      // warp's dV products have read them
      named_bar_sync(BAR_WG + w, 128);
      frags_to_swz<DP>(sw + NB * G::SBOX, G::SBOX, a1, lrow);
    }
    fence_proxy_async();  // before the bulk stores (and the dQ product) read them
    if constexpr (FUSED) named_bar_sync(BAR_WG + w, 128);
    mbar_arrive(sh.rfree(i % sh.g.rn));
    if constexpr (FUSED) {
      // dQ = 2 inv (dS K - rowsum(dS) q) of the head's queries, staged as
      // rows in the dO boxes once every warp's product has read K there
      // (n d 2 bytes and the start's offset fit in NB boxes), then stored
      float qa[G::DPAD / 2];
      ds_k<G::DPAD>(qa, dsb, sw + NB * G::SBOX);
      const float rs = row_sum(rsw, orow);
      uint2 o3[NB][8];
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 64 * b + 8 * j + 2 * (t & 2);
          const float4 v = row_quad(box_of<G::DPAD>(qa, b), j);
          const float4 q = orow < n && col < d ? swz_quad(sw, G::SBOX, orow, col)
                                               : make_float4(0.f, 0.f, 0.f, 0.f);
          o3[b][j] = make_uint2(pack_bf16(two * (v.x - rs * q.x), two * (v.y - rs * q.y)),
                                pack_bf16(two * (v.z - rs * q.z), two * (v.w - rs * q.w)));
        }
      named_bar_sync(BAR_WG + w, 128);
      const long s0 = (long)bh * n * d * 2;
      unsigned char* x3 = sw + NB * G::SBOX + off;
      if (orow < n) {
#pragma unroll
        for (int b = 0; b < NB; ++b)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = 64 * b + 8 * j + 2 * (t & 2);
            if (col < d) *reinterpret_cast<uint2*>(x3 + orow * d * 2 + col * 2) = o3[b][j];
          }
      }
      fence_proxy_async();
      named_bar_sync(BAR_WG + w, 128);
      if (ct == 0) {
        store_rows(reinterpret_cast<char*>(dqo.dq), x3, s0, s0 + (long)n * d * 2);
        hopper::bulk_commit();
      }
    }
  }
  if (FUSED && ct == 0) hopper::bulk_wait<0>();
}

// The single pass past 64 keys: this warpgroup's part c (rows: the tile's
// queries; four columns a j, from column 64 cb) of 64-key block kb of the
// head added into dQ's sums in key-block order (the head note): the first
// block stores, the middle ones add, the last one finishes dQ.
__device__ __forceinline__ void add_dq(const DqOut& dqo, const float4 (&c)[8], int kb, int kbs,
                                       long row, bool in_row, int cb, int d, float two) {
  const int t = threadIdx.x & 3;
  float* acc = dqo.acc + row * d + 64 * cb + 2 * (t & 2);
  if (kb == kbs - 1) {  // sum, scale, bf16 (a load at a time: at DP 64 eight in flight spilled)
    bf16* out = dqo.dq + row * d + 64 * cb + 2 * (t & 2);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (!(in_row && 64 * cb + 8 * j + 2 * (t & 2) < d)) continue;
      const float4 a = __ldcg(reinterpret_cast<const float4*>(acc + 8 * j));
      *reinterpret_cast<uint2*>(out + 8 * j) =
          make_uint2(pack_bf16(two * (a.x + c[j].x), two * (a.y + c[j].y)),
                     pack_bf16(two * (a.z + c[j].z), two * (a.w + c[j].w)));
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (!(in_row && 64 * cb + 8 * j + 2 * (t & 2) < d)) continue;
      float4* p = reinterpret_cast<float4*>(acc + 8 * j);
      if (kb == 0)
        *p = c[j];
      else
        atomicAdd(p, c[j]);
    }
  }
}

// Lockstep consumers (n > 64): both warpgroups take every unit of R resident
// rows and stream its tiles; warpgroup w re-lays tensor w of each tile into
// the shared swizzled pair (two pairs in turn), then takes resident rows
// roff .. roff + 63 and column box cb of the outputs (two boxes: the same
// rows, a box each; one box: 64 rows each), with the outputs in f32
// registers across the tiles.  The single pass adds each tile's dQ part
// (the head note).
template <int DP, int KIND>
__device__ __forceinline__ void consume_blocks(const Shared<DP>& sh, int w, DqOut dqo) {
  using namespace hopper;
  using G = Geo<DP>;
  constexpr bool DKV = KIND != kDq, FUSED = KIND == kFused;
  constexpr int NB = G::NB, R = G::R;
  const int n = sh.n, d = sh.d;
  const int ct = threadIdx.x & 127, lane = threadIdx.x & 31;
  const int wr = ct >> 5, g = lane >> 2, t = lane & 3;
  const int roff = NB == 1 ? 64 * w : 0, cb = NB == 1 ? 0 : w;
  const int lrow = roff + 16 * wr + g;        // this thread's resident rows lrow, lrow + 8
  const int orow = lrow + ((t & 1) ? 8 : 0);  // the row whose outputs this lane stores
  const int qrow = 16 * wr + g + ((t & 1) ? 8 : 0);  // the single pass: its dQ row of a tile
  unsigned char* dsb = sh.extra + w * DS_BYTES;
  float* rsw = reinterpret_cast<float*>(sh.extra + 2 * DS_BYTES + w * RSW_BYTES);
  unsigned char* kbox = sh.extra + OFF_KBOX + w * TILE * 128;
  const int kbs = (n + TILE - 1) / TILE;  // the single pass: 64-key blocks a head
  float acc1[32], acc2[DKV ? 32 : 1];
  int c = 0;
  for (int i = 0;; ++i) {
    mbar_wait(sh.rfull(i % sh.g.rn), (i / sh.g.rn) & 1);
    const int u = sh.unit(i);
    if (u < 0) break;
    const int bh = u / sh.per, uh = u - bh * sh.per, row0 = uh * R;
    const int rows_u = min(R, n - row0), off = sh.off(bh, row0);
    unsigned char* x1 = sh.rent(i) + off;
    unsigned char* x2 = x1 + sh.g.rtensor;
    uint32_t a1[DP / 16][4], a2[DP / 16][4];
    load_frags<DP>(a1, x1, lrow, rows_u, d);
    load_frags<DP>(a2, x2, lrow, rows_u, d);
    float nr[2], lr[2] = {0.f, 0.f}, dr[2] = {0.f, 0.f};
    frag_norms(a1, nr);
    if constexpr (!DKV) {
      const float* rr = reinterpret_cast<const float*>(sh.rent(i) + 2 * sh.g.rtensor);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        lr[h] = rr[lrow + 8 * h] * LOG2E;
        dr[h] = rr[sh.g.rrows + lrow + 8 * h];
      }
    }
    if constexpr (FUSED) {  // this warpgroup's K box: its keys (one box) or box w (two)
      if (NB == 1)
        relayout<64>(kbox, G::SBOX, x1 + roff * d * 2, max(min(rows_u - roff, 64), 0), d,
                     2 * d, ct, true);
      else
        relayout<64>(kbox, G::SBOX, x1 + 128 * w, rows_u, min(d - 64 * w, 64), 2 * d, ct, true);
    }
    const bool row_ok[2] = {lrow < rows_u, lrow + 8 < rows_u};
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int k = 0; k < 32; ++k) acc1[k] = 0.f;
    if constexpr (DKV) {
#pragma unroll
      for (int k = 0; k < 32; ++k) acc2[k] = 0.f;
    }

    for (int tt = 0; tt < sh.ntiles; ++tt, ++c) {
      const int rows_t = min(TILE, n - tt * TILE);
      unsigned char* sw = sh.swz + (c & 1) * G::SWZ;
      float* rows = sh.trows + (c & 1) * 3 * TILE;
      mbar_wait(sh.tfull(c % sh.g.tn), (c / sh.g.tn) & 1);
      const unsigned char* te = sh.tent(c);
      const int toff = sh.off(bh, tt * TILE);
      relayout<G::DPAD>(sw + w * NB * G::SBOX, G::SBOX, te + w * sh.g.ttensor + toff, rows_t, d,
                        2 * d, ct, true);
      if (DKV && w == 0 && ct < TILE) {
        const float* rw = reinterpret_cast<const float*>(te + 2 * sh.g.ttensor);
        rows[ct] = ct < rows_t ? rw[ct] : 0.f;
        rows[TILE + ct] = ct < rows_t ? rw[sh.g.trows + ct] : 0.f;
      }
      fence_proxy_async();
      named_bar_sync(BAR_PAIR, 256);
      if (threadIdx.x == 0) mbar_arrive(sh.tfree(c % sh.g.tn));
      float sa[32], pa[32];
      scores<DP>(sa, pa, a1, a2, sw);
      {  // the tile's |t|^2, four threads a row, under the products
        const float v = row_norm<DP>(sw, G::SBOX, threadIdx.x >> 2);
        if ((threadIdx.x & 3) == 0) rows[2 * TILE + (threadIdx.x >> 2)] = v;
      }
      named_bar_sync(BAR_PAIR2, 256);
      wgmma_wait<1>();  // S
      fence_regs(sa);
      probs<DKV>(sa, nr, rows + 2 * TILE, rows, lr, row_ok, rows_t, sh.scale_log2);
      const unsigned char* st1 = sw;
      const unsigned char* st2 = sw + NB * G::SBOX;
      uint32_t pf[4][4], df[4][4];
      wgmma_wait<0>();  // dP (and S's and dP's register operands free)
      fence_regs(pa);
      dsoft<DKV>(pa, sa, rows + TILE, dr, sum);
      if constexpr (FUSED) stash_ds(dsb, rsw, pa);
      pack_frags(df, pa);
      if constexpr (DKV) pack_frags(pf, sa);
      // dV += P^T dO (dk/dv) and dK += dS^T Q, or dQ += dS K (dq): B the
      // tile's box cb, MN-major
      wgmma_fence();
      if constexpr (DKV) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs<64, 1>(acc2, pf[kk], desc_sw128(st2 + cb * G::SBOX + kk * 2048, G::SBOX, 1024));
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<64, 1>(acc1, df[kk], desc_sw128(st1 + cb * G::SBOX + kk * 2048, G::SBOX, 1024));
      wgmma_commit();
      // every product retires within the tile
      wgmma_wait<0>();
      fence_regs(acc1);
      fence_frags(df);
      fence_frags(a1);
      fence_frags(a2);
      if constexpr (DKV) {
        fence_regs(acc2);
        fence_frags(pf);
      }
      if constexpr (FUSED) {
        // this warpgroup's part of the tile's dQ, added in key-block order
        named_bar_sync(BAR_WG + w, 128);  // the dS^T buffer and the sums written
        float4 cq[8];
        {
          float qa[32];
          ds_k<64>(qa, dsb, kbox);
          const float rs = row_sum(rsw, qrow);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = 64 * cb + 8 * j + 2 * (t & 2);
            const float4 v = row_quad(qa, j);
            const float4 q = qrow < rows_t && col < d ? swz_quad(st1, G::SBOX, qrow, col)
                                                      : make_float4(0.f, 0.f, 0.f, 0.f);
            cq[j] = make_float4(v.x - rs * q.x, v.y - rs * q.y, v.z - rs * q.z, v.w - rs * q.w);
          }
        }
        const int kb0 = NB == 1 ? 2 * uh : uh, kb_end = min(kb0 + (NB == 1 ? 2 : 1), kbs);
        uint32_t* flag = dqo.flags + (long)bh * sh.ntiles + tt;
        if (threadIdx.x == 0 && kb0 > 0)
          while (ld_acquire_gpu(flag) < (uint32_t)kb0) {
          }
        named_bar_sync(BAR_DQ, 256);
        const long row = (long)bh * n + tt * TILE + qrow;
        const float two = 2.f * sh.inv_scale;
        if (NB == 2 || w == 0) add_dq(dqo, cq, kb0, kbs, row, qrow < rows_t, cb, d, two);
        if (NB == 1 && kb_end == kb0 + 2) {  // warpgroup 1's keys after warpgroup 0's
          named_bar_sync(BAR_DQ, 256);
          if (w == 1) add_dq(dqo, cq, kb0 + 1, kbs, row, qrow < rows_t, cb, d, two);
        }
        if (kb_end < kbs) {
          named_bar_sync(BAR_DQ, 256);
          if (threadIdx.x == 0) st_release_gpu(flag, (uint32_t)kb_end);
        }
      }
    }

    // epilogue: out1 = 2 inv (acc1 - sum x), x the resident R1 row; out2 = acc2
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    }
    const float sm = (t & 1) ? sum[1] : sum[0];
    const float two = 2.f * sh.inv_scale;
    uint2 o1[8], o2[DKV ? 8 : 1];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * cb + 8 * j + 2 * (t & 2);
      const float4 v1 = row_quad(acc1, j);
      const uint2 xr = orow < rows_u && col < d
                           ? *reinterpret_cast<const uint2*>(x1 + orow * d * 2 + col * 2)
                           : make_uint2(0u, 0u);
      const float2 x01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr.x));
      const float2 x23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr.y));
      o1[j] = make_uint2(pack_bf16(two * (v1.x - sm * x01.x), two * (v1.y - sm * x01.y)),
                         pack_bf16(two * (v1.z - sm * x23.x), two * (v1.w - sm * x23.y)));
      if constexpr (DKV) {
        const float4 v2 = row_quad(acc2, j);
        o2[j] = make_uint2(pack_bf16(v2.x, v2.y), pack_bf16(v2.z, v2.w));
      }
    }
    // the unit's rows of the outputs staged in its entry (R1 half, and for
    // dk/dv R2), once every thread has read x; the producer stores them
    named_bar_sync(BAR_PAIR2, 256);
    if (orow < rows_u) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * cb + 8 * j + 2 * (t & 2);
        if (col < d) {
          *reinterpret_cast<uint2*>(x1 + orow * d * 2 + col * 2) = o1[j];
          if constexpr (DKV) *reinterpret_cast<uint2*>(x2 + orow * d * 2 + col * 2) = o2[j];
        }
      }
    }
    fence_proxy_async();  // before the bulk stores read them
    mbar_arrive(sh.rfree(i % sh.g.rn));
  }
}

// The body of the three kernels (the roles: the head note).  lse (natural
// log), delta: (bh, n) f32; q, k, v, dO and the outputs (bh, n, d) bf16, d a
// multiple of 4, 8-byte aligned.  The single pass: dqo; past 64 keys its
// ticket after the flags.
template <int DP, int KIND>
__device__ __forceinline__ void body(const bf16* __restrict__ r1, const bf16* __restrict__ r2,
                                     const bf16* __restrict__ t1, const bf16* __restrict__ t2,
                                     const float* __restrict__ lse,
                                     const float* __restrict__ delta, bf16* __restrict__ out1,
                                     bf16* __restrict__ out2, DqOut dqo, int bhs, int n, int d,
                                     float scale_log2, float inv_scale) {
  using namespace hopper;
  const Shared<DP> sh = setup<DP>(bhs, n, d, entry_of<KIND>(),
                                  KIND == kFused ? fused_extra(n) : 0, scale_log2, inv_scale);
  if (threadIdx.x >= 256) {  // producer: warp 3 of the producer warpgroup
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x < 352) return;
    uint32_t* ticket = KIND == kFused && !sh.pingpong
                           ? dqo.flags + (long)bhs * sh.ntiles : nullptr;
    produce<DP>(sh, r1, r2, t1, t2, lse, delta, out1, out2, KIND == kDq ? 1 : 2, ticket);
    return;
  }
  reg_alloc<CONSUMER_REGS>();
  if (sh.pingpong)
    consume_units<DP, KIND>(sh, threadIdx.x >> 7, dqo);
  else
    consume_blocks<DP, KIND>(sh, threadIdx.x >> 7, dqo);
}

template <int DP, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_l2_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, int bhs, int n, int d,
                        float scale_log2, float inv_scale) {
  static_assert(MODE == kL2, "the persistent backward kernels serve `l2` scores");
  body<DP, kDkv>(k, v, q, dout, lse, delta, dk, dv, DqOut{}, bhs, n, d, scale_log2, inv_scale);
}

template <int DP, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_l2_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       bf16* __restrict__ dq, int bhs, int n, int d, float scale_log2,
                       float inv_scale) {
  static_assert(MODE == kL2, "the persistent backward kernels serve `l2` scores");
  body<DP, kDq>(q, dout, k, v, lse, delta, dq, nullptr, DqOut{}, bhs, n, d, scale_log2,
                inv_scale);
}

template <int DP, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_fused_l2_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
                          float* __restrict__ dq_acc, uint32_t* __restrict__ flags, int bhs,
                          int n, int d, float scale_log2, float inv_scale) {
  static_assert(MODE == kL2, "the persistent backward kernels serve `l2` scores");
  body<DP, kFused>(k, v, q, dout, lse, delta, dk, dv, DqOut{dq, dq_acc, flags}, bhs, n, d,
                   scale_log2, inv_scale);
}

template <int DP, int KIND>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* out1, void* out2, void* out3, void* acc, void* flags,
           int bhs, int n, int d, float inv_scale, int grid, cudaStream_t stream) {
  const int smem =
      rings_of<DP>(n, d, entry_of<KIND>(), KIND == kFused ? fused_extra(n) : 0).smem;
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const auto* qb = static_cast<const bf16*>(q);
  const auto* kb = static_cast<const bf16*>(k);
  const auto* vb = static_cast<const bf16*>(v);
  const auto* db = static_cast<const bf16*>(dout);
  const auto* lb = static_cast<const float*>(lse);
  const auto* eb = static_cast<const float*>(delta);
  auto* o1 = static_cast<bf16*>(out1);
  auto* o2 = static_cast<bf16*>(out2);
  if constexpr (KIND == kDkv) {
    cudaFuncSetAttribute(flash_bwd_dkv_l2_kernel<DP, kL2>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    flash_bwd_dkv_l2_kernel<DP, kL2><<<grid, THREADS, smem, stream>>>(
        qb, kb, vb, db, lb, eb, o1, o2, bhs, n, d, inv_scale * LOG2E, inv_scale);
  } else if constexpr (KIND == kDq) {
    cudaFuncSetAttribute(flash_bwd_dq_l2_kernel<DP, kL2>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    flash_bwd_dq_l2_kernel<DP, kL2><<<grid, THREADS, smem, stream>>>(
        qb, kb, vb, db, lb, eb, o1, bhs, n, d, inv_scale * LOG2E, inv_scale);
  } else {
    cudaFuncSetAttribute(flash_bwd_fused_l2_kernel<DP, kL2>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    flash_bwd_fused_l2_kernel<DP, kL2><<<grid, THREADS, smem, stream>>>(
        qb, kb, vb, db, lb, eb, o1, o2, static_cast<bf16*>(out3), static_cast<float*>(acc),
        static_cast<uint32_t*>(flags), bhs, n, d, inv_scale * LOG2E, inv_scale);
  }
  return (int)cudaGetLastError();
}

// dk/dv: out1 = dk, out2 = dv; dq: out1 = dq; the single pass: out1, out2,
// out3 = dq, dk, dv, past 64 keys with acc (f32, (bh, n, d)) and flags
// (int32, bh * ceil(n / 64) + 1, zeroed by the caller).  Refuses d not a
// multiple of 4 or above 128, pointers not 8-byte aligned, and an empty grid.
template <int KIND>
int dispatch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
             const void* delta, void* out1, void* out2, void* out3, void* acc, void* flags,
             int bhs, int n, int d, float inv_scale, int grid, cudaStream_t s) {
  const void* ptrs[7] = {q, k, v, dout, out1, out2 ? out2 : out1, out3 ? out3 : out1};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 8 != 0) return (int)cudaErrorInvalidValue;
  if (d % 4 != 0 || d <= 0 || grid <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  if (KIND == kFused && n > TILE && (acc == nullptr || flags == nullptr))
    return (int)cudaErrorInvalidValue;
#define VK_L2(DP)                                                                             \
  launch<DP, KIND>(q, k, v, dout, lse, delta, out1, out2, out3, acc, flags, bhs, n, d, inv_scale, \
                   grid, s)
  switch ((d + 15) / 16) {
    case 1: return VK_L2(16);
    case 2: return VK_L2(32);
    case 3: return VK_L2(48);
    case 4: return VK_L2(64);
    case 5: return VK_L2(80);
    case 6: return VK_L2(96);
    case 7: return VK_L2(112);
    case 8: return VK_L2(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef VK_L2
}

}  // namespace l2
}  // namespace vk
