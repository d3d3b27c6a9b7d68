// The `l2` two-pass flash backward for Hopper (sm_90a): the persistent dk/dv
// and dq kernels, one body with the roles of the two operand pairs swapped.
// csrc/flash_attn_bwd_dkv.cu launches flash_bwd_dkv_l2_kernel, replacing the
// TPU kernel `_flash_bwd_dkv_kernel` (vitgan_tpu/ops/attention.py:434, with
// `_dkv_block_update` :392-422 and the `l2` finish of `_dkv_finalize`
// :425-431; pallas_call at :727); csrc/flash_attn_bwd_dq.cu launches
// flash_bwd_dq_l2_kernel, replacing `_flash_bwd_dq_kernel` (:324-346, with
// `_dq_block_update` :297 and `_dq_finalize` :316-321; pallas_call at :701).
//
// With the forward's natural-log LSE and the given delta = rowsum(dO * O):
//   P  = exp(S - lse),  S = -inv * max(|q|^2 + |k|^2 - 2 q.k, 0), in f32 from
//        bf16 operands;
//   dS = P * (dO V^T - delta);
//   dk/dv: dV = P^T dO,  dK = 2 inv (dS^T Q - colsum(dS) k);
//   dq:    dQ = 2 inv (dS K - rowsum(dS) q).
// P and dS are cast to bf16 before their products, every product accumulates
// in f32 and the sums of dS add the f32 values, as the TPU kernels do.
//
// What bounds it on this card.  At the v1 discriminator's shape (256 * 4
// heads, 50 tokens, Dh 108) the work is 1.1e9 flops (0.001 ms of tensor time)
// against 55-66 MB of q, k, v, dO, rows and outputs (0.017-0.020 ms of HBM
// time): bytes bound it, and what loses time is latency.  The first design's
// mma.sync kernels ran one block a (64-key or 64-query tile, head): at 50
// tokens each block was one serial chain (load, barrier, norms, barrier,
// products, epilogue, exit), so the memory pipe waited through every compute
// and epilogue phase; and their 16-byte copies needed the wrappers to pad Dh 108
// to 112 (eight pad launches an attention backward) and slice the outputs
// back.  Here a persistent block on each SM walks many heads, its loads a
// unit or more ahead of its math, and reads and writes the (B, H, N, 108)
// tensors where they lie.
//
// The design.  A unit is one (batch*head, R resident rows): the dk/dv kernel
// keeps R keys of K and V resident and streams the head's queries (Q, dO and
// the rows' LSE and delta), 64 a tile; the dq kernel keeps R queries of Q and
// dO (with their LSE and delta) resident and streams K and V, 64 keys a tile.
// A grid of min(units, SMs) blocks (ops/attention.l2_bwd_grid) walks units
// blockIdx.x, + gridDim.x, ...; at D's shape 1,024 units make under 8 rounds
// on 132 SMs.  One block: 384 threads.
//   - Producer (one warp).  A (bh, n, 108) bf16 row is 216 bytes: no tensor
//     map can describe it (TMA wants 16-byte strides), and 8-byte cp.async
//     into the swizzled tiles paced the SM at about 5 bytes a cycle.  But a
//     unit's rows are contiguous: lane 0 copies each unit's resident rows
//     and each tile's rows by one 1-D bulk copy a tensor (from the 16-byte
//     boundary at or before the first byte; the last 8 bytes by cp.async)
//     into linear entries of two rings, resident and tile, as many entries as
//     fit; the other lanes bring the rows' LSE and delta by cp.async.  Lane 0
//     also writes each unit's outputs back, staged by the consumers as rows
//     in the unit's resident entry, by one 1-D bulk store a tensor, and then
//     refills the entry.
//   - Consumers (two warpgroups).  The resident rows are the A operand of
//     S = R1 T1^T and dP = R2 T2^T, so each thread loads its rows' mma
//     fragments straight from the linear entry into registers (and their
//     |x|^2 from them); the tile, the B operand of every product, is re-laid
//     by the consumers into a 128-byte-swizzled pair of 64-column boxes, and
//     its entry goes back to the producer at once.  With one tile a unit
//     (n <= 64, the v1 shapes) the warpgroups take alternate units
//     (ping-pong), so that one's loads, barriers and epilogue overlap the
//     other's products: S and dP of the unit's 64 rows, P and dS, then each
//     64-column box of the outputs in turn with 32 accumulator registers.
//     With more tiles the two take every unit in lockstep, dK and dV (or dQ)
//     in f32 registers across the tiles, each warpgroup a column box (Dh >
//     64) or 64 of the resident rows (Dh <= 64), re-laying one tensor of each
//     tile each.  A tile:
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
//   - The epilogue reads the resident rows of R1 (k or q) from the linear
//     entry, applies the `l2` finish and stages bf16 rows < n, columns < d.
//     No atomics: two calls are bit-equal.
//
// ptxas -v: PERF.md records the registers, spills and warnings of both
// kernels at DP 112 and 64; chip_smoke.py prints them and fails on a spill or
// a performance warning there.
#pragma once

#include "hopper.cuh"

namespace vk {
namespace l2bwd {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int THREADS = 384;  // two consumer warpgroups + the producer warpgroup
constexpr int TILE = 64;      // rows of a streamed tile
constexpr int SMEM_LIMIT = 232448;  // shared memory a block can use on this card
// Named barriers: the two consumer warpgroups (lockstep) after a tile's
// re-layout and after its norms; warpgroup w's own (ping-pong).
constexpr int BAR_PAIR = 1, BAR_PAIR2 = 2, BAR_WG = 3;

__host__ __device__ constexpr int round16(int x) { return (x + 15) / 16 * 16; }

// Shared-memory geometry for a head dimension padded to DP (a multiple of 16).
template <int DP>
struct Geo {
  static constexpr int NB = (DP + 63) / 64;     // 64-column boxes a row
  static constexpr int DPAD = 64 * NB;
  static constexpr int R = NB == 1 ? 128 : 64;  // resident rows a unit
  static constexpr int SBOX = TILE * 128;       // one box of a swizzled tile
  static constexpr int SWZ = 2 * NB * SBOX;     // a tile pair, swizzled
  static constexpr int RING_MAX = 4;
  // offsets from the 1024-byte-aligned base: two swizzled tile pairs, their
  // rows (LSE, delta, norms), the mbarriers; the linear rings follow (Rings)
  static constexpr int OFF_TROWS = 2 * SWZ;
  static constexpr int OFF_BARS = OFF_TROWS + 2 * 3 * TILE * 4;
  static constexpr int OFF_RINGS = OFF_BARS + round16(4 * RING_MAX * 8);
};

// The linear rings at head width d and N tokens: resident entries (a unit's
// min(R, n) rows of two tensors, each with 16 bytes of slack for a start that
// is not 16-byte aligned, then their LSE and delta) and tile entries
// (min(64, n) rows), as many of each as fit, alternately, up to RING_MAX.
struct Rings {
  int rrows, rtensor, rbytes, trows, ttensor, tbytes, rn, tn, smem;
  template <int DP>
  __host__ __device__ static Rings of(int n, int d) {
    using G = Geo<DP>;
    Rings g;
    g.rrows = n < G::R ? n : G::R;
    g.trows = n < TILE ? n : TILE;
    g.rtensor = round16(g.rrows * d * 2 + 16);
    g.ttensor = round16(g.trows * d * 2 + 16);
    g.rbytes = 2 * g.rtensor + round16(2 * g.rrows * 4);
    g.tbytes = 2 * g.ttensor + round16(2 * g.trows * 4);
    const int room = SMEM_LIMIT - 1024 - G::OFF_RINGS;
    g.rn = g.tn = 2;
    for (bool grew = true; grew;) {
      const bool r_fits = g.rn < G::RING_MAX && (g.rn + 1) * g.rbytes + g.tn * g.tbytes <= room;
      const bool t_fits = g.tn < G::RING_MAX && g.rn * g.rbytes + (g.tn + 1) * g.tbytes <= room;
      grew = r_fits || t_fits;
      if (r_fits && (g.rn <= g.tn || !t_fits)) ++g.rn;
      else if (t_fits) ++g.tn;
    }
    g.smem = 1024 + G::OFF_RINGS + g.rn * g.rbytes + g.tn * g.tbytes;
    return g;
  }
};

// Re-lays `rows` rows of a row-major bf16 matrix of d columns (row stride 2d
// bytes, 8-byte aligned) into a 64-row tile of 64-column boxes `box` bytes
// apart at dst (128-byte swizzle), 8 bytes a lane, by 128 threads (pt their
// index): warp pw takes rows pw, pw + 4, ..., four rows' loads in flight
// before their stores, lane l columns 4l .. 4l + 3 of the DPAD.  With `fill`,
// rows past `rows` and columns past d are written as zeros; without, they
// are left as they are (zeros from an earlier fill with the same rows).
template <int DPAD>
__device__ inline void relayout(unsigned char* __restrict__ dst, int box,
                                const unsigned char* __restrict__ src, int rows, int d, int pt,
                                bool fill) {
  const int c = 4 * (pt & 31);
  if (c >= (fill ? DPAD : d)) return;
  unsigned char* col = dst + (c >> 6) * box + ((c >> 2) & 1) * 8;
  const int chunk = (c & 63) >> 3, stride = d * 2;
  const bool in_col = c < d;
  const int end = fill ? TILE : rows;
  for (int r0 = pt >> 5; r0 < end; r0 += 16) {
    uint2 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = r0 + 4 * u;
      v[u] = in_col && r < rows ? *reinterpret_cast<const uint2*>(src + r * stride + 2 * c)
                                : make_uint2(0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = r0 + 4 * u;
      if (r < end) *reinterpret_cast<uint2*>(col + r * 128 + ((chunk ^ (r & 7)) << 4)) = v[u];
    }
  }
}

// The mma.m16n8k16 A fragments of rows r and r + 8 of a row-major bf16 matrix
// in shared memory (d columns, row stride 2d bytes), DP columns deep: a[kk]
// holds (row r, columns 16 kk + 2t, + 1), (r + 8, the same), (r, + 8),
// (r + 8, + 8), t = lane % 4; zeros past d and at rows >= nrows.  The rows
// of warp i of a warpgroup are the A operand rows 16i .. of a wgmma.
template <int DP>
__device__ inline void load_frags(uint32_t (&a)[DP / 16][4], const unsigned char* m, int r,
                                  int nrows, int d) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r + 8 * (e & 1), col = 16 * kk + 8 * (e >> 1) + 2 * t;
      a[kk][e] = row < nrows && col < d
                     ? *reinterpret_cast<const uint32_t*>(m + row * d * 2 + col * 2)
                     : 0u;
    }
}

// |x|^2 in f32 of the two rows of A fragments (nr[h]: row r + 8 h), summed by
// the lane's group of four.
template <int K>
__device__ inline void frag_norms(const uint32_t (&a)[K][4], float (&nr)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float s = 0.f;
#pragma unroll
    for (int kk = 0; kk < K; ++kk)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float2 f =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a[kk][h + 2 * q]));
        s = fmaf(f.x, f.x, fmaf(f.y, f.y, s));
      }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    nr[h] = s;
  }
}

// |x|^2 in f32 of row r of a swizzled tile (boxes `box` bytes apart; zeros
// past d): the L lanes t = lane % L (L = 2 or 4) sum 16-byte chunks t, t + L,
// ... of the DP / 8, then shuffles; all L return the sum.
template <int DP, int L = 4>
__device__ inline float row_norm(const unsigned char* tile, int box, int r) {
  const int t = threadIdx.x & (L - 1);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < (DP / 8 + L - 1) / L; ++i) {
    const int c = t + L * i;
    if (c < DP / 8) {
      const uint4 raw = *reinterpret_cast<const uint4*>(tile + (c >> 3) * box + r * 128 +
                                                        (((c & 7) ^ (r & 7)) << 4));
      const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&words[k]));
        s = fmaf(f.x, f.x, fmaf(f.y, f.y, s));
      }
    }
  }
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  if (L == 4) s += __shfl_xor_sync(0xffffffffu, s, 2);
  return s;
}

// Column block j of an m64n64 accumulator fragment (rows g, g + 8; columns
// 8 j + 2 t, + 1) as four columns of one row: lanes t and t ^ 1 trade halves,
// even t keeping row g, odd t row g + 8, columns 8 j + 2 (t & 2) .. + 3.
// Every lane of the warp calls it.
__device__ inline float4 row_quad(const float (&a)[32], int j) {
  const int t = threadIdx.x & 3;
  const float x0 = (t & 1) ? a[4 * j] : a[4 * j + 2];
  const float x1 = (t & 1) ? a[4 * j + 1] : a[4 * j + 3];
  const float y0 = __shfl_xor_sync(0xffffffffu, x0, 1);
  const float y1 = __shfl_xor_sync(0xffffffffu, x1, 1);
  return (t & 1) ? make_float4(y0, y1, a[4 * j + 2], a[4 * j + 3])
                 : make_float4(a[4 * j], a[4 * j + 1], y0, y1);
}

// What the two consumer modes share: the shared-memory layout, the barriers
// and the problem.
template <int DP>
struct Shared {
  unsigned char* swz;    // two swizzled tile pairs, Geo::SWZ apart
  float* trows;          // their rows: LSE, delta, norms (3 TILE floats each)
  unsigned char* rings;  // the resident entries, then the tile entries
  uint64_t *rfull, *rfree, *tfull, *tfree;
  Rings g;
  int n, d, bhs, per, units, ntiles;
  float scale_log2, inv_scale;
  __device__ unsigned char* rent(int i) const { return rings + (i % g.rn) * g.rbytes; }
  __device__ unsigned char* tent(int c) const {
    return rings + g.rn * g.rbytes + (c % g.tn) * g.tbytes;
  }
  // byte offset within 16 of row r of head bh: where its first byte landed
  __device__ int off(int bh, int r) const { return (int)((((long)bh * n + r) * d * 2) & 15); }
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

// The 16 x 16 bf16 A fragments of a 64 x 64 accumulator (16 columns a step).
__device__ __forceinline__ void pack_frags(uint32_t (&f)[4][4], const float (&a)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) f[kk][r] = pack_bf16(a[8 * kk + 2 * r], a[8 * kk + 2 * r + 1]);
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
// the unit's resident entry as its rows: out2 (dv) in the R2 half as it is
// formed (r2 is in registers), out1 in the R1 half once every thread of the
// warpgroup has read its x there.
template <int DP, bool DKV>
__device__ __forceinline__ void consume_units(const Shared<DP>& sh, int w) {
  using namespace hopper;
  using G = Geo<DP>;
  constexpr int NB = G::NB;
  const int n = sh.n, d = sh.d;
  const int ct = threadIdx.x & 127, lane = threadIdx.x & 31;
  const int wr = ct >> 5, g = lane >> 2, t = lane & 3;
  const int lrow = 16 * wr + g;               // this thread's rows lrow, lrow + 8
  const int orow = lrow + ((t & 1) ? 8 : 0);  // the row whose outputs this lane stores
  const bool row_ok[2] = {lrow < n, lrow + 8 < n};
  unsigned char* sw = sh.swz + w * G::SWZ;
  float* rows = sh.trows + w * 3 * TILE;  // the tile's LSE and delta (dk/dv), its norms
  const int mine = blockIdx.x < sh.units ? (sh.units - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  for (int i = w; i < mine; i += 2) {
    const int bh = blockIdx.x + i * gridDim.x, off = sh.off(bh, 0);
    mbar_wait(&sh.rfull[i % sh.g.rn], (i / sh.g.rn) & 1);
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
    mbar_wait(&sh.tfull[i % sh.g.tn], (i / sh.g.tn) & 1);
    const unsigned char* te = sh.tent(i);
    // (this warpgroup's pair keeps its zero rows and columns after its first unit)
    relayout<G::DPAD>(sw, G::SBOX, te + off, n, d, ct, i == w);
    relayout<G::DPAD>(sw + NB * G::SBOX, G::SBOX, te + sh.g.ttensor + off, n, d, ct, i == w);
    if constexpr (DKV) {
      const float* rw = reinterpret_cast<const float*>(te + 2 * sh.g.ttensor);
      if (ct < TILE) {
        rows[ct] = ct < n ? rw[ct] : 0.f;
        rows[TILE + ct] = ct < n ? rw[sh.g.trows + ct] : 0.f;
      }
    }
    fence_proxy_async();  // the re-laid tile before the wgmmas read it
    named_bar_sync(BAR_WG + w, 128);
    if (ct == 0) mbar_arrive(&sh.tfree[i % sh.g.tn]);
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
    uint32_t pf[4][4], df[4][4];
    pack_frags(pf, sa);
    pack_frags(df, pa);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    }
    const float sm = (t & 1) ? sum[1] : sum[0];
    const float two = 2.f * sh.inv_scale;
    uint2 o1[NB][8];
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
        const int col = 64 * b + 8 * j + 2 * (t & 2);
        const bool in = orow < n && col < d;
        const float4 v1 = row_quad(a1c, j);
        const uint2 xr = in ? *reinterpret_cast<const uint2*>(x1 + orow * d * 2 + col * 2)
                            : make_uint2(0u, 0u);
        const float2 x01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr.x));
        const float2 x23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr.y));
        o1[b][j] = make_uint2(pack_bf16(two * (v1.x - sm * x01.x), two * (v1.y - sm * x01.y)),
                              pack_bf16(two * (v1.z - sm * x23.x), two * (v1.w - sm * x23.y)));
        if constexpr (DKV) {
          const float4 v2 = row_quad(a2c, j);
          if (in)
            *reinterpret_cast<uint2*>(x2 + orow * d * 2 + col * 2) =
                make_uint2(pack_bf16(v2.x, v2.y), pack_bf16(v2.z, v2.w));
        }
      }
    }
    fence_frags(pf);
    fence_frags(df);
    named_bar_sync(BAR_WG + w, 128);  // every thread of the warpgroup has read its x
    if (orow < n) {
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 64 * b + 8 * j + 2 * (t & 2);
          if (col < d) *reinterpret_cast<uint2*>(x1 + orow * d * 2 + col * 2) = o1[b][j];
        }
    }
    fence_proxy_async();  // before the bulk stores read them
    mbar_arrive(&sh.rfree[i % sh.g.rn]);
  }
}

// Lockstep consumers (n > 64): both warpgroups take every unit of R resident
// rows and stream its tiles; warpgroup w re-lays tensor w of each tile into
// the shared swizzled pair (two pairs in turn), then takes resident rows
// roff .. roff + 63 and column box cb of the outputs (two boxes: the same
// rows, a box each; one box: 64 rows each), with the outputs in f32
// registers across the tiles.
template <int DP, bool DKV>
__device__ __forceinline__ void consume_blocks(const Shared<DP>& sh, int w) {
  using namespace hopper;
  using G = Geo<DP>;
  constexpr int NB = G::NB, R = G::R;
  const int n = sh.n, d = sh.d;
  const int ct = threadIdx.x & 127, lane = threadIdx.x & 31;
  const int wr = ct >> 5, g = lane >> 2, t = lane & 3;
  const int roff = NB == 1 ? 64 * w : 0, cb = NB == 1 ? 0 : w;
  const int lrow = roff + 16 * wr + g;        // this thread's resident rows lrow, lrow + 8
  const int orow = lrow + ((t & 1) ? 8 : 0);  // the row whose outputs this lane stores
  float acc1[32], acc2[DKV ? 32 : 1];
  int c = 0;
  for (int u = blockIdx.x, i = 0; u < sh.units; u += gridDim.x, ++i) {
    const int bh = u / sh.per, row0 = (u - bh * sh.per) * R;
    const int rows_u = min(R, n - row0), off = sh.off(bh, row0);
    mbar_wait(&sh.rfull[i % sh.g.rn], (i / sh.g.rn) & 1);
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
      mbar_wait(&sh.tfull[c % sh.g.tn], (c / sh.g.tn) & 1);
      const unsigned char* te = sh.tent(c);
      const int toff = sh.off(bh, tt * TILE);
      relayout<G::DPAD>(sw + w * NB * G::SBOX, G::SBOX, te + w * sh.g.ttensor + toff, rows_t, d,
                        ct, true);
      if (DKV && w == 0 && ct < TILE) {
        const float* rw = reinterpret_cast<const float*>(te + 2 * sh.g.ttensor);
        rows[ct] = ct < rows_t ? rw[ct] : 0.f;
        rows[TILE + ct] = ct < rows_t ? rw[sh.g.trows + ct] : 0.f;
      }
      fence_proxy_async();
      named_bar_sync(BAR_PAIR, 256);
      if (threadIdx.x == 0) mbar_arrive(&sh.tfree[c % sh.g.tn]);
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
    mbar_arrive(&sh.rfree[i % sh.g.rn]);
  }
}

// The body of both kernels.  DKV: r1, r2 = k, v resident; t1, t2 = q, dO
// streamed; out1 = dk, out2 = dv.  Else: r1, r2 = q, dO resident; t1, t2 = k,
// v streamed; out1 = dq.  lse (natural log), delta: (bh, n) f32; q, k, v, dO
// and the outputs (bh, n, d) bf16, d a multiple of 4, 8-byte aligned.
template <int DP, bool DKV>
__device__ __forceinline__ void body(const bf16* __restrict__ r1, const bf16* __restrict__ r2,
                                     const bf16* __restrict__ t1, const bf16* __restrict__ t2,
                                     const float* __restrict__ lse,
                                     const float* __restrict__ delta, bf16* __restrict__ out1,
                                     bf16* __restrict__ out2, int bhs, int n, int d,
                                     float scale_log2, float inv_scale) {
  using namespace hopper;
  using G = Geo<DP>;
  constexpr int R = G::R;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  Shared<DP> sh;
  sh.swz = smem;
  sh.trows = reinterpret_cast<float*>(smem + G::OFF_TROWS);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + G::OFF_BARS);
  sh.rfull = bars;
  sh.rfree = bars + G::RING_MAX;
  sh.tfull = bars + 2 * G::RING_MAX;
  sh.tfree = bars + 3 * G::RING_MAX;
  sh.rings = smem + G::OFF_RINGS;
  sh.g = Rings::of<DP>(n, d);
  sh.n = n, sh.d = d, sh.bhs = bhs;
  sh.per = (n + R - 1) / R;
  sh.units = bhs * sh.per;
  sh.ntiles = (n + TILE - 1) / TILE;
  sh.scale_log2 = scale_log2, sh.inv_scale = inv_scale;
  // One tile a unit (n <= 64): the consumer warpgroups take alternate units
  // (ping-pong); else both take every unit, lockstep.
  const bool pingpong = sh.ntiles == 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < G::RING_MAX; ++s) {
      mbar_init(&sh.rfull[s], 32);  // producer warp 3: the bulk copies' bytes + 31 lanes
      mbar_init(&sh.tfull[s], 32);
      mbar_init(&sh.rfree[s], pingpong ? 128 : 256);  // the unit's consumers, outputs staged
      mbar_init(&sh.tfree[s], 1);                     // once the tile is re-laid out
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // producer: warp 3 of the producer warpgroup
    reg_dealloc<40>();
    if (threadIdx.x < 352) return;
    const int l = threadIdx.x & 31;
    const int mine = blockIdx.x < sh.units ? (sh.units - 1 - blockIdx.x) / gridDim.x + 1 : 0;
    // The copies of `rows` rows from row r0 of head bh of x and y (and their
    // LSE and delta with `carry`) into entry e (tensors `tensor` bytes apart,
    // then the rows' floats): lane 0 copies the two tensors' rows by 1-D bulk
    // copies from the 16-byte boundary at or before their first byte, its
    // arrival counting their bytes; lane 1 the last 8 bytes where the end is
    // not 16-byte aligned, and lanes 1 .. 31 the LSE and delta by cp.async,
    // each arriving once its copies have landed.
    auto issue = [&](unsigned char* e, int tensor, int stride, uint64_t* bar, const bf16* x,
                     const bf16* y, int bh, int r0, int rows, bool carry) {
      const long s0 = ((long)bh * n + r0) * d * 2, end = s0 + (long)rows * d * 2;
      const long a0 = s0 & ~15L, e0 = end & ~15L;
      const char* xb = reinterpret_cast<const char*>(x);
      const char* yb = reinterpret_cast<const char*>(y);
      if (l == 0) {
        mbar_arrive_tx(bar, 2 * (uint32_t)(e0 - a0));
        if (e0 > a0) {
          bulk_load(e, xb + a0, (uint32_t)(e0 - a0), bar);
          bulk_load(e + tensor, yb + a0, (uint32_t)(e0 - a0), bar);
        }
        return;
      }
      if (l == 1 && e0 < end) {
        cp_async8(e + (e0 - a0), xb + e0);
        cp_async8(e + tensor + (e0 - a0), yb + e0);
      }
      if (carry) {
        float* rw = reinterpret_cast<float*>(e + 2 * tensor);
        for (int j = l - 1; j < rows; j += 31) {
          cp_async4(rw + j, lse + (long)bh * n + r0 + j);
          cp_async4(rw + stride + j, delta + (long)bh * n + r0 + j);
        }
      }
      cp_async_arrive(bar);
    };
    // The outputs of the block's unit i, staged in its resident entry as the
    // unit's rows of each output: one 1-D bulk store a tensor from the first
    // 16-byte boundary, the 8 bytes before it and after the last one by plain
    // stores (lane 0); then the entry may be filled again.
    auto store = [&](int i) {
      const int u = blockIdx.x + i * gridDim.x, bh = u / sh.per, row0 = (u - bh * sh.per) * R;
      const long s0 = ((long)bh * n + row0) * d * 2, e = s0 + (long)min(R, n - row0) * d * 2;
      const int off = (int)(s0 & 15);
      const long a0 = off ? s0 + 8 : s0, e0 = e & ~15L;
#pragma unroll
      for (int o = 0; o < (DKV ? 2 : 1); ++o) {
        char* gp = reinterpret_cast<char*>(o ? out2 : out1);
        const unsigned char* so = sh.rent(i) + o * sh.g.rtensor + off;
        if (off) *reinterpret_cast<uint2*>(gp + s0) = *reinterpret_cast<const uint2*>(so);
        if (e0 > a0) bulk_store(gp + a0, so + (a0 - s0), (uint32_t)(e0 - a0));
        if (e0 < e) *reinterpret_cast<uint2*>(gp + e0) = *reinterpret_cast<const uint2*>(so + (e0 - s0));
      }
      bulk_commit();
      bulk_wait_read<0>();
    };
    int c = 0;  // tiles issued
    for (int i = 0; i < mine; ++i) {
      const int u = blockIdx.x + i * gridDim.x, bh = u / sh.per, row0 = (u - bh * sh.per) * R;
      if (i >= sh.g.rn) {
        mbar_wait(&sh.rfree[i % sh.g.rn], ((i / sh.g.rn) - 1) & 1);
        if (l == 0) store(i - sh.g.rn);
        __syncwarp();
      }
      issue(sh.rent(i), sh.g.rtensor, sh.g.rrows, &sh.rfull[i % sh.g.rn], r1, r2, bh, row0,
            min(R, n - row0), !DKV);
      for (int tt = 0; tt < sh.ntiles; ++tt, ++c) {
        if (c >= sh.g.tn) mbar_wait(&sh.tfree[c % sh.g.tn], ((c / sh.g.tn) - 1) & 1);
        issue(sh.tent(c), sh.g.ttensor, sh.g.trows, &sh.tfull[c % sh.g.tn], t1, t2, bh,
              tt * TILE, min(TILE, n - tt * TILE), DKV);
      }
    }
    for (int i = max(mine - sh.g.rn, 0); i < mine; ++i) {  // the last units' outputs
      mbar_wait(&sh.rfree[i % sh.g.rn], (i / sh.g.rn) & 1);
      if (l == 0) store(i);
    }
    if (l == 0) bulk_wait<0>();
    return;
  }

  reg_alloc<232>();
  if (pingpong)
    consume_units<DP, DKV>(sh, threadIdx.x >> 7);
  else
    consume_blocks<DP, DKV>(sh, threadIdx.x >> 7);
}

template <int DP, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_l2_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, int bhs, int n, int d,
                        float scale_log2, float inv_scale) {
  static_assert(MODE == kL2, "the persistent two-pass kernels serve `l2` scores");
  body<DP, true>(k, v, q, dout, lse, delta, dk, dv, bhs, n, d, scale_log2, inv_scale);
}

template <int DP, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_l2_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       bf16* __restrict__ dq, int bhs, int n, int d, float scale_log2,
                       float inv_scale) {
  static_assert(MODE == kL2, "the persistent two-pass kernels serve `l2` scores");
  body<DP, false>(q, dout, k, v, lse, delta, dq, nullptr, bhs, n, d, scale_log2, inv_scale);
}

template <int DP, bool DKV>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* out1, void* out2, int bhs, int n, int d, float inv_scale,
           int grid, cudaStream_t stream) {
  const int smem = Rings::of<DP>(n, d).smem;
  const auto* qb = static_cast<const bf16*>(q);
  const auto* kb = static_cast<const bf16*>(k);
  const auto* vb = static_cast<const bf16*>(v);
  const auto* db = static_cast<const bf16*>(dout);
  const auto* lb = static_cast<const float*>(lse);
  const auto* eb = static_cast<const float*>(delta);
  if constexpr (DKV) {
    cudaFuncSetAttribute(flash_bwd_dkv_l2_kernel<DP, kL2>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    flash_bwd_dkv_l2_kernel<DP, kL2><<<grid, THREADS, smem, stream>>>(
        qb, kb, vb, db, lb, eb, static_cast<bf16*>(out1), static_cast<bf16*>(out2), bhs, n, d,
        inv_scale * LOG2E, inv_scale);
  } else {
    cudaFuncSetAttribute(flash_bwd_dq_l2_kernel<DP, kL2>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    flash_bwd_dq_l2_kernel<DP, kL2><<<grid, THREADS, smem, stream>>>(
        qb, kb, vb, db, lb, eb, static_cast<bf16*>(out1), bhs, n, d, inv_scale * LOG2E,
        inv_scale);
  }
  return (int)cudaGetLastError();
}

// DKV: out1 = dk, out2 = dv; else out1 = dq.  Refuses d not a multiple of 4
// or above 128, pointers not 8-byte aligned, and an empty grid.
template <bool DKV>
int dispatch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
             const void* delta, void* out1, void* out2, int bhs, int n, int d, float inv_scale,
             int grid, cudaStream_t s) {
  const void* ptrs[6] = {q, k, v, dout, out1, DKV ? out2 : out1};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 8 != 0) return (int)cudaErrorInvalidValue;
  if (d % 4 != 0 || d <= 0 || grid <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
#define VK_L2(DP) \
  launch<DP, DKV>(q, k, v, dout, lse, delta, out1, out2, bhs, n, d, inv_scale, grid, s)
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

}  // namespace l2bwd
}  // namespace vk
