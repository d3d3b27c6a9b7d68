// The f32 A . W^T tile for Hopper (sm_90a): C = A . W^T on TF32 wgmma over a
// TMA ring, A (m, k) and W (n, k) both K-major, TF32 x TF32 with f32
// accumulation, and six epilogues (tile_f32_kernel<EPI, ACT>).
//   The megablock's saved backward (W the weight as it lies: every weight of
//   the backward's dy products is (in, out) = (n, k) row by row):
//     kDz1: dz1 = C * gelu'(z1) and h1 = gelu(z1)   (C = dmlp . w2^T)
//     kDy:  dy = C, a plain f32 store               (dy2 = dz1 . w1^T,
//           dy1 = dqkv . wqkv^T)
//     kDao: dao = C scattered into (B, H, N, Dh) and delta (B, H, N) =
//           each head's sum of dao * ao             (C = da . wout^T)
//   The LayerNorm family's forward (ln_f32.cuh: W a K-major copy of the (k,
//   n) weight that the wrapper makes in each call, A the LayerNorm's rows
//   y = LN(x) for the LN entries):
//     kFc1:    z1 = C + b1 [stored] and h = act(z1)   (ACT: common.cuh activate)
//     kLinear: out = [res +] [mask *] (C + bias), the mask stored
//     kQkv:    qkv = C + bias scattered into (3, B, H, N, Dh)
// The backward's three entries, each its own source (megablock_bwd_mlp_dz1_f32.cu,
// megablock_bwd_dy_f32.cu, megablock_bwd_mlp_dao_f32.cu), replace these
// products at f32 inputs in the TPU kernel `_bwd_kernel`
// (vitgan_tpu/ops/fused_block.py:484-628, pallas_call at :700), which
// computes in its input dtype (runtime.compute_dtype=float32); the
// forward's, those of `_kernel` (ln_f32.cuh).  The saved backward's other
// f32 entries are ln_rows.cuh's mask and LayerNorm-backward rows and
// wgrad_gemm_f32.cu.  The bf16 kernels stay as they are; the wrappers
// (ops/fused_mlp.py, ops/fused_block.py) send each call to one or the other
// by its dtype.
//
// Math (`_bwd_kernel`, `_kernel`): every product TF32 x TF32 with f32
// accumulation, each operand rounded to TF32 to nearest (ties to even) as it
// lands; GELU and GELU' the exact erf forms; bias, activation, mask and
// residual in f32; delta a plain f32 sum over the head's columns in column
// order; every output f32.  No atomics: two calls give the same bits.  The
// linear stage's mask is common.cuh's Philox bits on the element's place in
// the global batch (row r of sample s = r / rps keyed as row (s / local *
// global + first + s % local) rps + r % rps), the bits ln_mlp_fwd.cu's
// linear stage draws: the two masks are bit-equal at one seed, mask id and
// rows, whatever the dtype.
//
// Design.  A persistent grid (a block an SM, at most one an output tile) of
// 640 threads in five warpgroups: thread 0 of warpgroup 0 streams A's and
// W's boxes by TMA into a ring of mbarrier stages; warpgroups 1 and 2 (the
// consumers) multiply 64 rows each of a 128 x 128 output tile (m64n128k8,
// both operands from shared memory, 64 accumulators a thread, the stage
// released once its products are done at a wait depth of one); warpgroups 3
// and 4 (the epilogue) take each finished tile from a staged copy while the
// consumers multiply the next.  A box is 32 floats (one 128-byte swizzle
// row) by 128 rows, the canonical K-major SW128 atom that the bf16 kernels'
// 64-bf16 boxes are (hopper.cuh desc_sw128), so a k8 step adds 32 bytes to
// the descriptors.  Tiles go to blocks in turn, a row unit's column tiles
// together (blocks that run at once share A's rows and W in L2); a stage is
// A's box and W's (32 KB), three deep where the epilogue lands an operand
// (kDz1's z1, kDao's ao), five deep where it lands none (kDy, kFc1, kLinear,
// kQkv).  TMA's zero fill takes the ragged edges: rows past m,
// the summed width's tail where k is not a multiple of 32, W's rows past n.
// Rounding: the tensor core reads the top 19 bits of an f32 operand and
// drops the rest (truncation toward zero, biased).  A's and W's tensor maps
// are TFLOAT32 (hopper.cuh tmap_2d_tf32), so the TMA unit rounds each value
// to nearest as it lands and no thread rewrites a stage.  (Rounded in place
// by the consumers with cvt.rna instead, or by the producer warpgroup's
// spare warps, the rounding's shared-memory traffic and its barrier were
// the products' largest cost: PERF.md.)
// The hand-off: the consumers write their accumulators into the staged tile
// (64 KB, 32-column swizzled boxes: a warp's pairs hit 32 banks) once the
// epilogue has released it, then arrive on an mbarrier; the epilogue
// releases it when done.  Epilogues, a warp a row and a lane a 16-byte chunk
// (4 columns), the operand (z1 or ao) landed by TMA a quarter of the rows
// at a time, each quarter landing the next tile's as soon as it has been
// read:
//   kDz1 forms Phi(z) once an element and stores dz1 and h1 (a warp a whole
//       512-byte row segment each);
//   kDy stores the staged tile by TMA (rows past m and columns past n
//       clipped);
//   kDao owns whole heads: a tile is floor(128 / Dh) heads (the columns past
//       them multiply W's next rows and are dropped; every Dh <= 128 that is
//       a multiple of 8).  Each chunk of dao goes out to (B, H, N, Dh), since
//       a 128-row tile may straddle a batch (1,025 or 257 tokens), and the
//       products dao * ao replace it in the staged tile; then a thread a
//       (row, head) sums its Dh products in column order into delta;
//   kFc1 stores z1 (when asked) and h, a warp a whole 512-byte row segment
//       each;
//   kLinear draws a chunk's four mask values from one Philox call, reads
//       the residual's chunk from device memory (landing its tile would cost
//       the ring two stages, and at K 1,536 three stages hold the products
//       back: PERF.md), then stores the mask and out;
//   kQkv sends each chunk to its place in (3, B, H, N, Dh): Dh is a multiple
//       of 8, so a chunk never crosses a head, and a 128-row tile may
//       straddle a batch as kDao's does.
// No row past m and no column past n is written.
//
// Bound on this card (4-byte operands, 494.7 TFLOP/s TF32, 3.35 TB/s) at
// highres128's G (32,768 rows, E 384, hidden 1,536, 6 heads of 64), each
// input read once and each output written once: dz1 reads dmlp, z1 and w2
// and writes dz1 and h1, 657 MB (0.196 ms, bytes); dy2 3.87e10 flops (0.078
// ms, operations); dy1 203 MB (0.061 ms, bytes); dao with delta 152 MB
// (0.045 ms, bytes); the forward's in ln_f32.cuh.  The products' stage
// costs shared memory 80 KB of traffic (TMA's 32 KB in, the two
// warpgroups' wgmma reads of 48 KB) for 1 MFLOP, some 640 clocks at 128
// bytes a clock where the tensor core needs 512: the products run near the
// shared memory's pace.  dz1's 402 MB of stores against its reads hold it
// near 2.2 TB/s.  Times against the bounds: PERF.md, chip_smoke.py [f32 bwd
// kernels] and [f32 ln kernels], scripts/kernel_ab.py --f32-bwd and --f32-ln.
#pragma once

#include "hopper.cuh"

namespace vk {
namespace tilef32 {

using namespace vk::hopper;

constexpr int BM = 128;             // rows a tile: two consumer warpgroups of 64
constexpr int BN = 128;             // output columns a tile (kDao: its whole heads)
constexpr int BK = 32;              // summed columns a stage: a 128-byte swizzle row of f32
constexpr int THREADS = 640;        // producer, two consumers, two epilogue warpgroups
constexpr int ETHREADS = 256;       // the epilogue warpgroups' threads
constexpr int OB = 32;              // columns of a box (128 bytes a row)
constexpr int NB = BN / OB;         // boxes a tile
constexpr int BOX = BM * OB * 4;    // a box of the tile's 128 rows: 16 KB
constexpr int HALF = BOX / 2;       // its 64 rows of a consumer warpgroup
constexpr int STAGE = 2 * BOX;      // A's box (128 rows x 32), then W's
constexpr int TILE = NB * BOX;      // a 128 x 128 f32 tile: 64 KB
constexpr int QROWS = 32;           // the epilogue operand lands a quarter of the rows at a time
constexpr int QBOX = QROWS * OB * 4;  // a quarter of a box: 4 KB

enum Epi : int { kDz1 = 0, kDy = 1, kDao = 2, kFc1 = 3, kLinear = 4, kQkv = 5 };

// Whether EPI lands an operand by TMA; an epilogue that lands none runs a
// deeper ring.
template <int EPI>
constexpr bool LANDS = EPI == kDz1 || EPI == kDao;
template <int EPI>
constexpr int STAGES = LANDS<EPI> ? 3 : 5;
template <int EPI>
constexpr int XBYTES = LANDS<EPI> ? TILE : 0;  // z1's or ao's tile, landed
template <int EPI>
constexpr int SMEM = 1024 + STAGES<EPI> * STAGE + TILE + XBYTES<EPI> + (2 * STAGES<EPI> + 6) * 8;
static_assert(SMEM<kDy> <= 232448 && SMEM<kDz1> <= 232448, "a block an SM");

struct Params {
  int m, k, n;
  int ncol;       // output columns a tile: BN, or kDao's whole heads
  float* out;     // kDz1: dz1, kFc1: h, kLinear: out (m, n); kQkv: (3, batch, heads, tokens, dh)
  float* h1;      // kDz1: (m, n)
  float* z1;      // kFc1: (m, n), or null
  float* dao;     // kDao: (batch, heads, tokens, dh)
  float* delta;   // kDao: (batch, heads, tokens)
  const float* bias;  // kFc1, kLinear, kQkv: (n,)
  const float* res;  // kLinear: the (m, n) residual, or null
  float* mask;    // kLinear: the (m, n) multiply-mask, or null: no dropout
  const long long* seed;
  uint32_t mask_id, threshold;
  float inv_keep;
  int rps, local, global, first;  // the mask's rows in the global batch
  int batch, tokens, heads, dh;   // kDao, kQkv
};

// The 16-byte chunk holding columns c .. c + 3 (c a multiple of 4) of row r
// of a tile of 32-column boxes of 128 rows.
__device__ inline float4* chunk(unsigned char* tile, int r, int c) {
  return reinterpret_cast<float4*>(tile + (c >> 5) * BOX + r * 128 +
                                   ((((c & 31) >> 2) ^ (r & 7)) << 4));
}

// Inverted-dropout multiply-masks of elements idx .. idx + 3 (idx a multiple
// of 4) of mask `id`: common.cuh dropout_pair's bits of idx and idx + 2,
// from one Philox call.
__device__ inline float4 dropout_quad(uint2 key, uint32_t id, long long idx, uint32_t threshold,
                                      float inv_keep) {
  const unsigned long long q = static_cast<unsigned long long>(idx) >> 2;
  const uint4 w = philox4x32_10(
      make_uint4(static_cast<uint32_t>(q), static_cast<uint32_t>(q >> 32), id, 0u), key);
  return make_float4(w.x >= threshold ? inv_keep : 0.f, w.y >= threshold ? inv_keep : 0.f,
                     w.z >= threshold ? inv_keep : 0.f, w.w >= threshold ? inv_keep : 0.f);
}

__device__ inline float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// The epilogue warpgroups' work on quarter q (rows 32 q .. 32 q + 31) of a
// staged tile whose rows start at r0 and columns at n0 (.. nend - 1): warp ew
// (0 .. 7) takes rows 32 q + ew, + 8, .., lane l the row's 16-byte chunk l
// (columns 4 l .. 4 l + 3), if the tile has it.  `key`: kLinear's Philox key.
template <int EPI, int ACT>
__device__ inline void epilogue_rows(const Params& p, unsigned char* staged,
                                     unsigned char* xland, int q, int r0, int n0, int nend,
                                     int ew, int l, uint2 key) {
  const int c = 4 * l, col = n0 + c;
  if (l >= (EPI == kDao ? p.ncol : BN) / 4 || col >= nend) return;
  float4 bias = make_float4(0.f, 0.f, 0.f, 0.f);
  if constexpr (EPI >= kFc1) bias = __ldg(reinterpret_cast<const float4*>(p.bias + col));
  // kQkv: the chunk's part, head and feature (it lies in one head: col and
  // Dh are multiples of 4 and 8)
  int part = 0, head = 0, d0 = 0;
  if constexpr (EPI == kQkv) {
    const int hd = p.heads * p.dh;
    part = col / hd;
    head = (col - part * hd) / p.dh;
    d0 = col - part * hd - head * p.dh;
  }
#pragma unroll
  for (int k = 0; k < QROWS * 32 / ETHREADS; ++k) {
    const int rr = QROWS * q + ew + k * (ETHREADS / 32), row = r0 + rr;
    if (row >= p.m) break;
    float4* dp = chunk(staged, rr, c);
    const float4 d = *dp;
    if constexpr (EPI == kDz1) {
      const float4 x = *chunk(xland, rr, c);
      const float zs[4] = {x.x, x.y, x.z, x.w}, ds[4] = {d.x, d.y, d.z, d.w};
      float dz[4], h[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // Phi(z) once: gelu(z) = z Phi, gelu'(z) = Phi + z phi (exact erf)
        const float cdf = 0.5f * (1.f + erff(zs[j] * 0.70710678118654752f));
        dz[j] = ds[j] * (cdf + zs[j] * 0.39894228040143268f * __expf(-0.5f * zs[j] * zs[j]));
        h[j] = zs[j] * cdf;
      }
      const long off = (long)row * p.n + col;
      *reinterpret_cast<float4*>(p.out + off) = make_float4(dz[0], dz[1], dz[2], dz[3]);
      *reinterpret_cast<float4*>(p.h1 + off) = make_float4(h[0], h[1], h[2], h[3]);
    } else if constexpr (EPI == kDao) {
      // dao into (B, H, N, Dh): the chunk lies in one head (n0 and Dh are
      // multiples of 8), whatever batch the row is of; then dao * ao over
      // the staged dao
      const float4 x = *chunk(xland, rr, c);
      const int bi = row / p.tokens, tok = row - bi * p.tokens, hh = col / p.dh;
      *reinterpret_cast<float4*>(p.dao + (((long)bi * p.heads + hh) * p.tokens + tok) * p.dh +
                                 col - hh * p.dh) = d;
      *dp = make_float4(d.x * x.x, d.y * x.y, d.z * x.z, d.w * x.w);
    } else if constexpr (EPI == kFc1) {
      const float4 z = add4(d, bias);
      const long off = (long)row * p.n + col;
      if (p.z1 != nullptr) *reinterpret_cast<float4*>(p.z1 + off) = z;
      *reinterpret_cast<float4*>(p.out + off) =
          make_float4(activate<ACT>(z.x), activate<ACT>(z.y), activate<ACT>(z.z),
                      activate<ACT>(z.w));
    } else if constexpr (EPI == kLinear) {
      float4 v = add4(d, bias);
      const long off = (long)row * p.n + col;
      if (p.mask != nullptr) {
        long goff = 0;  // the row's place in the global batch less its own, in elements
        if (p.local != p.global) {
          const int s = row / p.rps;
          const long grow =
              ((long)(s / p.local) * p.global + p.first + s % p.local) * p.rps + row % p.rps;
          goff = (grow - row) * p.n;
        }
        const float4 mk = dropout_quad(key, p.mask_id, off + goff, p.threshold, p.inv_keep);
        v = make_float4(v.x * mk.x, v.y * mk.y, v.z * mk.z, v.w * mk.w);
        *reinterpret_cast<float4*>(p.mask + off) = mk;
      }
      if (p.res != nullptr) v = add4(v, __ldg(reinterpret_cast<const float4*>(p.res + off)));
      *reinterpret_cast<float4*>(p.out + off) = v;
    } else {
      // column (part H + head) Dh + d of row (b, tok) to (part, b, head, tok, d)
      const int bi = row / p.tokens;
      *reinterpret_cast<float4*>(
          p.out + (((long)(part * p.batch + bi) * p.heads + head) * p.tokens + row -
                   bi * p.tokens) * p.dh + d0) = add4(d, bias);
    }
  }
}

// kDao's delta from the staged products dao * ao: a thread a (row, head), its
// Dh products summed in column order.
__device__ inline void delta_rows(const Params& p, unsigned char* staged, int r0, int n0, int e) {
  const int hpb = p.ncol / p.dh, head0 = n0 / p.dh;
  for (int task = e; task < BM * hpb; task += ETHREADS) {
    const int rr = task & (BM - 1), hh = task / BM, row = r0 + rr, head = head0 + hh;
    if (row >= p.m || head >= p.heads) continue;
    float s = 0.f;
#pragma unroll 4
    for (int c = hh * p.dh; c < (hh + 1) * p.dh; c += 4) {
      const float4 v = *chunk(staged, rr, c);
      s += v.x;
      s += v.y;
      s += v.z;
      s += v.w;
    }
    const int bi = row / p.tokens;
    p.delta[((long)bi * p.heads + head) * p.tokens + row - bi * p.tokens] = s;
  }
}

// ta, tb: A's and W's maps (TF32, boxes 32 x 128 rows); tx: z1 (kDz1) or ao
// (kDao), to: dy (kDy), f32 boxes 32 x 128 rows.
template <int EPI, int ACT>
__global__ void __launch_bounds__(THREADS, 1)
tile_f32_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap to,
                const Params p) {
  constexpr int NS = STAGES<EPI>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* stages = align1024(smem_raw);  // stage s at s STAGE
  unsigned char* staged = stages + NS * STAGE;  // the accumulators' tile
  unsigned char* xland = staged + TILE;         // kDz1 / kDao: the operand's tile
  uint64_t* full = reinterpret_cast<uint64_t*>(xland + XBYTES<EPI>);
  uint64_t* empty = full + NS;
  uint64_t* accfull = empty + NS;  // the staged tile written, then read
  uint64_t* accempty = accfull + 1;
  uint64_t* xfull = accempty + 1;  // the operand's quarter q of the tile landed
  const int wgi = threadIdx.x >> 7, nkb = (p.k + BK - 1) / BK;
  const int ntiles = (p.n + p.ncol - 1) / p.ncol, tiles = (p.m + BM - 1) / BM * ntiles;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_init(accfull, 2);
    mbar_init(accempty, 1);
    for (int q = 0; q < BM / QROWS; ++q) mbar_init(&xfull[q], 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wgi == 0) {
    if (threadIdx.x == 0) {  // A's and W's boxes, 32 deep a stage, every tile of this block
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int r0 = tile / ntiles * BM, n0 = tile % ntiles * p.ncol;
        for (int kb = 0; kb < nkb; ++kb, ++it) {
          const int s = it % NS;
          if (it >= NS) mbar_wait(&empty[s], ((it / NS) - 1) & 1);
          unsigned char* st = stages + s * STAGE;
          mbar_arrive_tx(&full[s], STAGE);
          tma_load_2d(st, &ta, &full[s], kb * BK, r0);
          tma_load_2d(st + BOX, &tb, &full[s], kb * BK, n0);
        }
      }
    }
    return;
  }

  if (wgi >= 3) {  // the epilogue warpgroups: each staged tile, under the next one's products
    const int e = threadIdx.x - 384, ew = e >> 5, l = e & 31;
    if (EPI == kDy && e > 0) return;
    constexpr bool lands = LANDS<EPI>;
    // quarter q of tile `tile`'s operand (z1 or ao) into xland by TMA
    auto land = [&](int tile, int q) {
      const int r0 = tile / ntiles * BM, n0 = tile % ntiles * p.ncol;
      const int nbox = (min(p.n, n0 + p.ncol) - n0 + OB - 1) / OB;
      mbar_arrive_tx(&xfull[q], nbox * QBOX);
      for (int b = 0; b < nbox; ++b)
        tma_load_2d(xland + b * BOX + q * QBOX, &tx, &xfull[q], n0 + OB * b, r0 + QROWS * q);
    };
    if (lands && e == 0 && (int)blockIdx.x < tiles)
      for (int q = 0; q < BM / QROWS; ++q) land(blockIdx.x, q);
    uint2 key = make_uint2(0u, 0u);
    if constexpr (EPI == kLinear) {
      if (p.mask != nullptr) key = seed_key(p.seed);
    }
    int i = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++i) {
      const int r0 = tile / ntiles * BM, n0 = tile % ntiles * p.ncol;
      const int nend = min(p.n, n0 + p.ncol);
      mbar_wait(accfull, i & 1);
      if constexpr (EPI == kDy) {
        const int nbox = (nend - n0 + OB - 1) / OB;
        for (int b = 0; b < nbox; ++b) tma_store_2d(&to, staged + b * BOX, n0 + OB * b, r0);
        bulk_commit();
        bulk_wait_read<0>();  // the staged tile read: free for the next one
      } else {
        for (int q = 0; q < BM / QROWS; ++q) {
          if (lands) mbar_wait(&xfull[q], i & 1);
          epilogue_rows<EPI, ACT>(p, staged, xland, q, r0, n0, nend, ew, l, key);
          if (lands) {
            // the quarter read: it lands the next tile's while the others are worked
            named_bar_sync(3, ETHREADS);
            if (e == 0 && tile + (int)gridDim.x < tiles) land(tile + gridDim.x, q);
          }
        }
        if constexpr (EPI == kDao) delta_rows(p, staged, r0, n0, e);
        if (EPI == kDao || !lands) named_bar_sync(3, ETHREADS);  // the staged tile read
      }
      if (e == 0) mbar_arrive(accempty);
    }
    if (EPI == kDy) bulk_wait<0>();
    return;
  }

  // consumers: warpgroup w owns rows 64 w .. 64 w + 63 of each tile
  const int w = wgi - 1, ct = threadIdx.x & 127, lane = threadIdx.x & 31, wr = ct >> 5,
            g = lane >> 2, t = lane & 3;
  float acc[BN / 2];
  int it = 0, i = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++i) {
    for (int kb = 0; kb < nkb; ++kb, ++it) {
      const int s = it % NS;
      mbar_wait(&full[s], (it / NS) & 1);
      const unsigned char* st = stages + s * STAGE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk)
        wgmma_tf32_ss128(acc, desc_sw128(st + w * HALF + 32 * kk, 16, 1024),
                         desc_sw128(st + BOX + 32 * kk, 16, 1024), kb > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done: release it
      if (kb > 0 && ct == 0) mbar_arrive(&empty[(it - 1) % NS]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (ct == 0) mbar_arrive(&empty[(it - 1) % NS]);
    // the accumulators into the staged tile once the epilogue warpgroups have
    // read the last one: this thread holds rows 64 w + 16 wr + g + 8 h and
    // columns 8 j + 2 t (+ 1), box j / 4, pair j % 4 of it
    if (i > 0) mbar_wait(accempty, (i - 1) & 1);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(staged + (j >> 2) * BOX +
                                   swz_f32(64 * w + 16 * wr + g + 8 * h, j & 3, t)) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    if constexpr (EPI == kDy) fence_proxy_async();  // to the TMA unit's stores
    named_bar_sync(1 + w, 128);
    if (ct == 0) mbar_arrive(accfull);
  }
}

// k and n multiples of 8 (TMA's 16-byte strides, the epilogues' chunks).
inline bool dims_ok(int m, int k, int n) {
  return m >= 0 && k >= 8 && k % 8 == 0 && n >= 8 && n % 8 == 0;
}

// C = a . w^T with EPI (and ACT, kFc1's activation): x the epilogue operand
// landed by TMA (z1 or ao, or null), o the TMA-stored output (kDy's dy, or
// null).
template <int EPI, int ACT = 0>
int launch(const void* a, const void* w, const void* x, void* o, const Params& p, void* stream) {
  if (p.m == 0) return 0;
  CUtensorMap ta{}, tb{}, tx{}, to{};
  int err = tmap_2d_tf32(&ta, a, p.m, p.k, BM);
  if (!err) err = tmap_2d_tf32(&tb, w, p.n, p.k, BN);
  if (!err && x != nullptr) err = tmap_2d_f32(&tx, x, p.m, p.n, QROWS);
  if (!err && o != nullptr) err = tmap_2d_f32(&to, o, p.m, p.n, BM);
  if (err) return err;
  const long tiles = (long)((p.m + BM - 1) / BM) * ((p.n + p.ncol - 1) / p.ncol);
  if (tiles > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const int grid = tiles < sm_count() ? (int)tiles : sm_count();
  cudaError_t e = cudaFuncSetAttribute(tile_f32_kernel<EPI, ACT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM<EPI>);
  if (e != cudaSuccess) return (int)e;
  tile_f32_kernel<EPI, ACT><<<grid, THREADS, SMEM<EPI>, static_cast<cudaStream_t>(stream)>>>(
      ta, tb, tx, to, p);
  return (int)cudaGetLastError();
}

}  // namespace tilef32
}  // namespace vk
