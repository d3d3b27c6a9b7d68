// Saved-residual megablock backward, MLP half and out-projection, for Hopper
// (sm_90a), as a chain of three wgmma GEMM stages.
//
// Replaces the first half of `_bwd_kernel` in vitgan_tpu/ops/fused_block.py
// (lines 484-628, entered through `fused_encoder_block_bwd`, pallas_call at
// :700): from the output cotangent g and the forward's saved residuals x1, z1,
// ao (and the dropout masks m1, m2), on (M, .) rows:
//     dmlp = g * m2                                           stage dz1
//     dz1  = (dmlp . w2^T) * gelu'(z1),  h1 = gelu(z1)        stage dz1
//     dy2  = dz1 . w1^T                                       stage dx1
//     dx1  = g + LN2^T(dy2),  da = dx1 * m1,  y2 = LN2(x1)    stage dx1
//     dao  = da . wout^T,  delta = rowsum(dao * ao) per head  stage dao
// The wrapper (ops/fused_block.megablock_bwd_mlp) composes the three entries
// below; dmlp (with dropout), dz1 and da pass between them in bf16 and are
// also outputs.  dao goes out in the (B, H, N, Dh) layout the flash backward
// kernels read, with delta, their `_delta` (attention.py:640, _bwd_kernel
// :602); h1, y2 and da are the weight-gradient kernel's operands
// (wgrad_gemm.cu), dx1 (f32) megablock_bwd_ln1.cu's input, and the per-64-row
// tile column partials of dln2.scale = sum dy2 * yhat2 and dln2.bias = sum
// dy2 go to sum_partials.  No atomics: every sum is taken in a fixed order,
// so two calls give the same bits.
//
// Design: ln_mlp_fwd.cu's core.  Persistent grids of 384 threads, one block
// an SM: warpgroup 0 the producer (thread 0 streams the weight through an
// mbarrier ring by TMA, thread 32 the per-tile activations), warpgroups 1 and
// 2 the consumers, wgmma from shared memory with the 128-byte swizzle.  The
// three weights are read K-major (the summed E or hidden contiguous: wgmma's
// transpose bit 0), where the forward read its weights N-major.
//   megablock_bwd_mlp_rows_kernel<kDz1> (128-row units, BN 128, a 4-stage
//       ring of w2 boxes): a block takes a unit's g rows whole (E <= 384:
//       six boxes, 96 KB) by TMA; each consumer warpgroup multiplies its 64
//       rows by m2 in place (f32 masks loaded eight chunks ahead) and stores
//       them as dmlp by TMA, then walks the hidden width in 128-column tiles
//       against them.  z1's boxes of the tile land by TMA under the products;
//       the epilogue forms Phi(z) once (one erff and one expf an element) for
//       dz1 = acc * (Phi + z phi) in place of z1 and h1 = z Phi in a staged
//       box (one a box, so no box waits for the last one's store), both
//       stored by TMA.
//   megablock_bwd_mlp_dx1_kernel: ln_bwd_tile.cuh's body (shared with
//       megablock_bwd_ln1.cu) with the dx1 epilogue.  64-row tiles, a
//       2-stage ring of a dz1 box and w1's 384 rows, each stage released as
//       soon as its products are done; the two consumer warpgroups split E's
//       columns (m64n192, 96 accumulators a thread) over the whole tile.  x1's
//       and g's tiles land by TMA under the products; the warpgroups take
//       x1's f32 row statistics (over the real E, eight lanes a row as the
//       forward's fc1 stage, so the same bits) 32 rows each, then each row's
//       two LayerNorm sums (sum t, sum t yhat) are reduced in the quad and
//       exchanged through shared memory on a named barrier, always added
//       warpgroup 0 first.  dx1 is stored directly in f32 (a quad writes a
//       whole 32-byte sector) with m1 loaded a group of 32 columns ahead of
//       its stores (the first group under the statistics), da replaces g and
//       y2 replaces x1 in their landed tiles for TMA stores; the dln2 column
//       partials are summed over the warp's 16 rows by a reduce-scatter of
//       shuffles and over the four warps in order.
//   megablock_bwd_mlp_rows_kernel<kDao> (128-row units, BN 128): the kDz1
//       skeleton with da resident and wout streamed.  ao's boxes land by
//       TMA; each thread sums dao * ao (f32 dao, as the TPU kernel) over its
//       columns of a head in order, the quad adds its four sums at the head's
//       last column and stores delta.  dao is staged in bf16 and copied out
//       16 bytes (8 columns of one head) a thread into (B, H, N, Dh), rows
//       that straddle a batch included.
// The wide variants (E > 384, which the resident A and the dx1 stage's two
// 192-column warpgroups cannot hold, or forced by the wrapper): the rows
// kernel with kStream true streams A (dmlp, da) beside the weight, one
// 64-deep box of the unit's 128 rows a stage, for every tile, with the same
// epilogues; dmlp = g * m2 is formed first by ln_rows.cuh's mask_rows_kernel
// (the same rounding).  The dx1 stage splits in two: the rows kernel <kDy>
// writes dy2 = dz1 . w1^T in f32 straight from its accumulators, then
// ln_rows.cuh's ln_bwd_rows_kernel<kDx1> recomputes x1's statistics (eight
// lanes a row, the forward's order), forms sum t and sum t yhat, writes dx1,
// da and y2, and each 64-row tile's dln2 partials as a row, in one order, no
// atomics.  The LN1 half (megablock_bwd_ln1.cu) takes the same split.
// TMA zero-fills rows past M and columns past K or N (zeros into the
// products); its stores clip rows past M and columns past the width.
//
// What held the former mma.sync kernel back (PERF.md): 8 warps on
// 64-row blocks with every 64-wide hidden chunk behind two block barriers;
// each of the 512 blocks re-reading all three weights (2.65 MB) through
// cp.async with no loads in flight across chunks; a row phase of one warp a
// row with scalar loads; dao staged in f32 and written 2 bytes at a time,
// one head of one row at a time.  It ran at 7.4x its bound at G.  The chain
// costs dz1's, g's and da's second reads (about 151 MB at G).
//
// Bound on this card.  At G's shape (32,768 rows, E 384, hidden 1,536, H*Dh
// 384) a call does 4 M E hidden + 2 M E HD = 8.7e10 flops (0.088 ms) and
// must move g, x1, z1, ao, the two f32 masks and the weights in and dmlp,
// dz1, h1, y2, dx1, da, dao, delta out: 633 MB, 0.189 ms, so HBM bounds it;
// with the chain's second reads 0.234 ms.  At D's 65,600 rows: 1.27 GB,
// 0.378 ms.  E, hidden and Dh multiples of 8 (TMA's 16-byte strides, the
// dao stores; ln_qkv_fwd.cu takes the same Dh); E <= 384 for the resident A of
// kDz1 and kDao and the 384 columns of kDx1, any E for the wide variants.  At
// DeiT-B's G (16,384 rows, E 768, hidden 3,072) the wide half (five launches)
// ran 0.82 ms against its 0.19 ms bound by bytes, torch.matmul of its three
// products 0.25 (H100 80GB HBM3 at 700 W, chip_smoke.py [wide kernels];
// PERF.md has each launch).
//
// Where the time goes (PERF.md): the three mainloops run near the loads'
// pace; the epilogues, GELU's erf, the LayerNorm backward's passes and the
// stores, run between the products, not under them.
//
// ptxas -v (sm_90a, CUDA 12.9): each kernel launches at 168 registers a
// thread (the producer warpgroup drops to 40, the consumers take 232 by
// setmaxnreg), no spills, no performance warning (C7xxx); dynamic shared
// memory 230,496 bytes (rows kernels) and 230,960 (dx1): one block an SM;
// the streamed rows kernels 168 registers, 197,728 bytes.
#include "hopper.cuh"
#include "ln_bwd_tile.cuh"
#include "ln_rows.cuh"

using namespace vk;
using namespace vk::hopper;

namespace {

constexpr int THREADS = 384;      // producer warpgroup + two consumers
constexpr int OBOX = 64 * 64 * 2; // 64 rows of one 64-column bf16 box, bytes
constexpr int MAXKB = 6;          // 64-column boxes of E: E <= 384

// --- the resident-A stages: dz1 (h1, dmlp) and dao (delta) ---------------------

// kDy (streamed only): dy (m, n) f32 = a . w^T straight from the
// accumulators, the product of the wide dx1 stage and LN1 half.
enum { kDz1 = 0, kDao = 1, kDy = 2 };

namespace rs {
constexpr int BM = 128;                   // rows a unit
constexpr int ABOX = 64 * BM * 2;         // one 64-column box of the unit's rows
constexpr int BN = 128;                   // output columns a tile
constexpr int NB = BN / 64;               // 64-column boxes a tile
constexpr int STAGES = 4;
constexpr int WSTAGE = BN * 128;          // 64 deep x BN rows of a K-major weight
// resident A: a ring of weight boxes; streamed A (the wide variants): a ring
// of one A box (64 deep, the unit's 128 rows) and the weight box
template <bool kStream>
constexpr int STAGE = (kStream ? ABOX : 0) + WSTAGE;
template <bool kStream>
constexpr int SMEM = 1024 + (kStream ? 0 : MAXKB * ABOX) + STAGES * STAGE<kStream> +
                     2 * 2 * NB * OBOX + (2 * STAGES + 4) * 8;
}  // namespace rs

struct RowsParams {
  int m, k, n;          // rows, the summed width (E, or kDy's hidden or 3 H Dh), the output width
  const float* mask;    // kDz1 resident: m2 (m, k) f32, or null (no dropout)
  bf16* dao;            // kDao: (B, H, N, Dh)
  float* delta;         // kDao: (B, H, N)
  int ntok, heads, dh;  // kDao
  float* dy;            // kDy: (m, n) f32
};

// Rows rw0 .. rw0 + 63 of the resident tile (rows r0 .. of the matrix) times
// the f32 mask, in place: the warpgroup's threads take 16-byte chunks (8
// columns) in turn, the masks of eight chunks loaded before any is used.
__device__ inline void mask_rows(unsigned char* as, int rw0, int r0, int m, int k,
                                 const float* __restrict__ mask) {
  const int ct = threadIdx.x & 127, nch = k >> 3, items = 64 * nch;
  for (int base = 0; base < items; base += 8 * 128) {
    float4 mk[8][2];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int idx = base + 128 * q + ct, rr = idx / nch, c = idx - rr * nch;
      mk[q][0] = mk[q][1] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (idx < items && r0 + rr < m) {
        const float4* src = reinterpret_cast<const float4*>(mask + (long)(r0 + rr) * k + 8 * c);
        mk[q][0] = __ldg(src);
        mk[q][1] = __ldg(src + 1);
      }
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int idx = base + 128 * q + ct, rr = idx / nch, c = idx - rr * nch;
      if (idx >= items) continue;
      const int r = rw0 + rr;
      uint4* p = reinterpret_cast<uint4*>(as + (c >> 3) * rs::ABOX + r * 128 +
                                          (((c & 7) ^ (r & 7)) << 4));
      const uint4 v = *p;
      const float f[8] = {mk[q][0].x, mk[q][0].y, mk[q][0].z, mk[q][0].w,
                          mk[q][1].x, mk[q][1].y, mk[q][1].z, mk[q][1].w};
      const uint32_t in[4] = {v.x, v.y, v.z, v.w};
      uint32_t out[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&in[i]));
        out[i] = pack_bf16(x.x * f[2 * i], x.y * f[2 * i + 1]);
      }
      *p = make_uint4(out[0], out[1], out[2], out[3]);
    }
  }
}

// kStream false: a block takes a 128-row unit of A (g, or da) whole; the
// consumer warpgroups (64 rows each) walk every 128-column tile of the
// output width against it while the weight (w2, or wout: (n, k) row-major,
// K-major) streams through the ring.  kStream true (E > 384, and kDy): A
// (dmlp, da, or kDy's dz1 or dqkv) streams beside the weight, one 64-deep box
// of the unit's rows a stage, for every tile; kDz1's dmlp is formed before
// (ln_rows.cuh mask_rows).  tx: the per-tile operand of the epilogue (z1, or
// ao), landed 64 rows x 64 columns a box; to1 / to2: dz1 / h1 stores; td:
// dmlp's store (kDz1 resident, with a mask).
template <int KIND, bool kStream>
__global__ void __launch_bounds__(THREADS, 1)
megablock_bwd_mlp_rows_kernel(const __grid_constant__ CUtensorMap ta,
                              const __grid_constant__ CUtensorMap tb,
                              const __grid_constant__ CUtensorMap tx,
                              const __grid_constant__ CUtensorMap to1,
                              const __grid_constant__ CUtensorMap to2,
                              const __grid_constant__ CUtensorMap td, const RowsParams p) {
  using namespace rs;
  static_assert(KIND != kDy || kStream, "kDy streams its A");
  constexpr int ST = STAGE<kStream>;
  constexpr int BOFS = kStream ? ABOX : 0;              // a stage's weight box after its A box
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* as = smem;                             // box kb of A at kb ABOX (resident)
  unsigned char* stages = as + (kStream ? 0 : MAXKB * ABOX);  // stage s at s ST
  unsigned char* aux = stages + STAGES * ST;            // (warpgroup w, box b) at (w NB + b) OBOX
  unsigned char* staging = aux + 2 * NB * OBOX;         // (warpgroup w, box b) at (w NB + b) OBOX
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 2 * NB * OBOX);
  uint64_t* empty = full + STAGES;
  uint64_t* afull = empty + STAGES;                     // A landed / A free again
  uint64_t* aempty = afull + 1;
  uint64_t* xfull = aempty + 1;                         // warpgroup w's tx boxes landed

  const int wgi = threadIdx.x >> 7;
  const int nkb = (p.k + 63) / 64;
  const int ntiles = (p.n + BN - 1) / BN, units = (p.m + BM - 1) / BM;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_init(afull, 1);
    mbar_init(aempty, 2);
    mbar_init(&xfull[0], 1);
    mbar_init(&xfull[1], 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wgi == 0) {
    reg_dealloc<40>();
    if (threadIdx.x == 0) {  // the weight [and A], 64 deep a stage, every tile of every unit
      int it = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x)
        for (int nt = 0; nt < ntiles; ++nt)
          for (int kb = 0; kb < nkb; ++kb, ++it) {
            const int s = it % STAGES;
            if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
            unsigned char* st = stages + s * ST;
            mbar_arrive_tx(&full[s], ST);
            if (kStream) tma_load_2d(st, &ta, &full[s], kb * 64, u * BM);
            tma_load_2d(st + BOFS, &tb, &full[s], kb * 64, nt * BN);
          }
    } else if (!kStream && threadIdx.x == 32) {  // A, one 128-row unit at a time
      int i = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x, ++i) {
        if (i > 0) mbar_wait(aempty, (i - 1) & 1);
        mbar_arrive_tx(afull, nkb * ABOX);
        for (int kb = 0; kb < nkb; ++kb) tma_load_2d(as + kb * ABOX, &ta, afull, kb * 64, u * BM);
      }
    }
    return;
  }

  // consumers: warpgroup w owns rows 64 w .. 64 w + 63 of each unit
  reg_alloc<232>();
  const int w = wgi - 1, ct = threadIdx.x & 127, lane = threadIdx.x & 31, wr = ct >> 5,
            g = lane >> 2, t = lane & 3;
  unsigned char* xb = aux + w * NB * OBOX;
  unsigned char* sbw = staging + w * NB * OBOX;
  float acc[BN / 2];
  float run[2] = {0.f, 0.f};  // kDao: this thread's sums of the current head, rows h = 0, 1
  int it = 0, i = 0, xloads = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++i) {
    const int r0 = u * BM + 64 * w;
    const bool live = r0 < p.m;  // the same for the whole warpgroup
    if (!kStream) mbar_wait(afull, i & 1);
    if constexpr (KIND == kDz1 && !kStream) {
      if (p.mask != nullptr && live) {  // dmlp = g * m2, in place, then stored
        mask_rows(as, 64 * w, r0, p.m, p.k, p.mask);
        fence_proxy_async();  // the masked rows, to wgmma and the TMA unit
        named_bar_sync(1 + w, 128);
        if (ct == 0) {
          for (int kb = 0; kb < nkb; ++kb) tma_store_2d(&td, as + kb * ABOX + w * (64 * 128),
                                                        kb * 64, r0);
          bulk_commit();
        }
      }
    }
    for (int nt = 0; nt < ntiles; ++nt) {
      const int n0 = nt * BN, nbox = min(NB, (p.n - n0 + 63) / 64);
      // this warpgroup's tx boxes land under the products (the last tile's
      // stores from them and from the staged boxes have read them, which
      // xfull's wait passes on to the other threads; its reads precede a
      // proxy fence and a barrier)
      if (KIND != kDy && live && ct == 0) {
        bulk_wait_read<0>();
        mbar_arrive_tx(&xfull[w], nbox * OBOX);
        for (int b = 0; b < nbox; ++b) tma_load_2d(xb + b * OBOX, &tx, &xfull[w], n0 + 64 * b, r0);
      }
      for (int kb = 0; kb < nkb; ++kb, ++it) {
        const int s = it % STAGES;
        mbar_wait(&full[s], (it / STAGES) & 1);
        const unsigned char* st = stages + s * ST;
        const unsigned char* a = (kStream ? st : as + kb * ABOX) + w * (64 * 128);
        const unsigned char* b = st + BOFS;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<BN, 0, 0>(acc, desc_sw128(a + kk * 32, 16, 1024),
                             desc_sw128(b + kk * 32, 16, 1024), kb > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done: release it
        if (kb > 0 && ct == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (ct == 0) {
        mbar_arrive(&empty[(it - 1) % STAGES]);
        // every product of this unit has read the resident A, and dmlp's store
        if (!kStream && nt == ntiles - 1) {
          bulk_wait_read<0>();
          mbar_arrive(aempty);
        }
      }
      if (!live) continue;
      if constexpr (KIND == kDy) {
        // dy in f32 straight from the accumulators: a quad writes a whole
        // 32-byte sector of a row
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = n0 + 8 * j + 2 * t;  // n is a multiple of 8: col + 1 < n too
          if (col >= p.n) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = r0 + 16 * wr + g + 8 * h;
            if (row < p.m)
              *reinterpret_cast<float2*>(p.dy + (long)row * p.n + col) =
                  make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          }
        }
        continue;
      }
      mbar_wait(&xfull[w], xloads++ & 1);

      // epilogue, one 64-column box at a time.  This thread holds rows
      // 16 wr + g + 8 h of the warpgroup's 64, columns 8 j + 2 t + (0, 1) of
      // the tile; the landed box has the output box's layout.
#pragma unroll
      for (int jb = 0; jb < NB; ++jb) {
        const int c0 = n0 + 64 * jb;
        if (c0 >= p.n) continue;  // the same for the whole warpgroup
        unsigned char* xbox = xb + jb * OBOX;
        unsigned char* sb = sbw + jb * OBOX;
        named_bar_sync(1 + w, 128);  // every thread has read the last tile's staged box
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = 8 * jb + jj, gc = c0 + 8 * jj;
          float pr[2][2] = {};
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int rr = 16 * wr + g + 8 * h;
            uint32_t* xp = reinterpret_cast<uint32_t*>(xbox + swz(rr, jj, t));
            const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xp));
            const float d0 = acc[4 * j + 2 * h], d1 = acc[4 * j + 2 * h + 1];
            if constexpr (KIND == kDz1) {
              // Phi(z) once: gelu(z) = z Phi, gelu'(z) = Phi + z phi (exact erf)
              const float cdf0 = 0.5f * (1.f + erff(x.x * 0.70710678118654752f));
              const float cdf1 = 0.5f * (1.f + erff(x.y * 0.70710678118654752f));
              const float pdf0 = 0.39894228040143268f * __expf(-0.5f * x.x * x.x);
              const float pdf1 = 0.39894228040143268f * __expf(-0.5f * x.y * x.y);
              *xp = pack_bf16(d0 * (cdf0 + x.x * pdf0), d1 * (cdf1 + x.y * pdf1));  // dz1, in place
              *reinterpret_cast<uint32_t*>(sb + swz(rr, jj, t)) =
                  pack_bf16(x.x * cdf0, x.y * cdf1);  // h1
            } else {
              pr[h][0] = d0 * x.x;
              pr[h][1] = d1 * x.y;
              *reinterpret_cast<uint32_t*>(sb + swz(rr, jj, t)) = pack_bf16(d0, d1);
            }
          }
          if (KIND == kDao && gc < p.n) {  // the same for the whole warp
            // delta: each thread sums its columns of the head in order, the
            // quad adds its four sums at the head's last 8-column group (Dh
            // a multiple of 8: a group lies in one head)
#pragma unroll
            for (int h = 0; h < 2; ++h) run[h] += pr[h][0] + pr[h][1];
            const int hh = gc / p.dh;
            if ((hh + 1) * p.dh == gc + 8) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                float s = run[h];
                s += __shfl_xor_sync(0xffffffffu, s, 1);
                s += __shfl_xor_sync(0xffffffffu, s, 2);
                const int row = r0 + 16 * wr + g + 8 * h;
                if (t == 0 && row < p.m) {
                  const int bi = row / p.ntok, tok = row - bi * p.ntok;
                  p.delta[((long)bi * p.heads + hh) * p.ntok + tok] = s;
                }
                run[h] = 0.f;
              }
            }
          }
        }
        fence_proxy_async();  // the staged box (and dz1), to the TMA unit
        named_bar_sync(1 + w, 128);
        if constexpr (KIND == kDz1) {
          if (ct == 0) {
            tma_store_2d(&to1, xbox, c0, r0);
            tma_store_2d(&to2, sb, c0, r0);
            bulk_commit();
          }
        } else {
          // dao to (B, H, N, Dh): 16 bytes (8 columns of one row) a thread
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int idx = 128 * q + ct, rr = idx >> 3, cc = idx & 7;
            const int row = r0 + rr, col = c0 + 8 * cc;
            if (row >= p.m || col >= p.n) continue;
            const uint4 v = *reinterpret_cast<const uint4*>(sb + rr * 128 +
                                                            ((cc ^ (rr & 7)) << 4));
            const int bi = row / p.ntok, tok = row - bi * p.ntok, hh = col / p.dh;
            *reinterpret_cast<uint4*>(p.dao + (((long)bi * p.heads + hh) * p.ntok + tok) * p.dh +
                                      col - hh * p.dh) = v;
          }
        }
      }
    }
  }
  if (ct == 0) bulk_wait<0>();
}

// --- dy2 = dz1 . w1^T and the LayerNorm backward: dx1, da, y2, dln2 partials ----

// ln_bwd_tile.cuh's body with the dx1 epilogue: tx / tg x1's and g's tiles
// landed, ty / tda y2's and da's stores.
__global__ void __launch_bounds__(lnbwd::THREADS, 1)
megablock_bwd_mlp_dx1_kernel(const __grid_constant__ CUtensorMap ta,
                             const __grid_constant__ CUtensorMap tb,
                             const __grid_constant__ CUtensorMap tx,
                             const __grid_constant__ CUtensorMap tg,
                             const __grid_constant__ CUtensorMap ty,
                             const __grid_constant__ CUtensorMap tda, const lnbwd::Params p) {
  lnbwd::tiles<lnbwd::kDx1>(ta, tb, tx, tg, ty, tda, p);
}

template <int KIND, bool kStream>
int launch_rows(const CUtensorMap& ta, const CUtensorMap& tb, const CUtensorMap& tx,
                const CUtensorMap& to1, const CUtensorMap& to2, const CUtensorMap& td,
                const RowsParams& p, void* stream) {
  const int units = (p.m + rs::BM - 1) / rs::BM, grid = units < sm_count() ? units : sm_count();
  cudaFuncSetAttribute(megablock_bwd_mlp_rows_kernel<KIND, kStream>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, rs::SMEM<kStream>);
  megablock_bwd_mlp_rows_kernel<KIND, kStream><<<grid, THREADS, rs::SMEM<kStream>,
                                                 static_cast<cudaStream_t>(stream)>>>(
      ta, tb, tx, to1, to2, td, p);
  return (int)cudaGetLastError();
}

// The dao stage, da resident (E <= 384) or streamed (`wide`).
int dao_stage(const void* da, const void* ao, const void* wout, void* dao, void* delta, int batch,
              int n, int e, int heads, int dh, bool wide, void* stream) {
  const int m = batch * n, hd = heads * dh;
  if (batch < 0 || n < 1 || dh < 8 || dh % 8 || heads < 1 || e < 8 || e % 8)
    return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  CUtensorMap ta, tb, tx;
  int err = tmap_2d(&ta, da, m, e, rs::BM);
  if (!err) err = tmap_2d(&tb, wout, hd, e, rs::BN);
  if (!err) err = tmap_2d(&tx, ao, m, hd, 64);
  if (err) return err;
  RowsParams p{};
  p.m = m, p.k = e, p.n = hd;
  p.dao = static_cast<bf16*>(dao);
  p.delta = static_cast<float*>(delta);
  p.ntok = n, p.heads = heads, p.dh = dh;
  return wide ? launch_rows<kDao, true>(ta, tb, tx, tx, tx, tx, p, stream)
              : launch_rows<kDao, false>(ta, tb, tx, tx, tx, tx, p, stream);
}

}  // namespace

// dz1 (m, hidden) bf16 = (dmlp . w2^T) * gelu'(z1), h1 (m, hidden) bf16 =
// gelu(z1), with dmlp = g * m2 written to dmlp (m, e) bf16 when m2 != NULL
// (else dmlp is g).  g: (m, e) bf16; z1: (m, hidden) bf16; w2: (hidden, e)
// bf16; m2: (m, e) f32 or NULL.  Bases 16-byte aligned; e, hidden multiples
// of 8; e <= 384.
extern "C" int megablock_bwd_mlp_dz1(const void* g, const void* m2, const void* z1,
                                     const void* w2, void* dmlp, void* dz1, void* h1, int m, int e,
                                     int hidden, void* stream) {
  if (m < 0 || e < 8 || e > 64 * MAXKB || e % 8 || hidden < 8 || hidden % 8 ||
      (m2 != nullptr && dmlp == nullptr))
    return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  CUtensorMap ta, tb, tx, to1, to2, td;
  int err = tmap_2d(&ta, g, m, e, rs::BM);
  if (!err) err = tmap_2d(&tb, w2, hidden, e, rs::BN);
  if (!err) err = tmap_2d(&tx, z1, m, hidden, 64);
  if (!err) err = tmap_2d(&to1, dz1, m, hidden, 64);
  if (!err) err = tmap_2d(&to2, h1, m, hidden, 64);
  if (!err) err = tmap_2d(&td, m2 != nullptr ? dmlp : g, m, e, 64);
  if (err) return err;
  RowsParams p{};
  p.m = m, p.k = e, p.n = hidden;
  p.mask = static_cast<const float*>(m2);
  return launch_rows<kDz1, false>(ta, tb, tx, to1, to2, td, p, stream);
}

// The wide dz1 stage (any E a multiple of 8): dz1 and h1 as
// megablock_bwd_mlp_dz1's from dmlp (m, e) bf16 (g * m2 from
// megablock_bwd_mask_rows, or g itself without dropout), streamed.
extern "C" int megablock_bwd_mlp_dz1_wide(const void* dmlp, const void* z1, const void* w2,
                                          void* dz1, void* h1, int m, int e, int hidden,
                                          void* stream) {
  if (m < 0 || e < 8 || e % 8 || hidden < 8 || hidden % 8) return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  CUtensorMap ta, tb, tx, to1, to2;
  int err = tmap_2d(&ta, dmlp, m, e, rs::BM);
  if (!err) err = tmap_2d(&tb, w2, hidden, e, rs::BN);
  if (!err) err = tmap_2d(&tx, z1, m, hidden, 64);
  if (!err) err = tmap_2d(&to1, dz1, m, hidden, 64);
  if (!err) err = tmap_2d(&to2, h1, m, hidden, 64);
  if (err) return err;
  RowsParams p{};
  p.m = m, p.k = e, p.n = hidden;
  return launch_rows<kDz1, true>(ta, tb, tx, to1, to2, tx, p, stream);
}

// dmlp (m, e) bf16 = g * m2, each product rounded to bf16 once (the resident
// dz1 stage's arithmetic).  g: (m, e) bf16; m2: (m, e) f32; e a multiple of 8.
extern "C" int megablock_bwd_mask_rows(const void* g, const void* m2, void* dmlp, int m, int e,
                                       void* stream) {
  return lnrows::mask_rows(g, m2, dmlp, m, e, stream);
}

// dy (m, n) f32 = a . w^T: a (m, k) bf16, w (n, k) bf16 (K-major), k and n
// multiples of 8.  The wide dx1 stage's dy2 = dz1 . w1^T and the wide LN1
// half's dy1 = dqkv . wqkv^T.
extern "C" int megablock_bwd_dy(const void* a, const void* w, void* dy, int m, int k, int n,
                                void* stream) {
  if (m < 0 || k < 8 || k % 8 || n < 8 || n % 8) return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  CUtensorMap ta, tb;
  int err = tmap_2d(&ta, a, m, k, rs::BM);
  if (!err) err = tmap_2d(&tb, w, n, k, rs::BN);
  if (err) return err;
  RowsParams p{};
  p.m = m, p.k = k, p.n = n;
  p.dy = static_cast<float*>(dy);
  return launch_rows<kDy, true>(ta, tb, ta, ta, ta, ta, p, stream);
}

// The wide dx1 stage's LayerNorm backward (any E a multiple of 8), after
// dy2 = megablock_bwd_dy(dz1, w1): dx1, da, y2 and part as
// megablock_bwd_mlp_dx1's.  dy2: (m, e) f32; g, x1: (m, e) bf16; m1: (m, e)
// f32 or NULL.
extern "C" int megablock_bwd_mlp_dx1_rows(const void* dy2, const void* g, const void* m1,
                                          const void* x1, const void* ln_s, const void* ln_b,
                                          void* dx1, void* da, void* y2, void* part, int m,
                                          int e, float eps, void* stream) {
  lnrows::BwdParams p{};
  p.m = m, p.e = e;
  p.dy = static_cast<const float*>(dy2);
  p.x = static_cast<const bf16*>(x1);
  p.g = static_cast<const bf16*>(g);
  p.m1 = static_cast<const float*>(m1);
  p.ln_s = static_cast<const float*>(ln_s);
  p.ln_b = static_cast<const float*>(ln_b);
  p.eps = eps;
  p.dx1 = static_cast<float*>(dx1);
  p.out = static_cast<bf16*>(da);
  p.y = static_cast<bf16*>(y2);
  p.part = static_cast<float*>(part);
  return lnrows::ln_bwd_rows<lnrows::kDx1>(p, stream);
}

// dy2 = dz1 . w1^T; dx1 (m, e) f32 = g + LN2^T(dy2) with LN2's statistics from
// x1; da (m, e) bf16 = dx1 * m1 (dx1 when m1 is NULL); y2 (m, e) bf16 =
// LN2(x1); part (ceil(m / 64), 2 e) f32: each 64-row tile's column sums of
// dy2 * yhat2, then of dy2.  dz1: (m, hidden) bf16; g, x1: (m, e) bf16; w1:
// (e, hidden) bf16; m1: (m, e) f32 or NULL; ln_s, ln_b: (e,) f32.  Bases
// 16-byte aligned; e, hidden multiples of 8; e <= 384.
extern "C" int megablock_bwd_mlp_dx1(const void* dz1, const void* g, const void* m1,
                                     const void* x1, const void* w1, const void* ln_s,
                                     const void* ln_b, void* dx1, void* da, void* y2, void* part,
                                     int m, int e, int hidden, float eps, void* stream) {
  if (m < 0 || e < 8 || e > 2 * lnbwd::BNW || e % 8 || hidden < 8 || hidden % 8)
    return (int)cudaErrorInvalidValue;
  lnbwd::Params p{};
  p.m = m, p.e = e, p.k = hidden;
  p.ahead = static_cast<const float*>(m1);
  p.ln_s = static_cast<const float*>(ln_s);
  p.ln_b = static_cast<const float*>(ln_b);
  p.eps = eps;
  p.dx1 = static_cast<float*>(dx1);
  p.part = static_cast<float*>(part);
  return lnbwd::launch(megablock_bwd_mlp_dx1_kernel, dz1, w1, x1, g, y2, da, p, stream);
}

// dao (batch, heads, n, dh) bf16 = da . wout^T and delta (batch, heads, n)
// f32 = the sum over each head's dh columns of dao * ao (dao in f32).  da:
// (batch n, e) bf16; ao: (batch n, heads dh) bf16; wout: (heads dh, e) bf16.
// Bases 16-byte aligned; e, dh multiples of 8; e <= 384.
extern "C" int megablock_bwd_mlp_dao(const void* da, const void* ao, const void* wout, void* dao,
                                     void* delta, int batch, int n, int e, int heads, int dh,
                                     void* stream) {
  if (e > 64 * MAXKB) return (int)cudaErrorInvalidValue;
  return dao_stage(da, ao, wout, dao, delta, batch, n, e, heads, dh, false, stream);
}

// The wide dao stage (any E a multiple of 8): as megablock_bwd_mlp_dao, with
// da streamed.  The resident and the streamed forms are one function here
// (dao_stage), as they share every check.
extern "C" int megablock_bwd_mlp_dao_wide(const void* da, const void* ao, const void* wout,
                                          void* dao, void* delta, int batch, int n, int e,
                                          int heads, int dh, void* stream) {
  return dao_stage(da, ao, wout, dao, delta, batch, n, e, heads, dh, true, stream);
}
