// The LayerNorm backward after a product, on 64-row tiles, for Hopper
// (sm_90a): the body of megablock_bwd_mlp.cu's dx1 stage and of
// megablock_bwd_ln1.cu, one kernel templated on its epilogue.  On (M, .) rows:
//     dy  = a . w^T                 (a: dz1 or dqkv (M, K) bf16; w (E, K) bf16)
//     kDx1: dx1 = g + LN^T(dy)  f32 out,  da = dx1 * m1,  y = LN(x)
//     kLn1: dx  = dx1 + LN^T(dy)  bf16 out,               y = LN(x)
// with LN's statistics recomputed from x (bf16), and each 64-row tile's
// column sums of dy * yhat and of dy (the LN scale's and bias's partials, a
// row of part (ceil(M / 64), 2 E) f32 each, for sum_partials).  No atomics:
// every sum is taken in one order, so two calls give the same bits.
//
// A persistent grid of 384-thread blocks, one an SM: warpgroup 0 the
// producer (thread 0 streams a's 64-deep box and w's E rows (K-major,
// wgmma's transpose bit 0) through a 2-stage mbarrier ring by TMA, thread 32
// lands each tile's x (and kDx1's g) under the products), warpgroups 1 and 2
// the consumers, splitting E's columns (m64n192, 96 accumulators a thread)
// over the whole 64-row tile; each stage is released as soon as its products
// are done, so the next load runs beside the wait for the one in flight.
// E <= 192: warpgroup 1 multiplies TMA's zeros (a wgmma in a branch would be
// serialised).  Then the warpgroups take x's f32 row statistics (over the
// real E, eight lanes a row as the forward's ln_resident, so the same bits)
// 32 rows each, and each row's two LayerNorm sums (sum t, sum t yhat, t = dy
// gamma) are reduced in the quad and exchanged through shared memory on a
// named barrier, always added warpgroup 0 first.  The epilogue reads the f32
// operand of each element (m1 for kDx1, the residual dx1 for kLn1) straight
// from device memory (shared memory holds the ring), 32 columns a group, the
// first group under the statistics and each next one a group ahead of its
// stores; kDx1 stores
// dx1 directly in f32 (a quad writes a whole 32-byte sector); the bf16
// output (da, or dx) replaces g's tile (kLn1: a staging tile of its shape)
// and y replaces x's, both TMA-stored.  The column partials are summed over
// the warp's 16 rows by a reduce-scatter of shuffles (7 for 8 sums) and
// over the four warps in order.  TMA
// zero-fills rows past M and columns past K or E (zeros into the products);
// its stores clip rows past M and columns past E.
//
// E > 384 does not fit two 192-column warpgroups: the wide variants write
// dy in f32 and run ln_rows.cuh's row kernel with the same epilogues.
//
// Shared memory: the ring 2 x (8 KB + 48 KB), x's tile and g's (or dx's
// staging) 48 KB each, statistics, exchange and partials: 230,960 bytes, one
// block an SM.
#pragma once

#include "hopper.cuh"

namespace vk {
namespace lnbwd {

using namespace vk::hopper;

constexpr int THREADS = 384;              // producer warpgroup + two consumers
constexpr int OBOX = 64 * 64 * 2;         // 64 rows of one 64-column bf16 box, bytes
constexpr int MAXKB = 6;                  // 64-column boxes of E: E <= 384
constexpr int BM = 64;                    // rows a tile
constexpr int BNW = 192;                  // columns a consumer warpgroup
constexpr int ABOX = 64 * BM * 2;         // one 64-deep box of the tile's a rows
constexpr int WBOX = BNW * 128;           // one 64-deep box of 192 rows of w
constexpr int STAGES = 2;
constexpr int STAGE = ABOX + 2 * WBOX;
constexpr int SMEM = 1024 + STAGES * STAGE + 2 * MAXKB * OBOX + BM * 8 + 2 * BM * 8 +
                     2 * 4 * 2 * BNW * 4 + 2 * 2 * BNW * 4 + (2 * STAGES + 2) * 8;

enum { kDx1 = 0, kLn1 = 1 };

struct Params {
  int m, e, k;           // rows, E, the summed width (hidden, or 3 H Dh)
  const float* ahead;    // (m, e) f32 read ahead of the stores: kDx1 m1 (or null), kLn1 dx1
  const float* ln_s;
  const float* ln_b;
  float eps;
  float* dx1;            // kDx1: (m, e) f32 out
  float* part;           // (tiles, 2 e) f32
};

// A 64-row tile a step: dy over the whole summed width, warpgroup w holding
// columns 192 w .. 192 w + 191.  ta / tb: a's and w's loads; tx / tg: x's and
// (kDx1) g's tiles landed; ty / to: y's and the bf16 output's stores, from
// the same shared memory.
template <int KIND>
__device__ __forceinline__ void tiles(const CUtensorMap& ta, const CUtensorMap& tb,
                                      const CUtensorMap& tx, const CUtensorMap& tg,
                                      const CUtensorMap& ty, const CUtensorMap& to,
                                      const Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* stages = smem;                        // stage s at s STAGE
  unsigned char* xs = stages + STAGES * STAGE;         // x's box kb at kb OBOX, later y
  unsigned char* gs = xs + MAXKB * OBOX;               // g's box kb (kDx1), later the bf16 output
  float2* stats = reinterpret_cast<float2*>(gs + MAXKB * OBOX);  // (mean, rstd) of each row
  float2* xch = stats + BM;                            // warpgroup w's (sum t, sum t yhat) at w BM + r
  float* colp = reinterpret_cast<float*>(xch + 2 * BM);  // (w, warp, scale|bias, column)
  float* lnp = colp + 2 * 4 * 2 * BNW;                 // gamma at c, beta at 2 BNW + c
  uint64_t* full = reinterpret_cast<uint64_t*>(lnp + 2 * 2 * BNW);
  uint64_t* empty = full + STAGES;
  uint64_t* tfull = empty + STAGES;                    // x (and g) landed / free again
  uint64_t* tempty = tfull + 1;

  const int wgi = threadIdx.x >> 7;
  const int nkh = (p.k + 63) / 64, nke = (p.e + 63) / 64;
  const int units = (p.m + BM - 1) / BM;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_init(tfull, 1);
    mbar_init(tempty, 2);
    mbar_fence_init();
  }
  __syncthreads();

  if (wgi == 0) {
    reg_dealloc<40>();
    if (threadIdx.x == 0) {  // a's rows and w, 64 deep a stage
      int it = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x)
        for (int kb = 0; kb < nkh; ++kb, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
          unsigned char* st = stages + s * STAGE;
          mbar_arrive_tx(&full[s], STAGE);
          tma_load_2d(st, &ta, &full[s], kb * 64, u * BM);
          tma_load_2d(st + ABOX, &tb, &full[s], kb * 64, 0);
          tma_load_2d(st + ABOX + WBOX, &tb, &full[s], kb * 64, BNW);
        }
    } else if (threadIdx.x == 32) {  // x (and g), one tile at a time
      int i = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x, ++i) {
        if (i > 0) mbar_wait(tempty, (i - 1) & 1);
        mbar_arrive_tx(tfull, (KIND == kDx1 ? 2 : 1) * nke * OBOX);
        for (int kb = 0; kb < nke; ++kb) {
          tma_load_2d(xs + kb * OBOX, &tx, tfull, kb * 64, u * BM);
          if (KIND == kDx1) tma_load_2d(gs + kb * OBOX, &tg, tfull, kb * 64, u * BM);
        }
      }
    }
    return;
  }

  reg_alloc<232>();
  const int w = wgi - 1, ct = threadIdx.x & 127, lane = threadIdx.x & 31, wr = ct >> 5,
            g = lane >> 2, t = lane & 3;
  const float inv_e = 1.f / p.e;
  for (int c = 128 * w + ct; c < p.e; c += 256) {
    lnp[c] = p.ln_s[c];
    lnp[2 * BNW + c] = p.ln_b[c];
  }
  named_bar_sync(3, 256);
  float acc[BNW / 2];
  float* cpw = colp + (4 * w + wr) * 2 * BNW;  // this warp's column partials
  int it = 0, i = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++i) {
    const int m0 = u * BM;
    for (int kb = 0; kb < nkh; ++kb, ++it) {
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      const unsigned char* st = stages + s * STAGE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<BNW, 0, 0>(acc, desc_sw128(st + kk * 32, 16, 1024),
                            desc_sw128(st + ABOX + w * WBOX + kk * 32, 16, 1024),
                            kb > 0 || kk > 0);
      wgmma_commit();
      // release the stage as soon as its products are done: with two stages
      // the next load then runs beside the wait for the one in flight
      wgmma_wait<0>();
      if (ct == 0) mbar_arrive(&empty[s]);
    }
    fence_regs(acc);

    // the f32 operand of the epilogue (m1, or the residual dx1), 32 columns
    // of this thread's two rows a group: the first group loaded here, under
    // the statistics and the LayerNorm sums, each next one before the group
    // before it is used (a load from device memory returns slowly on a card
    // this busy; loads issued ahead of the stores need no ordering behind
    // them)
    float2 fa[2][4][2];
    auto ahead = [&](float2(&f)[4][2], int jq) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + 16 * wr + g + 8 * h, col = BNW * w + 32 * jq + 8 * jj + 2 * t;
          f[jj][h] = p.ahead != nullptr && row < p.m && col < p.e
                         ? *reinterpret_cast<const float2*>(p.ahead + (long)row * p.e + col)
                         : make_float2(KIND == kDx1 ? 1.f : 0.f, KIND == kDx1 ? 1.f : 0.f);
        }
    };
    ahead(fa[0], 0);
    mbar_wait(tfull, i & 1);

    // LayerNorm statistics of x's rows 32 w .. 32 w + 31, eight lanes a row
    // (hopper.cuh ln_row8, as the forward's ln_resident takes them)
#pragma unroll 1
    for (int r1 = 0; r1 < 8; r1 += 4) {
      const int r = 32 * w + 8 * wr + r1 + (lane >> 3);
      float v[6][8], mean, rstd;
      ln_row8(xs, OBOX, r * 128 + (((lane & 7) ^ (r & 7)) << 4), p.e, p.eps, v, mean, rstd);
      if ((lane & 7) == 0) stats[r] = make_float2(mean, rstd);
    }
    named_bar_sync(3, 256);

    // this thread: rows rr[h] = 16 wr + g + 8 h of the tile, columns
    // 192 w + 8 j + 2 t + (0, 1), in box 3 w + j / 8 at chunk j % 8
    float mean[2], rstd[2], st[2] = {0.f, 0.f}, sty[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 s = stats[16 * wr + g + 8 * h];
      mean[h] = s.x;
      rstd[h] = s.y;
    }
#pragma unroll
    for (int jp = 0; jp < BNW / 16; ++jp) {
      if (jp % 4 == 0) asm volatile("" ::: "memory");  // a box's loads at a time: registers
      // pv[4 jj ..]: this thread's sums over its two rows of dy yhat at
      // columns 8 j + 2 t, + 1, then of dy at both, j = 2 jp + jj
      float pv[8];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * jp + jj, col = BNW * w + 8 * j + 2 * t;
        float py0 = 0.f, py1 = 0.f, pb0 = 0.f, pb1 = 0.f;
        if (BNW * w + 8 * j < p.e) {  // the same for the whole warp
          const unsigned char* xbox = xs + (3 * w + j / 8) * OBOX;
          const float2 gm = *reinterpret_cast<const float2*>(lnp + col);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                xbox + swz(16 * wr + g + 8 * h, j % 8, t)));
            const float y0 = (x.x - mean[h]) * rstd[h], y1 = (x.y - mean[h]) * rstd[h];
            const float d0 = acc[4 * j + 2 * h], d1 = acc[4 * j + 2 * h + 1];
            const float t0 = d0 * gm.x, t1 = d1 * gm.y;
            st[h] += t0 + t1;
            sty[h] += t0 * y0 + t1 * y1;
            py0 += d0 * y0;
            py1 += d1 * y1;
            pb0 += d0;
            pb1 += d1;
          }
        }
        pv[4 * jj] = py0;
        pv[4 * jj + 1] = py1;
        pv[4 * jj + 2] = pb0;
        pv[4 * jj + 3] = pb1;
      }
      // the warp's 16 rows (lanes g = 0 .. 7) by a reduce-scatter in a fixed
      // tree: 7 shuffles for the 8 sums; after it lane g holds pv[g]'s
      float q4[4], q2[2];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const bool hi = g & 4;
        q4[k] = (hi ? pv[4 + k] : pv[k]) +
                __shfl_xor_sync(0xffffffffu, hi ? pv[k] : pv[4 + k], 16);
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const bool hi = g & 2;
        q2[k] = (hi ? q4[2 + k] : q4[k]) +
                __shfl_xor_sync(0xffffffffu, hi ? q4[k] : q4[2 + k], 8);
      }
      const bool hi = g & 1;
      const float sum = (hi ? q2[1] : q2[0]) + __shfl_xor_sync(0xffffffffu, hi ? q2[0] : q2[1], 4);
      const int j = 2 * jp + (g >> 2);
      if (BNW * w + 8 * j < p.e) cpw[(g & 2 ? BNW : 0) + 8 * j + 2 * t + (g & 1)] = sum;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      st[h] += __shfl_xor_sync(0xffffffffu, st[h], 1);
      st[h] += __shfl_xor_sync(0xffffffffu, st[h], 2);
      sty[h] += __shfl_xor_sync(0xffffffffu, sty[h], 1);
      sty[h] += __shfl_xor_sync(0xffffffffu, sty[h], 2);
      if (t == 0) xch[w * BM + 16 * wr + g + 8 * h] = make_float2(st[h], sty[h]);
    }
    named_bar_sync(3, 256);

    // dx = res + rstd (t - mean(t) - yhat mean(t yhat)), t = dy gamma
    // (_ln_bwd, fused_block.py:464-470), res = g (kDx1) or dx1 (kLn1);
    // kDx1: da = dx m1; y = yhat gamma + beta
    float mt[2], mty[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * wr + g + 8 * h;
      const float2 a = xch[r], b = xch[BM + r];
      mt[h] = (a.x + b.x) * inv_e;
      mty[h] = (a.y + b.y) * inv_e;
    }
#pragma unroll
    for (int jq = 0; jq < BNW / 32; ++jq) {
      // 32 columns at a time, the next group's f32 loads issued before this
      // group's stores
      if (jq + 1 < BNW / 32) ahead(fa[(jq + 1) & 1], jq + 1);
      const float2(&fq)[4][2] = fa[jq & 1];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * jq + jj, jb = j / 8, col = BNW * w + 8 * j + 2 * t;
        if (BNW * w + 8 * j >= p.e) continue;  // the same for the whole warp
        const float2 gm = *reinterpret_cast<const float2*>(lnp + col);
        const float2 bt = *reinterpret_cast<const float2*>(lnp + 2 * BNW + col);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * wr + g + 8 * h, row = m0 + r, o = (3 * w + jb) * OBOX + swz(r, j % 8, t);
          uint32_t* xp = reinterpret_cast<uint32_t*>(xs + o);
          uint32_t* gp = reinterpret_cast<uint32_t*>(gs + o);
          const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xp));
          const float2 res = KIND == kDx1
                                 ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(gp))
                                 : fq[jj][h];
          const float y0 = (x.x - mean[h]) * rstd[h], y1 = (x.y - mean[h]) * rstd[h];
          const float d0 = acc[4 * j + 2 * h] * gm.x, d1 = acc[4 * j + 2 * h + 1] * gm.y;
          const float dx0 = res.x + (d0 - mt[h] - y0 * mty[h]) * rstd[h];
          const float dx1 = res.y + (d1 - mt[h] - y1 * mty[h]) * rstd[h];
          if (KIND == kDx1) {
            if (row < p.m)
              *reinterpret_cast<float2*>(p.dx1 + (long)row * p.e + col) = make_float2(dx0, dx1);
            *gp = pack_bf16(dx0 * fq[jj][h].x, dx1 * fq[jj][h].y);  // da
          } else {
            *gp = pack_bf16(dx0, dx1);  // dx
          }
          *xp = pack_bf16(y0 * gm.x + bt.x, y1 * gm.y + bt.y);  // y
        }
      }
    }
    fence_proxy_async();  // y and the bf16 output, to the TMA unit
    named_bar_sync(1 + w, 128);
    if (ct == 0) {
      for (int b = 0; b < 3; ++b) {
        const int kb = 3 * w + b;
        if (kb < nke) {
          tma_store_2d(&ty, xs + kb * OBOX, kb * 64, m0);
          tma_store_2d(&to, gs + kb * OBOX, kb * 64, m0);
        }
      }
      bulk_commit();
    }
    // the tile's column partials: the four warps' sums added in order
    const float* cw = colp + 4 * w * 2 * BNW;
    for (int c = ct; c < BNW; c += 128) {
      const int col = BNW * w + c;
      if (col >= p.e) continue;
      float sy = 0.f, sb = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        sy += cw[q * 2 * BNW + c];
        sb += cw[q * 2 * BNW + BNW + c];
      }
      p.part[(long)u * 2 * p.e + col] = sy;
      p.part[(long)u * 2 * p.e + p.e + col] = sb;
    }
    if (ct == 0) {  // the stores have read the tiles: x (and g) may land again
      bulk_wait_read<0>();
      mbar_arrive(tempty);
    }
  }
  if (ct == 0) bulk_wait<0>();
}

// The tensor maps and the launch of the kernel `kernel` (a __global__ that
// calls tiles<KIND>) on (m, e) rows against a (m, k) and w (e, k): x, [g],
// y and the bf16 output (m, e).  Returns a CUDA error code.
template <typename Kernel>
inline int launch(Kernel kernel, const void* a, const void* w, const void* x, const void* g,
                  void* y, void* out, const Params& p, void* stream) {
  if (p.m == 0) return 0;
  CUtensorMap ta, tb, tx, tg, ty, to;
  int err = tmap_2d(&ta, a, p.m, p.k, BM);
  if (!err) err = tmap_2d(&tb, w, p.e, p.k, BNW);
  if (!err) err = tmap_2d(&tx, x, p.m, p.e, BM);
  if (!err) err = tmap_2d(&tg, g != nullptr ? g : x, p.m, p.e, BM);
  if (!err) err = tmap_2d(&ty, y, p.m, p.e, BM);
  if (!err) err = tmap_2d(&to, out, p.m, p.e, BM);
  if (err) return err;
  const int units = (p.m + BM - 1) / BM, grid = units < sm_count() ? units : sm_count();
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(ta, tb, tx, tg, ty, to, p);
  return (int)cudaGetLastError();
}

}  // namespace lnbwd
}  // namespace vk
