// Flash-attention forward, `dot`, `l2` and `l2ref` scores, for Hopper (sm_90a).
//
// Replaces the TPU kernels `_flash_kernel` / `_flash_forward`
// (vitgan_tpu/ops/attention.py:64-105, 232-278; pallas_call at :252) and
// their K/V-streaming variant `_flash_kernel_dma` (attention.py:108-169;
// pallas_call at :179): here K/V always stream through shared memory one
// tile at a time, at any length.
//
// Computes, per (batch*head, query):  O = softmax(S) v  and LSE = m + log(l),
// the f32 log-sum-exp of S the backward kernels will read (natural log, l
// clamped at 1e-30 as attention.py:100-104), with the score mode a template
// parameter (common.cuh): S = inv_scale q.k^T (`dot`), -inv_scale d2 (`l2`)
// or inv_scale sqrt(d2 + 1e-12) (`l2ref`, attention.py:61), d2 = max(|q|^2 +
// |k|^2 - 2 q.k^T, 0) formed on the f32 S accumulators.  In both designs the
// online softmax works on the S accumulators in registers, in f32 and in log2
// units (exp2 with log2(e) folded into the scale); keys past n are masked to
// -inf explicitly; p is cast to bf16 before P.V, as attention.py:93 does,
// while the row sums l add the f32 p, as there; rows past n are never stored.
// The head dimension is padded to a multiple of 16 in shared memory only
// (zeros), never in device memory.
//
// Two designs.  `dot` (the highres128 path and the v1 generator: 64 heads of
// 1,024 tokens, Dh 64) runs the TMA kernel (namespace wg); `l2` and `l2ref`
// (the v1 discriminator: 1,024 heads of 50 tokens, Dh 108, whose 216-byte
// rows no tensor map takes) run the persistent kernel on the skeleton of
// flash_l2.cuh (namespace l2fwd), which reads and writes the rows where they
// lie, at any Dh that is a multiple of 4.
//
// The `dot` kernel (wg::flash_attn_fwd_kernel<DP>).  One block of 384
// threads owns 128 queries of one (batch*head).  Warp 0 of the producer
// warpgroup loads the block's Q once by TMA (3-D tensor maps over (d, n, bh),
// so rows past n read zeros), then streams K and V, KT keys a tile (128 at
// DP <= 64, 64 above), through a four-stage ring on full/empty mbarriers.
// Consumer warpgroup w owns queries 64 w .. 64 w + 63 of the block (one
// with no row below n returns at once), O in f32 registers:
//   S = Q K^T     wgmma m64nKTk16, both operands K-major in shared memory
//                 (128-byte swizzle);
//   softmax       row max over the quad of lanes that share a row, O and l
//                 rescaled by alpha = exp2(m_old - m_new), P = exp2(S - m);
//   O += P V      wgmma with A (P in bf16) from registers, B (V) MN-major
//                 from the same tile, as the k-block backward's dV += P^T dO;
// both products retire within the tile (O is rescaled in registers between
// tiles), and the stage is released; the other warpgroup's products overlap
// this one's softmax.  O runs 64 or 128 columns wide (zero columns past d).
// The epilogue scales O by 1/l and stores bf16 rows < n, columns < d, in the
// (bh, n, d) layout or, with out_bnhd, the (b, n, heads, d) layout the
// megablock's out-projection reads.
//
// The `l2`/`l2ref` kernel (l2fwd::flash_fwd_l2_kernel<DP, MODE>).  A unit is
// (batch*head, R query rows); the producer lane bulk-copies the unit's Q rows
// into the resident ring and each 64-key tile's K and V rows into the tile
// ring, and bulk-stores the O rows the consumers staged in the unit's
// resident entry (flash_l2.cuh).  The consumers load Q's mma fragments from
// the entry into registers (the A operand of S = Q K^T) and |q|^2 from
// them, re-lay each tile's K (K-major, for S) and V (MN-major, for O += P V
// with P in bf16 from registers) into a swizzled pair and take |k|^2 from it:
//   n <= 64 (the v1 discriminator): the two warpgroups take alternate units,
//     each a whole head;
//   n > 64 (ragged, 1,025 tokens): both take every unit and stream its tiles,
//     each re-laying one of K and V; O stays in f32 registers across the
//     tiles, rescaled by alpha between them (every product retires within its
//     tile), each warpgroup 64 of the unit's 128 rows (Dh <= 64) or one
//     column box of its 64 (Dh > 64: the warpgroups share S).
// The epilogue scales O by 1/l, stages its bf16 rows < n, columns < d, and
// writes the LSE, one thread a row.
//
// Bound on this card.  At the serving shape (64*6 heads, 1,024 tokens,
// Dh 64) a launch does 4*384*1024^2*64 = 1.03e11 flops on 201 MB of
// q/k/v/o: 0.10 ms of tensor-core time against 0.06 ms of HBM time, so the
// tensor cores bound it; its 4.0e8 exponentials take the SFUs (16 a clock on
// each SM) about 0.1 ms more, which the two warpgroups' overlap hides at
// best.  At the v1 discriminator's `l2` shape (256*4 heads, 50 tokens,
// Dh 108) a launch moves 44 MB of q/k/v/o and LSE for 1.1e9 flops: 0.0133 ms
// of HBM time against 0.001 ms of tensor-core time, so the bytes bound it.
//
// ptxas -v (sm_90a, CUDA 12.8): the `dot` kernel launches at 168 registers a
// thread (the producer warpgroup drops to 40, the consumers take 232 by
// setmaxnreg), no spills and no performance warning at any DP; dynamic
// shared memory 148,552 bytes at DP <= 64, 164,936 at DP 80-128.  The `l2`
// kernel: PERF.md; chip_smoke.py fails on a spill or a performance warning
// of it at DP 112 and 64.
#include "flash_l2.cuh"

using namespace vk;

namespace {

// --- the `l2` / `l2ref` kernel: the persistent skeleton of flash_l2.cuh ------

namespace l2fwd {

using namespace hopper;
using namespace vk::l2;

// Q rows resident, K and V rows a tile; O staged in Q's place.
__host__ __device__ constexpr Entry fwd_entry() { return Entry{1, false, false}; }

// S = Q K^T, 64 x 64: A the Q fragments in registers, B the tile's K boxes
// (swizzled, K-major) at sw; one wgmma group, the accumulators zeroed first.
template <int DP>
__device__ __forceinline__ void qk(float (&sa)[32], const uint32_t (&a)[DP / 16][4],
                                   const unsigned char* sw) {
  using G = Geo<DP>;
#pragma unroll
  for (int k = 0; k < 32; ++k) sa[k] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    wgmma_rs<64, 0>(sa, a[kk], desc_sw128(sw + (kk >> 2) * G::SBOX + (kk & 3) * 32, 16, 1024));
  wgmma_commit();
}

// The online softmax of one tile in place over S: this thread's rows
// lrow + 8 h (|q|^2 nr[h]) and keys 8 j + 2 t + (e & 1) (|k|^2 in nk); the
// scores in log2 units, keys at or past `cols` -inf; m and l, the rows'
// running max and this thread's part of their sums, updated, alpha[h] the
// factor of the row's earlier O; S becomes p = exp2(s - m) (f32).
template <int MODE>
__device__ __forceinline__ void softmax(float (&sa)[32], const float (&nr)[2], const float* nk,
                                        int cols, float scale_log2, float (&m)[2], float (&l)[2],
                                        float (&alpha)[2]) {
  const int t = threadIdx.x & 3;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * t;
    const float2 nc = *reinterpret_cast<const float2*>(nk + col);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      const float s = col + (e & 1) < cols
                          ? score_log2<MODE>(sa[4 * j + e], nr[h], (e & 1) ? nc.y : nc.x,
                                             scale_log2)
                          : -INFINITY;
      sa[4 * j + e] = s;
      mx[h] = fmaxf(mx[h], s);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h]);
    alpha[h] = exp2f(m[h] - m_new);
    m[h] = m_new;
    l[h] *= alpha[h];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(sa[4 * j + e] - m[e >> 1]);
      sa[4 * j + e] = p;
      l[e >> 1] += p;
    }
}

// 1/l of this thread's rows lrow + 8 h; the LSE (natural log: ln2 m + ln l)
// of those below `rows` written at lse[row] by lane t == 0 where `write`.
__device__ __forceinline__ void finish(const float (&m)[2], const float (&l)[2], int lrow,
                                       int rows, bool write, float* lse, float (&il)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lt = l[h];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    lt = fmaxf(lt, 1e-30f);
    il[h] = 1.f / lt;
    if (write && (threadIdx.x & 3) == 0 && lrow + 8 * h < rows)
      lse[lrow + 8 * h] = m[h] * 0.69314718055994531f + logf(lt);
  }
}

// O box b of this thread's rows (lane pairs trading halves: row orow,
// columns 64 b + 8 j + 2 (t & 2) .. + 3), scaled by the row's 1/l, staged as
// bf16 rows < rows, columns < d of the unit's resident entry at x.
__device__ __forceinline__ void stage_box(const float (&acc)[32], int b, float il, int orow,
                                          int rows, int d, unsigned char* x) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 64 * b + 8 * j + 2 * (t & 2);
    const float4 v = row_quad(acc, j);
    if (orow < rows && col < d)
      *reinterpret_cast<uint2*>(x + orow * d * 2 + col * 2) =
          make_uint2(pack_bf16(v.x * il, v.y * il), pack_bf16(v.z * il, v.w * il));
  }
}

// Ping-pong consumers (n <= 64, a unit a head): warpgroup w takes the
// block's units w, w + 2, ..., whole: it re-lays the unit's K and V into its
// own swizzled pair, forms S and the softmax, then O, staged in place of the
// unit's Q rows (read into registers by every thread of the warpgroup before
// its first barrier).
template <int DP, int MODE>
__device__ __forceinline__ void consume_units(const Shared<DP>& sh, int w, float* lse) {
  using G = Geo<DP>;
  constexpr int NB = G::NB;
  const int n = sh.n, d = sh.d;
  const int ct = threadIdx.x & 127, lane = threadIdx.x & 31;
  const int wr = ct >> 5, g = lane >> 2, t = lane & 3;
  const int lrow = 16 * wr + g;               // this thread's rows lrow, lrow + 8
  const int orow = lrow + ((t & 1) ? 8 : 0);  // the row whose outputs this lane stages
  unsigned char* sw = sh.swz + w * G::SWZ;    // K's boxes, then V's
  float* nk = sh.trows + w * 3 * TILE + 2 * TILE;
  for (int i = w;; i += 2) {
    mbar_wait(sh.rfull(i % sh.g.rn), (i / sh.g.rn) & 1);
    const int bh = sh.unit(i);
    if (bh < 0) break;
    const int off = sh.off(bh, 0);
    unsigned char* xq = sh.rent(i) + off;
    uint32_t qa[DP / 16][4];
    load_frags<DP>(qa, xq, lrow, n, d);
    float nr[2];
    frag_norms(qa, nr);
    mbar_wait(sh.tfull(i % sh.g.tn), (i / sh.g.tn) & 1);
    const unsigned char* te = sh.tent(i);
    // (this warpgroup's pair keeps its zero rows and columns after its first unit)
    relayout<G::DPAD>(sw, G::SBOX, te + off, n, d, 2 * d, ct, i == w);
    relayout<G::DPAD>(sw + NB * G::SBOX, G::SBOX, te + sh.g.ttensor + off, n, d, 2 * d, ct,
                      i == w);
    fence_proxy_async();  // the re-laid tile before the wgmmas read it
    named_bar_sync(BAR_WG + w, 128);
    if (ct == 0) mbar_arrive(sh.tfree(i % sh.g.tn));
    float sa[32];
    qk<DP>(sa, qa, sw);
    {  // the tile's |k|^2, two threads a row, under the product
      const float v = row_norm<DP, 2>(sw, G::SBOX, ct >> 1);
      if ((ct & 1) == 0) nk[ct >> 1] = v;
    }
    named_bar_sync(BAR_WG + w, 128);
    wgmma_wait<0>();
    fence_regs(sa);
    fence_frags(qa);
    float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f}, alpha[2], il[2];
    softmax<MODE>(sa, nr, nk, n, sh.scale_log2, m, l, alpha);
    uint32_t pf[4][4];
    pack_frags(pf, sa);
    finish(m, l, lrow, n, true, lse + (long)bh * n, il);
    // O = P V, every column box in one product: B the tile's V boxes,
    // MN-major (the zeroed accumulators pinned ahead of the fence)
    float acc[G::DPAD / 2];
#pragma unroll
    for (int k = 0; k < G::DPAD / 2; ++k) acc[k] = 0.f;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<G::DPAD, 1>(acc, pf[kk], desc_sw128(sw + NB * G::SBOX + kk * 2048, G::SBOX, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_frags(pf);
#pragma unroll
    for (int b = 0; b < NB; ++b)
      stage_box(box_of<G::DPAD>(acc, b), b, (t & 1) ? il[1] : il[0], orow, n, d, xq);
    fence_proxy_async();  // before the bulk stores read them
    mbar_arrive(sh.rfree(i % sh.g.rn));
  }
}

// Lockstep consumers (n > 64): both warpgroups take every unit of R query
// rows and stream its tiles; warpgroup w re-lays tensor w of each tile (K,
// V) into the shared swizzled pair (two pairs in turn), then takes rows
// roff .. roff + 63 and column box cb of O (two boxes: the same rows, a box
// each; one box: 64 rows each), O in f32 registers across the tiles.
template <int DP, int MODE>
__device__ __forceinline__ void consume_blocks(const Shared<DP>& sh, int w, float* lse) {
  using G = Geo<DP>;
  constexpr int NB = G::NB, R = G::R;
  const int n = sh.n, d = sh.d;
  const int ct = threadIdx.x & 127, lane = threadIdx.x & 31;
  const int wr = ct >> 5, g = lane >> 2, t = lane & 3;
  const int roff = NB == 1 ? 64 * w : 0, cb = NB == 1 ? 0 : w;
  const int lrow = roff + 16 * wr + g;        // this thread's rows lrow, lrow + 8
  const int orow = lrow + ((t & 1) ? 8 : 0);  // the row whose outputs this lane stages
  int c = 0;
  for (int i = 0;; ++i) {
    mbar_wait(sh.rfull(i % sh.g.rn), (i / sh.g.rn) & 1);
    const int u = sh.unit(i);
    if (u < 0) break;
    const int bh = u / sh.per, row0 = (u - bh * sh.per) * R;
    const int rows_u = min(R, n - row0), off = sh.off(bh, row0);
    unsigned char* xq = sh.rent(i) + off;
    uint32_t qa[DP / 16][4];
    load_frags<DP>(qa, xq, lrow, rows_u, d);
    float nr[2];
    frag_norms(qa, nr);
    float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f}, alpha[2], il[2];
    float acc[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) acc[k] = 0.f;
    for (int tt = 0; tt < sh.ntiles; ++tt, ++c) {
      const int rows_t = min(TILE, n - tt * TILE);
      unsigned char* sw = sh.swz + (c & 1) * G::SWZ;
      float* nk = sh.trows + (c & 1) * 3 * TILE + 2 * TILE;
      mbar_wait(sh.tfull(c % sh.g.tn), (c / sh.g.tn) & 1);
      const unsigned char* te = sh.tent(c);
      const int toff = sh.off(bh, tt * TILE);
      relayout<G::DPAD>(sw + w * NB * G::SBOX, G::SBOX, te + w * sh.g.ttensor + toff, rows_t, d,
                        2 * d, ct, true);
      fence_proxy_async();
      named_bar_sync(BAR_PAIR, 256);
      if (threadIdx.x == 0) mbar_arrive(sh.tfree(c % sh.g.tn));
      float sa[32];
      qk<DP>(sa, qa, sw);
      {  // the tile's |k|^2, four threads a row, under the product
        const float v = row_norm<DP>(sw, G::SBOX, threadIdx.x >> 2);
        if ((threadIdx.x & 3) == 0) nk[threadIdx.x >> 2] = v;
      }
      named_bar_sync(BAR_PAIR2, 256);
      wgmma_wait<0>();
      fence_regs(sa);
      softmax<MODE>(sa, nr, nk, rows_t, sh.scale_log2, m, l, alpha);
#pragma unroll
      for (int k = 0; k < 32; ++k) acc[k] *= alpha[(k >> 1) & 1];
      uint32_t pf[4][4];
      pack_frags(pf, sa);
      // O += P V: B the tile's V box cb, MN-major; retired within the tile
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<64, 1>(acc, pf[kk],
                        desc_sw128(sw + (NB + cb) * G::SBOX + kk * 2048, G::SBOX, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_frags(pf);
      fence_frags(qa);
    }
    // (both warpgroups hold the same rows' LSE with two boxes: warpgroup 0 writes it)
    finish(m, l, lrow, rows_u, NB == 1 || w == 0, lse + (long)bh * n + row0, il);
    stage_box(acc, cb, (t & 1) ? il[1] : il[0], orow, rows_u, d, xq);
    fence_proxy_async();  // before the bulk stores read them
    mbar_arrive(sh.rfree(i % sh.g.rn));
  }
}

// q, k, v, o: (bh, n, d) bf16, 8-byte aligned, d a multiple of 4; lse: (bh,
// n) f32.  A persistent grid of `grid` blocks (ops/attention.l2_grid).
template <int DP, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_l2_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                    int bhs, int n, int d, float scale_log2) {
  static_assert(MODE == kL2 || MODE == kL2Ref, "the persistent forward serves `l2` and `l2ref`");
  const Shared<DP> sh = setup<DP>(bhs, n, d, fwd_entry(), 0, scale_log2, 0.f);
  if (threadIdx.x >= 256) {  // producer: warp 3 of the producer warpgroup
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x < 352) return;
    produce<DP>(sh, q, nullptr, k, v, nullptr, nullptr, o, nullptr, 1, nullptr);
    return;
  }
  reg_alloc<CONSUMER_REGS>();
  if (sh.pingpong)
    consume_units<DP, MODE>(sh, threadIdx.x >> 7, lse);
  else
    consume_blocks<DP, MODE>(sh, threadIdx.x >> 7, lse);
}

template <int DP, int MODE>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int n, int d,
           float scale_log2, int grid, cudaStream_t stream) {
  const int smem = rings_of<DP>(n, d, fwd_entry(), 0).smem;
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(flash_fwd_l2_kernel<DP, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  flash_fwd_l2_kernel<DP, MODE><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), bh, n, d, scale_log2);
  return (int)cudaGetLastError();
}

template <int MODE>
int dispatch(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int n,
             int d, float sl, int grid, cudaStream_t s) {
  const void* ptrs[4] = {q, k, v, o};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 8 != 0) return (int)cudaErrorInvalidValue;
  if (d % 4 != 0 || d <= 0 || grid <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  switch ((d + 15) / 16) {
    case 1: return launch<16, MODE>(q, k, v, o, lse, bh, n, d, sl, grid, s);
    case 2: return launch<32, MODE>(q, k, v, o, lse, bh, n, d, sl, grid, s);
    case 3: return launch<48, MODE>(q, k, v, o, lse, bh, n, d, sl, grid, s);
    case 4: return launch<64, MODE>(q, k, v, o, lse, bh, n, d, sl, grid, s);
    case 5: return launch<80, MODE>(q, k, v, o, lse, bh, n, d, sl, grid, s);
    case 6: return launch<96, MODE>(q, k, v, o, lse, bh, n, d, sl, grid, s);
    case 7: return launch<112, MODE>(q, k, v, o, lse, bh, n, d, sl, grid, s);
    case 8: return launch<128, MODE>(q, k, v, o, lse, bh, n, d, sl, grid, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace l2fwd

// --- the `dot` kernel: wgmma, TMA and mbarrier rings -----------------------

namespace wg {

using namespace hopper;

constexpr int QROWS = 128;    // queries per block: two consumer warpgroups of 64
constexpr int THREADS = 384;  // producer warpgroup + two consumer warpgroups
constexpr int STAGES = 4;     // K/V tiles in flight

// Shared-memory geometry for a head dimension padded to DP (a multiple of
// 16): NB boxes of 64 columns per row (zeros past d), so O runs DPAD = 64 NB
// columns; KT keys a streamed tile.
template <int DP>
struct Geo {
  static constexpr int NB = (DP + 63) / 64;
  static constexpr int DPAD = 64 * NB;
  static constexpr int KT = DP <= 64 ? 128 : 64;
  static constexpr int QBOX = 64 * 128;       // one box of a warpgroup's 64 Q rows, bytes
  static constexpr int KBOX = KT * 128;       // one box of a K or V tile
  static constexpr int STAGE = 2 * NB * KBOX;  // NB boxes of K, then NB of V
};

template <int DP>
constexpr int smem_bytes() {
  using G = Geo<DP>;
  return 1024 + 2 * G::NB * G::QBOX + STAGES * G::STAGE + (2 * STAGES + 1) * 8;
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
flash_attn_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                      float* __restrict__ lse, int n, int d, int heads, float scale_log2,
                      int out_bnhd) {
  using G = Geo<DP>;
  constexpr int NB = G::NB, DPAD = G::DPAD, KT = G::KT, NA = DPAD / 2, NS = KT / 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* qs = smem;                       // warpgroup w's box b at (w NB + b) QBOX
  unsigned char* stages = qs + 2 * NB * G::QBOX;  // stage s at s STAGE
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + STAGES * G::STAGE);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  const int wgi = threadIdx.x >> 7;
  const int q0 = blockIdx.x * QROWS, bh = blockIdx.y;
  const int ntiles = (n + KT - 1) / KT;
  const int nwg = n - q0 > 64 ? 2 : 1;  // consumer warpgroups with a row below n
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], nwg);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wgi == 0) {  // producer: one thread issues every TMA load
    reg_dealloc<40>();
    if (threadIdx.x == 0) {
      mbar_arrive_tx(qbar, nwg * NB * G::QBOX);
      for (int w = 0; w < nwg; ++w)
        for (int b = 0; b < NB; ++b)
          tma_load_3d(qs + (w * NB + b) * G::QBOX, &tq, qbar, 64 * b, q0 + 64 * w, bh);
      for (int kt = 0; kt < ntiles; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(&empty[s], ((kt / STAGES) - 1) & 1);
        unsigned char* st = stages + s * G::STAGE;
        mbar_arrive_tx(&full[s], 2 * NB * G::KBOX);
        for (int b = 0; b < NB; ++b) {
          tma_load_3d(st + b * G::KBOX, &tk, &full[s], 64 * b, kt * KT, bh);
          tma_load_3d(st + (NB + b) * G::KBOX, &tv, &full[s], 64 * b, kt * KT, bh);
        }
      }
    }
    return;
  }

  // consumers: warpgroup w owns queries q0 + 64 w .. + 63
  reg_alloc<232>();
  const int w = wgi - 1;
  if (w >= nwg) return;
  const int ct = threadIdx.x & 127, lane = threadIdx.x & 31, wr = ct >> 5, g = lane >> 2,
            t = lane & 3;
  const unsigned char* qw = qs + w * NB * G::QBOX;
  float oa[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) oa[i] = 0.f;
  // this thread's rows 16 wr + g + 8 h: running max (log2 units) and its
  // part of the running sum
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
  mbar_wait(qbar, 0);

  for (int kt = 0; kt < ntiles; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(&full[s], (kt / STAGES) & 1);
    const unsigned char* ks = stages + s * G::STAGE;
    const unsigned char* vs = ks + NB * G::KBOX;
    // S = Q K^T (64 queries x KT keys; both K-major), the first step
    // overwriting the accumulators
    float sa[NS];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss<KT, 0, 0>(sa, desc_sw128(qw + (kk >> 2) * G::QBOX + (kk & 3) * 32, 16, 1024),
                         desc_sw128(ks + (kk >> 2) * G::KBOX + (kk & 3) * 32, 16, 1024), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sa);
    // this thread holds rows 16 wr + g + 8 (e >> 1), keys 8 j + 2 t + (e & 1)
    if ((kt + 1) * KT > n) {  // keys past n: -inf (TMA's zero rows would score 0)
#pragma unroll
      for (int j = 0; j < KT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kt * KT + 8 * j + 2 * t + (e & 1) >= n) sa[4 * j + e] = -INFINITY;
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sa[4 * j + e]);
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h] * scale_log2);
      alpha[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(fmaf(sa[4 * j + e], scale_log2, -m[e >> 1]));
        sa[4 * j + e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int j = 0; j < DPAD / 8; ++j) {
      oa[4 * j] *= alpha[0];
      oa[4 * j + 1] *= alpha[0];
      oa[4 * j + 2] *= alpha[1];
      oa[4 * j + 3] *= alpha[1];
    }
    // O += P V (A: P in bf16 from registers, 16 keys a step; B: V MN-major)
    uint32_t pf[KT / 16][4];
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) pf[kk][r] = pack_bf16(sa[8 * kk + 2 * r], sa[8 * kk + 2 * r + 1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)
      wgmma_rs<DPAD, 1>(oa, pf[kk], desc_sw128(vs + kk * 2048, G::KBOX, 1024));
    wgmma_commit();
    // P V retires within the tile: O is rescaled in registers before the next
    // one, and the stage is free
    wgmma_wait<0>();
    fence_regs(oa);
    fence_frags(pf);
    if (ct == 0) mbar_arrive(&empty[s]);
  }

  // O / l and the LSE (natural log: lse = ln2 * m + ln l), rows < n, columns < d
  const long b = bh / heads, hh = bh % heads;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lt = l[h];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    lt = fmaxf(lt, 1e-30f);
    const int row = q0 + 64 * w + 16 * wr + g + 8 * h;
    if (row >= n) continue;
    const float inv_l = 1.f / lt;
    bf16* orow = o + (out_bnhd ? ((b * n + row) * heads + hh) * (long)d
                               : ((long)bh * n + row) * (long)d);
#pragma unroll
    for (int j = 0; j < DPAD / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (col < d)
        *reinterpret_cast<uint32_t*>(orow + col) =
            pack_bf16(oa[4 * j + 2 * h] * inv_l, oa[4 * j + 2 * h + 1] * inv_l);
    }
    if (t == 0) lse[(long)bh * n + row] = m[h] * 0.69314718055994531f + logf(lt);
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int n, int d,
           int heads, float scale_log2, int out_bnhd, cudaStream_t stream) {
  using G = Geo<DP>;
  CUtensorMap tq, tk, tv;
  const uint64_t dims[3] = {(uint64_t)d, (uint64_t)n, (uint64_t)bh};
  const uint64_t strides[2] = {(uint64_t)d * 2, (uint64_t)n * d * 2};
  const uint32_t qbox[3] = {64, 64, 1}, kbox[3] = {64, (uint32_t)G::KT, 1};
  int err = make_tmap_bf16(&tq, q, 3, dims, strides, qbox);
  if (!err) err = make_tmap_bf16(&tk, k, 3, dims, strides, kbox);
  if (!err) err = make_tmap_bf16(&tv, v, 3, dims, strides, kbox);
  if (err) return err;
  constexpr int smem = smem_bytes<DP>();
  cudaFuncSetAttribute(flash_attn_fwd_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  const dim3 grid((n + QROWS - 1) / QROWS, bh);
  flash_attn_fwd_kernel<DP><<<grid, THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), static_cast<float*>(lse), n, d, heads, scale_log2,
      out_bnhd);
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int n,
             int d, int heads, float sl, int out_bnhd, cudaStream_t s) {
  switch ((d + 15) / 16) {
    case 1: return launch<16>(q, k, v, o, lse, bh, n, d, heads, sl, out_bnhd, s);
    case 2: return launch<32>(q, k, v, o, lse, bh, n, d, heads, sl, out_bnhd, s);
    case 3: return launch<48>(q, k, v, o, lse, bh, n, d, heads, sl, out_bnhd, s);
    case 4: return launch<64>(q, k, v, o, lse, bh, n, d, heads, sl, out_bnhd, s);
    case 5: return launch<80>(q, k, v, o, lse, bh, n, d, heads, sl, out_bnhd, s);
    case 6: return launch<96>(q, k, v, o, lse, bh, n, d, heads, sl, out_bnhd, s);
    case 7: return launch<112>(q, k, v, o, lse, bh, n, d, heads, sl, out_bnhd, s);
    case 8: return launch<128>(q, k, v, o, lse, bh, n, d, heads, sl, out_bnhd, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace wg

}  // namespace

// q, k, v: (bh, n, d) bf16, contiguous.  `dot`: 16-byte aligned, d a multiple
// of 8 and at most 128, bh <= 65535; o (bh, n, d) bf16 or, with out_bnhd, the
// (b, n, heads, d) layout the out-projection reads as (b*n, heads*d).  `l2`,
// `l2ref`: 8-byte aligned, d a multiple of 4 and at most 128, o (bh, n, d)
// bf16 (no out_bnhd), `grid` the persistent blocks (ops/attention.l2_grid).
// lse: (bh, n) f32.  inv_scale multiplies q.k (`dot`) or the distance; mode
// 0 `dot`, 1 `l2`, 2 `l2ref`.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                              int bh, int n, int d, int heads, float inv_scale, int out_bnhd,
                              int mode, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float sl = inv_scale * 1.4426950408889634f;  // log2(e)
  if (mode != kDot && out_bnhd) return (int)cudaErrorInvalidValue;
  switch (mode) {
    case kDot:
      if (d % 8 != 0) return (int)cudaErrorInvalidValue;
      return wg::dispatch(q, k, v, o, lse, bh, n, d, heads, sl, out_bnhd, s);
    case kL2: return l2fwd::dispatch<kL2>(q, k, v, o, lse, bh, n, d, sl, grid, s);
    case kL2Ref: return l2fwd::dispatch<kL2Ref>(q, k, v, o, lse, bh, n, d, sl, grid, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
