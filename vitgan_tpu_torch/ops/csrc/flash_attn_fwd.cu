// Flash-attention forward, `dot`, `l2` and `l2ref` scores, for Hopper (sm_90a).
//
// Replaces the TPU kernels `_flash_kernel` / `_flash_forward`
// (vitgan_tpu/ops/attention.py:64-105, 232-278) and their K/V-streaming
// variant `_flash_kernel_dma` (attention.py:108-169): here K/V always stream
// through shared memory one tile at a time, at any length.
//
// Computes, per (batch*head, query):  O = softmax(S) v  and LSE = m + log(l),
// the f32 log-sum-exp of S the backward kernels will read (natural log, l
// clamped at 1e-30 as attention.py:100-104), with the score mode a template
// parameter (common.cuh): S = inv_scale q.k^T (`dot`), -inv_scale d2 (`l2`)
// or inv_scale sqrt(d2 + 1e-12) (`l2ref`), d2 = max(|q|^2 + |k|^2 - 2
// q.k^T, 0) formed on the f32 S accumulators.  In every design the online
// softmax works on the S accumulators in registers, in f32 and in log2 units
// (exp2 with log2(e) folded into the scale); keys past n are masked to -inf
// explicitly; p is cast to bf16 before P.V, as attention.py:93 does, while
// the row sums l add the f32 p, as there; rows past n are never stored.  The
// head dimension is padded to a multiple of 16 in shared memory only (zeros),
// never in device memory: no padding to 128 as on the TPU.  Dh must be a
// multiple of 8 (16-byte rows): the wrapper (ops/attention.flash_forward)
// zero-pads other widths, as the v1 discriminator's 108, to one (112) in
// device memory and slices O back; zero columns change no score of any mode.
//
// Two designs.  `dot` (the highres128 path and the v1 generator) runs the
// wgmma kernel (namespace wg); `l2` and `l2ref` (the v1 discriminator at 50
// tokens, host-bound) keep the mma.sync kernel below it.
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
// What held the mma.sync design back, and what this does about it: 8 warps
// of 16 rows each reading every K and V tile from shared memory by ldmatrix
// (now wgmma's descriptors), a two-stage cp.async ring behind one block
// barrier a tile (now TMA on mbarriers, the producer apart), mma.sync at a
// fraction of the tensor cores' wgmma rate.
//
// The `l2` kernel (flash_attn_fwd_kernel<DP, MODE>).  One block of 8 warps
// per (128-query tile, batch*head); each warp owns 16 query rows.  The Q
// fragments stay in registers; 64-key K/V tiles stream through a two-stage
// cp.async ring, the next tile's copy in flight while the current one is
// used.  S = Q K^T and O += P V run on mma.sync m16n8k16 with ldmatrix
// operands.  |q|^2 of the warp's rows comes from the resident Q tile once;
// |k|^2 of each streamed K tile from its shared-memory copy, into a 64-float
// array, behind a second barrier.
//
// Bound on this card.  At the serving shape (64*6 heads, 1,024 tokens,
// Dh 64) a launch does 4*384*1024^2*64 = 1.03e11 flops on 201 MB of
// q/k/v/o: 0.10 ms of tensor-core time against 0.06 ms of HBM time, so the
// tensor cores bound it; its 4.0e8 exponentials take the SFUs (16 a clock on
// each SM) about 0.1 ms more, which the two warpgroups' overlap hides at
// best.  At the v1 discriminator's `l2` shape (128*2*4 heads, 50 tokens,
// Dh 108) a launch moves 44 MB of q/k/v/o for 1.1e9 flops: 0.013 ms of HBM
// time against 0.001 ms of tensor-core time, so the bytes bound it there,
// and a 128-query block holds 50 real rows.
//
// ptxas -v (sm_90a, CUDA 12.8): the `dot` kernel launches at 168 registers a
// thread (the producer warpgroup drops to 40, the consumers take 232 by
// setmaxnreg), no spills and no performance warning at any DP; dynamic
// shared memory 148,552 bytes at DP <= 64, 164,936 at DP 80-128.  The
// mma.sync kernel's `l2ref` instantiation spills 12 bytes at DP 64.
#include "hopper.cuh"

using namespace vk;

namespace {

constexpr int BQ = 128;    // queries per block
constexpr int BK = 64;     // keys per streamed tile
constexpr int NWARP = 8;   // 16 query rows per warp

template <int DP, int MODE>
constexpr size_t smem_bytes() {
  // Q, two stages of K and V and |k|^2 of the current K tile
  return (size_t)(BQ + 4 * BK) * (DP + 8) * 2 + BK * sizeof(float);
}

// Two blocks per SM where the registers allow it (Dh <= 64: at most 128 each).
template <int DP, int MODE>
__global__ void __launch_bounds__(NWARP * 32, DP <= 64 ? 2 : 1)
flash_attn_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, int n, int d, int heads, float scale_log2,
                      int out_bnhd) {
  constexpr int LD = DP + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + BQ * LD;       // stage s at ks + s * BK * LD
  bf16* vs = ks + 2 * BK * LD;
  float* kk_s = reinterpret_cast<float*>(vs + 2 * BK * LD);  // |k|^2 of the tile

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const long bh = blockIdx.y;
  const long base = bh * (long)n * d;
  const bf16* kb = k + base;
  const bf16* vb = v + base;

  cp_tile(qs, LD, q + base, d, q0, 0, BQ, DP, n, d);
  cp_tile(ks, LD, kb, d, 0, 0, BK, DP, n, d);
  cp_tile(vs, LD, vb, d, 0, 0, BK, DP, n, d);
  cp_async_commit();

  uint32_t qf[DP / 16][4];
  float acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_r[2] = {-1e30f, -1e30f};  // running max of rows g and g+8 (log2 units)
  float l_r[2] = {0.f, 0.f};        // this lane's part of the running row sums
  float qq[2] = {0.f, 0.f};         // |q|^2 of rows g and g+8

  const int ntiles = (n + BK - 1) / BK;
  for (int kt = 0; kt < ntiles; ++kt) {
    const int cur = kt & 1;
    // One barrier a tile: after it tile kt (and Q) have landed and every warp
    // is done with tile kt - 1, whose stage takes tile kt + 1.
    cp_async_wait<0>();
    __syncthreads();
    if (kt + 1 < ntiles) {
      cp_tile(ks + (cur ^ 1) * BK * LD, LD, kb, d, (kt + 1) * BK, 0, BK, DP, n, d);
      cp_tile(vs + (cur ^ 1) * BK * LD, LD, vb, d, (kt + 1) * BK, 0, BK, DP, n, d);
    }
    cp_async_commit();
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) load_a(qf[kk], qs, LD, warp * 16, kk * 16);
      frag_row_sq_norms<DP>(qq, qs, LD, warp * 16);
    }
    const bf16* kt_s = ks + cur * BK * LD;
    const bf16* vt_s = vs + cur * BK * LD;
    // every warp is past tile kt - 1's reads of kk_s (the barrier above)
    row_sq_norms<DP>(kk_s, kt_s, LD, BK);
    __syncthreads();

    // S = Q K^T: 16 x 64 per warp, 8 n-tiles of 8 keys.
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < BK / 8; j += 2) {
        uint32_t b[4];
        load_b_nk(b, kt_s, LD, kk * 16, j * 8);
        mma16816(s[j], qf[kk], b[0], b[1]);
        mma16816(s[j + 1], qf[kk], b[2], b[3]);
      }
    }

    // Online softmax on the accumulators: this lane holds rows g (e = 0, 1)
    // and g+8 (e = 2, 3), keys kt*BK + 8j + 2t + (e & 1).
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1);
        const int key = kt * BK + col;
        const float val =
            key < n ? score_log2<MODE>(s[j][e], qq[e >> 1], kk_s[col], scale_log2) : -INFINITY;
        s[j][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_r[h], mx[h]);
      alpha[h] = exp2f(m_r[h] - m_new);
      m_r[h] = m_new;
      l_r[h] *= alpha[h];
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - m_r[e >> 1]);
        s[j][e] = p;
        l_r[e >> 1] += p;
      }
    }
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // O += P V: the S accumulators of n-tiles 2kk and 2kk+1 are the A
    // fragment of key step kk.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < DP / 8; j += 2) {
        uint32_t b[4];
        load_b_kn(b, vt_s, LD, kk * 16, j * 8);
        mma16816(acc[j], a, b[0], b[1]);
        mma16816(acc[j + 1], a, b[2], b[3]);
      }
    }
  }

  // O / l and the LSE (natural log: lse = ln2 * m + ln l).
  const long b = bh / heads, hh = bh % heads;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_r[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l = fmaxf(l, 1e-30f);
    const int row = q0 + warp * 16 + g + 8 * h;
    if (row >= n) continue;
    const float inv_l = 1.f / l;
    bf16* orow = o + (out_bnhd ? ((b * n + row) * heads + hh) * (long)d : base + (long)row * d);
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = j * 8 + 2 * t;
      if (col < d)
        *reinterpret_cast<uint32_t*>(orow + col) =
            pack_bf16(acc[j][2 * h] * inv_l, acc[j][2 * h + 1] * inv_l);
    }
    if (t == 0) lse[bh * n + row] = m_r[h] * 0.69314718055994531f + logf(l);
  }
}

template <int DP, int MODE>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int n,
           int d, int heads, float scale_log2, int out_bnhd, cudaStream_t stream) {
  const size_t smem = smem_bytes<DP, MODE>();
  cudaFuncSetAttribute(flash_attn_fwd_kernel<DP, MODE>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid((n + BQ - 1) / BQ, bh);
  flash_attn_fwd_kernel<DP, MODE><<<grid, NWARP * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), n, d, heads, scale_log2, out_bnhd);
  return (int)cudaGetLastError();
}

template <int MODE>
int dispatch(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int n,
             int d, int heads, float sl, int out_bnhd, cudaStream_t s) {
  switch ((d + 15) / 16) {
    case 1: return launch<16, MODE>(q, k, v, o, lse, bh, n, d, heads, sl, out_bnhd, s);
    case 2: return launch<32, MODE>(q, k, v, o, lse, bh, n, d, heads, sl, out_bnhd, s);
    case 3: return launch<48, MODE>(q, k, v, o, lse, bh, n, d, heads, sl, out_bnhd, s);
    case 4: return launch<64, MODE>(q, k, v, o, lse, bh, n, d, heads, sl, out_bnhd, s);
    case 5: return launch<80, MODE>(q, k, v, o, lse, bh, n, d, heads, sl, out_bnhd, s);
    case 6: return launch<96, MODE>(q, k, v, o, lse, bh, n, d, heads, sl, out_bnhd, s);
    case 7: return launch<112, MODE>(q, k, v, o, lse, bh, n, d, heads, sl, out_bnhd, s);
    case 8: return launch<128, MODE>(q, k, v, o, lse, bh, n, d, heads, sl, out_bnhd, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

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

// q, k, v: (bh, n, d) bf16, contiguous, 16-byte aligned, d a multiple of 8 and
// at most 128.  o: (bh, n, d) bf16, or with out_bnhd the (b, n, heads, d)
// layout the out-projection reads as (b*n, heads*d).  lse: (bh, n) f32.
// bh <= 65535.  inv_scale multiplies q.k (`dot`) or the distance; mode 0
// `dot`, 1 `l2`, 2 `l2ref`.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                              int bh, int n, int d, int heads, float inv_scale, int out_bnhd,
                              int mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float sl = inv_scale * 1.4426950408889634f;  // log2(e)
  if (d % 8 != 0) return (int)cudaErrorInvalidValue;
  switch (mode) {
    case kDot: return wg::dispatch(q, k, v, o, lse, bh, n, d, heads, sl, out_bnhd, s);
    case kL2: return dispatch<kL2>(q, k, v, o, lse, bh, n, d, heads, sl, out_bnhd, s);
    case kL2Ref: return dispatch<kL2Ref>(q, k, v, o, lse, bh, n, d, heads, sl, out_bnhd, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
