// Flash-attention backward dQ, `dot` and `l2` scores, for Hopper (sm_90a).
//
// Replaces the TPU kernels `_flash_bwd_dq_kernel` and its K/V-streaming
// variant `_flash_bwd_dq_kernel_dma` (vitgan_tpu/ops/attention.py:324-389,
// launched at :701): here K and V always stream through shared memory one
// tile at a time, at any length.
//
// Computes, per (batch*head, query):  dQ = inv_scale * dS K (`dot`) or
// 2 inv_scale (dS K - rowsum(dS) q) (`l2`), with dS = P * (dO V^T - delta),
// P = exp(S - lse) recomputed from the forward's natural-log LSE
// (flash_attn_bwd.cuh has the formulas); dS is cast to bf16 before its
// product, as the TPU kernel does.
//
// Two designs, one for each score mode.  `dot` (the highres128
// discriminator's two-pass route, 1,025 tokens) runs the wgmma kernel below
// (namespace wg): one block a 128-query block, K and V streamed by TMA.  `l2`
// (the v1 discriminator, 50 tokens, Dh 108) runs the persistent kernel of
// flash_l2_bwd.cuh (flash_bwd_dq_l2_kernel): one block an SM walking many
// (head, 64-query) units, loads by 1-D bulk copies a unit or more ahead of
// the math, which reads and writes the unpadded (B, H, N, 108) tensors; its
// head note gives the bound and the design.
//
// The `dot` kernel (wg::flash_bwd_dq_kernel<DP>), the k-block kernel with
// the roles swapped.  One block of 384 threads owns 128 queries of one
// (batch*head).  Warp 0 of the producer warpgroup loads the block's Q and dO
// once by TMA (3-D tensor maps over (d, n, bh); rows past n read zeros),
// then streams K and V, 64 keys a tile, through a four-stage ring on
// full/empty mbarriers.  Consumer warpgroup w owns queries 64 w .. 64 w + 63
// (one with no row below n returns at once) and reads its rows' LSE (log2
// units, +inf past n, so P = 0 there) and delta once, into registers; dQ
// stays in f32 registers for the whole key loop:
//   S = Q K^T and dP = dO V^T   wgmma m64n64k16, both operands K-major in
//                               shared memory (128-byte swizzle);
//   P, dS = P * (dP - delta)    on the accumulators, keys past n masked to
//                               P = 0;
//   dQ += dS K                  wgmma with A (dS in bf16) from registers, B (K)
//                               MN-major from the same tile;
// the products retire within the tile and the stage is released; the other
// warpgroup's products overlap this one's exp and dS.  dQ runs 64 or 128
// columns wide (zero columns past d); the epilogue scales it by inv_scale
// and stores bf16 rows < n, columns < d.  No atomics and no exchange through
// shared memory: each dQ element is one thread's sum over the keys in key
// order, so dQ is bit-deterministic.
//
// Bound on this card.  At the highres128 discriminator's shape (64*6 heads,
// 1,025 tokens, Dh 64) a launch does three products of 2*N*N*Dh flops per
// head, 1.55e11 flops, on 255 MB of q/k/v/dO/dq and rows: 0.16 ms of
// tensor-core time against 0.08 ms of HBM time; its 4.0e8 exponentials take
// the SFUs about 0.1 ms more, which the two warpgroups' overlap hides at best.
//
// ptxas -v (sm_90a, CUDA 12.8): the `dot` kernel launches at 168 registers a
// thread (40 producer / 232 consumer by setmaxnreg), no spills and no
// performance warning at any DP; dynamic shared memory 99,400 bytes at DP <=
// 64, 197,704 at DP 80-128.  The `l2` kernel: PERF.md.
#include "flash_attn_bwd.cuh"
#include "flash_l2_bwd.cuh"

using namespace vk;
using vk::bwd::LOG2E;

namespace {

// --- the `dot` kernel: wgmma, TMA and mbarrier rings -----------------------

namespace wg {

using namespace hopper;

constexpr int QROWS = 128;    // queries per block: two consumer warpgroups of 64
constexpr int KT = 64;        // keys per streamed tile
constexpr int THREADS = 384;  // producer warpgroup + two consumer warpgroups
constexpr int STAGES = 4;     // K/V tiles in flight

// Shared-memory geometry for a head dimension padded to DP (a multiple of
// 16): NB boxes of 64 columns per row (zeros past d), so dQ runs DPAD = 64 NB
// columns.
template <int DP>
struct Geo {
  static constexpr int NB = (DP + 63) / 64;
  static constexpr int DPAD = 64 * NB;
  static constexpr int QBOX = 64 * 128;       // one box of a warpgroup's 64 Q or dO rows
  static constexpr int KBOX = KT * 128;       // one box of a K or V tile
  static constexpr int STAGE = 2 * NB * KBOX;  // NB boxes of K, then NB of V
};

template <int DP>
constexpr int smem_bytes() {
  using G = Geo<DP>;
  return 1024 + 4 * G::NB * G::QBOX + STAGES * G::STAGE + (2 * STAGES + 1) * 8;
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq, int n, int d,
                    float scale_log2, float inv_scale) {
  using G = Geo<DP>;
  constexpr int NB = G::NB, DPAD = G::DPAD, NA = DPAD / 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* qs = smem;                        // warpgroup w's box b at (w NB + b) QBOX
  unsigned char* dos = qs + 2 * NB * G::QBOX;      // the same for dO
  unsigned char* stages = dos + 2 * NB * G::QBOX;  // stage s at s STAGE
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
      mbar_arrive_tx(qbar, 2 * nwg * NB * G::QBOX);
      for (int w = 0; w < nwg; ++w)
        for (int b = 0; b < NB; ++b) {
          tma_load_3d(qs + (w * NB + b) * G::QBOX, &tq, qbar, 64 * b, q0 + 64 * w, bh);
          tma_load_3d(dos + (w * NB + b) * G::QBOX, &tdo, qbar, 64 * b, q0 + 64 * w, bh);
        }
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
  // this thread's rows 16 wr + g + 8 h: LSE in log2 units (+inf past n) and delta
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + 64 * w + 16 * wr + g + 8 * h;
    lse2[h] = row < n ? lse[(long)bh * n + row] * LOG2E : INFINITY;
    dl[h] = row < n ? delta[(long)bh * n + row] : 0.f;
  }
  const unsigned char* qw = qs + w * NB * G::QBOX;
  const unsigned char* dw = dos + w * NB * G::QBOX;
  float qa[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) qa[i] = 0.f;
  mbar_wait(qbar, 0);

  for (int kt = 0; kt < ntiles; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(&full[s], (kt / STAGES) & 1);
    const unsigned char* ks = stages + s * G::STAGE;
    const unsigned char* vs = ks + NB * G::KBOX;
    // S = Q K^T and dP = dO V^T (64 queries x 64 keys; all K-major), one
    // wgmma group each, the first step overwriting the accumulators
    float sa[32], pa[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss64<0, 0>(sa, desc_sw128(qw + (kk >> 2) * G::QBOX + (kk & 3) * 32, 16, 1024),
                       desc_sw128(ks + (kk >> 2) * G::KBOX + (kk & 3) * 32, 16, 1024), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss64<0, 0>(pa, desc_sw128(dw + (kk >> 2) * G::QBOX + (kk & 3) * 32, 16, 1024),
                       desc_sw128(vs + (kk >> 2) * G::KBOX + (kk & 3) * 32, 16, 1024), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // S
    fence_regs(sa);
    // P in place: this thread holds rows 16 wr + g + 8 (e >> 1), keys
    // 8 j + 2 t + (e & 1) of the tile
    const bool edge = (kt + 1) * KT > n;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(fmaf(sa[4 * j + e], scale_log2, -lse2[e >> 1]));
        sa[4 * j + e] = edge && kt * KT + 8 * j + 2 * t + (e & 1) >= n ? 0.f : p;
      }
    wgmma_wait<0>();  // dP
    fence_regs(pa);
    // dS = P * (dP - delta) in place, then bf16 A fragments, 16 keys a step
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) pa[4 * j + e] = sa[4 * j + e] * (pa[4 * j + e] - dl[e >> 1]);
    uint32_t df[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) df[kk][r] = pack_bf16(pa[8 * kk + 2 * r], pa[8 * kk + 2 * r + 1]);
    // dQ += dS K (B: K MN-major)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<DPAD, 1>(qa, df[kk], desc_sw128(ks + kk * 2048, G::KBOX, 1024));
    wgmma_commit();
    // the products retire within the tile: then the stage is free
    wgmma_wait<0>();
    fence_regs(qa);
    fence_frags(df);
    if (ct == 0) mbar_arrive(&empty[s]);
  }

  // dQ = inv_scale dS K, bf16, rows < n and columns < d
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + 64 * w + 16 * wr + g + 8 * h;
    if (row >= n) continue;
    bf16* dst = dq + ((long)bh * n + row) * d;
#pragma unroll
    for (int j = 0; j < DPAD / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (col < d)
        *reinterpret_cast<uint32_t*>(dst + col) =
            pack_bf16(qa[4 * j + 2 * h] * inv_scale, qa[4 * j + 2 * h + 1] * inv_scale);
    }
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* dq, int bh, int n, int d, float inv_scale,
           cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  const uint64_t dims[3] = {(uint64_t)d, (uint64_t)n, (uint64_t)bh};
  const uint64_t strides[2] = {(uint64_t)d * 2, (uint64_t)n * d * 2};
  const uint32_t qbox[3] = {64, 64, 1}, kbox[3] = {64, KT, 1};
  int err = make_tmap_bf16(&tq, q, 3, dims, strides, qbox);
  if (!err) err = make_tmap_bf16(&tdo, dout, 3, dims, strides, qbox);
  if (!err) err = make_tmap_bf16(&tk, k, 3, dims, strides, kbox);
  if (!err) err = make_tmap_bf16(&tv, v, 3, dims, strides, kbox);
  if (err) return err;
  constexpr int smem = smem_bytes<DP>();
  cudaFuncSetAttribute(flash_bwd_dq_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  const dim3 grid((n + QROWS - 1) / QROWS, bh);
  flash_bwd_dq_kernel<DP><<<grid, THREADS, smem, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), n, d, inv_scale * LOG2E, inv_scale);
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
             const void* delta, void* dq, int bh, int n, int d, float inv_scale, cudaStream_t s) {
  switch ((d + 15) / 16) {
    case 1: return launch<16>(q, k, v, dout, lse, delta, dq, bh, n, d, inv_scale, s);
    case 2: return launch<32>(q, k, v, dout, lse, delta, dq, bh, n, d, inv_scale, s);
    case 3: return launch<48>(q, k, v, dout, lse, delta, dq, bh, n, d, inv_scale, s);
    case 4: return launch<64>(q, k, v, dout, lse, delta, dq, bh, n, d, inv_scale, s);
    case 5: return launch<80>(q, k, v, dout, lse, delta, dq, bh, n, d, inv_scale, s);
    case 6: return launch<96>(q, k, v, dout, lse, delta, dq, bh, n, d, inv_scale, s);
    case 7: return launch<112>(q, k, v, dout, lse, delta, dq, bh, n, d, inv_scale, s);
    case 8: return launch<128>(q, k, v, dout, lse, delta, dq, bh, n, d, inv_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace wg

}  // namespace

// q, k, v, dout: (bh, n, d) bf16, contiguous; `dot`: 16-byte aligned, d a
// multiple of 8 and at most 128; `l2`: 8-byte aligned, d a multiple of 4 and
// at most 128, `grid` the persistent blocks (ops/attention.l2_grid).  lse
// (natural log) and delta: (bh, n) f32.  dq: (bh, n, d) bf16.  inv_scale
// multiplies q.k (`dot`) or the distance; mode 0 `dot`, 1 `l2`.
extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dq, int bh, int n,
                                 int d, float inv_scale, int mode, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kDot:
      if (d % 8 != 0) return (int)cudaErrorInvalidValue;
      return wg::dispatch(q, k, v, dout, lse, delta, dq, bh, n, d, inv_scale, s);
    case kL2:
      return l2::dispatch<l2::kDq>(q, k, v, dout, lse, delta, dq, nullptr, nullptr, nullptr,
                                   nullptr, bh, n, d, inv_scale, grid, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
