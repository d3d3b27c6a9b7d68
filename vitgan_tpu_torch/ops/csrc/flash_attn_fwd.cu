// Flash-attention forward, `dot`, `l2` and `l2ref` scores, for Hopper (sm_90a).
//
// Replaces the TPU kernels `_flash_kernel` / `_flash_forward`
// (vitgan_tpu/ops/attention.py:64-105, 232-278) and their K/V-streaming
// variant `_flash_kernel_dma` (attention.py:108-169): here K/V always stream
// through shared memory one tile at a time, at any length.
//
// Computes, per (batch*head, query):  O = softmax(S) v  and LSE = m + log(l),
// the f32 log-sum-exp of S the backward kernels will read, with the score
// mode a template parameter (common.cuh): S = inv_scale q.k^T (`dot`),
// -inv_scale d2 (`l2`) or inv_scale sqrt(d2 + 1e-12) (`l2ref`), d2 =
// max(|q|^2 + |k|^2 - 2 q.k^T, 0) formed on the f32 S accumulators.  |q|^2 of
// the warp's rows comes from the resident Q tile once; |k|^2 of each streamed
// K tile from its shared-memory copy, into a 64-float array, behind a second
// barrier (the `l2` modes only).  The `dot` instantiation forms no norms.
//
// Design.  One block of 8 warps per (128-query tile, batch*head); each warp
// owns 16 query rows.  Every block streams all of its head's K/V from L2, so
// the query tile is as tall as the registers allow two blocks per SM (at
// 1,024 tokens the blocks read 0.8 GB of K/V from L2 per launch).  The Q
// fragments stay in registers; 64-key K/V tiles stream through a two-stage
// cp.async ring, the next tile's copy in flight while the current one is
// used.  S = Q K^T and O += P V run on the tensor cores (mma.sync m16n8k16,
// bf16 operands, f32 accumulation) with operands fetched by ldmatrix.  The
// online softmax works on the S accumulators in registers, in f32 and in
// log2 units (exp2 with log2(e) folded into the scale); keys past n are
// masked.  p is cast to bf16 before P.V, as attention.py:93 does, while the
// row sums l add the f32 p, as there.  The head dimension is padded to a
// multiple of 16 in shared memory only (zero-filled copies), never in device
// memory: no padding to 128 as on the TPU.  Dh must be a multiple of 8
// (16-byte copies): the wrapper (ops/attention.flash_forward) zero-pads
// other widths, as the v1 discriminator's 108, to one (112) in device memory
// and slices O back; zero columns change no score of any mode.
//
// Bound on this card.  At the serving shape (64*6 heads, 1,024 tokens,
// Dh 64) a launch does 4*384*1024^2*64 = 1.03e11 flops on 201 MB of
// q/k/v/o: 0.10 ms of tensor-core time against 0.06 ms of HBM time, so the
// tensor cores bound it.  mma.sync reaches only part of the wgmma rate;
// wgmma with TMA and warp specialisation is later work.  At the v1
// discriminator's `l2` shape (128*2*4 heads, 50 tokens, Dh 108) a launch
// moves 44 MB of q/k/v/o for 1.1e9 flops: 0.013 ms of HBM time against
// 0.001 ms of tensor-core time, so the bytes bound it there, and a
// 128-query block holds 50 real rows.
#include "common.cuh"

using namespace vk;

namespace {

constexpr int BQ = 128;    // queries per block
constexpr int BK = 64;     // keys per streamed tile
constexpr int NWARP = 8;   // 16 query rows per warp

template <int DP, int MODE>
constexpr size_t smem_bytes() {
  // Q + two stages of K and V (+ |k|^2 of the current K tile)
  return (size_t)(BQ + 4 * BK) * (DP + 8) * 2 + (MODE != kDot ? BK * sizeof(float) : 0);
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
  float* kk_s = reinterpret_cast<float*>(vs + 2 * BK * LD);  // l2 modes: |k|^2 of the tile

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
  float qq[2] = {0.f, 0.f};         // l2 modes: |q|^2 of rows g and g+8

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
      if constexpr (MODE != kDot) frag_row_sq_norms<DP>(qq, qs, LD, warp * 16);
    }
    const bf16* kt_s = ks + cur * BK * LD;
    const bf16* vt_s = vs + cur * BK * LD;
    if constexpr (MODE != kDot) {
      // every warp is past tile kt - 1's reads of kk_s (the barrier above)
      row_sq_norms<DP>(kk_s, kt_s, LD, BK);
      __syncthreads();
    }

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
        const float val = key < n ? score_log2<MODE>(s[j][e], qq[e >> 1],
                                                     MODE != kDot ? kk_s[col] : 0.f, scale_log2)
                                  : -INFINITY;
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
    case kDot: return dispatch<kDot>(q, k, v, o, lse, bh, n, d, heads, sl, out_bnhd, s);
    case kL2: return dispatch<kL2>(q, k, v, o, lse, bh, n, d, heads, sl, out_bnhd, s);
    case kL2Ref: return dispatch<kL2Ref>(q, k, v, o, lse, bh, n, d, heads, sl, out_bnhd, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
