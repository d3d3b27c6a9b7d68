// Saved-residual megablock backward, LN1 half, for Hopper (sm_90a).
//
// Replaces the end of `_bwd_kernel` in vitgan_tpu/ops/fused_block.py
// (lines 616-628; pallas_call at :700): from dqkv (the flash backward's dq,
// dk, dv in the (rows, 3*H*Dh) column order of `_pad_params`), per 64-row tile
//     dy1 = dqkv . wqkv^T                            (K = 3*H*Dh)
//     dx  = dx1 + LN1^T(dy1)                         (LN1 statistics from x)
// with y1 = LN1(x) written in bf16 for wgrad_gemm.cu (dwqkv = y1^T . dqkv, the
// operand the TPU kernel forms in its body) and per-tile column partials of
// dln1.scale = sum dy1 * yhat1 and dln1.bias = sum dy1 for a deterministic
// second-pass sum.
//
// Design.  As ln_mlp_fwd.cu's out-projection prologue: one block of 8 warps
// per 64-row tile, each warp 16 rows by half the E columns of f32
// accumulators in registers; K is walked in 64-wide chunks of dqkv and wqkv,
// two in flight by cp.async (mma.sync m16n8k16, ldmatrix operands).  dy1 is
// staged in f32 for the row phase (one warp per row).  E <= 384 and a
// multiple of 8; K a multiple of 8.
//
// Bound on this card.  At D's shape (65,600 rows, E 384, K 1,152) a launch
// does 2*M*E*K = 5.8e10 flops (0.06 ms) on 151 MB of dqkv, 50 MB of x,
// 101 MB of dx1 in and 50 MB of dx out (0.11 ms): HBM bounds it.
#include "common.cuh"

using namespace vk;

namespace {

constexpr int BM = 64;     // rows per block
constexpr int BK = 64;     // K chunk
constexpr int NWARP = 8;   // 4 row groups x 2 column halves
constexpr int MAXNT = 24;  // ep <= 384
constexpr int MAXC = 12;   // row-phase elements per lane

struct Ln1Smem {
  int lda, ldb, ldst;
  size_t a_size, b_off, b_size, red_off, bytes;
  __host__ __device__ explicit Ln1Smem(int ep) {
    lda = BK + 8;  // bf16 dqkv chunk, BM x BK, two buffers
    ldb = BK + 8;  // bf16 wqkv chunk, ep x BK, two buffers | f32 dy1, BM x ep
    ldst = ep + 4;
    a_size = (size_t)BM * lda * 2;
    b_off = 2 * a_size;
    b_size = (size_t)ep * ldb * 2;
    const size_t st = (size_t)BM * ldst * 4;
    red_off = b_off + (2 * b_size > st ? 2 * b_size : st);
    bytes = red_off + (size_t)2 * NWARP * ep * 4;  // warp partials of dln1
  }
};

__global__ void __launch_bounds__(NWARP * 32)
megablock_bwd_ln1_kernel(const bf16* __restrict__ dqkv, const bf16* __restrict__ wqkv,
                         const bf16* __restrict__ x, const float* __restrict__ dx1,
                         const float* __restrict__ ln_s, const float* __restrict__ ln_b,
                         bf16* __restrict__ dx_out, bf16* __restrict__ y1_out,
                         float* __restrict__ part_out, int m,
                         int e, int ep, int k, float eps) {
  const Ln1Smem L(ep);
  extern __shared__ __align__(128) unsigned char smem[];
  auto a_buf = [&](int s) { return reinterpret_cast<bf16*>(smem + s * L.a_size); };
  auto b_buf = [&](int s) { return reinterpret_cast<bf16*>(smem + L.b_off + s * L.b_size); };
  float* st = reinterpret_cast<float*>(smem + L.b_off);
  float* red = reinterpret_cast<float*>(smem + L.red_off);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * BM;
  const int rg = (warp & 3) * 16;
  const int cbase = (warp >> 2) * (ep / 2);
  const int nt = ep / 16;

  float acc[MAXNT][4];
#pragma unroll
  for (int j = 0; j < MAXNT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  // 1. dy1 = dqkv . wqkv^T over K chunks, two in flight.
  const int nk = (k + BK - 1) / BK;
  auto issue = [&](int c, int s) {
    cp_tile(a_buf(s), L.lda, dqkv, k, row0, c * BK, BM, BK, m, k);
    cp_tile(b_buf(s), L.ldb, wqkv, k, 0, c * BK, ep, BK, e, k);
  };
  issue(0, 0);
  cp_async_commit();
  for (int c = 0; c < nk; ++c) {
    if (c + 1 < nk) issue(c + 1, (c + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* as = a_buf(c & 1);
    const bf16* bs = b_buf(c & 1);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      load_a(a, as, L.lda, rg, kk * 16);
#pragma unroll
      for (int j = 0; j < MAXNT; j += 2) {
        if (j < nt) {
          uint32_t b[4];
          load_b_nk(b, bs, L.ldb, kk * 16, cbase + j * 8);
          mma16816(acc[j], a, b[0], b[1]);
          mma16816(acc[j + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // buffers c & 1 are free for chunk c + 2
  }
  cp_async_wait<0>();

  // 2. dy1 to shared memory in f32 (over the wqkv buffers).
#pragma unroll
  for (int j = 0; j < MAXNT; ++j) {
    if (j < nt) {
      const int col = cbase + j * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(st + (rg + g + 8 * h) * L.ldst + col) =
            make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
    }
  }
  __syncthreads();

  // 3. Row phase, one warp per row: dx = dx1 + rstd * (t - mean(t) - yhat *
  //    mean(t * yhat)), t = dy1 * gamma1 (_ln_bwd, fused_block.py:464-470).
  float ps[MAXC], pb[MAXC];
#pragma unroll
  for (int i = 0; i < MAXC; ++i) ps[i] = pb[i] = 0.f;
  for (int r = warp; r < BM; r += NWARP) {
    const int gr = row0 + r;
    if (gr >= m) continue;
    float v[MAXC], dy[MAXC];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < MAXC; ++i) {
      const int c = lane + 32 * i;
      v[i] = c < e ? __bfloat162float(x[(long)gr * e + c]) : 0.f;
      dy[i] = c < e ? st[r * L.ldst + c] : 0.f;
      s += v[i];
    }
    const float mean = warp_sum(s) / e;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < MAXC; ++i) {
      const int c = lane + 32 * i;
      const float d = c < e ? v[i] - mean : 0.f;
      q += d * d;
    }
    const float rstd = rsqrtf(warp_sum(q) / e + eps);
    float st_ = 0.f, sty = 0.f;
#pragma unroll
    for (int i = 0; i < MAXC; ++i) {
      const int c = lane + 32 * i;
      v[i] = c < e ? (v[i] - mean) * rstd : 0.f;
      const float tt = c < e ? dy[i] * ln_s[c] : 0.f;
      st_ += tt;
      sty += tt * v[i];
      ps[i] += dy[i] * v[i];
      pb[i] += dy[i];
    }
    const float mt = warp_sum(st_) / e, mty = warp_sum(sty) / e;
#pragma unroll
    for (int i = 0; i < MAXC; ++i) {
      const int c = lane + 32 * i;
      if (c < e) {
        const long o = (long)gr * e + c;
        dx_out[o] = __float2bfloat16(dx1[o] + (dy[i] * ln_s[c] - mt - v[i] * mty) * rstd);
        y1_out[o] = __float2bfloat16(v[i] * ln_s[c] + ln_b[c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < MAXC; ++i) {
    const int c = lane + 32 * i;
    if (c < ep) {
      red[(2 * warp) * ep + c] = ps[i];
      red[(2 * warp + 1) * ep + c] = pb[i];
    }
  }
  __syncthreads();
  for (int c2 = tid; c2 < 2 * e; c2 += NWARP * 32) {
    const int half = c2 < e ? 0 : 1, c = c2 - half * e;
    float s = 0.f;
    for (int w = 0; w < NWARP; ++w) s += red[(2 * w + half) * ep + c];
    part_out[(long)blockIdx.x * 2 * e + c2] = s;
  }
}

}  // namespace

// dqkv: (m, k) bf16, k = 3*H*Dh in _pad_params column order; wqkv: (e, k)
// bf16; x: (m, e) bf16; dx1: (m, e) f32; ln_s, ln_b: (e,) f32.  Out: dx and
// y1 = LN1(x) (m, e) bf16, part (ceil(m / 64), 2*e) f32 (dln1.scale then
// dln1.bias partials).  bf16 bases 16-byte aligned; e, k multiples of 8;
// e <= 384.
extern "C" int megablock_bwd_ln1(const void* dqkv, const void* wqkv, const void* x,
                                 const void* dx1, const void* ln_s, const void* ln_b, void* dx,
                                 void* y1, void* part, int m, int e, int k, float eps,
                                 void* stream) {
  const int ep = ceil_to(e, 32);
  if (ep / 16 > MAXNT || e % 8 || k % 8) return (int)cudaErrorInvalidValue;
  const Ln1Smem L(ep);
  cudaFuncSetAttribute(megablock_bwd_ln1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)L.bytes);
  megablock_bwd_ln1_kernel<<<(m + BM - 1) / BM, NWARP * 32, L.bytes,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(dqkv), static_cast<const bf16*>(wqkv),
      static_cast<const bf16*>(x), static_cast<const float*>(dx1),
      static_cast<const float*>(ln_s), static_cast<const float*>(ln_b), static_cast<bf16*>(dx),
      static_cast<bf16*>(y1), static_cast<float*>(part), m, e, ep, k, eps);
  return (int)cudaGetLastError();
}
