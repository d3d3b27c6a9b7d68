// Saved-residual megablock backward, MLP half and out-projection, for Hopper
// (sm_90a).
//
// Replaces the first half of `_bwd_kernel` in vitgan_tpu/ops/fused_block.py
// (lines 484-628, entered through `fused_encoder_block_bwd`, pallas_call at
// :700): from the output cotangent g and the forward's saved residuals x1, z1,
// ao (and the dropout masks m1, m2), per 64-row tile:
//     dmlp = g * m2
//     dz1  = (dmlp . w2^T) * gelu'(z1)              (hidden walked in 64-chunks)
//     dy2  = dz1 . w1^T                              (accumulated in registers)
//     dx1  = g + LN2^T(dy2)                          (LN2 statistics recomputed)
//     da   = dx1 * m1
//     dao  = da . wout^T, delta = rowsum(dao * ao) per head
// dao goes out in the (B, H, N, Dh) layout the flash backward kernels read,
// with delta, their `_delta` (attention.py:640, _bwd_kernel :602).  dmlp (with
// dropout), dz1 and da go out in bf16 for the weight-gradient kernel
// (wgrad_gemm.cu), with the other operands of its products as the TPU kernel
// forms them in its body: h1 = gelu(z1) and y2 = LN2(x1), in bf16.  dx1 goes
// out in f32 for megablock_bwd_ln1.cu, and per-tile column partials of
// dln2.scale = sum dy2 * yhat2 and dln2.bias = sum dy2 for a deterministic
// second-pass sum.  The TPU kernel accumulates the weight
// gradients in its sequential grid; Hopper blocks run in no order, so they go
// to wgrad_gemm.cu instead.
//
// Design.  One block of 8 warps per 64-row tile, as ln_mlp_fwd.cu: each warp
// owns 16 rows by half the E columns of the dy2 accumulators.  Per 64-wide
// hidden chunk, dh1 is formed on the tensor cores (mma.sync m16n8k16,
// ldmatrix operands; w2's chunk double-buffered by cp.async), multiplied by
// gelu'(z1) (exact erf GELU, the forward's) and passed through shared memory
// as bf16 into dy2 += dz1 . w1[:, chunk]^T.  dy2 is then staged in f32 for
// the row phase (one warp per row: LN2 backward, masks, stores); da comes
// back as bf16 for dao, whose chunks are staged in f32 for the per-head
// delta.  E <= 384, E, hidden and H*Dh multiples of 8.
//
// Bound on this card.  At G's shape (32,768 rows, E 384, hidden 1,536, H*Dh
// 384) a launch does 2*M*(2*E*hidden + E*HD) = 9.7e10 flops (0.10 ms) and
// moves g, x1, z1, ao, two f32 masks in and dmlp, dz1, h1, y2, dx1, da, dao
// out, about 0.5 GB (0.15 ms): HBM bounds it.
#include "common.cuh"

using namespace vk;

namespace {

constexpr int BM = 64;     // rows per block
constexpr int BH = 64;     // hidden (and out-projection) chunk
constexpr int NWARP = 8;   // 4 row groups x 2 column halves
constexpr int MAXNT = 24;  // 8-column accumulator tiles per warp: ep <= 384
constexpr int MAXC = 12;   // row-phase elements per lane: ep <= 384

__host__ __device__ inline size_t max3(size_t a, size_t b, size_t c) {
  return a > b ? (a > c ? a : c) : (b > c ? b : c);
}

struct BwdSmem {
  int lda, ldw1, ldw2, ldh, ldst, ldo;
  size_t r1_off, r2_off, r3_off, w2_size, bytes;
  __host__ __device__ BwdSmem(int ep, int hdp) {
    lda = ep + 8;   // R0: bf16 dmlp tile, later the da tile, BM x ep
    ldw2 = ep + 8;  // R1: bf16 w2 chunk, BH x ep, two buffers | f32 dy2 | f32 dao
    ldst = ep + 4;  //     f32 dy2, BM x ep
    ldo = hdp + 4;  //     f32 dao, BM x hdp
    ldw1 = BH + 8;  // R2: bf16 w1 chunk, ep x BH | wout chunk BH x ep | warp partials
    ldh = BH + 8;   // R3: bf16 dz1 chunk, BM x BH
    w2_size = (size_t)BH * ldw2 * 2;
    r1_off = (size_t)BM * lda * 2;
    r2_off = r1_off + max3(2 * w2_size, (size_t)BM * ldst * 4, (size_t)BM * ldo * 4);
    r3_off = r2_off + max3((size_t)ep * ldw1 * 2, w2_size, (size_t)2 * NWARP * ep * 4);
    bytes = r3_off + (size_t)BM * ldh * 2;
  }
};

__global__ void __launch_bounds__(NWARP * 32)
megablock_bwd_mlp_kernel(const bf16* __restrict__ gout, const float* __restrict__ m1,
                         const float* __restrict__ m2, const bf16* __restrict__ x1,
                         const bf16* __restrict__ z1, const bf16* __restrict__ ao,
                         const bf16* __restrict__ w1, const bf16* __restrict__ w2,
                         const bf16* __restrict__ wout, const float* __restrict__ ln_s,
                         const float* __restrict__ ln_b, bf16* __restrict__ dmlp_out,
                         bf16* __restrict__ dz1_out, bf16* __restrict__ h1_out,
                         bf16* __restrict__ y2_out, float* __restrict__ dx1_out,
                         bf16* __restrict__ da_out, bf16* __restrict__ dao_out,
                         float* __restrict__ delta_out, float* __restrict__ part_out, int batch,
                         int n, int e, int ep, int heads, int dh, int hidden, float eps) {
  const int m = batch * n, hd = heads * dh, hdp = ceil_to(hd, BH);
  const BwdSmem L(ep, hdp);
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* as = reinterpret_cast<bf16*>(smem);
  float* st = reinterpret_cast<float*>(smem + L.r1_off);  // dy2, later dao
  bf16* w1s = reinterpret_cast<bf16*>(smem + L.r2_off);
  bf16* wos = w1s;                                         // wout chunk
  float* red = reinterpret_cast<float*>(smem + L.r2_off);  // warp partials
  bf16* hs = reinterpret_cast<bf16*>(smem + L.r3_off);
  auto w2_buf = [&](int s) { return reinterpret_cast<bf16*>(smem + L.r1_off + s * L.w2_size); };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * BM;
  const int rg = (warp & 3) * 16;            // this warp's 16 rows
  const int cbase = (warp >> 2) * (ep / 2);  // its half of the E columns
  const int hcol = (warp >> 2) * 32;         // its 32 columns of a 64-wide chunk
  const int nt = ep / 16;

  // 1. The g tile and w2's first chunk arrive by cp.async; dmlp = g * m2.
  cp_tile(as, L.lda, gout, e, row0, 0, BM, ep, m, e);
  cp_tile(w2_buf(0), L.ldw2, w2, e, 0, 0, BH, ep, hidden, e);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (m2 != nullptr) {
    for (int i = tid; i < BM * (ep / 2); i += NWARP * 32) {
      const int r = i / (ep / 2), c = 2 * (i - r * (ep / 2)), gr = row0 + r;
      if (gr < m && c < e) {
        __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(as + r * L.lda + c);
        const float2 gv = __bfloat1622float2(*p);
        const float2 mk = *reinterpret_cast<const float2*>(m2 + (long)gr * e + c);
        const uint32_t v = pack_bf16(gv.x * mk.x, gv.y * mk.y);
        *reinterpret_cast<uint32_t*>(p) = v;
        *reinterpret_cast<uint32_t*>(dmlp_out + (long)gr * e + c) = v;
      }
    }
  }

  float acc[MAXNT][4];
#pragma unroll
  for (int j = 0; j < MAXNT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  // 2. Over 64-wide hidden chunks c: dz1 = (dmlp . w2[c, :]^T) * gelu'(z1[:, c])
  //    and dy2 += dz1 . w1[:, c]^T.  Two block barriers a chunk: after the
  //    first, w2 chunk c has landed and every warp is done with chunk c - 1,
  //    so w1's buffer, hs and w2's other buffer may be refilled.
  const int nch = (hidden + BH - 1) / BH;
  for (int c = 0; c < nch; ++c) {
    cp_async_wait<0>();
    __syncthreads();
    cp_tile(w1s, L.ldw1, w1, hidden, 0, c * BH, ep, BH, e, hidden);
    cp_async_commit();
    if (c + 1 < nch) cp_tile(w2_buf((c + 1) & 1), L.ldw2, w2, e, (c + 1) * BH, 0, BH, ep, hidden, e);
    cp_async_commit();
    float hacc[4][4] = {};
    const bf16* w2s = w2_buf(c & 1);
#pragma unroll 2
    for (int kk = 0; kk < ep / 16; ++kk) {
      uint32_t a[4], b[4], b2v[4];
      load_a(a, as, L.lda, rg, kk * 16);
      load_b_nk(b, w2s, L.ldw2, kk * 16, hcol);
      load_b_nk(b2v, w2s, L.ldw2, kk * 16, hcol + 16);
      mma16816(hacc[0], a, b[0], b[1]);
      mma16816(hacc[1], a, b[2], b[3]);
      mma16816(hacc[2], a, b2v[0], b2v[1]);
      mma16816(hacc[3], a, b2v[2], b2v[3]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = hcol + j * 8 + 2 * t, gc = c * BH + col;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = rg + g + 8 * h, gr = row0 + r;
        uint32_t v = 0u;
        if (gr < m && gc < hidden) {
          const float2 z = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(z1 + (long)gr * hidden + gc));
          v = pack_bf16(hacc[j][2 * h] * gelu_grad(z.x), hacc[j][2 * h + 1] * gelu_grad(z.y));
          *reinterpret_cast<uint32_t*>(dz1_out + (long)gr * hidden + gc) = v;
          *reinterpret_cast<uint32_t*>(h1_out + (long)gr * hidden + gc) =
              pack_bf16(gelu(z.x), gelu(z.y));
        }
        *reinterpret_cast<uint32_t*>(hs + r * L.ldh + col) = v;
      }
    }
    cp_async_wait<1>();  // w1 chunk c has landed
    __syncthreads();     // and the whole dz1 chunk is in hs
#pragma unroll
    for (int kk = 0; kk < BH / 16; ++kk) {
      uint32_t a[4];
      load_a(a, hs, L.ldh, rg, kk * 16);
#pragma unroll
      for (int j = 0; j < MAXNT; j += 2) {
        if (j < nt) {
          uint32_t b[4];
          load_b_nk(b, w1s, L.ldw1, kk * 16, cbase + j * 8);
          mma16816(acc[j], a, b[0], b[1]);
          mma16816(acc[j + 1], a, b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the w1 and w2 buffers

  // 3. dy2 to shared memory in f32 (over the w2 buffers).
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

  // 4. Row phase, one warp per row: LN2's statistics from x1, then
  //    dx1 = g + rstd * (t - mean(t) - yhat * mean(t * yhat)), t = dy2 * gamma2
  //    (_ln_bwd, fused_block.py:464-470); da = dx1 * m1.
  float ps[MAXC], pb[MAXC];
#pragma unroll
  for (int i = 0; i < MAXC; ++i) ps[i] = pb[i] = 0.f;
  for (int r = warp; r < BM; r += NWARP) {
    const int gr = row0 + r;
    if (gr >= m) {
#pragma unroll
      for (int i = 0; i < MAXC; ++i) {
        const int c = lane + 32 * i;
        if (c < ep) as[r * L.lda + c] = __float2bfloat16(0.f);
      }
      continue;
    }
    float v[MAXC], dy[MAXC];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < MAXC; ++i) {
      const int c = lane + 32 * i;
      v[i] = c < e ? __bfloat162float(x1[(long)gr * e + c]) : 0.f;
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
      v[i] = c < e ? (v[i] - mean) * rstd : 0.f;  // yhat
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
      if (c >= ep) continue;
      float da = 0.f;
      if (c < e) {
        const long o = (long)gr * e + c;
        const float dx1 = __bfloat162float(gout[o]) + (dy[i] * ln_s[c] - mt - v[i] * mty) * rstd;
        dx1_out[o] = dx1;
        y2_out[o] = __float2bfloat16(v[i] * ln_s[c] + ln_b[c]);
        da = m1 != nullptr ? dx1 * m1[o] : dx1;
        da_out[o] = __float2bfloat16(da);
      }
      as[r * L.lda + c] = __float2bfloat16(da);
    }
  }
  // The block's column partials of dln2: warps' sums through shared memory.
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
  __syncthreads();  // the partials area takes wout's chunks next

  // 5. dao = da . wout^T over 64-wide chunks of H*Dh, staged in f32.
  for (int c = 0; c < hdp / BH; ++c) {
    cp_tile(wos, L.ldw2, wout, e, c * BH, 0, BH, ep, hd, e);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float hacc[4][4] = {};
#pragma unroll 2
    for (int kk = 0; kk < ep / 16; ++kk) {
      uint32_t a[4], b[4], b2v[4];
      load_a(a, as, L.lda, rg, kk * 16);
      load_b_nk(b, wos, L.ldw2, kk * 16, hcol);
      load_b_nk(b2v, wos, L.ldw2, kk * 16, hcol + 16);
      mma16816(hacc[0], a, b[0], b[1]);
      mma16816(hacc[1], a, b[2], b[3]);
      mma16816(hacc[2], a, b2v[0], b2v[1]);
      mma16816(hacc[3], a, b2v[2], b2v[3]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c * BH + hcol + j * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(st + (rg + g + 8 * h) * L.ldo + col) =
            make_float2(hacc[j][2 * h], hacc[j][2 * h + 1]);
    }
    __syncthreads();  // wout's buffer is free for the next chunk
  }

  // 6. Per row and head: delta = sum dao * ao (f32 dao, as the TPU kernel),
  //    and dao in bf16 to its (B, H, N, Dh) place.
  for (int r = warp; r < BM; r += NWARP) {
    const int gr = row0 + r;
    if (gr >= m) continue;
    const int bi = gr / n, tok = gr - bi * n;
    for (int hh = 0; hh < heads; ++hh) {
      float s = 0.f;
      const long base = (((long)bi * heads + hh) * n + tok) * dh;
      for (int d = lane; d < dh; d += 32) {
        const int col = hh * dh + d;
        const float v = st[r * L.ldo + col];
        s += v * __bfloat162float(ao[(long)gr * hd + col]);
        dao_out[base + d] = __float2bfloat16(v);
      }
      s = warp_sum(s);
      if (lane == 0) delta_out[((long)bi * heads + hh) * n + tok] = s;
    }
  }
}

}  // namespace

// g, x1: (batch*n, e) bf16; z1: (batch*n, hidden) bf16; ao: (batch*n, heads*dh)
// bf16; m1, m2: (batch*n, e) f32 or both NULL (no dropout; dmlp is g and is
// not written).  w1 (e, hidden), w2 (hidden, e), wout (heads*dh, e) bf16;
// ln_s, ln_b (e,) f32.  Out: dmlp (batch*n, e) bf16 (with dropout), dz1 and
// h1 = gelu(z1) like z1, y2 = LN2(x1) (batch*n, e) bf16, dx1 (batch*n, e) f32,
// da (batch*n, e) bf16, dao (batch, heads, n, dh) bf16, delta (batch, heads,
// n) f32, part (ceil(batch*n / 64), 2*e) f32 (dln2.scale then dln2.bias
// partials).  bf16
// bases 16-byte aligned; e, hidden, heads*dh multiples of 8; e <= 384.
extern "C" int megablock_bwd_mlp(const void* g, const void* m1, const void* m2, const void* x1,
                                 const void* z1, const void* ao, const void* w1, const void* w2,
                                 const void* wout, const void* ln_s, const void* ln_b,
                                 void* dmlp, void* dz1, void* h1, void* y2, void* dx1, void* da,
                                 void* dao, void* delta, void* part, int batch, int n, int e,
                                 int heads, int dh,
                                 int hidden, float eps, void* stream) {
  const int ep = ceil_to(e, 32), hd = heads * dh;
  if (ep / 16 > MAXNT || e % 8 || hidden % 8 || hd % 8 || (m1 == nullptr) != (m2 == nullptr) ||
      (m2 != nullptr && dmlp == nullptr))
    return (int)cudaErrorInvalidValue;
  const BwdSmem L(ep, ceil_to(hd, BH));
  if (L.bytes > 232448) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(megablock_bwd_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)L.bytes);
  const int m = batch * n;
  megablock_bwd_mlp_kernel<<<(m + BM - 1) / BM, NWARP * 32, L.bytes,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(g), static_cast<const float*>(m1), static_cast<const float*>(m2),
      static_cast<const bf16*>(x1), static_cast<const bf16*>(z1), static_cast<const bf16*>(ao),
      static_cast<const bf16*>(w1), static_cast<const bf16*>(w2), static_cast<const bf16*>(wout),
      static_cast<const float*>(ln_s), static_cast<const float*>(ln_b), static_cast<bf16*>(dmlp),
      static_cast<bf16*>(dz1), static_cast<bf16*>(h1), static_cast<bf16*>(y2),
      static_cast<float*>(dx1), static_cast<bf16*>(da), static_cast<bf16*>(dao),
      static_cast<float*>(delta), static_cast<float*>(part), batch, n, e, ep, heads, dh, hidden,
      eps);
  return (int)cudaGetLastError();
}
