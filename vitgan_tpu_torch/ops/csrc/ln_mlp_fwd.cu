// Fused LayerNorm -> fc1 -> GELU -> fc2 [+ residual] forward for Hopper
// (sm_90a), with an optional out-projection prologue.
//
// Replaces the TPU kernel `_kernel` / `_forward` of vitgan_tpu/ops/fused_mlp.py
// (lines 72-107, 110-150).  With the prologue it is the third of the three
// launches that replace the megablock `_kernel` of
// vitgan_tpu/ops/fused_block.py:93-211 (see ln_qkv_fwd.cu for the first):
//     x1  = x + attn . wout + bout        (kept on chip, in f32)
//     out = x1 + fc2(gelu(fc1(LN2(x1))))
// Without the prologue:  out = [x +] fc2(gelu(fc1(LN(x)))).
//
// Design.  One block of 8 warps per 64-row tile; each warp owns 16 rows by
// half the output columns, its f32 accumulators in registers.  The
// LayerNorm runs in f32 over the real width and leaves the normalised tile
// in shared memory as bf16.  The hidden width is walked in 64-column chunks:
// h = gelu(y . w1[:, c] + b1[c]) is formed on the tensor cores, passed
// through shared memory as bf16, and acc += h . w2[c, :] accumulates in
// registers (mma.sync m16n8k16 with ldmatrix operands, bf16 in, f32 out).
// The copies run ahead by cp.async: w1's chunk c+1 and w2's chunk c load
// while fc1 of chunk c runs (two w1 buffers, one w2 buffer: 64-wide chunks
// fit 227 KB no other way), and there are two block barriers a chunk.  The (rows, hidden) intermediate
// never reaches device memory, which is the point of the TPU kernel.  The
// residual (x, or x1 from the prologue) seeds the accumulators; the x tile
// arrives by cp.async, with the prologue while the out-projection runs.
// GELU is the exact erf form (see common.cuh).  E, hidden and H*Dh must be
// multiples of 8 (16-byte copies); E <= 384 (shared memory).
//
// Training instantiation (TRAIN = true; entry ln_mlp_train_fwd), the third
// launch of the TPU megablock's training forms (`_kernel` with rate > 0 and
// want_res, fused_block.py:111-123, 186-209):
//     a   = attn . wout + bout
//     x1  = x + m1 * a                    (written as bf16: a saved residual)
//     z1  = LN2(x1) . w1 + b1             (written as bf16 chunk by chunk)
//     out = x1 + m2 * (gelu(z1) . w2 + b2)
// m1 and m2 are f32 multiply-masks drawn in the kernel from Philox4x32-10
// (common.cuh) and written out, as the TPU kernel returns them; with no
// dropout they are 1 and not written.  The mask applies before the residual,
// so the accumulators start from zero and the epilogue adds x1, read back
// from this thread's own bf16 x1 stores.  The serving instantiation is
// unchanged: the template flag removes every training branch from it.
//
// Bound on this card.  At the serving shape (65,536 rows, E 384, hidden
// 1,536) a launch does 4*65536*384*1536 = 1.55e11 flops on 101 MB of
// activations and 2.4 MB of weights: 0.16 ms of tensor-core time against
// 0.03 ms of HBM time, so the tensor cores bound it.  The training form at
// G's 32,768 rows also writes z1 (101 MB), two f32 masks (101 MB) and x1:
// ~0.08 ms of HBM time against ~0.09 ms of tensor-core time.  Every 64-row block
// reads all the weights once from L2 (2.4 GB in all at this shape), which
// is the next limit after the tensor cores.  The prologue adds
// 2*65536*384*384 = 1.9e10 flops and 50 MB.
#include "common.cuh"

using namespace vk;

namespace {

constexpr int BM = 64;     // rows per block
constexpr int BH = 64;     // hidden (and prologue K) chunk
constexpr int NWARP = 8;   // 4 row groups x 2 column halves
constexpr int MAXNT = 24;  // 8-column accumulator tiles per warp: ep / 16 <= 24, ep <= 384

struct MlpSmem {
  int ldy, ldw1, ldw2, ldh, ldst;
  size_t w1_off, w1_size, w2_off, h_off, bytes;
  __host__ __device__ explicit MlpSmem(int ep) {
    ldy = ep + 8;   // bf16 LN output, BM x ep
    ldw1 = BH + 8;  // bf16 w1 chunk, ep x BH, two buffers
    ldw2 = ep + 8;  // bf16 w2 chunk, BH x ep, one buffer
    ldh = BH + 8;   // bf16 activation (or attn) chunk, BM x BH, two buffers
    ldst = ep + 4;  // f32 x1 for the LayerNorm, BM x ep: aliases the w1 buffers,
                    // as do the prologue's two wout chunks
    w1_off = (size_t)BM * ldy * 2;
    w1_size = (size_t)ep * ldw1 * 2;
    w2_off = w1_off + 2 * w1_size;
    h_off = w2_off + (size_t)BH * ldw2 * 2;
    bytes = h_off + 2 * (size_t)BM * ldh * 2;
  }
};

// The training instantiation's extra arguments; m1 == nullptr: no dropout.
struct TrainArgs {
  const long long* seed;
  float* m1;
  float* m2;
  bf16* x1;
  bf16* z1;
  uint32_t threshold;
  float inv_keep;
};

template <bool TRAIN>
__global__ void __launch_bounds__(NWARP * 32)
ln_mlp_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ attn,
                  const bf16* __restrict__ wout, const float* __restrict__ bout,
                  const float* __restrict__ ln_s, const float* __restrict__ ln_b,
                  const bf16* __restrict__ w1, const float* __restrict__ b1,
                  const bf16* __restrict__ w2, const float* __restrict__ b2,
                  bf16* __restrict__ out, int m, int e, int ep, int hd, int hidden, float eps,
                  int residual, TrainArgs tr) {
  const MlpSmem L(ep);
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ys = reinterpret_cast<bf16*>(smem);
  float* st = reinterpret_cast<float*>(smem + L.w1_off);
  bf16* w2s = reinterpret_cast<bf16*>(smem + L.w2_off);
  bf16* hs = reinterpret_cast<bf16*>(smem + L.h_off);
  auto w1_buf = [&](int s) { return reinterpret_cast<bf16*>(smem + L.w1_off + s * L.w1_size); };
  auto wout_buf = [&](int s) {  // BH x ep, in the w1 area
    return reinterpret_cast<bf16*>(smem + L.w1_off + (size_t)s * BH * L.ldw2 * 2);
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * BM;
  const int rg = (warp & 3) * 16;           // this warp's 16 rows
  const int cbase = (warp >> 2) * (ep / 2);  // and its half of the output columns
  const int nt = ep / 16;                   // its 8-column accumulator tiles
  const bool drop = TRAIN && tr.m1 != nullptr;
  const uint2 key = drop ? seed_key(tr.seed) : make_uint2(0u, 0u);

  float acc[MAXNT][4];
#pragma unroll
  for (int j = 0; j < MAXNT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  // acc += a_tile (BM x BH) . b_tile (BH x ep).
  auto acc_from = [&](const bf16* a_tile, const bf16* b_tile) {
#pragma unroll
    for (int kk = 0; kk < BH / 16; ++kk) {
      uint32_t a[4];
      load_a(a, a_tile, L.ldh, rg, kk * 16);
#pragma unroll
      for (int j = 0; j < MAXNT; j += 2) {
        if (j < nt) {
          uint32_t b[4];
          load_b_kn(b, b_tile, L.ldw2, kk * 16, cbase + j * 8);
          mma16816(acc[j], a, b[0], b[1]);
          mma16816(acc[j + 1], a, b[2], b[3]);
        }
      }
    }
  };

  // 1. The x tile lands in ys (bf16) by cp.async, ahead of everything else.
  cp_tile(ys, L.ldy, x, e, row0, 0, BM, ep, m, e);
  if (attn != nullptr) {
    // acc = attn . wout over BH-wide chunks, two in flight; then
    // x1 = acc + bout + x stays in the accumulators (the residual) and goes
    // to the staging area for the LayerNorm.
    const int nk = (hd + BH - 1) / BH;
    auto issue = [&](int c, int s) {
      cp_tile(hs + s * BM * L.ldh, L.ldh, attn, hd, row0, c * BH, BM, BH, m, hd);
      cp_tile(wout_buf(s), L.ldw2, wout, e, c * BH, 0, BH, ep, hd, e);
    };
    issue(0, 0);
    cp_async_commit();
    for (int c = 0; c < nk; ++c) {
      if (c + 1 < nk) issue(c + 1, (c + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      acc_from(hs + (c & 1) * BM * L.ldh, wout_buf(c & 1));
      __syncthreads();  // buffers c & 1 are free for chunk c + 2
    }
#pragma unroll
    for (int j = 0; j < MAXNT; ++j) {
      if (j < nt) {
        const int col = cbase + j * 8 + 2 * t;
        const float bias0 = col < e ? bout[col] : 0.f, bias1 = col < e ? bout[col + 1] : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = rg + g + 8 * h;
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(ys + r * L.ldy + col));
          if constexpr (TRAIN) {
            // x1 = x + m1 * a; the MLP then accumulates from zero
            const int gr = row0 + r;
            const bool ok = gr < m && col < e;
            float a0 = acc[j][2 * h] + bias0, a1 = acc[j][2 * h + 1] + bias1;
            if (drop) {
              const float2 mk =
                  dropout_pair(key, 0u, (long long)gr * e + col, tr.threshold, tr.inv_keep);
              a0 *= mk.x;
              a1 *= mk.y;
              if (ok) *reinterpret_cast<float2*>(tr.m1 + (long)gr * e + col) = mk;
            }
            const float v0 = xv.x + a0, v1 = xv.y + a1;
            if (ok) *reinterpret_cast<uint32_t*>(tr.x1 + (long)gr * e + col) = pack_bf16(v0, v1);
            *reinterpret_cast<float2*>(st + r * L.ldst + col) = make_float2(v0, v1);
            acc[j][2 * h] = acc[j][2 * h + 1] = 0.f;
          } else {
            acc[j][2 * h] += bias0 + xv.x;
            acc[j][2 * h + 1] += bias1 + xv.y;
            *reinterpret_cast<float2*>(st + r * L.ldst + col) =
                make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
          }
        }
      }
    }
    __syncthreads();
    // 2. LayerNorm of x1 in f32 over the real width -> bf16 y.
    layer_norm_rows<MAXNT / 2>([&](int r, int c) { return st[r * L.ldst + c]; }, ys, L.ldy, BM,
                               e, ep, ln_s, ln_b, eps);
  } else {
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (residual) {  // the accumulators start from x
#pragma unroll
      for (int j = 0; j < MAXNT; ++j) {
        if (j < nt) {
          const int col = cbase + j * 8 + 2 * t;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                ys + (rg + g + 8 * h) * L.ldy + col));
            acc[j][2 * h] = xv.x;
            acc[j][2 * h + 1] = xv.y;
          }
        }
      }
      __syncthreads();  // x is read before the LayerNorm overwrites it
    }
    // 2. LayerNorm of x in f32 over the real width, in place -> bf16 y.
    layer_norm_rows<MAXNT / 2>(
        [&](int r, int c) { return __bfloat162float(ys[r * L.ldy + c]); }, ys, L.ldy, BM, e, ep,
        ln_s, ln_b, eps);
  }
  __syncthreads();  // y is complete and the staging area (the w1 buffers) is free

  // 3. acc += gelu(y . w1[:, c] + b1[c]) . w2[c, :] over BH-column chunks c,
  //    two block barriers a chunk.  After the first, every warp is done with
  //    chunk c - 1, so w2s, hs and the other w1 buffer may be refilled: w2
  //    chunk c loads during fc1 of chunk c, w1 chunk c + 1 during all of it.
  const int hcol = (warp >> 2) * 32;  // this warp's 32 columns of the chunk
  const int nch = (hidden + BH - 1) / BH;
  cp_tile(w1_buf(0), L.ldw1, w1, hidden, 0, 0, ep, BH, e, hidden);
  cp_async_commit();
  for (int c = 0; c < nch; ++c) {
    cp_async_wait<0>();  // w1 chunk c has landed
    __syncthreads();
    cp_tile(w2s, L.ldw2, w2, e, c * BH, 0, BH, ep, hidden, e);
    cp_async_commit();
    if (c + 1 < nch)
      cp_tile(w1_buf((c + 1) & 1), L.ldw1, w1, hidden, 0, (c + 1) * BH, ep, BH, e, hidden);
    cp_async_commit();
    float hacc[4][4] = {};
    const bf16* w1s = w1_buf(c & 1);
#pragma unroll 2
    for (int kk = 0; kk < ep / 16; ++kk) {
      uint32_t a[4], b[4], b2v[4];
      load_a(a, ys, L.ldy, rg, kk * 16);
      load_b_kn(b, w1s, L.ldw1, kk * 16, hcol);
      load_b_kn(b2v, w1s, L.ldw1, kk * 16, hcol + 16);
      mma16816(hacc[0], a, b[0], b[1]);
      mma16816(hacc[1], a, b[2], b[3]);
      mma16816(hacc[2], a, b2v[0], b2v[1]);
      mma16816(hacc[3], a, b2v[2], b2v[3]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = hcol + j * 8 + 2 * t, gc = c * BH + col;
      const float bias0 = gc < hidden ? b1[gc] : 0.f;
      const float bias1 = gc + 1 < hidden ? b1[gc + 1] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if constexpr (TRAIN) {  // the fc1 pre-activation z1, a saved residual
          const int gr = row0 + rg + g + 8 * h;
          if (gr < m && gc < hidden)
            *reinterpret_cast<uint32_t*>(tr.z1 + (long)gr * hidden + gc) =
                pack_bf16(hacc[j][2 * h] + bias0, hacc[j][2 * h + 1] + bias1);
        }
        const float v0 = gc < hidden ? gelu(hacc[j][2 * h] + bias0) : 0.f;
        const float v1 = gc + 1 < hidden ? gelu(hacc[j][2 * h + 1] + bias1) : 0.f;
        *reinterpret_cast<uint32_t*>(hs + (rg + g + 8 * h) * L.ldh + col) = pack_bf16(v0, v1);
      }
    }
    cp_async_wait<1>();  // w2 chunk c has landed
    __syncthreads();     // and the whole 64 x BH activation chunk is in hs
    acc_from(hs, w2s);
  }

  // 4. out = acc + b2.
#pragma unroll
  for (int j = 0; j < MAXNT; ++j) {
    if (j < nt) {
      const int col = cbase + j * 8 + 2 * t;
      if (col < e) {
        const float bias0 = b2[col], bias1 = b2[col + 1];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gr = row0 + rg + g + 8 * h;
          if (gr >= m) continue;
          if constexpr (TRAIN) {  // out = x1 + m2 * (mlp + b2)
            float o0 = acc[j][2 * h] + bias0, o1 = acc[j][2 * h + 1] + bias1;
            if (drop) {
              const float2 mk =
                  dropout_pair(key, 1u, (long long)gr * e + col, tr.threshold, tr.inv_keep);
              o0 *= mk.x;
              o1 *= mk.y;
              *reinterpret_cast<float2*>(tr.m2 + (long)gr * e + col) = mk;
            }
            const float2 xv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(tr.x1 + (long)gr * e + col));
            *reinterpret_cast<uint32_t*>(out + (long)gr * e + col) =
                pack_bf16(xv.x + o0, xv.y + o1);
          } else {
            *reinterpret_cast<uint32_t*>(out + (long)gr * e + col) =
                pack_bf16(acc[j][2 * h] + bias0, acc[j][2 * h + 1] + bias1);
          }
        }
      }
    }
  }
}

}  // namespace

// x: (m, e) bf16.  w1: (e, hidden), w2: (hidden, e) bf16.  ln_s, ln_b, b2: (e,)
// and b1: (hidden,) f32.  out: (m, e) bf16.  With attn != NULL the prologue
// runs: attn (m, hd) bf16, wout (hd, e) bf16, bout (e,) f32, and the residual
// is x1.  bf16 bases 16-byte aligned; e, hidden, hd multiples of 8; e <= 384.
extern "C" int ln_mlp_fwd(const void* x, const void* attn, const void* wout, const void* bout,
                          const void* ln_s, const void* ln_b, const void* w1, const void* b1,
                          const void* w2, const void* b2, void* out, int m, int e, int hd,
                          int hidden, float eps, int residual, void* stream) {
  const int ep = ceil_to(e, 32);
  if (ep / 16 > MAXNT || e % 8 || hidden % 8 || hd % 8) return (int)cudaErrorInvalidValue;
  const MlpSmem L(ep);
  cudaFuncSetAttribute(ln_mlp_fwd_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)L.bytes);
  ln_mlp_fwd_kernel<false><<<(m + BM - 1) / BM, NWARP * 32, L.bytes,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(attn),
      static_cast<const bf16*>(wout), static_cast<const float*>(bout),
      static_cast<const float*>(ln_s), static_cast<const float*>(ln_b),
      static_cast<const bf16*>(w1), static_cast<const float*>(b1),
      static_cast<const bf16*>(w2), static_cast<const float*>(b2), static_cast<bf16*>(out), m,
      e, ep, hd, hidden, eps, residual, TrainArgs{});
  return (int)cudaGetLastError();
}

// The training form: as ln_mlp_fwd with the prologue (attn, wout, bout are
// required), plus seed (one int64 on the card), x1 (m, e) bf16, z1 (m, hidden)
// bf16 and, with dropout, m1 and m2 (m, e) f32 (m1 == NULL: no dropout, m2
// unused).  threshold = min(rate * 2^32, 2^32 - 1); inv_keep = 1 / (1 - rate).
extern "C" int ln_mlp_train_fwd(const void* x, const void* attn, const void* wout,
                                const void* bout, const void* ln_s, const void* ln_b,
                                const void* w1, const void* b1, const void* w2, const void* b2,
                                const void* seed, void* out, void* m1, void* m2, void* x1,
                                void* z1, int m, int e, int hd, int hidden, float eps,
                                unsigned int threshold, float inv_keep, void* stream) {
  const int ep = ceil_to(e, 32);
  if (ep / 16 > MAXNT || e % 8 || hidden % 8 || hd % 8 || attn == nullptr || x1 == nullptr ||
      z1 == nullptr || (m1 != nullptr && (m2 == nullptr || seed == nullptr)))
    return (int)cudaErrorInvalidValue;
  const MlpSmem L(ep);
  cudaFuncSetAttribute(ln_mlp_fwd_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)L.bytes);
  const TrainArgs tr{static_cast<const long long*>(seed), static_cast<float*>(m1),
                     static_cast<float*>(m2), static_cast<bf16*>(x1), static_cast<bf16*>(z1),
                     threshold, inv_keep};
  ln_mlp_fwd_kernel<true><<<(m + BM - 1) / BM, NWARP * 32, L.bytes,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(attn),
      static_cast<const bf16*>(wout), static_cast<const float*>(bout),
      static_cast<const float*>(ln_s), static_cast<const float*>(ln_b),
      static_cast<const bf16*>(w1), static_cast<const float*>(b1),
      static_cast<const bf16*>(w2), static_cast<const float*>(b2), static_cast<bf16*>(out), m,
      e, ep, hd, hidden, eps, 1, tr);
  return (int)cudaGetLastError();
}
