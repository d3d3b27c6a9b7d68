// Fused LayerNorm -> qkv projection forward for Hopper (sm_90a): the first of
// the three launches that replace the TPU megablock.
//
// Replaces the attention half's front of `_kernel` in
// vitgan_tpu/ops/fused_block.py:93-141 (entered through `fused_encoder_block`,
// fused_block.py:306-435, pallas_call at :408):
//     y   = LN1(x)                      (f32 statistics over the real width)
//     qkv = y . wqkv + bqkv             (bf16 operands, f32 accumulation)
// with the columns of wqkv in the order of `_pad_params` (fused_block.py:280):
// column (p*H + h)*Dh + d is part p (q, k, v) of head h, feature d.  Each
// result goes straight to its place in the (3, B, H, N, Dh) layout the flash
// kernel reads, so no transpose ever runs in device memory.
//
// Why three launches and not one: the TPU kernel keeps a whole sample's qkv
// on chip (VMEM holds megabytes).  At 1,024 tokens that is 1,024 x 1,152
// bf16 = 2.4 MB per sample against 227 KB of shared memory on an H100 SM, so
// the block splits into this kernel, flash_attn_fwd (per-head attention) and
// ln_mlp_fwd with its out-projection stage (x1 = x + attn . wout + bout,
// then LN2 -> MLP -> + x1).
//
// Design: ln_mlp_fwd.cu's LN -> fc1 stage without GELU.  A persistent grid of
// 384-thread blocks, one an SM, each walking its share of the 128-row units:
// warpgroup 0 is the producer (thread 0 streams wqkv through a 3-stage
// mbarrier ring of three 64 x 64 boxes by TMA, thread 32 loads the unit's x
// rows whole: E <= 384, six boxes, 96 KB), warpgroups 1 and 2 the consumers,
// 64 rows each.  A consumer warpgroup takes its rows' f32 statistics over the
// real E and normalises them in place in the 128-byte swizzle (hopper.cuh
// ln_resident, eight lanes a row, gamma and beta from shared memory;
// fence.proxy.async before wgmma reads them), then walks
// 3*H*Dh in 192-column tiles (1,152 and 576 are multiples of 192; 256 would
// leave half a tile idle at both) against wqkv read N-major through the
// descriptor's transpose bit, wgmma m64n192k16 from shared memory, one group
// in flight while the next stage is waited for, all retired within the tile
// (wgmmas left in flight across tiles are serialised by ptxas).  Epilogue:
// the f32 bias added (the tile's bias lands in shared memory by cp.async
// under the products: a load from device memory returns slowly on a card
// this busy, and the first design's bias loads a box and the LayerNorm's
// gamma and beta loads a row were its largest waits, PERF.md),
// the tile's three boxes staged in bf16 in shared memory,
// then copied out 16 bytes (8 columns of one (p, h): Dh is a multiple of 8) a
// thread into (3, B, H, N, Dh), each row's (b, n) from its own index, so rows
// that straddle a sample are placed like any other (at D's 1,025 tokens 6%
// of the 64-row slices straddle, at deit64's 257 a quarter).  Eight threads
// write 64 contiguous columns of one row; with Dh 64 that is 128 bytes of
// one head.  TMA stores of the boxes that lie in one sample (Dh 64) were
// slower: the next unit's x waited behind them (PERF.md).  TMA
// zero-fills rows past M and columns past E (the statistics read only the
// real E; the zeros add nothing to the products); rows past M and columns
// past 3*H*Dh are not written.
//
// What held the mma.sync kernel back, and what this does about it: every
// 128-row block re-read all of wqkv through a two-stage cp.async ring with a
// block barrier each 64-column chunk (now an mbarrier ring run ahead by a
// producer, no block barrier in the main loop); the LayerNorm and the
// products ran strictly one after the other (now the ring keeps three
// stages of wqkv loaded across the LayerNorm, and the next unit's x lands as
// soon as the last tile's products have read this one); bf16 pairs went
// straight from the accumulators as 4-byte stores into scattered rows of the
// output, half a sector each (now 16-byte stores, 128 bytes a row and head);
// mma.sync at a fraction of wgmma's rate.
//
// Bound on this card.  At the serving shape (65,536 rows, E 384, 3*H*Dh
// 1,152) a launch does 2*65536*384*1152 = 5.8e10 flops (0.059 ms) on 50 MB of
// x, 151 MB of qkv and 0.9 MB of weights (0.060 ms): HBM and the tensor cores
// are about even.  At G's 32,768 rows about 0.030 ms.  E and Dh multiples of 8
// (TMA's 16-byte strides, the 16-byte copy-out); E <= 384 for the resident x,
// any E for the wide variant.
//
// The wide variant (E > 384, or forced by the wrapper): ln_mlp_fwd.cu's
// ln_rows writes LN1(x) in bf16 with ln_resident's statistics, then
// ln_qkv_fwd_kernel<kStream = true> streams those rows beside wqkv, one
// 64-column box of the unit's 128 rows and three wqkv boxes in each of four
// stages, with the same epilogue and copy-out.  At DeiT-B's G (16,384 rows, E
// 768) it is bound by its 5.8e10 flops (0.059 ms) and ran 0.11 ms, torch.matmul
// of its product 0.093 (H100 80GB HBM3 at 700 W, chip_smoke.py [wide
// kernels]).
//
// Where the time goes (scripts/phase_trace.py, PERF.md): of a 128-row unit
// at the serving shape the products take about half, the LayerNorm a sixth,
// the epilogues' staging and copy-out nearly a third, all between the
// products rather than under them.
//
// ptxas -v (sm_90a, CUDA 12.9): 168 registers a thread (the producer
// warpgroup drops to 40, the consumers take 232 by setmaxnreg), no spills and
// no performance warning; dynamic shared memory 226,880 bytes: one block an
// SM.
#include "hopper.cuh"

using namespace vk;
using namespace vk::hopper;

namespace {

constexpr int BM = 128;              // rows a unit
constexpr int THREADS = 384;         // producer warpgroup + two consumers
constexpr int ABOX = 64 * BM * 2;    // one 64-column box of a unit's x rows, bytes
constexpr int BBOX = 64 * 64 * 2;    // one 64 (K) x 64 (N) box of wqkv
constexpr int MAXKB = 6;             // the resident x boxes: E <= 384
constexpr int BN = 192;              // output columns a tile
constexpr int NB = BN / 64;          // wqkv boxes a stage
constexpr int OBOX = 64 * 64 * 2;    // a warpgroup's 64 rows of one 64-column box
constexpr int MAXE = 64 * MAXKB;
// resident x: a 3-stage ring of three wqkv boxes; streamed (the wide
// variant, y = LN(x) from ln_rows): a 4-stage ring of one y box and three
// wqkv boxes, and no gamma or beta in shared memory
template <bool kStream>
constexpr int STAGES = kStream ? 4 : 3;
template <bool kStream>
constexpr int STAGE = (kStream ? ABOX : 0) + NB * BBOX;
template <bool kStream>
constexpr int SMEM = 1024 + (kStream ? 0 : MAXKB * ABOX + 2 * MAXE * 4) +
                     STAGES<kStream> * STAGE<kStream> + 2 * NB * OBOX + 2 * BN * 4 +
                     (2 * STAGES<kStream> + 2) * 8;

struct Params {
  int m, e, n;            // rows, E, 3 H Dh
  int ntok, heads, dh;    // the output's (3, B, H, N, Dh) layout
  long long part;         // elements of one part p: B H N Dh
  const float* bias;      // (n,)
  const float* ln_s;
  const float* ln_b;
  float eps;
  bf16* qkv;
};

// kStream false: the resident x, normalised in place.  kStream true (E >
// 384): x is y = LN(x) already (ln_rows.cuh) and streams beside wqkv, one
// 64-column box of the unit's 128 rows a stage, for every 192-column tile;
// the epilogue is the same.
template <bool kStream>
__global__ void __launch_bounds__(THREADS, 1)
ln_qkv_fwd_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                  const Params p) {
  constexpr int NST = STAGES<kStream>, ST = STAGE<kStream>;
  constexpr int BOFS = kStream ? ABOX : 0;              // a stage's wqkv boxes after its y box
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* as = smem;                             // box kb of x at kb ABOX (resident)
  unsigned char* stages = as + (kStream ? 0 : MAXKB * ABOX);  // stage s at s ST
  unsigned char* staging = stages + NST * ST;           // (warpgroup w, box b) at (w NB + b) OBOX
  float* lnp = reinterpret_cast<float*>(staging + 2 * NB * OBOX);  // gamma at c, beta at MAXE + c
  float* biases = lnp + (kStream ? 0 : 2 * MAXE);       // warpgroup w's tile of bias at w BN
  uint64_t* full = reinterpret_cast<uint64_t*>(biases + 2 * BN);
  uint64_t* empty = full + NST;
  uint64_t* afull = empty + NST;                        // x landed / x free again (resident)
  uint64_t* aempty = afull + 1;

  const int wgi = threadIdx.x >> 7;
  const int nkb = (p.e + 63) / 64;
  const int ntiles = (p.n + BN - 1) / BN, units = (p.m + BM - 1) / BM;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_init(afull, 1);
    mbar_init(aempty, 2);
    mbar_fence_init();
  }
  __syncthreads();

  if (wgi == 0) {
    reg_dealloc<40>();
    if (threadIdx.x == 0) {  // wqkv [and y], stage by stage, every tile of every unit in order
      int it = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x)
        for (int nt = 0; nt < ntiles; ++nt) {
          const int n0 = nt * BN, nbox = min(NB, (p.n - n0 + 63) / 64);
          for (int kb = 0; kb < nkb; ++kb, ++it) {
            const int s = it % NST;
            if (it >= NST) mbar_wait(&empty[s], ((it / NST) - 1) & 1);
            unsigned char* st = stages + s * ST;
            mbar_arrive_tx(&full[s], BOFS + nbox * BBOX);
            if (kStream) tma_load_2d(st, &ta, &full[s], kb * 64, u * BM);
            for (int b = 0; b < nbox; ++b)
              tma_load_2d(st + BOFS + b * BBOX, &tb, &full[s], n0 + 64 * b, kb * 64);
          }
        }
    } else if (!kStream && threadIdx.x == 32) {  // x, one 128-row unit at a time
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
  unsigned char* sbw = staging + w * NB * OBOX;
  float* bw = biases + w * BN;
  const int hd = p.heads * p.dh;
  if (!kStream) {
    // gamma and beta, read by every row's LayerNorm, once from device memory
    for (int c = 128 * w + ct; c < p.e; c += 256) {
      lnp[c] = p.ln_s[c];
      lnp[MAXE + c] = p.ln_b[c];
    }
    named_bar_sync(3, 256);
  }
  float acc[BN / 2];
  int it = 0, i = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++i) {
    const int r0 = u * BM + 64 * w;
    if (!kStream) {
      mbar_wait(afull, i & 1);
      ln_resident(as, ABOX, 64 * w, p.e, lnp, lnp + MAXE, p.eps);
      fence_proxy_async();           // the normalised rows, to wgmma's operand reads
      named_bar_sync(1 + w, 128);    // this warpgroup reads only its own 64 rows
    }
    // the copy-out's rows of this thread, 16 q + ct / 8 of the warpgroup's 64:
    // where each starts in (3, B, H, N, Dh), or -1 past m
    long long row_off[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = r0 + 16 * q + (ct >> 3);
      const int bi = row / p.ntok, tok = row - bi * p.ntok;
      row_off[q] = row < p.m ? ((long long)bi * p.heads * p.ntok + tok) * p.dh : -1;
    }
    for (int nt = 0; nt < ntiles; ++nt) {
      const int n0 = nt * BN;
      // the tile's bias lands in shared memory under the products (the last
      // epilogue read it before its second barrier)
      if (ct < BN / 4) {
        const bool ok = n0 + 4 * ct < p.n;
        cp_async16(bw + 4 * ct, ok ? p.bias + n0 + 4 * ct : p.bias, ok);
      }
      cp_async_commit();
      for (int kb = 0; kb < nkb; ++kb, ++it) {
        const int s = it % NST;
        mbar_wait(&full[s], (it / NST) & 1);
        const unsigned char* st = stages + s * ST;
        const unsigned char* a = (kStream ? st : as + kb * ABOX) + w * (64 * 128);
        const unsigned char* b = st + BOFS;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<BN, 0, 1>(acc, desc_sw128(a + kk * 32, 16, 1024),
                             desc_sw128(b + kk * 2048, BBOX, 1024), kb > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done: release it
        if (kb > 0 && ct == 0) mbar_arrive(&empty[(it - 1) % NST]);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (ct == 0) {
        mbar_arrive(&empty[(it - 1) % NST]);
        // every product of this unit has read the resident x
        if (!kStream && nt == ntiles - 1) mbar_arrive(aempty);
      }

      // epilogue: bias added, the tile's boxes staged in bf16 (this thread
      // holds rows 16 wr + g + 8 h of the warpgroup's 64, columns
      // 8 j + 2 t + (0, 1) of the tile), then copied out
      cp_async_wait<0>();
      named_bar_sync(1 + w, 128);  // the bias landed; the last tile's boxes are copied out
#pragma unroll
      for (int jb = 0; jb < NB; ++jb) {
        if (n0 + 64 * jb >= p.n) continue;  // the same for the whole warpgroup
        unsigned char* sb = sbw + jb * OBOX;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = 8 * jb + jj;
          const float2 bias = *reinterpret_cast<const float2*>(bw + 8 * j + 2 * t);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<uint32_t*>(sb + swz(16 * wr + g + 8 * h, jj, t)) =
                pack_bf16(acc[4 * j + 2 * h] + bias.x, acc[4 * j + 2 * h + 1] + bias.y);
        }
      }
      named_bar_sync(1 + w, 128);
      // to (3, B, H, N, Dh): 16 bytes (8 columns of one part and head) of
      // row 16 q + ct / 8, chunk ct % 8 of each box
      const int cc = ct & 7;
#pragma unroll
      for (int jb = 0; jb < NB; ++jb) {
        const int col = n0 + 64 * jb + 8 * cc;
        if (col >= p.n) continue;
        const int pp = col / hd, rem = col - pp * hd, hh = rem / p.dh;
        const long long col_off = pp * p.part + (long long)hh * p.ntok * p.dh + rem - hh * p.dh;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int rr = 16 * q + (ct >> 3);
          if (row_off[q] < 0) continue;
          const uint4 v =
              *reinterpret_cast<const uint4*>(sbw + jb * OBOX + rr * 128 + ((cc ^ (rr & 7)) << 4));
          *reinterpret_cast<uint4*>(p.qkv + row_off[q] + col_off) = v;
        }
      }
    }  // the tile
  }
}

template <bool kStream>
int launch(const void* x, const void* ln_s, const void* ln_b, const void* w, const void* bias,
           void* qkv, int batch, int n, int e, int heads, int dh, float eps, void* stream) {
  if (batch < 0 || n < 1 || heads < 1 || dh < 8 || dh % 8 || e < 8 || e % 8)
    return (int)cudaErrorInvalidValue;
  const int m = batch * n, ncol = 3 * heads * dh;
  if (m == 0) return 0;
  CUtensorMap ta, tb;
  int err = tmap_2d(&ta, x, m, e, BM);
  if (!err) err = tmap_2d(&tb, w, e, ncol, 64);
  if (err) return err;
  Params p{};
  p.m = m, p.e = e, p.n = ncol;
  p.ntok = n, p.heads = heads, p.dh = dh;
  p.part = (long long)batch * heads * n * dh;
  p.bias = static_cast<const float*>(bias);
  p.ln_s = static_cast<const float*>(ln_s);
  p.ln_b = static_cast<const float*>(ln_b);
  p.eps = eps;
  p.qkv = static_cast<bf16*>(qkv);
  const int units = (m + BM - 1) / BM, grid = units < sm_count() ? units : sm_count();
  cudaFuncSetAttribute(ln_qkv_fwd_kernel<kStream>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       SMEM<kStream>);
  ln_qkv_fwd_kernel<kStream><<<grid, THREADS, SMEM<kStream>,
                               static_cast<cudaStream_t>(stream)>>>(ta, tb, p);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (batch*n, e) bf16.  w: (e, 3*heads*dh) bf16 in _pad_params column order;
// bias: (3*heads*dh,) f32, ln_s/ln_b: (e,) f32.  qkv: (3, batch, heads, n, dh)
// bf16.  Bases 16-byte aligned; e and dh multiples of 8; e <= 384.
extern "C" int ln_qkv_fwd(const void* x, const void* ln_s, const void* ln_b, const void* w,
                          const void* bias, void* qkv, int batch, int n, int e, int heads, int dh,
                          float eps, void* stream) {
  if (e > 64 * MAXKB) return (int)cudaErrorInvalidValue;
  return launch<false>(x, ln_s, ln_b, w, bias, qkv, batch, n, e, heads, dh, eps, stream);
}

// The wide variant (any E a multiple of 8): y (batch*n, e) bf16 = LN1(x)
// from ln_rows (ln_mlp_fwd.cu), streamed; arguments as ln_qkv_fwd's, less
// the LayerNorm's.
extern "C" int ln_qkv_fwd_wide(const void* y, const void* w, const void* bias, void* qkv,
                               int batch, int n, int e, int heads, int dh, void* stream) {
  return launch<true>(y, nullptr, nullptr, w, bias, qkv, batch, n, e, heads, dh, 0.f, stream);
}
