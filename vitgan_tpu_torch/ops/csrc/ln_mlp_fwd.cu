// LayerNorm -> fc1 -> GELU -> fc2 [+ residual] forward for Hopper (sm_90a),
// with an optional out-projection before it, as a chain of wgmma GEMMs.
//
// Replaces the TPU kernel `_kernel` / `_forward` of vitgan_tpu/ops/fused_mlp.py
// (lines 72-107, 110-150) and, with the out-projection, the MLP half of the
// megablock `_kernel` of vitgan_tpu/ops/fused_block.py:93-211 (pallas_call
// at :408; see ln_qkv_fwd.cu for the first launch).  Three forms, each
// composed by its Python wrapper from the two entries below:
//   plain LN->MLP (ops/fused_mlp.ln_mlp_forward):
//       h   = act(LN(x) . w1 + b1)                          ln_mlp_fc1
//       out = [x +] (h . w2 + b2)                           ln_mlp_linear
//   serving, the megablock's inference form (the same with attn):
//       x1  = x + (attn . wout + bout)                      ln_mlp_linear
//       then the plain form on x1 with the residual x1;
//   training (ops/fused_block.ln_mlp_train_forward; rate > 0, want_res at
//   fused_block.py:111-123, 186-209):
//       x1  = x + m1 * (attn . wout + bout)   (bf16, saved) ln_mlp_linear
//       z1  = LN2(x1) . w1 + b1               (bf16, saved) ln_mlp_fc1
//       out = x1 + m2 * (gelu(z1) . w2 + b2)                ln_mlp_linear
// m1 and m2 are f32 multiply-masks drawn in the epilogues from Philox4x32-10
// (common.cuh dropout_pair, streams 0 and 1, element row * E + col on the
// real E) and written out, as the TPU kernel returns them.  act is the
// activation of the plain LN->MLP (the JAX `_ACTS`, fused_mlp.py:63-69: gelu,
// relu, tanh or sigmoid; a template parameter of the fc1 kernel, each its
// own instantiation), GELU in the megablock's forms; GELU is the exact erf
// form (common.cuh) on the f32 pre-activation.  h (and the serving
// form's x1) go through device memory in bf16: the wrappers allocate them.
//
// Design: a chain of GEMMs on wgrad_gemm.cu's pipeline.  Two kernels of 384 threads, one block an SM, each block walking
// its share of the tiles (a persistent grid): warpgroup 0 is the producer
// (thread 0 issues the TMA loads of the streamed operands, thread 32 fc1's
// resident A), warpgroups 1 and 2 the consumers, each owning 64 rows of a
// 128-row tile and its f32 accumulators.  Every operand lands by TMA with the
// 128-byte swizzle: A (activations, (M, K) row-major) K-major in 64-column
// boxes of 128 rows, B (the weight, (K, N) row-major) N-major in 64 x 64
// boxes, read through the descriptor's transpose bit as wgrad_gemm.cu reads
// its B.  Products are wgmma m64nBNk16 from shared memory, one group in
// flight while the next stage is waited for, all retired within the tile.
//   ln_mlp_linear_kernel (BN 192; a 4-stage ring of one A box and three B
//       boxes): a 128 x 192 tile at a time.  At the tile's start each
//       consumer warpgroup's residual rows (when there is one) land by TMA
//       under the products; epilogue bias [* mask] [+ residual], bf16 out,
//       the mask in f32.
//   ln_mlp_fc1_kernel (BN 256; a 3-stage ring of four B boxes): a block
//       takes a 128-row tile of A whole (E <= 384: six boxes, 96 KB) by TMA,
//       the consumers form the f32 row statistics over the real E and
//       normalise their 64 rows in place (hopper.cuh ln_resident, eight
//       lanes a row, shared with ln_qkv_fwd.cu; fence.proxy.async before
//       wgmma reads them),
//       then walk every 256-column tile of the hidden width against it while
//       w1 streams through the ring; epilogue bias, [z1], act, bf16 h.
//   The wide variant (E > 384, which the resident tile cannot hold, or
//       forced by the wrapper): ln_rows.cuh's ln_rows_kernel writes LN(x) in
//       bf16 with ln_resident's statistics (the same order, so at E <= 384 the
//       same bits), then ln_mlp_fc1_kernel<kStream = true> streams those
//       rows beside w1, one 64-column box of the tile's 128 rows in each of
//       four stages, for every 256-column tile; the epilogue is the same.
//       The cost: LN(x) leaves the chip (M E 2 bytes each way) and A is read
//       once a 256-column tile (from L2).
// Epilogues go one 64-column box at a time: the box's bias loads issued
// together, the f32 masks stored directly (a quad writes a whole 32-byte
// sector), the bf16 outputs staged in shared memory and written by TMA
// stores (4-byte stores straight from the accumulators write half
// sectors).  TMA zero-fills rows past M and columns past K
// (zeros into the products) and past N; its stores clip rows past M and
// columns past N; B boxes wholly past N are not loaded.  The products run
// at cuBLAS's pace (PERF.md); the epilogues, GELU's erf
// above all, run between them, not under them: a ping-pong of the consumer
// warpgroups and alternating accumulator sets were both slower (PERF.md).
//
// What held the mma.sync kernel back, and what this does about it: 8 warps
// on 64-row blocks, each chunk of the hidden width behind two block barriers
// with one w2 buffer (now mbarrier rings, no block barrier in the main
// loop); the prologue, the LayerNorm staging and the MLP strictly one after
// the other (now separate GEMMs whose loads run ahead of their products);
// every 64-row block re-reading all the weights (now 128-row tiles); mma.sync
// at a fraction of wgmma's rate.  The cost: h leaves the chip, 2 M hidden 2
// bytes each way (0.4 GB, ~0.12 ms at the serving shape), and the serving
// form's x1 too.
//
// Bound on this card.  At the serving shape (65,536 rows, E 384, H*Dh 384,
// hidden 1,536) the fused work is 2 M (HD E + 2 E hidden) = 1.74e11 flops on
// ~0.15 GB of activations: 0.176 ms of tensor-core time, so the tensor cores
// bound it; the training form at G's 32,768 rows also writes z1, x1 and two
// f32 masks: 0.091 ms by its bytes.  E, hidden and H*Dh multiples of 8
// (TMA's 16-byte strides); E <= 384 for fc1's resident A, any E for the wide
// variant.  At DeiT-B's G (16,384 rows, E 768, hidden 3,072) the wide fc1
// is bound by its 7.7e10 flops (0.078 ms) and ran 0.23 ms, torch.matmul of
// its product 0.12, ln_rows 0.032 against 0.015 by bytes (H100 80GB HBM3 at
// 700 W, chip_smoke.py [wide kernels]; PERF.md).
//
// ptxas -v (sm_90a, CUDA 12.9): both kernels launch at 168 registers a thread
// (the producer warpgroup drops to 40, the consumers take 232 by
// setmaxnreg), no spills and no performance warning; dynamic shared memory
// 230,464 bytes (fc1) and 230,480 (linear): one block an SM.  The wide fc1
// (kStream true) too launches at 168 registers, 230,480 bytes.
#include "hopper.cuh"
#include "ln_rows.cuh"

using namespace vk;
using namespace vk::hopper;

namespace {

constexpr int BM = 128;              // rows a tile
constexpr int THREADS = 384;         // producer warpgroup + two consumers
constexpr int ABOX = 64 * BM * 2;    // one 64-column box of a tile's A rows, bytes
constexpr int BBOX = 64 * 64 * 2;    // one 64 (K) x 64 (N) box of B
constexpr int MAXKB = 6;             // fc1's resident A boxes: E <= 384

struct Params {
  int m, k, n;                 // rows, summed width, output width
  const float* bias;           // (n,)
  // fc1
  const float* ln_s;
  const float* ln_b;
  float eps;
  const bf16* z1;              // the pre-activation (m, n) is written, or null
  // linear
  const bf16* res;             // (m, n) residual, or null
  float* mask;                 // (m, n) f32 multiply-mask, or null: no dropout
  const long long* seed;
  uint32_t mask_id, threshold;
  float inv_keep;
  // the mask's rows in the global batch (data parallelism): row r of sample
  // s = r / rps keys its bits as row (s / local * global + first + s % local)
  // * rps + r % rps; local == global keys row r itself
  int rps, local, global, first;
};

// --- the linear stage: out = [res +] [mask *] (a . w + bias) ------------------

namespace lin {
constexpr int BN = 192;                       // output columns a tile
constexpr int NB = BN / 64;                   // B boxes a stage
constexpr int STAGES = 4;
constexpr int STAGE = ABOX + NB * BBOX;       // one A box, three B boxes
constexpr int OBOX = 64 * 64 * 2;             // a warpgroup's 64 rows of one 64-column box
constexpr int SMEM = 1024 + STAGES * STAGE + 2 * NB * OBOX + 2 * OBOX + (2 * STAGES + 2) * 8;
}  // namespace lin

__global__ void __launch_bounds__(THREADS, 1)
ln_mlp_linear_kernel(const __grid_constant__ CUtensorMap ta,
                     const __grid_constant__ CUtensorMap tb,
                     const __grid_constant__ CUtensorMap to,
                     const __grid_constant__ CUtensorMap tr, const Params p) {
  using namespace lin;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* stages = smem;                        // stage s at s STAGE
  unsigned char* resid = stages + STAGES * STAGE;      // warpgroup w's box b at (w NB + b) OBOX
  unsigned char* staging = resid + 2 * NB * OBOX;      // warpgroup w's box at w OBOX
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 2 * OBOX);
  uint64_t* empty = full + STAGES;
  uint64_t* rfull = empty + STAGES;                    // warpgroup w's residual landed

  const int wgi = threadIdx.x >> 7;
  const int nkb = (p.k + 63) / 64;
  const int ntiles = (p.n + BN - 1) / BN, units = (p.m + BM - 1) / BM * ntiles;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_init(&rfull[0], 1);
    mbar_init(&rfull[1], 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wgi == 0) {  // producer: one thread streams A and B, stage by stage
    reg_dealloc<40>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int m0 = u / ntiles * BM, n0 = u % ntiles * BN;
        const int nbox = min(NB, (p.n - n0 + 63) / 64);  // boxes wholly past n: not loaded
        for (int kb = 0; kb < nkb; ++kb, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
          unsigned char* st = stages + s * STAGE;
          mbar_arrive_tx(&full[s], ABOX + nbox * BBOX);
          tma_load_2d(st, &ta, &full[s], kb * 64, m0);
          for (int b = 0; b < nbox; ++b)
            tma_load_2d(st + ABOX + b * BBOX, &tb, &full[s], n0 + 64 * b, kb * 64);
        }
      }
    }
    return;
  }

  // consumers: warpgroup w owns rows 64 w .. 64 w + 63 of each tile
  reg_alloc<232>();
  const int w = wgi - 1, ct = threadIdx.x & 127, lane = threadIdx.x & 31, wr = ct >> 5,
            g = lane >> 2, t = lane & 3;
  const uint2 key = p.mask != nullptr ? seed_key(p.seed) : make_uint2(0u, 0u);
  unsigned char* rs = resid + w * NB * OBOX;
  unsigned char* so = staging + w * OBOX;
  float acc[BN / 2];
  int it = 0, loads = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int m0 = u / ntiles * BM, n0 = u % ntiles * BN, r0 = m0 + 64 * w;
    const int nbox = min(NB, (p.n - n0 + 63) / 64);
    // this warpgroup's residual rows land by TMA under the products (the
    // last epilogue's reads of rs precede its proxy fence and barrier)
    const bool res = p.res != nullptr && r0 < p.m;
    if (res && ct == 0) {
      mbar_arrive_tx(&rfull[w], nbox * OBOX);
      for (int b = 0; b < nbox; ++b) tma_load_2d(rs + b * OBOX, &tr, &rfull[w], n0 + 64 * b, r0);
    }
    for (int kb = 0; kb < nkb; ++kb, ++it) {
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      const unsigned char* st = stages + s * STAGE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<BN, 0, 1>(acc, desc_sw128(st + w * (64 * 128) + kk * 32, 16, 1024),
                           desc_sw128(st + ABOX + kk * 2048, BBOX, 1024), kb > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done: release it
      if (kb > 0 && ct == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (ct == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
    if (res) mbar_wait(&rfull[w], loads++ & 1);

    // this thread's two rows' offsets from their Philox elements: the rows'
    // places in the global batch less their own (0 for one rank), made once
    // a tile so that a mask element costs one add more than at one rank
    long goff[2] = {0, 0};
    if (p.mask != nullptr && p.local != p.global) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 16 * wr + g + 8 * h, s = row / p.rps;
        const long grow =
            ((long)(s / p.local) * p.global + p.first + s % p.local) * p.rps + row % p.rps;
        goff[h] = (grow - row) * p.n;
      }
    }

    // epilogue, one 64-column box at a time: the box's bias loads first,
    // issued together (a store between them would order each load behind
    // it); then the arithmetic, the f32 mask stored directly (a quad writes
    // 32 contiguous bytes) and the bf16 output staged in shared memory for
    // one TMA store, which clips rows past m and columns past n.  This
    // thread holds rows 16 wr + g + 8 h of the warpgroup's 64, columns
    // 8 j + 2 t + (0, 1) of the tile; the residual box has the output
    // box's layout.
#pragma unroll
    for (int jb = 0; jb < NB; ++jb) {
      const int c0 = n0 + 64 * jb;
      if (c0 >= p.n) continue;  // the same for the whole warpgroup
      float2 bias[8];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = c0 + 8 * jj + 2 * t;  // n is a multiple of 8: col + 1 < n too
        bias[jj] = col < p.n ? __ldg(reinterpret_cast<const float2*>(p.bias + col))
                             : make_float2(0.f, 0.f);
      }
      if (ct == 0) bulk_wait_read<0>();  // the last box's store has read the staging
      named_bar_sync(1 + w, 128);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = 8 * jb + jj, col = c0 + 8 * jj + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rr = 16 * wr + g + 8 * h, row = r0 + rr;
          float v0 = acc[4 * j + 2 * h] + bias[jj].x, v1 = acc[4 * j + 2 * h + 1] + bias[jj].y;
          if (p.mask != nullptr && row < p.m && col < p.n) {
            const long idx = (long)row * p.n + col;
            const float2 mk =
                dropout_pair(key, p.mask_id, idx + goff[h], p.threshold, p.inv_keep);
            v0 *= mk.x;
            v1 *= mk.y;
            *reinterpret_cast<float2*>(p.mask + idx) = mk;
          }
          if (res) {
            const float2 r = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(rs + jb * OBOX + swz(rr, jj, t)));
            v0 += r.x;
            v1 += r.y;
          }
          *reinterpret_cast<uint32_t*>(so + swz(rr, jj, t)) = pack_bf16(v0, v1);
        }
      }
      fence_proxy_async();  // the staged box, to the TMA unit
      named_bar_sync(1 + w, 128);
      if (ct == 0 && r0 < p.m) {
        tma_store_2d(&to, so, c0, r0);
        bulk_commit();
      }
    }
  }
  if (ct == 0) bulk_wait<0>();
}

// --- LN -> fc1 -> act: h = act(LN(a) . w1 + b1) [, z1] ------------------------

namespace fc1 {
constexpr int BN = 256;                       // output columns a tile
constexpr int NB = BN / 64;                   // B boxes a stage
constexpr int OBOX = 64 * 64 * 2;             // a warpgroup's 64 rows of one output box
// resident A: a 3-stage ring of four B boxes; streamed A (the wide variant):
// a 4-stage ring of one A box and four B boxes
template <bool kStream>
constexpr int STAGES = kStream ? 4 : 3;
template <bool kStream>
constexpr int STAGE = (kStream ? ABOX : 0) + NB * BBOX;
template <bool kStream>
constexpr int SMEM = 1024 + (kStream ? 0 : MAXKB * ABOX) + STAGES<kStream> * STAGE<kStream> +
                     2 * 2 * OBOX + (2 * STAGES<kStream> + 2) * 8;
}  // namespace fc1

// kStream false: a block takes a 128-row tile of A whole (the resident A):
// the consumer warpgroups normalise their 64 rows each, then walk every
// 256-column tile of the hidden width against it while w1 streams through
// the ring.  kStream true (E > 384): A is LN(x) already (ln_rows.cuh) and
// streams beside w1, one 64-column box of the tile's 128 rows a stage, for
// every 256-column tile; the epilogue is the same.  ACT: the activation
// (Act) the epilogue applies.
template <bool kStream, int ACT>
__global__ void __launch_bounds__(THREADS, 1)
ln_mlp_fc1_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                  const __grid_constant__ CUtensorMap th, const __grid_constant__ CUtensorMap tz,
                  const Params p) {
  using namespace fc1;
  constexpr int NST = STAGES<kStream>, ST = STAGE<kStream>;
  constexpr int BOFS = kStream ? ABOX : 0;              // a stage's B boxes after its A box
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* as = smem;                             // box kb of A at kb ABOX (resident)
  unsigned char* stages = as + (kStream ? 0 : MAXKB * ABOX);  // stage s at s ST
  unsigned char* staging = stages + NST * ST;           // (warpgroup w, output o) at (2 w + o) OBOX
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 4 * OBOX);
  uint64_t* empty = full + NST;
  uint64_t* afull = empty + NST;                        // A landed / A free again (resident)
  uint64_t* aempty = afull + 1;

  const int wgi = threadIdx.x >> 7;
  const int nkb = (p.k + 63) / 64;
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
    if (threadIdx.x == 0) {  // w1 [and A], stage by stage, every tile of every unit in order
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
    } else if (!kStream && threadIdx.x == 32) {  // A, one 128-row tile at a time
      int i = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x, ++i) {
        if (i > 0) mbar_wait(aempty, (i - 1) & 1);
        mbar_arrive_tx(afull, nkb * ABOX);
        for (int kb = 0; kb < nkb; ++kb) tma_load_2d(as + kb * ABOX, &ta, afull, kb * 64, u * BM);
      }
    }
    return;
  }

  // consumers: warpgroup w owns rows 64 w .. 64 w + 63 of each tile
  reg_alloc<232>();
  const int w = wgi - 1, ct = threadIdx.x & 127, lane = threadIdx.x & 31, wr = ct >> 5,
            g = lane >> 2, t = lane & 3;
  unsigned char* sh = staging + 2 * w * OBOX;
  unsigned char* sz = sh + OBOX;
  float acc[BN / 2];
  int it = 0, i = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++i) {
    const int m0 = u * BM, r0 = m0 + 64 * w;
    if (!kStream) {
      mbar_wait(afull, i & 1);
      ln_resident(as, ABOX, 64 * w, p.k, p.ln_s, p.ln_b, p.eps);
      fence_proxy_async();           // the normalised rows, to wgmma's operand reads
      named_bar_sync(1 + w, 128);    // this warpgroup reads only its own 64 rows
    }
    for (int nt = 0; nt < ntiles; ++nt) {
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
        // every product of this unit has read the resident A
        if (!kStream && nt == ntiles - 1) mbar_arrive(aempty);
      }
      // epilogue, one 64-column box at a time: bias, [z1], act staged in
      // shared memory, one TMA store per output (rows past m, columns past n
      // clipped).  This thread holds rows 16 wr + g + 8 h of the warpgroup's
      // 64, columns 8 j + 2 t + (0, 1) of the tile.
#pragma unroll
      for (int jb = 0; jb < NB; ++jb) {
        const int c0 = nt * BN + 64 * jb;
        if (c0 >= p.n) continue;  // the same for the whole warpgroup
        float2 bias[8];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int col = c0 + 8 * jj + 2 * t;  // n is a multiple of 8: col + 1 < n too
          bias[jj] = col < p.n ? __ldg(reinterpret_cast<const float2*>(p.bias + col))
                               : make_float2(0.f, 0.f);
        }
        if (ct == 0) bulk_wait_read<0>();  // the last box's stores have read the staging
        named_bar_sync(1 + w, 128);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = 8 * jb + jj;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int rr = 16 * wr + g + 8 * h;
            const float v0 = acc[4 * j + 2 * h] + bias[jj].x;
            const float v1 = acc[4 * j + 2 * h + 1] + bias[jj].y;
            if (p.z1 != nullptr)
              *reinterpret_cast<uint32_t*>(sz + swz(rr, jj, t)) = pack_bf16(v0, v1);
            *reinterpret_cast<uint32_t*>(sh + swz(rr, jj, t)) = pack_bf16(activate<ACT>(v0),
                                                                       activate<ACT>(v1));
          }
        }
        fence_proxy_async();  // the staged boxes, to the TMA unit
        named_bar_sync(1 + w, 128);
        if (ct == 0 && r0 < p.m) {
          tma_store_2d(&th, sh, c0, r0);
          if (p.z1 != nullptr) tma_store_2d(&tz, sz, c0, r0);
          bulk_commit();
        }
      }
    }
  }
  if (ct == 0) bulk_wait<0>();
}

template <bool kStream, int ACT>
int launch_fc1_act(const CUtensorMap& ta, const CUtensorMap& tb, const CUtensorMap& th,
                   const CUtensorMap& tz, const Params& p, void* stream) {
  const int units = (p.m + BM - 1) / BM, grid = units < sm_count() ? units : sm_count();
  cudaFuncSetAttribute(ln_mlp_fc1_kernel<kStream, ACT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, fc1::SMEM<kStream>);
  ln_mlp_fc1_kernel<kStream, ACT><<<grid, THREADS, fc1::SMEM<kStream>,
                                    static_cast<cudaStream_t>(stream)>>>(ta, tb, th, tz, p);
  return (int)cudaGetLastError();
}

template <bool kStream>
int launch_fc1(const CUtensorMap& ta, const CUtensorMap& tb, const CUtensorMap& th,
               const CUtensorMap& tz, const Params& p, int act, void* stream) {
  switch (act) {
    case kGelu: return launch_fc1_act<kStream, kGelu>(ta, tb, th, tz, p, stream);
    case kRelu: return launch_fc1_act<kStream, kRelu>(ta, tb, th, tz, p, stream);
    case kTanh: return launch_fc1_act<kStream, kTanh>(ta, tb, th, tz, p, stream);
    case kSigmoid: return launch_fc1_act<kStream, kSigmoid>(ta, tb, th, tz, p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// h (m, hidden) bf16 = act(LN(a) . w1 + b1) and, when z1 != NULL, z1 (m,
// hidden) bf16 = LN(a) . w1 + b1.  a: (m, e) bf16; w1: (e, hidden) bf16;
// ln_s, ln_b: (e,) and b1: (hidden,) f32.  Bases 16-byte aligned; e, hidden
// multiples of 8; e <= 384; act 0 gelu, 1 relu, 2 tanh, 3 sigmoid.
extern "C" int ln_mlp_fc1(const void* a, const void* ln_s, const void* ln_b, const void* w1,
                          const void* b1, void* h, void* z1, int m, int e, int hidden, float eps,
                          int act, void* stream) {
  if (m < 0 || e < 8 || e > 64 * MAXKB || e % 8 || hidden < 8 || hidden % 8)
    return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  CUtensorMap ta, tb, th, tz;
  int err = tmap_2d(&ta, a, m, e, BM);
  if (!err) err = tmap_2d(&tb, w1, e, hidden, 64);
  if (!err) err = tmap_2d(&th, h, m, hidden, 64);
  if (!err) err = tmap_2d(&tz, z1 != nullptr ? z1 : h, m, hidden, 64);
  if (err) return err;
  Params p{};
  p.m = m, p.k = e, p.n = hidden;
  p.bias = static_cast<const float*>(b1);
  p.ln_s = static_cast<const float*>(ln_s);
  p.ln_b = static_cast<const float*>(ln_b);
  p.eps = eps;
  p.z1 = static_cast<const bf16*>(z1);
  return launch_fc1<false>(ta, tb, th, tz, p, act, stream);
}

// The wide variant (any E a multiple of 8): y (m, e) bf16 = LN(a) from
// ln_rows, then h = act(y . w1 + b1) [and z1] with y streamed.  Arguments
// as ln_mlp_fc1's, less the LayerNorm's.
extern "C" int ln_mlp_fc1_wide(const void* y, const void* w1, const void* b1, void* h, void* z1,
                               int m, int e, int hidden, int act, void* stream) {
  if (m < 0 || e < 8 || e % 8 || hidden < 8 || hidden % 8) return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  CUtensorMap ta, tb, th, tz;
  int err = tmap_2d(&ta, y, m, e, BM);
  if (!err) err = tmap_2d(&tb, w1, e, hidden, 64);
  if (!err) err = tmap_2d(&th, h, m, hidden, 64);
  if (!err) err = tmap_2d(&tz, z1 != nullptr ? z1 : h, m, hidden, 64);
  if (err) return err;
  Params p{};
  p.m = m, p.k = e, p.n = hidden;
  p.bias = static_cast<const float*>(b1);
  p.z1 = static_cast<const bf16*>(z1);
  return launch_fc1<true>(ta, tb, th, tz, p, act, stream);
}

// y (m, e) bf16 = LN(x) with gamma ln_s, beta ln_b (e,) f32, the statistics
// in the resident kernels' order (ln_rows.cuh).  x: (m, e) bf16; e a
// multiple of 8; bases 16-byte aligned.
extern "C" int ln_rows(const void* x, const void* ln_s, const void* ln_b, void* y, int m, int e,
                       float eps, void* stream) {
  return lnrows::ln_rows(x, ln_s, ln_b, y, m, e, eps, stream);
}

// out (m, n) bf16 = [res +] [mask *] (a . w + bias).  a: (m, k) bf16; w: (k,
// n) bf16; bias: (n,) f32; res: (m, n) bf16 or NULL.  With mask != NULL the
// f32 multiply-mask of Philox stream mask_id is drawn from the int64 at seed
// (element row * n + col: inv_keep where its bits are >= threshold, else 0),
// applied and written to mask (m, n).  Under data parallelism the bits of row
// r are those of its row in the global batch (Params::rps..first; local ==
// global for one rank).  Bases 16-byte aligned; k, n multiples of 8.
extern "C" int ln_mlp_linear(const void* a, const void* w, const void* bias, const void* res,
                             const void* seed, void* out, void* mask, int m, int k, int n,
                             int mask_id, unsigned int threshold, float inv_keep, int rps,
                             int local, int global, int first, void* stream) {
  if (m < 0 || k < 8 || k % 8 || n < 8 || n % 8 || (mask != nullptr && seed == nullptr) ||
      rps < 1 || local < 1 || global < local || first < 0 || first + local > global)
    return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  CUtensorMap ta, tb, to, tr;
  int err = tmap_2d(&ta, a, m, k, BM);
  if (!err) err = tmap_2d(&tb, w, k, n, 64);
  if (!err) err = tmap_2d(&to, out, m, n, 64);
  if (!err) err = tmap_2d(&tr, res != nullptr ? res : out, m, n, 64);
  if (err) return err;
  Params p{};
  p.m = m, p.k = k, p.n = n;
  p.bias = static_cast<const float*>(bias);
  p.res = static_cast<const bf16*>(res);
  p.mask = static_cast<float*>(mask);
  p.seed = static_cast<const long long*>(seed);
  p.mask_id = (uint32_t)mask_id;
  p.threshold = threshold;
  p.inv_keep = inv_keep;
  p.rps = rps, p.local = local, p.global = global, p.first = first;
  const int units = (m + BM - 1) / BM * ((n + lin::BN - 1) / lin::BN);
  const int grid = units < sm_count() ? units : sm_count();
  cudaFuncSetAttribute(ln_mlp_linear_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       lin::SMEM);
  ln_mlp_linear_kernel<<<grid, THREADS, lin::SMEM, static_cast<cudaStream_t>(stream)>>>(
      ta, tb, to, tr, p);
  return (int)cudaGetLastError();
}
