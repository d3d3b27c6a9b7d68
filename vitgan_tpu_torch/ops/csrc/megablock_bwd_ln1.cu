// Saved-residual megablock backward, LN1 half, for Hopper (sm_90a).
//
// Replaces the end of `_bwd_kernel` in vitgan_tpu/ops/fused_block.py
// (lines 616-628; pallas_call at :700): from dqkv (the flash backward's dq,
// dk, dv in the (rows, 3*H*Dh) column order of `_pad_params`), on (M, .) rows
//     dy1 = dqkv . wqkv^T                            (K = 3*H*Dh)
//     dx  = dx1 + LN1^T(dy1)                         (LN1 statistics from x)
// with y1 = LN1(x) written in bf16 for wgrad_gemm.cu (dwqkv = y1^T . dqkv, the
// operand the TPU kernel forms in its body) and per-64-row-tile column
// partials of dln1.scale = sum dy1 * yhat1 and dln1.bias = sum dy1 for
// sum_partials' deterministic second pass.
//
// Design: ln_bwd_tile.cuh's body, which megablock_bwd_mlp.cu's dx1 stage
// runs with its own epilogue (dy2 = dz1 . w1^T there, K = hidden).  Here K is
// 3*H*Dh, wqkv (E, 3*H*Dh) is read K-major as w1 is, x's tile alone lands by
// TMA under the products, the residual dx1 (f32) is read straight from
// device memory a group of 32 columns ahead of its stores (shared memory
// holds the ring), and dx is staged in bf16 where the dx1 stage keeps g, then
// TMA-stored, as y1 is from x's landed tile.  LN1's statistics are taken
// eight lanes a row as ln_qkv_fwd.cu takes them (hopper.cuh ln_row8), so
// the backward normalises with the forward's bits.  The dln1 partials keep
// the (ceil(M / 64), 2E) layout, a row a tile, summed in a fixed order: no
// atomics, two calls give the same bits.
//
// What held the mma.sync kernel back, and what this does about it: 8 warps
// on 64-row tiles with two cp.async buffers behind two block barriers for
// every 64-wide K chunk (now a 2-stage mbarrier ring fed by a producer
// thread, each stage released as soon as its products finish); dy1 staged in
// f32 in shared memory for a row phase of one warp a row that read x and dx1
// with 2- and 4-byte loads strided 32 elements apart and wrote dx and y1 as
// single bf16 elements (now the LayerNorm backward runs on the accumulators
// in registers, dx1 is read as 8-byte pairs a quad writes as whole sectors,
// and dx and y1 leave by TMA stores); mma.sync at a fraction of wgmma's rate.
//
// Bound on this card.  At G's shape (32,768 rows, E 384, K 1,152) a launch
// does 2*M*E*K = 2.9e10 flops (0.029 ms) on 75 MB of dqkv, 25 MB of x and 50
// MB of dx1 in and 25 MB each of dx and y1 out (0.060 ms): HBM bounds it.
// At D's 65,600 rows 0.12 ms.  E and K multiples of 8 (TMA's 16-byte
// strides); E <= 384 (two warpgroups of 192 columns).  A wider E (or the
// wrapper forcing it) takes the wide variant: dy1 = dqkv . wqkv^T in f32 by
// megablock_bwd_mlp.cu's streamed product, then megablock_bwd_ln1_rows below
// (ln_rows.cuh's LayerNorm-backward rows with this epilogue).
//
// Where the time goes (scripts/phase_trace.py, PERF.md): of a 64-row tile at
// G the products take about half, near twice the tensor cores' time for
// them, while the ring streams all of wqkv (0.9 MB) from L2 again for every
// tile; the epilogue a quarter, the LayerNorm
// sums a tenth, the statistics and the stores the rest, between the
// products.  The statistics eight lanes a row, the column partials by a
// reduce-scatter and the residual loaded a group ahead (the first under the
// statistics) shortened those phases, the dx1 stage's with them.
//
// ptxas -v (sm_90a, CUDA 12.9): 168 registers a thread (the producer
// warpgroup drops to 40, the consumers take 232 by setmaxnreg), no spills
// and no performance warning; dynamic shared memory 230,960 bytes: one
// block an SM.
#include "hopper.cuh"
#include "ln_bwd_tile.cuh"
#include "ln_rows.cuh"

using namespace vk;

namespace {

// ln_bwd_tile.cuh's body with the LN1 epilogue: tx x's tile landed, ty / tdx
// y1's and dx's stores (tg unused).
__global__ void __launch_bounds__(lnbwd::THREADS, 1)
megablock_bwd_ln1_kernel(const __grid_constant__ CUtensorMap ta,
                         const __grid_constant__ CUtensorMap tb,
                         const __grid_constant__ CUtensorMap tx,
                         const __grid_constant__ CUtensorMap tg,
                         const __grid_constant__ CUtensorMap ty,
                         const __grid_constant__ CUtensorMap tdx, const lnbwd::Params p) {
  lnbwd::tiles<lnbwd::kLn1>(ta, tb, tx, tg, ty, tdx, p);
}

}  // namespace

// dqkv: (m, k) bf16, k = 3*H*Dh in _pad_params column order; wqkv: (e, k)
// bf16; x: (m, e) bf16; dx1: (m, e) f32; ln_s, ln_b: (e,) f32.  Out: dx and
// y1 = LN1(x) (m, e) bf16, part (ceil(m / 64), 2*e) f32 (dln1.scale then
// dln1.bias partials, a row a 64-row tile).  Bases 16-byte aligned; e, k
// multiples of 8; e <= 384.
extern "C" int megablock_bwd_ln1(const void* dqkv, const void* wqkv, const void* x,
                                 const void* dx1, const void* ln_s, const void* ln_b, void* dx,
                                 void* y1, void* part, int m, int e, int k, float eps,
                                 void* stream) {
  if (m < 0 || e < 8 || e > 2 * lnbwd::BNW || e % 8 || k < 8 || k % 8)
    return (int)cudaErrorInvalidValue;
  lnbwd::Params p{};
  p.m = m, p.e = e, p.k = k;
  p.ahead = static_cast<const float*>(dx1);
  p.ln_s = static_cast<const float*>(ln_s);
  p.ln_b = static_cast<const float*>(ln_b);
  p.eps = eps;
  p.part = static_cast<float*>(part);
  return lnbwd::launch(megablock_bwd_ln1_kernel, dqkv, wqkv, x, nullptr, y1, dx, p, stream);
}

// The wide LN1 half's LayerNorm backward (any E a multiple of 8), after dy1 =
// megablock_bwd_dy(dqkv, wqkv^T) (megablock_bwd_mlp.cu): dx, y1 and part as
// megablock_bwd_ln1's.  dy1, dx1: (m, e) f32; x: (m, e) bf16.
extern "C" int megablock_bwd_ln1_rows(const void* dy1, const void* x, const void* dx1,
                                      const void* ln_s, const void* ln_b, void* dx, void* y1,
                                      void* part, int m, int e, float eps, void* stream) {
  lnrows::BwdParams p{};
  p.m = m, p.e = e;
  p.dy = static_cast<const float*>(dy1);
  p.x = static_cast<const bf16*>(x);
  p.res = static_cast<const float*>(dx1);
  p.ln_s = static_cast<const float*>(ln_s);
  p.ln_b = static_cast<const float*>(ln_b);
  p.eps = eps;
  p.out = static_cast<bf16*>(dx);
  p.y = static_cast<bf16*>(y1);
  p.part = static_cast<float*>(part);
  return lnrows::ln_bwd_rows<lnrows::kLn1>(p, stream);
}
