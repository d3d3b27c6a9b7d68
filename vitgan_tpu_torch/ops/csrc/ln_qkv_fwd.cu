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
// ln_mlp_fwd with its out-projection prologue (x1 = x + attn . wout + bout,
// then LN2 -> MLP -> + x1, never leaving the chip).
//
// Design.  One block of 8 warps per 128-row tile.  The x tile arrives by
// cp.async and is normalised in place, in f32, to a bf16 tile; the 3*H*Dh
// output columns are walked in 64-column chunks of wqkv through a two-stage
// cp.async ring, each warp multiplying 32 rows by 32 columns on the tensor
// cores (mma.sync m16n8k16, ldmatrix operands: two A and two B loads feed
// eight MMAs, which keeps shared memory from limiting the tensor cores) and
// writing bias-added bf16 pairs straight from its accumulators.  E, 3*H*Dh
// and Dh must be multiples of 8; E <= 416 (shared memory).
//
// Bound on this card.  At the serving shape (65,536 rows, E 384, 3*H*Dh
// 1,152) a launch does 2*65536*384*1152 = 5.8e10 flops on 50 MB of x, 151 MB
// of qkv and 0.9 MB of weights: 0.06 ms of HBM time against 0.06 ms of
// tensor-core time; the two are about even.
#include "common.cuh"

using namespace vk;

namespace {

constexpr int BM = 128;   // rows per block
constexpr int BN = 64;    // output column chunk
constexpr int NWARP = 8;  // 4 row groups of 32 x 2 column groups of 32
constexpr int MAXC = 13;  // LayerNorm elements per lane: e <= 416

struct QkvSmem {
  int ldy, ldw;
  size_t w_off, stage, bytes;
  __host__ __device__ explicit QkvSmem(int ep) {
    ldy = ep + 8;  // bf16 LN output, BM x ep
    ldw = BN + 8;  // bf16 wqkv chunk, ep x BN, two stages
    w_off = (size_t)BM * ldy * 2;
    stage = (size_t)ep * ldw * 2;
    bytes = w_off + 2 * stage;
  }
};

__global__ void __launch_bounds__(NWARP * 32)
ln_qkv_fwd_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_s,
                  const float* __restrict__ ln_b, const bf16* __restrict__ w,
                  const float* __restrict__ bias, bf16* __restrict__ qkv, int batch, int n, int e,
                  int ep, int heads, int dh, float eps) {
  const QkvSmem L(ep);
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ys = reinterpret_cast<bf16*>(smem);
  auto w_stage = [&](int s) { return reinterpret_cast<bf16*>(smem + L.w_off + s * L.stage); };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m = batch * n, hdim = heads * dh, ncol = 3 * hdim;
  const int row0 = blockIdx.x * BM;
  const int rg = (warp & 3) * 32;
  const int cg = (warp >> 2) * 32;

  // The x tile and the first wqkv chunk arrive together by cp.async; the
  // LayerNorm then runs in place on the x tile.
  const int nchunks = (ncol + BN - 1) / BN;
  cp_tile(ys, L.ldy, x, e, row0, 0, BM, ep, m, e);
  cp_tile(w_stage(0), L.ldw, w, ncol, 0, 0, ep, BN, e, ncol);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  layer_norm_rows<MAXC>([&](int r, int c) { return __bfloat162float(ys[r * L.ldy + c]); }, ys,
                        L.ldy, BM, e, ep, ln_s, ln_b, eps);

  // Where this lane's four rows (rg + 8r + g) start in the (3, B, H, N, Dh) output.
  long row_off[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gr = row0 + rg + 8 * r + g;
    const int bi = gr / n, tok = gr - bi * n;
    row_off[r] = ((long)bi * heads * n + tok) * dh;
  }
  const long part = (long)batch * heads * n * dh;

  for (int c = 0; c < nchunks; ++c) {
    // One barrier a chunk: after it chunk c has landed (and, the first time,
    // y is complete), and every warp is done with chunk c - 1, whose stage
    // takes chunk c + 1.
    cp_async_wait<0>();
    __syncthreads();
    if (c + 1 < nchunks)
      cp_tile(w_stage((c + 1) & 1), L.ldw, w, ncol, 0, (c + 1) * BN, ep, BN, e, ncol);
    cp_async_commit();
    const bf16* ws = w_stage(c & 1);
    float acc[2][4][4] = {};  // [16-row tile][8-column tile]
#pragma unroll 2
    for (int kk = 0; kk < ep / 16; ++kk) {
      uint32_t a0[4], a1[4], b[4], b2[4];
      load_a(a0, ys, L.ldy, rg, kk * 16);
      load_a(a1, ys, L.ldy, rg + 16, kk * 16);
      load_b_kn(b, ws, L.ldw, kk * 16, cg);
      load_b_kn(b2, ws, L.ldw, kk * 16, cg + 16);
      mma16816(acc[0][0], a0, b[0], b[1]);
      mma16816(acc[0][1], a0, b[2], b[3]);
      mma16816(acc[0][2], a0, b2[0], b2[1]);
      mma16816(acc[0][3], a0, b2[2], b2[3]);
      mma16816(acc[1][0], a1, b[0], b[1]);
      mma16816(acc[1][1], a1, b[2], b[3]);
      mma16816(acc[1][2], a1, b2[0], b2[1]);
      mma16816(acc[1][3], a1, b2[2], b2[3]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = c * BN + cg + j * 8 + 2 * t;
      if (gc >= ncol) continue;
      const int p = gc / hdim, h = (gc - p * hdim) / dh, d = gc - p * hdim - h * dh;
      const long col_off = p * part + (long)h * n * dh + d;
      const float bias0 = bias[gc], bias1 = bias[gc + 1];
#pragma unroll
      for (int r = 0; r < 4; ++r) {  // rows rg + 8r + g: tile r / 2, half r % 2
        if (row0 + rg + 8 * r + g < m)
          *reinterpret_cast<uint32_t*>(qkv + row_off[r] + col_off) =
              pack_bf16(acc[r >> 1][j][2 * (r & 1)] + bias0, acc[r >> 1][j][2 * (r & 1) + 1] + bias1);
      }
    }
  }
}

}  // namespace

// x: (batch*n, e) bf16.  w: (e, 3*heads*dh) bf16 in _pad_params column order;
// bias: (3*heads*dh,) f32, ln_s/ln_b: (e,) f32.  qkv: (3, batch, heads, n, dh)
// bf16.  bf16 bases 16-byte aligned; e and dh multiples of 8; e <= 416.
extern "C" int ln_qkv_fwd(const void* x, const void* ln_s, const void* ln_b, const void* w,
                          const void* bias, void* qkv, int batch, int n, int e, int heads, int dh,
                          float eps, void* stream) {
  const int ep = ceil_to(e, 16);
  if (dh % 8 || e % 8 || ep > 32 * MAXC) return (int)cudaErrorInvalidValue;
  const QkvSmem L(ep);
  cudaFuncSetAttribute(ln_qkv_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)L.bytes);
  const int m = batch * n;
  ln_qkv_fwd_kernel<<<(m + BM - 1) / BM, NWARP * 32, L.bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_s),
      static_cast<const float*>(ln_b), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<bf16*>(qkv), batch, n, e, ep, heads, dh, eps);
  return (int)cudaGetLastError();
}
