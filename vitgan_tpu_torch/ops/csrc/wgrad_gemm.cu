// Weight gradients of the saved-residual megablock backward for Hopper
// (sm_90a): dW = A^T . B and db = column sums of B, summed over all rows.
//
// Replaces the parameter-gradient accumulation of `_bwd_kernel` in
// vitgan_tpu/ops/fused_block.py (lines 503-510, 531-534, 541-544, 555-558,
// 617-620; pallas_call at :700), which sums each product down the TPU's
// sequential grid in f32 output blocks:
//     dw2   = h1^T . dmlp,   db2   = sum dmlp      (h1 = gelu(z1))
//     dw1   = y2^T . dz1,    db1   = sum dz1       (y2 = LN2(x1))
//     dwout = ao^T . da,     dbout = sum da
//     dwqkv = y1^T . dqkv,   dbqkv = sum dqkv      (y1 = LN1(x))
// h1, y2 and y1 come in bf16 from megablock_bwd_mlp.cu and
// megablock_bwd_ln1.cu, formed once a row as the TPU kernel forms them in its
// body.  Hopper blocks run in no order, so the rows are split over the grid's
// z dimension: each block sums its row range into an f32 partial of its
// 64 x 64 output tile, and a second kernel adds the partials in a fixed
// order.  The result is deterministic (no atomics).
//
// Design.  4 warps a block, each 32 x 32 of the output tile, f32
// accumulators in registers; 64 rows of A and B a stage through a two-stage
// cp.async ring; A^T's fragments come from the row-major A tile by
// ldmatrix.trans (load_a_km), B's by ldmatrix.trans as in the forward
// kernels (mma.sync m16n8k16).  Blocks of the first output-row tile also sum
// B's columns for db, each thread two columns of a quarter of the rows.  Ka
// and Nb multiples of 8.
//
// Bound on this card.  At G's 32,768 rows the four products do
// 2*M*(2*E*hidden + E*HD + 3*E*HD) = 1.2e11 flops together (0.12 ms), on
// about 0.35 GB of operands (0.10 ms): tensor cores and HBM about even.
// The partials add splits * Ka * Nb * 4 bytes each way (L2-resident for the
// smaller products).
#include "common.cuh"

using namespace vk;

namespace {

constexpr int TI = 64;   // output rows (columns of A) per block
constexpr int TJ = 64;   // output columns (columns of B) per block
constexpr int BK = 64;   // summed rows per stage
constexpr int NW = 4;    // warps: 2 x 2 of 32 x 32
constexpr int LD = 72;   // shared leading dimension (64 + 8 skew)

__global__ void __launch_bounds__(NW * 32)
wgrad_gemm_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                  float* __restrict__ part, float* __restrict__ bpart, int m, int ka, int nb,
                  int rows_per_split) {
  __shared__ __align__(128) bf16 as[2][BK * LD];
  __shared__ __align__(128) bf16 bs[2][BK * LD];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int j0 = blockIdx.x * TJ, i0 = blockIdx.y * TI, split = blockIdx.z;
  const int r0 = split * rows_per_split;
  const int r1 = min(m, r0 + rows_per_split);
  const int wi = (warp & 1) * 32, wj = (warp >> 1) * 32;
  const bool bias = blockIdx.y == 0;
  const int bc = 2 * (tid & 31), br = (tid >> 5) * (BK / 4);  // column pair, row quarter

  float acc[2][4][4] = {};
  float2 bsum = make_float2(0.f, 0.f);
  const int nch = r1 > r0 ? (r1 - r0 + BK - 1) / BK : 0;
  auto issue = [&](int c, int s) {
    cp_tile(as[s], LD, a, ka, r0 + c * BK, i0, BK, TI, r1, ka);
    cp_tile(bs[s], LD, b, nb, r0 + c * BK, j0, BK, TJ, r1, nb);
  };
  if (nch > 0) issue(0, 0);
  cp_async_commit();
  for (int c = 0; c < nch; ++c) {
    if (c + 1 < nch) issue(c + 1, (c + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* at = as[c & 1];
    const bf16* bt = bs[c & 1];
    if (bias) {
#pragma unroll 4
      for (int rr = br; rr < br + BK / 4; ++rr) {
        const float2 v =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bt + rr * LD + bc));
        bsum.x += v.x;
        bsum.y += v.y;
      }
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a0[4], a1[4], b0[4], b1[4];
      load_a_km(a0, at, LD, wi, kk * 16);
      load_a_km(a1, at, LD, wi + 16, kk * 16);
      load_b_kn(b0, bt, LD, kk * 16, wj);
      load_b_kn(b1, bt, LD, kk * 16, wj + 16);
      mma16816(acc[0][0], a0, b0[0], b0[1]);
      mma16816(acc[0][1], a0, b0[2], b0[3]);
      mma16816(acc[0][2], a0, b1[0], b1[1]);
      mma16816(acc[0][3], a0, b1[2], b1[3]);
      mma16816(acc[1][0], a1, b0[0], b0[1]);
      mma16816(acc[1][1], a1, b0[2], b0[3]);
      mma16816(acc[1][2], a1, b1[0], b1[1]);
      mma16816(acc[1][3], a1, b1[2], b1[3]);
    }
    __syncthreads();  // stage c & 1 is free for chunk c + 2
  }
  cp_async_wait<0>();

  float* out = part + (long)split * ka * nb;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      const int gj = j0 + wj + nj * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gi = i0 + wi + mi * 16 + g + 8 * h;
        if (gi < ka && gj < nb)
          *reinterpret_cast<float2*>(out + (long)gi * nb + gj) =
              make_float2(acc[mi][nj][2 * h], acc[mi][nj][2 * h + 1]);
      }
    }
  }
  if (bias) {  // the four row quarters' column sums, added in order
    float* red = reinterpret_cast<float*>(as[0]);
    reinterpret_cast<float2*>(red)[tid] = bsum;
    __syncthreads();
    if (tid < TJ && j0 + tid < nb) {
      float s = 0.f;
      for (int q = 0; q < NW; ++q) s += red[q * TJ + tid];
      bpart[(long)split * nb + j0 + tid] = s;
    }
  }
}

// out[x] = sum over s of part[s * count + x], s in order.
__global__ void sum_partials_kernel(const float* __restrict__ part, float* __restrict__ out,
                                    int splits, long count) {
  const long x = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= count) return;
  float s = 0.f;
  for (int i = 0; i < splits; ++i) s += part[(long)i * count + x];
  out[x] = s;
}

int launch_sum(const float* part, float* out, int splits, long count, cudaStream_t stream) {
  if (count <= 0) return 0;
  sum_partials_kernel<<<(unsigned)((count + 255) / 256), 256, 0, stream>>>(part, out, splits,
                                                                          count);
  return (int)cudaGetLastError();
}

}  // namespace

// a: (m, ka) bf16; b: (m, nb) bf16.  Out: dw (ka, nb) f32 and db (nb,) f32.
// scratch: splits * (ka * nb + nb) f32.  The rows are
// split into `splits` ranges of whole 64-row stages.  bf16 bases 16-byte
// aligned; ka, nb multiples of 8.
extern "C" int wgrad_gemm(const void* a, const void* b, void* dw, void* db, void* scratch, int m,
                          int ka, int nb, int splits, void* stream) {
  if (ka % 8 || nb % 8 || splits < 1 || db == nullptr) return (int)cudaErrorInvalidValue;
  const int rows_per_split = ceil_to((m + splits - 1) / splits, BK);
  float* part = static_cast<float*>(scratch);
  float* bpart = part + (long)splits * ka * nb;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((nb + TJ - 1) / TJ, (ka + TI - 1) / TI, splits);
  wgrad_gemm_kernel<<<grid, NW * 32, 0, s>>>(static_cast<const bf16*>(a),
                                             static_cast<const bf16*>(b), part, bpart, m, ka, nb,
                                             rows_per_split);
  int err = (int)cudaGetLastError();
  if (err) return err;
  err = launch_sum(part, static_cast<float*>(dw), splits, (long)ka * nb, s);
  return err ? err : launch_sum(bpart, static_cast<float*>(db), splits, nb, s);
}

// out (count,) f32 = sum over s of part (splits, count) f32, in order: the
// second pass of the per-tile LayerNorm-gradient partials.
extern "C" int sum_partials(const void* part, void* out, int splits, int count, void* stream) {
  if (splits < 1) return (int)cudaErrorInvalidValue;
  return launch_sum(static_cast<const float*>(part), static_cast<float*>(out), splits, count,
                    static_cast<cudaStream_t>(stream));
}
