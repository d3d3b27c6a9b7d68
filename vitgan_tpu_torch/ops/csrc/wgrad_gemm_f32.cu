// Weight gradients of the saved-residual megablock backward in f32 for
// Hopper (sm_90a): wgrad_f32_kernel (an mma.sync TF32 tile core: 8 warps, a
// 128 x 128 tile, 64 x 32 a warp, two cp.async stages of 32 rows, each
// operand rounded with cvt.rna as it lands), over ops/wgrad.plan's
// row splits, then wgrad_reduce.cuh's fixed-order sum of the partials.
// Replaces, at f32 inputs, the parameter-gradient accumulation of
// `_bwd_kernel` (vitgan_tpu/ops/fused_block.py:531-620, pallas_call at :700):
// dw2 = h1^T . dmlp, dw1 = y2^T . dz1, dwout = ao^T . da, dwqkv = y1^T . dqkv
// and the biases' column sums.  Bound on this card at highres128's G: dW2 and
// dW1 3.87e10 flops each (0.078 ms, operations), dWout ~101 MB (0.030 ms),
// dWqkv ~201 MB (0.060 ms).
//
// Design (a simple kernel; TF32 wgmma is ROADMAP.md queue 2 item 6r).  The
// kernel sums over rows, so both operands lie MN-major: 32 rows of A's 128
// columns and of B's a stage at a stride of 136 floats, A's fragment (m = g,
// k = t) at t S + g, B's at t S + g (32 banks each).  The rows split over the
// grid's z as wgrad.plan chooses (ranges of whole 64-row stages); rows past
// the split land as zeros.  db: the block of output-row tile y sums the
// stages c with c % (row tiles) == y from the raw f32 tile before it is
// rounded, a thread its four columns over its rows, then the eight threads
// of a column group in order through shared memory.  No atomics: two calls
// give the same bits.
#include "flash_f32.cuh"
#include "wgrad_reduce.cuh"

namespace vk {
namespace wgradf32 {

using f32::bits;
using f32::mma;
using f32::tf32;

constexpr int BM = 128;       // dW rows (A's columns) a block
constexpr int BN = 128;       // dW columns (B's columns) a block
constexpr int BK = 32;        // summed rows a stage
constexpr int THREADS = 256;  // 8 warps: 2 (rows) x 4 (columns), 64 x 32 each

__device__ inline float4 round4(float4 v) {
  return make_float4(__uint_as_float(tf32(v.x)), __uint_as_float(tf32(v.y)),
                     __uint_as_float(tf32(v.z)), __uint_as_float(tf32(v.w)));
}

__device__ inline void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

// --- dW = A^T . B, db = column sums of B ---------------------------------------------

constexpr int WS = BN + 8;          // the MN-major tiles' stride, floats
constexpr int WTILE = BK * WS;      // 32 rows of 128 columns
constexpr int WSTAGE = 2 * WTILE;   // A's, then B's
constexpr int WSMEM = 2 * WSTAGE * (int)sizeof(float);  // 69,632 bytes
static_assert(8 * BN <= 2 * WSTAGE, "db's column-group partials fit the stage buffers");

// Stage rows [row0, row0 + BK) (zero at or past r1) of A's columns [i0, i0 +
// BM) and B's [j0, j0 + BN) into `st`, 16 bytes a copy, zero past ka, nb.
__device__ inline void load_wstage(float* st, const float* a, const float* b, int row0, int r1,
                                   int ka, int nb, int i0, int j0) {
  for (int i = threadIdx.x; i < BK * BM / 4; i += THREADS) {
    const int r = i / (BM / 4), c = 4 * (i % (BM / 4));
    const bool ok = row0 + r < r1 && i0 + c < ka;
    cp_async16(st + r * WS + c, ok ? a + (long)(row0 + r) * ka + i0 + c : a, ok);
  }
  for (int i = threadIdx.x; i < BK * BN / 4; i += THREADS) {
    const int r = i / (BN / 4), c = 4 * (i % (BN / 4));
    const bool ok = row0 + r < r1 && j0 + c < nb;
    cp_async16(st + WTILE + r * WS + c, ok ? b + (long)(row0 + r) * nb + j0 + c : b, ok);
  }
}

// dW partial (ka, nb) of split blockIdx.z into part + split ka nb, and this
// row tile's db partial into bpart row (split * gridDim.y + blockIdx.y).
__global__ void __launch_bounds__(THREADS, 2)
wgrad_f32_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ part,
                 float* __restrict__ bpart, int m, int ka, int nb, int rows_per_split) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int j0 = blockIdx.x * BN, i0 = blockIdx.y * BM, split = blockIdx.z;
  const int r0 = split * rows_per_split, r1 = min(m, r0 + rows_per_split);
  const int nch = r1 > r0 ? (r1 - r0 + BK - 1) / BK : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wm = 64 * (warp >> 2), wn = 32 * (warp & 3);

  if (nch > 0) {
    load_wstage(sm, a, b, r0, r1, ka, nb, i0, j0);
    cp_async_commit();
  }
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  float4 cs = make_float4(0.f, 0.f, 0.f, 0.f);  // db: B's columns j0 + 4 (tid % 32) .. + 3

  for (int c = 0; c < nch; ++c) {
    float* st = sm + (c & 1) * WSTAGE;
    if (c + 1 < nch) {
      load_wstage(sm + ((c + 1) & 1) * WSTAGE, a, b, r0 + (c + 1) * BK, r1, ka, nb, i0, j0);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    // this thread's granules (load_wstage's mapping): B's raw values into db
    // on this row tile's stages, then both operands rounded to TF32
    const bool sums = c % gridDim.y == blockIdx.y;
    for (int i = threadIdx.x; i < BK * BM / 4; i += THREADS) {
      float4* q = reinterpret_cast<float4*>(st + (i / (BM / 4)) * WS + 4 * (i % (BM / 4)));
      *q = round4(*q);
    }
    for (int i = threadIdx.x; i < BK * BN / 4; i += THREADS) {
      float4* q = reinterpret_cast<float4*>(st + WTILE + (i / (BN / 4)) * WS + 4 * (i % (BN / 4)));
      const float4 v = *q;
      if (sums) {
        cs.x += v.x;
        cs.y += v.y;
        cs.z += v.z;
        cs.w += v.w;
      }
      *q = round4(v);
    }
    __syncthreads();
    const float* bs = st + WTILE;
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      uint32_t af[4][4], bf[4][2];
      const float* p0 = st + (8 * kk + t) * WS + wm + g;
      const float* p1 = p0 + 4 * WS;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        af[i][0] = bits(p0[16 * i]);
        af[i][1] = bits(p0[16 * i + 8]);
        af[i][2] = bits(p1[16 * i]);
        af[i][3] = bits(p1[16 * i + 8]);
      }
      const float* q0 = bs + (8 * kk + t) * WS + wn + g;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bf[j][0] = bits(q0[8 * j]);
        bf[j][1] = bits(q0[4 * WS + 8 * j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
    __syncthreads();  // the stage is free for stage c + 2 (or, last, for db's partials)
  }

  float* out = part + (long)split * ka * nb;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gi = i0 + wm + 16 * i + g + 8 * h;
      if (gi >= ka) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gj = j0 + wn + 8 * j + 2 * t;  // nb even: gj + 1 < nb too
        if (gj < nb) store2(out + (long)gi * nb + gj, acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
  }
  // db: the eight threads of a column group (tid / 32 = 0..7, rows 8 apart)
  // added in that order
  float4* red = reinterpret_cast<float4*>(sm);
  red[threadIdx.x] = cs;
  __syncthreads();
  if (threadIdx.x < 32 && j0 + 4 * (int)threadIdx.x < nb) {
    float4 s = red[threadIdx.x];
#pragma unroll
    for (int q = 1; q < THREADS / 32; ++q) {
      const float4 v = red[32 * q + threadIdx.x];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    *reinterpret_cast<float4*>(bpart + ((long)split * gridDim.y + blockIdx.y) * nb + j0 +
                               4 * threadIdx.x) = s;
  }
}

}  // namespace wgradf32
}  // namespace vk

// a: (m, ka) f32; b: (m, nb) f32, both row-major with 16-byte aligned bases;
// ka, nb multiples of 8.  Out: dw (ka, nb) f32 and db (nb,) f32.  The rows
// are split into ranges of rows_per_split (a multiple of 32; wgrad.plan
// gives multiples of 64), splits = ceil(m / rows_per_split); scratch holds
// splits * ka * nb dW partials, then splits * ceil(ka / 128) * nb db
// partials, f32 (wgrad_gemm.cu's layout).
extern "C" int wgrad_gemm_f32(const void* a, const void* b, void* dw, void* db, void* scratch,
                              int m, int ka, int nb, int rows_per_split, void* stream) {
  using namespace vk::wgradf32;
  if (ka % 8 || nb % 8 || ka < 8 || nb < 8 || m < 0 || rows_per_split < BK ||
      rows_per_split % BK || db == nullptr || (ka + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m == 0) {
    cudaMemsetAsync(dw, 0, (size_t)ka * nb * sizeof(float), s);
    cudaMemsetAsync(db, 0, (size_t)nb * sizeof(float), s);
    return (int)cudaGetLastError();
  }
  const int splits = (m + rows_per_split - 1) / rows_per_split;
  float* part = static_cast<float*>(scratch);
  const dim3 grid((nb + BN - 1) / BN, (ka + BM - 1) / BM, splits);
  float* bpart = part + (long)splits * ka * nb;
  cudaError_t err = cudaFuncSetAttribute(wgrad_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, WSMEM);
  if (err != cudaSuccess) return (int)err;
  wgrad_f32_kernel<<<grid, THREADS, WSMEM, s>>>(static_cast<const float*>(a),
                                                 static_cast<const float*>(b), part, bpart, m, ka,
                                                 nb, rows_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return vk::wgrad::reduce(part, bpart, static_cast<float*>(dw), static_cast<float*>(db), splits,
                           splits * (int)grid.y, (long)ka * nb, nb, s);
}
