// Weight gradients of the saved-residual megablock backward for Hopper
// (sm_90a): dW = A^T . B and db = column sums of B, summed over all rows.
//
// Replaces the parameter-gradient accumulation of `_bwd_kernel` in
// vitgan_tpu/ops/fused_block.py (lines 484-620, products at :531 (dw2) and
// :617 (dwqkv); pallas_call at :700), which sums each product down the TPU's
// sequential grid in f32 output blocks:
//     dw2   = h1^T . dmlp,   db2   = sum dmlp      (h1 = gelu(z1))
//     dw1   = y2^T . dz1,    db1   = sum dz1       (y2 = LN2(x1))
//     dwout = ao^T . da,     dbout = sum da
//     dwqkv = y1^T . dqkv,   dbqkv = sum dqkv      (y1 = LN1(x))
// h1, y2 and y1 come in bf16 from megablock_bwd_mlp.cu and
// megablock_bwd_ln1.cu.  Hopper blocks run in no order, so the rows are
// split over the grid's z dimension into ranges of whole 64-row stages
// (ops/wgrad.plan chooses the range); each block sums its range into an f32
// partial of its 128 x 128 output tile, and one second kernel adds the dW and
// db partials in a fixed order.  The result is bit-deterministic (no
// atomics).
//
// Design.  384 threads a block: warpgroup 0 is the producer (warp 0 issues
// the TMA loads, warp 1 sums B's columns for db), warpgroups 1 and 2 the
// consumers, each owning 64 output rows x 128 columns in f32 registers.
// Warp 0 keeps a ring of 6 stages full: per stage two 64-column boxes of A
// and two of B, 64 rows each, 128-byte swizzled, on one `full` mbarrier
// each; the consumers and the sum warp release a stage on its `empty`
// mbarrier.  Each stage is 4 wgmma m64n128k16 per consumer with both
// operands read from shared memory in their natural layouts (A^T is M-major,
// B is N-major: the descriptors' transpose bits), one wgmma group kept in
// flight.  db: the block of output-row tile y sums the stages c with
// c % (row tiles) == y, so the column sums are spread evenly over the
// blocks that hold the same B stages; each writes its own partial row.  TMA
// zero-fills rows past M and columns past Ka or Nb.  Ka and Nb multiples of
// 8 (TMA's 16-byte stride rule).
//
// What held the old kernel back, and what this does about it: 64 x 64 tiles
// on mma.sync re-read every operand Nb/64 or Ka/64 times (now 128 x 128 on
// wgmma, half the re-reads); a two-stage cp.async ring behind a block-wide
// barrier every stage (now a 6-stage TMA ring on mbarriers); A^T fragments by
// ldmatrix.trans (now the descriptor's transpose bit); db summed by the
// first output-row tile alone (now spread); two second passes (now one).
//
// Bound on this card.  At G's 32,768 rows the four products do
// 2*M*(2*E*hidden + E*HD + 3*E*HD) = 1.2e11 flops together (0.12 ms), on
// about 0.38 GB of operands (0.11 ms): tensor cores and HBM about even,
// 0.03 ms a product on average.  The partials add splits * (Ka * Nb + row
// tiles * Nb) * 4 bytes each way, mostly L2-resident.
//
// ptxas -v (sm_90a, CUDA 12.8): wgrad_gemm_kernel 90 registers a thread, no
// spills, 197,728 bytes of dynamic shared memory (one block an SM);
// wgrad_reduce_kernel 44 registers, no spills.
//
// sum_partials_kernel (the second pass of the LN partials, TPU
// fused_block.py:700; 512 x 768 f32 at G, 1,025 x 768 at D) used to give one
// thread a column and sum 512-1,025 values serially: 768 threads on 3
// blocks, latency-bound, slower than part.sum(0).  It now gives a block 16
// columns (48 blocks at 768) and 512 threads, the rows split over 128
// interleaved lanes read as float4 and a fixed pairwise tree in shared
// memory.  Bound: 1.5-3.1 MB read once, 0.0005-0.0009 ms.
#include "hopper.cuh"
#include "wgrad_reduce.cuh"

using namespace vk;
using namespace vk::hopper;

namespace {

constexpr int TILE = 128;                 // output rows and columns per block
constexpr int BK = 64;                    // summed rows per stage
constexpr int STAGES = 6;                 // ring depth
constexpr int BOX = 64 * BK * 2;          // one 64-column box of a stage, bytes
constexpr int STAGE_BYTES = 4 * BOX;      // two boxes of A, two of B
constexpr int THREADS = 384;              // producer warpgroup + 2 consumers
constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;

__global__ void __launch_bounds__(THREADS, 1)
wgrad_gemm_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                  float* __restrict__ part, float* __restrict__ bpart, int m, int ka, int nb,
                  int rows_per_split) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  const int wg = threadIdx.x >> 7, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j0 = blockIdx.x * TILE, i0 = blockIdx.y * TILE, split = blockIdx.z;
  const int r0 = split * rows_per_split;
  const int r1 = min(m, r0 + rows_per_split);
  const int nch = r1 > r0 ? (r1 - r0 + BK - 1) / BK : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 3);  // two consumer warpgroups and the sum warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    if (warp == 0 && lane == 0) {  // TMA producer
      for (int c = 0; c < nch; ++c) {
        const int s = c % STAGES;
        if (c >= STAGES) mbar_wait(&empty[s], ((c / STAGES) - 1) & 1);
        unsigned char* st = smem + s * STAGE_BYTES;
        const int row = r0 + c * BK;
        mbar_arrive_tx(&full[s], STAGE_BYTES);
        tma_load_2d(st, &ta, &full[s], i0, row);
        tma_load_2d(st + BOX, &ta, &full[s], i0 + 64, row);
        tma_load_2d(st + 2 * BOX, &tb, &full[s], j0, row);
        tma_load_2d(st + 3 * BOX, &tb, &full[s], j0 + 64, row);
      }
    } else if (warp == 1) {  // db: four columns a lane, this block's share of the stages
      const int col = 4 * lane, box = col >> 6, chunk = (col & 63) >> 3, half = col & 7;
      float4 cs = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int c = 0; c < nch; ++c) {
        const int s = c % STAGES;
        mbar_wait(&full[s], (c / STAGES) & 1);
        if (c % gridDim.y == blockIdx.y) {
          const unsigned char* bt = smem + s * STAGE_BYTES + (2 + box) * BOX;
#pragma unroll 8
          for (int r = 0; r < BK; ++r) {
            const uint2 v = *reinterpret_cast<const uint2*>(bt + r * 128 +
                                                            ((chunk ^ (r & 7)) << 4) + half * 2);
            const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
            const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
            cs.x += lo.x;
            cs.y += lo.y;
            cs.z += hi.x;
            cs.w += hi.y;
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
      }
      if (j0 + col < nb)
        *reinterpret_cast<float4*>(bpart + ((long)split * gridDim.y + blockIdx.y) * nb + j0 +
                                   col) = cs;
    }
    return;
  }

  // consumers: rows i0 + 64 w .. + 63 of the output tile
  const int w = wg - 1;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int c = 0; c < nch; ++c) {
    const int s = c % STAGES;
    mbar_wait(&full[s], (c / STAGES) & 1);
    const unsigned char* st = smem + s * STAGE_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_ss128<1, 1>(acc, desc_sw128(st + w * BOX + kk * 2048, BOX, 1024),
                        desc_sw128(st + 2 * BOX + kk * 2048, BOX, 1024), 1);
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: release it
    if (c > 0 && (threadIdx.x & 127) == 0) mbar_arrive(&empty[(c - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  float* out = part + (long)split * ka * nb;
  const int wr = (threadIdx.x & 127) >> 5, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int gj = j0 + 8 * j + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gi = i0 + 64 * w + 16 * wr + g + 8 * h;
      if (gi < ka && gj < nb)
        *reinterpret_cast<float2*>(out + (long)gi * nb + gj) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// out[c] = sum over s of part[s, c] in one fixed order (ops/wgrad.
// sum_partials_reference repeats it with elementwise adds): block b owns
// columns [16 b, 16 b + 16), four float4 quads; its SP_LANES lanes each sum
// the rows s = lane, lane + SP_LANES, ... in increasing s from 0, and a
// pairwise tree in shared memory adds lane l + stride into lane l for
// stride = SP_LANES / 2, ..., 1.  No atomics: two calls are bit-equal.
constexpr int SP_COLS = 16;                  // columns a block: four float4 quads
constexpr int SP_LANES = 128;                // interleaved row ranges a column
constexpr int SP_THREADS = 4 * SP_LANES;

__global__ void __launch_bounds__(SP_THREADS)
sum_partials_kernel(const float* __restrict__ part, float* __restrict__ out, int splits,
                    int count) {
  __shared__ float4 tree[SP_LANES][4];
  const int q = threadIdx.x & 3, lane = threadIdx.x >> 2;
  const int col = blockIdx.x * SP_COLS + 4 * q;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (col < count) {
#pragma unroll 4
    for (int i = lane; i < splits; i += SP_LANES) {
      const float4 v = *reinterpret_cast<const float4*>(part + (long)i * count + col);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
  }
  tree[lane][q] = s;
  for (int stride = SP_LANES / 2; stride > 0; stride >>= 1) {
    __syncthreads();
    if (lane < stride) {
      const float4 a = tree[lane][q], b = tree[lane + stride][q];
      tree[lane][q] = make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
    }
  }
  // lane 0 wrote tree[0][q] itself at every level
  if (lane == 0 && col < count) *reinterpret_cast<float4*>(out + col) = tree[0][q];
}

}  // namespace

// a: (m, ka) bf16; b: (m, nb) bf16, both row-major with 16-byte aligned
// bases; ka, nb multiples of 8.  Out: dw (ka, nb) f32 and db (nb,) f32.  The
// rows are split into ranges of rows_per_split (a multiple of 64), splits =
// ceil(m / rows_per_split); scratch holds splits * ka * nb dW partials, then
// splits * ceil(ka / 128) * nb db partials, f32.
extern "C" int wgrad_gemm(const void* a, const void* b, void* dw, void* db, void* scratch, int m,
                          int ka, int nb, int rows_per_split, void* stream) {
  if (ka % 8 || nb % 8 || ka < 8 || nb < 8 || m < 0 || rows_per_split < BK ||
      rows_per_split % BK || db == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m == 0) {
    cudaMemsetAsync(dw, 0, (size_t)ka * nb * sizeof(float), s);
    cudaMemsetAsync(db, 0, (size_t)nb * sizeof(float), s);
    return (int)cudaGetLastError();
  }
  const int splits = (m + rows_per_split - 1) / rows_per_split;
  CUtensorMap ta, tb;
  const uint32_t box[2] = {64, BK};
  const uint64_t dims_a[2] = {(uint64_t)ka, (uint64_t)m}, stride_a[1] = {(uint64_t)ka * 2};
  const uint64_t dims_b[2] = {(uint64_t)nb, (uint64_t)m}, stride_b[1] = {(uint64_t)nb * 2};
  int err = make_tmap_bf16(&ta, a, 2, dims_a, stride_a, box);
  if (err) return err;
  err = make_tmap_bf16(&tb, b, 2, dims_b, stride_b, box);
  if (err) return err;
  float* part = static_cast<float*>(scratch);
  const dim3 grid((nb + TILE - 1) / TILE, (ka + TILE - 1) / TILE, splits);
  float* bpart = part + (long)splits * ka * nb;
  cudaFuncSetAttribute(wgrad_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  wgrad_gemm_kernel<<<grid, THREADS, SMEM, s>>>(ta, tb, part, bpart, m, ka, nb, rows_per_split);
  err = (int)cudaGetLastError();
  if (err) return err;
  const long count = (long)ka * nb;
  return wgrad::reduce(part, bpart, static_cast<float*>(dw), static_cast<float*>(db), splits,
                       splits * grid.y, count, nb, s);
}

// out (count,) f32 = sum over s of part (splits, count) f32 in the fixed
// order of sum_partials_kernel: the second pass of the per-tile
// LayerNorm-gradient partials.  count a multiple of 4, bases 16-byte aligned.
extern "C" int sum_partials(const void* part, void* out, int splits, int count, void* stream) {
  if (splits < 1 || count % 4) return (int)cudaErrorInvalidValue;
  if (count <= 0) return 0;
  sum_partials_kernel<<<(unsigned)((count + SP_COLS - 1) / SP_COLS), SP_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<float*>(out), splits, count);
  return (int)cudaGetLastError();
}
