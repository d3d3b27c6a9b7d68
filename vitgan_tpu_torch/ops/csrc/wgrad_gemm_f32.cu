// Weight gradients of the saved-residual megablock backward in f32 for
// Hopper (sm_90a): wgrad_tf32_kernel, dW = A^T . B on TF32 wgmma over
// ops/wgrad.plan's row splits, with db = the column sums of B, then
// wgrad_reduce.cuh's fixed-order sum of the partials.
// Replaces, at f32 inputs, the parameter-gradient accumulation of
// `_bwd_kernel` (vitgan_tpu/ops/fused_block.py:531-620, pallas_call at :700):
// dw2 = h1^T . dmlp, dw1 = y2^T . dz1, dwout = ao^T . da, dwqkv = y1^T . dqkv
// and the biases' column sums.
//
// Math: every product TF32 x TF32 with f32 accumulation, each operand
// rounded to TF32 to nearest (cvt.rna) on chip; db summed from B's raw f32
// values.  No atomics: two calls give the same bits.
//
// Design.  The kernel sums over rows, so both operands lie MN-major, and TF32
// wgmma reads shared-memory operands K-major only (the transpose bits exist
// for 16-bit types alone; TMA cannot transpose a 4-byte box).  So each stage
// lands by TMA as it lies and is re-laid on chip:
//   - a persistent grid (a block an SM) walks the (output tile, split) units
//     of ops/wgrad.units: the split outermost, then the 128 x 128 output
//     tiles, column tiles fastest, so the blocks that run at once share A's
//     and B's rows in L2;
//   - thread 0 of warpgroup 0 streams a stage (32 summed rows of A's 128
//     columns and of B's) by TMA into a ring of landed stages: FLOAT32 maps
//     (db needs the raw values), four 32-column boxes an operand, 128-byte
//     swizzled, boxes wholly past Ka or Nb not loaded, rows past M and
//     columns past Ka or Nb zero-filled;
//   - a re-lay warpgroup writes B's landed boxes K-major into a ring of
//     re-laid stages, each value rounded with cvt.rna on the way: a 32-row
//     stage re-laid K-major is exactly tile_f32.cuh's canonical SW128 box
//     (128 rows x 32 summed floats, 16 KB).  A lane takes a 4 x 4 block,
//     four 16-byte loads down the landed rows and four 16-byte stores along
//     the re-laid rows, its column chunk q = lane and its row chunk c =
//     (lane % 8) ^ t; every quarter-warp's eight chunks lie at eight
//     different swizzled places on both sides, so neither side conflicts.
//     It adds B's raw values into db on this row tile's stages (c % row
//     tiles == y) as it re-lays them;
//   - two consumer warpgroups multiply 64 rows each of the output tile
//     (m64n128k8, B from the re-laid box, a k8 step 32 bytes along its
//     descriptor).  Each reads its A fragments (mma.m16n8k8 TF32 layout) from
//     the landed boxes into registers, 16 four-byte loads a stage rounded
//     with cvt.rna, the accumulator rows permuted among A's columns so that
//     every load hits 32 banks (reg_a_col), and stores its accumulators into
//     the split's partial.
// Two mbarrier rings: landed (TMA -> the re-lay warps and the consumers' A
// loads) and re-laid (the re-lay warps, after fence.proxy.async -> wgmma).
// db: each re-lay thread sums its four columns over its rows; the four
// warps' sums of a column are added in warp order through shared memory into
// the row tile's partial row.  A stage moves 112 KB of shared memory for 1
// MFLOP (TMA 32 KB, B's re-lay loads and stores 16 KB each, A's fragment
// loads 16 KB, the two consumers' wgmma reads of B 32 KB); re-laying A as
// well (both operands from shared memory, 144 KB) ran slower on the card
// (PERF.md), though ptxas serialises this kernel's wgmmas (C7513: the next
// stage's A fragments are written while the last stage's products run).
//
// Bound on this card at highres128's G (32,768 rows, TF32 494.7 TFLOP/s,
// 3.35 TB/s): dW2 and dW1 3.87e10 flops each (0.078 ms, operations), dWout
// ~101 MB (0.030 ms), dWqkv ~201 MB (0.060 ms).  At 112 KB a stage the
// shared memory needs some 900 clocks where the tensor core needs 512, and
// each block's 32 KB a stage from L2 adds up, over the card, to some 5 TB/s
// at the kernel's pace: the products run well under the TF32 peak.  Times
// against the bound: PERF.md, chip_smoke.py [f32 bwd kernels],
// scripts/kernel_ab.py --f32-bwd.
#include "flash_f32.cuh"
#include "hopper.cuh"
#include "wgrad_reduce.cuh"

namespace vk {
namespace wgradf32 {

using namespace vk::hopper;
using f32::tf32;

constexpr int BM = 128;             // dW rows (A's columns) a tile
constexpr int BN = 128;             // dW columns (B's columns) a tile
constexpr int BK = 32;              // summed rows a stage
constexpr int OB = 32;              // columns of a landed box (128 bytes a row)
constexpr int LBOX = BK * OB * 4;   // a landed box: 32 rows x 32 columns, 4 KB
constexpr int OPER = 4 * LBOX;      // an operand's stage: four landed boxes, or B's re-laid box
constexpr int LSTAGE = 2 * OPER;    // a landed stage: A's boxes, then B's (32 KB)
constexpr int THREADS = 128 * 4;    // warpgroups: producer, re-lay, two consumers
constexpr int NL = 4;               // landed stages (ring depths: the fastest tried on the card)
constexpr int NR = 4;               // re-laid stages
constexpr int LARRIVE = 4 + 8;      // warps releasing a landed stage: the re-lay's, the consumers'
constexpr int RARRIVE = 4;          // warps filling a re-laid stage
constexpr int SMEM = 1024 + NL * LSTAGE + NR * OPER + 4 * 32 * 16 + 2 * (NL + NR) * 8;
static_assert(SMEM <= 232448, "a block an SM");

// Unit u of the persistent grid (ops/wgrad.units): split u / tiles, then the
// 128 x 128 output tile, column tiles fastest; its rows [r0, r0 +
// rows_per_split) and stages of BK rows up to m.
struct Unit {
  int i0, j0, y, split, r0, nch;
};
__device__ inline Unit unit_of(int u, int nbt, int tiles, int m, int rps) {
  Unit w;
  w.split = u / tiles;
  const int tile = u - w.split * tiles;
  w.y = tile / nbt;
  w.i0 = w.y * BM;
  w.j0 = (tile - w.y * nbt) * BN;
  w.r0 = w.split * rps;
  w.nch = (min(m, w.r0 + rps) - w.r0 + BK - 1) / BK;
  return w;
}

__device__ inline float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// This warp's share of one operand's stage: `src` landed (BK rows of 128
// columns in four swizzled 32-column boxes) into `dst` re-laid K-major (128
// rows of BK floats, the canonical SW128 box), each value rounded to TF32.
// Lane l takes column chunk q = l (columns 4 l .. 4 l + 3) of rows 4 c .. 4 c
// + 3 for c = (l % 8) ^ t, t = 2 wq and 2 wq + 1, and writes it as rows 4 q
// .. 4 q + 3, chunk c.  SUMS: the raw values are
// added into cs (B's column sums, in the order t, then row).
template <bool SUMS>
__device__ inline void relay(const unsigned char* src, unsigned char* dst, int wq, int lane,
                             float4& cs) {
  const int q = lane;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = (lane & 7) ^ (2 * wq + h);
    float4 v[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int k = 4 * c + kk;
      v[kk] = *reinterpret_cast<const float4*>(src + (q >> 3) * LBOX + k * 128 +
                                               (((q & 7) ^ (k & 7)) << 4));
    }
    if constexpr (SUMS) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        cs.x += v[kk].x;
        cs.y += v[kk].y;
        cs.z += v[kk].z;
        cs.w += v[kk].w;
      }
    }
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int i = 4 * q + ii;
      *reinterpret_cast<uint4*>(dst + i * 128 + ((c ^ (i & 7)) << 4)) =
          make_uint4(tf32(lane_of(v[0], ii)), tf32(lane_of(v[1], ii)), tf32(lane_of(v[2], ii)),
                     tf32(lane_of(v[3], ii)));
    }
  }
}

// The tile row (of the consumer warpgroup's 64) that holds the
// accumulator rows 16 wr + g + 8 h of warp wr's lane (g, t): A's columns,
// permuted so that a warp's A-fragment loads from the landed boxes hit 32
// different banks (lanes g % 4 take four neighbouring columns of one chunk,
// g / 4 and t, through the swizzle, eight different chunks).
__device__ inline int reg_a_col(int wr, int g, int h) {
  return 32 * (wr >> 1) + 16 * (g >> 2) + 8 * (wr & 1) + 4 * h + (g & 3);
}

// dW partial (ka, nb) of split s into part + s ka nb, and row tile y's db
// partial into bpart row (s row_tiles + y), for every unit of this block.
__global__ void __launch_bounds__(THREADS, 1)
wgrad_tf32_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                  float* __restrict__ part, float* __restrict__ bpart, int m, int ka, int nb,
                  int rows_per_split) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* landed = align1024(smem_raw);        // landed stage s at s LSTAGE
  unsigned char* relaid = landed + NL * LSTAGE;       // re-laid stage s at s OPER
  float4* red = reinterpret_cast<float4*>(relaid + NR * OPER);  // db: 4 warps x 32 lanes
  uint64_t* lfull = reinterpret_cast<uint64_t*>(red + 4 * 32);
  uint64_t* lempty = lfull + NL;
  uint64_t* rfull = lempty + NL;
  uint64_t* rempty = rfull + NR;
  const int wgi = threadIdx.x >> 7;
  const int nbt = (nb + BN - 1) / BN, rtiles = (ka + BM - 1) / BM, tiles = nbt * rtiles;
  const int units = tiles * ((m + rows_per_split - 1) / rows_per_split);
  if (threadIdx.x == 0) {
    for (int s = 0; s < NL; ++s) {
      mbar_init(&lfull[s], 1);
      mbar_init(&lempty[s], LARRIVE);
    }
    for (int s = 0; s < NR; ++s) {
      mbar_init(&rfull[s], RARRIVE);
      mbar_init(&rempty[s], 2);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wgi == 0) {
    if (threadIdx.x == 0) {  // the landed ring: A's and B's boxes, every unit of this block
      int it = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit w = unit_of(u, nbt, tiles, m, rows_per_split);
        const int na = min(4, (ka - w.i0 + OB - 1) / OB), nbx = min(4, (nb - w.j0 + OB - 1) / OB);
        for (int c = 0; c < w.nch; ++c, ++it) {
          const int s = it % NL, row = w.r0 + c * BK;
          if (it >= NL) mbar_wait(&lempty[s], ((it / NL) - 1) & 1);
          unsigned char* st = landed + s * LSTAGE;
          mbar_arrive_tx(&lfull[s], (na + nbx) * LBOX);
          for (int b = 0; b < na; ++b)
            tma_load_2d(st + b * LBOX, &ta, &lfull[s], w.i0 + OB * b, row);
          for (int b = 0; b < nbx; ++b)
            tma_load_2d(st + OPER + b * LBOX, &tb, &lfull[s], w.j0 + OB * b, row);
        }
      }
    }
    return;
  }

  if (wgi == 1) {  // the re-lay warpgroup: B's box and db
    const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3;
    int it = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit w = unit_of(u, nbt, tiles, m, rows_per_split);
      float4 cs = make_float4(0.f, 0.f, 0.f, 0.f);  // db: B's columns j0 + 4 lane .. + 3
      for (int c = 0; c < w.nch; ++c, ++it) {
        const int sl = it % NL, sr = it % NR;
        mbar_wait(&lfull[sl], (it / NL) & 1);
        if (it >= NR) mbar_wait(&rempty[sr], ((it / NR) - 1) & 1);
        const unsigned char* src = landed + sl * LSTAGE + OPER;
        unsigned char* dst = relaid + sr * OPER;
        if (c % rtiles == w.y)
          relay<true>(src, dst, wq, lane, cs);
        else
          relay<false>(src, dst, wq, lane, cs);
        fence_proxy_async();  // the re-laid values, to the consumers' wgmma reads
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(&lempty[sl]);
          mbar_arrive(&rfull[sr]);
        }
      }
      // the four warps' sums of each column, in warp order
      named_bar_sync(1, 128);  // the previous unit's sums read
      red[wq * 32 + lane] = cs;
      named_bar_sync(1, 128);
      if (wq == 0 && w.j0 + 4 * lane < nb) {
        float4 s = red[lane];
#pragma unroll
        for (int k = 1; k < 4; ++k) {
          const float4 v = red[32 * k + lane];
          s.x += v.x;
          s.y += v.y;
          s.z += v.z;
          s.w += v.w;
        }
        *reinterpret_cast<float4*>(bpart + ((long)w.split * rtiles + w.y) * nb + w.j0 +
                                   4 * lane) = s;
      }
    }
    return;
  }

  // consumers: warpgroup w owns 64 rows of each output tile (rows 64 w .. 64
  // w + 63, permuted within them, reg_a_col)
  const int w = wgi - 2, ct = threadIdx.x & 127, lane = threadIdx.x & 31, wr = ct >> 5,
            g = lane >> 2, t = lane & 3;
  float acc[BN / 2];
  int it = 0;
  // This lane's A-fragment words in a landed stage, rows k = t of a
  // k8 step (+ 4 for a2 and a3, which lie 512 bytes on with their chunk's
  // bit 2 flipped by the swizzle); columns h = 0 and 1 one chunk apart
  int aoff[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int col = 64 * w + reg_a_col(wr, g, h);
    aoff[h] = (col >> 5) * LBOX + t * 128 + ((((col & 31) >> 2) ^ t) << 4) + 4 * (col & 3);
  }
  uint32_t af[2][BK / 8][4];  // stage parity's A fragments, kept until its products retire
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit un = unit_of(u, nbt, tiles, m, rows_per_split);
    for (int c0 = 0; c0 < un.nch; c0 += 2) {
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int c = c0 + p;
        if (c >= un.nch) break;
        const int sl = it % NL, sr = it % NR;
        mbar_wait(&lfull[sl], (it / NL) & 1);
        const unsigned char* la = landed + sl * LSTAGE;
#pragma unroll
        for (int kk = 0; kk < BK / 8; ++kk) {
          // rows 8 kk + t and 8 kk + t + 4: (k & 7) is t, then t + 4
          const unsigned char* r0 = la + kk * 1024;
          uint32_t* a = af[p][kk];
          a[0] = tf32(*reinterpret_cast<const float*>(r0 + aoff[0]));
          a[1] = tf32(*reinterpret_cast<const float*>(r0 + aoff[1]));
          a[2] = tf32(*reinterpret_cast<const float*>(r0 + (aoff[0] ^ 64) + 512));
          a[3] = tf32(*reinterpret_cast<const float*>(r0 + (aoff[1] ^ 64) + 512));
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&lempty[sl]);
        mbar_wait(&rfull[sr], (it / NR) & 1);
        const unsigned char* st = relaid + sr * OPER;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 8; ++kk)
          wgmma_tf32_rs128(acc, af[p][kk], desc_sw128(st + 32 * kk, 16, 1024), c > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done: release it
        fence_frags(af[1 - p]);
        if (c > 0 && ct == 0) mbar_arrive(&rempty[(it - 1) % NR]);
        ++it;
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    fence_frags(af[0]);
    fence_frags(af[1]);
    if (ct == 0) mbar_arrive(&rempty[(it - 1) % NR]);
    // this thread's accumulator rows 16 wr + g + 8 h and columns 8 j + 2 t (+ 1)
    float* out = part + (long)un.split * ka * nb;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gi = un.i0 + 64 * w + reg_a_col(wr, g, h);
      if (gi >= ka) continue;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int gj = un.j0 + 8 * j + 2 * t;  // nb even: gj + 1 < nb too
        if (gj < nb)
          *reinterpret_cast<float2*>(out + (long)gi * nb + gj) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
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
      rows_per_split % BK || db == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m == 0) {
    cudaMemsetAsync(dw, 0, (size_t)ka * nb * sizeof(float), s);
    cudaMemsetAsync(db, 0, (size_t)nb * sizeof(float), s);
    return (int)cudaGetLastError();
  }
  const int splits = (m + rows_per_split - 1) / rows_per_split;
  const int rtiles = (ka + BM - 1) / BM;
  const long units = (long)rtiles * ((nb + BN - 1) / BN) * splits;
  if (units > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  CUtensorMap ta{}, tb{};
  int err = tmap_2d_f32(&ta, a, m, ka, BK);
  if (!err) err = tmap_2d_f32(&tb, b, m, nb, BK);
  if (err) return err;
  float* part = static_cast<float*>(scratch);
  float* bpart = part + (long)splits * ka * nb;
  cudaError_t e = cudaFuncSetAttribute(wgrad_tf32_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  const int grid = units < sm_count() ? (int)units : sm_count();
  wgrad_tf32_kernel<<<grid, THREADS, SMEM, s>>>(ta, tb, part, bpart, m, ka, nb, rows_per_split);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return vk::wgrad::reduce(part, bpart, static_cast<float*>(dw), static_cast<float*>(db), splits,
                           splits * rtiles, (long)ka * nb, nb, s);
}
