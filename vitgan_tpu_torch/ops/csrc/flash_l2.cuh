// The persistent skeleton of the `l2` and `l2ref` flash kernels for Hopper
// (sm_90a), shared by four kernels: the forward (csrc/flash_attn_fwd.cu,
// flash_fwd_l2_kernel), the single-pass backward and the two-pass dq and
// dk/dv (csrc/flash_l2_bwd.cuh).  Each kernel's head note says what it
// computes; this one says how the data moves.
//
// Why this shape.  At the v1 discriminator's shape (256 * 4 heads, 50
// tokens, Dh 108) a head is one serial chain of a few small products, and
// the bytes bound every kernel (PERF.md §6).  A (bh, n, 108) bf16 row is 216
// bytes: no tensor map can describe it (TMA wants 16-byte strides), and
// 8-byte cp.async into swizzled tiles paced the SM at about 5 bytes a cycle.
// But a unit's rows are contiguous, so:
//   - A unit is one (batch*head, R resident rows); a grid of min(units, SMs)
//     blocks walks the units blockIdx.x, + gridDim.x, ... or, where units
//     wait on one another (the single pass past 64 keys), in the order of an
//     atomic ticket (ops/attention.l2_units models both).  One block: 384
//     threads, a producer warp and two consumer warpgroups.
//   - Producer (warp 3 of warpgroup 2).  Lane 0 copies each unit's resident
//     rows and each 64-row tile's rows by one 1-D bulk copy a tensor (from the
//     16-byte boundary at or before the first byte; lane 1 the last 8 bytes
//     by cp.async) into linear entries of two rings, resident and tile, as
//     many entries as fit; lanes 1 .. 31 bring the rows' LSE and delta by
//     cp.async where a kernel carries them.  Lane 0 also writes each unit's
//     outputs back, staged by the consumers as rows in the unit's resident
//     entry, by one 1-D bulk store a tensor, and then refills the entry.  The
//     unit an entry holds goes beside the ring; a unit of -1 ends the walk.
//   - Consumers.  The resident rows are the A operand of every product that
//     reads them, so each thread loads their mma fragments straight from the
//     linear entry into registers (load_frags, and |x|^2 from them); the
//     tile, the B operand, is re-laid by the consumers into a
//     128-byte-swizzled pair of 64-column boxes (relayout), and its entry goes
//     back to the producer at once.  With one tile a unit (n <= 64, the v1
//     shapes) the two warpgroups take alternate units (ping-pong), so that
//     one's loads, barriers and epilogue overlap the other's products; with
//     more they take every unit in lockstep, each re-laying one tensor of
//     each tile into a shared pair, and split the unit's rows (Dh <= 64: 64
//     of R = 128 each) or the outputs' column boxes (Dh > 64: R = 64).
#pragma once

#include "hopper.cuh"

namespace vk {
namespace l2 {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int THREADS = 384;  // two consumer warpgroups + the producer warpgroup
constexpr int TILE = 64;      // rows of a streamed tile
constexpr int SMEM_LIMIT = 232448;  // shared memory a block can use on this card
// Named barriers: the two consumer warpgroups (lockstep) after a tile's
// re-layout, after its norms, and around the single pass's ordered dQ
// additions; warpgroup w's own, BAR_WG + w.
constexpr int BAR_PAIR = 1, BAR_PAIR2 = 2, BAR_WG = 3, BAR_DQ = 5;
// Registers a thread by setmaxnreg: the producer warpgroup's and the
// consumers'.  The block launches at 168 a thread; the consumers' increase
// takes exactly what the producer's decrease frees (128 * (168 - 40) = 256 *
// (232 - 168)): with the producer at 48 it waits for registers forever.
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

__host__ __device__ constexpr int round16(int x) { return (x + 15) / 16 * 16; }

// Shared-memory geometry for a head dimension padded to DP (a multiple of 16).
template <int DP>
struct Geo {
  static constexpr int NB = (DP + 63) / 64;     // 64-column boxes a row
  static constexpr int DPAD = 64 * NB;
  static constexpr int R = NB == 1 ? 128 : 64;  // resident rows a unit
  static constexpr int SBOX = TILE * 128;       // one box of a swizzled tile
  static constexpr int SWZ = 2 * NB * SBOX;     // a tile pair, swizzled
  static constexpr int RING_MAX = 4;
  // offsets from the 1024-byte-aligned base: two swizzled tile pairs, their
  // rows (LSE, delta, norms), the mbarriers, the unit of each resident
  // entry; then a kernel's own buffers (1024-aligned) and the linear rings
  static constexpr int OFF_TROWS = 2 * SWZ;
  static constexpr int OFF_BARS = OFF_TROWS + 2 * 3 * TILE * 4;
  static constexpr int OFF_UNITS = OFF_BARS + 4 * RING_MAX * 8;
  static constexpr int OFF_EXTRA = (OFF_UNITS + RING_MAX * 4 + 1023) / 1024 * 1024;
};

// What a kernel keeps in an entry of each ring: the bf16 tensors of the
// resident rows (1 or 2; a tile's are always 2) and whether the rows' LSE and
// delta come beside the resident rows or the tile's.
struct Entry {
  int rtensors;
  bool rfloats;
  bool tfloats;
};

// The linear rings at head width d and N tokens: resident entries (a unit's
// min(R, n) rows of each resident tensor, each with 16 bytes of slack for a
// start that is not 16-byte aligned, then the floats) and tile entries
// (min(64, n) rows), as many of each as fit after `extra` bytes of the
// kernel's own, up to RING_MAX, at least rmin and 2: alternately, or (ping-pong,
// where each warpgroup holds a resident entry for its whole unit and a tile
// entry only until it is re-laid) resident entries first.
struct Rings {
  int rrows, rtensor, rbytes, trows, ttensor, tbytes, rn, tn, off, smem;
  template <int DP>
  __host__ __device__ static Rings of(int n, int d, Entry e, int extra, int rmin,
                                      bool resident_first) {
    using G = Geo<DP>;
    Rings g;
    g.rrows = n < G::R ? n : G::R;
    g.trows = n < TILE ? n : TILE;
    g.rtensor = round16(g.rrows * d * 2 + 16);
    g.ttensor = round16(g.trows * d * 2 + 16);
    g.rbytes = e.rtensors * g.rtensor + (e.rfloats ? round16(2 * g.rrows * 4) : 0);
    g.tbytes = 2 * g.ttensor + (e.tfloats ? round16(2 * g.trows * 4) : 0);
    g.off = G::OFF_EXTRA + extra;
    const int room = SMEM_LIMIT - 1024 - g.off;
    g.rn = rmin;
    g.tn = 2;
    for (bool grew = true; grew;) {
      const bool r_fits = g.rn < G::RING_MAX && (g.rn + 1) * g.rbytes + g.tn * g.tbytes <= room;
      const bool t_fits = g.tn < G::RING_MAX && g.rn * g.rbytes + (g.tn + 1) * g.tbytes <= room;
      grew = r_fits || t_fits;
      if (r_fits && (resident_first || g.rn <= g.tn || !t_fits)) ++g.rn;
      else if (t_fits) ++g.tn;
    }
    g.smem = 1024 + g.off + g.rn * g.rbytes + g.tn * g.tbytes;
    return g;
  }
};

// Re-lays `rows` rows of a row-major bf16 matrix (`cols` columns read, row
// stride `stride` bytes, 8-byte aligned) into a 64-row tile of 64-column
// boxes `box` bytes apart at dst (128-byte swizzle), 8 bytes a lane, by 128
// threads (pt their index): DPAD / 4 lanes a row (L), lane l columns
// 4 (l % L) .. + 3, the warp's 32 / L rows pw, pw + 4 .. at a time, four
// steps' loads in flight before their stores.  With `fill`, rows past `rows`
// and columns past `cols` are written as zeros; without, they are left as
// they are (zeros from an earlier fill with the same rows).
template <int DPAD>
__device__ inline void relayout(unsigned char* __restrict__ dst, int box,
                                const unsigned char* __restrict__ src, int rows, int cols,
                                int stride, int pt, bool fill) {
  constexpr int L = DPAD / 4, RW = 32 / L;  // lanes a row, rows a warp step
  const int c = 4 * (pt & (L - 1));
  if (c >= (fill ? DPAD : cols)) return;
  unsigned char* col = dst + (c >> 6) * box + ((c >> 2) & 1) * 8;
  const int chunk = (c & 63) >> 3;
  const bool in_col = c < cols;
  const int end = fill ? TILE : rows;
  for (int r0 = (pt >> 5) + 4 * ((pt & 31) / L); r0 < end; r0 += 16 * RW) {
    uint2 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = r0 + 4 * RW * u;
      v[u] = in_col && r < rows ? *reinterpret_cast<const uint2*>(src + r * stride + 2 * c)
                                : make_uint2(0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = r0 + 4 * RW * u;
      if (r < end) *reinterpret_cast<uint2*>(col + r * 128 + ((chunk ^ (r & 7)) << 4)) = v[u];
    }
  }
}

// The mma.m16n8k16 A fragments of rows r and r + 8 of a row-major bf16 matrix
// in shared memory (d columns, row stride 2d bytes), DP columns deep: a[kk]
// holds (row r, columns 16 kk + 2t, + 1), (r + 8, the same), (r, + 8),
// (r + 8, + 8), t = lane % 4; zeros past d and at rows >= nrows.  The rows
// of warp i of a warpgroup are the A operand rows 16i .. of a wgmma.
template <int DP>
__device__ inline void load_frags(uint32_t (&a)[DP / 16][4], const unsigned char* m, int r,
                                  int nrows, int d) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r + 8 * (e & 1), col = 16 * kk + 8 * (e >> 1) + 2 * t;
      a[kk][e] = row < nrows && col < d
                     ? *reinterpret_cast<const uint32_t*>(m + row * d * 2 + col * 2)
                     : 0u;
    }
}

// The A fragments of load_frags (rows r, r + 8; DP columns deep, zeros past
// d) written into a swizzled tile of 64-column boxes `box` bytes apart, four
// bytes a word; columns from DP to the boxes' end are left as they are.
template <int DP>
__device__ inline void frags_to_swz(unsigned char* dst, int box, const uint32_t (&a)[DP / 16][4],
                                    int r) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r + 8 * (e & 1), col = 16 * kk + 8 * (e >> 1) + 2 * t;
      *reinterpret_cast<uint32_t*>(dst + (col >> 6) * box + row * 128 +
                                   ((((col & 63) >> 3) ^ (row & 7)) << 4) + (col & 7) * 2) =
          a[kk][e];
    }
}

// |x|^2 in f32 of the two rows of A fragments (nr[h]: row r + 8 h), summed by
// the lane's group of four.
template <int K>
__device__ inline void frag_norms(const uint32_t (&a)[K][4], float (&nr)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float s = 0.f;
#pragma unroll
    for (int kk = 0; kk < K; ++kk)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float2 f =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a[kk][h + 2 * q]));
        s = fmaf(f.x, f.x, fmaf(f.y, f.y, s));
      }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    nr[h] = s;
  }
}

// |x|^2 in f32 of row r of a swizzled tile (boxes `box` bytes apart; zeros
// past d): the L lanes t = lane % L (L = 2 or 4) sum 16-byte chunks t, t + L,
// ... of the DP / 8, then shuffles; all L return the sum.
template <int DP, int L = 4>
__device__ inline float row_norm(const unsigned char* tile, int box, int r) {
  const int t = threadIdx.x & (L - 1);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < (DP / 8 + L - 1) / L; ++i) {
    const int c = t + L * i;
    if (c < DP / 8) {
      const uint4 raw = *reinterpret_cast<const uint4*>(tile + (c >> 3) * box + r * 128 +
                                                        (((c & 7) ^ (r & 7)) << 4));
      const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&words[k]));
        s = fmaf(f.x, f.x, fmaf(f.y, f.y, s));
      }
    }
  }
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  if (L == 4) s += __shfl_xor_sync(0xffffffffu, s, 2);
  return s;
}

// Column block j of an m64n64 accumulator fragment (rows g, g + 8; columns
// 8 j + 2 t, + 1) as four columns of one row: lanes t and t ^ 1 trade halves,
// even t keeping row g, odd t row g + 8, columns 8 j + 2 (t & 2) .. + 3.
// Every lane of the warp calls it.
__device__ inline float4 row_quad(const float (&a)[32], int j) {
  const int t = threadIdx.x & 3;
  const float x0 = (t & 1) ? a[4 * j] : a[4 * j + 2];
  const float x1 = (t & 1) ? a[4 * j + 1] : a[4 * j + 3];
  const float y0 = __shfl_xor_sync(0xffffffffu, x0, 1);
  const float y1 = __shfl_xor_sync(0xffffffffu, x1, 1);
  return (t & 1) ? make_float4(y0, y1, a[4 * j + 2], a[4 * j + 3])
                 : make_float4(a[4 * j], a[4 * j + 1], y0, y1);
}

// Box b (64 columns: 32 floats) of an m64nN accumulator fragment.
template <int N>
__device__ __forceinline__ const float (&box_of(const float (&acc)[N / 2], int b))[32] {
  return *reinterpret_cast<const float(*)[32]>(acc + 32 * b);
}

// Four bf16 of row r, columns c .. c + 3 (c a multiple of 4), of a swizzled
// tile of 64-column boxes `box` bytes apart, as floats.
__device__ inline float4 swz_quad(const unsigned char* tile, int box, int r, int c) {
  const uint2 raw = *reinterpret_cast<const uint2*>(
      tile + (c >> 6) * box + r * 128 + ((((c & 63) >> 3) ^ (r & 7)) << 4) + ((c >> 2) & 1) * 8);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// The 16 x 16 bf16 A fragments of a 64 x 64 accumulator (16 columns a step).
__device__ __forceinline__ void pack_frags(uint32_t (&f)[4][4], const float (&a)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) f[kk][r] = pack_bf16(a[8 * kk + 2 * r], a[8 * kk + 2 * r + 1]);
}

// A kernel's shared-memory layout, its barriers and the problem.
template <int DP>
struct Shared {
  unsigned char* swz;    // two swizzled tile pairs, Geo::SWZ apart
  float* trows;          // their rows: LSE, delta, norms (3 TILE floats each)
  int* units_at;         // the unit of each resident entry, -1: the walk's end
  unsigned char* extra;  // the kernel's own buffers
  unsigned char* rings;  // the resident entries, then the tile entries
  uint64_t* bars;        // RING_MAX each: rfull, rfree, tfull, tfree
  Rings g;
  Entry e;
  int n, d, bhs, per, units, ntiles;
  bool pingpong;
  float scale_log2, inv_scale;
  __device__ unsigned char* rent(int i) const { return rings + (i % g.rn) * g.rbytes; }
  __device__ unsigned char* tent(int c) const {
    return rings + g.rn * g.rbytes + (c % g.tn) * g.tbytes;
  }
  // byte offset within 16 of row r of head bh: where its first byte landed
  __device__ int off(int bh, int r) const { return (int)((((long)bh * n + r) * d * 2) & 15); }
  // the unit of resident entry i, once it has landed
  __device__ int unit(int i) const { return units_at[i % g.rn]; }
  // the barriers of ring slot s: a resident entry landed (rfull) and
  // released by its consumers (rfree), a tile entry landed and released
  __device__ uint64_t* rfull(int s) const { return bars + s; }
  __device__ uint64_t* rfree(int s) const { return bars + Geo<DP>::RING_MAX + s; }
  __device__ uint64_t* tfull(int s) const { return bars + 2 * Geo<DP>::RING_MAX + s; }
  __device__ uint64_t* tfree(int s) const { return bars + 3 * Geo<DP>::RING_MAX + s; }
};

// Stores the bytes [s0, e) of a (bh, n, d) bf16 tensor at gp from their
// staged copy at so (so + k holds byte s0 + k; so is 16-byte aligned where
// s0 is): one 1-D bulk store from the first 16-byte boundary, the 8 bytes
// before it and after the last one by plain stores; the caller commits.
__device__ inline void store_rows(char* gp, const unsigned char* so, long s0, long e) {
  using namespace hopper;
  const int off = (int)(s0 & 15);
  const long a0 = off ? s0 + 8 : s0, e0 = e & ~15L;
  if (off) *reinterpret_cast<uint2*>(gp + s0) = *reinterpret_cast<const uint2*>(so);
  if (e0 > a0) bulk_store(gp + a0, so + (a0 - s0), (uint32_t)(e0 - a0));
  if (e0 < e) *reinterpret_cast<uint2*>(gp + e0) = *reinterpret_cast<const uint2*>(so + (e0 - s0));
}

// One tile a unit (n <= 64): the consumer warpgroups take alternate units.
__host__ __device__ inline bool pingpong_at(int n) { return n <= TILE; }

// The shared memory a kernel asks for (`extra` bytes of its own).
template <int DP>
__host__ __device__ inline Rings rings_of(int n, int d, Entry e, int extra) {
  return Rings::of<DP>(n, d, e, extra, pingpong_at(n) ? 2 : 1, pingpong_at(n));
}

// Carves the dynamic shared memory and initialises the barriers (the caller
// has `extra` bytes of its own after the unit slots); every thread calls it.
template <int DP>
__device__ inline Shared<DP> setup(int bhs, int n, int d, Entry e, int extra, float scale_log2,
                                   float inv_scale) {
  using namespace hopper;
  using G = Geo<DP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  Shared<DP> sh;
  sh.swz = smem;
  sh.trows = reinterpret_cast<float*>(smem + G::OFF_TROWS);
  sh.bars = reinterpret_cast<uint64_t*>(smem + G::OFF_BARS);
  sh.units_at = reinterpret_cast<int*>(smem + G::OFF_UNITS);
  sh.extra = smem + G::OFF_EXTRA;
  sh.g = rings_of<DP>(n, d, e, extra);
  sh.rings = smem + sh.g.off;
  sh.e = e;
  sh.n = n, sh.d = d, sh.bhs = bhs;
  sh.per = (n + G::R - 1) / G::R;
  sh.units = bhs * sh.per;
  sh.ntiles = (n + TILE - 1) / TILE;
  sh.pingpong = pingpong_at(n);
  sh.scale_log2 = scale_log2, sh.inv_scale = inv_scale;
  if (threadIdx.x == 0) {
    for (int s = 0; s < G::RING_MAX; ++s) {
      mbar_init(sh.rfull(s), 32);  // the producer warp: the bulk copies' bytes + 31 lanes
      mbar_init(sh.tfull(s), 32);
      mbar_init(sh.rfree(s), sh.pingpong ? 128 : 256);  // the unit's consumers, outputs staged
      mbar_init(sh.tfree(s), 1);                        // once the tile is re-laid out
    }
    mbar_fence_init();
  }
  __syncthreads();
  return sh;
}

// The producer warp (the caller's threads 352 .. 383).  r1, r2: the resident
// tensors (r2 with e.rtensors == 2); t1, t2: the tile's; lse and delta of the
// rows where the entry carries them; out1, out2: the outputs staged in the
// resident entry (nout of them).  With `ticket`, the units are taken in the
// order of an atomicAdd on it (the caller has zeroed it); else the static
// walk blockIdx.x, + gridDim.x, ...
template <int DP>
__device__ inline void produce(const Shared<DP>& sh, const bf16* r1, const bf16* r2,
                               const bf16* t1, const bf16* t2, const float* __restrict__ lse,
                               const float* __restrict__ delta, bf16* out1, bf16* out2, int nout,
                               uint32_t* ticket) {
  using namespace hopper;
  using G = Geo<DP>;
  constexpr int R = G::R;
  const int l = threadIdx.x & 31, n = sh.n, d = sh.d, rn = sh.g.rn, tn = sh.g.tn;
  // The copies of `rows` rows from row r0 of head bh of x (and y: two
  // tensors) into entry ent (tensors `tensor` bytes apart, then, with
  // `carry`, the rows' LSE and delta): lane 0 copies the tensors' rows by
  // 1-D bulk copies from the 16-byte boundary at or before their first byte,
  // its arrival counting their bytes; lane 1 the last 8 bytes where the end
  // is not 16-byte aligned, and lanes 1 .. 31 the LSE and delta by cp.async,
  // each arriving once its copies have landed.
  auto issue = [&](unsigned char* ent, int tensors, int tensor, bool carry, int stride,
                   uint64_t* bar, const bf16* x, const bf16* y, int bh, int r0, int rows) {
    const long s0 = ((long)bh * n + r0) * d * 2, end = s0 + (long)rows * d * 2;
    const long a0 = s0 & ~15L, e0 = end & ~15L;
    const char* xb = reinterpret_cast<const char*>(x);
    const char* yb = reinterpret_cast<const char*>(y);
    if (l == 0) {
      mbar_arrive_tx(bar, (y != nullptr ? 2 : 1) * (uint32_t)(e0 - a0));
      if (e0 > a0) {
        bulk_load(ent, xb + a0, (uint32_t)(e0 - a0), bar);
        if (y != nullptr) bulk_load(ent + tensor, yb + a0, (uint32_t)(e0 - a0), bar);
      }
      return;
    }
    if (l == 1 && e0 < end) {
      cp_async8(ent + (e0 - a0), xb + e0);
      if (y != nullptr) cp_async8(ent + tensor + (e0 - a0), yb + e0);
    }
    if (carry) {
      float* rw = reinterpret_cast<float*>(ent + tensors * tensor);
      for (int j = l - 1; j < rows; j += 31) {
        cp_async4(rw + j, lse + (long)bh * n + r0 + j);
        cp_async4(rw + stride + j, delta + (long)bh * n + r0 + j);
      }
    }
    cp_async_arrive(bar);
  };
  // The outputs of the block's entry j, staged in it as the unit's rows of
  // each output: one 1-D bulk store a tensor from the first 16-byte
  // boundary, the 8 bytes before it and after the last one by plain stores
  // (lane 0); then the entry may be filled again.
  auto store = [&](int j) {
    const int u = sh.unit(j), bh = u / sh.per, row0 = (u - bh * sh.per) * R;
    const long s0 = ((long)bh * n + row0) * d * 2, e = s0 + (long)min(R, n - row0) * d * 2;
    for (int o = 0; o < nout; ++o)
      store_rows(reinterpret_cast<char*>(o ? out2 : out1),
                 sh.rent(j) + o * sh.g.rtensor + (int)(s0 & 15), s0, e);
    bulk_commit();
    bulk_wait_read<0>();
  };
  // entry i may be filled once the consumers have released entry i - rn and
  // its outputs are stored
  auto reuse = [&](int i) {
    if (i >= rn) {
      mbar_wait(sh.rfree(i % rn), ((i / rn) - 1) & 1);
      if (l == 0) store(i - rn);
      __syncwarp();
    }
  };
  int c = 0, i = 0;  // tiles and units issued
  for (;; ++i) {
    int u;
    if (ticket != nullptr) {
      int v = 0;
      if (l == 0) v = (int)atomicAdd(ticket, 1u);
      v = __shfl_sync(0xffffffffu, v, 0);
      u = v < sh.units ? v : -1;
    } else {
      const long v = blockIdx.x + (long)i * gridDim.x;
      u = v < sh.units ? (int)v : -1;
    }
    reuse(i);
    if (u < 0) break;
    const int bh = u / sh.per, row0 = (u - bh * sh.per) * R;
    if (l == 0) sh.units_at[i % rn] = u;
    issue(sh.rent(i), sh.e.rtensors, sh.g.rtensor, sh.e.rfloats, sh.g.rrows, sh.rfull(i % rn),
          r1, r2, bh, row0, min(R, n - row0));
    for (int tt = 0; tt < sh.ntiles; ++tt, ++c) {
      if (c >= tn) mbar_wait(sh.tfree(c % tn), ((c / tn) - 1) & 1);
      issue(sh.tent(c), 2, sh.g.ttensor, sh.e.tfloats, sh.g.trows,
            sh.tfull(c % tn), t1, t2, bh, tt * TILE, min(TILE, n - tt * TILE));
    }
  }
  // the walk's end: one entry of unit -1 for each warpgroup that waits on
  // its own entries (ping-pong), one for both (lockstep)
  const int m = i;
  for (int s = 0; s < (sh.pingpong ? 2 : 1); ++s, ++i) {
    if (s > 0) reuse(i);
    if (l == 0) sh.units_at[i % rn] = -1;
    mbar_arrive(sh.rfull(i % rn));
  }
  for (int j = max(i - rn, 0); j < m; ++j) {  // the last units' outputs
    mbar_wait(sh.rfree(j % rn), (j / rn) & 1);
    if (l == 0) store(j);
  }
  if (l == 0) bulk_wait<0>();
}

}  // namespace l2
}  // namespace vk
