// Hopper-only helpers (sm_90a) of the port's redesigned kernels
// (wgrad_gemm.cu, flash_attn_bwd.cuh, flash_attn_fwd.cu, flash_attn_bwd_dq.cu,
// ln_mlp_fwd.cu, ln_qkv_fwd.cu, megablock_bwd_mlp.cu, megablock_bwd_ln1.cu,
// flash_l2.cuh and its `l2` kernels, tile_f32.cuh's TF32 tile,
// wgrad_gemm_f32.cu, flash_f32_bwd.cuh): mbarrier
// rings fed by TMA (tensor or 1-D bulk copies) or by cp.async, TMA tensor and
// 1-D bulk stores, wgmma descriptors and products (bf16, and TF32 on f32
// bits), warpgroup fences, acquire/release flags, register hand-over and the
// LayerNorm of a resident swizzled tile.
//
// Shared-memory tiles here are written by TMA with the 128-byte swizzle: a
// box is `rows` rows of 64 bf16 or 32 f32 (128 bytes), 16-byte chunk c of row
// r stored at chunk c ^ (r % 8), every box 1024-byte aligned.  Such a tile is a
// canonical wgmma operand in both majors (CUTLASS's Layout_{K,MN}_SW128_Atom):
//   K-major (the summed dimension contiguous): SBO = 1024 (8 rows), LBO
//     unused; a 16-deep step inside the 64-wide box adds 32 bytes to the
//     start address, the next box its byte offset;
//   MN-major (M or N contiguous, summed over rows): SBO = 1024 (8 rows of
//     the summed dimension), LBO = the byte offset of the next 64-wide box
//     along M or N; a 16-deep step adds 2048 bytes (16 rows).
// The host side builds the tensor maps with cuTensorMapEncodeTiled, fetched
// through cudaGetDriverEntryPoint, so no library links against libcuda.
#pragma once

#include <cuda.h>

#include "common.cuh"

namespace vk {
namespace hopper {

// The first 1024-byte-aligned address at or after p in shared memory (the
// 128-byte swizzle repeats every 1024 bytes; the caller asks for 1 KB more).
__device__ inline unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// --- mbarrier ----------------------------------------------------------------

// mbarrier.init: `count` arrivals complete a phase.
__device__ inline void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// fence.mbarrier_init: makes the inits visible before any thread (or the TMA
// unit) uses the barriers; the caller synchronises the block after it.
__device__ inline void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// mbarrier.arrive: one arrival (release semantics for this thread's writes).
__device__ inline void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// mbarrier.arrive.expect_tx: one arrival, and `bytes` more to come from TMA.
__device__ inline void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// mbarrier.try_wait.parity in a loop: returns once the phase of parity
// `parity` has completed (acquire semantics).
__device__ inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// --- cp.async onto mbarriers --------------------------------------------------

// cp.async of 8 (or 4) bytes into shared memory.
__device__ inline void cp_async8(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_u32(smem)), "l"(gmem)
               : "memory");
}
__device__ inline void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(smem)), "l"(gmem)
               : "memory");
}
// cp.async.mbarrier.arrive.noinc: one arrival on `bar` (counted among the
// arrivals its init expects), made once every cp.async this thread issued
// before it has landed.
__device__ inline void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// --- TMA ---------------------------------------------------------------------

// cp.async.bulk (global -> shared, 1-D, completion on an mbarrier): `bytes`
// contiguous bytes (a multiple of 16; both addresses 16-byte aligned),
// counted in the barrier's bytes.
__device__ inline void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// cp.async.bulk.tensor.2d (global -> shared, completion on an mbarrier): the
// box at coordinates (c0 innermost, c1) of `map`; out-of-bounds elements are
// written as zeros and counted in the barrier's bytes.
__device__ inline void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                   int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
// cp.async.bulk.tensor.3d: the same with a third coordinate.
__device__ inline void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                   int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// cp.async.bulk (shared -> global, 1-D, bulk group): `bytes` contiguous bytes
// (a multiple of 16; both addresses 16-byte aligned).  The writing threads
// fence_proxy_async() and synchronise before one issues it.
__device__ inline void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}

// cp.async.bulk.tensor.2d (shared -> global, bulk group): the box of `map` at
// coordinates (c0 innermost, c1) from shared memory `src` (the layout a load
// of the same box would write); elements out of bounds are not written.  The
// writing threads fence_proxy_async() and synchronise before one issues it.
__device__ inline void tma_store_2d(const CUtensorMap* map, const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}
// cp.async.bulk.commit_group: closes the bulk group of the stores issued so far.
__device__ inline void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// cp.async.bulk.wait_group.read N: at most N bulk groups still read shared
// memory (their sources may be written again); without .read, at most N
// groups have writes outstanding.
template <int N>
__device__ inline void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ inline void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// --- fences and barriers -----------------------------------------------------

// fence.proxy.async.shared::cta: this thread's ordinary shared-memory writes
// become visible to the async proxy (wgmma operand reads, TMA).
__device__ inline void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// bar.sync id, count: a named barrier over `count` threads (whole warps).
__device__ inline void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
// ld.acquire.gpu / st.release.gpu of a 32-bit flag in global memory: the
// release orders before the store every access that precedes it in this
// thread or, through a barrier, in the threads that reached it first; the
// acquire orders the accesses after it (also through a barrier) after it.
__device__ inline uint32_t ld_acquire_gpu(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ inline void st_release_gpu(uint32_t* p, uint32_t v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}
// setmaxnreg.{dec,inc}: the warpgroup gives up / takes registers.
template <int N>
__device__ inline void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ inline void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Byte offset of the 4-byte word holding columns 8 jj + 2 t, + 1 of row r in
// a 128-byte-swizzled 64-column box (16-byte chunk jj of row r at jj ^ r % 8):
// the word of an m64nN accumulator fragment (rows 16 wr + g + 8 h, columns
// 8 j + 2 t) in a staged or landed box.
__device__ inline int swz(int r, int jj, int t) { return r * 128 + ((jj ^ (r & 7)) << 4) + 4 * t; }
// The same for an f32 box (32 columns, 128 bytes a row): byte offset of the
// 8-byte pair holding columns 8 jj + 2 t, + 1 of row r (16-byte chunk
// 2 jj + t / 2 of the row at its swizzled place), jj < 4.
__device__ inline int swz_f32(int r, int jj, int t) {
  return r * 128 + (((2 * jj + (t >> 1)) ^ (r & 7)) << 4) + ((t & 1) << 3);
}

// The f32 LayerNorm statistics of row r of a resident tile of
// 128-byte-swizzled 64-column boxes `box` bytes apart (the swizzled chunk of
// column c of row r is c / 8 ^ r % 8), eight lanes a row: lane l of the row
// (l = lane % 8) holds 16-byte chunks l, l + 8, .. (E <= 384: six boxes) in
// v, the eight lanes one 128-byte row of a box together.  Over the e real
// columns: the mean, then the mean of squared deviations (the JAX package's
// order), each summed in the lane, then over the eight lanes by three
// shuffles; chunks past e read as zeros.  `off` is the row's chunk offset
// in a box: r * 128 + ((l ^ r % 8) << 4).  ln_rows.cuh's row_stats8 takes
// the same sums in the same order from rows in device memory, at any E.
__device__ inline void ln_row8(const unsigned char* as, int box, int off, int e, float eps,
                               float (&v)[6][8], float& mean, float& rstd) {
  const int l8 = threadIdx.x & 7, nch = e >> 3;
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (l8 + 8 * i < nch) raw = *reinterpret_cast<const uint4*>(as + i * box + off);
    const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&words[q]));
      v[i][2 * q] = f.x;
      v[i][2 * q + 1] = f.y;
      s += f.x + f.y;
    }
  }
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  mean = s / e;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < 6; ++i)
    if (l8 + 8 * i < nch)
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float d = v[i][k] - mean;
        sq += d * d;
      }
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  rstd = rsqrtf(sq / e + eps);
}

// Row LayerNorm, in place, of rows r0 .. r0 + 63 of a resident tile (as
// ln_row8): a warp takes four rows at a time (this warp of the warpgroup:
// rows r0 + 16 wr ..); columns past e stay TMA's zeros.  g and b (gamma,
// beta) may lie in global or shared memory.  The caller fences
// (fence.proxy.async) before wgmma reads the rows.
__device__ inline void ln_resident(unsigned char* as, int box, int r0, int e,
                                   const float* __restrict__ g, const float* __restrict__ b,
                                   float eps) {
  const int lane = threadIdx.x & 31, wr = (threadIdx.x & 127) >> 5, l8 = lane & 7;
  const int nch = e >> 3;
  for (int r1 = 0; r1 < 16; r1 += 4) {
    const int r = r0 + 16 * wr + r1 + (lane >> 3), off = r * 128 + ((l8 ^ (r & 7)) << 4);
    float v[6][8], mean, rstd;
    ln_row8(as, box, off, e, eps, v, mean, rstd);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const int c = l8 + 8 * i;
      if (c >= nch) continue;
      const float4 g0 = *reinterpret_cast<const float4*>(g + 8 * c);
      const float4 g1 = *reinterpret_cast<const float4*>(g + 8 * c + 4);
      const float4 b0 = *reinterpret_cast<const float4*>(b + 8 * c);
      const float4 b1 = *reinterpret_cast<const float4*>(b + 8 * c + 4);
      const float gs[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
      const float bs[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      uint32_t y[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        y[k] = pack_bf16((v[i][2 * k] - mean) * rstd * gs[2 * k] + bs[2 * k],
                         (v[i][2 * k + 1] - mean) * rstd * gs[2 * k + 1] + bs[2 * k + 1]);
      *reinterpret_cast<uint4*>(as + i * box + off) = make_uint4(y[0], y[1], y[2], y[3]);
    }
  }
}

// --- wgmma -------------------------------------------------------------------

// The 64-bit shared-memory matrix descriptor of a 128-byte-swizzled operand:
// start address, LBO and SBO in 16-byte units, layout type 1 (128B swizzle)
// in bits 62-63, base offset 0 (boxes are 1024-byte aligned).
__device__ inline uint64_t desc_sw128(const void* start, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(start) & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
// wgmma.fence: orders earlier register and shared-memory writes before the
// next wgmma reads them.
__device__ inline void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
// wgmma.commit_group: closes the group of the wgmmas issued so far.
__device__ inline void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wgmma.wait_group N: waits until at most N committed groups are pending.
template <int N>
__device__ inline void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving an accumulator across a wgmma wait.
template <int R>
__device__ inline void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// The same for register A operands of a wgmma still in flight: they stay
// allocated, unchanged, until this point.
template <int K>
__device__ inline void fence_frags(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// D (64 x 64, f32) = A . B (+ D when scale_d): both operands in shared memory
// (wgmma.mma_async m64n64k16 .bf16, descriptors); TA / TB are the transpose
// immediates (1: the operand is M- / N-major).
template <int TA, int TB>
__device__ inline void wgmma_ss64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31} "
      ", %32, %33, p, 1, 1, "
      "%35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// D (64 x 128, f32) = A . B (+ D when scale_d): both operands in shared memory
// (wgmma.mma_async m64n128k16 .bf16, descriptors); TA / TB are the transpose
// immediates (1: the operand is M- / N-major).
template <int TA, int TB>
__device__ inline void wgmma_ss128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63} "
      ", %64, %65, p, 1, 1, "
      "%67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// D (64 x 192, f32) = A . B (+ D when scale_d): both operands in shared memory
// (wgmma.mma_async m64n192k16 .bf16, descriptors); TA / TB are the transpose
// immediates (1: the operand is M- / N-major).
template <int TA, int TB>
__device__ inline void wgmma_ss192(float (&d)[96], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, "
      "%87, %88, %89, %90, %91, %92, %93, %94, %95} "
      ", %96, %97, p, 1, 1, "
      "%99, %100;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// D (64 x 256, f32) = A . B (+ D when scale_d): both operands in shared memory
// (wgmma.mma_async m64n256k16 .bf16, descriptors); TA / TB are the transpose
// immediates (1: the operand is M- / N-major).
template <int TA, int TB>
__device__ inline void wgmma_ss256(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, "
      "%87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, "
      "%103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, "
      "%117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127} "
      ", %128, %129, p, 1, 1, "
      "%131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// D (64 x 64, f32) += A . B: A (64 x 16 bf16) from registers in the
// mma.m16n8k16 A-fragment layout (warp i of the warpgroup holds rows
// 16i..16i+15), B from shared memory (descriptor); TB the transpose immediate.
template <int TB>
__device__ inline void wgmma_rs64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31} "
      ", {%32, %33, %34, "
      "%35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

// D (64 x 128, f32) += A . B: A (64 x 16 bf16) from registers in the
// mma.m16n8k16 A-fragment layout (warp i of the warpgroup holds rows
// 16i..16i+15), B from shared memory (descriptor); TB the transpose immediate.
template <int TB>
__device__ inline void wgmma_rs128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63} "
      ", {%64, %65, %66, "
      "%67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

// D (64 x 128, f32) = A . B (+ D when scale_d): TF32 operands (f32 bits, of
// which the tensor core reads the top 19) both in shared memory, both
// K-major: wgmma.mma_async m64n128k8 .tf32 takes no transpose.  A k8 step is
// 32 bytes of a 128-byte swizzle row, as bf16's k16.
__device__ inline void wgmma_tf32_ss128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63} "
      ", %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 128, f32) = A . B (+ D when scale_d): TF32 operands, A (64 x 8)
// from registers in the mma.m16n8k8 TF32 A-fragment layout (warp i of the
// warpgroup holds rows 16 i .. 16 i + 15: a0 (g, t), a1 (g + 8, t), a2 (g,
// t + 4), a3 (g + 8, t + 4)), B from shared memory K-major (descriptor).
__device__ inline void wgmma_tf32_rs128(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                        int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63} "
      ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// wgmma_tf32_ss128's m64n32k8 (both operands from shared memory, K-major).
__device__ inline void wgmma_tf32_ss32(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15} "
      ", %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}
// wgmma_tf32_rs128's m64n32k8 (A from registers, B from shared memory K-major).
__device__ inline void wgmma_tf32_rs32(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                       int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15} "
      ", {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// wgmma_tf32_ss128's m64n64k8 (both operands from shared memory, K-major).
__device__ inline void wgmma_tf32_ss64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31} "
      ", %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}
// wgmma_tf32_rs128's m64n64k8 (A from registers, B from shared memory K-major).
__device__ inline void wgmma_tf32_rs64(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                       int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31} "
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// wgmma_tf32_ss128's m64n96k8 (both operands from shared memory, K-major).
__device__ inline void wgmma_tf32_ss96(float (&d)[48], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47} "
      ", %48, %49, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(scale_d));
}
// wgmma_tf32_rs128's m64n96k8 (A from registers, B from shared memory K-major).
__device__ inline void wgmma_tf32_rs96(float (&d)[48], const uint32_t (&a)[4], uint64_t db,
                                       int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47} "
      ", {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// TF32 m64nNk8 products (the accumulator holds N / 2 floats a thread), N =
// 32, 64, 96 or 128: both operands from shared memory (ss), or A from
// registers (rs), as wgmma_tf32_ss128 and wgmma_tf32_rs128.
template <int N>
__device__ inline void wgmma_tf32_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (N == 32) {
    wgmma_tf32_ss32(d, a, b, scale_d);
  } else if constexpr (N == 64) {
    wgmma_tf32_ss64(d, a, b, scale_d);
  } else if constexpr (N == 96) {
    wgmma_tf32_ss96(d, a, b, scale_d);
  } else {
    static_assert(N == 128, "wgmma_tf32_ss takes N = 32, 64, 96 or 128");
    wgmma_tf32_ss128(d, a, b, scale_d);
  }
}
template <int N>
__device__ inline void wgmma_tf32_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                     int scale_d) {
  if constexpr (N == 32) {
    wgmma_tf32_rs32(d, a, b, scale_d);
  } else if constexpr (N == 64) {
    wgmma_tf32_rs64(d, a, b, scale_d);
  } else if constexpr (N == 96) {
    wgmma_tf32_rs96(d, a, b, scale_d);
  } else {
    static_assert(N == 128, "wgmma_tf32_rs takes N = 32, 64, 96 or 128");
    wgmma_tf32_rs128(d, a, b, scale_d);
  }
}

// m64nNk16 products (the accumulator holds N / 2 floats a thread): both
// operands from shared memory (N = 64, 128, 192 or 256), or A from registers
// (N = 64 or 128).
template <int N, int TA, int TB>
__device__ inline void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (N == 64) {
    wgmma_ss64<TA, TB>(d, a, b, scale_d);
  } else if constexpr (N == 128) {
    wgmma_ss128<TA, TB>(d, a, b, scale_d);
  } else if constexpr (N == 192) {
    wgmma_ss192<TA, TB>(d, a, b, scale_d);
  } else {
    static_assert(N == 256, "wgmma_ss takes N = 64, 128, 192 or 256");
    wgmma_ss256<TA, TB>(d, a, b, scale_d);
  }
}
template <int N, int TB>
__device__ inline void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 64) {
    wgmma_rs64<TB>(d, a, b);
  } else {
    wgmma_rs128<TB>(d, a, b);
  }
}

}  // namespace hopper
}  // namespace vk

// --- host: tensor maps -------------------------------------------------------

namespace vk {
namespace hopper {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The CUDA driver's cuTensorMapEncodeTiled, looked up once through the runtime
// (cudaGetDriverEntryPoint), or null.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tensor map of `type` and `rank` dimensions (innermost first): sizes
// `dims`, byte strides `strides` of dimensions 1.. (multiples of 16), box
// `box` (box[0] one 128-byte swizzle row: 64 bf16 or 32 f32), 128-byte
// swizzle, zeros out of bounds.  Returns 0 or a CUDA error code.
inline int make_tmap(CUtensorMap* map, CUtensorMapDataType type, const void* base, int rank,
                     const uint64_t* dims, const uint64_t* strides, const uint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, type, (cuuint32_t)rank, const_cast<void*>(base), dims, strides, box,
                        unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}
inline int make_tmap_bf16(CUtensorMap* map, const void* base, int rank, const uint64_t* dims,
                          const uint64_t* strides, const uint32_t* box) {
  return make_tmap(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, rank, dims, strides, box);
}

// The bf16 tensor map of a row-major (rows, cols) matrix, box 64 columns x
// box_rows rows, 128-byte swizzle.
inline int tmap_2d(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  const uint64_t dims[2] = {(uint64_t)cols, (uint64_t)rows}, strides[1] = {(uint64_t)cols * 2};
  const uint32_t box[2] = {64, (uint32_t)box_rows};
  return make_tmap_bf16(map, base, 2, dims, strides, box);
}

// The f32 tensor map of a row-major (rows, cols) matrix, box 32 columns (128
// bytes) x box_rows rows, 128-byte swizzle.  `type` TFLOAT32: the TMA unit
// rounds each f32 to TF32 (to nearest, ties to even) as it lands, so that a
// TF32 wgmma reads it rounded rather than truncated.
inline int tmap_2d_f32(CUtensorMap* map, const void* base, int rows, int cols, int box_rows,
                       CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_FLOAT32) {
  const uint64_t dims[2] = {(uint64_t)cols, (uint64_t)rows}, strides[1] = {(uint64_t)cols * 4};
  const uint32_t box[2] = {32, (uint32_t)box_rows};
  return make_tmap(map, type, base, 2, dims, strides, box);
}
inline int tmap_2d_tf32(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  return tmap_2d_f32(map, base, rows, cols, box_rows, CU_TENSOR_MAP_DATA_TYPE_TFLOAT32);
}
// The TFLOAT32 tensor map of a row-major (planes, rows, cols) f32 tensor, box
// 32 columns x box_rows rows of one plane, 128-byte swizzle: rows past `rows`
// and columns past `cols` land as zeros, never another plane's.
inline int tmap_3d_tf32(CUtensorMap* map, const void* base, int planes, int rows, int cols,
                        int box_rows) {
  const uint64_t dims[3] = {(uint64_t)cols, (uint64_t)rows, (uint64_t)planes};
  const uint64_t strides[2] = {(uint64_t)cols * 4, (uint64_t)rows * cols * 4};
  const uint32_t box[3] = {32, (uint32_t)box_rows, 1};
  return make_tmap(map, CU_TENSOR_MAP_DATA_TYPE_TFLOAT32, base, 3, dims, strides, box);
}

// The current device's SM count (the persistent grids' size), read once.
inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

}  // namespace hopper
}  // namespace vk
