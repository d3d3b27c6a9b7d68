// Flash-attention backward dK and dV, `dot` and `l2` scores, for Hopper (sm_90a).
//
// Replaces the TPU kernels `_flash_bwd_dkv_kernel` and its K/V-streaming
// variant `_flash_bwd_dkv_kernel_dma` (vitgan_tpu/ops/attention.py:434-504,
// launched at :727): here Q and dO always stream through shared memory one
// tile at a time, at any length.  `dot` runs the wgmma/TMA k-block kernel of
// flash_attn_bwd.cuh (FUSED = false), one block a 128-key block; `l2` runs
// the persistent kernel of flash_l2_bwd.cuh (flash_bwd_dkv_l2_kernel), one
// block an SM walking many (head, 64-key) units, which reads and writes the
// unpadded (B, H, N, 108) tensors of the v1 discriminator.  Each header says
// what its kernel computes and how.  dK and dV are bit-deterministic (each
// block owns its keys).
//
// Bound on this card.  At the highres128 discriminator's shape (64*6 heads,
// 1,025 tokens, Dh 64) a launch does four products of 2*N*N*Dh flops per
// head, 2.07e11 flops, on 305 MB of q/k/v/dO/dk/dv and rows: 0.21 ms of
// tensor-core time against 0.09 ms of HBM time, so the tensor cores bound
// it.  At the v1 discriminator's `l2` shape (128*2*4 heads, 50 tokens,
// Dh 108) the 58 MB of q/k/v/dO/dk/dv bound it (0.017 ms) against 1.1e9
// flops (0.001 ms).
//
// ptxas -v (sm_90a, CUDA 12.8): the `dot` instantiations launch at 168
// registers a thread (40 producer / 232 consumer by setmaxnreg); at DP
// 80-128 16 bytes of spills and wgmmas serialised for want of registers
// (C7512), at DP <= 64 neither; dynamic shared memory 118,360 bytes at DP
// <= 64 (five stages), 133,160 at DP 80-128 (two stages of two boxes).  The
// `l2` kernel: PERF.md.
#include "flash_attn_bwd.cuh"
#include "flash_l2_bwd.cuh"

// q, k, v, dout: (bh, n, d) bf16, contiguous; `dot`: 16-byte aligned, d a
// multiple of 8 and at most 128; `l2`: 8-byte aligned, d a multiple of 4 and
// at most 128, `grid` the persistent blocks (ops/attention.l2_grid).  lse
// (natural log) and delta: (bh, n) f32.  dk, dv: (bh, n, d) bf16.  inv_scale
// multiplies q.k (`dot`) or the distance; mode 0 `dot`, 1 `l2`.
extern "C" int flash_attn_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, void* dk, void* dv,
                                  int bh, int n, int d, float inv_scale, int mode, int grid,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case vk::kDot:
      if (d % 8 != 0) return (int)cudaErrorInvalidValue;
      return vk::bwd::wg::dispatch<false>(q, k, v, dout, lse, delta, dk, dv, nullptr, nullptr,
                                          nullptr, bh, n, d, inv_scale, s);
    case vk::kL2:
      return vk::l2::dispatch<vk::l2::kDkv>(q, k, v, dout, lse, delta, dk, dv, nullptr, nullptr,
                                            nullptr, bh, n, d, inv_scale, grid, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
