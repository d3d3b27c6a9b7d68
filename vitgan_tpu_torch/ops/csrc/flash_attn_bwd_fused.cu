// Flash-attention backward dQ, dK and dV in one sweep, `dot` and `l2` scores,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel `_flash_bwd_fused_kernel` / `_flash_backward_fused`
// (vitgan_tpu/ops/attention.py:507-621, launched at :606): five products a
// tile instead of the two-pass route's seven.  The k-block kernel of
// flash_attn_bwd.cuh with FUSED = true (the wgmma/TMA kernel for `dot`, the
// mma.sync one for `l2`) adds each tile's dS K into an f32 buffer (for `l2`
// also each row's sum of dS, into one f32 per row); a second kernel scales
// it by inv_scale, or for `l2` forms 2 inv_scale (acc - rowsum q), and casts
// it to bf16.  dQ's bits vary from run to run with the order of the
// additions, in both modes.
//
// Bound on this card.  At the highres128 generator's shape (32*6 heads,
// 1,024 tokens, Dh 64) a launch does five products of 2*N*N*Dh flops per
// head, 1.29e11 flops, on 178 MB of q/k/v/dO/dq/dk/dv and rows: 0.13 ms of
// tensor-core time against 0.05 ms of HBM time.  The `dot` kernel's dQ
// additions are N/128 * N * Dh per head (1.0e8 at this shape, 2.0e8 before),
// four floats a RED through the L2.
//
// ptxas -v (sm_90a, CUDA 12.8): the `dot` instantiations launch at 168
// registers a thread (the producer warpgroup drops to 40, the consumers take
// 232 by setmaxnreg); at DP 80-128 16 bytes of spills and wgmmas serialised
// for want of registers (C7512), at DP <= 64 neither; dynamic shared memory
// 151,128 bytes at DP <= 64, 165,928 at DP 80-128.  The `l2` ones (mma.sync)
// spill 44-356 bytes at DP 96-128.
#include "flash_attn_bwd.cuh"

namespace {

// dq = scale * acc (`dot`), or 2 scale (acc - rs[row] q) (`l2`), cast to bf16.
template <int MODE>
__global__ void scale_cast_kernel(const float* __restrict__ acc, const float* __restrict__ rs,
                                  const vk::bf16* __restrict__ q, vk::bf16* __restrict__ out,
                                  long count, int d, float scale) {
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < count;
       i += (long)gridDim.x * blockDim.x) {
    if constexpr (MODE == vk::kL2)
      out[i] = __float2bfloat16(2.f * scale * (acc[i] - rs[i / d] * __bfloat162float(q[i])));
    else
      out[i] = __float2bfloat16(acc[i] * scale);
  }
}

}  // namespace

// As flash_attn_bwd_dkv, plus dq (bh, n, d) bf16, dq_acc, an f32 scratch
// buffer of the same shape, and for `l2` (mode 1) rs_acc, an f32 (bh, n)
// scratch buffer (both zeroed here).
extern "C" int flash_attn_bwd_fused(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dq, void* dk, void* dv, void* dq_acc, void* rs_acc,
                                    int bh, int n, int d, float inv_scale, int mode,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long count = (long)bh * n * d;
  if (mode == vk::kL2 && rs_acc == nullptr) return (int)cudaErrorInvalidValue;
  cudaMemsetAsync(dq_acc, 0, count * sizeof(float), s);
  if (mode == vk::kL2) cudaMemsetAsync(rs_acc, 0, (long)bh * n * sizeof(float), s);
  const int err = vk::bwd::dispatch_kv<true>(q, k, v, dout, lse, delta, dk, dv, dq_acc, rs_acc,
                                             bh, n, d, inv_scale, mode, s);
  if (err != 0) return err;
  const int blocks = (int)((count + 255) / 256 < 4096 ? (count + 255) / 256 : 4096);
  const float* acc = static_cast<const float*>(dq_acc);
  vk::bf16* out = static_cast<vk::bf16*>(dq);
  if (mode == vk::kL2)
    scale_cast_kernel<vk::kL2><<<blocks, 256, 0, s>>>(acc, static_cast<const float*>(rs_acc),
                                                      static_cast<const vk::bf16*>(q), out,
                                                      count, d, inv_scale);
  else
    scale_cast_kernel<vk::kDot><<<blocks, 256, 0, s>>>(acc, nullptr, nullptr, out, count, d,
                                                       inv_scale);
  return (int)cudaGetLastError();
}
