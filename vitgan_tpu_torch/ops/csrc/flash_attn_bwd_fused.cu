// Flash-attention backward dQ, dK and dV in one sweep, `dot` scores, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_flash_bwd_fused_kernel` / `_flash_backward_fused`
// (vitgan_tpu/ops/attention.py:507-621, launched at :606): five products a
// tile instead of the two-pass route's seven.  The k-block kernel of
// flash_attn_bwd.cuh with FUSED = true adds each tile's dS K into an f32
// buffer with atomics; a second kernel scales it by inv_scale and casts it to
// bf16.  dQ's bits vary from run to run with the order of the atomics.
//
// Bound on this card.  At the highres128 generator's shape (32*6 heads,
// 1,024 tokens, Dh 64) a launch does five products of 2*N*N*Dh flops per
// head, 1.29e11 flops, on 178 MB of q/k/v/dO/dq/dk/dv and rows: 0.13 ms of
// tensor-core time against 0.05 ms of HBM time.  The f32 atomics add
// N/64 * N * Dh additions per head (2.0e8 at this shape) through the L2.
#include "flash_attn_bwd.cuh"

namespace {

__global__ void scale_cast_kernel(const float* __restrict__ acc, vk::bf16* __restrict__ out,
                                  long count, float scale) {
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < count;
       i += (long)gridDim.x * blockDim.x)
    out[i] = __float2bfloat16(acc[i] * scale);
}

}  // namespace

// As flash_attn_bwd_dkv, plus dq (bh, n, d) bf16 and dq_acc, an f32 scratch
// buffer of the same shape (zeroed here).
extern "C" int flash_attn_bwd_fused(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dq, void* dk, void* dv, void* dq_acc, int bh, int n,
                                    int d, float inv_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long count = (long)bh * n * d;
  cudaMemsetAsync(dq_acc, 0, count * sizeof(float), s);
  const int err = vk::bwd::dispatch_kv<true>(q, k, v, dout, lse, delta, dk, dv, dq_acc, bh, n,
                                             d, inv_scale, s);
  if (err != 0) return err;
  const long blocks = (count + 255) / 256;
  scale_cast_kernel<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(
      static_cast<const float*>(dq_acc), static_cast<vk::bf16*>(dq), count, inv_scale);
  return (int)cudaGetLastError();
}
