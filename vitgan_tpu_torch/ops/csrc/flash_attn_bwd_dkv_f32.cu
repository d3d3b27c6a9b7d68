// Flash-attention backward dK and dV in f32, `dot` and `l2` scores, for
// Hopper (sm_90a): flash_f32_bwd.cuh's k-block kernel
// (flash_bwd_kv_tf32_kernel, FUSED = false) on TF32 wgmma.  Replaces the TPU
// kernels `_flash_bwd_dkv_kernel` and `_flash_bwd_dkv_kernel_dma`
// (vitgan_tpu/ops/attention.py:434-504, pallas_call at :727) at f32 inputs,
// the two-pass route's second pass.
//
// Bound on this card (4-byte operands): four products of 2 N^2 Dh flops a
// head (S^T, dP^T, dV, dK) at 494.7 TFLOP/s TF32 against q/k/v/dO read and
// dK, dV written (6 N Dh 4 bytes) and the rows at 3.35 TB/s; at highres128's
// D (32 x 6 heads of 1,025 tokens, Dh 64) 0.209 ms of products.
#include "flash_f32_bwd.cuh"

// Arguments as flash_attn_bwd_dq_f32's; dk, dv: (bh, n, d) f32.
extern "C" int flash_attn_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dk, void* dv, int bh, int n, int d, float inv_scale,
                                      int mode, int, void* stream) {
  return vk::f32bwd::dispatch<false>(q, k, v, dout, lse, delta, dk, dv, nullptr, nullptr,
                                     nullptr, bh, n, d, inv_scale, mode,
                                     static_cast<cudaStream_t>(stream));
}
