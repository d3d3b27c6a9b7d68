// dmlp = g * m2 in f32 for Hopper (sm_90a): ln_rows.cuh's mask_rows_kernel on
// f32 rows.  Replaces, at f32 inputs, the dropout mask's application to the
// output cotangent in `_bwd_kernel` (vitgan_tpu/ops/fused_block.py:529,
// pallas_call at :700).  dmlp is an output of its own: wgrad_gemm_f32's db2
// and dW2 read it.  Bound on this card: bytes (g and m2 read, dmlp written,
// 151 MB at highres128's G: 0.045 ms).
#include "ln_rows.cuh"

// dmlp (m, e) f32 = g * m2.  g: (m, e) f32; m2: (m, e) f32; bases 16-byte
// aligned; e a multiple of 8.
extern "C" int megablock_bwd_mask_rows_f32(const void* g, const void* m2, void* dmlp, int m,
                                           int e, void* stream) {
  return vk::lnrows::mask_rows<float>(g, m2, dmlp, m, e, stream);
}
