// Flash-attention backward dQ, dK and dV in one sweep, `dot` and `l2` scores,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel `_flash_bwd_fused_kernel` / `_flash_backward_fused`
// (vitgan_tpu/ops/attention.py:507-621, launched at :606): five products a
// tile instead of the two-pass route's seven.  The k-block kernel of
// flash_attn_bwd.cuh with FUSED = true (the wgmma/TMA kernel for `dot`, the
// mma.sync one for `l2`) sums each tile's dS K over the k-blocks of a head
// in key-block order, on one int32 flag per (batch*head, 64-query tile),
// each block's place in that order its ticket, one more int32 after the
// flags; this entry zeroes them all.  So dQ is bit-deterministic in both
// modes, as the TPU kernel's is, and the launch finishes in any dispatch
// order.  `dot`: the last k-block scales the sum by inv_scale and stores
// bf16 dQ itself.  `l2`: the kernel also sums each row's dS, in warp order,
// into one f32 per row; a second kernel forms 2 inv_scale (acc - rowsum q)
// and casts it to bf16.
//
// Bound on this card.  At the highres128 generator's shape (32*6 heads,
// 1,024 tokens, Dh 64) a launch does five products of 2*N*N*Dh flops per
// head, 1.29e11 flops, on 178 MB of q/k/v/dO/dq/dk/dv and rows: 0.13 ms of
// tensor-core time against 0.05 ms of HBM time.  The `dot` kernel's dQ
// additions are N/128 * N * Dh per head (1.0e8 at this shape): the first
// k-block's tile stored, the middle ones' added four floats a RED through
// the L2, the last one's read back with the sum and stored as bf16.
//
// ptxas -v (sm_90a, CUDA 12.8): the `dot` instantiations launch at 168
// registers a thread (the producer warpgroup drops to 40, the consumers take
// 232 by setmaxnreg); at DP 80-128 32 bytes of spill stores and 44 of loads
// (the last k-block's sums of a 128-column tile) and wgmmas serialised for
// want of registers (C7512), at DP <= 64 neither; dynamic shared memory
// 151,128 bytes at DP <= 64, 165,928 at DP 80-128.  The `l2` ones (mma.sync)
// spill 56-564 bytes at DP 96-128.
#include "flash_attn_bwd.cuh"

namespace vk {
namespace bwd {

template <int DP>
int launch_kv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dk, void* dv, void* dq_acc, void* rs_acc, void* dq_order,
              int bh, int n, int d, float inv_scale, cudaStream_t stream) {
  const size_t smem = kv_smem_bytes<DP>();
  cudaFuncSetAttribute(flash_bwd_kv_kernel<DP, kL2>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  flash_bwd_kv_kernel<DP, kL2><<<(n + BK - 1) / BK * bh, NWARP * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      static_cast<float*>(dq_acc), static_cast<float*>(rs_acc), static_cast<uint32_t*>(dq_order),
      n, d, inv_scale * LOG2E, inv_scale);
  return (int)cudaGetLastError();
}

int dispatch_kv_l2(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dk, void* dv, void* dq_acc,
                   void* rs_acc, void* dq_order, int bh, int n, int d, float inv_scale,
                   cudaStream_t s) {
#define VK_KV(DP) \
  launch_kv<DP>(q, k, v, dout, lse, delta, dk, dv, dq_acc, rs_acc, dq_order, bh, n, d, inv_scale, s)
  switch ((d + 15) / 16) {
    case 1: return VK_KV(16);
    case 2: return VK_KV(32);
    case 3: return VK_KV(48);
    case 4: return VK_KV(64);
    case 5: return VK_KV(80);
    case 6: return VK_KV(96);
    case 7: return VK_KV(112);
    case 8: return VK_KV(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef VK_KV
}

// The single pass, mode 0 `dot`, 1 `l2`: dq_acc, the f32 sums of dQ; dq, the
// bf16 dQ the `dot` kernel finishes; rs_acc (`l2`), the rows' dS sums;
// dq_order, the flags of the order of the additions and the ticket after
// them (zeroed by the caller).
int dispatch_fused(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                   const void* delta, void* dk, void* dv, void* dq_acc, void* dq, void* rs_acc,
                   void* dq_order, int bh, int n, int d, float inv_scale, int mode,
                   cudaStream_t s) {
  if (d % 8 != 0) return (int)cudaErrorInvalidValue;
  switch (mode) {
    case kDot:
      return wg::dispatch<true>(q, k, v, dout, lse, delta, dk, dv, dq_acc, dq, dq_order, bh, n, d,
                                inv_scale, s);
    case kL2:
      return dispatch_kv_l2(q, k, v, dout, lse, delta, dk, dv, dq_acc, rs_acc, dq_order, bh, n,
                            d, inv_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace bwd
}  // namespace vk

namespace {

// The `l2` finish: dq = 2 scale (acc - rs[row] q), cast to bf16.
__global__ void scale_cast_kernel(const float* __restrict__ acc, const float* __restrict__ rs,
                                  const vk::bf16* __restrict__ q, vk::bf16* __restrict__ out,
                                  long count, int d, float scale) {
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < count;
       i += (long)gridDim.x * blockDim.x)
    out[i] = __float2bfloat16(2.f * scale * (acc[i] - rs[i / d] * __bfloat162float(q[i])));
}

}  // namespace

// As flash_attn_bwd_dkv, plus dq (bh, n, d) bf16; dq_acc, an f32 scratch
// buffer of the same shape (`dot`: needed only past 128 keys); for `l2`
// (mode 1) rs_acc, an f32 (bh, n) scratch buffer (both zeroed here); and
// dq_order, an int32 scratch buffer of bh * ceil(n / 64) flags and the ticket
// after them (zeroed here; needed past one k-block: 128 keys for `dot`, 64
// for `l2`).
extern "C" int flash_attn_bwd_fused(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dq, void* dk, void* dv, void* dq_acc, void* rs_acc,
                                    void* dq_order, int bh, int n, int d, float inv_scale,
                                    int mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long count = (long)bh * n * d;
  const int tiles = (n + vk::bwd::BQ - 1) / vk::bwd::BQ;
  const int kblocks = mode == vk::kDot ? (n + vk::bwd::wg::KEYS - 1) / vk::bwd::wg::KEYS : tiles;
  if (kblocks > 1 && (dq_acc == nullptr || dq_order == nullptr)) return (int)cudaErrorInvalidValue;
  if (mode == vk::kL2 && (rs_acc == nullptr || dq_acc == nullptr))
    return (int)cudaErrorInvalidValue;
  if (kblocks > 1) cudaMemsetAsync(dq_order, 0, ((long)bh * tiles + 1) * sizeof(uint32_t), s);
  if (mode == vk::kL2) {
    cudaMemsetAsync(dq_acc, 0, count * sizeof(float), s);
    cudaMemsetAsync(rs_acc, 0, (long)bh * n * sizeof(float), s);
  }
  const int err = vk::bwd::dispatch_fused(q, k, v, dout, lse, delta, dk, dv, dq_acc, dq, rs_acc,
                                          dq_order, bh, n, d, inv_scale, mode, s);
  if (err != 0 || mode != vk::kL2) return err;
  const int blocks = (int)((count + 255) / 256 < 4096 ? (count + 255) / 256 : 4096);
  scale_cast_kernel<<<blocks, 256, 0, s>>>(
      static_cast<const float*>(dq_acc), static_cast<const float*>(rs_acc),
      static_cast<const vk::bf16*>(q), static_cast<vk::bf16*>(dq), count, d, inv_scale);
  return (int)cudaGetLastError();
}
