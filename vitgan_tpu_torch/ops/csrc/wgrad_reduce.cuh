// The weight-gradient kernels' second pass (wgrad_gemm.cu in bf16,
// wgrad_gemm_f32.cu in f32): the per-split dW partials and the per-split,
// per-row-tile db partials of their scratch, each summed in one fixed order.
#pragma once

#include "common.cuh"

namespace vk {
namespace wgrad {

// dw[x] = sum over s < splits of part[s * count + x] and db[y] = sum over
// q < bsplits of bpart[q * nb + y], in order, four values a thread.
__global__ void wgrad_reduce_kernel(const float* __restrict__ part,
                                    const float* __restrict__ bpart, float* __restrict__ dw,
                                    float* __restrict__ db, int splits, int bsplits, long count,
                                    int nb) {
  const long x = 4 * ((long)blockIdx.x * blockDim.x + threadIdx.x);
  const float* src;
  float* dst;
  long stride;
  int terms;
  if (x < count) {
    src = part + x, dst = dw + x, stride = count, terms = splits;
  } else if (x - count < nb) {
    src = bpart + (x - count), dst = db + (x - count), stride = nb, terms = bsplits;
  } else {
    return;
  }
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = 0; i < terms; ++i) {
    const float4 v = *reinterpret_cast<const float4*>(src + i * stride);
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  *reinterpret_cast<float4*>(dst) = s;
}

// Launch the reduce over count = ka * nb dW elements and nb db columns.
inline int reduce(const float* part, const float* bpart, float* dw, float* db, int splits,
                  int bsplits, long count, int nb, cudaStream_t s) {
  const long threads = (count + nb) / 4;
  wgrad_reduce_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, s>>>(part, bpart, dw, db,
                                                                         splits, bsplits, count,
                                                                         nb);
  return (int)cudaGetLastError();
}

}  // namespace wgrad
}  // namespace vk
