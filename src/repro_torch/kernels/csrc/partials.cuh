// The second pass of the fused dense kernels, which split a reduction
// across clusters (x_c_xt_u.cu, x_c_xt_multi.cu): out[j] = sum_s
// part[s * len + j], the S rows added in order s = 0, 1, ..., so the
// result does not depend on which CTA finished first.
#pragma once

#include "common.cuh"

namespace kern {

__global__ void sum_rows_kernel(const float* __restrict__ part,
                                float* __restrict__ out, int rows, int len) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= len) return;
  float s = 0.f;
  for (int r = 0; r < rows; ++r) s += __ldg(part + static_cast<size_t>(r) * len + j);
  out[j] = s;
}

inline cudaError_t sum_rows(const float* part, float* out, int rows, int len,
                            cudaStream_t stream) {
  const int threads = 256;
  sum_rows_kernel<<<(len + threads - 1) / threads, threads, 0, stream>>>(
      part, out, rows, len);
  return cudaGetLastError();
}

}  // namespace kern
