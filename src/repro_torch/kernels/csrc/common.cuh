// Device helpers shared by every kernel of the port.
#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace kern {

// Most columns (probe vectors) one launch of a multi-vector kernel takes
// (ell_mm, ell_hvp_mm, xt_multi, x_cz_multi): each thread keeps that many
// accumulators per output row or column in registers. The wrappers check
// it (MAX_COLS in kernels/build.py) and the entry points refuse more.
constexpr int kMaxCols = 8;

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_down_sync(0xffffffffu, s, off);
  return s;
}

// Dynamic shared memory above 48 KB must be opted into per kernel.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace kern
