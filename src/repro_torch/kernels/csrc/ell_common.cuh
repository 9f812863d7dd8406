// Device helpers shared by the blocked-ELL kernels (ell_mv.cu, ell_hvp.cu).
#pragma once

#include "common.cuh"

namespace ell {

// part[r * 32 + lane] += sum_b tile[r, b] * vec[b] for the rows r of this
// warp (r = warp, warp + nwarps, ...). tile is (rows, cols) row-major in
// device memory; vec (cols,) sits in shared memory. Lanes stride over the
// columns, so each tile row is read coalesced; every partial stays with the
// one thread that owns it, so no barrier is needed between calls. With VEC4
// each lane reads 16 bytes (cols % 4 == 0 and 16-byte aligned rows).
template <bool VEC4>
__device__ __forceinline__ void tile_rows_dot(const float* __restrict__ tile,
                                              const float* __restrict__ vec,
                                              float* __restrict__ part,
                                              int rows, int cols, int lane,
                                              int warp, int nwarps) {
#pragma unroll 4
  for (int r = warp; r < rows; r += nwarps) {
    float acc = 0.f;
    if (VEC4) {
      const float4* t4 =
          reinterpret_cast<const float4*>(tile + static_cast<size_t>(r) * cols);
      const float4* v4 = reinterpret_cast<const float4*>(vec);
      const int nq = cols >> 2;
      for (int q = lane; q < nq; q += 32) {
        const float4 a = __ldg(t4 + q);
        const float4 b = v4[q];
        acc += a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
      }
    } else {
      const float* t = tile + static_cast<size_t>(r) * cols;
      for (int b = lane; b < cols; b += 32) acc += __ldg(t + b) * vec[b];
    }
    part[r * 32 + lane] += acc;
  }
}

}  // namespace ell
