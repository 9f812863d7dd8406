// Device helpers shared by the blocked-ELL kernels (ell_mv.cu, ell_hvp.cu,
// ell_mm.cu, ell_hvp_mm.cu).
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

// Multi-vector twin of tile_rows_dot, for up to kern::kMaxCols vectors:
// acc[k][j] += sum_b tile[r_k, b] * vecT[j * cols + b] for the RPW rows
// r_k = r_first + k * rstep of this warp (rows past `rows` read nothing).
// vecT holds the s vectors' block s-major in shared memory, so the lanes'
// 16-byte reads of one vector are contiguous (no bank conflicts). Lanes
// stride over the columns (each tile row is read coalesced), every row's
// loads are issued before its multiply-adds, and each lane keeps its own
// partial sums in registers: the caller reduces them over the lanes.
template <bool VEC4, int RPW>
__device__ __forceinline__ void tile_rows_mm(const float* __restrict__ tile,
                                             const float* __restrict__ vecT,
                                             float (&acc)[RPW][kern::kMaxCols],
                                             int r_first, int rstep, int rows,
                                             int cols, int s, int lane) {
  if (VEC4) {
    const int nq = cols >> 2;
    for (int q = lane; q < nq; q += 32) {
      float4 x[RPW];
#pragma unroll
      for (int k = 0; k < RPW; ++k) {
        const int r = r_first + k * rstep;
        x[k] = r < rows ? __ldg(reinterpret_cast<const float4*>(
                              tile + static_cast<size_t>(r) * cols) + q)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int j = 0; j < kern::kMaxCols; ++j) {
        if (j < s) {
          const float4 v = reinterpret_cast<const float4*>(vecT + j * cols)[q];
#pragma unroll
          for (int k = 0; k < RPW; ++k)
            acc[k][j] += x[k].x * v.x + x[k].y * v.y + x[k].z * v.z +
                         x[k].w * v.w;
        }
      }
    }
  } else {
    for (int b = lane; b < cols; b += 32) {
      float x[RPW];
#pragma unroll
      for (int k = 0; k < RPW; ++k) {
        const int r = r_first + k * rstep;
        x[k] = r < rows ? __ldg(tile + static_cast<size_t>(r) * cols + b) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kern::kMaxCols; ++j) {
        if (j < s) {
          const float v = vecT[j * cols + b];
#pragma unroll
          for (int k = 0; k < RPW; ++k) acc[k][j] += x[k] * v;
        }
      }
    }
  }
}

// vecT[j * len + b] = (c .* M)[base + b, j] for b < len, j < s: the s
// vectors' block of a row-major (., ld) matrix M, s-major in shared memory
// for tile_rows_mm, the scale c (or none) applied on load.
template <bool HAS_C>
__device__ __forceinline__ void stage_block(float* __restrict__ vecT,
                                            const float* __restrict__ M,
                                            int64_t ld,
                                            const float* __restrict__ c,
                                            size_t base, int len, int s) {
  for (int e = threadIdx.x; e < s * len; e += blockDim.x) {
    const int j = e / len;
    const int b = e - j * len;
    const float v = __ldg(M + (base + b) * ld + j);
    vecT[e] = HAS_C ? __ldg(c + base + b) * v : v;
  }
}

}  // namespace ell
