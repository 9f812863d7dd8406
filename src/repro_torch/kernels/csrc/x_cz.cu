// Dense pass B  y = X (c .* z)  for Hopper (sm_90a), the c scale fused.
//
// Replaces the Pallas TPU kernel repro/kernels/glm_hvp.py::x_cz
// (_x_cz_kernel). On the DiSCO main path it is pass B of every two-pass
// dense HVP, and the second half of the fused route when x_c_xt_u's panel
// does not fit.
//
// Layout: X (d, n) f32, row-major with row stride ld >= n elements; c
// (optional) and z (n,), y (d,) f32. Element offsets are 64-bit.
//
// Design: one dot product per row over n (at the full width a row is
// 1 MiB). Each CTA takes ROWS consecutive rows; its threads stride over
// the columns with 16-byte loads, form c .* z for a column chunk once and
// use it for all ROWS rows, so the vectors (which stay in L2) are read once
// per ROWS rows of X. Each thread keeps one partial per row in registers;
// warp shuffles and then one pass over the warps' sums in shared memory,
// in a fixed order, give y. No atomics: repeatable bit for bit.
//
// Bound: device-memory bytes (2 flops per 4-byte element of X).
#include "common.cuh"

namespace {

constexpr int ROWS = 4;

template <bool VEC4, bool HAS_C>
__global__ void x_cz_kernel(const float* __restrict__ X, int64_t ld,
                            const float* __restrict__ c,
                            const float* __restrict__ z,
                            float* __restrict__ y, int d, int n) {
  __shared__ float red[ROWS][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int r0 = blockIdx.x * ROWS;
  const int nr = min(ROWS, d - r0);
  const float* row = X + static_cast<int64_t>(r0) * ld;
  float acc[ROWS];
#pragma unroll
  for (int k = 0; k < ROWS; ++k) acc[k] = 0.f;

  if (VEC4) {
    const int nq = n >> 2;
    const float4* z4 = reinterpret_cast<const float4*>(z);
    const float4* c4 = reinterpret_cast<const float4*>(c);
#pragma unroll 2
    for (int q = threadIdx.x; q < nq; q += blockDim.x) {
      float4 v = __ldg(z4 + q);
      if (HAS_C) {
        const float4 s = __ldg(c4 + q);
        v = make_float4(s.x * v.x, s.y * v.y, s.z * v.z, s.w * v.w);
      }
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        if (k < nr) {
          const float4 x = __ldg(reinterpret_cast<const float4*>(
              row + k * ld + 4 * static_cast<int64_t>(q)));
          acc[k] += x.x * v.x + x.y * v.y + x.z * v.z + x.w * v.w;
        }
      }
    }
  } else {
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const float v = HAS_C ? __ldg(c + j) * __ldg(z + j) : __ldg(z + j);
#pragma unroll
      for (int k = 0; k < ROWS; ++k)
        if (k < nr) acc[k] += __ldg(row + k * ld + j) * v;
    }
  }

#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const float s = kern::warp_sum(acc[k]);
    if (lane == 0) red[k][warp] = s;
  }
  __syncthreads();
  if (threadIdx.x < nr) {
    float s = 0.f;
    for (int w = 0; w < nwarps; ++w) s += red[threadIdx.x][w];
    y[r0 + threadIdx.x] = s;
  }
}

template <bool VEC4, bool HAS_C>
cudaError_t launch(const float* X, int64_t ld, const float* c, const float* z,
                   float* y, int d, int n, int threads, cudaStream_t stream) {
  x_cz_kernel<VEC4, HAS_C><<<(d + ROWS - 1) / ROWS, threads, 0, stream>>>(
      X, ld, c, z, y, d, n);
  return cudaGetLastError();
}

}  // namespace

// C entry point, called through ctypes; c may be null (no scale). Returns
// a cudaError_t (0 = launched).
extern "C" int x_cz_launch(const float* X, long long ld, const float* c,
                           const float* z, float* y, int d, int n,
                           int threads, void* stream) {
  if (d <= 0 || n <= 0 || ld < n || threads <= 0 || threads % 32 != 0 ||
      threads > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec4 = n % 4 == 0 && ld % 4 == 0 &&
                    (reinterpret_cast<uintptr_t>(X) & 15) == 0 &&
                    (reinterpret_cast<uintptr_t>(z) & 15) == 0 &&
                    (reinterpret_cast<uintptr_t>(c) & 15) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (vec4)
    err = c ? launch<true, true>(X, ld, c, z, y, d, n, threads, s)
            : launch<true, false>(X, ld, c, z, y, d, n, threads, s);
  else
    err = c ? launch<false, true>(X, ld, c, z, y, d, n, threads, s)
            : launch<false, false>(X, ld, c, z, y, d, n, threads, s);
  return static_cast<int>(err);
}
