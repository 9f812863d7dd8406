// Dense multi-vector pass B  Y = X (c .* Z)  for Hopper (sm_90a), the c
// scale fused, over s <= kern::kMaxCols vectors at once.
//
// Replaces the Pallas TPU kernel repro/kernels/glm_hvp.py::x_cz_multi
// (_x_cz_multi_kernel). On the DiSCO main path it is pass B of the s-step
// round's batched HVP on dense input.
//
// Layout: X (d, n) f32, row-major with row stride ld >= n elements; c
// (n,) f32 or null; Z (n, s) f32 row-major with row stride ldz >= s, as
// pass A and the all-reduce leave it; Y (d, s) f32 row-major. Element
// offsets are 64-bit.
//
// Design: x_cz's, widened to s vectors. Each CTA takes ROWS consecutive
// rows of X; its threads stride over the columns, a thread owning 4
// consecutive columns per chunk (one 16-byte load per row). Each column of
// c .* Z is used by exactly one thread, for all ROWS rows, so the thread
// forms it in registers: Z's row-major layout puts a thread's 4 columns'
// s values in 4 s contiguous floats and a warp's in one contiguous span of
// 128 s floats, which its scalar loads read through L1 (the block is in L2
// after the first CTAs). The loop has no barrier: all ROWS loads of X are
// issued before the multiply-adds. Each thread keeps ROWS * s partial sums
// in registers; warp shuffles and then one pass over the warps' sums in
// shared memory, in a fixed order, give Y. No atomics: repeatable bit for
// bit. ROWS = 8 (twice x_cz's 4) halves how often the s-times-larger Z
// is read from L2 for each row of X.
//
// Bound: device-memory bytes (2 s flops per 4-byte element of X, below the
// card's ~20 flops per byte at s <= 8).
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;   // block size the kernel is compiled for

constexpr int ROWS = 8;

template <bool VEC4, bool HAS_C>
__global__ void __launch_bounds__(kMaxThreads)
x_cz_multi_kernel(const float* __restrict__ X, int64_t ld,
                  const float* __restrict__ c,
                  const float* __restrict__ Z, int64_t ldz,
                  float* __restrict__ Y, int d, int n,
                  int s) {
  __shared__ float red[ROWS * kern::kMaxCols][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int r0 = blockIdx.x * ROWS;
  const int nr = min(ROWS, d - r0);
  const float* row = X + static_cast<int64_t>(r0) * ld;
  float acc[ROWS][kern::kMaxCols];
#pragma unroll
  for (int k = 0; k < ROWS; ++k)
#pragma unroll
    for (int j = 0; j < kern::kMaxCols; ++j) acc[k][j] = 0.f;

  // VEC4: columns col..col+3 (n % 4 == 0, so col < n covers col + 3);
  // else the single column col
  const int64_t step = (VEC4 ? 4 : 1) * static_cast<int64_t>(blockDim.x);
  for (int64_t col = (VEC4 ? 4 : 1) * static_cast<int64_t>(threadIdx.x);
       col < n; col += step) {
    if (VEC4) {
      float4 x[ROWS];
#pragma unroll
      for (int k = 0; k < ROWS; ++k)
        x[k] = k < nr ? __ldg(reinterpret_cast<const float4*>(row + k * ld + col))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 cc = HAS_C ? __ldg(reinterpret_cast<const float4*>(c + col))
                              : make_float4(1.f, 1.f, 1.f, 1.f);
      const float* z = Z + col * ldz;
#pragma unroll
      for (int j = 0; j < kern::kMaxCols; ++j) {
        if (j < s) {
          const float z0 = cc.x * __ldg(z + j);
          const float z1 = cc.y * __ldg(z + ldz + j);
          const float z2 = cc.z * __ldg(z + 2 * ldz + j);
          const float z3 = cc.w * __ldg(z + 3 * ldz + j);
#pragma unroll
          for (int k = 0; k < ROWS; ++k)
            acc[k][j] += x[k].x * z0 + x[k].y * z1 + x[k].z * z2 + x[k].w * z3;
        }
      }
    } else {
      float x[ROWS];
#pragma unroll
      for (int k = 0; k < ROWS; ++k) x[k] = k < nr ? __ldg(row + k * ld + col) : 0.f;
      const float cc = HAS_C ? __ldg(c + col) : 1.f;
#pragma unroll
      for (int j = 0; j < kern::kMaxCols; ++j) {
        if (j < s) {
          const float zj = cc * __ldg(Z + col * ldz + j);
#pragma unroll
          for (int k = 0; k < ROWS; ++k) acc[k][j] += x[k] * zj;
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
#pragma unroll
    for (int j = 0; j < kern::kMaxCols; ++j) {
      if (j < s) {                         // uniform over the CTA
        const float sum = kern::warp_sum(acc[k][j]);
        if (lane == 0) red[k * kern::kMaxCols + j][warp] = sum;
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nr * s; e += blockDim.x) {
    const int k = e / s;
    const int j = e - k * s;
    float sum = 0.f;
    for (int w = 0; w < nwarps; ++w) sum += red[k * kern::kMaxCols + j][w];
    Y[static_cast<int64_t>(r0 + k) * s + j] = sum;
  }
}

template <bool VEC4, bool HAS_C>
cudaError_t launch(const float* X, int64_t ld, const float* c, const float* Z,
                   int64_t ldz, float* Y, int d, int n, int s, int threads,
                   cudaStream_t stream) {
  x_cz_multi_kernel<VEC4, HAS_C><<<(d + ROWS - 1) / ROWS, threads, 0, stream>>>(
      X, ld, c, Z, ldz, Y, d, n, s);
  return cudaGetLastError();
}

}  // namespace

// C entry point, called through ctypes; c may be null (no scale). Returns
// a cudaError_t (0 = launched).
extern "C" int x_cz_multi_launch(const float* X, long long ld, const float* c,
                                 const float* Z, long long ldz, float* Y,
                                 int d, int n, int s, int threads,
                                 void* stream) {
  if (d <= 0 || n <= 0 || ld < n || s <= 0 || s > kern::kMaxCols ||
      ldz < s || threads < 32 || threads % 32 != 0 || threads > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec4 = n % 4 == 0 && ld % 4 == 0 &&
                    (reinterpret_cast<uintptr_t>(X) & 15) == 0 &&
                    (reinterpret_cast<uintptr_t>(c) & 15) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (vec4)
    err = c ? launch<true, true>(X, ld, c, Z, ldz, Y, d, n, s, threads, st)
            : launch<true, false>(X, ld, c, Z, ldz, Y, d, n, s, threads, st);
  else
    err = c ? launch<false, true>(X, ld, c, Z, ldz, Y, d, n, s, threads, st)
            : launch<false, false>(X, ld, c, Z, ldz, Y, d, n, s, threads, st);
  return static_cast<int>(err);
}
