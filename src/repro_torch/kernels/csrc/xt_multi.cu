// Dense multi-vector pass A  Z = X^T U  for Hopper (sm_90a), over
// s <= kern::kMaxCols probe vectors at once.
//
// Replaces the Pallas TPU kernel repro/kernels/glm_hvp.py::xt_multi
// (_xt_multi_kernel). On the DiSCO main path it is pass A of the s-step
// round's batched HVP on dense input (the (n, s) block DiSCO-F
// all-reduces between the passes).
//
// Layout: X (d, n) f32, row-major with row stride ld >= n elements (a
// column slice of a wider matrix is passed as a view); U (d, s) f32
// row-major with row stride ldu >= s; Z (n, s) f32 row-major. Element
// offsets are 64-bit.
//
// Design: column strips by row slices. Each CTA owns a strip of
// 4 * blockDim.x columns and a slice of rows; each thread keeps 4 * s sums
// (its 4 columns times the s vectors) in registers while it walks the
// rows, one 16-byte load of X per row (a warp reads 512 contiguous bytes).
// The slice's rows of U are staged in shared memory CHUNK rows at a time
// and each row's s values are read as a broadcast. When the strips alone
// are too few CTAs to fill the card, the wrapper splits d into S slices;
// slice s writes its sums to part[s, :, :] and a second kernel adds the S
// blocks in order. No atomics: repeatable bit for bit for given shapes.
//
// Bound: device-memory bytes. Each element of X is read once for s
// multiply-adds (2 s flops per 4 bytes: 10 at s = 5, below the card's
// ~20 flops per byte), so X's bytes bound it for all s vectors at once.
#include "partials.cuh"

namespace {

constexpr int kMaxThreads = 256;   // block size the kernel is compiled for

constexpr int CHUNK = 256;   // rows of U staged at a time

template <bool VEC4>
__global__ void __launch_bounds__(kMaxThreads)
xt_multi_kernel(const float* __restrict__ X, int64_t ld,
                const float* __restrict__ U, int64_t ldu,
                float* __restrict__ out, int d, int n, int s,
                int rows_per_slice) {
  __shared__ float uS[CHUNK * kern::kMaxCols];
  const int64_t T = blockDim.x;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * 4 * T;
  const int r0 = blockIdx.y * rows_per_slice;
  const int r1 = min(d, r0 + rows_per_slice);
  float* o = out + static_cast<int64_t>(blockIdx.y) * n * s;
  // VEC4: this thread's columns are col..col+3; else c0 + k * T, k < 4
  const int64_t col = col0 + 4 * static_cast<int64_t>(threadIdx.x);
  const int64_t c0 = col0 + threadIdx.x;
  float acc[4][kern::kMaxCols];
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int j = 0; j < kern::kMaxCols; ++j) acc[t][j] = 0.f;

  for (int rc = r0; rc < r1; rc += CHUNK) {
    const int nr = min(CHUNK, r1 - rc);
    __syncthreads();                       // all readers done with uS
    for (int e = threadIdx.x; e < nr * s; e += blockDim.x) {
      const int rr = e / s;
      const int j = e - rr * s;
      uS[rr * kern::kMaxCols + j] = __ldg(U + (rc + rr) * ldu + j);
    }
    __syncthreads();
    if (VEC4) {
      if (col < n) {                       // n % 4 == 0: col < n covers col + 3
        const float* p = X + static_cast<int64_t>(rc) * ld + col;
#pragma unroll 4
        for (int rr = 0; rr < nr; ++rr, p += ld) {
          const float4 x = __ldg(reinterpret_cast<const float4*>(p));
          const float* u = uS + rr * kern::kMaxCols;
#pragma unroll
          for (int j = 0; j < kern::kMaxCols; ++j) {
            if (j < s) {
              const float uj = u[j];
              acc[0][j] += uj * x.x;
              acc[1][j] += uj * x.y;
              acc[2][j] += uj * x.z;
              acc[3][j] += uj * x.w;
            }
          }
        }
      }
    } else {
      const float* p = X + static_cast<int64_t>(rc) * ld;
      for (int rr = 0; rr < nr; ++rr, p += ld) {
        float x[4];
#pragma unroll
        for (int t = 0; t < 4; ++t)
          x[t] = c0 + t * T < n ? __ldg(p + c0 + t * T) : 0.f;
        const float* u = uS + rr * kern::kMaxCols;
#pragma unroll
        for (int j = 0; j < kern::kMaxCols; ++j) {
          if (j < s) {
            const float uj = u[j];
#pragma unroll
            for (int t = 0; t < 4; ++t) acc[t][j] += uj * x[t];
          }
        }
      }
    }
  }

#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int64_t ct = VEC4 ? col + t : c0 + t * T;
    if (ct < n) {
#pragma unroll
      for (int j = 0; j < kern::kMaxCols; ++j)
        if (j < s) o[ct * s + j] = acc[t][j];
    }
  }
}

}  // namespace

// C entry point, called through ctypes. part is (slices, n, s) scratch,
// unused when slices == 1. Returns a cudaError_t (0 = launched).
extern "C" int xt_multi_launch(const float* X, long long ld, const float* U,
                               long long ldu, float* Z, float* part, int d,
                               int n, int s, int slices, int threads,
                               void* stream) {
  if (d <= 0 || n <= 0 || ld < n || s <= 0 || s > kern::kMaxCols ||
      ldu < s || slices <= 0 || slices > 65535 || threads <= 0 ||
      threads % 32 != 0 || threads > kMaxThreads ||
      (slices > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec4 = n % 4 == 0 && ld % 4 == 0 &&
                    (reinterpret_cast<uintptr_t>(X) & 15) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t strip = 4 * static_cast<int64_t>(threads);
  const dim3 grid(static_cast<unsigned>((n + strip - 1) / strip), slices);
  const int rows_per_slice = (d + slices - 1) / slices;
  float* out = slices == 1 ? Z : part;
  if (vec4)
    xt_multi_kernel<true><<<grid, threads, 0, st>>>(X, ld, U, ldu, out, d, n, s,
                                                    rows_per_slice);
  else
    xt_multi_kernel<false><<<grid, threads, 0, st>>>(X, ld, U, ldu, out, d, n,
                                                     s, rows_per_slice);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess && slices > 1)
    err = kern::sum_rows(part, Z, slices, n * s, st);
  return static_cast<int>(err);
}
