// Dense pass A  z = X^T u  for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/glm_hvp.py::xt_u
// (_xt_u_kernel). On the DiSCO main path it is pass A of every two-pass
// dense HVP (the n-vector DiSCO-F all-reduces between the passes), and the
// first half of the fused route when x_c_xt_u's panel does not fit.
//
// Layout: X (d, n) f32, row-major with row stride ld >= n elements (a
// column slice of a wider matrix is passed as a view, never copied);
// u (d,), z (n,) f32. Element offsets are 64-bit: d * ld is 2^30 at the
// full width, and byte offsets pass 4 GiB.
//
// Design: the TPU grid walked d in order against one resident output
// block. Here CTAs run at once, so each CTA owns a strip of 4 * blockDim.x
// columns and a slice of rows, and each thread keeps the sums of its 4
// columns in registers while it walks the rows, one 16-byte load per row
// (neighbouring threads on neighbouring addresses: a warp reads 512
// contiguous bytes of a row). When the strips alone are too few CTAs to
// fill the card, the wrapper splits d into S slices; slice s writes its
// sums to part[s, :] and a second kernel adds the S rows in order. No
// atomics: the result is repeatable bit for bit for a given (d, n, S).
//
// Bound: device-memory bytes. Each element of X is read once for one
// multiply-add (2 flops per 4 bytes), far below the card's flops-per-byte
// balance.
#include "partials.cuh"

namespace {

template <bool VEC4>
__global__ void xt_u_kernel(const float* __restrict__ X, int64_t ld,
                            const float* __restrict__ u,
                            float* __restrict__ out, int d, int n,
                            int rows_per_slice) {
  const int64_t strip = 4 * static_cast<int64_t>(blockDim.x);
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * strip;
  const int r0 = blockIdx.y * rows_per_slice;
  const int r1 = min(d, r0 + rows_per_slice);
  float* o = out + static_cast<int64_t>(blockIdx.y) * n;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  if (VEC4) {
    const int64_t col = col0 + 4 * static_cast<int64_t>(threadIdx.x);
    if (col >= n) return;  // n % 4 == 0, so col < n covers col + 3
    const float* p = X + static_cast<int64_t>(r0) * ld + col;
#pragma unroll 4
    for (int r = r0; r < r1; ++r, p += ld) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(p));
      const float ur = __ldg(u + r);
      a0 += ur * x.x;
      a1 += ur * x.y;
      a2 += ur * x.z;
      a3 += ur * x.w;
    }
    *reinterpret_cast<float4*>(o + col) = make_float4(a0, a1, a2, a3);
  } else {
    // thread t owns columns col0 + t + k * blockDim.x, k = 0..3
    const int64_t c0 = col0 + threadIdx.x, T = blockDim.x;
    const float* p = X + static_cast<int64_t>(r0) * ld;
    for (int r = r0; r < r1; ++r, p += ld) {
      const float ur = __ldg(u + r);
      if (c0 < n) a0 += ur * __ldg(p + c0);
      if (c0 + T < n) a1 += ur * __ldg(p + c0 + T);
      if (c0 + 2 * T < n) a2 += ur * __ldg(p + c0 + 2 * T);
      if (c0 + 3 * T < n) a3 += ur * __ldg(p + c0 + 3 * T);
    }
    if (c0 < n) o[c0] = a0;
    if (c0 + T < n) o[c0 + T] = a1;
    if (c0 + 2 * T < n) o[c0 + 2 * T] = a2;
    if (c0 + 3 * T < n) o[c0 + 3 * T] = a3;
  }
}

}  // namespace

// C entry point, called through ctypes. part is (slices, n) scratch, unused
// when slices == 1. Returns a cudaError_t (0 = launched).
extern "C" int xt_u_launch(const float* X, long long ld, const float* u,
                           float* z, float* part, int d, int n, int slices,
                           int threads, void* stream) {
  if (d <= 0 || n <= 0 || ld < n || slices <= 0 || slices > 65535 ||
      threads <= 0 || threads % 32 != 0 || (slices > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec4 = n % 4 == 0 && ld % 4 == 0 &&
                    (reinterpret_cast<uintptr_t>(X) & 15) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t strip = 4 * static_cast<int64_t>(threads);
  const dim3 grid(static_cast<unsigned>((n + strip - 1) / strip), slices);
  const int rows_per_slice = (d + slices - 1) / slices;
  float* out = slices == 1 ? z : part;
  if (vec4)
    xt_u_kernel<true><<<grid, threads, 0, s>>>(X, ld, u, out, d, n, rows_per_slice);
  else
    xt_u_kernel<false><<<grid, threads, 0, s>>>(X, ld, u, out, d, n, rows_per_slice);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess && slices > 1) err = kern::sum_rows(part, z, slices, n, s);
  return static_cast<int>(err);
}
