// Dense multi-vector pass B  Y = X (c .* Z)  for Hopper (sm_90a), the c
// scale fused, over s <= kern::kMaxCols vectors at once.
//
// Replaces the Pallas TPU kernel repro/kernels/glm_hvp.py::x_cz_multi
// (_x_cz_multi_kernel). On the DiSCO main path it is pass B of the s-step
// round's batched HVP on dense input, and pass B of the K-class softmax
// product (without c).
//
// Layout: X (d, n) f32, row-major with row stride ld >= n elements; c
// (n,) f32 or null; Z (n, s) f32 row-major with row stride ldz >= s, as
// pass A and the all-reduce leave it; Y (d, s) f32 row-major.
//
// Design: the x_cz_multi case of dense_multi.cuh: ROWS = 8 rows of X a
// CTA, each thread forming c .* Z for its 4 columns in registers and
// keeping ROWS * s partial sums, reduced in a fixed order. No atomics:
// repeatable bit for bit.
//
// Bound: device-memory bytes (2 s flops per 4-byte element of X, below the
// card's ~20 flops per byte at s <= 8).
#include "dense_multi.cuh"

// C entry point, called through ctypes; c may be null (no scale). Returns
// a cudaError_t (0 = launched).
extern "C" int x_cz_multi_launch(const float* X, long long ld, const float* c,
                                 const float* Z, long long ldz, float* Y,
                                 int d, int n, int s, int threads,
                                 void* stream) {
  return static_cast<int>(dmulti::x_cz_multi(
      X, ld, c, Z, ldz, Y, d, n, s, threads,
      static_cast<cudaStream_t>(stream)));
}
