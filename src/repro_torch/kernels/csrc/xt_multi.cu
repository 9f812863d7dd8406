// Dense multi-vector pass A  Z = X^T U  for Hopper (sm_90a), over
// s <= kern::kMaxCols probe vectors at once.
//
// Replaces the Pallas TPU kernel repro/kernels/glm_hvp.py::xt_multi
// (_xt_multi_kernel). On the DiSCO main path it is pass A of the s-step
// round's batched HVP on dense input (the (n, s) block DiSCO-F
// all-reduces between the passes), and pass A of the K-class softmax
// product.
//
// Layout: X (d, n) f32, row-major with row stride ld >= n elements (a
// column slice of a wider matrix is passed as a view); U (d, s) f32
// row-major with row stride ldu >= s; Z (n, s) f32 row-major.
//
// Design: the xt_multi case of dense_multi.cuh: column strips by row
// slices, each thread keeping 4 * s sums in registers over one 16-byte
// load of X a row, U staged in shared memory; row slices added in order
// by a second kernel when the strips alone do not fill the card. No
// atomics: repeatable bit for bit for given shapes.
//
// Bound: device-memory bytes. Each element of X is read once for s
// multiply-adds (2 s flops per 4 bytes: 10 at s = 5, below the card's
// ~20 flops per byte), so X's bytes bound it for all s vectors at once.
#include "dense_multi.cuh"

// C entry point, called through ctypes. part is (slices, n, s) scratch,
// unused when slices == 1. Returns a cudaError_t (0 = launched).
extern "C" int xt_multi_launch(const float* X, long long ld, const float* U,
                               long long ldu, float* Z, float* part, int d,
                               int n, int s, int slices, int threads,
                               void* stream) {
  return static_cast<int>(dmulti::xt_multi(X, ld, U, ldu, Z, part, d, n, s,
                                           slices, threads,
                                           static_cast<cudaStream_t>(stream)));
}
