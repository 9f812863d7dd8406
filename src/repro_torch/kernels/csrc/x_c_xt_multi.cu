// Fused one-pass dense multi-vector HVP core  Y = X (c .* (X^T U))  for
// Hopper (sm_90a), over s <= kern::kMaxCols probe vectors at once.
//
// Replaces the Pallas TPU kernel repro/kernels/glm_hvp.py::x_c_xt_multi
// (_x_c_xt_multi_kernel). On the DiSCO main path it is the batched HVP of
// an s-step round on dense input under hvp_fused=True: every DiSCO-S shard's
// round product, and the DiSCO-F round on a single shard (there the first s
// of the s + 1 basis columns come in as a strided view).
//
// Layout: X (d, n) f32, row-major with row stride ld >= n elements; c
// (optional, n); U (d, s) f32 row-major with row stride ldu >= s; scratch
// (clusters, d, s) f32; Y (d, s) f32 row-major; cz_out (optional, n x s
// f32, row-major) receives the hand-off c .* Z (checks only).
//
// Design: fused_stream.cuh at S = s columns: a cluster shares each column
// panel by rows, every CTA keeps U's slice of its rows in shared memory for
// its whole run (read from device memory once, not once a panel), and only
// the panel's partial X^T U (bn x s) crosses the cluster. The header's
// notes say how each edge is resolved.
//
// Bound: device-memory bytes (4 s flops per 4-byte element of X: at s = 8,
// 8 flops a byte against the card's 20 f32 flops per byte).
#include "fused_stream.cuh"

// C entry point, called through ctypes; arguments as x_c_xt_u_launch's, with
// U (ldu) and s in place of u. Returns the same codes.
extern "C" int x_c_xt_multi_launch(const float* X, long long ld,
                                   const float* c, const float* U,
                                   long long ldu, float* Y, float* cz_out,
                                   float* scratch, int d, int n, int s, int q,
                                   int bn, int stages, int clusters, int cap,
                                   int* path, int* used, void* stream) {
  static_assert(kern::kMaxCols == 8, "one case per column count");
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define X_C_XT_MULTI_CASE(S)                                               \
  case S:                                                                  \
    return fused::run<float, S>(X, ld, c, U, ldu, Y, cz_out, scratch, d, n, \
                                q, bn, stages, clusters, cap, path, used, st);
  switch (s) {
    X_C_XT_MULTI_CASE(1)
    X_C_XT_MULTI_CASE(2)
    X_C_XT_MULTI_CASE(3)
    X_C_XT_MULTI_CASE(4)
    X_C_XT_MULTI_CASE(5)
    X_C_XT_MULTI_CASE(6)
    X_C_XT_MULTI_CASE(7)
    X_C_XT_MULTI_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef X_C_XT_MULTI_CASE
}
