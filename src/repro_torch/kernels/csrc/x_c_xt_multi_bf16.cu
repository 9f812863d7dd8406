// Fused one-pass dense multi-vector HVP core  Y = X (c .* (X^T U))  on bf16
// tiles, for Hopper (sm_90a), over s <= kern::kMaxCols probe vectors at
// once.
//
// Replaces the Pallas TPU kernel repro/kernels/glm_hvp.py::x_c_xt_multi
// (_x_c_xt_multi_kernel) at bf16 tile storage (DiscoConfig.hvp_dtype =
// 'bfloat16'). On the DiSCO main path it is the batched HVP of an s-step
// round on the PCG loop's bf16 copy of dense X under hvp_fused=True: every
// DiSCO-S shard's round product, and the DiSCO-F round on a single shard.
//
// Layout: X (d, n) bf16, row-major with row stride ld >= n elements; c, U,
// scratch, Y and cz_out f32, as in x_c_xt_multi.cu.
//
// Design: x_c_xt_multi.cu's, the tile type a template parameter of
// fused_stream.cuh, in panels of 64 (or 32) columns (128-byte rows, 8
// elements a thread's read). A panel then has E = 64 s partials of X^T U,
// past the 256 consumer threads from s = 5 on: each thread sums and
// exchanges E / 256 (rounded up) of them. Rounding as the TPU kernel's:
// U is rounded to bf16 as it is staged (`U.astype(X.dtype)`), c .* Z
// after the cluster's rank-ordered sum (`(c * z).astype(x.dtype)`), so each
// product is exact in f32 and only the f32 sum order differs. Repeatable
// bit for bit.
//
// Bound: device-memory bytes, 2 bytes an element of X, for all s vectors
// at once (4 s flops an element: at s = 8, 16 flops a byte against the
// card's 20 f32 flops per byte).
#include "fused_stream.cuh"

// C entry point, called through ctypes; as x_c_xt_multi_launch, bn one of
// 64 and 32.
extern "C" int x_c_xt_multi_bf16_launch(const __nv_bfloat16* X, long long ld,
                                        const float* c, const float* U,
                                        long long ldu, float* Y,
                                        float* cz_out, float* scratch, int d,
                                        int n, int s, int q, int bn,
                                        int stages, int clusters, int cap,
                                        int* path, int* used, void* stream) {
  static_assert(kern::kMaxCols == 8, "one case per column count");
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define X_C_XT_MULTI_BF16_CASE(S)                                        \
  case S:                                                                \
    return fused::run<__nv_bfloat16, S>(X, ld, c, U, ldu, Y, cz_out,     \
                                        scratch, d, n, q, bn, stages,    \
                                        clusters, cap, path, used, st);
  switch (s) {
    X_C_XT_MULTI_BF16_CASE(1)
    X_C_XT_MULTI_BF16_CASE(2)
    X_C_XT_MULTI_BF16_CASE(3)
    X_C_XT_MULTI_BF16_CASE(4)
    X_C_XT_MULTI_BF16_CASE(5)
    X_C_XT_MULTI_BF16_CASE(6)
    X_C_XT_MULTI_BF16_CASE(7)
    X_C_XT_MULTI_BF16_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef X_C_XT_MULTI_BF16_CASE
}
