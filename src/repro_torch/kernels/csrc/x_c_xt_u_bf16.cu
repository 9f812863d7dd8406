// Fused one-pass dense HVP core  y = X (c .* (X^T u))  on bf16 tiles, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/glm_hvp.py::x_c_xt_u
// (_x_c_xt_u_kernel) at bf16 tile storage (DiscoConfig.hvp_dtype =
// 'bfloat16'). On the DiSCO main path it is the local curvature product
// under hvp_fused=True on the PCG loop's bf16 copy of X: every DiSCO-S HVP,
// and the DiSCO-F HVP on a single shard (there also the basis operator of
// fused s-step rounds); the margins and the gradient stay on the f32 X.
//
// Layout: X (d, n) bf16, row-major with row stride ld >= n elements (a
// DiSCO-S column slice of the bf16 copy is passed as a view); c, u,
// scratch, y and cz_out f32, as in x_c_xt_u.cu.
//
// Design: x_c_xt_u.cu's, the tile type a template parameter of
// fused_stream.cuh: the same plan, split, exchange and fix-up order, in
// panels of 64 (or 32) columns so that a row is 128 (or 64) bytes as at
// f32, a thread's 16-byte read 8 elements. Rounding as the TPU kernel's:
// u is rounded to bf16 as it is staged (`u.astype(X.dtype)`), and c .* z
// after the cluster's rank-ordered sum of z (`(c * z).astype(x.dtype)`),
// so each product is exact in f32 and only the f32 sum order differs. A
// row stride that is not a multiple of 8 elements, or a view not 16-byte
// aligned, takes the direct path. Repeatable bit for bit.
//
// Bound: device-memory bytes, 2 bytes an element of X (half of
// x_c_xt_u.cu's), used in two multiply-adds.
#include "fused_stream.cuh"

// C entry point, called through ctypes; as x_c_xt_u_launch, bn one of 64
// and 32.
extern "C" int x_c_xt_u_bf16_launch(const __nv_bfloat16* X, long long ld,
                                    const float* c, const float* u, float* y,
                                    float* cz_out, float* scratch, int d,
                                    int n, int q, int bn, int stages,
                                    int clusters, int cap, int* path,
                                    int* used, void* stream) {
  return fused::run<__nv_bfloat16, 1>(X, ld, c, u, 1, y, cz_out, scratch, d,
                                      n, q, bn, stages, clusters, cap, path,
                                      used,
                                      static_cast<cudaStream_t>(stream));
}
