// Dense multi-vector pass B  Y = X (c .* Z)  on bf16 tiles, for Hopper
// (sm_90a), the c scale fused, over s <= kern::kMaxCols vectors at once.
//
// Replaces the Pallas TPU kernel repro/kernels/glm_hvp.py::x_cz_multi
// (_x_cz_multi_kernel) at bf16 tile storage (DiscoConfig.hvp_dtype =
// 'bfloat16'). On the DiSCO main path it is pass B of the s-step round's
// batched HVP and of the K-class softmax product on the PCG loop's bf16
// copy of X.
//
// Layout: X (d, n) bf16, row-major with row stride ld >= n elements; c,
// Z and Y f32, as in x_cz_multi.cu.
//
// Design: x_cz_multi.cu's, the tile type a template parameter of
// dense_multi.cuh: the same rows a CTA and fixed-order reduction, one
// 8-byte load of four elements a thread a row (kept packed until used),
// one instance for each s. Rounding as the TPU
// kernel's `cz = (c * z).astype(x.dtype)`: c .* Z is rounded to bf16 where
// a thread forms it, and Z alone without c (the softmax product, whose
// reference passes c = 1), so each product is exact in f32 and only the
// f32 sum order differs. Repeatable bit for bit.
//
// Bound: device-memory bytes, 2 bytes an element of X, for all s vectors
// at once.
#include "dense_multi.cuh"

// C entry point, called through ctypes; as x_cz_multi_launch.
extern "C" int x_cz_multi_bf16_launch(const __nv_bfloat16* X, long long ld,
                                      const float* c, const float* Z,
                                      long long ldz, float* Y, int d, int n,
                                      int s, int threads, void* stream) {
  return static_cast<int>(dmulti::x_cz_multi(
      X, ld, c, Z, ldz, Y, d, n, s, threads,
      static_cast<cudaStream_t>(stream)));
}
