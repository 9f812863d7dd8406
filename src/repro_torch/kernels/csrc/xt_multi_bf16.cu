// Dense multi-vector pass A  Z = X^T U  on bf16 tiles, for Hopper
// (sm_90a), over s <= kern::kMaxCols probe vectors at once.
//
// Replaces the Pallas TPU kernel repro/kernels/glm_hvp.py::xt_multi
// (_xt_multi_kernel) at bf16 tile storage (DiscoConfig.hvp_dtype =
// 'bfloat16'). On the DiSCO main path it is pass A of the s-step round's
// batched HVP and of the K-class softmax product on the PCG loop's bf16
// copy of X.
//
// Layout: X (d, n) bf16, row-major with row stride ld >= n elements; U,
// Z and part f32, as in xt_multi.cu.
//
// Design: xt_multi.cu's, the tile type a template parameter of
// dense_multi.cuh: the same strips, slices and in-order sum, one 8-byte
// load of four elements a thread a row, so each thread keeps its four
// columns; one instance for each s, so a thread holds exactly its 4 s
// sums. Rounding as the TPU kernel's `U.astype(X.dtype)`: U is rounded
// to bf16 as it is staged into shared memory, so each product is exact in
// f32 and only the f32 sum order differs. Repeatable bit for bit.
//
// Bound: device-memory bytes, 2 bytes an element of X (half of
// xt_multi.cu's), for all s vectors at once.
#include "dense_multi.cuh"

// C entry point, called through ctypes; as xt_multi_launch.
extern "C" int xt_multi_bf16_launch(const __nv_bfloat16* X, long long ld,
                                    const float* U, long long ldu, float* Z,
                                    float* part, int d, int n, int s,
                                    int slices, int threads, void* stream) {
  return static_cast<int>(dmulti::xt_multi(X, ld, U, ldu, Z, part, d, n, s,
                                           slices, threads,
                                           static_cast<cudaStream_t>(stream)));
}
