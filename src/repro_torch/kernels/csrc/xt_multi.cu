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
// Design: the xt_multi case of dense_multi.cuh: a persistent grid of
// `ctas` CTAs, each walking an even share of the 16 x 1024 pieces of X
// chunk by chunk, the pieces brought into a three-stage ring by a producer
// warp's bulk copies, the pieces' rows of U staged once each; each thread
// keeps the partial Z of its 4 columns (4 s sums) in registers over its
// run of rows in one chunk; chunks cut by a range boundary are summed in
// CTA order by the fix-up kernel. No atomics: repeatable bit for bit for
// a given shape and CTA count.
//
// Bound: device-memory bytes. Each element of X is read once for s
// multiply-adds (2 s flops per 4 bytes: 16 at s = 8, below the card's
// ~20 flops per byte), so X's bytes bound it for all s vectors at once.
#include "dense_multi.cuh"

// C entry point, called through ctypes. scratch is (ctas, 2, tile_cols *
// s) f32 partials of cut column chunks; tile_rows and tile_cols are the
// piece the caller's split assumes (refused unless they are the header's).
// Launches the kernel and its fix-up, writes the path taken to *path (0
// direct, 1 bulk copies), and returns a cudaError_t (0 = launched).
extern "C" int xt_multi_launch(const float* X, long long ld, const float* U,
                               long long ldu, float* Z, float* scratch, int d,
                               int n, int s, int ctas, int tile_rows,
                               int tile_cols, int* path, void* stream) {
  if (!dmulti::valid_args<true>(X, ld, U, ldu, Z, scratch, d, n, s, ctas,
                                tile_rows, tile_cols))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dmulti::run<true>(
      X, ld, U, ldu, nullptr, Z, scratch, d, n, s, ctas, path,
      static_cast<cudaStream_t>(stream)));
}
