// Dense pass A  z = X^T u  for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/glm_hvp.py::xt_u
// (_xt_u_kernel). On the DiSCO main path it is pass A of every two-pass
// dense HVP (the n-vector DiSCO-F all-reduces between the passes), a basis
// product of two-pass s-step rounds, and the first half of the fused route
// when x_c_xt_u's panel does not fit.
//
// Layout: X (d, n) f32, row-major with row stride ld >= n elements (a
// column slice of a wider matrix is passed as a view, never copied);
// u (d,), z (n,) f32; scratch (ctas, 2, kTileCols) f32.
//
// Design: the chunk-major case of dense_stream.cuh: a persistent grid of
// `ctas` CTAs, each walking an even share of the (row group, column chunk)
// pieces chunk by chunk, the pieces brought into a ring of shared memory
// by bulk copies, each thread keeping the partial z of its 4 columns in
// registers over its run of rows; chunks cut by a range boundary are
// summed in CTA order by the fix-up kernel. No atomics: repeatable bit for
// bit for a given shape and CTA count. The header's notes say how each
// edge is resolved.
//
// Bound: device-memory bytes. Each element of X is read once for one
// multiply-add (2 flops per 4 bytes), far below the card's flops-per-byte
// balance.
#include "dense_stream.cuh"

// C entry point, called through ctypes. tile_rows and tile_cols are the
// piece the caller's split assumes (refused unless they are the header's).
// Launches the stream kernel and its fix-up, writes the path taken to
// *path (0 direct, 1 bulk copies), and returns a cudaError_t (0 =
// launched).
extern "C" int xt_u_launch(const float* X, long long ld, const float* u,
                           float* z, float* scratch, int d, int n, int ctas,
                           int tile_rows, int tile_cols, int* path,
                           void* stream) {
  if (!u || !dense::valid_args(X, ld, d, n, ctas, tile_rows, tile_cols, z,
                               scratch))
    return static_cast<int>(cudaErrorInvalidValue);
  dense::Params p = dense::make_params(X, ld, d, n, ctas, z, scratch);
  p.u = u;
  return static_cast<int>(
      dense::run<true, float>(p, path, static_cast<cudaStream_t>(stream)));
}
