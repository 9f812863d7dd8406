// Dense pass B  y = X (c .* z)  for Hopper (sm_90a), the c scale fused.
//
// Replaces the Pallas TPU kernel repro/kernels/glm_hvp.py::x_cz
// (_x_cz_kernel). On the DiSCO main path it is pass B of every two-pass
// dense HVP, a basis product of two-pass s-step rounds, and the second
// half of the fused route when x_c_xt_u's panel does not fit.
//
// Layout: X (d, n) f32, row-major with row stride ld >= n elements; c
// (optional) and z (n,), y (d,) f32; scratch (ctas, 2, kTileRows) f32.
//
// Design: the row-group-major case of dense_stream.cuh: a persistent grid
// of `ctas` CTAs, each walking an even share of the (row group, column
// chunk) pieces along its row groups, the pieces brought into a ring of
// shared memory by bulk copies with the chunk's z and c beside them; c .* z
// is formed once a piece and used for all its kTileRows rows, each thread
// keeping one partial sum per row in registers over its run of the row
// group; row groups cut by a range boundary are summed in CTA order by the
// fix-up kernel. No atomics: repeatable bit for bit for a given shape and
// CTA count.
//
// Bound: device-memory bytes (2 flops per 4-byte element of X).
#include "dense_stream.cuh"

// C entry point, called through ctypes; c may be null (no scale).
// tile_rows and tile_cols are the piece the caller's split assumes
// (refused unless they are the header's). Launches the stream kernel and
// its fix-up, writes the path taken to *path (0 direct, 1 bulk copies),
// and returns a cudaError_t (0 = launched).
extern "C" int x_cz_launch(const float* X, long long ld, const float* c,
                           const float* z, float* y, float* scratch, int d,
                           int n, int ctas, int tile_rows, int tile_cols,
                           int* path, void* stream) {
  if (!z || !dense::valid_args(X, ld, d, n, ctas, tile_rows, tile_cols, y,
                               scratch))
    return static_cast<int>(cudaErrorInvalidValue);
  dense::Params p = dense::make_params(X, ld, d, n, ctas, y, scratch);
  p.c = c;
  p.z = z;
  return static_cast<int>(
      dense::run<false, float>(p, path, static_cast<cudaStream_t>(stream)));
}
