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
// pass A and the all-reduce leave it (or a column group of a wider
// block); Y (d, s) f32 row-major.
//
// Design: the x_cz_multi case of dense_multi.cuh: a persistent grid of
// `ctas` CTAs, each walking an even share of the 64 x 256 pieces of X row
// group by row group, the pieces brought into a three-stage ring by a
// producer warp's bulk copies; the chunk's c .* Z is formed once a piece
// into shared memory (transposed), never read per thread from device
// memory; each thread keeps the partial Y of its 8 rows (8 s sums) over
// its run of chunks in one row group, summed over its row slab's lanes by
// shuffles; row groups cut by a range boundary are summed in CTA order by
// the fix-up kernel. No atomics: repeatable bit for bit.
//
// Bound: device-memory bytes (2 s flops per 4-byte element of X, below the
// card's ~20 flops per byte at s <= 8).
#include "dense_multi.cuh"

// C entry point, called through ctypes; c may be null (no scale).
// scratch is (ctas, 2, tile_rows * s) f32 partials of cut row groups;
// tile_rows and tile_cols are the piece the caller's split assumes
// (refused unless they are the header's). Launches the kernel and its
// fix-up, writes the path taken to *path (0 direct, 1 bulk copies), and
// returns a cudaError_t (0 = launched).
extern "C" int x_cz_multi_launch(const float* X, long long ld, const float* c,
                                 const float* Z, long long ldz, float* Y,
                                 float* scratch, int d, int n, int s,
                                 int ctas, int tile_rows, int tile_cols,
                                 int* path, void* stream) {
  if (!dmulti::valid_args<false>(X, ld, Z, ldz, Y, scratch, d, n, s, ctas,
                                 tile_rows, tile_cols))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dmulti::run<false>(
      X, ld, Z, ldz, c, Y, scratch, d, n, s, ctas, path,
      static_cast<cudaStream_t>(stream)));
}
