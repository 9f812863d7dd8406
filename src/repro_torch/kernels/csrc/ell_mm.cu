// Blocked-ELL generalized matmat  Y = A (c .* V)  for Hopper (sm_90a), over
// s <= kern::kMaxCols probe vectors at once.
//
// Replaces the Pallas TPU kernel repro/kernels/sparse_hvp.py::ell_mm
// (_ell_mm_kernel). On the DiSCO main path it is the s-step round's
// batched HVP on sparse input: on a shard's transposed layout it computes
// pass A  Z = X^T U, on its forward layout pass B  X (c .* Z).
//
// Layout: data (nb, W, br, bc) f32 tiles, cols (nb, W) int32 column-block
// ids, V (ncb * bc, s) f32 row-major with row stride ldv >= s (a column
// slice of a wider basis is passed as a view; v_len floats are readable
// from V on), c (ncb * bc,) f32 or null, Y (nb * br, s) f32 row-major;
// sched and scratch (ctas, 2, br, s) as for ell_mv. The TPU wrapper padded
// s to 128 lanes; here s is the true width.
//
// Design: ell_stream.cuh with S = s, one instance per s: the persistent
// grid over the live tiles and the bulk-copy ring of ell_mv, the stage
// holding beside each tile the (bc, ldv) span of V it multiplies; the
// threads copy c .* V s-major into shared memory, and one read of each tile
// element from shared memory serves all s columns. A lane keeps 8 s sums
// (at most 64 registers) over its warp's rows. No atomics, repeatable bit
// for bit.
//
// Bound: device-memory bytes. Each live tile element is read once and used
// in 2 s flops (16 at s = 8 against the card's ~20 flops per byte balance
// for 4-byte elements), so at s <= 8 the tiles' bytes bound it, as for
// ell_mv, for all s vectors at once.
#include "ell_stream.cuh"

// C entry point, called through ctypes (the body: ells::mm in the header).
// Launches the stream kernel and its fix-up, writes the path taken to
// *path (0 direct, 1 bulk copies), and returns a cudaError_t (0 =
// launched).
extern "C" int ell_mm_launch(const float* data, const int* cols,
                             const int* sched, int ctas, const float* V,
                             long long ldv, long long v_len, const float* c,
                             float* Y, float* scratch, int nb, int W, int br,
                             int bc, int ncb, int s, int* path, void* stream) {
  return ells::mm(data, cols, sched, ctas, V, ldv, v_len, c, Y, scratch, nb,
                  W, br, bc, ncb, s, path, stream);
}
