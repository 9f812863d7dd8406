// Blocked-ELL generalized matvec  y = A (c .* v)  for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/sparse_hvp.py::ell_mv
// (_ell_mv_kernel). On the DiSCO main path it computes the margins, the
// gradient, and both passes of the two-pass Hessian-vector product.
//
// Layout: data (nb, W, br, bc) f32 tiles, cols (nb, W) int32 column-block
// ids, v and c (ncb * bc,) f32, y (nb * br,) f32; sched the layout's
// schedule (kernels/sparse_hvp.py ell_schedule: live counts, their prefix
// sums, the ranges of `ctas` CTAs), scratch (ctas, 2, br) f32.
//
// Design: the one-column case of ell_stream.cuh: a persistent grid of
// `ctas` CTAs, each walking an even share of the live tiles (padding slots
// are never read), the tiles brought into a ring of shared memory by bulk
// copies with the (c .* v) block beside each, row-blocks cut by a range
// boundary summed in CTA order by the fix-up kernel; no atomics, repeatable
// bit for bit. The header's notes say how each edge is resolved.
//
// Bound: device-memory bytes: every live tile element is read once and
// used in one multiply-add (2 flops per 4 bytes), far below the card's
// flops-per-byte balance.
#include "ell_stream.cuh"

// C entry point, called through ctypes (the body: ells::mv in the header).
// Launches the stream kernel and its fix-up, writes the path taken to
// *path (0 direct, 1 bulk copies), and returns a cudaError_t (0 =
// launched).
extern "C" int ell_mv_launch(const float* data, const int* cols,
                             const int* sched, int ctas, const float* v,
                             const float* c, float* y, float* scratch, int nb,
                             int W, int br, int bc, int ncb, int* path,
                             void* stream) {
  return ells::mv(data, cols, sched, ctas, v, c, y, scratch, nb, W, br, bc,
                  ncb, path, stream);
}
