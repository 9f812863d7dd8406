// Blocked-ELL generalized matvec  y = A (c .* v)  on bf16 tiles, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/sparse_hvp.py::ell_mv
// (_ell_mv_kernel) at bf16 tile storage (DiscoConfig.hvp_dtype =
// 'bfloat16'). On the DiSCO main path it is both passes of the two-pass
// Hessian-vector product on the PCG loop's bf16 copies of the layouts; the
// margins and the gradient stay on the f32 layouts (ell_mv.cu).
//
// Layout: data (nb, W, br, bc) bf16 tiles; everything else as in ell_mv.cu
// (v, c, y and scratch f32).
//
// Design: ell_mv.cu's, the tile type a template parameter of
// ell_stream.cuh: the same persistent grid over the live tiles, ring and
// fix-up, each stage's tile piece half the bytes (so four 32 KB stages fit
// at 128 x 128 tiles), 8-byte reads of four elements a lane. Rounding as
// the TPU kernel's `cv = (c * v).astype(x.dtype)`: c .* v is rounded to
// bf16 where it is staged, so each product is exact in f32 and only the
// f32 sum order differs. Tiles whose rows are not a multiple of 16 bytes
// (bc % 8 != 0) take the direct path. Repeatable bit for bit.
//
// Bound: device-memory bytes, 2 bytes a live tile element (half of
// ell_mv.cu's), used in one multiply-add.
#include "ell_stream.cuh"

// C entry point, called through ctypes; as ell_mv_launch.
extern "C" int ell_mv_bf16_launch(const __nv_bfloat16* data, const int* cols,
                                  const int* sched, int ctas, const float* v,
                                  const float* c, float* y, float* scratch,
                                  int nb, int W, int br, int bc, int ncb,
                                  int* path, void* stream) {
  return ells::mv(data, cols, sched, ctas, v, c, y, scratch, nb, W, br, bc,
                  ncb, path, stream);
}
