// Fused blocked-ELL Hessian-vector product  y = A (c .* (A^T u))  from the
// transposed layout alone, on bf16 tiles, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/sparse_hvp.py::ell_hvp
// (_ell_hvp_kernel) at bf16 tile storage (DiscoConfig.hvp_dtype =
// 'bfloat16'). On the DiSCO main path it is the local curvature product
// under hvp_fused=True on the PCG loop's bf16 copy of the transposed
// layout.
//
// Layout: dataT (ncb, WT, bc, br) bf16 tiles; everything else as in
// ell_hvp.cu (u, c, y, cz and scratch f32).
//
// Design: ell_hvp.cu's stepped cooperative grid, the tile type a template
// parameter of ell_hvp_stream.cuh: stages of half the bytes, and a step
// (`step_bytes` of the schedule, built at 2-byte tiles) holds twice the
// tiles. Rounding as the TPU kernel's: u is rounded to bf16 where pass A
// stages it (`u.astype(dataT.dtype)`), c .* z where it is written to cz
// (`(c * z).astype(xT.dtype)`), so every product is exact in f32. z and cz
// repeat bit for bit, y to f32 rounding (its f32 atomics). Tiles whose
// rows are not a multiple of 16 bytes (br % 8 != 0) take the direct path.
//
// Bound: device-memory bytes, 2 bytes a live tile element read once, used
// in two multiply-adds.
#include "ell_hvp_stream.cuh"

// C entry point, called through ctypes; as ell_hvp_launch.
extern "C" int ell_hvp_bf16_launch(const __nv_bfloat16* dataT,
                                   const int* colsT, const int* sched,
                                   int* state, int ctas, int steps, int epoch,
                                   const float* u, const float* c, float* y,
                                   float* cz, float* scratch, int ncb, int WT,
                                   int bc, int br, int nrb, int* path,
                                   void* stream) {
  return ellh::hvp(dataT, colsT, sched, state, ctas, steps, epoch, u, c, y,
                   cz, scratch, ncb, WT, bc, br, nrb, path, stream);
}
