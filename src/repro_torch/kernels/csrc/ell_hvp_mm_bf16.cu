// Fused blocked-ELL multi-vector Hessian-vector product
// Y = A (c .* (A^T U))  from the transposed layout alone, on bf16 tiles, for
// Hopper (sm_90a), over s <= kern::kMaxCols probe vectors at once.
//
// Replaces the Pallas TPU kernel repro/kernels/sparse_hvp.py::ell_hvp_mm
// (_ell_hvp_mm_kernel) at bf16 tile storage (DiscoConfig.hvp_dtype =
// 'bfloat16'). On the DiSCO main path it is the s-step round's batched
// local HVP under hvp_fused=True on the PCG loop's bf16 copy of the
// transposed layout.
//
// Layout: dataT (ncb, WT, bc, br) bf16 tiles; everything else as in
// ell_hvp_mm.cu (U, c, Y, cz and scratch f32).
//
// Design: ell_hvp_mm.cu's, the tile type a template parameter of
// ell_hvp_stream.cuh (see ell_hvp_bf16.cu). Rounding as the TPU kernel's:
// U is rounded to bf16 where pass A stages it s-major, c .* Z where it is
// written to cz. Z and cz repeat bit for bit, Y to f32 rounding.
//
// Bound: device-memory bytes, 2 bytes a live tile element, used in 4 s
// flops.
#include "ell_hvp_stream.cuh"

// C entry point, called through ctypes; as ell_hvp_mm_launch.
extern "C" int ell_hvp_mm_bf16_launch(const __nv_bfloat16* dataT,
                                      const int* colsT, const int* sched,
                                      int* state, int ctas, int steps,
                                      int epoch, const float* U,
                                      long long ldu, long long u_len,
                                      const float* c, float* Y, float* cz,
                                      float* scratch, int ncb, int WT, int bc,
                                      int br, int nrb, int s, int* path,
                                      void* stream) {
  return ellh::hvp_mm(dataT, colsT, sched, state, ctas, steps, epoch, U, ldu,
                      u_len, c, Y, cz, scratch, ncb, WT, bc, br, nrb, s,
                      path, stream);
}
