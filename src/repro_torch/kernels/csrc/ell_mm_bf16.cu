// Blocked-ELL generalized matmat  Y = A (c .* V)  on bf16 tiles, for Hopper
// (sm_90a), over s <= kern::kMaxCols probe vectors at once.
//
// Replaces the Pallas TPU kernel repro/kernels/sparse_hvp.py::ell_mm
// (_ell_mm_kernel) at bf16 tile storage (DiscoConfig.hvp_dtype =
// 'bfloat16'). On the DiSCO main path it is the s-step round's two-pass
// batched HVP on the PCG loop's bf16 copies of the layouts.
//
// Layout: data (nb, W, br, bc) bf16 tiles; everything else as in ell_mm.cu
// (V, c, Y and scratch f32).
//
// Design: ell_mm.cu's, the tile type a template parameter of
// ell_stream.cuh (see ell_mv_bf16.cu). Rounding as the TPU kernel's
// `cv = (c * v).astype(x.dtype)`: the s-major copy of c .* V in shared
// memory holds bf16 values, so each product is exact in f32. Repeatable
// bit for bit.
//
// Bound: device-memory bytes, 2 bytes a live tile element, used in 2 s
// flops (16 at s = 8, still below the card's f32 flops per byte at 2-byte
// elements).
#include "ell_stream.cuh"

// C entry point, called through ctypes; as ell_mm_launch.
extern "C" int ell_mm_bf16_launch(const __nv_bfloat16* data, const int* cols,
                                  const int* sched, int ctas, const float* V,
                                  long long ldv, long long v_len,
                                  const float* c, float* Y, float* scratch,
                                  int nb, int W, int br, int bc, int ncb,
                                  int s, int* path, void* stream) {
  return ells::mm(data, cols, sched, ctas, V, ldv, v_len, c, Y, scratch, nb,
                  W, br, bc, ncb, s, path, stream);
}
