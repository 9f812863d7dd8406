// Dense pass A  z = X^T u  on bf16 tiles, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/glm_hvp.py::xt_u
// (_xt_u_kernel) at bf16 tile storage (DiscoConfig.hvp_dtype =
// 'bfloat16'). On the DiSCO main path it is pass A of every two-pass dense
// HVP on the PCG loop's bf16 copy of X, and a basis product of two-pass
// s-step rounds; the margins and the gradient stay on the f32 X.
//
// Layout: X (d, n) bf16, row-major with row stride ld >= n elements (a
// DiSCO-S column slice of the bf16 copy is passed as a view); u (d,),
// z (n,) and scratch (ctas, 2, kTileCols) f32, as in xt_u.cu.
//
// Design: xt_u.cu's, the tile type a template parameter of
// dense_stream.cuh: the same split, walk and fix-up over 16 x 1536
// pieces, each stage half the bytes (so four 48 KB stages fit), 8-byte
// reads of four elements a thread. Rounding as the TPU kernel's
// `u.astype(X.dtype)`: u is rounded to bf16 where a warp loads its rows'
// u, so each product is exact in f32 and only the f32 sum order differs.
// Rows that are not a multiple of 16 bytes (n or ld % 8 != 0: a DiSCO-S
// view at an odd column offset) take the direct path. Repeatable bit for
// bit.
//
// Bound: device-memory bytes, 2 bytes an element of X (half of xt_u.cu's),
// used in one multiply-add.
#include "dense_stream.cuh"

// C entry point, called through ctypes; as xt_u_launch.
extern "C" int xt_u_bf16_launch(const __nv_bfloat16* X, long long ld,
                                const float* u, float* z, float* scratch,
                                int d, int n, int ctas, int tile_rows,
                                int tile_cols, int* path, void* stream) {
  if (!u || !dense::valid_args(X, ld, d, n, ctas, tile_rows, tile_cols, z,
                               scratch))
    return static_cast<int>(cudaErrorInvalidValue);
  dense::Params p = dense::make_params(X, ld, d, n, ctas, z, scratch);
  p.u = u;
  return static_cast<int>(dense::run<true, __nv_bfloat16>(
      p, path, static_cast<cudaStream_t>(stream)));
}
