// Dense pass B  y = X (c .* z)  on bf16 tiles, for Hopper (sm_90a), the c
// scale fused.
//
// Replaces the Pallas TPU kernel repro/kernels/glm_hvp.py::x_cz
// (_x_cz_kernel) at bf16 tile storage (DiscoConfig.hvp_dtype =
// 'bfloat16'). On the DiSCO main path it is pass B of every two-pass dense
// HVP on the PCG loop's bf16 copy of X, and a basis product of two-pass
// s-step rounds.
//
// Layout: X (d, n) bf16, row-major with row stride ld >= n elements; c
// (optional) and z (n,), y (d,) and scratch (ctas, 2, kTileRows) f32, as
// in x_cz.cu.
//
// Design: x_cz.cu's, the tile type a template parameter of
// dense_stream.cuh: the same split, walk and fix-up over 16 x 1536
// pieces, each stage's piece of X half the bytes (three 60 KB stages with
// the f32 z and c beside them), 8-byte reads of four elements a thread.
// Rounding as the TPU kernel's `cz = (c * z).astype(x.dtype)`: c .* z (z
// alone without c) is rounded to bf16 where a thread forms it from the
// stage, so each product is exact in f32 and only the f32 sum order
// differs. Rows that are not a multiple of 16 bytes take the direct path.
// Repeatable bit for bit.
//
// Bound: device-memory bytes, 2 bytes an element of X, used in one
// multiply-add.
#include "dense_stream.cuh"

// C entry point, called through ctypes; as x_cz_launch (c may be null).
extern "C" int x_cz_bf16_launch(const __nv_bfloat16* X, long long ld,
                                const float* c, const float* z, float* y,
                                float* scratch, int d, int n, int ctas,
                                int tile_rows, int tile_cols, int* path,
                                void* stream) {
  if (!z || !dense::valid_args(X, ld, d, n, ctas, tile_rows, tile_cols, y,
                               scratch))
    return static_cast<int>(cudaErrorInvalidValue);
  dense::Params p = dense::make_params(X, ld, d, n, ctas, y, scratch);
  p.c = c;
  p.z = z;
  return static_cast<int>(dense::run<false, __nv_bfloat16>(
      p, path, static_cast<cudaStream_t>(stream)));
}
