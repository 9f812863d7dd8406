// Dense multi-vector pass A  Z = X^T U  on bf16 tiles, for Hopper
// (sm_90a), over s <= kern::kMaxCols probe vectors at once.
//
// Replaces the Pallas TPU kernel repro/kernels/glm_hvp.py::xt_multi
// (_xt_multi_kernel) at bf16 tile storage (DiscoConfig.hvp_dtype =
// 'bfloat16'). On the DiSCO main path it is pass A of the s-step round's
// batched HVP and of the K-class softmax product on the PCG loop's bf16
// copy of X.
//
// Layout: X (d, n) bf16, row-major with row stride ld >= n elements; U,
// Z and scratch f32, as in xt_multi.cu.
//
// Design: xt_multi.cu's split, ring and fix-up (dense_multi.cuh, the tile
// type a template parameter) over 32 x 1024 pieces (64 KB of bf16), on the
// tensor cores: each warp takes 128 columns of a piece as 8 tiles of
// mma.sync m16n8k16 (A = X^T through ldmatrix.trans from the row-major
// stage, B = the piece's rows of U, the s columns of the block padded to
// N = 8 with zeros). Rounding as the TPU kernel's `U.astype(X.dtype)`: U
// is rounded to bf16 as it is staged, so each product is exact in f32 and
// only the f32 sum order differs. Repeatable bit for bit.
//
// Bound: device-memory bytes, 2 bytes an element of X (half of
// xt_multi.cu's), for all s vectors at once.
#include "dense_multi.cuh"

// C entry point, called through ctypes; as xt_multi_launch.
extern "C" int xt_multi_bf16_launch(const __nv_bfloat16* X, long long ld,
                                    const float* U, long long ldu, float* Z,
                                    float* scratch, int d, int n, int s,
                                    int ctas, int tile_rows, int tile_cols,
                                    int* path, void* stream) {
  if (!dmulti::valid_args<true>(X, ld, U, ldu, Z, scratch, d, n, s, ctas,
                                tile_rows, tile_cols))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dmulti::run<true>(
      X, ld, U, ldu, nullptr, Z, scratch, d, n, s, ctas, path,
      static_cast<cudaStream_t>(stream)));
}
