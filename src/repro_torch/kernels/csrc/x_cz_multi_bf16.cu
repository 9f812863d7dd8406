// Dense multi-vector pass B  Y = X (c .* Z)  on bf16 tiles, for Hopper
// (sm_90a), the c scale fused, over s <= kern::kMaxCols vectors at once.
//
// Replaces the Pallas TPU kernel repro/kernels/glm_hvp.py::x_cz_multi
// (_x_cz_multi_kernel) at bf16 tile storage (DiscoConfig.hvp_dtype =
// 'bfloat16'). On the DiSCO main path it is pass B of the s-step round's
// batched HVP and of the K-class softmax product on the PCG loop's bf16
// copy of X.
//
// Layout: X (d, n) bf16, row-major with row stride ld >= n elements; c,
// Z, Y and scratch f32, as in x_cz_multi.cu.
//
// Design: x_cz_multi.cu's split, ring and fix-up (dense_multi.cuh, the
// tile type a template parameter) over 128 x 256 pieces (64 KB of bf16),
// on the tensor cores: each warp takes 16 rows of a piece through
// mma.sync m16n8k16 (A = the piece through ldmatrix, B = the chunk's
// c .* Z staged transposed in bf16, the s columns padded to N = 8 with
// zeros). Rounding as the TPU kernel's `cz = (c * z).astype(x.dtype)`:
// c .* Z is rounded to bf16 where it is formed (Z alone without c: the
// softmax product, whose reference passes c = 1), so each product is
// exact in f32 and only the f32 sum order differs. Repeatable bit for bit.
//
// Bound: device-memory bytes, 2 bytes an element of X, for all s vectors
// at once.
#include "dense_multi.cuh"

// C entry point, called through ctypes; as x_cz_multi_launch.
extern "C" int x_cz_multi_bf16_launch(const __nv_bfloat16* X, long long ld,
                                      const float* c, const float* Z,
                                      long long ldz, float* Y, float* scratch,
                                      int d, int n, int s, int ctas,
                                      int tile_rows, int tile_cols, int* path,
                                      void* stream) {
  if (!dmulti::valid_args<false>(X, ld, Z, ldz, Y, scratch, d, n, s, ctas,
                                 tile_rows, tile_cols))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dmulti::run<false>(
      X, ld, Z, ldz, c, Y, scratch, d, n, s, ctas, path,
      static_cast<cudaStream_t>(stream)));
}
