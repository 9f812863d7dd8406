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
// slice of a wider basis is passed as a view), c (ncb * bc,) f32 or null,
// Y (nb * br, s) f32 row-major. Padding slots carry cols = 0 and a zero
// tile. The TPU wrapper padded s to 128 lanes; here s is the true width.
//
// Design: one CTA per (row-block i, chunk of RPW * warps rows): a CTA
// walks the W slots of its row-block in order and reads only its rows of
// each tile, so every tile byte is read once in all. Per slot the (bc, s)
// block of c .* V the tile multiplies is staged in shared memory, s-major,
// the scale applied on load; warps take RPW rows each and lanes stride
// over bc with 16-byte loads (a 128-column tile row is one coalesced
// 512-byte read per warp). Each lane keeps RPW * s partial sums in
// registers across all W slots; one warp reduction per (row, vector) at
// the end writes Y. The sum over a row-block stays inside one CTA, so the
// result is deterministic and needs no atomics.
//
// Bound: device-memory bytes. Each tile element is read once and used in
// 2 s flops (20 at s = 5 against the card's ~20 flops per byte balance
// for 4-byte elements), so at s <= 8 the tiles' bytes bound it, as for
// ell_mv, for all s vectors at once. Splitting a row-block's rows over
// grid.y gives the transposed layout at the rcv1-train shape 318 CTAs of
// 512 threads instead of ell_mv's 159.
#include "ell_common.cuh"

namespace {

constexpr int kMaxThreads = 512;   // block size the kernel is compiled for

constexpr int RPW = 4;   // rows per warp

template <bool VEC4, bool HAS_C>
__global__ void __launch_bounds__(kMaxThreads)
ell_mm_kernel(const float* __restrict__ data,
              const int* __restrict__ cols,
              const float* __restrict__ V, int64_t ldv,
              const float* __restrict__ c,
              float* __restrict__ Y, int W, int br, int bc,
              int ncb, int s) {
  extern __shared__ __align__(16) float vecT[];   // (s, bc)
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int r_first = blockIdx.y * RPW * nwarps + warp;
  const size_t i = blockIdx.x;
  const size_t tile_elems = static_cast<size_t>(br) * bc;
  const float* row = data + i * static_cast<size_t>(W) * tile_elems;
  const int* row_cols = cols + i * static_cast<size_t>(W);

  float acc[RPW][kern::kMaxCols];
#pragma unroll
  for (int k = 0; k < RPW; ++k)
#pragma unroll
    for (int j = 0; j < kern::kMaxCols; ++j) acc[k][j] = 0.f;

  for (int k = 0; k < W; ++k) {
    const int cb = row_cols[k];
    if (cb < 0 || cb >= ncb) __trap();  // corrupt layout: fail loudly
    __syncthreads();                    // all readers done with vecT
    ell::stage_block<HAS_C>(vecT, V, ldv, c, static_cast<size_t>(cb) * bc,
                            bc, s);
    __syncthreads();
    ell::tile_rows_mm<VEC4, RPW>(row + k * tile_elems, vecT, acc, r_first,
                                 nwarps, br, bc, s, lane);
  }

#pragma unroll
  for (int k = 0; k < RPW; ++k) {
    const int r = r_first + k * nwarps;
#pragma unroll
    for (int j = 0; j < kern::kMaxCols; ++j) {
      if (j < s && r < br) {            // uniform over the warp
        const float sum = kern::warp_sum(acc[k][j]);
        if (lane == 0) Y[(i * br + r) * s + j] = sum;
      }
    }
  }
}

template <bool VEC4, bool HAS_C>
cudaError_t launch(const float* data, const int* cols, const float* V,
                   int64_t ldv, const float* c, float* Y, int nb, int W,
                   int br, int bc, int ncb, int s, int threads,
                   cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(s) * bc * sizeof(float);
  auto kernel = ell_mm_kernel<VEC4, HAS_C>;
  cudaError_t err = kern::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int rows_per_cta = RPW * (threads / 32);
  const dim3 grid(nb, (br + rows_per_cta - 1) / rows_per_cta);
  kernel<<<grid, threads, smem, stream>>>(data, cols, V, ldv, c, Y, W, br,
                                          bc, ncb, s);
  return cudaGetLastError();
}

}  // namespace

// C entry point, called through ctypes. Returns a cudaError_t (0 = launched).
extern "C" int ell_mm_launch(const float* data, const int* cols,
                             const float* V, long long ldv, const float* c,
                             float* Y, int nb, int W, int br, int bc,
                             int ncb, int s, int threads, void* stream) {
  if (nb <= 0 || W <= 0 || br <= 0 || bc <= 0 || s <= 0 ||
      s > kern::kMaxCols || ldv < s || threads <= 0 || threads % 32 != 0 ||
      threads > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec4 =
      bc % 4 == 0 && (reinterpret_cast<uintptr_t>(data) & 15) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (vec4)
    err = c ? launch<true, true>(data, cols, V, ldv, c, Y, nb, W, br, bc, ncb, s, threads, st)
            : launch<true, false>(data, cols, V, ldv, c, Y, nb, W, br, bc, ncb, s, threads, st);
  else
    err = c ? launch<false, true>(data, cols, V, ldv, c, Y, nb, W, br, bc, ncb, s, threads, st)
            : launch<false, false>(data, cols, V, ldv, c, Y, nb, W, br, bc, ncb, s, threads, st);
  return static_cast<int>(err);
}
