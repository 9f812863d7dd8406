// Blocked-ELL generalized matvec  y = A (c .* v)  for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/sparse_hvp.py::ell_mv
// (_ell_mv_kernel). On the DiSCO main path it computes the margins, the
// gradient, and both passes of the two-pass Hessian-vector product.
//
// Layout: data (nb, W, br, bc) f32 tiles, cols (nb, W) int32 column-block
// ids, v and c (ncb * bc,) f32, y (nb * br,) f32. Padding slots carry
// cols = 0 and a zero tile: they gather block 0 and add zeros.
//
// Design: one CTA per row-block i walks its W slots in order. Per slot the
// (c .* v) block the tile multiplies is staged in shared memory; warps take
// the tile's rows and lanes stride over bc, so every tile row is one
// coalesced read. Each lane keeps its per-row partial sums in shared memory
// across all W slots, and one warp reduction per row at the end writes y.
// The sum over a row-block stays inside one CTA, so the result is
// deterministic and needs no atomics. Tile offsets are 64-bit.
//
// Bound: device-memory bytes. Every tile element is read once and used in
// one multiply-add (2 flops per 4 bytes), far below the card's
// flops-per-byte balance, so the kernel can at best stream the tiles at the
// HBM rate. Nothing here overlaps loads beyond what the warps in flight
// give; TMA staging of tile rows is left to a later revision.
#include "ell_common.cuh"

namespace {

template <bool VEC4, bool HAS_C>
__global__ void ell_mv_kernel(const float* __restrict__ data,
                              const int* __restrict__ cols,
                              const float* __restrict__ v,
                              const float* __restrict__ c,
                              float* __restrict__ y, int W, int br, int bc,
                              int ncb) {
  extern __shared__ __align__(16) float smem[];
  float* vec = smem;        // (bc,)       (c .* v) block of the current slot
  float* part = smem + bc;  // (br, 32)    per-lane partial row sums
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const size_t i = blockIdx.x;
  const size_t tile_elems = static_cast<size_t>(br) * bc;
  const float* row = data + i * static_cast<size_t>(W) * tile_elems;
  const int* row_cols = cols + i * static_cast<size_t>(W);

  for (int r = warp; r < br; r += nwarps) part[r * 32 + lane] = 0.f;

  for (int k = 0; k < W; ++k) {
    const int cb = row_cols[k];
    if (cb < 0 || cb >= ncb) __trap();  // corrupt layout: fail loudly
    __syncthreads();                    // all readers done with vec
    const size_t base = static_cast<size_t>(cb) * bc;
    for (int t = threadIdx.x; t < bc; t += blockDim.x)
      vec[t] = HAS_C ? __ldg(c + base + t) * __ldg(v + base + t)
                     : __ldg(v + base + t);
    __syncthreads();
    ell::tile_rows_dot<VEC4>(row + k * tile_elems, vec, part, br, bc, lane,
                             warp, nwarps);
  }

  for (int r = warp; r < br; r += nwarps) {
    const float s = kern::warp_sum(part[r * 32 + lane]);
    if (lane == 0) y[i * br + r] = s;
  }
}

template <bool VEC4, bool HAS_C>
cudaError_t launch(const float* data, const int* cols, const float* v,
                   const float* c, float* y, int nb, int W, int br, int bc,
                   int ncb, int threads, cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(bc) + 32 * static_cast<size_t>(br)) *
                      sizeof(float);
  auto kernel = ell_mv_kernel<VEC4, HAS_C>;
  cudaError_t err = kern::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<nb, threads, smem, stream>>>(data, cols, v, c, y, W, br, bc, ncb);
  return cudaGetLastError();
}

}  // namespace

// C entry point, called through ctypes. Returns a cudaError_t (0 = launched).
extern "C" int ell_mv_launch(const float* data, const int* cols,
                             const float* v, const float* c, float* y, int nb,
                             int W, int br, int bc, int ncb, int threads,
                             void* stream) {
  if (nb <= 0 || W <= 0 || br <= 0 || bc <= 0 || threads <= 0 ||
      threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec4 =
      bc % 4 == 0 && (reinterpret_cast<uintptr_t>(data) & 15) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (vec4)
    err = c ? launch<true, true>(data, cols, v, c, y, nb, W, br, bc, ncb, threads, s)
            : launch<true, false>(data, cols, v, c, y, nb, W, br, bc, ncb, threads, s);
  else
    err = c ? launch<false, true>(data, cols, v, c, y, nb, W, br, bc, ncb, threads, s)
            : launch<false, false>(data, cols, v, c, y, nb, W, br, bc, ncb, threads, s);
  return static_cast<int>(err);
}
