// Fused blocked-ELL multi-vector Hessian-vector product
// Y = A (c .* (A^T U))  from the transposed layout alone, for Hopper
// (sm_90a), over s <= kern::kMaxCols probe vectors at once.
//
// Replaces the Pallas TPU kernel repro/kernels/sparse_hvp.py::ell_hvp_mm
// (_ell_hvp_mm_kernel). On the DiSCO main path it is the s-step round's
// batched local HVP under hvp_fused=True: every DiSCO-S round, and the
// DiSCO-F round on a single shard.
//
// Layout: dataT (ncb, WT, bc, br) f32 tiles of A^T, colsT (ncb, WT) int32,
// U (nrb * br, s) f32 row-major with row stride ldu >= s (DiSCO-F passes
// the first s columns of its (., s+1) basis as a view), c (ncb * bc,) f32
// or null, Y (nrb * br, s) f32 row-major, zeroed by the caller. Padding
// slots carry colsT = 0 and a zero tile.
//
// Design: one CTA per transposed row-block j.
//   Pass A: Z_j = sum_k tile_k . U[colsT[j, k]] (bc, s), the same
//           warp-per-row, lane-per-column walk with register accumulators
//           as ell_mm (RPW * warps rows at a time, the U block staged
//           s-major in shared memory per slot), then cz_j = c_j .* Z_j in
//           shared memory, row-major (bc, s).
//   Pass B: the CTA re-reads the same tiles; for each slot, thread groups
//           split the bc rows of the tile and lanes take the br columns
//           (coalesced 4-byte reads), each thread keeping s sums for its
//           column; the groups' sums are added in order in shared memory
//           and one f32 atomicAdd per output element lands
//           Y[colsT[j, k]] += cz_j^T tile_k.
// As ell_hvp, it reads every tile twice: a tile row at the rcv1-train
// shape is about 24 MB, far beyond a CTA's 227 KB of shared memory. The
// atomics make the summation order vary from run to run: the result
// matches the two-pass ell_mm pair within f32 rounding, not bit for bit.
//
// Bound: device-memory bytes (4 s flops per 4-byte tile element, and the
// tiles read once in the bound's count).
#include "ell_common.cuh"

namespace {

constexpr int kMaxThreads = 512;   // block size the kernel is compiled for

constexpr int RPW = 4;   // pass A rows per warp

template <bool VEC4, bool HAS_C>
__global__ void __launch_bounds__(kMaxThreads)
ell_hvp_mm_kernel(const float* __restrict__ dataT,
                  const int* __restrict__ colsT,
                  const float* __restrict__ U, int64_t ldu,
                  const float* __restrict__ c,
                  float* __restrict__ Y, int WT, int bc,
                  int br, int nrb, int s, int G) {
  extern __shared__ __align__(16) float smem[];
  float* vecT = smem;                                  // (s, br) U block
  float* cz = vecT + static_cast<size_t>(s) * br;      // (bc, s) c .* Z_j
  float* red = cz + static_cast<size_t>(bc) * s;       // (G, br, s) pass B
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const size_t j = blockIdx.x;
  const size_t tile_elems = static_cast<size_t>(bc) * br;
  const float* row = dataT + j * static_cast<size_t>(WT) * tile_elems;
  const int* row_cols = colsT + j * static_cast<size_t>(WT);

  // ---- pass A: Z_j = A_j^T U over the row's WT tiles -----------------------
  for (int a0 = 0; a0 < bc; a0 += RPW * nwarps) {
    float acc[RPW][kern::kMaxCols];
#pragma unroll
    for (int k = 0; k < RPW; ++k)
#pragma unroll
      for (int v = 0; v < kern::kMaxCols; ++v) acc[k][v] = 0.f;
    for (int k = 0; k < WT; ++k) {
      const int rb = row_cols[k];
      if (rb < 0 || rb >= nrb) __trap();  // corrupt layout: fail loudly
      __syncthreads();
      ell::stage_block<false>(vecT, U, ldu, nullptr,
                              static_cast<size_t>(rb) * br, br, s);
      __syncthreads();
      ell::tile_rows_mm<VEC4, RPW>(row + k * tile_elems, vecT, acc,
                                   a0 + warp, nwarps, bc, br, s, lane);
    }
#pragma unroll
    for (int k = 0; k < RPW; ++k) {
      const int a = a0 + warp + k * nwarps;
#pragma unroll
      for (int v = 0; v < kern::kMaxCols; ++v) {
        if (v < s && a < bc) {             // uniform over the warp
          const float sum = kern::warp_sum(acc[k][v]);
          if (lane == 0) cz[a * s + v] = HAS_C ? __ldg(c + j * bc + a) * sum : sum;
        }
      }
    }
  }
  __syncthreads();

  // ---- pass B: Y[colsT[j, k]] += cz_j^T tile_k -------------------------------
  const int g = threadIdx.x / br;          // this thread's row group
  for (int k = 0; k < WT; ++k) {
    const size_t out0 = static_cast<size_t>(row_cols[k]) * br;
    const float* tile = row + k * tile_elems;
    if (g < G) {
      for (int b = G == 1 ? threadIdx.x : threadIdx.x % br; b < br;
           b += G == 1 ? blockDim.x : br) {
        float acc[kern::kMaxCols];
#pragma unroll
        for (int v = 0; v < kern::kMaxCols; ++v) acc[v] = 0.f;
#pragma unroll 4
        for (int a = g; a < bc; a += G) {
          const float t = __ldg(tile + static_cast<size_t>(a) * br + b);
          const float* cza = cz + a * s;
#pragma unroll
          for (int v = 0; v < kern::kMaxCols; ++v)
            if (v < s) acc[v] += t * cza[v];
        }
        float* dst = red + (static_cast<size_t>(g) * br + b) * s;
#pragma unroll
        for (int v = 0; v < kern::kMaxCols; ++v)
          if (v < s) dst[v] = acc[v];
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < br * s; e += blockDim.x) {
      float sum = 0.f;
      for (int gg = 0; gg < G; ++gg) sum += red[static_cast<size_t>(gg) * br * s + e];
      atomicAdd(Y + out0 * s + e, sum);
    }
    __syncthreads();  // red is rewritten by the next slot
  }
}

template <bool VEC4, bool HAS_C>
cudaError_t launch(const float* dataT, const int* colsT, const float* U,
                   int64_t ldu, const float* c, float* Y, int ncb, int WT,
                   int bc, int br, int nrb, int s, int threads,
                   cudaStream_t stream) {
  const int G = threads / br > 1 ? threads / br : 1;
  const size_t smem = (static_cast<size_t>(s) * br + static_cast<size_t>(bc) * s +
                       static_cast<size_t>(G) * br * s) *
                      sizeof(float);
  auto kernel = ell_hvp_mm_kernel<VEC4, HAS_C>;
  cudaError_t err = kern::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<ncb, threads, smem, stream>>>(dataT, colsT, U, ldu, c, Y, WT, bc,
                                         br, nrb, s, G);
  return cudaGetLastError();
}

}  // namespace

// C entry point, called through ctypes. Returns a cudaError_t (0 = launched).
extern "C" int ell_hvp_mm_launch(const float* dataT, const int* colsT,
                                 const float* U, long long ldu,
                                 const float* c, float* Y, int ncb, int WT,
                                 int bc, int br, int nrb, int s, int threads,
                                 void* stream) {
  if (ncb <= 0 || WT <= 0 || br <= 0 || bc <= 0 || nrb <= 0 || s <= 0 ||
      s > kern::kMaxCols || ldu < s || threads <= 0 || threads % 32 != 0 ||
      threads > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec4 =
      br % 4 == 0 && (reinterpret_cast<uintptr_t>(dataT) & 15) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (vec4)
    err = c ? launch<true, true>(dataT, colsT, U, ldu, c, Y, ncb, WT, bc, br, nrb, s, threads, st)
            : launch<true, false>(dataT, colsT, U, ldu, c, Y, ncb, WT, bc, br, nrb, s, threads, st);
  else
    err = c ? launch<false, true>(dataT, colsT, U, ldu, c, Y, ncb, WT, bc, br, nrb, s, threads, st)
            : launch<false, false>(dataT, colsT, U, ldu, c, Y, ncb, WT, bc, br, nrb, s, threads, st);
  return static_cast<int>(err);
}
