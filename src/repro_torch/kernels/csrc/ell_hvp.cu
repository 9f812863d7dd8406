// Fused blocked-ELL Hessian-vector product  y = A (c .* (A^T u))  from the
// transposed layout alone, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/sparse_hvp.py::ell_hvp
// (_ell_hvp_kernel). On the DiSCO main path it is the local curvature
// product under hvp_fused=True: every DiSCO-S HVP, and the DiSCO-F HVP on a
// single shard.
//
// Layout: dataT (ncb, WT, bc, br) f32 tiles of A^T, colsT (ncb, WT) int32,
// u (nrb * br,) f32, c (ncb * bc,) f32, y (nrb * br,) f32 zeroed by the
// caller. Padding slots carry colsT = 0 and a zero tile.
//
// Design: one CTA per transposed row-block j.
//   Pass A: z_j = sum_k tile_k . u[colsT[j, k]], the same warp-per-row,
//           lane-per-column walk as ell_mv, then cz_j = c_j .* z_j in
//           shared memory.
//   Pass B: the CTA re-reads the same tiles; for each slot, thread groups
//           split the bc rows of the tile, lanes take the br columns
//           (coalesced), the groups' partials are summed in shared memory,
//           and one f32 atomicAdd per column lands y[colsT[j, k]] +=
//           cz_j^T tile_k.
// The TPU kernel kept the whole tile row resident in VMEM and read each
// tile once. On Hopper a tile row at the rcv1-train shape is 369 tiles of
// 64 KB, about 24 MB, far beyond the 227 KB of shared memory a CTA can
// hold, so this first version reads every tile twice (from L2 or HBM) and
// moves as many bytes as the two-pass ell_mv pair. Because different CTAs
// add into the same y blocks with atomics, the summation order varies from
// run to run: the result matches the two-pass product within f32 rounding,
// not bit for bit.
//
// Bound: device-memory bytes (4 flops per 4-byte tile element).
#include "ell_common.cuh"

namespace {

template <bool VEC4, bool HAS_C>
__global__ void ell_hvp_kernel(const float* __restrict__ dataT,
                               const int* __restrict__ colsT,
                               const float* __restrict__ u,
                               const float* __restrict__ c,
                               float* __restrict__ y, int WT, int bc, int br,
                               int nrb, int G) {
  extern __shared__ __align__(16) float smem[];
  float* vec = smem;                                     // (br,) u block
  float* part = vec + br;                                // (bc, 32) partials
  float* cz = part + static_cast<size_t>(bc) * 32;       // (bc,) c .* z
  float* red = cz + bc;                                  // (G, br) pass B
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const size_t j = blockIdx.x;
  const size_t tile_elems = static_cast<size_t>(bc) * br;
  const float* row = dataT + j * static_cast<size_t>(WT) * tile_elems;
  const int* row_cols = colsT + j * static_cast<size_t>(WT);

  // ---- pass A: z_j = A_j^T u over the row's WT tiles ---------------------
  for (int a = warp; a < bc; a += nwarps) part[a * 32 + lane] = 0.f;
  for (int k = 0; k < WT; ++k) {
    const int rb = row_cols[k];
    if (rb < 0 || rb >= nrb) __trap();  // corrupt layout: fail loudly
    __syncthreads();
    const size_t base = static_cast<size_t>(rb) * br;
    for (int t = threadIdx.x; t < br; t += blockDim.x) vec[t] = __ldg(u + base + t);
    __syncthreads();
    ell::tile_rows_dot<VEC4>(row + k * tile_elems, vec, part, bc, br, lane,
                             warp, nwarps);
  }
  for (int a = warp; a < bc; a += nwarps) {
    const float s = ell::warp_sum(part[a * 32 + lane]);
    if (lane == 0) cz[a] = HAS_C ? __ldg(c + j * bc + a) * s : s;
  }
  __syncthreads();

  // ---- pass B: y[colsT[j, k]] += cz_j^T tile_k -----------------------------
  constexpr int kUnit = VEC4 ? 4 : 1;
  const int nq = br / kUnit;                  // column units per tile row
  const int g = threadIdx.x / nq;             // this thread's row group
  const int stride = G == 1 ? blockDim.x : nq;
  for (int k = 0; k < WT; ++k) {
    const int rb = row_cols[k];
    const float* tile = row + k * tile_elems;
    if (g < G) {
      for (int q = threadIdx.x % nq; q < nq; q += stride) {
        if (VEC4) {
          float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
          for (int a = g; a < bc; a += G) {
            const float s = cz[a];
            const float4 t = __ldg(
                reinterpret_cast<const float4*>(tile + static_cast<size_t>(a) * br) + q);
            acc.x += s * t.x;
            acc.y += s * t.y;
            acc.z += s * t.z;
            acc.w += s * t.w;
          }
          float* dst = red + static_cast<size_t>(g) * br + 4 * q;
          dst[0] = acc.x;
          dst[1] = acc.y;
          dst[2] = acc.z;
          dst[3] = acc.w;
        } else {
          float acc = 0.f;
#pragma unroll 4
          for (int a = g; a < bc; a += G)
            acc += cz[a] * __ldg(tile + static_cast<size_t>(a) * br + q);
          red[static_cast<size_t>(g) * br + q] = acc;
        }
      }
    }
    __syncthreads();
    for (int b = threadIdx.x; b < br; b += blockDim.x) {
      float s = 0.f;
      for (int gg = 0; gg < G; ++gg) s += red[static_cast<size_t>(gg) * br + b];
      atomicAdd(y + static_cast<size_t>(rb) * br + b, s);
    }
    __syncthreads();  // red is rewritten by the next slot
  }
}

template <bool VEC4, bool HAS_C>
cudaError_t launch(const float* dataT, const int* colsT, const float* u,
                   const float* c, float* y, int ncb, int WT, int bc, int br,
                   int nrb, int threads, cudaStream_t stream) {
  const int nq = VEC4 ? br / 4 : br;
  const int G = threads / nq > 1 ? threads / nq : 1;
  const size_t smem = (static_cast<size_t>(br) + 32 * static_cast<size_t>(bc) +
                       static_cast<size_t>(bc) +
                       static_cast<size_t>(G) * br) *
                      sizeof(float);
  auto kernel = ell_hvp_kernel<VEC4, HAS_C>;
  cudaError_t err = ell::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<ncb, threads, smem, stream>>>(dataT, colsT, u, c, y, WT, bc, br,
                                         nrb, G);
  return cudaGetLastError();
}

}  // namespace

// C entry point, called through ctypes. Returns a cudaError_t (0 = launched).
extern "C" int ell_hvp_launch(const float* dataT, const int* colsT,
                              const float* u, const float* c, float* y,
                              int ncb, int WT, int bc, int br, int nrb,
                              int threads, void* stream) {
  if (ncb <= 0 || WT <= 0 || br <= 0 || bc <= 0 || nrb <= 0 || threads <= 0 ||
      threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec4 =
      br % 4 == 0 && (reinterpret_cast<uintptr_t>(dataT) & 15) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (vec4)
    err = c ? launch<true, true>(dataT, colsT, u, c, y, ncb, WT, bc, br, nrb, threads, s)
            : launch<true, false>(dataT, colsT, u, c, y, ncb, WT, bc, br, nrb, threads, s);
  else
    err = c ? launch<false, true>(dataT, colsT, u, c, y, ncb, WT, bc, br, nrb, threads, s)
            : launch<false, false>(dataT, colsT, u, c, y, ncb, WT, bc, br, nrb, threads, s);
  return static_cast<int>(err);
}
