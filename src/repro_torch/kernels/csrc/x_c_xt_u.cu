// Fused one-pass dense HVP core  y = X (c .* (X^T u))  for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/glm_hvp.py::x_c_xt_u
// (_x_c_xt_u_kernel). On the DiSCO main path it is the local curvature
// product under hvp_fused=True: every DiSCO-S HVP, and the DiSCO-F HVP on a
// single shard.
//
// Layout: X (d, n) f32, row-major with row stride ld >= n elements; c
// (optional) and u as in the two-pass kernels; part (G, d) f32 scratch,
// y (d,) f32. Element offsets are 64-bit.
//
// Design: the TPU kernel kept a whole (d, 512) column panel in VMEM. Here a
// panel is bn columns, held in shared memory: the wrapper picks the largest
// bn of 32, 16, 8, 4 with (d * bn + d + 33 * bn) * 4 bytes <= 227 KB (bn = 8
// at d = 4096: 144 KB), and takes the two-pass route when even bn = 4 does
// not fit (d above about 11,000). A persistent grid of G CTAs (as many as
// are resident at once) walks the panels p = blockIdx.x, + G, ...; per
// panel:
//   1. each thread loads its VEC-wide pieces of the panel (bn / VEC
//      neighbouring threads cover one row's bn columns), stores them in
//      shared memory and adds u_r * x into its partials of z_j = X[:, j]^T u;
//   2. the partials of each column are summed in a fixed order (warp
//      shuffles, then the warps' sums), and cz_j = c_j z_j;
//   3. each thread reads back exactly the pieces it stored (no barrier is
//      needed for the panel itself), dots them with cz, and the bn / VEC
//      threads of a row add their sums (shuffles) into the CTA's partial
//      y_r in shared memory.
// After its last panel the CTA writes its partial y to part[blockIdx.x, :]
// and a second kernel adds the G rows in order. Every element of X leaves
// device memory once. No atomics: repeatable bit for bit for a given
// (d, n, bn, G).
//
// Bound: device-memory bytes (4 flops per 4-byte element of X). The panel
// load and the two passes over shared memory do not overlap within a CTA;
// that costs time against the bound, left to a later revision.
#include "partials.cuh"

namespace {

template <int VEC, bool HAS_C>
__global__ void __launch_bounds__(1024)
x_c_xt_u_kernel(const float* __restrict__ X, int64_t ld,
                const float* __restrict__ c, const float* __restrict__ u,
                float* __restrict__ part, int d, int n, int bn,
                int npanels) {
  extern __shared__ __align__(16) float smem[];
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nwarps = T >> 5;
  float* panel = smem;                 // (d, bn)
  float* ys = panel + static_cast<int64_t>(d) * bn;  // (d,) partial y
  float* red = ys + d;                 // (nwarps, bn) column partials
  float* cz = red + nwarps * bn;       // (bn,)
  const int lpr = bn / VEC;            // threads per row (1..32)
  const int sub = t % lpr;             // this thread's piece of a row
  const int rstep = T / lpr;           // rows per sweep of the CTA

  for (int i = t; i < d; i += T) ys[i] = 0.f;
  __syncthreads();

  for (int p = blockIdx.x; p < npanels; p += gridDim.x) {
    const int64_t col = static_cast<int64_t>(p) * bn + sub * VEC;
    // 1. load the panel; partial sums of z over this thread's rows
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
#pragma unroll 4
    for (int r = t / lpr; r < d; r += rstep) {
      float x[VEC];
      const float* src = X + static_cast<int64_t>(r) * ld + col;
      if constexpr (VEC == 4) {
        // n % 4 == 0 here, so col < n covers col + 3
        const float4 v = col < n ? __ldg(reinterpret_cast<const float4*>(src))
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
        x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
        *reinterpret_cast<float4*>(panel + r * bn + sub * VEC) = v;
      } else {
        x[0] = col < n ? __ldg(src) : 0.f;
        panel[r * bn + sub] = x[0];
      }
      const float ur = __ldg(u + r);
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] += ur * x[k];
    }
    // 2. z_j over the CTA, then cz_j
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      for (int off = 16; off >= lpr; off >>= 1)
        acc[k] += __shfl_down_sync(0xffffffffu, acc[k], off);
    if (lane < lpr) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) red[warp * bn + lane * VEC + k] = acc[k];
    }
    __syncthreads();
    if (t < bn) {
      float s = 0.f;
      for (int w = 0; w < nwarps; ++w) s += red[w * bn + t];
      const int64_t j = static_cast<int64_t>(p) * bn + t;
      cz[t] = j < n ? (HAS_C ? __ldg(c + j) * s : s) : 0.f;
    }
    __syncthreads();
    // 3. y_r += X[r, panel] . cz from this thread's own pieces. The sweep
    //    loop runs the same count in every lane, for the shuffles.
    float w[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) w[k] = cz[sub * VEC + k];
#pragma unroll 4
    for (int rb = 0; rb < d; rb += rstep) {
      const int r = rb + t / lpr;
      float s = 0.f;
      if (r < d) {
        if constexpr (VEC == 4) {
          const float4 v =
              *reinterpret_cast<const float4*>(panel + r * bn + sub * VEC);
          s = v.x * w[0] + v.y * w[1] + v.z * w[2] + v.w * w[3];
        } else {
          s = panel[r * bn + sub] * w[0];
        }
      }
      for (int off = lpr >> 1; off > 0; off >>= 1)
        s += __shfl_down_sync(0xffffffffu, s, off);
      if (sub == 0 && r < d) ys[r] += s;
    }
  }
  __syncthreads();
  float* out = part + static_cast<int64_t>(blockIdx.x) * d;
  for (int i = t; i < d; i += T) out[i] = ys[i];
}

template <int VEC, bool HAS_C>
cudaError_t launch(const float* X, int64_t ld, const float* c, const float* u,
                   float* part, int d, int n, int bn, int npanels, int grid,
                   int threads, size_t smem, cudaStream_t stream) {
  auto kernel = x_c_xt_u_kernel<VEC, HAS_C>;
  cudaError_t err = kern::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(X, ld, c, u, part, d, n, bn, npanels);
  return cudaGetLastError();
}

}  // namespace

// C entry point, called through ctypes; c may be null (no scale). part is
// (grid, d) scratch. Returns a cudaError_t (0 = launched).
extern "C" int x_c_xt_u_launch(const float* X, long long ld, const float* c,
                               const float* u, float* y, float* part, int d,
                               int n, int bn, int grid, int threads,
                               void* stream) {
  if (d <= 0 || n <= 0 || ld < n || grid <= 0 || part == nullptr ||
      threads <= 0 || threads % 32 != 0 || threads > 1024 ||
      !(bn == 4 || bn == 8 || bn == 16 || bn == 32))
    return static_cast<int>(cudaErrorInvalidValue);
  const int npanels = static_cast<int>((static_cast<int64_t>(n) + bn - 1) / bn);
  const size_t smem = (static_cast<size_t>(d) * bn + d +
                       static_cast<size_t>(threads / 32 + 1) * bn) * sizeof(float);
  const bool vec4 = n % 4 == 0 && ld % 4 == 0 &&
                    (reinterpret_cast<uintptr_t>(X) & 15) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (vec4)
    err = c ? launch<4, true>(X, ld, c, u, part, d, n, bn, npanels, grid, threads, smem, s)
            : launch<4, false>(X, ld, c, u, part, d, n, bn, npanels, grid, threads, smem, s);
  else
    err = c ? launch<1, true>(X, ld, c, u, part, d, n, bn, npanels, grid, threads, smem, s)
            : launch<1, false>(X, ld, c, u, part, d, n, bn, npanels, grid, threads, smem, s);
  if (err == cudaSuccess) err = kern::sum_rows(part, y, grid, d, s);
  return static_cast<int>(err);
}
