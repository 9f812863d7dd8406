// Fused one-pass dense multi-vector HVP core  Y = X (c .* (X^T U))  for
// Hopper (sm_90a), over s <= kern::kMaxCols probe vectors at once.
//
// Replaces the Pallas TPU kernel repro/kernels/glm_hvp.py::x_c_xt_multi
// (_x_c_xt_multi_kernel). On the DiSCO main path it is the batched HVP of
// an s-step round on dense input under hvp_fused=True: every DiSCO-S shard's
// round product, and the DiSCO-F round on a single shard (there the first s
// of the s + 1 basis columns come in as a strided view).
//
// Layout: X (d, n) f32, row-major with row stride ld >= n elements; c
// (optional, n); U (d, s) f32 row-major with row stride ldu >= s; part
// (G, d, s) f32 scratch; Y (d, s) f32 row-major. Element offsets are 64-bit.
//
// Design: x_c_xt_u.cu's, widened to s columns. A panel is bn columns of X
// held in shared memory; the wrapper picks the widest bn of 32, 16, 8, 4
// with (d * bn + d * s + (warps + 1) * bn * s) * 4 bytes <= 227 KB (bn = 8
// at d = 4096 and s = 5: 218 KB; bn = 4 at s = 8: 199 KB) and takes the
// two-pass route (xt_multi, then x_cz_multi) when no panel fits. A CTA has
// 1024 threads up to s = 5 and 512 above, where the 4 * s partial sums per
// thread do not fit 1024 threads' 64 registers and spill. A persistent
// grid of G CTAs walks the panels p = blockIdx.x, + G, ...; per panel:
//   1. each thread loads its VEC-wide pieces of the panel (bn / VEC
//      neighbouring threads cover one row's bn columns), stores them in
//      shared memory and adds x * U[r, k] into its VEC * S partials of
//      Z[j, k] = X[:, j]^T U[:, k] (U's rows come through the read-only
//      cache);
//   2. the partials of each (column, k) are summed in a fixed order (warp
//      shuffles, then the warps' sums), and cz[j, k] = c_j Z[j, k];
//   3. each thread reads back exactly the pieces it stored (no barrier is
//      needed for the panel itself), forms its S dot products with cz, and
//      the bn / VEC threads of a row add them (shuffles) into the CTA's
//      partial Y[r, :] in shared memory, kept k-major so that neighbouring
//      rows sit in neighbouring banks.
// After its last panel the CTA writes its partial Y to part[blockIdx.x] and
// a second kernel adds the G blocks in order. Every element of X leaves
// device memory once for all s columns. No atomics: repeatable bit for bit
// for a given (d, n, s, bn, G).
//
// Bound: device-memory bytes (4 s flops per 4-byte element of X: 5 flops
// per byte at s = 5, a quarter of the card's f32 rate per byte). The panel
// load and the two passes over shared memory do not overlap within a CTA,
// and each panel re-reads U (d * s values) from L2; both cost time against
// the bound and are left to a later revision.
#include "partials.cuh"

namespace {

// block size the kernel is compiled for, at S columns (threads_for in
// kernels/glm_hvp.py)
constexpr int threads_for(int S) { return S <= 5 ? 1024 : 512; }

template <int VEC, int S, bool HAS_C>
__global__ void __launch_bounds__(threads_for(S))
x_c_xt_multi_kernel(const float* __restrict__ X, int64_t ld,
                    const float* __restrict__ c,
                    const float* __restrict__ U, int64_t ldu,
                    float* __restrict__ part, int d, int n, int bn,
                    int npanels) {
  extern __shared__ __align__(16) float smem[];
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nwarps = T >> 5;
  float* panel = smem;                                  // (d, bn)
  float* ys = panel + static_cast<int64_t>(d) * bn;     // (S, d) partial Y
  float* red = ys + static_cast<int64_t>(d) * S;        // (nwarps, bn, S)
  float* cz = red + nwarps * bn * S;                    // (bn, S)
  const int lpr = bn / VEC;            // threads per row (1..32)
  const int sub = t % lpr;             // this thread's piece of a row
  const int rstep = T / lpr;           // rows per sweep of the CTA

  for (int i = t; i < d * S; i += T) ys[i] = 0.f;
  __syncthreads();

  for (int p = blockIdx.x; p < npanels; p += gridDim.x) {
    const int64_t col = static_cast<int64_t>(p) * bn + sub * VEC;
    // 1. load the panel; partial sums of Z over this thread's rows
    float acc[VEC][S];
#pragma unroll
    for (int v = 0; v < VEC; ++v)
#pragma unroll
      for (int k = 0; k < S; ++k) acc[v][k] = 0.f;
#pragma unroll 4
    for (int r = t / lpr; r < d; r += rstep) {
      float x[VEC];
      const float* src = X + static_cast<int64_t>(r) * ld + col;
      if constexpr (VEC == 4) {
        // n % 4 == 0 here, so col < n covers col + 3
        const float4 q = col < n ? __ldg(reinterpret_cast<const float4*>(src))
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
        x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
        *reinterpret_cast<float4*>(panel + r * bn + sub * VEC) = q;
      } else {
        x[0] = col < n ? __ldg(src) : 0.f;
        panel[r * bn + sub] = x[0];
      }
      const float* ur = U + static_cast<int64_t>(r) * ldu;
#pragma unroll
      for (int k = 0; k < S; ++k) {
        const float uk = __ldg(ur + k);
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[v][k] += uk * x[v];
      }
    }
    // 2. Z[j, k] over the CTA, then cz[j, k]
#pragma unroll
    for (int v = 0; v < VEC; ++v)
#pragma unroll
      for (int k = 0; k < S; ++k)
        for (int off = 16; off >= lpr; off >>= 1)
          acc[v][k] += __shfl_down_sync(0xffffffffu, acc[v][k], off);
    if (lane < lpr) {
#pragma unroll
      for (int v = 0; v < VEC; ++v)
#pragma unroll
        for (int k = 0; k < S; ++k)
          red[(warp * bn + lane * VEC + v) * S + k] = acc[v][k];
    }
    __syncthreads();
    for (int e = t; e < bn * S; e += T) {
      float s = 0.f;
      for (int w = 0; w < nwarps; ++w) s += red[w * bn * S + e];
      const int64_t j = static_cast<int64_t>(p) * bn + e / S;
      cz[e] = j < n ? (HAS_C ? __ldg(c + j) * s : s) : 0.f;
    }
    __syncthreads();
    // 3. Y[r, k] += X[r, panel] . cz[:, k] from this thread's own pieces.
    //    The sweep loop runs the same count in every lane, for the shuffles.
    float w[VEC][S];
#pragma unroll
    for (int v = 0; v < VEC; ++v)
#pragma unroll
      for (int k = 0; k < S; ++k) w[v][k] = cz[(sub * VEC + v) * S + k];
#pragma unroll 4
    for (int rb = 0; rb < d; rb += rstep) {
      const int r = rb + t / lpr;
      float x[VEC];
      if (r < d) {
        if constexpr (VEC == 4) {
          const float4 q =
              *reinterpret_cast<const float4*>(panel + r * bn + sub * VEC);
          x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
        } else {
          x[0] = panel[r * bn + sub];
        }
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v) x[v] = 0.f;
      }
#pragma unroll
      for (int k = 0; k < S; ++k) {
        float s = 0.f;
#pragma unroll
        for (int v = 0; v < VEC; ++v) s += x[v] * w[v][k];
        for (int off = lpr >> 1; off > 0; off >>= 1)
          s += __shfl_down_sync(0xffffffffu, s, off);
        if (sub == 0 && r < d) ys[k * d + r] += s;
      }
    }
    // the next panel's step 2 rewrites red and cz only after the barrier
    // that follows its step 1, by which time every thread has read cz
  }
  __syncthreads();
  float* out = part + static_cast<int64_t>(blockIdx.x) * d * S;
  for (int i = t; i < d * S; i += T) out[i] = ys[(i % S) * d + i / S];
}

template <int VEC, int S, bool HAS_C>
cudaError_t launch(const float* X, int64_t ld, const float* c, const float* U,
                   int64_t ldu, float* part, int d, int n, int bn,
                   int npanels, int grid, int threads, size_t smem,
                   cudaStream_t stream) {
  if (threads != threads_for(S)) return cudaErrorInvalidValue;
  auto kernel = x_c_xt_multi_kernel<VEC, S, HAS_C>;
  cudaError_t err = kern::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(X, ld, c, U, ldu, part, d, n, bn,
                                          npanels);
  return cudaGetLastError();
}

template <int VEC, int S>
cudaError_t launch_c(const float* X, int64_t ld, const float* c,
                     const float* U, int64_t ldu, float* part, int d, int n,
                     int bn, int npanels, int grid, int threads, size_t smem,
                     cudaStream_t stream) {
  return c ? launch<VEC, S, true>(X, ld, c, U, ldu, part, d, n, bn, npanels,
                                  grid, threads, smem, stream)
           : launch<VEC, S, false>(X, ld, c, U, ldu, part, d, n, bn, npanels,
                                   grid, threads, smem, stream);
}

template <int VEC>
cudaError_t launch_s(int s, const float* X, int64_t ld, const float* c,
                     const float* U, int64_t ldu, float* part, int d, int n,
                     int bn, int npanels, int grid, int threads, size_t smem,
                     cudaStream_t stream) {
  static_assert(kern::kMaxCols == 8, "one case per column count");
#define X_C_XT_MULTI_CASE(S)                                              \
  case S:                                                                 \
    return launch_c<VEC, S>(X, ld, c, U, ldu, part, d, n, bn, npanels,    \
                            grid, threads, smem, stream);
  switch (s) {
    X_C_XT_MULTI_CASE(1)
    X_C_XT_MULTI_CASE(2)
    X_C_XT_MULTI_CASE(3)
    X_C_XT_MULTI_CASE(4)
    X_C_XT_MULTI_CASE(5)
    X_C_XT_MULTI_CASE(6)
    X_C_XT_MULTI_CASE(7)
    X_C_XT_MULTI_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef X_C_XT_MULTI_CASE
}

}  // namespace

// C entry point, called through ctypes; c may be null (no scale). part is
// (grid, d, s) scratch; threads must be threads_for(s). Returns a
// cudaError_t (0 = launched).
extern "C" int x_c_xt_multi_launch(const float* X, long long ld,
                                   const float* c, const float* U,
                                   long long ldu, float* Y, float* part,
                                   int d, int n, int s, int bn, int grid,
                                   int threads, void* stream) {
  if (d <= 0 || n <= 0 || ld < n || s <= 0 || s > kern::kMaxCols ||
      ldu < s || grid <= 0 || part == nullptr ||
      !(bn == 4 || bn == 8 || bn == 16 || bn == 32))
    return static_cast<int>(cudaErrorInvalidValue);
  const int npanels = static_cast<int>((static_cast<int64_t>(n) + bn - 1) / bn);
  const size_t smem = (static_cast<size_t>(d) * bn +
                       static_cast<size_t>(d) * s +
                       static_cast<size_t>(threads / 32 + 1) * bn * s) *
                      sizeof(float);
  const bool vec4 = n % 4 == 0 && ld % 4 == 0 &&
                    (reinterpret_cast<uintptr_t>(X) & 15) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      vec4 ? launch_s<4>(s, X, ld, c, U, ldu, part, d, n, bn, npanels, grid,
                         threads, smem, st)
           : launch_s<1>(s, X, ld, c, U, ldu, part, d, n, bn, npanels, grid,
                         threads, smem, st);
  if (err == cudaSuccess) err = kern::sum_rows(part, Y, grid, d * s, st);
  return static_cast<int>(err);
}
