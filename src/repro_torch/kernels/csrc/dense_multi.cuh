// The dense multi-vector passes of the s-step HVP over s <=
// kern::kMaxCols probe vectors at once: xt_multi (K8, Z = X^T U) and
// x_cz_multi (K9, Y = X (c .* Z)). xt_multi.cu and x_cz_multi.cu are their
// entry points for f32 tiles, xt_multi_bf16.cu and x_cz_multi_bf16.cu for
// bf16 tiles (DiscoConfig.hvp_dtype = 'bfloat16').
//
// Layout: X (d, n) of tile type T (float or __nv_bfloat16), row-major with
// row stride ld >= n elements (a column slice of a wider matrix is passed
// as a view); U (d, s) and Z (n, s) f32 row-major with row strides ldu,
// ldz >= s; c (n,) f32 or null; the outputs f32 row-major. Element offsets
// are 64-bit.
//
// bf16 tiles round where the TPU kernels round (repro/kernels/glm_hvp.py:
// xt_multi's U.astype(X.dtype), x_cz_multi's (c * z).astype(x.dtype)):
// xt_multi rounds U as it stages it into shared memory, x_cz_multi rounds
// c .* Z (Z alone without c, as the softmax product passes it) where a
// thread forms it. Every product is then of two bf16 values, exact in f32;
// the sums are f32 in a fixed order, so the result repeats bit for bit.
// At f32 the rounding is the identity and the arithmetic is the f32
// kernels' own.
//
// xt_multi: column strips by row slices. Each CTA owns a strip of
// 4 * blockDim.x columns and a slice of rows; each thread keeps 4 * s sums
// (its 4 columns times the s vectors) in registers while it walks the
// rows, one load of its 4 elements a row (16 bytes of f32, 8 of bf16; a
// warp reads 512 or 256 contiguous bytes). The slice's rows of U are
// staged in shared memory CHUNK rows at a time and each row's s values
// are read as a broadcast. When the strips alone are too few CTAs to fill
// the card, the wrapper splits d into S slices; slice s writes its sums to
// part[s, :, :] and a second kernel adds the S blocks in order.
//
// x_cz_multi: x_cz's, widened to s vectors. Each CTA takes ROWS
// consecutive rows of X; its threads stride over the columns, a thread
// owning 4 consecutive columns a chunk (one load a row). Each column of
// c .* Z is used by exactly one thread, for all ROWS rows, so the thread
// forms it in registers: Z's row-major layout puts a thread's 4 columns'
// s values in 4 s contiguous floats and a warp's in one contiguous span of
// 128 s floats, which its scalar loads read through L1 (the block is in L2
// after the first CTAs). The loop has no barrier: all ROWS loads of X are
// issued before the multiply-adds (at bf16 the rows stay packed, two
// elements a word, until they are used). Each thread keeps ROWS * s
// partial sums in registers; warp shuffles and then one pass over the
// warps' sums in shared memory, in a fixed order, give Y. ROWS = 8 (twice
// x_cz's 4) halves how often the s-times-larger Z is read from L2 for each
// row of X. No atomics in either kernel.
//
// Instances by columns: the bf16 instances are compiled for each s in
// 1 .. kMaxCols (by_cols), so a thread holds exactly its s sums a row or
// column, in fewer registers; the f32 kernels keep their one instance for
// any s (kMaxCols sums held, s of them used). chip_multi_variants.py times
// the bf16 instances against text edits of this header (all kMaxCols sums
// held, more rows in flight) at the dense slice's full width; PERF.md
// keeps the figures. Eight columns a thread (16-byte loads of bf16) was
// slower at s = 5 in both kernels: more registers, fewer warps. At s = 8
// K9 is bound at either type by its scalar Z loads, each touching a line
// per lane, not by the bytes of X.
//
// Four-element loads need n and ld multiples of 4 and X aligned to 4
// elements' bytes, c to 16; other shapes take the scalar path (4 columns
// a thread for xt_multi, 1 for x_cz_multi, a warp's loads coalesced).
//
// Bound: device-memory bytes. Each element of X is read once for s
// multiply-adds (2 s flops per 4 bytes at f32, per 2 at bf16: at most 8
// flops a byte at s = 8, below the card's ~20 flops per byte), so X's
// bytes bound it for all s vectors at once.
#pragma once

#include <type_traits>

#include "ell_tiles.cuh"
#include "partials.cuh"

namespace dmulti {

using ells::ldg_elem;
using ells::round_to;

constexpr int kMaxThreads = 256;   // block size the kernels are compiled for
constexpr int CHUNK = 256;         // rows of U staged at a time (xt_multi)
constexpr int ROWS = 8;            // rows of X a CTA (x_cz_multi)

constexpr int kCols = 4;           // columns of X a thread reads at once

// The 4 consecutive elements of X at p as f32, through the read-only path
// in one load: 16 bytes of f32, 8 of bf16 (a bf16 value is the high half
// of its f32).
__device__ __forceinline__ void ldg4(const float* p, float (&x)[kCols]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
__device__ __forceinline__ void ldg4(const __nv_bfloat16* p,
                                     float (&x)[kCols]) {
  const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
  x[0] = __uint_as_float(w.x << 16);
  x[1] = __uint_as_float(w.x & 0xffff0000u);
  x[2] = __uint_as_float(w.y << 16);
  x[3] = __uint_as_float(w.y & 0xffff0000u);
}

// Whether X's rows take four-element loads: n and ld multiples of 4, X
// aligned to 4 elements' bytes.
template <class T>
inline bool vec_rows(const T* X, long long ld, int n) {
  return n % kCols == 0 && ld % kCols == 0 &&
         (reinterpret_cast<uintptr_t>(X) % (kCols * sizeof(T))) == 0;
}

// The kernels' instances by columns: S = s (1 .. kMaxCols) for bf16 tiles,
// whose sums a thread holds for exactly the call's s columns (fewer
// registers at small s, no spill at s = 8); S = 0 for f32 tiles, the f32
// kernels' one instance for any s (kMaxCols sums held, s of them used).
// by_cols calls f(std::integral_constant<int, S>) for the call's s.
template <class T, class F>
cudaError_t by_cols(int s, F&& f) {
  if constexpr (sizeof(T) == 4) {
    return f(std::integral_constant<int, 0>{});
  } else {
    switch (s) {
      case 1: return f(std::integral_constant<int, 1>{});
      case 2: return f(std::integral_constant<int, 2>{});
      case 3: return f(std::integral_constant<int, 3>{});
      case 4: return f(std::integral_constant<int, 4>{});
      case 5: return f(std::integral_constant<int, 5>{});
      case 6: return f(std::integral_constant<int, 6>{});
      case 7: return f(std::integral_constant<int, 7>{});
      case 8: return f(std::integral_constant<int, 8>{});
      default: return cudaErrorInvalidValue;
    }
  }
}

// Sums held a row or column by an instance of S columns.
template <int S>
constexpr int kHeld = S ? S : kern::kMaxCols;

// xt_multi: acc[t][j] += u[j] x[t] for one row's C elements x of a thread
// and the row's staged u.
template <int C, int S>
__device__ __forceinline__ void xt_row(const float (&x)[C],
                                       const float* __restrict__ u,
                                       float (&acc)[C][kHeld<S>], int s) {
#pragma unroll
  for (int j = 0; j < kHeld<S>; ++j) {
    if (S || j < s) {
      const float uj = u[j];
#pragma unroll
      for (int t = 0; t < C; ++t) acc[t][j] += uj * x[t];
    }
  }
}

template <class T, bool VEC, int S>
__global__ void __launch_bounds__(kMaxThreads)
xt_multi_kernel(const T* __restrict__ X, int64_t ld,
                const float* __restrict__ U, int64_t ldu,
                float* __restrict__ out, int d, int n, int s,
                int rows_per_slice) {
  constexpr int C = kCols;                 // columns a thread
  constexpr int SH = kHeld<S>;
  __shared__ float uS[CHUNK * kern::kMaxCols];
  const int64_t nt = blockDim.x;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * C * nt;
  const int r0 = blockIdx.y * rows_per_slice;
  const int r1 = min(d, r0 + rows_per_slice);
  float* o = out + static_cast<int64_t>(blockIdx.y) * n * s;
  // VEC: this thread's columns are col .. col + C - 1; else c0 + k nt
  const int64_t col = col0 + C * static_cast<int64_t>(threadIdx.x);
  const int64_t c0 = col0 + threadIdx.x;
  float acc[C][SH];
#pragma unroll
  for (int t = 0; t < C; ++t)
#pragma unroll
    for (int j = 0; j < SH; ++j) acc[t][j] = 0.f;

  for (int rc = r0; rc < r1; rc += CHUNK) {
    const int nr = min(CHUNK, r1 - rc);
    __syncthreads();                       // all readers done with uS
    for (int e = threadIdx.x; e < nr * s; e += blockDim.x) {
      const int rr = e / s;
      const int j = e - rr * s;
      uS[rr * kern::kMaxCols + j] =
          round_to<T>(__ldg(U + (rc + rr) * ldu + j));
    }
    __syncthreads();
    if constexpr (VEC) {
      if (col < n) {                       // n % C == 0: col < n covers them
        const T* p = X + static_cast<int64_t>(rc) * ld + col;
#pragma unroll 4
        for (int rr = 0; rr < nr; ++rr, p += ld) {
          float x[C];
          ldg4(p, x);
          xt_row<C, S>(x, uS + rr * kern::kMaxCols, acc, s);
        }
      }
    } else {
      const T* p = X + static_cast<int64_t>(rc) * ld;
      for (int rr = 0; rr < nr; ++rr, p += ld) {
        float x[4];
#pragma unroll
        for (int t = 0; t < 4; ++t)
          x[t] = c0 + t * nt < n ? ldg_elem(p + c0 + t * nt) : 0.f;
        xt_row<4, S>(x, uS + rr * kern::kMaxCols, acc, s);
      }
    }
  }

#pragma unroll
  for (int t = 0; t < C; ++t) {
    const int64_t ct = VEC ? col + t : c0 + t * nt;
    if (ct < n) {
#pragma unroll
      for (int j = 0; j < SH; ++j)
        if (S || j < s) o[ct * s + j] = acc[t][j];
    }
  }
}

// The body of the K8 entry points: part is (slices, n, s) scratch, unused
// when slices == 1. Returns a cudaError_t (0 = launched).
template <class T>
cudaError_t xt_multi(const T* X, long long ld, const float* U, long long ldu,
                     float* Z, float* part, int d, int n, int s, int slices,
                     int threads, cudaStream_t st) {
  if (!X || !U || !Z || d <= 0 || n <= 0 || ld < n || s <= 0 ||
      s > kern::kMaxCols || ldu < s || slices <= 0 || slices > 65535 ||
      threads <= 0 || threads % 32 != 0 || threads > kMaxThreads ||
      (slices > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  const bool vec = vec_rows(X, ld, n);
  const int64_t strip = kCols * static_cast<int64_t>(threads);
  const dim3 grid(static_cast<unsigned>((n + strip - 1) / strip), slices);
  const int rows_per_slice = (d + slices - 1) / slices;
  float* out = slices == 1 ? Z : part;
  cudaError_t err = by_cols<T>(s, [&](auto S) {
    if (vec)
      xt_multi_kernel<T, true, decltype(S)::value><<<grid, threads, 0, st>>>(
          X, ld, U, ldu, out, d, n, s, rows_per_slice);
    else
      xt_multi_kernel<T, false, decltype(S)::value><<<grid, threads, 0, st>>>(
          X, ld, U, ldu, out, d, n, s, rows_per_slice);
    return cudaGetLastError();
  });
  if (err == cudaSuccess && slices > 1)
    err = kern::sum_rows(part, Z, slices, n * s, st);
  return err;
}

template <class T, bool VEC, bool HAS_C, int S>
__global__ void __launch_bounds__(kMaxThreads)
x_cz_multi_kernel(const T* __restrict__ X, int64_t ld,
                  const float* __restrict__ c,
                  const float* __restrict__ Z, int64_t ldz,
                  float* __restrict__ Y, int d, int n, int s) {
  constexpr int SH = kHeld<S>;
  __shared__ float red[ROWS * kern::kMaxCols][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int r0 = blockIdx.x * ROWS;
  const int nr = min(ROWS, d - r0);
  const T* row = X + static_cast<int64_t>(r0) * ld;
  float acc[ROWS][SH];
#pragma unroll
  for (int k = 0; k < ROWS; ++k)
#pragma unroll
    for (int j = 0; j < SH; ++j) acc[k][j] = 0.f;

  // VEC: columns col .. col + C - 1 (n % C == 0, so col < n covers
  // them); else the single column col
  constexpr int C = VEC ? kCols : 1;
  const int64_t step = C * static_cast<int64_t>(blockDim.x);
  for (int64_t col = C * static_cast<int64_t>(threadIdx.x); col < n;
       col += step) {
    if constexpr (VEC && sizeof(T) == 2) {   // bf16: 4 columns, 8 bytes
      // the rows' elements stay packed (two a word) until they are used
      uint2 xr[ROWS];
#pragma unroll
      for (int k = 0; k < ROWS; ++k)
        xr[k] = k < nr ? __ldg(reinterpret_cast<const uint2*>(
                             row + k * ld + col))
                       : make_uint2(0u, 0u);
      const float4 c4 = HAS_C ? __ldg(reinterpret_cast<const float4*>(c + col))
                              : make_float4(1.f, 1.f, 1.f, 1.f);
      const float cc[C] = {c4.x, c4.y, c4.z, c4.w};
      const float* z = Z + col * ldz;
#pragma unroll
      for (int j = 0; j < SH; ++j) {
        if (S || j < s) {
          float zz[C];
#pragma unroll
          for (int e = 0; e < C; ++e)
            zz[e] = round_to<T>(cc[e] * __ldg(z + e * ldz + j));
#pragma unroll
          for (int k = 0; k < ROWS; ++k)
            acc[k][j] += __uint_as_float(xr[k].x << 16) * zz[0] +
                         __uint_as_float(xr[k].x & 0xffff0000u) * zz[1] +
                         __uint_as_float(xr[k].y << 16) * zz[2] +
                         __uint_as_float(xr[k].y & 0xffff0000u) * zz[3];
        }
      }
    } else if constexpr (VEC) {              // f32: 4 columns, 16 bytes
      float4 x[ROWS];
#pragma unroll
      for (int k = 0; k < ROWS; ++k)
        x[k] = k < nr ? __ldg(reinterpret_cast<const float4*>(
                            row + k * ld + col))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 cc = HAS_C ? __ldg(reinterpret_cast<const float4*>(c + col))
                              : make_float4(1.f, 1.f, 1.f, 1.f);
      const float* z = Z + col * ldz;
#pragma unroll
      for (int j = 0; j < SH; ++j) {
        if (S || j < s) {
          const float z0 = round_to<T>(cc.x * __ldg(z + j));
          const float z1 = round_to<T>(cc.y * __ldg(z + ldz + j));
          const float z2 = round_to<T>(cc.z * __ldg(z + 2 * ldz + j));
          const float z3 = round_to<T>(cc.w * __ldg(z + 3 * ldz + j));
#pragma unroll
          for (int k = 0; k < ROWS; ++k)
            acc[k][j] += x[k].x * z0 + x[k].y * z1 + x[k].z * z2 + x[k].w * z3;
        }
      }
    } else {
      float x[ROWS];
#pragma unroll
      for (int k = 0; k < ROWS; ++k)
        x[k] = k < nr ? ldg_elem(row + k * ld + col) : 0.f;
      const float cc = HAS_C ? __ldg(c + col) : 1.f;
#pragma unroll
      for (int j = 0; j < SH; ++j) {
        if (S || j < s) {
          const float zj = round_to<T>(cc * __ldg(Z + col * ldz + j));
#pragma unroll
          for (int k = 0; k < ROWS; ++k) acc[k][j] += x[k] * zj;
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
#pragma unroll
    for (int j = 0; j < SH; ++j) {
      if (S || j < s) {                    // uniform over the CTA
        const float sum = kern::warp_sum(acc[k][j]);
        if (lane == 0) red[k * kern::kMaxCols + j][warp] = sum;
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nr * s; e += blockDim.x) {
    const int k = e / s;
    const int j = e - k * s;
    float sum = 0.f;
    for (int w = 0; w < nwarps; ++w) sum += red[k * kern::kMaxCols + j][w];
    Y[static_cast<int64_t>(r0 + k) * s + j] = sum;
  }
}

// The body of the K9 entry points; c may be null (no scale). Returns a
// cudaError_t (0 = launched).
template <class T>
cudaError_t x_cz_multi(const T* X, long long ld, const float* c,
                       const float* Z, long long ldz, float* Y, int d, int n,
                       int s, int threads, cudaStream_t st) {
  if (!X || !Z || !Y || d <= 0 || n <= 0 || ld < n || s <= 0 ||
      s > kern::kMaxCols || ldz < s || threads < 32 || threads % 32 != 0 ||
      threads > kMaxThreads)
    return cudaErrorInvalidValue;
  const bool vec =
      vec_rows(X, ld, n) && (reinterpret_cast<uintptr_t>(c) & 15) == 0;
  const unsigned blocks = static_cast<unsigned>((d + ROWS - 1) / ROWS);
  return by_cols<T>(s, [&](auto S) {
    constexpr int kS = decltype(S)::value;
    if (vec && c)
      x_cz_multi_kernel<T, true, true, kS><<<blocks, threads, 0, st>>>(
          X, ld, c, Z, ldz, Y, d, n, s);
    else if (vec)
      x_cz_multi_kernel<T, true, false, kS><<<blocks, threads, 0, st>>>(
          X, ld, c, Z, ldz, Y, d, n, s);
    else if (c)
      x_cz_multi_kernel<T, false, true, kS><<<blocks, threads, 0, st>>>(
          X, ld, c, Z, ldz, Y, d, n, s);
    else
      x_cz_multi_kernel<T, false, false, kS><<<blocks, threads, 0, st>>>(
          X, ld, c, Z, ldz, Y, d, n, s);
    return cudaGetLastError();
  });
}

}  // namespace dmulti
