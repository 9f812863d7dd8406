// Device helpers shared by the two blocked-ELL designs of the port:
// ell_stream.cuh (K1 ell_mv, K6 ell_mm) and ell_hvp_stream.cuh (K2
// ell_hvp, K7 ell_hvp_mm). Both stream a layout's live tiles into a ring
// of shared memory by 1-D bulk copies (no tensor map), one mbarrier a
// stage, and take each tile as 16 warps x kRowsPerWarp rows, lanes over
// the tile's row with 4 elements a read (16 bytes of f32, 8 of bf16).
//
// Tile element type T: float or __nv_bfloat16 (DiscoConfig.hvp_dtype).
// Vectors, sums and outputs are f32 either way. With bf16 tiles the
// kernels round where the TPU kernels round (repro/kernels/sparse_hvp.py):
// the vector a tile multiplies is rounded to bf16 first (round_to), so
// every product is of two bf16 values, exact in f32, and the sums are f32.
#pragma once

#include <cuda_bf16.h>

#include <type_traits>

#include "common.cuh"

namespace ells {

constexpr int kThreads = 512;                     // threads of a CTA
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 8;                   // accumulator rows a warp
constexpr int kRows = kWarps * kRowsPerWarp;      // tile rows of one piece
constexpr int kMaxStages = 4;
constexpr int kBarrierBytes = 128;                // the ring's mbarriers

enum Path : int { kDirect = 0, kBulk = 1 };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// Arrive once and expect `bytes` of bulk-copy transfers on the barrier.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Wait until the barrier's phase of the given parity has completed. A wait
// of more than about ten seconds traps (a launch error) rather than hang
// the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1ll << 34)) __trap();
  }
}

// One 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from device memory into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)),
         "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Largest k in [0, n) with a[k] <= x, for a nondecreasing a with a[0] <= x.
__device__ __forceinline__ int last_at_most(const int* a, int n, int x) {
  int lo = 0, hi = n;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= x) lo = mid; else hi = mid;
  }
  return lo;
}

// x rounded to the tile element type T and widened back to f32: the
// identity for f32 tiles, round to nearest even for bf16 tiles (as the
// TPU kernels' astype and torch's .to(torch.bfloat16)).
template <class T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (std::is_same_v<T, float>) return x;
  else return __bfloat162float(__float2bfloat16_rn(x));
}

// One tile element as f32, from shared memory or, through the read-only
// path, from device memory (a bf16 value is the high half of its f32).
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float ldg_elem(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_elem(const __nv_bfloat16* p) {
  return __uint_as_float(static_cast<uint32_t>(
                             __ldg(reinterpret_cast<const unsigned short*>(p)))
                         << 16);
}

// Elements [4q, 4q + 4) of a tile row in shared memory as f32: one
// 16-byte read of f32, one 8-byte read of bf16.
__device__ __forceinline__ float4 load4(const float* row, int q) {
  return reinterpret_cast<const float4*>(row)[q];
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* row, int q) {
  const uint2 w = reinterpret_cast<const uint2*>(row)[q];
  return make_float4(__uint_as_float(w.x << 16),
                     __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16),
                     __uint_as_float(w.y & 0xffff0000u));
}

// vecT[j * bc + b] = c[b] * V[b * ldv + j] (c = 1 when null), rounded to
// the tile type T: the piece's block of c .* V, s-major, from the stage's
// copy or from device memory.
template <class T, int S>
__device__ __forceinline__ void stage_vec(float* __restrict__ vecT,
                                          const float* vsrc, long long ldv,
                                          const float* csrc, int bc) {
  for (int e = threadIdx.x; e < bc * S; e += kThreads) {
    const int b = e / S;
    const int j = e - b * S;
    const float x = vsrc[b * ldv + j];
    vecT[j * bc + b] = round_to<T>(csrc ? csrc[b] * x : x);
  }
}

// acc[k][j] += sum_b tile[r_k, b] * vecT[j, b] for the rows r_k = warp + k *
// kWarps < rows. VEC4: tile in shared memory, 4 elements a read (bc % 4 ==
// 0); else the tile in device memory, one element a lane.
template <class T, int S, bool VEC4>
__device__ __forceinline__ void dot_rows(const T* __restrict__ tile,
                                         const float* __restrict__ vecT,
                                         float (&acc)[kRowsPerWarp][S],
                                         int rows, int bc, int lane,
                                         int warp) {
  if (VEC4) {
    const int nq = bc >> 2;
    const float4* v4 = reinterpret_cast<const float4*>(vecT);
    for (int q = lane; q < nq; q += 32) {
      float4 v[S];
#pragma unroll
      for (int j = 0; j < S; ++j) v[j] = v4[j * nq + q];
#pragma unroll
      for (int k = 0; k < kRowsPerWarp; ++k) {
        const int r = warp + k * kWarps;
        if (r < rows) {
          const float4 x = load4(tile + static_cast<size_t>(r) * bc, q);
#pragma unroll
          for (int j = 0; j < S; ++j)
            acc[k][j] += x.x * v[j].x + x.y * v[j].y + x.z * v[j].z +
                         x.w * v[j].w;
        }
      }
    }
  } else {
    for (int b = lane; b < bc; b += 32) {
      float v[S];
#pragma unroll
      for (int j = 0; j < S; ++j) v[j] = vecT[j * bc + b];
#pragma unroll
      for (int k = 0; k < kRowsPerWarp; ++k) {
        const int r = warp + k * kWarps;
        if (r < rows) {
          const float x = ldg_elem(tile + static_cast<size_t>(r) * bc + b);
#pragma unroll
          for (int j = 0; j < S; ++j) acc[k][j] += x * v[j];
        }
      }
    }
  }
}

inline bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

// Whether a bulk copy can take rows of `cols` tile elements of type T:
// every row a multiple of 16 bytes (4 f32, 8 bf16), so that each piece
// and the span after it in a stage start 16-byte aligned.
template <class T>
inline bool bulk_rows(int cols) {
  return (static_cast<size_t>(cols) * sizeof(T)) % 16 == 0;
}

inline int round_up(size_t x, int to) {
  return static_cast<int>((x + to - 1) / to * to);
}

}  // namespace ells
