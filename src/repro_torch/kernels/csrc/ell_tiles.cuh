// Device helpers shared by the two blocked-ELL designs of the port:
// ell_stream.cuh (K1 ell_mv, K6 ell_mm) and ell_hvp_stream.cuh (K2
// ell_hvp, K7 ell_hvp_mm). Both stream a layout's live tiles into a ring
// of shared memory by 1-D bulk copies (no tensor map), one mbarrier a
// stage, and take each tile as 16 warps x kRowsPerWarp rows, lanes over
// the tile's row with 16-byte reads.
#pragma once

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

// vecT[j * bc + b] = c[b] * V[b * ldv + j] (c = 1 when null): the piece's
// block of c .* V, s-major, from the stage's copy or from device memory.
template <int S>
__device__ __forceinline__ void stage_vec(float* __restrict__ vecT,
                                          const float* vsrc, long long ldv,
                                          const float* csrc, int bc) {
  for (int e = threadIdx.x; e < bc * S; e += kThreads) {
    const int b = e / S;
    const int j = e - b * S;
    const float x = vsrc[b * ldv + j];
    vecT[j * bc + b] = csrc ? csrc[b] * x : x;
  }
}

// acc[k][j] += sum_b tile[r_k, b] * vecT[j, b] for the rows r_k = warp + k *
// kWarps < rows. VEC4: tile in shared memory, 16-byte reads (bc % 4 == 0);
// else the tile in device memory, one float a lane.
template <int S, bool VEC4>
__device__ __forceinline__ void dot_rows(const float* __restrict__ tile,
                                         const float* __restrict__ vecT,
                                         float (&acc)[kRowsPerWarp][S],
                                         int rows, int bc, int lane,
                                         int warp) {
  if (VEC4) {
    const int nq = bc >> 2;
    const float4* t4 = reinterpret_cast<const float4*>(tile);
    const float4* v4 = reinterpret_cast<const float4*>(vecT);
    for (int q = lane; q < nq; q += 32) {
      float4 v[S];
#pragma unroll
      for (int j = 0; j < S; ++j) v[j] = v4[j * nq + q];
#pragma unroll
      for (int k = 0; k < kRowsPerWarp; ++k) {
        const int r = warp + k * kWarps;
        if (r < rows) {
          const float4 x = t4[r * nq + q];
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
          const float x = __ldg(tile + static_cast<size_t>(r) * bc + b);
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

inline int round_up(size_t x, int to) {
  return static_cast<int>((x + to - 1) / to * to);
}

}  // namespace ells
