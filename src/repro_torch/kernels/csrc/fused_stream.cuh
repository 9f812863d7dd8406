// The fused one-pass dense HVP  Y = X (c .* (X^T U))  for Hopper (sm_90a),
// over S = 1..kern::kMaxCols columns: a thread-block cluster shares each
// column panel of X, split by rows, and exchanges only the panel's partial
// X^T U through distributed shared memory. x_c_xt_u.cu (K5, S = 1) and
// x_c_xt_multi.cu (K10) are its entry points for f32 tiles,
// x_c_xt_u_bf16.cu and x_c_xt_multi_bf16.cu for bf16 tiles
// (DiscoConfig.hvp_dtype = 'bfloat16').
//
// Layout: X (d, n) of tile type T (float or __nv_bfloat16), row-major with
// row stride ld >= n elements (a DiSCO-S column view or a DiSCO-F row block
// is passed as a view, never copied); c (optional, n); U (d, S) f32
// row-major with row stride ldu >= S (K5: u, ldu = 1); scratch (clusters,
// d, S) f32; Y (d, S) f32 row-major; cz_out (optional, n x S f32, row-major)
// receives the hand-off c .* z as pass 2 uses it, for the checks (null on
// every solver path). Element offsets are 64-bit.
//
// bf16 tiles round where the TPU kernels round (repro/kernels/glm_hvp.py:
// `u.astype(X.dtype)` at entry, `cz = (c * z).astype(x.dtype)` between the
// passes): U is rounded to bf16 as it is staged into U's slice, and c .* z
// (z alone without c) after the cluster's rank-ordered sum of z. Every
// product is then of two bf16 values, exact in f32; the sums are f32, so
// only their order differs from the plain version's.
//
// The plan (kernels/glm_hvp.py fused_plan mirrors it on the host).
// - A cluster of Q CTAs (Q in 1, 2, 4, 8, one CTA an SM) walks column
//   panels of BN columns: rows of 128 or 64 bytes, so BN is 32 or 16 at
//   f32 and 64 or 32 at bf16. CTA rank q holds rows [q R, (q + 1) R) of
//   every panel, R = ceil(d / Q) rounded up to kRowQuantum; rows past d
//   read as zeros. At d = 4,096: Q = 8, R = 512, BN = 32 at f32 and 64 at
//   bf16, a 64 KB stage either way.
// - With C clusters and P = ceil(n / BN) panels, cluster k takes panels
//   [k P / C, (k + 1) P / C) (glm_hvp.fused_split): shares differ by at
//   most one panel, with no table. C is as many clusters as the card holds
//   at once (cudaOccupancyMaxActiveClusters), at most one per panel.
//
// Design.
// - A producer warp brings each CTA's R x BN slice of a panel in by 2-D
//   TMA copies of kBoxRows rows (the tensor map is over the X view: dims
//   {n, d}, row stride ld * sizeof(T) bytes; X evict-first in L2) into a ring of
//   2-4 stages with full and empty mbarriers. Rows and columns past the
//   view arrive as zeros, which covers a ragged last panel, d not a
//   multiple of Q, and ranks wholly past d.
// - 256 consumer threads; thread t takes the 16-byte column q = t % CT of
//   the panel (V = 16 / sizeof(T) elements: 4 at f32, 8 at bf16; CT = BN /
//   V threads a row) and the rows rt + RT j (rt = t / CT, RT = 256 / CT row
//   threads): a warp reads whole 128-byte rows (CT = 8), so no bank
//   conflicts. U's slice (R x S, f32) sits in shared memory for the CTA's
//   whole run; the partial Y of the thread's rows in registers.
// - Pass 1 of a panel: each thread's partial z over its rows (V columns x
//   S), summed over the warp's row threads by shuffles, then over the warps
//   in order through shared memory, into the CTA's exchange slot (E = BN S
//   partials: thread t sums partials t, t + 256, ..., E / 256 rounded up of
//   them; at bf16 E passes 256 from S = 5 on). Each warp then arrives
//   (release, cluster scope) on every peer's exchange barrier for that
//   slot.
// - Pass 2 (one panel later when the ring has three stages or more, so
//   that pass 1 of panel i + 1 runs while the peers' partials of panel i
//   arrive): wait (acquire) on the CTA's own exchange barrier, read the Q
//   slots through DSMEM in rank order 0..Q-1 (every CTA gets the same z,
//   summed in the same order), cz = c .* z (rounded to T), and dot each
//   of the thread's rows with cz from the same stage; the CT threads of a
//   row add their sums by a reduce-scatter of shuffles, which leaves each
//   lane the whole sum of one row. Rank 0 copies cz to cz_out when asked,
//   after the rows, not in the exchange loop (a store there took 11% of
//   K10's time at s = 5 on an H100 at 700 W, chip_fused_variants.py).
//   Then the warps release the stage.
// - After its last panel each CTA writes the partial Y of its rows to the
//   scratch row of its cluster; sum_rows (partials.cuh), launched right
//   after by the same entry point, adds the C partials in cluster order.
//   Every sum's order is fixed by (shape, Q, BN, C): no atomics, and the
//   result repeats bit for bit.
// - Direct path, for views a tensor map cannot take (a row stride that is
//   not a multiple of 16 bytes: ld % 4 != 0 at f32, ld % 8 != 0 at bf16; or
//   X not 16-byte aligned, such as a DiSCO-S column view at an odd offset):
//   the same plan, split and exchange, X read from device memory element by
//   element (at the alignment it has) by every consumer thread in both
//   passes, no producer warp.
//
// Where trouble was likely, and how it is resolved.
// - The exchange slots: a CTA publishes panel m's partial into slot
//   m % kSlots before it waits for panel m - 1's (lag 1). A peer reads the
//   slot of panel m' after its wait for m', and publishes m' + 2 only after
//   that; so when a CTA publishes m, every peer has read the slots of
//   panels up to m - 4, and four slots are never overwritten early
//   (tests/test_torch_fused_schedule.py walks the exchange on the host
//   over random interleavings of the CTAs; three slots fail). An exchange
//   barrier's phase for panel m + 4 cannot begin before its phase for m
//   has completed, for the same reason.
// - The ring's parity: panel m of a CTA lives in stage m % stages; its
//   full barrier's parity is (m / stages) & 1, and the producer's r-th
//   refill of a stage (r >= 1) waits on its empty barrier with parity
//   (r - 1) & 1. Pass 1 of panel m + 1 before pass 2 of panel m holds two
//   stages, so the lag is used only with three stages or more.
// - Shared buffers between passes: the warps' column partials are written
//   in pass 1 and cz in pass 2; one consumer barrier of each pass orders
//   every reuse, pass 1 of panels 0 and 1, back to back, have one more
//   between them, and so do the last panels' pass 2, back to back when
//   the lag is 1 (without it a warp could rewrite cz while a slower one
//   still reads the panel before, or copies it to cz_out).
// - Exit: a CTA must not exit while a peer may still read its slots, and
//   the exchange barriers must be initialised in every CTA before a peer
//   arrives on them: a cluster barrier of all threads at the start and at
//   the end.
//
// Bound: device-memory bytes (4 S flops per element of X, at S = 8 8 flops
// a byte at f32 and 16 at bf16, under the f32 rate of 67 TFLOP/s per 3.35
// TB/s). On an
// H100 SXM at 700 W (chip_fused_variants.py ablations, S = 1, full width):
// the copies alone take 1562 us of the kernel's 1696 (rows of 128 bytes
// 1 MiB apart stream at 2.75 TB/s; the bound is 1282 us), the exchange
// about 28 and the arithmetic about 110. Measured no faster: panels of 16
// columns, clusters of 4, the panels of a cluster taken in turn, 256-byte
// L2 promotion, an evict-normal policy, boxes of 64 or 128 rows, 512
// consumer threads, and the panel held in registers at S = 1 (the stage
// released after pass 1). The bf16 instances keep every choice in bytes
// (128-byte rows, 64 KB stages at d = 4,096) and take each thread's 16
// bytes as 8 columns, so a thread holds twice the partial sums of pass 1
// and the cz values of pass 2.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include "ell_tiles.cuh"
#include "partials.cuh"

namespace fused {

using ells::aligned16;
using ells::ldg_elem;
using ells::mbar_expect_tx;
using ells::mbar_init;
using ells::mbar_wait;
using ells::round_to;
using ells::round_up;
using ells::smem_u32;

constexpr int kThreads = 256;          // consumer threads (one producer warp
                                       // more on the TMA path)
constexpr int kWarps = kThreads / 32;
constexpr int kRowQuantum = 256;       // a CTA's rows R are a multiple
constexpr int kBoxRows = 256;          // rows of one TMA copy
constexpr int kSlots = 4;              // exchange slots (see the header)
constexpr int kMaxStages = 4;
constexpr int kBarrierBytes = 128;     // full, empty and exchange barriers
static_assert(kRowQuantum % kBoxRows == 0, "a stage is whole copies");

// Elements of X in one 16-byte read of a thread: 4 f32, 8 bf16.
template <class T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));

// The two panel widths of tile type T: rows of 128 or 64 bytes.
template <class T>
constexpr int kWide = 8 * kVec<T>;
template <class T>
constexpr int kNarrow = 4 * kVec<T>;

// Row groups (R / kRowQuantum) a CTA can hold at S columns: the partial Y
// of a thread's rows lives in registers, groups x S of them.
__host__ __device__ constexpr int max_groups(int S) {
  return S == 1 ? 6 : S <= 3 ? 5 : S <= 5 ? 4 : 3;
}

// Floats a row of U's slice takes in shared memory (vector loads).
__host__ __device__ constexpr int padded(int S) {
  return S <= 2 ? S : S <= 4 ? 4 : 8;
}

enum Path : int { kDirect = 0, kBulk = 1 };

// Returned when the tensor map cannot be encoded: kMapError + the CUresult;
// kNoCluster when the card cannot place one cluster of the plan.
constexpr int kMapError = 1000;
constexpr int kNoCluster = 2000;

template <class T>
struct Params {
  const T* X;
  long long ld;
  const float* c;        // or null
  const float* U;
  long long ldu;
  float* scratch;        // (clusters, d, S)
  float* cz_out;         // (n, S) or null
  int d, n;
  int q;                 // CTAs of a cluster
  int rows, groups;      // R and R / kRowQuantum
  int stages, lag;       // ring stages (TMA path); pass 2 one panel behind
  int clusters, panels;
  int slot_off, red_off, cz_off, us_off, ring_off;   // shared memory
};

// Shared memory of a CTA, in the order the kernel lays it out.
struct Layout {
  int slot_off, red_off, cz_off, us_off, ring_off, bytes;
};

inline Layout layout(int S, int bn, int rows, int stages, bool bulk,
                     int esize) {
  const int e = bn * S;
  Layout l;
  l.slot_off = kBarrierBytes;
  l.red_off = l.slot_off + round_up(static_cast<size_t>(kSlots) * e * 4, 128);
  l.cz_off = l.red_off + round_up(static_cast<size_t>(kWarps) * e * 4, 128);
  l.us_off = l.cz_off + round_up(static_cast<size_t>(e) * 4, 128);
  l.ring_off = l.us_off +
               round_up(static_cast<size_t>(rows) * padded(S) * 4, 128);
  l.bytes = l.ring_off +
            (bulk ? stages * rows * bn * esize : 0);
  return l;
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_id() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}

// A barrier of every thread of the cluster (release, then acquire).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The address of the same shared variable in the CTA of rank `rank`.
__device__ __forceinline__ uint32_t peer_addr(const void* p, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(smem_u32(p)), "r"(rank));
  return out;
}

// Arrive once on the mbarrier `bar` of the CTA of rank `rank` (release at
// cluster scope: the arriving warp's earlier shared stores are visible to
// whoever acquires the completed phase).
__device__ __forceinline__ void arrive_on(uint64_t* bar, uint32_t rank) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n"
      :: "r"(peer_addr(bar, rank)) : "memory");
}

// Wait for the phase of the given parity of a barrier the cluster's CTAs
// arrive on (acquire at cluster scope). Traps after about ten seconds.
__device__ __forceinline__ void wait_cluster(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1ll << 34)) __trap();
  }
}

// A float of a peer CTA's shared memory (a DSMEM address from peer_addr).
__device__ __forceinline__ float ld_peer(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

// Arrive once on a barrier of this CTA (no transfer bytes).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// A barrier of the consumer threads alone (not the producer warp).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kThreads) : "memory");
}

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

// TMA: the box at (column c0, row c1) of the 2-D map into shared memory,
// completing `bar`'s expected bytes, with an L2 policy.
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map,
                                       uint64_t* bar, int c0, int c1,
                                       uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes.L2::cache_hint [%0], [%1, {%3, %4}], [%2], %5;\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "l"(policy)
      : "memory");
}

// The first panel of cluster k's range: k P / C.
template <class P>
__device__ __forceinline__ long long panel_bound(const P& p, int k) {
  return static_cast<long long>(k) * p.panels / p.clusters;
}

// The first column of the m-th panel of a cluster whose range starts at
// panel `first`.
template <class P>
__device__ __forceinline__ long long panel_col(const P& p, long long first,
                                               int m, int bn) {
  return (first + m) * bn;
}

// The elements of one 16-byte read as f32 (a bf16 value is the high half
// of its f32).
__device__ __forceinline__ void widen16(uint4 w, float (&x)[4]) {
  x[0] = __uint_as_float(w.x);
  x[1] = __uint_as_float(w.y);
  x[2] = __uint_as_float(w.z);
  x[3] = __uint_as_float(w.w);
}
__device__ __forceinline__ void widen16(uint4 w, float (&x)[8]) {
  const uint32_t h[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(h[i] << 16);
    x[2 * i + 1] = __uint_as_float(h[i] & 0xffff0000u);
  }
}

// Row r of the CTA's slice, columns col .. col + V - 1 of the panel as f32:
// from the stage (TMA path, one 16-byte read) or from device memory (direct
// path, element by element), zeros past the view.
template <class T, int BN, bool BULK>
__device__ __forceinline__ void load_x(const Params<T>& p, const T* tile,
                                       int r, int row0, long long col, int q,
                                       float (&x)[kVec<T>]) {
  constexpr int V = kVec<T>;
  if constexpr (BULK) {
    widen16(reinterpret_cast<const uint4*>(tile)[r * (BN / V) + q], x);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) x[e] = 0.f;
    const int gr = row0 + r;
    if (gr < p.d) {
      const T* src = p.X + static_cast<long long>(gr) * p.ld + col;
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (col + e < p.n) x[e] = ldg_elem(src + e);
    }
  }
}

// U's row r of the slice, S values, from shared memory.
template <int S>
__device__ __forceinline__ void load_u(const float* us, int r,
                                       float (&u)[S]) {
  constexpr int SP = padded(S);
  const float* src = us + r * SP;
  if constexpr (SP == 1) {
    u[0] = src[0];
  } else if constexpr (SP == 2) {
    const float2 a = *reinterpret_cast<const float2*>(src);
    u[0] = a.x;
    u[1] = a.y;
  } else {
    float b[SP];
#pragma unroll
    for (int h = 0; h < SP / 4; ++h) {
      const float4 a = reinterpret_cast<const float4*>(src)[h];
      b[4 * h] = a.x;
      b[4 * h + 1] = a.y;
      b[4 * h + 2] = a.z;
      b[4 * h + 3] = a.w;
    }
#pragma unroll
    for (int k = 0; k < S; ++k) u[k] = b[k];
  }
}

// Reduce-scatter of v (a row's CT lanes' sums for CT rows) over the lanes
// q = 0..CT-1 that differ in their low bits: each step halves the rows a
// lane holds, so lane q is left with the whole sum of row q in v[0].
template <int HALF, int CT, int S>
__device__ __forceinline__ void scatter(float (&v)[CT][S], int q) {
  if constexpr (HALF >= 1) {
    const bool up = (q & HALF) != 0;
#pragma unroll
    for (int i = 0; i < HALF; ++i)
#pragma unroll
      for (int k = 0; k < S; ++k) {
        const float keep = up ? v[i + HALF][k] : v[i][k];
        const float give = up ? v[i][k] : v[i + HALF][k];
        v[i][k] = keep + __shfl_xor_sync(0xffffffffu, give, HALF);
      }
    scatter<HALF / 2>(v, q);
  }
}

template <class T, int S, int BN, bool BULK>
__global__ void __launch_bounds__(kThreads + 32, 1)
    fused_kernel(const __grid_constant__ CUtensorMap map, const Params<T> p) {
  constexpr int V = kVec<T>;            // columns of a thread's read
  constexpr int CT = BN / V;            // threads of a row
  constexpr int RW = 32 / CT;           // rows of a warp
  constexpr int RT = kThreads / CT;     // row threads
  constexpr int E = BN * S;             // partials of a panel
  constexpr int PER = (E + kThreads - 1) / kThreads;   // of them a thread
  constexpr int G = max_groups(S);
  static_assert(RT * CT == kRowQuantum, "a row group is every thread's row");
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  uint64_t* xfull = empty + kMaxStages;
  float* slots = reinterpret_cast<float*>(smem + p.slot_off);
  float* red = reinterpret_cast<float*>(smem + p.red_off);
  float* cz = reinterpret_cast<float*>(smem + p.cz_off);
  float* us = reinterpret_cast<float*>(smem + p.us_off);
  T* ring = reinterpret_cast<T*>(smem + p.ring_off);

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int rank = static_cast<int>(cluster_rank());
  const int cl = static_cast<int>(cluster_id());
  const int row0 = rank * p.rows;
  const long long first = panel_bound(p, cl);
  const int np = static_cast<int>(panel_bound(p, cl + 1) - first);
  const int stage_elems = p.rows * BN;

  if (t == 0) {
    if (BULK) {
      for (int st = 0; st < p.stages; ++st) {
        mbar_init(&full[st], 1);
        mbar_init(&empty[st], kWarps);
      }
    }
    for (int sl = 0; sl < kSlots; ++sl) mbar_init(&xfull[sl], p.q * kWarps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // U's slice rounded to T (as the TPU kernel's U.astype(X.dtype)), zeros
  // past d and past S
  constexpr int SP = padded(S);
  for (int i = t; i < p.rows * SP; i += blockDim.x) {
    const int r = i / SP, k = i - r * SP;
    const int gr = row0 + r;
    us[i] = k < S && gr < p.d
                ? round_to<T>(
                      __ldg(p.U + static_cast<long long>(gr) * p.ldu + k))
                : 0.f;
  }
  cluster_sync();

  if (BULK && warp == kWarps) {           // the producer warp
    if (lane == 0) {
      const uint64_t policy = evict_first_policy();
      const uint32_t bytes =
          static_cast<uint32_t>(stage_elems) * static_cast<uint32_t>(sizeof(T));
      int st = 0, round = 0;
      for (int m = 0; m < np; ++m) {
        if (round > 0) mbar_wait(&empty[st], (round - 1) & 1);
        mbar_expect_tx(&full[st], bytes);
        T* dst = ring + static_cast<size_t>(st) * stage_elems;
        const int col = static_cast<int>(panel_col(p, first, m, BN));
        for (int h = 0; h < p.rows / kBoxRows; ++h)
          tma_2d(dst + h * kBoxRows * BN, &map, &full[st], col,
                 row0 + h * kBoxRows, policy);
        if (++st == p.stages) {
          st = 0;
          ++round;
        }
      }
    }
    __syncwarp();
  } else if (t < kThreads) {              // the consumers
    const int q = lane % CT;
    const int rt = warp * RW + lane / CT;
    const int rpt = p.groups * CT;         // rows of a thread
    float y[G][S];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int k = 0; k < S; ++k) y[g][k] = 0.f;

    // the CTA's partial z of panel m into slot m % kSlots; publish it
    auto publish = [&](int m, float (&acc)[V][S]) {
      // over the warp's row threads (lanes of the same q), then the warps
#pragma unroll
      for (int e = 0; e < V; ++e)
#pragma unroll
        for (int k = 0; k < S; ++k)
#pragma unroll
          for (int off = 16; off >= CT; off >>= 1)
            acc[e][k] += __shfl_down_sync(0xffffffffu, acc[e][k], off);
      if (lane < CT) {
#pragma unroll
        for (int e = 0; e < V; ++e)
#pragma unroll
          for (int k = 0; k < S; ++k)
            red[warp * E + (V * q + e) * S + k] = acc[e][k];
      }
      consumers_sync();
      const int sl = m % kSlots;
#pragma unroll
      for (int h = 0; h < PER; ++h) {
        const int i = t + h * kThreads;
        if (i < E) {
          float s = 0.f;
          for (int w = 0; w < kWarps; ++w) s += red[w * E + i];
          slots[sl * E + i] = s;
        }
      }
      __syncwarp();
      if (lane < p.q) arrive_on(&xfull[sl], lane);
    };

    // pass 1 of panel m: partial z over the thread's rows
    auto pass1 = [&](int m) {
      const int st = m % p.stages;
      if (BULK) mbar_wait(&full[st], (m / p.stages) & 1);
      const T* tile = ring + static_cast<size_t>(st) * stage_elems;
      const long long col = panel_col(p, first, m, BN) + V * q;
      float acc[V][S];
#pragma unroll
      for (int e = 0; e < V; ++e)
#pragma unroll
        for (int k = 0; k < S; ++k) acc[e][k] = 0.f;
#pragma unroll 4
      for (int j = 0; j < rpt; ++j) {
        const int r = rt + RT * j;
        float x[V];
        load_x<T, BN, BULK>(p, tile, r, row0, col, q, x);
        float u[S];
        load_u<S>(us, r, u);
#pragma unroll
        for (int e = 0; e < V; ++e)
#pragma unroll
          for (int k = 0; k < S; ++k) acc[e][k] += x[e] * u[k];
      }
      publish(m, acc);
    };

    // pass 2 of panel m: z from the cluster's slots, cz rounded to T (as
    // the TPU kernel's (c * z).astype(x.dtype)), Y += X cz
    auto pass2 = [&](int m) {
      const int st = m % p.stages;
      const int sl = m % kSlots;
#pragma unroll
      for (int h = 0; h < PER; ++h) {
        const int i = t + h * kThreads;
        if (i < E) {
          if (h == 0) wait_cluster(&xfull[sl], (m / kSlots) & 1);
          const float* mine = slots + sl * E + i;
          float part[8];
#pragma unroll
          for (int r = 0; r < 8; ++r)
            part[r] = r < p.q ? ld_peer(peer_addr(mine, r)) : 0.f;
          float z = part[0];
#pragma unroll
          for (int r = 1; r < 8; ++r)
            if (r < p.q) z += part[r];
          const long long j = panel_col(p, first, m, BN) + i / S;
          cz[i] = j < p.n ? round_to<T>(p.c ? __ldg(p.c + j) * z : z) : 0.f;
        }
      }
      consumers_sync();
      float w[V][S];
#pragma unroll
      for (int e = 0; e < V; ++e)
#pragma unroll
        for (int k = 0; k < S; ++k) w[e][k] = cz[(V * q + e) * S + k];
      const T* tile = ring + static_cast<size_t>(st) * stage_elems;
      const long long col = panel_col(p, first, m, BN) + V * q;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (g < p.groups) {
          float v[CT][S];
#pragma unroll
          for (int jj = 0; jj < CT; ++jj) {
            const int r = rt + RT * (g * CT + jj);
            float x[V];
            load_x<T, BN, BULK>(p, tile, r, row0, col, q, x);
#pragma unroll
            for (int k = 0; k < S; ++k) {
              float a = x[0] * w[0][k];
#pragma unroll
              for (int e = 1; e < V; ++e) a += x[e] * w[e][k];
              v[jj][k] = a;
            }
          }
          scatter<CT / 2>(v, q);
#pragma unroll
          for (int k = 0; k < S; ++k) y[g][k] += v[0][k];
        }
      }
      // the hand-off for the checks, from rank 0 (cz is rewritten only
      // after the next pass 1's consumer barrier)
      if (__builtin_expect(p.cz_out != nullptr && rank == 0, 0)) {
        const long long c0 = panel_col(p, first, m, BN) * S;
        for (int i = t; i < E; i += kThreads)
          if (c0 + i < static_cast<long long>(p.n) * S)
            p.cz_out[c0 + i] = cz[i];
      }
      if (BULK) {                         // the warp is done with the stage
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[st]);
      }
    };

    if (np > 0) {
      pass1(0);
      if (p.lag && np > 1) {
        consumers_sync();                 // red is read again by pass 1
        pass1(1);
      }
      for (int m = 0; m < np; ++m) {
        pass2(m);
        if (m + 1 + p.lag < np) pass1(m + 1 + p.lag);
        else if (m + 1 < np) consumers_sync();   // cz is read again
      }
    }
    float* out = p.scratch + static_cast<size_t>(cl) * p.d * S;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int gr = row0 + rt + RT * (g * CT + q);
      if (g < p.groups && gr < p.d) {
#pragma unroll
        for (int k = 0; k < S; ++k)
          out[static_cast<size_t>(gr) * S + k] = y[g][k];
      }
    }
  }
  cluster_sync();                         // peers are done with the slots
}

// cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, so the library
// needs no -lcuda.
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(ptr);
  }
  return fn;
}

// The 2-D map {n, d} of the X view in boxes of bn columns by kBoxRows rows;
// elements past the view read as zeros.
template <class T>
CUresult encode_map(CUtensorMap* map, const T* X, long long ld, int d, int n,
                    int bn) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(d)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * sizeof(T)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(bn),
                             static_cast<cuuint32_t>(kBoxRows)};
  const cuuint32_t elem[2] = {1u, 1u};
  const CUtensorMapDataType type = sizeof(T) == 4
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return encode(map, type, 2, const_cast<T*>(X), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The clusters of one launch: as many as are resident at once (cached per
// kernel and shared memory), at most `cap`; 0 when none can be placed.
template <typename Kernel>
cudaError_t max_clusters(Kernel kernel, int q, int threads, int smem,
                         int cap, int* out) {
  struct Entry {
    const void* fn;
    int q, smem, clusters;
  };
  static Entry cache[64];
  static int used = 0;
  const void* fn = reinterpret_cast<const void*>(kernel);
  for (int i = 0; i < used; ++i)
    if (cache[i].fn == fn && cache[i].q == q && cache[i].smem == smem) {
      *out = min(cache[i].clusters, cap);
      return cudaSuccess;
    }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = q;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(q * cap);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
  if (err != cudaSuccess) return err;
  if (used < 64) cache[used++] = Entry{fn, q, smem, clusters};
  *out = min(clusters, cap);
  return cudaSuccess;
}

// One launch of the instance <T, S, BN, BULK> on C clusters (C =
// `clusters` when positive, else as many as fit, at most `cap` and one per
// panel), then the sum of the clusters' partials into Y. Reports C.
template <class T, int S, int BN, bool BULK>
int launch(const CUtensorMap& map, Params<T> p, float* Y, int clusters,
           int cap, int* used, cudaStream_t stream) {
  auto kernel = fused_kernel<T, S, BN, BULK>;
  const Layout l = layout(S, BN, p.rows, p.stages, BULK, sizeof(T));
  p.slot_off = l.slot_off;
  p.red_off = l.red_off;
  p.cz_off = l.cz_off;
  p.us_off = l.us_off;
  p.ring_off = l.ring_off;
  const int threads = BULK ? kThreads + 32 : kThreads;
  cudaError_t err = kern::allow_smem(kernel, l.bytes);
  if (err != cudaSuccess) return err;
  int C = clusters;
  if (C <= 0) {
    err = max_clusters(kernel, p.q, threads, l.bytes, cap, &C);
    if (err != cudaSuccess) return err;
    if (C <= 0) return kNoCluster;
    C = min(C, p.panels);
  }
  p.clusters = C;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.q;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(C * p.q);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = l.bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, map, p);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  *used = C;
  return kern::sum_rows(p.scratch, Y, C, p.d * S, stream);
}

template <class T, int S, bool BULK>
int launch_bn(int bn, const CUtensorMap& map, const Params<T>& p, float* Y,
              int clusters, int cap, int* used, cudaStream_t stream) {
  return bn == kWide<T>
             ? launch<T, S, kWide<T>, BULK>(map, p, Y, clusters, cap, used,
                                            stream)
             : launch<T, S, kNarrow<T>, BULK>(map, p, Y, clusters, cap, used,
                                              stream);
}

// Check a call's plan, encode the map (TMA path) and launch the instance
// for tile type T and S columns; write the path and the clusters used.
// bn is one of T's two panel widths (kWide, kNarrow). Returns a
// cudaError_t, kMapError + the CUresult, or kNoCluster.
template <class T, int S>
int run(const T* X, long long ld, const float* c, const float* U,
        long long ldu, float* Y, float* cz_out, float* scratch, int d, int n,
        int q, int bn, int stages, int clusters, int cap, int* path,
        int* used, cudaStream_t stream) {
  if (!X || !U || !Y || !scratch || !path || !used || d <= 0 || n <= 0 ||
      ld < n || ldu < S || cap <= 0 || clusters < 0 ||
      !(q == 1 || q == 2 || q == 4 || q == 8) ||
      !(bn == kWide<T> || bn == kNarrow<T>) || stages < 2 ||
      stages > kMaxStages)
    return cudaErrorInvalidValue;
  Params<T> p{};
  p.X = X;
  p.ld = ld;
  p.c = c;
  p.U = U;
  p.ldu = ldu;
  p.scratch = scratch;
  p.cz_out = cz_out;
  p.d = d;
  p.n = n;
  p.q = q;
  const int per_rank = (d + q - 1) / q;
  p.rows = (per_rank + kRowQuantum - 1) / kRowQuantum * kRowQuantum;
  p.groups = p.rows / kRowQuantum;
  p.stages = stages;
  p.lag = stages >= 3 ? 1 : 0;
  p.panels = static_cast<int>((static_cast<long long>(n) + bn - 1) / bn);
  if (p.groups > max_groups(S)) return cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  // the plan must fit the TMA path, whichever path runs
  if (layout(S, bn, p.rows, stages, true, sizeof(T)).bytes > optin)
    return cudaErrorInvalidValue;
  CUtensorMap map{};
  // a tensor map needs a row stride of whole 16-byte units and an aligned
  // base: ld a multiple of 4 at f32, 8 at bf16
  const bool bulk = (ld * static_cast<long long>(sizeof(T))) % 16 == 0 &&
                    aligned16(X);
  if (bulk) {
    const CUresult r = encode_map(&map, X, ld, d, n, bn);
    if (r != CUDA_SUCCESS) return kMapError + static_cast<int>(r);
  }
  const int rc =
      bulk ? launch_bn<T, S, true>(bn, map, p, Y, clusters, cap, used, stream)
           : launch_bn<T, S, false>(bn, map, p, Y, clusters, cap, used,
                                    stream);
  if (rc == 0) *path = bulk ? kBulk : kDirect;
  return rc;
}

}  // namespace fused
