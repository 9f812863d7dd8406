// The fused blocked-ELL Hessian-vector product Y = A (c .* (A^T U)) over
// S = 1..kern::kMaxCols columns, from the transposed layout alone, as one
// cooperative persistent grid that walks the layout in steps: pass A of a
// step reads the step's tiles from device memory, pass B reads them again
// while they sit in L2. ell_hvp.cu (K2, S = 1) and ell_hvp_mm.cu (K7) are
// its entry points for f32 tiles, ell_hvp_bf16.cu and ell_hvp_mm_bf16.cu
// for bf16 tiles; nothing else in them differs.
//
// Layout, named by its own axes: data (nb, W, R, C) tiles of A^T of type T
// (float or __nv_bfloat16; R is A's column-block width, C its row-block
// height), cols (nb, W) int32
// row-block ids of A, U (ncb * C, S) f32 row-major with row stride
// ldu >= S, c (nb * R,) f32 or null, Y (ncb * C, S) f32 row-major, zeroed
// by the caller. Live slots as in ell_stream.cuh: a row-block's slots up
// to its last nonzero tile; the padding past them is never read.
//
// The schedule (kernels/sparse_hvp.py ell_hvp_schedule, built once per
// layout) gives prefix (nb + 1,), the prefix sums of the live counts, and
// per step i (a run of whole row-blocks whose tiles fit in a share of the
// L2) bounds[i] (ctas + 1,): the CTAs' ranges of the step's live tiles,
// sizes differing by at most one. Its state: count (nb,), the arrival
// counters, zero between calls, and ready (nb,), the ready flags, each the
// epoch of the call that last wrote the row-block's c .* z.
//
// Rounding with bf16 tiles, where the TPU kernel rounds: U is rounded to
// bf16 where pass A stages it (`u.astype(dataT.dtype)`), and c .* z where
// it is written to cz (`(c * z).astype(xT.dtype)`), in pass A or by the sum
// of the partials; every product is then of two bf16 values, exact in f32,
// summed in f32. At f32 tiles both roundings are the identity.
//
// Design.
// - Phases: CTA k walks A(0), A(1), B(0), A(2), B(1), ..., A(n-1),
//   B(n-2), B(n-1), where A(i) and B(i) are the two passes over its range
//   [bounds[i][k], bounds[i][k+1]) of step i. Pass A of the next step lies
//   between the two passes of each, so the hand-off of a step hides behind
//   the next step's reads, and at most two steps' tiles must stay in L2.
//   The same CTA reads the same tiles in both passes.
// - Pass A: per row-block j of the range, z_j = sum_k tile_k U[cols[j,k]]
//   (R x S), the walk of ell_stream.cuh: chunks of 128 rows, 16 warps x 8
//   rows, lanes over C with 16-byte reads, 8 S sums a lane, the U block
//   staged s-major (at S = 1 on a contiguous u and f32 tiles it is read
//   where it landed). A row-block wholly in the range: c_j .* z_j goes to cz, and
//   its ready flag is released. A row-block cut by the range: its partial
//   z goes to scratch (4 sets by step, ctas, 2 slots, R, S; slot 0 if it
//   holds the range's first tile, else 1), and the CTA adds its tile count
//   to the row-block's counter (release, device scope) without waiting for
//   the reply. Pass A waits for nothing but its copies.
// - Pass B: per row-block of the range, thread 0 waits (acquire) for its
//   ready flag. If the row-block was cut and its counter shows every tile
//   arrived, the first CTA to claim it (compare-and-swap to -1) sums the
//   partials instead: it copies the step's CTA ranges into shared memory
//   (one round trip, not a binary search through device memory), sums
//   the partials in CTA order, scales by c_j, writes cz_j, resets the
//   counter and releases the flag. z and cz repeat bit for bit. (Summing
//   in pass A by the last CTA to arrive, the step's slowest, kept that
//   CTA the slowest and doubled pass A's time.) Then the threads copy
//   cz_j into shared memory, and per tile G =
//   512 / C row groups (1 if C >= 512) take the tile's column sums
//   cz_j^T tile (C x S); the groups' sums are added in order in shared
//   memory and scattered into Y's block of the tile's row-block id by f32
//   reductions (atomicAdd, four floats at a time where Y's block allows).
//   Row-blocks of one step, and neighbouring steps on other CTAs, add into
//   the same Y blocks, so Y repeats only to f32 rounding.
// - The ring: thread 0 issues, in walk order, one 1-D bulk copy per piece
//   (a chunk of at most 128 tile rows; in pass A also the (C, ldu) span of
//   U the tile multiplies) into 2-4 stages, each with one mbarrier. It
//   issues past pass B's waits: while thread 0 waits for a flag, the next
//   pieces are in flight. Piece n lives in stage n % stages, parity
//   (n / stages) & 1, across both passes.
// - Direct path, for tiles a bulk copy cannot take (rows not a multiple of
//   16 bytes: C % 4 != 0 at f32, C % 8 != 0 at bf16; pointers not 16-byte
//   aligned, a U span past its storage, fewer than two stages fitting):
//   the same schedule, walk and hand-off, the tiles and U read from device
//   memory.
//
// Where trouble was likely, and how it is resolved.
// - Spinning on a flag deadlocks unless every CTA is resident: the grid
//   (ctas = SMs, one CTA an SM) is launched cooperative, so a grid the
//   card cannot hold at once is refused. A flag wait of more than about
//   ten seconds traps rather than hang the card.
// - No deadlock in the walk: pass A waits for nothing but its own copies,
//   so every CTA's arrivals at the row-blocks of step i happen, and every
//   contributor to a cut row-block waits for it in its B(i), so one of
//   them claims the sum once all have arrived: every wait ends.
// - Memory order: writers of cz and of partials finish before a CTA
//   barrier, and thread 0's release (or acq_rel) at device scope then
//   publishes them; a reader's thread 0 acquires before a CTA barrier, and
//   the data written by other CTAs is read through L2 (__ldcg), never
//   from a possibly stale L1 line.
// - Scratch reuse: a CTA's partials of step i are summed before its B(i)
//   passes its waits (they cover every row-block it cut in step i). Its
//   next partials in the same set are those of step i + 4, written in
//   A(i + 4), which comes after its B(i + 3 - kLag): for kLag <= 3, after
//   B(i). The counter reads -1 while claimed and 0 again after the sum.
// - Counters reset by the CTA that summed; flags carry the call's epoch,
//   so one launch a call and no memset.
//
// Bound: device-memory bytes. Each live tile element (4 or 2 bytes) is
// read once from device memory and used in 4 S flops (at S <= 8, below the
// card's flops-per-byte balance); the second read is meant to hit L2.
#pragma once

#include <cuda/atomic>

#include "ell_tiles.cuh"

namespace ellh {

using ells::kBarrierBytes;
using ells::kMaxStages;
using ells::kRows;
using ells::kRowsPerWarp;
using ells::kThreads;
using ells::kWarps;
using DeviceInt = cuda::atomic_ref<int, cuda::thread_scope_device>;

constexpr int kLag = 1;             // steps pass A runs ahead of pass B
constexpr int kClaimOff = 64;       // the sum's claim, in the barrier bytes
// scratch sets, taken by step % kScratchSets (SCRATCH_SETS in
// kernels/sparse_hvp.py, which allocates them)
constexpr int kScratchSets = 4;
static_assert(kLag + 1 <= kScratchSets, "scratch reused too early");

struct Params {
  const void* data;      // tiles of the entry point's type T
  const int* cols;
  const int* prefix;     // (nb + 1,) live-tile prefix sums
  const int* bounds;     // (steps, ctas + 1) CTA ranges of each step
  int* count;            // (nb,) arrival counters, in tiles
  int* ready;            // (nb,) ready flags (epochs)
  int epoch;
  const float* U;
  long long ldu;
  const float* c;        // or null
  float* Y;
  float* cz;             // (nb, R, S) c .* z of every row-block
  float* scratch;        // (4, ctas, 2, R, S) partial z of cut row-blocks
  int nb, W, R, C, ncb, ctas, steps;
  int groups;            // row groups of pass B's column sums
  int stages;            // ring stages (bulk path)
  int stage_bytes;       // bytes of one stage: tile chunk, U span
  int u_off, u_bytes;    // offset and bytes of the U span in a stage
  int vec_off, czs_off, red_off, bnd_off, ring_off;   // shared memory
  int sched_off;         // the CTA's ranges and the prefix sums (0: none)
};

// Where a CTA reads its schedule: its range in step i is
// [ranges[i * stride], ranges[i * stride + 1]); prefix as in Params. In
// shared memory when it fits, else in device memory.
struct Sched {
  const int* ranges;
  int stride;
  const int* prefix;
};

// Phase ph of 2 * steps: pass A (true) or B of *step, with pass A running
// L = min(kLag, steps) steps ahead of pass B: A(0), ..., A(L - 1), then
// A(L), B(0), A(L + 1), B(1), ..., then the last L passes B. At kLag = 1:
// A(0), A(1), B(0), A(2), B(1), ..., B(steps - 1).
__device__ __forceinline__ bool phase(int ph, int steps, int* step) {
  const int lag = min(kLag, steps);
  if (ph < lag) { *step = ph; return true; }
  const int r = ph - lag, paired = 2 * (steps - lag);
  if (r >= paired) { *step = r - steps + lag; return false; }
  *step = (r & 1) ? r >> 1 : (r >> 1) + lag;
  return !(r & 1);
}

__device__ __forceinline__ const int* step_bounds(const Params& p, int step) {
  return p.bounds + static_cast<size_t>(step) * (p.ctas + 1);
}

// The column-block id (a row-block of Y) of slot `slot` of row-block i;
// traps on a slot past W or an id out of range (a corrupt layout or
// schedule).
__device__ __forceinline__ int col_of(const Params& p, int i, int slot) {
  if (slot >= p.W) __trap();
  const int cb = p.cols[static_cast<size_t>(i) * p.W + slot];
  if (cb < 0 || cb >= p.ncb) __trap();
  return cb;
}

template <class T>
__device__ __forceinline__ const T* tile_rows(const Params& p, int i,
                                              int slot, int chunk) {
  return static_cast<const T*>(p.data) +
         ((static_cast<size_t>(i) * p.W + slot) * p.R +
          static_cast<size_t>(chunk) * kRows) * p.C;
}

// Thread 0's position in the CTA's walk: phase, its pass, step and range;
// row-block i (first live tile base, segment [ts, te) in the range), row
// chunk and tile t. The consumer's loops walk the same order.
struct Walker {
  int ph, step, b0, b1, i, base, ts, te, chunk, t;
  bool pass_a, valid;
};

// From w.i + 1 on, the next row-block with live tiles in [b0, b1).
__device__ __forceinline__ bool next_segment(Walker& w, const Params& p,
                                             const Sched& sc) {
  for (++w.i; w.i < p.nb; ++w.i) {
    const int base = sc.prefix[w.i], end = sc.prefix[w.i + 1];
    if (base >= w.b1) return false;
    if (end > base) {
      w.base = w.ts = w.t = base;
      w.te = min(end, w.b1);
      w.chunk = 0;
      return true;
    }
  }
  return false;
}

// From w.ph on, the first phase whose range holds a tile, at its first
// piece; invalid past the last phase.
__device__ __forceinline__ void first_piece(Walker& w, const Params& p,
                                            const Sched& sc) {
  for (; w.ph < 2 * p.steps; ++w.ph) {
    w.pass_a = phase(w.ph, p.steps, &w.step);
    w.b0 = sc.ranges[w.step * sc.stride];
    w.b1 = sc.ranges[w.step * sc.stride + 1];
    if (w.b0 < w.b1) {
      w.i = ells::last_at_most(sc.prefix, p.nb, w.b0);  // holds tile b0
      w.base = sc.prefix[w.i];
      w.ts = w.t = w.b0;
      w.te = min(sc.prefix[w.i + 1], w.b1);
      w.chunk = 0;
      w.valid = true;
      return;
    }
  }
  w.valid = false;
}

__device__ __forceinline__ void advance(Walker& w, const Params& p,
                                        const Sched& sc, int nchunks) {
  if (++w.t < w.te) return;
  if (++w.chunk < nchunks) {
    w.t = w.ts;
    return;
  }
  if (next_segment(w, p, sc)) return;
  ++w.ph;
  first_piece(w, p, sc);
}

// Thread 0: the bulk copies of the walker's piece into `stage`: the tile
// chunk, and in pass A the U span it multiplies.
template <class T>
__device__ __forceinline__ void issue(const Walker& w, const Params& p,
                                      unsigned char* stage, uint64_t* bar) {
  const int slot = w.t - w.base;
  const int cb = col_of(p, w.i, slot);
  const uint32_t tile_bytes = static_cast<uint32_t>(
      min(kRows, p.R - w.chunk * kRows)) * p.C * sizeof(T);
  const T* tile = tile_rows<T>(p, w.i, slot, w.chunk);
  if (w.pass_a) {
    ells::mbar_expect_tx(bar, tile_bytes + p.u_bytes);
    ells::bulk_copy(stage, tile, tile_bytes, bar);
    ells::bulk_copy(stage + p.u_off,
                    p.U + static_cast<size_t>(cb) * p.C * p.ldu, p.u_bytes,
                    bar);
  } else {
    ells::mbar_expect_tx(bar, tile_bytes);
    ells::bulk_copy(stage, tile, tile_bytes, bar);
  }
}

// The ring and thread 0's walk, as the consumer loops see them.
struct Ring {
  uint64_t* full;
  unsigned char* base;
  Walker prod;
  Sched sc;
  int nchunks;

  // Piece n's tile rows: waited for in its stage (bulk), or in device
  // memory.
  template <class T, bool BULK>
  __device__ __forceinline__ const T* take(const Params& p, int n, int i,
                                           int slot, int chunk) {
    if (!BULK) return tile_rows<T>(p, i, slot, chunk);
    const int stage = n % p.stages;
    ells::mbar_wait(&full[stage], (n / p.stages) & 1);
    return reinterpret_cast<const T*>(
        base + static_cast<size_t>(stage) * p.stage_bytes);
  }

  // After a barrier that follows every thread's use of piece n: thread 0
  // refills its stage with the next piece of the walk.
  template <class T, bool BULK>
  __device__ __forceinline__ void refill(const Params& p, int n) {
    if (!BULK || threadIdx.x != 0 || !prod.valid) return;
    const int stage = n % p.stages;
    issue<T>(prod, p, base + static_cast<size_t>(stage) * p.stage_bytes,
             &full[stage]);
    advance(prod, p, sc, nchunks);
  }
};

__device__ __forceinline__ float4 operator+(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

template <class Vec>
__device__ __forceinline__ Vec zero_vec() {
  if constexpr (sizeof(Vec) == sizeof(float4)) return make_float4(0.f, 0.f, 0.f, 0.f);
  else return 0.f;
}

// cz_i = c_i .* (sum of the partials of CTAs k0..k1, empty ranges
// skipped; bnd: the step's CTA ranges, in shared memory), rounded to the
// tile type T. The partials
// (R x S floats each, in `part`) are read as Vec vectors through L2 by Q
// groups of threads, group q summing a run of contributors in CTA order
// with its loads issued together; the groups' sums are then added in
// group order in `buf` (4 kThreads floats). The order is fixed by the
// schedule, so cz repeats bit for bit.
template <class T, class Vec, int S>
__device__ __forceinline__ void fixup(const Params& p, float* buf,
                                      const float* part, const int* bnd,
                                      int k0, int k1, int base, int i) {
  constexpr int kV = sizeof(Vec) / sizeof(float);
  const size_t rs = static_cast<size_t>(p.R) * S;
  const int E = static_cast<int>(rs / kV);          // vectors of a partial
  const int K = k1 - k0 + 1;
  const int Q = max(1, min(kThreads / E, K));
  const int per = (K + Q - 1) / Q;
  float* cz = p.cz + i * rs;
  const float* c = p.c ? p.c + static_cast<size_t>(i) * p.R : nullptr;
  for (int t = threadIdx.x; t < E * Q; t += kThreads) {
    const int e = t % E, q = t / E;
    const int ka = k0 + q * per, kb = min(k1 + 1, ka + per);
    Vec sum = zero_vec<Vec>();
#pragma unroll 8
    for (int k = ka; k < kb; ++k) {
      const int lo = bnd[k];
      const Vec* src = reinterpret_cast<const Vec*>(
          part + (2 * static_cast<size_t>(k) + (base <= lo ? 0 : 1)) * rs) + e;
      sum = sum + (lo != bnd[k + 1] ? __ldcg(src) : zero_vec<Vec>());
    }
    if (Q > 1) {
      reinterpret_cast<Vec*>(buf)[q * E + e] = sum;
    } else {
      const float* v = reinterpret_cast<const float*>(&sum);
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        const int f = e * kV + j;
        cz[f] = ells::round_to<T>(c ? c[f / S] * v[j] : v[j]);
      }
    }
  }
  if (Q == 1) return;
  __syncthreads();                        // the groups' sums are in buf
  for (int e = threadIdx.x; e < E; e += kThreads) {
    Vec sum = reinterpret_cast<const Vec*>(buf)[e];
    for (int q = 1; q < Q; ++q) sum = sum + reinterpret_cast<const Vec*>(buf)[q * E + e];
    const float* v = reinterpret_cast<const float*>(&sum);
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const int f = e * kV + j;
      cz[f] = ells::round_to<T>(c ? c[f / S] * v[j] : v[j]);
    }
  }
}

// Pass A of one row-block segment [ts, te) of the range [b0, b1): z over
// the segment's tiles, to cz (scaled and rounded to T; the row-block lies
// wholly in the range, and its flag is released) or to the CTA's scratch
// slot (and its tile count added to the row-block's counter).
template <class T, int S, bool BULK>
__device__ __forceinline__ void pass_a(const Params& p, Ring& ring,
                                       float* vecT, int& n,
                                       int step, int b0, int b1, int i,
                                       int base, int end, int ts, int te,
                                       int lane, int warp) {
  const size_t rs = static_cast<size_t>(p.R) * S;
  const bool whole = base >= b0 && end <= b1;
  float* out = whole ? p.cz + i * rs
                     : p.scratch + ((static_cast<size_t>(step % kScratchSets) * p.ctas +
                                     blockIdx.x) * 2 + (base <= b0 ? 0 : 1)) *
                                       rs;
  for (int ch = 0; ch < ring.nchunks; ++ch) {
    const int rows = min(kRows, p.R - ch * kRows);
    float acc[kRowsPerWarp][S];
#pragma unroll
    for (int k = 0; k < kRowsPerWarp; ++k)
#pragma unroll
      for (int j = 0; j < S; ++j) acc[k][j] = 0.f;
    for (int t = ts; t < te; ++t, ++n) {
      const int slot = t - base;
      const T* tile = ring.take<T, BULK>(p, n, i, slot, ch);
      const float* vec = vecT;
      if (BULK) {
        const float* us = reinterpret_cast<const float*>(
            reinterpret_cast<const unsigned char*>(tile) + p.u_off);
        if (S == 1 && p.ldu == 1 && std::is_same_v<T, float>) {
          vec = us;                       // a contiguous u block, in place
        } else {
          ells::stage_vec<T, S>(vecT, us, p.ldu, nullptr, p.C);
          __syncthreads();                // vecT staged
        }
      } else {
        const int cb = col_of(p, i, slot);
        ells::stage_vec<T, S>(vecT,
                              p.U + static_cast<size_t>(cb) * p.C * p.ldu,
                              p.ldu, nullptr, p.C);
        __syncthreads();
      }
      ells::dot_rows<T, S, BULK>(tile, vec, acc, rows, p.C, lane, warp);
      __syncthreads();                    // the stage and vecT are free
      ring.refill<T, BULK>(p, n);
    }
#pragma unroll
    for (int k = 0; k < kRowsPerWarp; ++k) {
      const int r = warp + k * kWarps;
      const int row = ch * kRows + r;
#pragma unroll
      for (int j = 0; j < S; ++j) {
        if (r < rows) {                   // uniform over the warp
          const float sum = kern::warp_sum(acc[k][j]);
          if (lane == 0)
            out[static_cast<size_t>(row) * S + j] =
                !whole ? sum
                       : ells::round_to<T>(
                             p.c ? p.c[static_cast<size_t>(i) * p.R + row] * sum
                                 : sum);
        }
      }
    }
  }
  __syncthreads();                        // the segment's rows are written
  if (threadIdx.x == 0) {
    if (whole)
      DeviceInt(p.ready[i]).store(p.epoch, cuda::memory_order_release);
    else
      DeviceInt(p.count[i]).fetch_add(te - ts, cuda::memory_order_release);
  }
}

// red[(g * C + b) * S + j] = sum over the rows a = g, g + G, ... < rows of
// tile[a, b] * z[a, j]: row group g's column sums of one piece (tile in
// shared memory, or in device memory on the direct path).
template <class T, int S, bool SMEM>
__device__ __forceinline__ void column_sums(const T* __restrict__ tile,
                                            const float* __restrict__ z,
                                            float* __restrict__ red, int rows,
                                            int C, int G) {
  const int g = G > 1 ? threadIdx.x / C : 0;
  if (g >= G) return;
  const int b0 = G > 1 ? threadIdx.x - g * C : threadIdx.x;
  const int bstep = G > 1 ? C : kThreads;
  for (int b = b0; b < C; b += bstep) {
    float acc[S];
#pragma unroll
    for (int j = 0; j < S; ++j) acc[j] = 0.f;
#pragma unroll 4
    for (int a = g; a < rows; a += G) {
      const float x = SMEM ? ells::widen(tile[a * C + b])
                           : ells::ldg_elem(tile + static_cast<size_t>(a) * C + b);
      const float* za = z + a * S;
#pragma unroll
      for (int j = 0; j < S; ++j) acc[j] += x * za[j];
    }
    float* dst = red + (static_cast<size_t>(g) * C + b) * S;
#pragma unroll
    for (int j = 0; j < S; ++j) dst[j] = acc[j];
  }
}

// y[e] += sum over the groups of red[g * len + e], e < len = C * S: one
// piece's contribution to its Y block, by f32 reductions in device memory.
__device__ __forceinline__ void scatter(const float* __restrict__ red,
                                        float* y, int len, int G) {
  if ((len & 3) == 0 && (reinterpret_cast<uintptr_t>(y) & 15) == 0) {
    const float4* r4 = reinterpret_cast<const float4*>(red);
    const int len4 = len >> 2;
    for (int e = threadIdx.x; e < len4; e += kThreads) {
      float4 s = r4[e];
      for (int g = 1; g < G; ++g) {
        const float4 x = r4[g * len4 + e];
        s.x += x.x;
        s.y += x.y;
        s.z += x.z;
        s.w += x.w;
      }
      atomicAdd(reinterpret_cast<float4*>(y) + e, s);
    }
  } else {
    for (int e = threadIdx.x; e < len; e += kThreads) {
      float s = red[e];
      for (int g = 1; g < G; ++g) s += red[g * len + e];
      atomicAdd(y + e, s);
    }
  }
}

// The sum of row-block i's partials (its CTAs' ranges of step `step` cut
// it): the step's CTA ranges, once, into shared memory; then the partials
// of CTAs k0..k1 (the ranges holding the row-block's first and last live
// tile), in CTA order, scaled and rounded into cz_i; then the counter is
// reset and the flag released.
template <class T, int S>
__device__ __forceinline__ void sum_partials(const Params& p, float* red,
                                             int* bnd_s, int step, int i,
                                             int base, int end) {
  const size_t rs = static_cast<size_t>(p.R) * S;
  const int* bnd = step_bounds(p, step);
  for (int q = threadIdx.x; q <= p.ctas; q += kThreads) bnd_s[q] = bnd[q];
  __syncthreads();
  const int k0 = ells::last_at_most(bnd_s, p.ctas, base);
  const int k1 = ells::last_at_most(bnd_s, p.ctas, end - 1);
  const float* part = p.scratch + static_cast<size_t>(step % kScratchSets) * p.ctas * 2 * rs;
  if (rs % 4 == 0)
    fixup<T, float4, S>(p, red, part, bnd_s, k0, k1, base, i);
  else
    fixup<T, float, S>(p, red, part, bnd_s, k0, k1, base, i);
  __syncthreads();                        // cz_i is written
  if (threadIdx.x == 0) {
    DeviceInt(p.count[i]).store(0, cuda::memory_order_relaxed);
    DeviceInt(p.ready[i]).store(p.epoch, cuda::memory_order_release);
  }
}

// Pass B of one row-block segment: wait for cz_i, or sum the partials
// into it if every partial has arrived and no CTA has claimed the sum yet;
// then per piece the column sums and their scatter into Y.
template <class T, int S, bool BULK>
__device__ __forceinline__ void pass_b(const Params& p, Ring& ring,
                                       float* czs, float* red, int* bnd_s,
                                       int* claim, int& n, int step, int i,
                                       int base, int end, int ts, int te) {
  const size_t rs = static_cast<size_t>(p.R) * S;
  if (threadIdx.x == 0) {
    DeviceInt flag(p.ready[i]), count(p.count[i]);
    const int live = end - base;
    long long start = 0;
    *claim = 0;
    while (flag.load(cuda::memory_order_acquire) != p.epoch) {
      int arrived = live;
      if (count.load(cuda::memory_order_relaxed) == live &&
          count.compare_exchange_strong(arrived, -1,
                                        cuda::memory_order_acq_rel)) {
        *claim = 1;                       // every partial is in: sum them
        break;
      }
      if (start == 0) start = clock64();
      else if (clock64() - start > (1ll << 34)) __trap();
      __nanosleep(32);
    }
  }
  __syncthreads();
  if (*claim) sum_partials<T, S>(p, red, bnd_s, step, i, base, end);
  for (int e = threadIdx.x; e < static_cast<int>(rs); e += kThreads)
    czs[e] = __ldcg(p.cz + i * rs + e);
  __syncthreads();                        // cz_i staged
  for (int ch = 0; ch < ring.nchunks; ++ch) {
    const int rows = min(kRows, p.R - ch * kRows);
    for (int t = ts; t < te; ++t, ++n) {
      const int slot = t - base;
      const int cb = col_of(p, i, slot);
      const T* tile = ring.take<T, BULK>(p, n, i, slot, ch);
      column_sums<T, S, BULK>(tile,
                              czs + static_cast<size_t>(ch) * kRows * S, red,
                              rows, p.C, p.groups);
      __syncthreads();                    // red written; the stage is free
      ring.refill<T, BULK>(p, n);
      scatter(red, p.Y + static_cast<size_t>(cb) * p.C * S, p.C * S,
              p.groups);
      __syncthreads();                    // red is free
    }
  }
}

template <class T, int S, bool BULK>
__global__ void __launch_bounds__(kThreads, 1) hvp_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  int* claim = reinterpret_cast<int*>(smem + kClaimOff);
  int* bnd_s = reinterpret_cast<int*>(smem + p.bnd_off);
  float* vecT = reinterpret_cast<float*>(smem + p.vec_off);
  float* czs = reinterpret_cast<float*>(smem + p.czs_off);
  float* red = reinterpret_cast<float*>(smem + p.red_off);
  const int k = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  Ring ring;
  ring.full = reinterpret_cast<uint64_t*>(smem);
  ring.base = smem + p.ring_off;
  ring.nchunks = (p.R + kRows - 1) / kRows;
  ring.prod.ph = 0;
  ring.prod.valid = false;
  ring.sc = Sched{p.bounds + k, p.ctas + 1, p.prefix};
  if (p.sched_off) {                      // the schedule, copied once
    int* ranges = reinterpret_cast<int*>(smem + p.sched_off);
    int* prefix = ranges + 2 * p.steps;
    for (int e = threadIdx.x; e < 2 * p.steps; e += kThreads)
      ranges[e] = p.bounds[static_cast<size_t>(e >> 1) * (p.ctas + 1) + k +
                           (e & 1)];
    for (int e = threadIdx.x; e <= p.nb; e += kThreads) prefix[e] = p.prefix[e];
    ring.sc = Sched{ranges, 2, prefix};
    __syncthreads();
  }
  if (BULK) {
    if (threadIdx.x == 0) {
      for (int st = 0; st < p.stages; ++st) ells::mbar_init(&ring.full[st], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      first_piece(ring.prod, p, ring.sc);
      for (int st = 0; st < p.stages && ring.prod.valid; ++st) {
        issue<T>(ring.prod, p,
                 ring.base + static_cast<size_t>(st) * p.stage_bytes,
                 &ring.full[st]);
        advance(ring.prod, p, ring.sc, ring.nchunks);
      }
    }
    __syncthreads();
  }

  int n = 0;                              // pieces taken
  for (int ph = 0; ph < 2 * p.steps; ++ph) {
    int step;
    const bool a = phase(ph, p.steps, &step);
    const Sched& sc = ring.sc;
    const int b0 = sc.ranges[step * sc.stride];
    const int b1 = sc.ranges[step * sc.stride + 1];
    if (b0 >= b1) continue;               // nothing of this step here
    for (int i = ells::last_at_most(sc.prefix, p.nb, b0); i < p.nb; ++i) {
      const int base = sc.prefix[i], end = sc.prefix[i + 1];
      if (base >= b1) break;
      if (end == base) continue;          // no live tile
      const int ts = max(base, b0), te = min(end, b1);
      if (a)
        pass_a<T, S, BULK>(p, ring, vecT, n, step, b0, b1, i, base, end, ts,
                           te, lane, warp);
      else
        pass_b<T, S, BULK>(p, ring, czs, red, bnd_s, claim, n, step, i, base,
                           end, ts, te);
    }
  }
}

// Plan the call (bulk path and ring, or direct path), launch the kernel
// cooperatively, and report the path. u_len: the floats readable from U on
// (the bulk path copies whole (C, ldu) spans of U). The stage count is the
// most stages of the tile type's piece that fit, up to kMaxStages.
template <class T, int S>
cudaError_t run(Params p, long long u_len, int* path, cudaStream_t stream) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  const size_t chunk_rows = min(kRows, p.R);
  const size_t tile_bytes = chunk_rows * p.C * sizeof(T);
  const size_t u_bytes = static_cast<size_t>(p.C) * p.ldu * sizeof(float);
  p.groups = max(1, kThreads / p.C);
  p.vec_off = kBarrierBytes;
  p.czs_off = p.vec_off + ells::round_up(static_cast<size_t>(S) * p.C * 4, 128);
  p.red_off = p.czs_off + ells::round_up(static_cast<size_t>(p.R) * S * 4, 128);
  // red: pass B's column sums, and the fix-up's group sums
  p.bnd_off = p.red_off +
              ells::round_up(max(static_cast<size_t>(p.groups) * p.C * S,
                                 static_cast<size_t>(4 * kThreads)) * 4, 128);
  // bnd: the fix-up's copy of the step's CTA ranges (ctas + 1)
  p.ring_off = p.bnd_off + ells::round_up(static_cast<size_t>(p.ctas + 1) * 4, 128);
  const size_t stage_bytes = ells::round_up(tile_bytes + u_bytes, 128);
  const long long fit = (static_cast<long long>(optin) - p.ring_off) /
                        static_cast<long long>(stage_bytes);
  const bool bulk = ells::bulk_rows<T>(p.C) && ells::aligned16(p.data) &&
                    ells::aligned16(p.U) &&
                    static_cast<long long>(p.ncb) * p.C * p.ldu <= u_len &&
                    fit >= 2;
  p.stages = bulk ? static_cast<int>(min(fit, static_cast<long long>(kMaxStages))) : 1;
  p.stage_bytes = static_cast<int>(stage_bytes);
  p.u_bytes = static_cast<int>(u_bytes);
  p.u_off = static_cast<int>(tile_bytes);
  size_t smem = bulk ? p.ring_off + p.stages * stage_bytes
                     : static_cast<size_t>(p.ring_off);
  if (smem > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  // the CTA's ranges (steps, 2) and the prefix sums (nb + 1), if they fit
  const size_t sched_bytes = (2 * static_cast<size_t>(p.steps) + p.nb + 1) * 4;
  p.sched_off = 0;
  if (smem + sched_bytes <= static_cast<size_t>(optin)) {
    p.sched_off = static_cast<int>(smem);
    smem += sched_bytes;
  }
  auto kernel = bulk ? hvp_kernel<T, S, true> : hvp_kernel<T, S, false>;
  err = kern::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(p.ctas), dim3(kThreads), args, smem,
                                    stream);
  const cudaError_t last = cudaGetLastError();   // cleared even on a refusal
  if (err == cudaSuccess) err = last;
  if (err == cudaSuccess && path) *path = bulk ? ells::kBulk : ells::kDirect;
  return err;
}

// The arguments both entry points check.
inline bool valid_args(const void* data, const int* cols, const int* sched,
                       int* state, int ctas, int steps, const float* U,
                       float* Y, float* cz, float* scratch, int nb, int W,
                       int R, int C, int ncb) {
  return data && cols && sched && state && U && Y && cz && scratch &&
         nb > 0 && W > 0 && R > 0 && C > 0 && ncb > 0 && ctas > 0 &&
         steps > 0;
}

// sched: [live (nb), prefix (nb + 1), first (steps + 1), bounds (steps *
// (ctas + 1))]; state: [count (nb), ready (nb)].
inline Params make_params(const void* data, const int* cols, const int* sched,
                          int* state, int ctas, int steps, int epoch,
                          const float* U, long long ldu, const float* c,
                          float* Y, float* cz, float* scratch, int nb, int W,
                          int R, int C, int ncb) {
  Params p{};
  p.data = data;
  p.cols = cols;
  p.prefix = sched + nb;
  p.bounds = sched + 2 * nb + 1 + steps + 1;
  p.count = state;
  p.ready = state + nb;
  p.epoch = epoch;
  p.U = U;
  p.ldu = ldu;
  p.c = c;
  p.Y = Y;
  p.cz = cz;
  p.scratch = scratch;
  p.nb = nb;
  p.W = W;
  p.R = R;
  p.C = C;
  p.ncb = ncb;
  p.ctas = ctas;
  p.steps = steps;
  return p;
}

// The body of the K2 entry points (ell_hvp.cu, ell_hvp_bf16.cu): launches
// the kernel, writes the path taken to *path (0 direct, 1 bulk copies),
// and returns a cudaError_t (0 = launched).
template <class T>
int hvp(const T* dataT, const int* colsT, const int* sched, int* state,
        int ctas, int steps, int epoch, const float* u, const float* c,
        float* y, float* cz, float* scratch, int ncb, int WT, int bc, int br,
        int nrb, int* path, void* stream) {
  if (!valid_args(dataT, colsT, sched, state, ctas, steps, u, y, cz, scratch,
                  ncb, WT, bc, br, nrb))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p = make_params(dataT, colsT, sched, state, ctas, steps, epoch,
                               u, 1, c, y, cz, scratch, ncb, WT, bc, br, nrb);
  return static_cast<int>(run<T, 1>(p, static_cast<long long>(nrb) * br,
                                    path, static_cast<cudaStream_t>(stream)));
}

// The body of the K7 entry points (ell_hvp_mm.cu, ell_hvp_mm_bf16.cu), one
// instance per s.
template <class T>
int hvp_mm(const T* dataT, const int* colsT, const int* sched, int* state,
           int ctas, int steps, int epoch, const float* U, long long ldu,
           long long u_len, const float* c, float* Y, float* cz,
           float* scratch, int ncb, int WT, int bc, int br, int nrb, int s,
           int* path, void* stream) {
  if (s <= 0 || s > kern::kMaxCols || ldu < s ||
      !valid_args(dataT, colsT, sched, state, ctas, steps, U, Y, cz, scratch,
                  ncb, WT, bc, br, nrb))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p = make_params(dataT, colsT, sched, state, ctas, steps, epoch,
                               U, ldu, c, Y, cz, scratch, ncb, WT, bc, br,
                               nrb);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (s) {
    case 1: err = run<T, 1>(p, u_len, path, st); break;
    case 2: err = run<T, 2>(p, u_len, path, st); break;
    case 3: err = run<T, 3>(p, u_len, path, st); break;
    case 4: err = run<T, 4>(p, u_len, path, st); break;
    case 5: err = run<T, 5>(p, u_len, path, st); break;
    case 6: err = run<T, 6>(p, u_len, path, st); break;
    case 7: err = run<T, 7>(p, u_len, path, st); break;
    default: err = run<T, 8>(p, u_len, path, st); break;
  }
  return static_cast<int>(err);
}

}  // namespace ellh

