// The dense one-vector products of the two-pass HVP as one persistent,
// balanced grid over tiles of a row-major X, fed by a ring of bulk copies.
// xt_u.cu (K3, z = X^T u) and x_cz.cu (K4, y = X (c .* z)) are its two
// entry points for f32 tiles, xt_u_bf16.cu and x_cz_bf16.cu for bf16 tiles
// (DiscoConfig.hvp_dtype = 'bfloat16').
//
// Layout: X (d, n) of tile type T (float or __nv_bfloat16), row-major with
// row stride ld >= n elements (a column slice or a row block of a wider
// matrix is passed as a view, never copied); u (d,), c (optional) and z
// (n,), y (d,) f32 either way. Element offsets are 64-bit: d * ld is 2^30
// at the full width.
//
// bf16 tiles round where the TPU kernels round (repro/kernels/glm_hvp.py:
// xt_u's u.astype(X.dtype), x_cz's (c * z).astype(x.dtype)): xt_u rounds u
// to bf16 where a warp loads its rows' u, x_cz rounds c .* z (z alone
// without c) where it forms it from the stage. Every product is then of
// two bf16 values, exact in f32; the sums are f32, so only their order
// differs from the TPU kernel's, and the result repeats bit for bit.
//
// The split (kernels/glm_hvp.py dense_split mirrors it on the host).
// - X is cut into pieces of kTileRows rows by kTileCols columns: row groups
//   g < groups, column chunks k < chunks, the last of each ragged.
// - x_cz numbers the pieces row-group-major (a unit is a row group, whose
//   rows a piece's partial dot products add to); xt_u numbers them
//   chunk-major (a unit is a column chunk, whose columns a piece's partial
//   z adds to).
// - CTA k takes pieces [k P / ctas, (k + 1) P / ctas) of the P pieces, so
//   CTA shares differ by at most one piece whatever the shape: no wave
//   tail at the full width, at a DiSCO-S column view or at a DiSCO-F row
//   block.
//
// Design.
// - Bulk path: a producer warp (one warp beside the kThreads consumer
//   threads) issues, per piece, one 1-D cp.async.bulk per tile row (lane
//   r copies row r; rows are ld apart in device memory and kTileCols
//   floats apart in the stage) and, for x_cz, one of the chunk's z and one
//   of its c, into one stage of a ring in dynamic shared memory (two
//   stages of 96 KB pieces), completing that stage's full mbarrier. Each
//   consumer warp arrives on the stage's empty mbarrier when it is done
//   with it; the producer refills a stage once all have. No CTA-wide
//   barrier per piece, and no tensor map. The rows of X are copied with
//   an evict-first L2 policy: X is read once, and the vectors, read again
//   by every CTA, stay in L2.
// - Producer and consumers walk the CTA's pieces with a cursor that steps
//   by one piece (no division on the way).
// - The piece, 16 rows by 1536 columns (6 KB a row copy at f32) on 384
//   consumer threads, measured fastest on the card beside 32 x 512,
//   32 x 768 and 24 x 1024 (chip_dense_variants.py): a larger piece means
//   fewer barrier waits per byte, and two stages of it keep enough in
//   flight.
// - bf16 keeps the piece in elements (16 x 1536, 3 KB a row copy): a
//   stage holds half the bytes, and the ring doubles its depth for the
//   same bytes in flight (4 stages for xt_u, 3 for x_cz, whose stage also
//   holds the f32 z and c). Keeping the bytes instead (16 x 3072) would
//   double those f32 vectors too: an x_cz stage of 120 KB, two of which do
//   not fit 227 KB. The thread mapping, the split and the fix-up are
//   then the same at both types.
// - Thread t takes the four columns 4q .. 4q + 3 of a piece (q = t %
//   kColThreads: one 16-byte read of f32, one 8-byte read of bf16) and its
//   rows rt + j kRowThreads (rt = t / kColThreads).
//   x_cz: each thread forms c .* z for its 4 columns once per piece, from
//   the stage, and uses it for its kRowsPerThread rows, keeping one partial
//   sum per row in registers over the whole run of the CTA's pieces in one
//   row group; c and z are read from L2 once per kTileRows rows of X.
//   xt_u: each thread keeps the partial z of its 4 columns in registers
//   over its run of rows in one chunk; u of a piece's rows is read a piece
//   ahead, once per warp (one float a lane), and handed out by shuffles.
// - At the end of a unit's segment (the unit's last piece or the range's
//   last) the sums are reduced in a fixed order (lanes, then warps or row
//   threads through shared memory). A unit wholly inside the range is
//   written to the output; a unit cut by a range boundary has its partial
//   written to the caller's scratch (ctas, 2, unit length): slot 0 if the
//   unit holds the range's first piece, else slot 1 (a CTA cuts at most
//   two units).
// - The fix-up kernel, launched right after on the same stream by the same
//   entry point, sums each cut unit's partials in CTA order. Every sum's
//   order is fixed by the shape and the CTA count, so the result repeats
//   bit for bit; no atomics.
// - Direct path, for shapes a bulk copy cannot take (a row of n or ld
//   elements not a multiple of 16 bytes: n or ld not a multiple of 4 at
//   f32, of 8 at bf16, so a DiSCO-S column view at an offset not a
//   multiple of 8 takes it at bf16; X, c or z not 16-byte aligned; or
//   fewer than two stages fitting in shared memory): the same split, walk and write-out, X read
//   from device memory by every thread, thread t taking columns
//   q + e kColThreads (e < 4) so that a warp's loads stay coalesced.
//
// Where trouble was likely, and how it is resolved.
// - The mbarrier phases when a range wraps the ring many times: piece i
//   of a range lives in stage i % stages; consumers wait on its full
//   barrier with parity (i / stages) & 1, and the producer, before the
//   r-th refill of a stage (r >= 1), waits on its empty barrier with
//   parity (r - 1) & 1, which completes only when all consumer warps are
//   done with the piece before. Every piece issued is waited for, so no
//   copy is in flight when a CTA exits, though the producer warp leaves
//   first. The consumers' own barriers (the sums at a unit's end) are a
//   named barrier of the kThreads consumers, without the producer.
// - A range with no piece (fewer pieces than CTAs) returns before touching
//   its barriers; it writes no partial, and the fix-up skips it.
// - The fix-up runs one CTA per range boundary; the first boundary inside
//   a unit sums it. Its order: CTAs k0..k1 (the owners of the unit's first
//   and last piece), ascending, skipping empty ranges; CTA k's partial is
//   in slot 0 if its range starts inside the unit, else in slot 1. Only
//   k0 can hold slot 1, and empty ranges exist only when there are fewer
//   pieces than CTAs (then every range is one piece or none, and the
//   fix-up walks the unit's pieces), so the fix-up needs no table.
// - Shuffles under a ragged chunk: the u shuffles run before the branch on
//   the column, so every lane of a warp takes part.
//
// Bound: device-memory bytes. Each element of X is read once for one
// multiply-add (2 flops per 4 bytes at f32, per 2 at bf16), far below the
// card's flops-per-byte balance; the vectors stay in L2. The ring keeps
// one to two pieces (96 to 192 KB) in flight on every SM at f32, and
// three or four half-size pieces at bf16, above the bandwidth-latency
// product.
#pragma once

#include "ell_tiles.cuh"

namespace dense {

using ells::aligned16;
using ells::bulk_copy;
using ells::mbar_expect_tx;
using ells::mbar_init;
using ells::mbar_wait;
using ells::round_up;
using ells::smem_u32;

constexpr int kThreads = 384;      // consumer threads of a CTA (bulk path:
                                   // one producer warp more)
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 16;                          // rows of a piece
constexpr int kTileCols = 1536;                        // columns of a piece
constexpr int kColThreads = kTileCols / 4;             // 4 columns each
constexpr int kRowThreads = kThreads / kColThreads;
constexpr int kRowsPerThread = kTileRows / kRowThreads;
constexpr int kMaxStages = 4;
constexpr int kBarrierBytes = 128;
constexpr int kFixupThreads = 256;
static_assert(kColThreads % 32 == 0 && kThreads % kColThreads == 0,
              "a warp lies in one row thread");
static_assert(kTileRows % kRowThreads == 0, "rows split evenly");
static_assert(kTileRows <= 32, "a warp holds a piece's u, a float a lane");

enum Path : int { kDirect = 0, kBulk = 1 };

struct Params {
  const void* X;         // T (d, ld), T the tile type of the instance
  long long ld;
  const float* u;        // xt_u
  const float* c;        // x_cz, or null
  const float* z;        // x_cz
  float* out;            // z (n,) for xt_u, y (d,) for x_cz
  float* scratch;        // (ctas, 2, unit length) partials of cut units
  int d, n, ctas;
  int groups, chunks;    // row groups of kTileRows, column chunks
  long long pieces;
  int stages;            // ring stages (bulk path)
  int stage_bytes;       // bytes of one stage: the tile, then z and c (f32)
  int ring_off;          // offset of the ring in shared memory
};

// bytes of a piece of X in a stage, and of one f32 vector beside it
template <class T>
__host__ __device__ constexpr int tile_bytes() {
  return kTileRows * kTileCols * static_cast<int>(sizeof(T));
}
constexpr int kVecBytes = kTileCols * 4;

template <class T>
__device__ __forceinline__ const T* x_of(const Params& p) {
  return static_cast<const T*>(p.X);
}

// The first piece of CTA k's range.
__device__ __forceinline__ long long bound(const Params& p, int k) {
  return static_cast<long long>(k) * p.pieces / p.ctas;
}

// The CTA whose range holds piece t: the largest k with bound(k) <= t,
// that is k P < (t + 1) C.
__device__ __forceinline__ int owner(const Params& p, long long t) {
  return static_cast<int>(((t + 1) * p.ctas - 1) / p.pieces);
}

// A CTA's place in its pieces: row group g, chunk k, the piece's place in
// its unit, and the rows and columns it covers.
template <bool XT>
struct Piece {
  int g, k, pos, per_unit;
  int r0, rows, c0, w;

  __device__ __forceinline__ Piece(const Params& p, long long t) {
    per_unit = XT ? p.groups : p.chunks;
    const int unit = static_cast<int>(t / per_unit);
    pos = static_cast<int>(t - static_cast<long long>(unit) * per_unit);
    g = XT ? pos : unit;
    k = XT ? unit : pos;
    span(p);
  }

  // Step to the next piece (pieces are numbered unit by unit).
  __device__ __forceinline__ void next(const Params& p) {
    if (++pos == per_unit) pos = 0;
    if (XT) {
      g = pos;
      if (pos == 0) ++k;
    } else {
      k = pos;
      if (pos == 0) ++g;
    }
    span(p);
  }

  __device__ __forceinline__ void span(const Params& p) {
    r0 = g * kTileRows;
    rows = min(kTileRows, p.d - r0);
    c0 = k * kTileCols;
    w = min(kTileCols, p.n - c0);
  }
};

// Arrive once on an mbarrier (no transfer bytes).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// A barrier of the consumer threads alone (the producer warp is not in it).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kThreads) : "memory");
}

// An L2 policy that evicts the lines it marks first.
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

// ells::bulk_copy with an L2 policy for the lines it reads.
__device__ __forceinline__ void bulk_copy_hint(void* dst, const void* src,
                                               uint32_t bytes, uint64_t* bar,
                                               uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)),
         "r"(bytes), "r"(smem_u32(bar)), "l"(policy)
      : "memory");
}

// The producer warp: the bulk copies of a piece into `stage`, X's rows
// evict-first.
template <bool XT, class T>
__device__ __forceinline__ void issue(const Params& p, const Piece<XT>& pc,
                                      unsigned char* stage, uint64_t* bar,
                                      uint64_t policy, int lane) {
  const uint32_t row_bytes = static_cast<uint32_t>(pc.w) * sizeof(T);
  const uint32_t vec_bytes = static_cast<uint32_t>(pc.w) * 4;
  if (lane == 0) {
    const uint32_t vecs = XT ? 0 : (p.c ? 2 : 1);
    mbar_expect_tx(bar, pc.rows * row_bytes + vecs * vec_bytes);
  }
  __syncwarp();
  for (int r = lane; r < pc.rows; r += 32)
    bulk_copy_hint(stage + static_cast<size_t>(r) * kTileCols * sizeof(T),
                   x_of<T>(p) + static_cast<size_t>(pc.r0 + r) * p.ld + pc.c0,
                   row_bytes, bar, policy);
  if (!XT && lane == 0) {
    bulk_copy(stage + tile_bytes<T>(), p.z + pc.c0, vec_bytes, bar);
    if (p.c) bulk_copy(stage + tile_bytes<T>() + kVecBytes, p.c + pc.c0,
                       vec_bytes, bar);
  }
}

// Where a unit's sums go: the output (the unit lies wholly in [b0, b1)) or
// the CTA's scratch slot for it.
__device__ __forceinline__ float* unit_dst(const Params& p, long long base,
                                           int per_unit, long long b0,
                                           long long b1, float* whole,
                                           int unit_len) {
  if (base >= b0 && base + per_unit <= b1) return whole;
  const size_t slot =
      2 * static_cast<size_t>(blockIdx.x) + (base <= b0 ? 0 : 1);
  return p.scratch + slot * unit_len;
}

// x_cz: the rows' sums over the CTA's pieces of one row group, added over
// the lanes, then over the warps of a row thread in order; reset.
__device__ __forceinline__ void write_rows(float (&acc)[kRowsPerThread],
                                          float* red, float* dst, int rows,
                                          int lane, int warp) {
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const float s = kern::warp_sum(acc[j]);
    if (lane == 0) red[warp * kRowsPerThread + j] = s;
    acc[j] = 0.f;
  }
  consumers_sync();
  if (threadIdx.x < rows) {
    const int r = threadIdx.x;
    const int rt = r % kRowThreads, j = r / kRowThreads;
    constexpr int kWarpsPerRow = kColThreads / 32;
    float s = 0.f;
    for (int w = 0; w < kWarpsPerRow; ++w)
      s += red[(rt * kWarpsPerRow + w) * kRowsPerThread + j];
    dst[r] = s;
  }
  consumers_sync();                     // red is free again
}

// xt_u: the chunk's column sums over the CTA's pieces of it, added over
// the row threads in order; reset. acc[e] holds column col(q, e).
template <bool BULK>
__device__ __forceinline__ void write_cols(float (&acc)[4], float* red,
                                           float* dst, int w, int q, int rt) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int col = BULK ? 4 * q + e : q + e * kColThreads;
    red[rt * kTileCols + col] = acc[e];
    acc[e] = 0.f;
  }
  consumers_sync();
  for (int j = threadIdx.x; j < w; j += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < kRowThreads; ++r) s += red[r * kTileCols + j];
    dst[j] = s;
  }
  consumers_sync();                     // red is free again
}

template <bool XT, bool BULK, bool HAS_C, class T>
__global__ void __launch_bounds__(kThreads + 32, 1)
    stream_kernel(const Params p) {
  using ells::round_to;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  float* red = reinterpret_cast<float*>(smem + kBarrierBytes);
  unsigned char* ring = smem + p.ring_off;
  const long long b0 = bound(p, blockIdx.x), b1 = bound(p, blockIdx.x + 1);
  if (b0 >= b1) return;                 // empty range: nothing to write
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q = threadIdx.x % kColThreads;
  const int rt = threadIdx.x / kColThreads;

  Piece<XT> pc(p, b0);                  // the piece computed
  int stage = 0, phase = 0;             // its stage and that stage's parity
  if (BULK) {
    if (threadIdx.x == 0) {
      for (int st = 0; st < p.stages; ++st) {
        mbar_init(&full[st], 1);
        mbar_init(&empty[st], kWarps);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (warp == kWarps) {               // the producer warp
      const uint64_t policy = evict_first_policy();
      for (long long t = b0; t < b1; ++t) {
        if (t - b0 >= p.stages) mbar_wait(&empty[stage], phase ^ 1);
        issue<XT, T>(p, pc, ring + static_cast<size_t>(stage) * p.stage_bytes,
                     &full[stage], policy, lane);
        if (++stage == p.stages) {
          stage = 0;
          phase ^= 1;
        }
        pc.next(p);
      }
      return;
    }
  }

  float acc[XT ? 4 : kRowsPerThread];
#pragma unroll
  for (int j = 0; j < (XT ? 4 : kRowsPerThread); ++j) acc[j] = 0.f;

  // xt_u: u of the piece's rows, one a lane, loaded a piece ahead and
  // rounded to the tile type
  float ul = XT && lane < pc.rows ? round_to<T>(__ldg(p.u + pc.r0 + lane))
                                  : 0.f;

  for (long long t = b0; t < b1; ++t) {
    const unsigned char* st = ring + static_cast<size_t>(stage) * p.stage_bytes;
    if (BULK) mbar_wait(&full[stage], phase);

    if constexpr (XT) {
      // u of the piece's rows, handed out by shuffles
      float ur[kRowsPerThread];
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j)
        ur[j] = __shfl_sync(0xffffffffu, ul, rt + j * kRowThreads);
      if (t + 1 < b1) {
        Piece<XT> nx = pc;
        nx.next(p);
        ul = lane < nx.rows ? round_to<T>(__ldg(p.u + nx.r0 + lane)) : 0.f;
      }
      if constexpr (BULK) {
        if (4 * q < pc.w) {
          const T* tile = reinterpret_cast<const T*>(st);
#pragma unroll
          for (int j = 0; j < kRowsPerThread; ++j) {
            const int r = rt + j * kRowThreads;
            if (r < pc.rows) {
              const float4 x = ells::load4(tile + r * kTileCols, q);
              acc[0] += ur[j] * x.x;
              acc[1] += ur[j] * x.y;
              acc[2] += ur[j] * x.z;
              acc[3] += ur[j] * x.w;
            }
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < kRowsPerThread; ++j) {
          const int r = rt + j * kRowThreads;
          if (r < pc.rows) {
            const T* row =
                x_of<T>(p) + static_cast<size_t>(pc.r0 + r) * p.ld + pc.c0;
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (q + e * kColThreads < pc.w)
                acc[e] += ur[j] * ells::ldg_elem(row + q + e * kColThreads);
          }
        }
      }
    } else if constexpr (BULK) {
      if (4 * q < pc.w) {
        const T* tile = reinterpret_cast<const T*>(st);
        float4 v = reinterpret_cast<const float4*>(st + tile_bytes<T>())[q];
        if (HAS_C) {
          const float4 s = reinterpret_cast<const float4*>(
              st + tile_bytes<T>() + kVecBytes)[q];
          v = make_float4(s.x * v.x, s.y * v.y, s.z * v.z, s.w * v.w);
        }
        v = make_float4(round_to<T>(v.x), round_to<T>(v.y), round_to<T>(v.z),
                        round_to<T>(v.w));
#pragma unroll
        for (int j = 0; j < kRowsPerThread; ++j) {
          const int r = rt + j * kRowThreads;
          if (r < pc.rows) {
            const float4 x = ells::load4(tile + r * kTileCols, q);
            acc[j] += x.x * v.x + x.y * v.y + x.z * v.z + x.w * v.w;
          }
        }
      }
    } else {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = pc.c0 + q + e * kColThreads;
        v[e] = q + e * kColThreads < pc.w
                   ? round_to<T>(HAS_C ? __ldg(p.c + col) * __ldg(p.z + col)
                                       : __ldg(p.z + col))
                   : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        const int r = rt + j * kRowThreads;
        if (r < pc.rows) {
          const T* row =
              x_of<T>(p) + static_cast<size_t>(pc.r0 + r) * p.ld + pc.c0;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (q + e * kColThreads < pc.w)
              acc[j] += ells::ldg_elem(row + q + e * kColThreads) * v[e];
        }
      }
    }

    if (pc.pos + 1 == pc.per_unit || t + 1 == b1) {   // the segment's end
      const long long base = t - pc.pos;
      if constexpr (XT)
        write_cols<BULK>(acc, red,
                         unit_dst(p, base, pc.per_unit, b0, b1,
                                  p.out + pc.c0, kTileCols),
                         pc.w, q, rt);
      else
        write_rows(acc, red,
                   unit_dst(p, base, pc.per_unit, b0, b1, p.out + pc.r0,
                            kTileRows),
                   pc.rows, lane, warp);
    }
    if (BULK) {                         // the warp is done with the stage
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
    }
    if (++stage == p.stages) {
      stage = 0;
      phase ^= 1;
    }
    pc.next(p);
  }
}

// One CTA per range boundary bound(k), k = 1 .. ctas - 1: the first
// boundary inside a unit (after its first piece) gets the unit the sum of
// its partials in CTA order. A unit no boundary cuts was written whole by
// the CTA whose range holds it.
__global__ void __launch_bounds__(kFixupThreads)
    fixup_kernel(const Params p, int per_unit, int unit_len, int total) {
  const long long b = bound(p, blockIdx.x + 1);
  const int i = static_cast<int>(b / per_unit);       // the unit b lies in
  const long long base = static_cast<long long>(i) * per_unit;
  if (b == base || bound(p, blockIdx.x) > base) return;
  const int k0 = owner(p, base), k1 = owner(p, base + per_unit - 1);
  const int len = min(unit_len, total - i * unit_len);
  // CTA k0 holds the unit in slot 1 unless its range starts in the unit;
  // the CTAs after it do, in slot 0
  const size_t first = (2 * static_cast<size_t>(k0) +
                        (bound(p, k0) >= base ? 0 : 1)) * unit_len;
  const bool sparse = p.pieces < p.ctas;   // ranges of one piece or none
  for (int e = threadIdx.x; e < len; e += blockDim.x) {
    float s = p.scratch[first + e];
    if (!sparse) {
      for (int k = k0 + 1; k <= k1; ++k)
        s += p.scratch[2 * static_cast<size_t>(k) * unit_len + e];
    } else {
      for (long long t = base + 1; t < base + per_unit; ++t)
        s += p.scratch[2 * static_cast<size_t>(owner(p, t)) * unit_len + e];
    }
    p.out[static_cast<size_t>(i) * unit_len + e] = s;
  }
}

// The stream kernel's instance for a call (x_cz: with or without c).
template <bool XT, bool BULK, class T>
auto pick(const float* c) {
  if constexpr (XT)
    return stream_kernel<true, BULK, false, T>;
  else
    return c ? stream_kernel<false, BULK, true, T>
             : stream_kernel<false, BULK, false, T>;
}

inline Params make_params(const void* X, long long ld, int d, int n,
                          int ctas, float* out, float* scratch) {
  Params p{};
  p.X = X;
  p.ld = ld;
  p.out = out;
  p.scratch = scratch;
  p.d = d;
  p.n = n;
  p.ctas = ctas;
  p.groups = (d + kTileRows - 1) / kTileRows;
  p.chunks = (n + kTileCols - 1) / kTileCols;
  p.pieces = static_cast<long long>(p.groups) * p.chunks;
  return p;
}

inline bool valid_args(const void* X, long long ld, int d, int n, int ctas,
                       int tile_rows, int tile_cols, const float* out,
                       const float* scratch) {
  return X && out && scratch && d > 0 && n > 0 && ld >= n && ctas > 0 &&
         tile_rows == kTileRows && tile_cols == kTileCols;
}

// Plan the call (bulk path and ring, or direct path), launch the stream
// kernel and the fix-up, and report the path.
template <bool XT, class T>
cudaError_t run(Params p, int* path, cudaStream_t stream) {
  int dev = 0, optin = 0, per_sm = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // CTAs that share an SM share its shared memory (1 KB reserved each)
  const int share = (p.ctas + sms - 1) / sms;
  const long long budget =
      share <= 1 ? optin : min(optin, per_sm / share - 1024);
  const int red_bytes = XT ? kRowThreads * kTileCols * 4
                           : kWarps * kRowsPerThread * 4;
  p.ring_off = kBarrierBytes + round_up(red_bytes, 128);
  p.stage_bytes = round_up(tile_bytes<T>() + (XT ? 0 : 2 * kVecBytes), 128);
  const long long fit = (budget - p.ring_off) / p.stage_bytes;
  // rows of whole 16-byte units: n and ld multiples of 4 at f32, 8 at bf16
  constexpr int kPerUnit = 16 / static_cast<int>(sizeof(T));
  const bool bulk = p.n % kPerUnit == 0 && p.ld % kPerUnit == 0 &&
                    aligned16(p.X) &&
                    (XT || (aligned16(p.z) && (!p.c || aligned16(p.c)))) &&
                    fit >= 2;
  p.stages = bulk ? static_cast<int>(min(fit, 1LL * kMaxStages)) : 1;
  const size_t smem =
      p.ring_off + (bulk ? static_cast<size_t>(p.stages) * p.stage_bytes : 0);
  auto kernel = bulk ? pick<XT, true, T>(p.c) : pick<XT, false, T>(p.c);
  err = kern::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<p.ctas, bulk ? kThreads + 32 : kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (p.ctas > 1) {
    fixup_kernel<<<p.ctas - 1, kFixupThreads, 0, stream>>>(
        p, XT ? p.groups : p.chunks, XT ? kTileCols : kTileRows,
        XT ? p.n : p.d);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess && path) *path = bulk ? kBulk : kDirect;
  return err;
}

}  // namespace dense
