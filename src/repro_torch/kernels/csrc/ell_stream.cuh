// The blocked-ELL product Y = A (c .* V) over S = 1..kern::kMaxCols columns
// as one persistent, balanced grid over the live tiles of a layout, fed by
// a ring of bulk copies. ell_mv.cu (K1, S = 1) and ell_mm.cu (K6) are its
// entry points for f32 tiles, ell_mv_bf16.cu and ell_mm_bf16.cu for bf16
// tiles; nothing else in them differs.
//
// Layout: data (nb, W, br, bc) tiles of type T (float or __nv_bfloat16),
// cols (nb, W) int32 column-block ids, V (ncb * bc, S) f32 row-major with
// row stride ldv >= S, c (ncb * bc,) f32 or null, Y (nb * br, S) f32
// row-major. With bf16 tiles, c .* V is rounded to bf16 before the
// products (the TPU kernel's `(c * v).astype(x.dtype)`); the sums are f32. A row-block's live slots are
// its slots up to and including the last one that holds a nonzero tile
// (for ell_from_csr layouts, exactly its real tiles); the slots past them
// are padding and are never read.
//
// The schedule (kernels/sparse_hvp.py ell_schedule, built once per layout)
// gives prefix (nb + 1,), the prefix sums of the row-blocks' live counts,
// and bounds (ctas + 1,), the ranges of the flattened live-tile sequence
// that the CTAs take, split as evenly as the tile count allows.
//
// Design.
// - CTA k walks the tiles [bounds[k], bounds[k+1]) in order; its range
//   may cross row-block boundaries. Per row-block segment it walks the
//   tiles once per chunk of kRows rows (one chunk for br <= 128), so every
//   live tile byte is read once in all.
// - Bulk path: thread 0 issues, per (tile, chunk) piece, one 1-D
//   cp.async.bulk of the chunk's rows (contiguous in a row-major tile),
//   one of the (bc, ldv) span of V the tile multiplies and one of the c
//   block, into one stage of a ring of 2-4 stages in dynamic shared memory,
//   completing that stage's mbarrier. No tensor map is needed.
// - Per piece all threads wait for the stage, copy c .* V into vecT (S, bc)
//   s-major (the transposition keeps the reads of the compute loop free of
//   bank conflicts whatever ldv is), and take the chunk's rows: warp w takes
//   rows w, w + 16, ... (kRowsPerWarp of them), lanes stride over bc with
//   16-byte reads, and each lane keeps kRowsPerWarp * S partial sums in
//   registers (S a template parameter: at S <= 7 the bulk instances fit the
//   128-register cap of 512 threads; S = 8, off the main path, spills 16
//   bytes); one tile read from shared memory serves all S columns. After
//   the piece a barrier frees the stage and thread 0 refills it with the
//   piece `stages` ahead.
// - At the end of a row-block segment each warp reduces its sums over the
//   lanes. A row-block that lies wholly inside the CTA's range is written
//   to Y. A row-block cut by a range boundary has its partial rows written
//   to the caller's scratch (ctas, 2, br, S): slot 0 if it holds the
//   range's first tile, else slot 1 (a CTA cuts at most two row-blocks).
// - The fix-up kernel, launched right after on the same stream by the same
//   entry point, sums each cut row-block's partials in CTA order and writes
//   zeros for row-blocks with no live tile. The order of every sum is fixed
//   by the schedule, so the result repeats bit for bit; no atomics.
// - Direct path, for tiles a bulk copy cannot take (rows not a multiple of
//   16 bytes: bc % 4 != 0 at f32, bc % 8 != 0 at bf16; pointers not
//   16-byte aligned, a V span past its storage, or fewer than two stages
//   fitting in shared memory): the same schedule, walk, vecT and
//   write-out, with the tile rows read from device memory by every thread.
//
// Where trouble was likely, and how it is resolved.
// - The mbarrier phase when a range wraps the ring more than once: piece n
//   lives in stage n % stages and its wait takes parity (n / stages) & 1.
//   A stage is refilled only after the barrier that follows every thread's
//   wait on it, so no wait can miss its phase, however many times the ring
//   wraps. Every piece issued is waited for, so no copy is in flight when
//   a CTA exits.
// - A range that begins or ends inside a row-block: only that row-block's
//   segment in the range is walked, and its sums go to scratch (slot 0 or
//   1 by the rule above, which the fix-up applies too). With W = 1 every
//   row-block is one tile, so no range boundary can cut one: each is
//   written whole, or is empty and zeroed by the fix-up.
// - A CTA whose range is empty (fewer live tiles than CTAs) returns before
//   touching its barriers; it writes no partial, and the fix-up skips it.
// - The fix-up order: for a cut row-block, CTAs k0..k1 (the ones holding
//   its first and last live tile), ascending, skipping empty ranges.
// - Shared memory above 48 KB: kern::allow_smem opts each instance in to
//   the bytes its ring needs, before each launch.
//
// Bound: device-memory bytes. Each live tile element is read once and used
// in 2 S flops (at S <= 8, below the card's flops-per-byte balance), so
// the kernel can at best stream the live tiles at the HBM rate. The ring
// keeps (stages - 1) pieces in flight on every SM (128 KB at 128 x 128
// f32 tiles and three stages; 96 KB at bf16, whose 32 KB stages fit four
// deep), well above the bandwidth-latency product.
#pragma once

#include "ell_tiles.cuh"

namespace ells {

constexpr int kFixupThreads = 128;

struct Params {
  const void* data;      // tiles of the entry point's type T
  const int* cols;
  const int* prefix;     // (nb + 1,) live-tile prefix sums
  const int* bounds;     // (ctas + 1,) CTA ranges of the live-tile sequence
  const float* V;
  long long ldv;
  const float* c;        // or null
  float* Y;
  float* scratch;        // (ctas, 2, br, S) partial rows of cut row-blocks
  int nb, W, br, bc, ncb, ctas;
  int stages;            // ring stages (bulk path)
  int stage_bytes;       // bytes of one stage: tile chunk, V span, c block
  int v_off, c_off;      // offsets of the V span and the c block in a stage
  int v_bytes;           // bytes of the V span
  int ring_off;          // offset of the ring in shared memory
};

// Where a CTA stands in its range [b0, b1) of the live-tile sequence:
// row-block i (its live tiles are [base, end)), its row chunk, and tile t
// inside the segment [ts, te) of row-block i that lies in the range.
struct Cursor {
  int i, chunk, t, ts, te, base, end;
  bool valid;
};

// From cur.i on, the first row-block with live tiles inside [b0, b1).
__device__ __forceinline__ void seek(Cursor& cur, const Params& p, int b0,
                                     int b1) {
  for (; cur.i < p.nb; ++cur.i) {
    const int base = p.prefix[cur.i], end = p.prefix[cur.i + 1];
    if (base >= b1) break;
    const int lo = max(base, b0), hi = min(end, b1);
    if (lo < hi) {
      cur.base = base;
      cur.end = end;
      cur.ts = cur.t = lo;
      cur.te = hi;
      cur.chunk = 0;
      cur.valid = true;
      return;
    }
  }
  cur.valid = false;
}

__device__ __forceinline__ void advance(Cursor& cur, const Params& p,
                                        int nchunks, int b0, int b1) {
  if (++cur.t < cur.te) return;
  if (++cur.chunk < nchunks) {
    cur.t = cur.ts;
    return;
  }
  ++cur.i;
  seek(cur, p, b0, b1);
}

// The piece's tile rows in device memory and its column-block id; traps on
// a slot past W or a column id out of range (a corrupt layout or schedule).
template <class T>
__device__ __forceinline__ const T* piece_tile(const Cursor& cur,
                                              const Params& p, int* cb) {
  const int slot = cur.t - cur.base;
  if (slot >= p.W) __trap();
  const size_t k = static_cast<size_t>(cur.i) * p.W + slot;
  *cb = p.cols[k];
  if (*cb < 0 || *cb >= p.ncb) __trap();
  return static_cast<const T*>(p.data) +
         (k * p.br + static_cast<size_t>(cur.chunk) * kRows) * p.bc;
}

__device__ __forceinline__ int piece_rows(const Cursor& cur, const Params& p) {
  return min(kRows, p.br - cur.chunk * kRows);
}

// Thread 0: the bulk copies of one piece into `stage`.
template <class T>
__device__ __forceinline__ void issue(const Cursor& cur, const Params& p,
                                      unsigned char* stage, uint64_t* bar) {
  int cb;
  const T* tile = piece_tile<T>(cur, p, &cb);
  const uint32_t tile_bytes =
      static_cast<uint32_t>(piece_rows(cur, p)) * p.bc * sizeof(T);
  const size_t base = static_cast<size_t>(cb) * p.bc;
  mbar_expect_tx(bar, tile_bytes + p.v_bytes +
                          (p.c ? p.bc * sizeof(float) : 0));
  bulk_copy(stage, tile, tile_bytes, bar);
  bulk_copy(stage + p.v_off, p.V + base * p.ldv, p.v_bytes, bar);
  if (p.c) bulk_copy(stage + p.c_off, p.c + base, p.bc * sizeof(float), bar);
}

// The end of a row-block segment: each warp's rows summed over its lanes,
// to Y (the row-block lies wholly in the range) or to the CTA's scratch
// slot; the sums are reset.
template <int S>
__device__ __forceinline__ void write_rows(float (&acc)[kRowsPerWarp][S],
                                           const Cursor& cur, const Params& p,
                                           int b0, int b1, int rows, int lane,
                                           int warp) {
  const size_t row0 = static_cast<size_t>(cur.chunk) * kRows;
  float* out;
  if (cur.base >= b0 && cur.end <= b1) {
    out = p.Y + (static_cast<size_t>(cur.i) * p.br + row0) * S;
  } else {
    const size_t slot = 2 * static_cast<size_t>(blockIdx.x) +
                        (cur.base <= b0 ? 0 : 1);
    out = p.scratch + (slot * p.br + row0) * S;
  }
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) {
    const int r = warp + k * kWarps;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      if (r < rows) {                       // uniform over the warp
        const float sum = kern::warp_sum(acc[k][j]);
        if (lane == 0) out[static_cast<size_t>(r) * S + j] = sum;
      }
      acc[k][j] = 0.f;
    }
  }
}

template <class T, int S, bool BULK>
__global__ void __launch_bounds__(kThreads, 1) stream_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  float* vecT = reinterpret_cast<float*>(smem + kBarrierBytes);
  unsigned char* ring = smem + p.ring_off;
  const int b0 = p.bounds[blockIdx.x], b1 = p.bounds[blockIdx.x + 1];
  if (b0 >= b1) return;                 // empty range: nothing to write
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nchunks = (p.br + kRows - 1) / kRows;

  Cursor cur;
  cur.i = last_at_most(p.prefix, p.nb, b0);
  seek(cur, p, b0, b1);
  Cursor prod = cur;                    // thread 0's issue position
  if (BULK) {
    if (threadIdx.x == 0) {
      for (int st = 0; st < p.stages; ++st) mbar_init(&full[st], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int st = 0; st < p.stages && prod.valid; ++st) {
        issue<T>(prod, p, ring + static_cast<size_t>(st) * p.stage_bytes,
                 &full[st]);
        advance(prod, p, nchunks, b0, b1);
      }
    }
    __syncthreads();
  }

  float acc[kRowsPerWarp][S];
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k)
#pragma unroll
    for (int j = 0; j < S; ++j) acc[k][j] = 0.f;

  for (int n = 0; cur.valid; ++n) {
    const int stage = n % p.stages;
    const int rows = piece_rows(cur, p);
    const T* tile;
    if (BULK) {
      mbar_wait(&full[stage], (n / p.stages) & 1);
      const unsigned char* st = ring + static_cast<size_t>(stage) * p.stage_bytes;
      tile = reinterpret_cast<const T*>(st);
      stage_vec<T, S>(vecT, reinterpret_cast<const float*>(st + p.v_off),
                      p.ldv,
                      p.c ? reinterpret_cast<const float*>(st + p.c_off)
                          : nullptr,
                      p.bc);
    } else {
      int cb;
      tile = piece_tile<T>(cur, p, &cb);
      const size_t base = static_cast<size_t>(cb) * p.bc;
      stage_vec<T, S>(vecT, p.V + base * p.ldv, p.ldv,
                      p.c ? p.c + base : nullptr, p.bc);
    }
    __syncthreads();                    // vecT staged
    dot_rows<T, S, BULK>(tile, vecT, acc, rows, p.bc, lane, warp);
    if (cur.t + 1 == cur.te)            // the segment's last tile
      write_rows<S>(acc, cur, p, b0, b1, rows, lane, warp);
    __syncthreads();                    // the stage and vecT are free
    if (BULK && threadIdx.x == 0 && prod.valid) {
      issue<T>(prod, p, ring + static_cast<size_t>(stage) * p.stage_bytes,
               &full[stage]);
      advance(prod, p, nchunks, b0, b1);
    }
    advance(cur, p, nchunks, b0, b1);
  }
}

// One CTA per row-block: a row-block cut by range boundaries gets the sum
// of its partials in CTA order; one with no live tile gets zeros; one that
// lies wholly in one range was written there and is left alone.
template <int S>
__global__ void __launch_bounds__(kFixupThreads) fixup_kernel(const Params p) {
  const int i = blockIdx.x;
  const int base = p.prefix[i], end = p.prefix[i + 1];
  const int len = p.br * S;
  float* y = p.Y + static_cast<size_t>(i) * len;
  if (base == end) {
    for (int e = threadIdx.x; e < len; e += blockDim.x) y[e] = 0.f;
    return;
  }
  const int k0 = last_at_most(p.bounds, p.ctas, base);
  const int k1 = last_at_most(p.bounds, p.ctas, end - 1);
  if (k0 == k1) return;
  for (int e = threadIdx.x; e < len; e += blockDim.x) {
    float sum = 0.f;
    for (int k = k0; k <= k1; ++k) {
      const int lo = p.bounds[k];
      if (lo == p.bounds[k + 1]) continue;      // empty range
      const size_t slot = 2 * static_cast<size_t>(k) + (lo >= base ? 0 : 1);
      sum += p.scratch[slot * len + e];
    }
    y[e] = sum;
  }
}

// Plan the call (bulk path and ring, or direct path), launch the stream
// kernel and the fix-up, and report the path. v_len: the floats readable
// from V on (the bulk path copies whole (bc, ldv) spans of V). The stage
// count is the most stages of the tile type's piece that fit, up to
// kMaxStages.
template <class T, int S>
cudaError_t run(Params p, long long v_len, int* path, cudaStream_t stream) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  const int chunk_rows = min(kRows, p.br);
  const size_t tile_bytes = static_cast<size_t>(chunk_rows) * p.bc * sizeof(T);
  const size_t v_bytes = static_cast<size_t>(p.bc) * p.ldv * sizeof(float);
  const size_t c_bytes = p.c ? static_cast<size_t>(p.bc) * sizeof(float) : 0;
  p.ring_off = kBarrierBytes + round_up(static_cast<size_t>(S) * p.bc * sizeof(float), 128);
  const size_t stage_bytes = round_up(tile_bytes + v_bytes + c_bytes, 128);
  const long long fit = (static_cast<long long>(optin) - p.ring_off) /
                        static_cast<long long>(stage_bytes);
  const bool bulk = bulk_rows<T>(p.bc) && aligned16(p.data) && aligned16(p.V) &&
                    (!p.c || aligned16(p.c)) &&
                    static_cast<long long>(p.ncb) * p.bc * p.ldv <= v_len &&
                    fit >= 2;
  p.stages = bulk ? static_cast<int>(min(fit, static_cast<long long>(kMaxStages))) : 1;
  p.stage_bytes = static_cast<int>(stage_bytes);
  p.v_bytes = static_cast<int>(v_bytes);
  p.v_off = static_cast<int>(tile_bytes);
  p.c_off = static_cast<int>(tile_bytes + v_bytes);
  const size_t smem = bulk ? p.ring_off + p.stages * stage_bytes
                           : static_cast<size_t>(p.ring_off);
  auto kernel = bulk ? stream_kernel<T, S, true> : stream_kernel<T, S, false>;
  err = kern::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<p.ctas, kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fixup_kernel<S><<<p.nb, kFixupThreads, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err == cudaSuccess && path) *path = bulk ? kBulk : kDirect;
  return err;
}

// The arguments both entry points check.
inline bool valid_args(const void* data, const int* cols, const int* sched,
                       int ctas, float* Y, float* scratch, int nb, int W,
                       int br, int bc, int ncb) {
  return data && cols && sched && Y && scratch && nb > 0 && W > 0 &&
         br > 0 && bc > 0 && ncb > 0 && ctas > 0;
}

inline Params make_params(const void* data, const int* cols, const int* sched,
                          int ctas, const float* V, long long ldv,
                          const float* c, float* Y, float* scratch, int nb,
                          int W, int br, int bc, int ncb) {
  Params p{};
  p.data = data;
  p.cols = cols;
  p.prefix = sched + nb;                 // sched: live (nb), prefix, bounds
  p.bounds = sched + 2 * nb + 1;
  p.V = V;
  p.ldv = ldv;
  p.c = c;
  p.Y = Y;
  p.scratch = scratch;
  p.nb = nb;
  p.W = W;
  p.br = br;
  p.bc = bc;
  p.ncb = ncb;
  p.ctas = ctas;
  return p;
}

// The body of the K1 entry points (ell_mv.cu, ell_mv_bf16.cu): launches the
// stream kernel and its fix-up, writes the path taken to *path (0 direct,
// 1 bulk copies), and returns a cudaError_t (0 = launched).
template <class T>
int mv(const T* data, const int* cols, const int* sched, int ctas,
       const float* v, const float* c, float* y, float* scratch, int nb,
       int W, int br, int bc, int ncb, int* path, void* stream) {
  if (!v || !valid_args(data, cols, sched, ctas, y, scratch, nb, W, br, bc,
                        ncb))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p = make_params(data, cols, sched, ctas, v, 1, c, y, scratch,
                               nb, W, br, bc, ncb);
  return static_cast<int>(run<T, 1>(p, static_cast<long long>(ncb) * bc,
                                    path, static_cast<cudaStream_t>(stream)));
}

// The body of the K6 entry points (ell_mm.cu, ell_mm_bf16.cu), one
// instance per s.
template <class T>
int mm(const T* data, const int* cols, const int* sched, int ctas,
       const float* V, long long ldv, long long v_len, const float* c,
       float* Y, float* scratch, int nb, int W, int br, int bc, int ncb,
       int s, int* path, void* stream) {
  if (!V || s <= 0 || s > kern::kMaxCols || ldv < s ||
      !valid_args(data, cols, sched, ctas, Y, scratch, nb, W, br, bc, ncb))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p = make_params(data, cols, sched, ctas, V, ldv, c, Y, scratch,
                               nb, W, br, bc, ncb);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (s) {
    case 1: err = run<T, 1>(p, v_len, path, st); break;
    case 2: err = run<T, 2>(p, v_len, path, st); break;
    case 3: err = run<T, 3>(p, v_len, path, st); break;
    case 4: err = run<T, 4>(p, v_len, path, st); break;
    case 5: err = run<T, 5>(p, v_len, path, st); break;
    case 6: err = run<T, 6>(p, v_len, path, st); break;
    case 7: err = run<T, 7>(p, v_len, path, st); break;
    default: err = run<T, 8>(p, v_len, path, st); break;
  }
  return static_cast<int>(err);
}

}  // namespace ells
