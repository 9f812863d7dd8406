// The dense multi-vector passes of the s-step HVP over s <=
// kern::kMaxCols probe vectors at once, as one persistent, balanced grid
// over pieces of a row-major X fed by a ring of bulk copies: xt_multi (K8,
// Z = X^T U) and x_cz_multi (K9, Y = X (c .* Z)). xt_multi.cu and
// x_cz_multi.cu are their entry points for f32 tiles, xt_multi_bf16.cu and
// x_cz_multi_bf16.cu for bf16 tiles (DiscoConfig.hvp_dtype = 'bfloat16').
//
// Layout: X (d, n) of tile type T (float or __nv_bfloat16), row-major with
// row stride ld >= n elements (a column slice or a row block of a wider
// matrix is passed as a view); U (d, s) and Z (n, s) f32 row-major with
// row strides ldu, ldz >= s (a column group of a wider block is passed as
// a view); c (n,) f32 or null; the outputs f32 row-major (n, s) and
// (d, s). Element offsets are 64-bit.
//
// bf16 tiles round where the TPU kernels round (repro/kernels/glm_hvp.py:
// xt_multi's U.astype(X.dtype), x_cz_multi's (c * z).astype(x.dtype)):
// xt_multi rounds U as it stages a piece's rows of it, x_cz_multi rounds
// c .* Z (Z alone without c, as the softmax product passes it) where it
// forms a piece's columns of it. Every product is then of two bf16
// values, exact in f32; the sums are f32 in an order fixed by the shape
// and the CTA count, so the result repeats bit for bit. At f32 the
// rounding is the identity.
//
// The split (kernels/glm_hvp.py multi_split mirrors it on the host), as
// dense_stream.cuh's for K3 / K4:
// - X is cut into pieces of TR rows by TC columns: row groups g < groups,
//   column chunks k < chunks, the last of each ragged. xt_multi takes
//   short, wide pieces (1024 columns: 16 rows of f32, 32 of bf16) and
//   numbers them chunk-major (a unit is a column chunk, whose rows of Z a
//   piece's partial sums add to); x_cz_multi takes tall ones (512
//   columns: 40 rows of f32, 96 of bf16) and numbers them row-group-major
//   (a unit is a row group). A piece of x_cz_multi needs its chunk's c and
//   Z, 36 bytes a column at s = 8: 0.225 of the piece's X at f32, 0.19 at
//   bf16.
// - The pieces were chosen on the card (chip_multi_variants.py, PERF.md).
//   A row copy of 512 bytes (x_cz_multi's first bf16 pieces, 128 x 256)
//   held the kernel to 2.1 TB/s with the arithmetic taken out (the bulk
//   copies' own rate), rows of 1 KB to 2.9 TB/s: rows of at least 1 KB,
//   and x_cz_multi's pieces tall enough for c and Z, take two stages of
//   80 and 96 KB pieces. xt_multi's partials of cut units are TC s floats each, so
//   its bf16 rows stay at 2 KB (4 KB rows cost 27 us more at s = 8, in the
//   fix-up).
// - CTA k takes pieces [k P / ctas, (k + 1) P / ctas) of the P pieces, so
//   CTA shares differ by at most one piece whatever the shape: no wave
//   tail at the full width, at a DiSCO-S column view or at a DiSCO-F row
//   block.
//
// Design.
// - Bulk path: a producer warp (one warp beside the kThreads consumer
//   threads) issues, per piece, one 1-D cp.async.bulk per tile row (X
//   evict-first in L2) into one stage of a ring in dynamic shared memory
//   (xt_multi three stages of 64 KB pieces, x_cz_multi two of 80 or 96
//   KB), completing that stage's full mbarrier. Each consumer warp arrives
//   on the stage's empty mbarrier when it is done with it; the producer
//   refills a stage once all have. The producer, the ring and the parity
//   rule are
//   dense_stream.cuh's (bulk_copy_hint, evict_first_policy and
//   mbar_arrive are taken from it; the walk, the write-out and the fix-up
//   are mirrored here for the two pieces).
// - A tile row lies kRowPad bytes past a multiple of 128 from the one
//   before, so the 8 rows an ldmatrix or a column of threads reads fall
//   in different banks.
// - The vectors: the consumers stage a piece's vector block once, into
//   one of two buffers: x_cz_multi the chunk's c .* Z, rounded to T and
//   stored transposed (cz[j][col], a row of TC + 16 bytes per vector);
//   xt_multi the piece's rows of U, rounded to T (U[j][row] for the
//   tensor cores, U[row][j] for the CUDA cores). Each thread loads its
//   share of the next piece's block from device memory (L2) into
//   registers while the piece before is computed (thread t the block's
//   rows t + 256 q, all s floats of each), so c, Z and U are read once per
//   piece, by loads that a strided block or an unaligned vector takes as
//   well as a contiguous one; the inner loop reads them from shared memory
//   only.
// - A named barrier of the consumers (not the producer) per piece orders
//   the staging before the reads. The two buffers alternate by piece: a
//   thread rewrites a buffer only after the barrier of the piece after the
//   one that read it, which every consumer reaches only when that piece's
//   reads are done (K5 / K10 had exactly this race with one buffer).
// - bf16 on the tensor cores: mma.sync m16n8k16 (bf16 x bf16 -> f32),
//   an s <= 8 block the N = 8 of the tile, the vector rows past s left
//   zero. x_cz_multi: warp w < 6 owns rows [16 w, 16 w + 16) of a piece;
//   A is the piece (ldmatrix), B the staged c .* Z; 32 steps a piece, the
//   warp's 16 x 8 sums in registers over the CTA's pieces of a row group.
//   xt_multi: warp w owns columns [128 w, 128 w + 128) of a piece (8
//   tiles of 16); A is X^T (ldmatrix.trans from the same row-major
//   stage), B the staged U rows; 4 sums a thread a tile. Each step starts
//   from zero and is added to the f32 sums (mma_bf16). Each warp writes
//   its own rows or columns at a unit's end: no reduction between warps.
// - f32 on the CUDA cores (TF32 would round X): x_cz_multi: warp w takes
//   the row slab [5 w, 5 w + 5) of a piece, lane l its column quads
//   l + 32 e, keeping 5 s sums, reduced over the lanes by shuffles at a
//   unit's end; xt_multi: thread t takes the 4 columns [4 t, 4 t + 4) of
//   a piece and all its rows (one 16-byte read a row), keeping 4 s sums,
//   written as they are at a unit's end. The same code takes bf16 tiles
//   when kMmaAtBf16 is false (chip_multi_variants.py times both).
// - Instances by columns: each s in 1 .. kMaxCols is its own instance
//   (by_cols), so a thread holds exactly its sums.
// - Ragged pieces: the consumers zero the whole of shared memory once,
//   before the first copy; a stage's bytes outside a ragged piece then
//   hold zeros or another piece's (finite) X, and meet only zeros: c .* Z
//   past the chunk's columns and U past the group's rows are staged as
//   zeros, and outputs past the piece are not written.
// - At the end of a unit's segment (the unit's last piece or the range's
//   last) a unit wholly inside the range is written to the output; a unit
//   cut by a range boundary has its partial written to the caller's
//   scratch (ctas, 2, unit length x s): slot 0 if the unit holds the
//   range's first piece, else slot 1. The fix-up kernel, launched right
//   after on the same stream by the same entry point, sums each cut
//   unit's partials in CTA order (dense_stream.cuh's, on a unit of TC s or
//   TR s floats, whose outputs it spreads over blocks of 2,048). No
//   atomics.
// - Direct path, for X a bulk copy cannot take (a row of n or ld elements
//   not a whole number of 16-byte units: n or ld not a multiple of 4 at
//   f32, of 8 at bf16; X not 16-byte aligned; or fewer than two stages
//   fitting in shared memory): no producer; the consumers load each piece
//   into one stage with ordinary loads (zeros outside it), then compute
//   it exactly as the bulk path does. Same split, walk, sums and fix-up:
//   the two paths give the same bits.
//
// Where trouble was likely, and how it is resolved.
// - The mbarrier phases: dense_stream.cuh's rule. Piece i of a range lives
//   in stage i % stages; consumers wait on its full barrier with parity
//   (i / stages) & 1, and the producer, before the r-th refill of a stage
//   (r >= 1), waits on its empty barrier with parity (r - 1) & 1.
// - The zeroing and the copies: the zeros are written by the generic
//   proxy and later overwritten by bulk copies (the async proxy); each
//   thread fences its writes to the async proxy before the CTA barrier
//   that lets the producer start.
// - A range with no piece (fewer pieces than CTAs) returns before touching
//   its barriers; it writes no partial, and the fix-up skips it.
//
// Bound: device-memory bytes. Each element of X is read once for s
// multiply-adds (2 s flops per 4 bytes at f32, per 2 at bf16: at most 8
// flops a byte at s = 8, below the card's f32 balance of 20), so X's bytes
// bound it for all s vectors at once; c and Z come from L2 once per piece.
#pragma once

#include "dense_stream.cuh"

namespace dmulti {

using dense::bulk_copy_hint;
using dense::evict_first_policy;
using dense::mbar_arrive;
using ells::aligned16;
using ells::load4;
using ells::mbar_expect_tx;
using ells::mbar_init;
using ells::mbar_wait;
using ells::round_to;
using ells::round_up;
using ells::smem_u32;

constexpr int kThreads = 256;      // consumer threads of a CTA (bulk path:
                                   // one producer warp more)
constexpr int kWarps = kThreads / 32;
// the pieces, by kernel and tile type: the bytes of a tile row and the
// rows. xt_multi 64 KB: 16 rows of 4 KB at f32, 32 rows of 2 KB at bf16
// (1024 columns either way: a cut unit's partial is 1024 s floats);
// x_cz_multi 40 rows of 2 KB at f32 (512 columns) and 96 rows of 1 KB at
// bf16 (512 columns), so that c and Z (36 bytes a column at s = 8) are at
// most 0.225 of a piece's X
constexpr int kXtRowBytesF32 = 4096;
constexpr int kXtRowsF32 = 16;
constexpr int kXtRowBytesBf16 = 2048;
constexpr int kXtRowsBf16 = 32;
constexpr int kCzRowBytesF32 = 2048;
constexpr int kCzRowsF32 = 40;
constexpr int kCzRowBytesBf16 = 1024;
constexpr int kCzRowsBf16 = 96;
constexpr int kFixupThreads = 256;
constexpr int kFixupPer = 8;       // outputs of a cut unit a fix-up thread
constexpr int kRowPad = 16;        // bytes after each tile row in a stage
constexpr int kMaxStages = 4;
constexpr int kBarrierBytes = 128;
// bf16 tiles on the tensor cores (mma.sync); false: the CUDA-core loops
constexpr bool kMmaAtBf16 = true;

enum Path : int { kDirect = 0, kBulk = 1 };

// The piece of a kernel (XT: xt_multi) at tile type T.
template <bool XT, class T>
__host__ __device__ constexpr int row_bytes() {
  return sizeof(T) == 4 ? (XT ? kXtRowBytesF32 : kCzRowBytesF32)
                        : (XT ? kXtRowBytesBf16 : kCzRowBytesBf16);
}
template <bool XT, class T>
__host__ __device__ constexpr int tile_cols() {
  return row_bytes<XT, T>() / static_cast<int>(sizeof(T));
}
template <bool XT, class T>
__host__ __device__ constexpr int tile_rows() {
  return sizeof(T) == 4 ? (XT ? kXtRowsF32 : kCzRowsF32)
                        : (XT ? kXtRowsBf16 : kCzRowsBf16);
}
// bytes of a tile row in a stage, and of a stage
template <bool XT, class T>
__host__ __device__ constexpr int row_pitch() {
  return row_bytes<XT, T>() + kRowPad;
}
template <bool XT, class T>
__host__ __device__ constexpr int stage_bytes() {
  return tile_rows<XT, T>() * row_pitch<XT, T>();
}
// elements of a staged vector row (c .* Z of a chunk's columns, U of a
// group's rows), 16 bytes of padding after each, kMaxCols rows a buffer
template <bool XT, class T>
__host__ __device__ constexpr int vec_pitch() {
  return (XT ? tile_rows<XT, T>() : tile_cols<XT, T>()) +
         16 / static_cast<int>(sizeof(T));
}
template <bool XT, class T>
__host__ __device__ constexpr int vec_buffer_bytes() {
  return (kern::kMaxCols * vec_pitch<XT, T>() * static_cast<int>(sizeof(T)) +
          127) / 128 * 128;
}
template <class T>
__host__ __device__ constexpr bool use_mma() {
  return sizeof(T) == 2 && kMmaAtBf16;
}

static_assert(tile_cols<true, float>() % (4 * kThreads) == 0,
              "xt_multi: whole quads of columns a thread");
static_assert(tile_cols<true, __nv_bfloat16>() % (16 * kWarps) == 0,
              "xt_multi mma: whole tiles of columns a warp");
static_assert(tile_rows<true, __nv_bfloat16>() % 16 == 0,
              "xt_multi mma: whole k-steps of rows");
static_assert(tile_rows<false, __nv_bfloat16>() % 16 == 0 &&
                  tile_rows<false, __nv_bfloat16>() <= 16 * kWarps,
              "x_cz_multi mma: 16 rows a warp");
static_assert(tile_rows<false, float>() % kWarps == 0 &&
                  tile_cols<false, float>() % 128 == 0,
              "x_cz_multi: a row slab a warp, whole quads a lane");
static_assert((kRowPad % 16) == 0 && (kXtRowBytesF32 % 128) == 0 &&
                  (kXtRowBytesBf16 % 128) == 0 &&
                  (kCzRowBytesF32 % 128) == 0 && (kCzRowBytesBf16 % 128) == 0,
              "rows 16-byte aligned, a bank group apart");

struct Params {
  const void* X;         // T (d, ld), T the tile type of the instance
  long long ld;
  const float* V;        // U (d, s) for xt_multi, Z (n, s) for x_cz_multi
  long long ldv;
  const float* c;        // x_cz_multi, or null
  float* out;            // Z (n, s) for xt_multi, Y (d, s) for x_cz_multi
  float* scratch;        // (ctas, 2, unit length * s) partials of cut units
  int d, n, s, ctas;
  int groups, chunks;    // row groups of TR, column chunks of TC
  long long pieces;
  int stages;            // ring stages (bulk path; 1 on the direct path)
  int ring_off;          // offset of the ring in shared memory
};

// The first piece of CTA k's range (dense_stream.cuh's bound).
__device__ __forceinline__ long long bound(const Params& p, int k) {
  return static_cast<long long>(k) * p.pieces / p.ctas;
}

// A CTA's place in its pieces: row group g, chunk k, the piece's place in
// its unit, and the rows and columns it covers (dense_stream.cuh's Piece
// on this header's tiles).
template <bool XT, class T>
struct Piece {
  static constexpr int TR = tile_rows<XT, T>(), TC = tile_cols<XT, T>();
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
    r0 = g * TR;
    rows = min(TR, p.d - r0);
    c0 = k * TC;
    w = min(TC, p.n - c0);
  }
};

template <class T>
__device__ __forceinline__ const T* x_of(const Params& p) {
  return static_cast<const T*>(p.X);
}

// f32 to the tile type (round to nearest even for bf16).
template <class T>
__device__ __forceinline__ T to_tile(float x) {
  if constexpr (std::is_same_v<T, float>) return x;
  else return __float2bfloat16_rn(x);
}

// A barrier of the consumer threads alone (the producer warp is not in it).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kThreads) : "memory");
}

// Order this thread's generic writes to shared memory before later bulk
// copies (the async proxy) into the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3]) : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&a)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3]) : "r"(addr));
}

// acc += A B over one 16 x 16 x 8 step: bf16 operands. The tensor cores
// sum the step's 16 exact products from zero; the step's sums are then
// added to acc by f32 adds (round to nearest). Chaining the steps through
// the mma's own accumulator instead lets its truncating sums drift over a
// row of 262,144 columns (6.9e-5 relative at the dense slice's width,
// against ~1e-6 this way).
__device__ __forceinline__ void mma_bf16(float* acc, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  float d[4];
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += d[i];
}

// The producer warp: the bulk copies of a piece's rows into `stage`, X
// evict-first, a row kRowPad bytes past the last.
template <bool XT, class T>
__device__ __forceinline__ void issue(const Params& p, const Piece<XT, T>& pc,
                                      unsigned char* stage, uint64_t* bar,
                                      uint64_t policy, int lane) {
  const uint32_t row_bytes = static_cast<uint32_t>(pc.w) * sizeof(T);
  if (lane == 0) mbar_expect_tx(bar, pc.rows * row_bytes);
  __syncwarp();
  for (int r = lane; r < pc.rows; r += 32)
    bulk_copy_hint(stage + static_cast<size_t>(r) * row_pitch<XT, T>(),
                   x_of<T>(p) + static_cast<size_t>(pc.r0 + r) * p.ld + pc.c0,
                   row_bytes, bar, policy);
}

// Direct path: the piece into `stage` by ordinary loads, zeros outside it.
template <bool XT, class T>
__device__ __forceinline__ void load_tile(const Params& p,
                                          const Piece<XT, T>& pc,
                                          unsigned char* stage) {
  constexpr int TR = Piece<XT, T>::TR, TC = Piece<XT, T>::TC;
  constexpr int PE = row_pitch<XT, T>() / static_cast<int>(sizeof(T));
  T* tile = reinterpret_cast<T*>(stage);
#pragma unroll 4
  for (int e = threadIdx.x; e < TR * TC; e += kThreads) {
    const int r = e / TC, col = e - r * TC;
    tile[r * PE + col] =
        r < pc.rows && col < pc.w
            ? x_of<T>(p)[static_cast<size_t>(pc.r0 + r) * p.ld + pc.c0 + col]
            : to_tile<T>(0.f);
  }
}

// Rows of the vector block a thread loads a piece: the block is a
// piece's L = TR rows of U (xt_multi) or TC rows of Z and c (x_cz_multi);
// thread t takes rows t + kThreads q, all S floats of each (contiguous in
// device memory when the block is), so a thread holds L / kThreads rows of
// S floats and one c each.
template <bool XT, class T>
constexpr int kLines =
    ((XT ? tile_rows<XT, T>() : tile_cols<XT, T>()) + kThreads - 1) /
    kThreads;

// This thread's rows of piece pc's vector block, from device memory (zero
// past the piece); with c, its c too.
template <bool XT, class T, int S>
__device__ __forceinline__ void load_vec(const Params& p,
                                         const Piece<XT, T>& pc,
                                         float (&v)[kLines<XT, T>][S],
                                         float (&cv)[kLines<XT, T>]) {
  constexpr int L = XT ? Piece<XT, T>::TR : Piece<XT, T>::TC;
#pragma unroll
  for (int q = 0; q < kLines<XT, T>; ++q) {
    const int at = threadIdx.x + q * kThreads;   // row (xt) or column (cz)
    const bool in = at < L && at < (XT ? pc.rows : pc.w);
    const long long row = XT ? pc.r0 + at : pc.c0 + at;
#pragma unroll
    for (int j = 0; j < S; ++j)
      v[q][j] = in ? __ldg(p.V + row * p.ldv + j) : 0.f;
    cv[q] = !XT && in && p.c ? __ldg(p.c + row) : 1.f;
  }
}

// The rows into the piece's buffer, rounded to T: c .* Z as cz[j][col]
// (x_cz_multi); U as u[j][row] (xt_multi, tensor cores) or u[row][j]
// (xt_multi, CUDA cores).
template <bool XT, class T, int S>
__device__ __forceinline__ void store_vec(T* buf,
                                          const float (&v)[kLines<XT, T>][S],
                                          const float (&cv)[kLines<XT, T>]) {
  constexpr int L = XT ? tile_rows<XT, T>() : tile_cols<XT, T>();
  constexpr int VP = vec_pitch<XT, T>();
#pragma unroll
  for (int q = 0; q < kLines<XT, T>; ++q) {
    const int at = threadIdx.x + q * kThreads;
    if (at < L) {
#pragma unroll
      for (int j = 0; j < S; ++j) {
        if constexpr (XT) {
          buf[use_mma<T>() ? j * VP + at : at * kern::kMaxCols + j] =
              to_tile<T>(v[q][j]);
        } else {
          // c .* Z rounded where it is formed (cv = 1 without c: Z alone)
          buf[j * VP + at] = to_tile<T>(cv[q] * v[q][j]);
        }
      }
    }
  }
}

// Tensor cores: 16-column tiles of an xt_multi piece a warp.
template <class T>
constexpr int kXtTiles = tile_cols<true, T>() / (16 * kWarps);
// CUDA cores: column quads of an xt_multi piece a thread; rows of an
// x_cz_multi piece a warp (its row slab).
template <class T>
constexpr int kXtQuads = tile_cols<true, T>() / (4 * kThreads);
template <class T>
constexpr int kSlabRows = tile_rows<false, T>() / kWarps;

// Sums a thread holds: x_cz_multi on the tensor cores one 16 x 8 tile (4),
// on the CUDA cores its slab's rows of S; xt_multi 4 a tile, or 4 S a
// quad of columns.
template <bool XT, class T, int S>
constexpr int kAcc = use_mma<T>() ? (XT ? 4 * kXtTiles<T> : 4)
                                  : (XT ? 4 * kXtQuads<T> * S
                                        : kSlabRows<T> * S);

// acc += the piece in `stage` times the staged vector block `buf`.
template <bool XT, class T, int S>
__device__ __forceinline__ void compute(const unsigned char* stage,
                                        const T* buf,
                                        float (&acc)[kAcc<XT, T, S>]) {
  constexpr int TR = tile_rows<XT, T>(), TC = tile_cols<XT, T>();
  constexpr int PITCH = row_pitch<XT, T>();
  constexpr int PE = PITCH / static_cast<int>(sizeof(T));
  constexpr int VP = vec_pitch<XT, T>();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  if constexpr (use_mma<T>() && !XT) {
    // rows [16 warp, 16 warp + 16) of the piece (the warps past TR / 16
    // have none); k-steps over its columns
    if (warp >= TR / 16) return;
    const uint32_t a_addr =
        smem_u32(stage) + (warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                              PITCH + 16 * (lane >> 4);
    const T* brow = buf + g * VP + 2 * t4;
#pragma unroll 4
    for (int kk = 0; kk < TC / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, a_addr + kk * 32);
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(brow + kk * 16);
      const uint32_t b1 =
          *reinterpret_cast<const uint32_t*>(brow + kk * 16 + 8);
      mma_bf16(acc, a, b0, b1);
    }
  } else if constexpr (use_mma<T>()) {
    // the warp's kXtTiles tiles of 16 columns of the piece; k-steps over
    // its rows, A = X^T through ldmatrix.trans
    constexpr int M = kXtTiles<T>;
    const uint32_t a_addr =
        smem_u32(stage) + ((lane & 7) + 8 * (lane >> 4)) * PITCH +
        (warp * 16 * M + 8 * ((lane >> 3) & 1)) * 2;
    const T* brow = buf + g * VP + 2 * t4;
#pragma unroll
    for (int kk = 0; kk < TR / 16; ++kk) {
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(brow + kk * 16);
      const uint32_t b1 =
          *reinterpret_cast<const uint32_t*>(brow + kk * 16 + 8);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        uint32_t a[4];
        ldmatrix_x4_trans(a, a_addr + kk * 16 * PITCH + m * 32);
        mma_bf16(acc + 4 * m, a, b0, b1);
      }
    }
  } else if constexpr (XT) {
    // column quads t + kThreads e, every row of the piece
    const T* tile = reinterpret_cast<const T*>(stage);
#pragma unroll 4
    for (int r = 0; r < TR; ++r) {
      float u[8];
      const float4 u0 = load4(buf + r * kern::kMaxCols, 0);
      u[0] = u0.x, u[1] = u0.y, u[2] = u0.z, u[3] = u0.w;
      if constexpr (S > 4) {
        const float4 u1 = load4(buf + r * kern::kMaxCols, 1);
        u[4] = u1.x, u[5] = u1.y, u[6] = u1.z, u[7] = u1.w;
      }
#pragma unroll
      for (int e = 0; e < kXtQuads<T>; ++e) {
        const float4 x = load4(tile + r * PE, threadIdx.x + kThreads * e);
        float* a = acc + 4 * S * e;
#pragma unroll
        for (int j = 0; j < S; ++j) {
          a[0 * S + j] += x.x * u[j];
          a[1 * S + j] += x.y * u[j];
          a[2 * S + j] += x.z * u[j];
          a[3 * S + j] += x.w * u[j];
        }
      }
    }
  } else {
    // the warp's row slab, column quads lane + 32 e
    constexpr int SR = kSlabRows<T>;
    const T* tile = reinterpret_cast<const T*>(stage) + warp * SR * PE;
#pragma unroll
    for (int e = 0; e < TC / 128; ++e) {
      const int quad = lane + 32 * e;
      float4 v[S];
#pragma unroll
      for (int j = 0; j < S; ++j) v[j] = load4(buf + j * VP, quad);
#pragma unroll
      for (int i = 0; i < SR; ++i) {
        const float4 x = load4(tile + i * PE, quad);
#pragma unroll
        for (int j = 0; j < S; ++j)
          acc[i * S + j] +=
              x.x * v[j].x + x.y * v[j].y + x.z * v[j].z + x.w * v[j].w;
      }
    }
  }
}

// Where a unit's sums go: the output (the unit lies wholly in [b0, b1)) or
// the CTA's scratch slot for it (dense_stream.cuh's unit_dst).
__device__ __forceinline__ float* unit_dst(const Params& p, long long base,
                                           int per_unit, long long b0,
                                           long long b1, float* whole,
                                           int unit_len) {
  if (base >= b0 && base + per_unit <= b1) return whole;
  const size_t slot =
      2 * static_cast<size_t>(blockIdx.x) + (base <= b0 ? 0 : 1);
  return p.scratch + slot * unit_len;
}

// The sums of a unit's segment to dst (the unit's rows or columns, s
// floats each, from its first), reset. Only rows < rows and columns < w
// of the piece are written.
template <bool XT, class T, int S>
__device__ __forceinline__ void write_unit(float (&acc)[kAcc<XT, T, S>],
                                           float* dst, int rows, int w) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  if constexpr (use_mma<T>()) {
    // tile m's sums: (row g, cols 2 t4, 2 t4 + 1) and row g + 8; a row is
    // a row of Y (x_cz_multi) or a column of X (xt_multi)
    constexpr int M = XT ? kXtTiles<T> : 1;
    const int lim = XT ? w : rows;
#pragma unroll
    for (int m = 0; m < M; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int at = (XT ? (warp * M + m) * 16 : warp * 16) + g + 8 * h;
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int j = 2 * t4 + b;
          if (at < lim && j < S) dst[at * S + j] = acc[4 * m + 2 * h + b];
          acc[4 * m + 2 * h + b] = 0.f;
        }
      }
    }
  } else if constexpr (XT) {
#pragma unroll
    for (int e = 0; e < 4 * kXtQuads<T>; ++e) {
      const int col = 4 * (threadIdx.x + kThreads * (e / 4)) + e % 4;
#pragma unroll
      for (int j = 0; j < S; ++j) {
        if (col < w) dst[col * S + j] = acc[e * S + j];
        acc[e * S + j] = 0.f;
      }
    }
  } else {
    // the slab's sums over the warp's lanes, in a fixed order
#pragma unroll
    for (int i = 0; i < kSlabRows<T>; ++i) {
#pragma unroll
      for (int j = 0; j < S; ++j) {
        float s = acc[i * S + j];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        const int r = warp * kSlabRows<T> + i;
        if (lane == 0 && r < rows) dst[r * S + j] = s;
        acc[i * S + j] = 0.f;
      }
    }
  }
}

template <bool XT, bool BULK, class T, int S>
__global__ void __launch_bounds__(kThreads + 32, 1)
    multi_kernel(const Params p) {
  constexpr int TR = tile_rows<XT, T>(), TC = tile_cols<XT, T>();
  constexpr int NV = kLines<XT, T>;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  unsigned char* vbuf = smem + kBarrierBytes;
  unsigned char* ring = smem + p.ring_off;
  const long long b0 = bound(p, blockIdx.x), b1 = bound(p, blockIdx.x + 1);
  if (b0 >= b1) return;                 // empty range: nothing to write
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // zeros over the vector buffers and the ring (the stage bytes a ragged
  // piece leaves, the vector rows past s), fenced before the copies
  {
    const int end = p.ring_off + p.stages * stage_bytes<XT, T>();
    for (int at = kBarrierBytes + 16 * static_cast<int>(threadIdx.x);
         at < end; at += 16 * static_cast<int>(blockDim.x))
      *reinterpret_cast<uint4*>(smem + at) = make_uint4(0u, 0u, 0u, 0u);
    fence_proxy_async();
  }
  Piece<XT, T> pc(p, b0);               // the piece computed
  int stage = 0, phase = 0;             // its stage and that stage's parity
  if (BULK && threadIdx.x == 0) {
    for (int st = 0; st < p.stages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (BULK && warp == kWarps) {         // the producer warp
    const uint64_t policy = evict_first_policy();
    for (long long t = b0; t < b1; ++t) {
      if (t - b0 >= p.stages) mbar_wait(&empty[stage], phase ^ 1);
      issue<XT, T>(p, pc, ring + static_cast<size_t>(stage) *
                                     stage_bytes<XT, T>(),
                   &full[stage], policy, lane);
      if (++stage == p.stages) {
        stage = 0;
        phase ^= 1;
      }
      pc.next(p);
    }
    return;
  }

  float acc[kAcc<XT, T, S>];
#pragma unroll
  for (int i = 0; i < kAcc<XT, T, S>; ++i) acc[i] = 0.f;
  float v[NV][S], cv[NV];
  load_vec<XT, T, S>(p, pc, v, cv);

  for (long long t = b0; t < b1; ++t) {
    unsigned char* st = ring + static_cast<size_t>(stage) *
                                   stage_bytes<XT, T>();
    T* buf = reinterpret_cast<T*>(vbuf + (t & 1) * vec_buffer_bytes<XT, T>());
    if (!BULK) {
      consumers_sync();                 // all done with the one stage
      load_tile<XT, T>(p, pc, st);
    }
    store_vec<XT, T, S>(buf, v, cv);
    if (t + 1 < b1) {                   // the next piece's block, in flight
      Piece<XT, T> nx = pc;             // while this one is computed
      nx.next(p);
      load_vec<XT, T, S>(p, nx, v, cv);
    }
    consumers_sync();                   // the block (and direct: the tile)
    if (BULK) mbar_wait(&full[stage], phase);
    compute<XT, T, S>(st, buf, acc);

    if (pc.pos + 1 == pc.per_unit || t + 1 == b1) {   // the segment's end
      const long long base = t - pc.pos;
      const int unit_len = (XT ? TC : TR) * S;
      write_unit<XT, T, S>(
          acc,
          unit_dst(p, base, pc.per_unit, b0, b1,
                   p.out + static_cast<size_t>(XT ? pc.c0 : pc.r0) * S,
                   unit_len),
          pc.rows, pc.w);
    }
    if (BULK) {                         // the warp is done with the stage
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == p.stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    pc.next(p);
  }
}

// The fix-up: grid (ctas - 1, blocks of kFixupThreads x kFixupPer outputs
// of a unit). Block (k, y) takes range boundary bound(k + 1); the first
// boundary inside a unit (after its first piece) gets the unit's outputs
// of block y the sum of its partials in CTA order: dense_stream.cuh's
// fixup_kernel (one block a boundary, which walks a unit of 1024 s floats
// about 7 us a column of xt_multi), with a unit's outputs spread over
// blocks and a thread's kFixupPer loads issued together (one output a
// thread made so many blocks, most of them returning at once, that their
// launch alone took 44 us at s = 8). Separate from dense_stream.cuh's so
// that K3 / K4 keep theirs.
__global__ void __launch_bounds__(kFixupThreads)
    fixup_kernel(const Params p, int per_unit, int unit_len, int total) {
  const long long b = bound(p, blockIdx.x + 1);
  const int i = static_cast<int>(b / per_unit);       // the unit b lies in
  const long long base = static_cast<long long>(i) * per_unit;
  if (b == base || bound(p, blockIdx.x) > base) return;
  const int len =
      static_cast<int>(min(static_cast<long long>(unit_len),
                           total - static_cast<long long>(i) * unit_len));
  const int e0 = blockIdx.y * kFixupThreads * kFixupPer + threadIdx.x;
  // the owners of the unit's first and last piece (dense_stream.cuh's
  // owner: the largest k with bound(k) <= t)
  const int k0 = static_cast<int>(((base + 1) * p.ctas - 1) / p.pieces);
  const int k1 =
      static_cast<int>(((base + per_unit) * p.ctas - 1) / p.pieces);
  // CTA k0 holds the unit in slot 1 unless its range starts in the unit;
  // the CTAs after it do, in slot 0
  const float* first = p.scratch + (2 * static_cast<size_t>(k0) +
                                    (bound(p, k0) >= base ? 0 : 1)) *
                                       unit_len;
  float s[kFixupPer];
#pragma unroll
  for (int j = 0; j < kFixupPer; ++j) {
    const int e = e0 + j * kFixupThreads;
    s[j] = e < len ? first[e] : 0.f;
  }
  const bool sparse = p.pieces < p.ctas;   // ranges of one piece or none
  for (long long t = sparse ? base + 1 : k0 + 1;
       t <= (sparse ? base + per_unit - 1 : k1); ++t) {
    const int k = sparse ? static_cast<int>(((t + 1) * p.ctas - 1) / p.pieces)
                         : static_cast<int>(t);
    const float* part = p.scratch + 2 * static_cast<size_t>(k) * unit_len;
#pragma unroll
    for (int j = 0; j < kFixupPer; ++j) {
      const int e = e0 + j * kFixupThreads;
      if (e < len) s[j] += part[e];
    }
  }
  float* out = p.out + static_cast<size_t>(i) * unit_len;
#pragma unroll
  for (int j = 0; j < kFixupPer; ++j) {
    const int e = e0 + j * kFixupThreads;
    if (e < len) out[e] = s[j];
  }
}

template <bool XT, bool BULK, class T, int S>
cudaError_t launch(const Params& p, size_t smem, cudaStream_t stream) {
  auto kernel = multi_kernel<XT, BULK, T, S>;
  cudaError_t err = kern::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<p.ctas, BULK ? kThreads + 32 : kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The instance for the call's s (each s in 1 .. kMaxCols its own).
template <bool XT, bool BULK, class T>
cudaError_t by_cols(const Params& p, size_t smem, cudaStream_t stream) {
  switch (p.s) {
    case 1: return launch<XT, BULK, T, 1>(p, smem, stream);
    case 2: return launch<XT, BULK, T, 2>(p, smem, stream);
    case 3: return launch<XT, BULK, T, 3>(p, smem, stream);
    case 4: return launch<XT, BULK, T, 4>(p, smem, stream);
    case 5: return launch<XT, BULK, T, 5>(p, smem, stream);
    case 6: return launch<XT, BULK, T, 6>(p, smem, stream);
    case 7: return launch<XT, BULK, T, 7>(p, smem, stream);
    case 8: return launch<XT, BULK, T, 8>(p, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The arguments of an entry point: X, its vector block and the scratch
// present, the shape positive, s in 1 .. kMaxCols, and the piece the
// caller's split assumes the header's.
template <bool XT, class T>
bool valid_args(const T* X, long long ld, const float* V, long long ldv,
                const float* out, const float* scratch, int d, int n, int s,
                int ctas, int tile_rows_, int tile_cols_) {
  return X && V && out && scratch && d > 0 && n > 0 && ld >= n && s > 0 &&
         s <= kern::kMaxCols && ldv >= s && ctas > 0 &&
         tile_rows_ == tile_rows<XT, T>() && tile_cols_ == tile_cols<XT, T>();
}

// Plan the call (bulk path and ring, or direct path), launch the kernel
// and the fix-up, and report the path.
template <bool XT, class T>
cudaError_t run(const T* X, long long ld, const float* V, long long ldv,
                const float* c, float* out, float* scratch, int d, int n,
                int s, int ctas, int* path, cudaStream_t stream) {
  Params p{};
  p.X = X;
  p.ld = ld;
  p.V = V;
  p.ldv = ldv;
  p.c = c;
  p.out = out;
  p.scratch = scratch;
  p.d = d;
  p.n = n;
  p.s = s;
  p.ctas = ctas;
  p.groups = (d + tile_rows<XT, T>() - 1) / tile_rows<XT, T>();
  p.chunks = (n + tile_cols<XT, T>() - 1) / tile_cols<XT, T>();
  p.pieces = static_cast<long long>(p.groups) * p.chunks;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  p.ring_off = kBarrierBytes + 2 * vec_buffer_bytes<XT, T>();
  const long long fit = (optin - p.ring_off) / stage_bytes<XT, T>();
  // rows of whole 16-byte units: n and ld multiples of 4 at f32, 8 at bf16
  constexpr int kPerUnit = 16 / static_cast<int>(sizeof(T));
  const bool bulk = n % kPerUnit == 0 && ld % kPerUnit == 0 &&
                    aligned16(X) && fit >= 2;
  p.stages = bulk ? static_cast<int>(min(fit, 1LL * kMaxStages)) : 1;
  const size_t smem =
      p.ring_off + static_cast<size_t>(p.stages) * stage_bytes<XT, T>();
  err = bulk ? by_cols<XT, true, T>(p, smem, stream)
             : by_cols<XT, false, T>(p, smem, stream);
  if (err != cudaSuccess) return err;
  if (ctas > 1) {
    // units of TC s (xt_multi) or TR s (x_cz_multi) floats
    const int unit_len = (XT ? tile_cols<XT, T>() : tile_rows<XT, T>()) * s;
    const dim3 grid(ctas - 1, (unit_len + kFixupThreads * kFixupPer - 1) /
                                  (kFixupThreads * kFixupPer));
    fixup_kernel<<<grid, kFixupThreads, 0, stream>>>(
        p, XT ? p.groups : p.chunks, unit_len, (XT ? n : d) * s);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess && path) *path = bulk ? kBulk : kDirect;
  return err;
}

}  // namespace dmulti
