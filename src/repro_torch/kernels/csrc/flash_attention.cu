// Flash attention (prefill) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention (_flash_kernel). On the model zoo's main path it is the
// self-attention of every layer of a prefill forward (models/attention.py
// attention_block): one launch per layer.
//
// What it computes: o = softmax(q k^T * scale, masked) v per (batch,
// q-head), q (B, Hq, S, Dh), k/v (B, Hkv, T, Dh), Hq % Hkv == 0 (GQA:
// q-head h reads kv-head h / (Hq / Hkv), and grouped K/V are never
// repeated in memory). Each of q, k, v and o is addressed by its own
// (batch, head, row) strides, the last dimension's being 1, so a
// (B, S, H, Dh) tensor seen as (B, H, S, Dh) is read and written where it
// lies. Positions run from 0 for q and k alike; a key is attended when
// k_pos < kv_len, and diff = q_pos - k_pos >= 0 (causal) and diff < window
// (window > 0). Inputs f32 or bf16; scores, softmax statistics and the
// accumulator f32; output in the input dtype. A masked score never
// contributes (p = 0), and the denominator is floored at 1e-30, so a row
// with no key to attend is 0, never NaN. Dh is 32, 64, 80 or 128. S and T are
// taken as they are: the ragged last q tile and the rows past T or kv_len
// are masked here, nothing is padded.
//
// Design: the TPU grid swept the kv blocks in order (nk fastest) against
// VMEM scratch carried from step to step. Here a CTA owns q tiles of one
// (q-head, batch) and loops over kv tiles itself, with the running max,
// denominator and accumulator of its rows in registers (f32). The loop
// covers only the kv tiles a q tile can attend, the TPU kernel's
// `relevant` test: causal stops at the tile's last row, a window starts
// at q_start - window + 1, and kv_len ends it. No atomics and a fixed
// order of sums: each result repeats bit for bit. Two kernels:
//
//  * bf16 (the model's dtype), flash_wgmma_kernel: warp-specialised, on
//    wgmma and TMA. 384 threads: two consumer warpgroups of 64 q rows
//    (a q tile of 128 rows) and a producer warpgroup, whose first thread
//    issues every load by TMA over 4-D tensor maps (Dh, rows, heads,
//    batch) that swizzle the tiles for wgmma. A CTA takes two q tiles of
//    one (q-head, batch), the x-th longest under causal and the x-th
//    shortest, so that every CTA attends about the same number of kv
//    tiles and the second tile's loads run behind the first's products;
//    both Q tiles are loaded at once, then the K and V tiles of 128 keys
//    of each q tile in turn into a ring of kStages = 2 stages. K and V of
//    a stage each have a full barrier (TMA byte counts) and an empty one
//    that the 8 consumer warps arrive on, so a K slot is refilled as
//    soon as its scores are computed. setmaxnreg moves the producer
//    warpgroup's registers to the consumers (168 -> 24 and 240 a
//    thread). A consumer warpgroup computes its 64 x 128 block of
//    S = Q K^T by wgmma m64n128k16 with both operands in shared memory
//    (Q and K are K-major as they lie), runs the online softmax on the
//    accumulator registers in exp2 units (the scale folded into one FFMA
//    a score, 2^x in one MUFU.EX2), rounds P to bf16 (F6) in the register
//    layout of a wgmma A operand, and adds O += P V by wgmma m64nDhk16
//    with A = P from registers and B = V in shared memory. The products
//    overlap the softmax twice over: kv tile j + 1's Q K^T and tile j's
//    P V are in flight while tile j + 1's softmax runs, and the two
//    warpgroups take turns to issue their products (two named barriers),
//    so that one's softmax runs while the other's products do
//    (FlashAttention-3's ping-pong). Only the tiles whose keys some row
//    of the warpgroup must not attend (the causal diagonal, a window's
//    first tiles, the kv_len or T edge) evaluate the mask, and O is
//    rescaled only when a row's max moved. The output goes from the
//    accumulator registers to device memory, 4 bytes a lane.
//  * f32 (the consistency checks' dtype), flash_f32_kernel: CUDA cores.
//    64 q rows and 256 threads a CTA, 4 per q row, the CTAs of the last
//    (under causal, longest) q tiles first; thread r of a row holds
//    the row's q (pre-scaled by scale * log2 e) and output for the
//    columns 16 i + 4 r .. + 3; K and V tiles of 64 keys in f32 shared
//    memory (64 KB at Dh = 128, opted into above 48 KB); per 16 keys the
//    partial dots are summed over the row's 4 threads by xor shuffles,
//    then one online-softmax update. A warp reads one K or V row at a
//    time, 64 contiguous bytes broadcast to its 8 rows: no bank conflicts.
//
// What was hard in the bf16 kernel, and how it is resolved:
//  * The tensor-map encoder, cuTensorMapEncodeTiled, lives in libcuda,
//    not in the runtime. It is reached through cudaGetDriverEntryPoint,
//    so the library links no -lcuda; the three maps are encoded on the
//    host on every call (the pointers change) and passed as
//    __grid_constant__ kernel parameters. Rows past S or T are out of
//    the map's bounds and arrive as zeros, never from the next head.
//  * Swizzle and box width. A 128-byte swizzle spans 64 bf16, so a tile of
//    Dh = 128 is two boxes ("panels") of 64 columns, each a column of
//    1024-byte swizzle atoms (8 rows x 128 B). Q K^T steps across the
//    panels k-step by k-step (32 bytes into an atom's row, then the next
//    panel); P V reaches the second panel through the descriptor's leading
//    byte offset (V is MN-major: the transpose bit, leading offset = the
//    panel stride, stride offset = 8 keys). Dh = 32 (64-byte rows) takes
//    the 64-byte swizzle and 512-byte atoms. Every tile starts on 1024 B.
//  * A Dh that is not a multiple of 64 (zamba2's 80). Its tiles take the
//    layout of the next multiple, Plan::kWidth (128 at Dh = 80: two
//    64-column panels, the 128-byte swizzle). The tensor maps' inner
//    extent stays Dh, so the second panel's box reads columns 64-79 and
//    TMA fills columns 80-127 with zeros (the full box's bytes still
//    complete the barrier). Q K^T takes Dh / 16 k-steps (5), so it never
//    reads the fill; P V runs at N = kWidth over it, and the epilogue
//    stores only O's first Dh columns. The cost: P V at 128 / 80 of its
//    work and the accumulator of Dh = 128. A native 64 + 16 layout (a
//    second panel of 32-byte rows) would save that work, but needs a
//    third swizzle mode, mixed descriptors in one product and an n80
//    wgmma; this one reuses the Dh = 128 path as it is.
//  * Fragment layouts. The m64nN accumulator gives warp w of a warpgroup
//    rows 16 w + lane / 4 (+ 8) and, in column tile n, columns
//    8 n + 2 (lane % 4) (+ 1): the m16n8 layout repeated N / 8 times. For
//    16-bit types that is also wgmma's register A layout, so P's A operand
//    for keys 16 j .. 16 j + 15 is S's column tiles 2 j and 2 j + 1, pairs
//    of f32 packed to one bf16x2, in FlashAttention-3's order.
//  * Masks on the accumulator layout: row and key of each register come
//    from that mapping (softmax_tile), not from mma.sync's m16n8.
//  * Shared memory: at Dh = 128, two Q tiles of 32 KB plus 2 stages of K
//    and V at 32 KB each, 192 KB (opted into above 48 KB). A third stage
//    measured no faster with one Q tile (PERF.md).
//  * setmaxnreg moves registers only within the CTA: a lone producer warp
//    (288 threads) left the consumers' increase waiting forever, so the
//    producer is a whole warpgroup, and the launch refuses a build whose
//    register count would not cover the increase.
//  * The profiler name: chip_smoke.py finds K11's device time by the
//    kernel names flash_wgmma_kernel and flash_f32_kernel.
//
// Bound: operations. A causal prefill at (4, 16, 4096, 128) attends 537 M
// (q, k) pairs at 4 Dh flops each, 275 GFLOP: 0.28 ms at the card's 989
// TFLOP/s of bf16 tensor-core rate, against 268 MB of q, k, v and o in
// bf16 (0.08 ms at 3.35 TB/s); in f32, 4.1 ms at the 67 TFLOP/s of the
// CUDA cores.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;      // the TPU kernel's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

// Element strides of a (B, H, rows, Dh) tensor; the last dimension's is 1.
struct Layout {
  long long b, h, r;
};

__device__ __forceinline__ bool attended(int qpos, int kpos, int kv_len,
                                         int causal, int window) {
  const int diff = qpos - kpos;
  return kpos < kv_len && (!causal || diff >= 0) &&
         (window <= 0 || diff < window);
}

// The kv tiles [first, end) of COLS keys that ROWS q rows starting at
// q_start can attend (end <= first: none).
template <int ROWS, int COLS>
__device__ __forceinline__ void kv_tiles(int q_start, int T_len, int kv_len,
                                         int causal, int window, int* first,
                                         int* end) {
  int k_end = min(T_len, kv_len);
  if (causal) k_end = min(k_end, q_start + ROWS);
  const int k_begin = window > 0 ? max(0, q_start - window + 1) : 0;
  *first = k_begin / COLS;
  *end = (k_end + COLS - 1) / COLS;
}

// 2^x in one MUFU.EX2 (flushing results below 2^-126 to 0), where exp2f
// adds instructions for subnormal results: the softmax issues 64 a
// thread and tile, and they are on its critical path.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// bf16: wgmma, TMA, a producer warpgroup and two consumer warpgroups
// ---------------------------------------------------------------------------

constexpr int kWgRows = 64;            // q rows per consumer warpgroup (M)
constexpr int kConsumers = 2;          // consumer warpgroups a CTA
constexpr int kCtaRows = kWgRows * kConsumers;
constexpr int kTileN = 128;            // keys per K / V tile
constexpr int kStages = 2;             // depth of the K / V ring
constexpr int kQTiles = 2;             // q tiles a CTA (a long, a short)
constexpr int kWgThreads = 128;
constexpr int kWgmmaThreads = (kConsumers + 1) * kWgThreads;  // + producer
// setmaxnreg moves registers only inside the CTA: launched at 168 a
// thread (384 x 168 = 64,512), the producer warpgroup gives 144 each so
// that the consumers reach 240 (256 x 240 + 128 x 24 = 64,512)
constexpr int kConsumerRegs = 240;
constexpr int kProducerRegs = 24;

// Shared-memory plan of one CTA for head dim DH, in bytes. A tile is
// kPanels panels of kPanel columns, each rows x kRowBytes, swizzled; it
// holds kWidth >= DH columns, those past DH zero (TMA's fill).
template <int DH>
struct Plan {
  static constexpr int kPanel = DH < 64 ? DH : 64;
  static constexpr int kPanels = (DH + kPanel - 1) / kPanel;
  static constexpr int kWidth = kPanels * kPanel;      // O's accumulator
  static_assert(DH % 16 == 0 && kWidth >= DH && kWidth - DH < kPanel &&
                    (kPanel == 32 || kPanel == 64) &&
                    (kWidth == 32 || kWidth == 64 || kWidth == 128),
                "the panels must cover Dh in 16-column k-steps, with a "
                "swizzle mode and a wgmma_rs instance for their width");
  static constexpr int kRowBytes = 2 * kPanel;         // 128, or 64 at Dh 32
  static constexpr int kAtom = 8 * kRowBytes;          // 8 rows of a panel
  static constexpr uint64_t kSwizzle = kRowBytes == 128 ? 1 : 2;  // desc.
  static constexpr int kQPanel = kCtaRows * kRowBytes;
  static constexpr int kKVPanel = kTileN * kRowBytes;
  static constexpr int kQ = kPanels * kQPanel;
  static constexpr int kKV = kPanels * kKVPanel;
  static constexpr int kTiles = kQTiles * kQ + 2 * kStages * kKV;
  static constexpr int kBarriers = kQTiles + 4 * kStages;
  static constexpr size_t kBytes = 1024 + kTiles + 8 * kBarriers;  // 1024:
                                                                   // align
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// Arrive once and expect `bytes` of TMA transfers on the barrier.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Wait until the barrier's phase of the given parity has completed. A
// wait of more than about ten seconds traps (a launch error) rather than
// hang the card.
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

// TMA: the box at (c0, c1, c2, c3) of a 4-D tensor map into shared memory,
// completing `bar`'s expected bytes.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle mode (1: 128 B, 2: 64 B).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t swizzle) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | swizzle << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Named barrier `id` (1 + a consumer warpgroup) over both consumer
// warpgroups: sync waits for the other's arrival, arrive signals it.
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "n"(kConsumers * kWgThreads)
               : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id),
               "n"(kConsumers * kWgThreads) : "memory");
}

// Wait until at most N of this warpgroup's commit groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Keeps the compiler from moving accesses of an accumulator across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
// ... and keeps an A operand's registers alive until its product is done.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j]) :: "memory");
}

// D (64 x N, f32) += A (64 x 16, bf16 in registers) B (16 x N), B MN-major
// in shared memory (the transpose bit).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b);

// D (64 x 128, f32) (+)= A (64 x 16) B (16 x 128)^T, both K-major in
// shared memory; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
      "%58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
      "%58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


// One kv tile's online-softmax update for a consumer thread's two rows:
// update the running max (in log2 units) and sum, return the
// accumulator's correction factors, and leave P in S's registers (f32),
// 0 where MASK drops a score. The max of the scaled scores is the scale
// times the max (POS: scale >= 0) or the min of the raw ones, so each
// score costs one FFMA and one MUFU.EX2. Register 4 n + e of S holds row
// (e < 2 ? row0 : row1) and key kcol + 8 n + (e & 1).
template <bool MASK, bool POS>
__device__ __forceinline__ void softmax_tile(
    float (&s)[kTileN / 2], float& m0, float& m1, float& l0, float& l1,
    float& c0, float& c1, int row0, int row1, int kcol, int kv_len,
    int causal, int window, float scale_log2) {
  constexpr int NT = kTileN / 8;
  constexpr float kFar = POS ? kNegInf : -kNegInf;   // never the extreme
  const auto pick = [](float a, float b) {
    return POS ? fmaxf(a, b) : fminf(a, b);
  };
  uint64_t valid = 0;
  float r0 = kFar, r1 = kFar;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (MASK) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = attended(e < 2 ? row0 : row1, kcol + 8 * n + (e & 1),
                                 kv_len, causal, window);
        valid |= ok ? uint64_t{1} << (4 * n + e) : uint64_t{0};
        s[4 * n + e] = ok ? s[4 * n + e] : kFar;
      }
    }
    r0 = pick(r0, pick(s[4 * n], s[4 * n + 1]));
    r1 = pick(r1, pick(s[4 * n + 2], s[4 * n + 3]));
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    r0 = pick(r0, __shfl_xor_sync(0xffffffffu, r0, off));
    r1 = pick(r1, __shfl_xor_sync(0xffffffffu, r1, off));
  }
  const float mn0 = fmaxf(m0, r0 * scale_log2);
  const float mn1 = fmaxf(m1, r1 * scale_log2);
  c0 = ex2(m0 - mn0);
  c1 = ex2(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int i = 0; i < 4 * NT; ++i) {
    const bool lo = (i & 3) < 2;
    const float p = !MASK || ((valid >> i) & 1u)
                        ? ex2(fmaf(s[i], scale_log2, lo ? -mn0 : -mn1))
                        : 0.f;
    s[i] = p;
    if (lo) ps0 += p; else ps1 += p;
  }
  l0 = l0 * c0 + ps0;
  l1 = l1 * c1 + ps1;
}

// P (f32, S's accumulator layout) to bf16 in wgmma's register A layout:
// the A operand for keys 16 j .. 16 j + 15 is S's column tiles 2 j, 2 j + 1.
__device__ __forceinline__ void pack_p(const float (&s)[kTileN / 2],
                                       uint32_t (&pa)[kTileN / 16][4]) {
#pragma unroll
  for (int j = 0; j < kTileN / 16; ++j) {
    pa[j][0] = pack_bf16(s[8 * j], s[8 * j + 1]);
    pa[j][1] = pack_bf16(s[8 * j + 2], s[8 * j + 3]);
    pa[j][2] = pack_bf16(s[8 * j + 4], s[8 * j + 5]);
    pa[j][3] = pack_bf16(s[8 * j + 6], s[8 * j + 7]);
  }
}

// Issue S = Q K^T for a warpgroup (one commit group): Dh / 16 k-steps,
// 32 bytes into an atom's row each, the next panel every kPanel / 16.
template <int DH>
__device__ __forceinline__ void issue_qk(float (&s)[kTileN / 2],
                                         uint32_t q_addr, uint32_t k_addr) {
  using P = Plan<DH>;
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const int p = kk / (P::kPanel / 16);
    const uint32_t off = (kk % (P::kPanel / 16)) * 32u;
    wgmma_ss_n128(
        s, gmma_desc(q_addr + p * P::kQPanel + off, 16, P::kAtom, P::kSwizzle),
        gmma_desc(k_addr + p * P::kKVPanel + off, 16, P::kAtom, P::kSwizzle),
        kk > 0);
  }
  wgmma_commit();
}

// Issue O += P V (one commit group): 16 keys (two 8-key atoms) a k-step;
// V's second 64-column panel through the leading byte offset. N is the
// tile's width, the zero columns past Dh included.
template <int DH>
__device__ __forceinline__ void issue_pv(float (&acc)[Plan<DH>::kWidth / 2],
                                         const uint32_t (&pa)[kTileN / 16][4],
                                         uint32_t v_addr) {
  using P = Plan<DH>;
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < kTileN / 16; ++j)
    wgmma_rs<P::kWidth>(acc, pa[j],
                 gmma_desc(v_addr + j * 2 * P::kAtom, P::kKVPanel, P::kAtom,
                           P::kSwizzle));
  wgmma_commit();
}

// O *= the rows' corrections; skipped when no row of the warp has a new
// max (c = 1), as in most tiles past the first few.
template <int DH>
__device__ __forceinline__ void rescale(float (&acc)[Plan<DH>::kWidth / 2],
                                        float c0, float c1) {
  if (!__any_sync(0xffffffffu, c0 != 1.f || c1 != 1.f)) return;
#pragma unroll
  for (int dn = 0; dn < Plan<DH>::kWidth / 8; ++dn) {
    acc[4 * dn] *= c0;
    acc[4 * dn + 1] *= c0;
    acc[4 * dn + 2] *= c1;
    acc[4 * dn + 3] *= c1;
  }
}

template <int DH>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       __nv_bfloat16* __restrict__ o, Layout ol, int S,
                       int T_len, int group, int kv_len, int causal,
                       int window, float scale_log2) {
  using P = Plan<DH>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + P::kTiles);
  uint64_t* q_full = bars;                  // Q tile j arrived
  uint64_t* k_full = q_full + kQTiles;      // K / V tile of a stage arrived
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;     // ... and consumed
  uint64_t* v_empty = k_empty + kStages;
  auto q_tile = [&](int j) { return smem + j * P::kQ; };
  auto k_tile = [&](int st) {
    return smem + kQTiles * P::kQ + st * 2 * P::kKV;
  };

  // This CTA's q tiles: the x-th longest of its (q-head, batch) and the
  // x-th shortest, so that under causal every CTA attends about the same
  // number of kv tiles, and the second tile's loads run behind the first
  // tile's products. With an odd count the middle tile is alone.
  const int h = blockIdx.y, b = blockIdx.z;
  const int nqt = (S + kCtaRows - 1) / kCtaRows;
  const int qa = nqt - 1 - blockIdx.x, qb = blockIdx.x;
  const int nq = qb < qa ? 2 : 1;
  int first[kQTiles], count[kQTiles], turns = 0;
#pragma unroll
  for (int j = 0; j < kQTiles; ++j) {
    int end;
    kv_tiles<kCtaRows, kTileN>((j == 0 ? qa : qb) * kCtaRows, T_len, kv_len,
                               causal, window, &first[j], &end);
    count[j] = j < nq ? max(0, end - first[j]) : 0;
    turns += count[j];
  }

  if (threadIdx.x == 0) {
    for (int j = 0; j < kQTiles; ++j) mbar_init(&q_full[j], 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&k_full[st], 1);
      mbar_init(&v_full[st], 1);
      mbar_init(&k_empty[st], 4 * kConsumers);   // one arrival a warp
      mbar_init(&v_empty[st], 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kWgThreads;
  if (wg == kConsumers) {
    // producer warpgroup: its first thread issues every load: both Q
    // tiles, then the kv tiles of each through the ring, K and V of a
    // stage each as soon as the consumers have released it
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs));
    if (threadIdx.x == kConsumers * kWgThreads) {
      for (int j = 0; j < nq; ++j) {
        mbar_expect_tx(&q_full[j], P::kQ);
#pragma unroll
        for (int p = 0; p < P::kPanels; ++p)
          tma_load_4d(q_tile(j) + p * P::kQPanel, &tq, &q_full[j],
                      p * P::kPanel, (j == 0 ? qa : qb) * kCtaRows, h, b);
      }
      int it = 0;                             // the ring's running count
      for (int j = 0; j < nq; ++j) {
        const int n = j == 0 ? count[0] : count[1];
        const int kt0 = j == 0 ? first[0] : first[1];
        for (int i = 0; i < n; ++i, ++it) {
          const int st = it % kStages;
          const uint32_t vacant = ((it / kStages) & 1) ^ 1;
          const int k0 = (kt0 + i) * kTileN;
          mbar_wait(&k_empty[st], vacant);
          mbar_expect_tx(&k_full[st], P::kKV);
#pragma unroll
          for (int p = 0; p < P::kPanels; ++p)
            tma_load_4d(k_tile(st) + p * P::kKVPanel, &tk, &k_full[st],
                        p * P::kPanel, k0, h / group, b);
          mbar_wait(&v_empty[st], vacant);
          mbar_expect_tx(&v_full[st], P::kKV);
#pragma unroll
          for (int p = 0; p < P::kPanels; ++p)
            tma_load_4d(k_tile(st) + P::kKV + p * P::kKVPanel, &tv,
                        &v_full[st], p * P::kPanel, k0, h / group, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(kConsumerRegs));
    const int warp = (threadIdx.x % kWgThreads) / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int kv_end = min(T_len, kv_len);
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // the two warpgroups take turns to issue their products, so that one's
    // softmax runs while the other's products do (warpgroup 0 first)
    auto my_turn = [&] { bar_sync(1 + wg); };
    auto your_turn = [&] { bar_arrive(2 - wg); };
    if (wg == 1 && turns > 0) bar_arrive(1);

    int base = 0;                             // ring count at tile j's start
    for (int j = 0; j < nq; ++j) {
      // consumer warpgroup wg: q rows [wrow, wrow + 64) of q tile j
      const int n = j == 0 ? count[0] : count[1];
      const int kt0 = j == 0 ? first[0] : first[1];
      const int wrow = (j == 0 ? qa : qb) * kCtaRows + wg * kWgRows;
      const int row0 = wrow + 16 * warp + g, row1 = row0 + 8;
      const uint32_t q_addr =
          smem_u32(q_tile(j)) + wg * kWgRows * P::kRowBytes;
      float s[kTileN / 2], acc[P::kWidth / 2];
#pragma unroll
      for (int i = 0; i < kTileN / 2; ++i) s[i] = 0.f;
#pragma unroll
      for (int i = 0; i < P::kWidth / 2; ++i) acc[i] = 0.f;
      float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
      float c0 = 1.f, c1 = 1.f;               // O's pending correction
      uint32_t pa[kTileN / 16][4];
      // softmax of kv tile i: the mask only where some (row, key) of this
      // warpgroup and tile falls outside it
      auto softmax = [&](int i) {
        const int k0 = (kt0 + i) * kTileN;
        const bool masked = k0 + kTileN > kv_end ||
                            (causal && k0 + kTileN - 1 > wrow) ||
                            (window > 0 && wrow + kWgRows - 1 - k0 >= window);
        const int kcol = k0 + 2 * t;
        if (scale_log2 >= 0.f) {
          if (masked)
            softmax_tile<true, true>(s, m0, m1, l0, l1, c0, c1, row0, row1,
                                     kcol, kv_len, causal, window,
                                     scale_log2);
          else
            softmax_tile<false, true>(s, m0, m1, l0, l1, c0, c1, row0, row1,
                                      kcol, kv_len, causal, window,
                                      scale_log2);
        } else {
          softmax_tile<true, false>(s, m0, m1, l0, l1, c0, c1, row0, row1,
                                    kcol, kv_len, causal, window, scale_log2);
        }
      };
      auto stage = [&](int i) { return (base + i) % kStages; };
      auto phase = [&](int i) { return ((base + i) / kStages) & 1; };
      mbar_wait(&q_full[j], 0);

      // kv tile i's S = Q K^T runs while this warpgroup's tensor cores
      // still add tile i - 1's P V, and the softmax of tile i overlaps
      // that product: FlashAttention-3's intra-warpgroup pipelining.
      if (n > 0) {
        mbar_wait(&k_full[stage(0)], phase(0));
        my_turn();
        issue_qk<DH>(s, q_addr, smem_u32(k_tile(stage(0))));
        your_turn();
        wgmma_wait<0>();
        fence_regs(s);
        release(&k_empty[stage(0)]);
        softmax(0);
        pack_p(s, pa);
      }
      for (int i = 1; i < n; ++i) {
        const int st = stage(i), sp = stage(i - 1);
        mbar_wait(&k_full[st], phase(i));
        my_turn();
        issue_qk<DH>(s, q_addr, smem_u32(k_tile(st)));
        rescale<DH>(acc, c0, c1);
        mbar_wait(&v_full[sp], phase(i - 1));
        issue_pv<DH>(acc, pa, smem_u32(k_tile(sp) + P::kKV));
        your_turn();
        wgmma_wait<1>();                      // S of tile i
        fence_regs(s);
        release(&k_empty[st]);
        softmax(i);
        wgmma_wait<0>();                      // P V of tile i - 1
        fence_regs(acc);
        fence_regs(pa);
        release(&v_empty[sp]);
        pack_p(s, pa);
      }
      if (n > 0) {
        const int sp = stage(n - 1);
        rescale<DH>(acc, c0, c1);
        mbar_wait(&v_full[sp], phase(n - 1));
        my_turn();
        issue_pv<DH>(acc, pa, smem_u32(k_tile(sp) + P::kKV));
        your_turn();
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(pa);
        release(&v_empty[sp]);
      }
      base += n;

#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      const float inv0 = 1.f / fmaxf(l0, 1e-30f);
      const float inv1 = 1.f / fmaxf(l1, 1e-30f);
      __nv_bfloat16* ob = o + b * ol.b + h * ol.h;
      __nv_bfloat16* o0 = ob + row0 * ol.r;
      __nv_bfloat16* o1 = ob + row1 * ol.r;
#pragma unroll
      for (int dn = 0; dn < DH / 8; ++dn) {     // O's first Dh columns
        const int c = 8 * dn + 2 * t;
        if (row0 < S)
          *reinterpret_cast<uint32_t*>(o0 + c) =
              pack_bf16(acc[4 * dn] * inv0, acc[4 * dn + 1] * inv0);
        if (row1 < S)
          *reinterpret_cast<uint32_t*>(o1 + c) =
              pack_bf16(acc[4 * dn + 2] * inv1, acc[4 * dn + 3] * inv1);
      }
    }
    if (wg == 0 && turns > 0) bar_sync(1);    // warpgroup 1's last turn
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kBlockM = 64;            // q rows per CTA
constexpr int kBlockN = 64;            // kv rows per shared-memory tile
constexpr int kThreadsPerRow = 4;
constexpr int kF32Threads = kBlockM * kThreadsPerRow;
constexpr int kChunk = 16;             // keys per online-softmax update

// Stage rows [k0, k0 + kBlockN) of a (T, DH) f32 matrix of row stride ld
// into shared memory; rows at or past T are zero (and masked).
template <int DH>
__device__ __forceinline__ void stage_f32(float* dst, const float* src,
                                          long long ld, int k0, int T_len) {
  constexpr int kQuads = DH / 4;
  for (int c = threadIdx.x; c < kBlockN * kQuads; c += kF32Threads) {
    const int r = c / kQuads, d = 4 * (c % kQuads);
    const int row = k0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < T_len)
      x = *reinterpret_cast<const float4*>(src + row * ld + d);
    *reinterpret_cast<float4*>(dst + r * DH + d) = x;
  }
}

template <int DH>
__global__ void __launch_bounds__(kF32Threads, 2)
    flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     Layout ql, Layout kl, Layout vl, Layout ol, int S,
                     int T_len, int group, int kv_len, int causal,
                     int window, float scale_log2) {
  constexpr int NC = DH / 16;   // float4 column chunks per thread
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kBlockN * DH;

  const int qt = gridDim.x - 1 - blockIdx.x;   // long causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int row = threadIdx.x / kThreadsPerRow;
  const int part = threadIdx.x % kThreadsPerRow;
  const int q_start = qt * kBlockM;
  const int qi = q_start + row;
  const float* kb = k + b * kl.b + (h / group) * kl.h;
  const float* vb = v + b * vl.b + (h / group) * vl.h;

  float qr[NC][4], acc[NC][4];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int d = 16 * i + 4 * part;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (qi < S)
      x = *reinterpret_cast<const float4*>(q + b * ql.b + h * ql.h +
                                           qi * ql.r + d);
    qr[i][0] = x.x * scale_log2;
    qr[i][1] = x.y * scale_log2;
    qr[i][2] = x.z * scale_log2;
    qr[i][3] = x.w * scale_log2;
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  int kt, kt_end;
  kv_tiles<kBlockM, kBlockN>(q_start, T_len, kv_len, causal, window, &kt,
                             &kt_end);
  for (; kt < kt_end; ++kt) {
    const int k0 = kt * kBlockN;
    __syncthreads();   // the previous tile is consumed
    stage_f32<DH>(Ks, kb, kl.r, k0, T_len);
    stage_f32<DH>(Vs, vb, vl.r, k0, T_len);
    __syncthreads();

#pragma unroll 1
    for (int j0 = 0; j0 < kBlockN; j0 += kChunk) {
      float s[kChunk];
      uint32_t ok = 0u;
      float cmax = kNegInf;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float* kr = Ks + (j0 + j) * DH + 4 * part;
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          const float4 kk = *reinterpret_cast<const float4*>(kr + 16 * i);
          dot = fmaf(qr[i][0], kk.x, dot);
          dot = fmaf(qr[i][1], kk.y, dot);
          dot = fmaf(qr[i][2], kk.z, dot);
          dot = fmaf(qr[i][3], kk.w, dot);
        }
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        const bool valid =
            attended(qi, k0 + j0 + j, kv_len, causal, window);
        s[j] = valid ? dot : kNegInf;
        ok |= valid ? (1u << j) : 0u;
        cmax = fmaxf(cmax, s[j]);
      }
      const float m_new = fmaxf(m, cmax);
      const float corr = exp2f(m - m_new);
      l *= corr;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        acc[i][0] *= corr;
        acc[i][1] *= corr;
        acc[i][2] *= corr;
        acc[i][3] *= corr;
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float p = (ok >> j) & 1u ? exp2f(s[j] - m_new) : 0.f;
        l += p;
        const float* vr = Vs + (j0 + j) * DH + 4 * part;
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          const float4 vv = *reinterpret_cast<const float4*>(vr + 16 * i);
          acc[i][0] = fmaf(p, vv.x, acc[i][0]);
          acc[i][1] = fmaf(p, vv.y, acc[i][1]);
          acc[i][2] = fmaf(p, vv.z, acc[i][2]);
          acc[i][3] = fmaf(p, vv.w, acc[i][3]);
        }
      }
      m = m_new;
    }
  }

  if (qi < S) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    float* out = o + b * ol.b + h * ol.h + qi * ol.r;
#pragma unroll
    for (int i = 0; i < NC; ++i)
      *reinterpret_cast<float4*>(out + 16 * i + 4 * part) =
          make_float4(acc[i][0] * inv, acc[i][1] * inv, acc[i][2] * inv,
                      acc[i][3] * inv);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// Returned when a tensor map cannot be encoded: kMapError + the CUresult.
constexpr int kMapError = 1000;

struct Args {
  const void *q, *k, *v;
  void* o;
  Layout ql, kl, vl, ol;
  int B, Hq, Hkv, S, T_len, kv_len, causal, window;
  float scale_log2;
  cudaStream_t stream;
};

// cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, so the library
// needs no -lcuda.
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// The 4-D map (Dh, rows, heads, batch) of a bf16 tensor, in boxes of one
// panel's columns by box_rows rows, swizzled as the wgmma descriptors
// expect; rows past `rows` and columns past Dh read as zeros.
template <int DH>
CUresult encode_map(CUtensorMap* map, const void* base, int rows, int heads,
                    int B, const Layout& l, int box_rows) {
  using P = Plan<DH>;
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(DH),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {2ull * l.r, 2ull * l.h, 2ull * l.b};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(P::kPanel),
                             static_cast<cuuint32_t>(box_rows), 1u, 1u};
  const cuuint32_t elem[4] = {1u, 1u, 1u, 1u};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                P::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                    : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int DH>
int launch_bf16(const Args& a) {
  CUtensorMap tq, tk, tv;
  CUresult r = encode_map<DH>(&tq, a.q, a.S, a.Hq, a.B, a.ql, kCtaRows);
  if (r == CUDA_SUCCESS)
    r = encode_map<DH>(&tk, a.k, a.T_len, a.Hkv, a.B, a.kl, kTileN);
  if (r == CUDA_SUCCESS)
    r = encode_map<DH>(&tv, a.v, a.T_len, a.Hkv, a.B, a.vl, kTileN);
  if (r != CUDA_SUCCESS) return kMapError + static_cast<int>(r);
  const size_t smem = Plan<DH>::kBytes;
  cudaError_t err = kern::allow_smem(flash_wgmma_kernel<DH>, smem);
  if (err != cudaSuccess) return err;
  // the consumers' setmaxnreg.inc would wait forever for registers the
  // CTA was not launched with
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, flash_wgmma_kernel<DH>);
  if (err != cudaSuccess) return err;
  if (fa.numRegs * kWgmmaThreads < kConsumers * kWgThreads * kConsumerRegs +
                                       kWgThreads * kProducerRegs)
    return cudaErrorInvalidConfiguration;
  const int q_tiles = (a.S + kCtaRows - 1) / kCtaRows;
  const dim3 grid((q_tiles + 1) / 2, a.Hq, a.B);   // two q tiles a CTA
  flash_wgmma_kernel<DH><<<grid, kWgmmaThreads, smem, a.stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(a.o), a.ol, a.S, a.T_len,
      a.Hq / a.Hkv, a.kv_len, a.causal, a.window, a.scale_log2);
  return cudaGetLastError();
}

template <int DH>
int launch_f32(const Args& a) {
  const size_t smem = 2 * kBlockN * DH * sizeof(float);
  cudaError_t err = kern::allow_smem(flash_f32_kernel<DH>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + kBlockM - 1) / kBlockM, a.Hq, a.B);
  flash_f32_kernel<DH><<<grid, kF32Threads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.ql, a.kl,
      a.vl, a.ol, a.S, a.T_len, a.Hq / a.Hkv, a.kv_len, a.causal, a.window,
      a.scale_log2);
  return cudaGetLastError();
}

template <int DH>
int launch(const Args& a, int bf16) {
  return bf16 ? launch_bf16<DH>(a) : launch_f32<DH>(a);
}

// 16-byte aligned base and (batch, head, row) strides of `esize`-byte
// elements, as TMA and the float4 loads need.
bool aligned(const void* p, const Layout& l, int esize) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && l.b * esize % 16 == 0 &&
         l.h * esize % 16 == 0 && l.r * esize % 16 == 0;
}

}  // namespace

// C entry point, called through ctypes. strides: 12 element strides, the
// (batch, head, row) strides of q, k, v and o in turn (each last dimension
// has stride 1); pointers and strides 16-byte aligned. bf16 != 0 means
// __nv_bfloat16 tensors, else float. Returns a cudaError_t (0 = launched),
// or 1000 + the CUresult when a tensor map cannot be encoded.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o,
                                      const long long* strides, int B, int Hq,
                                      int Hkv, int S, int T_len, int Dh,
                                      int kv_len, int causal, int window,
                                      float scale, int bf16, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || S <= 0 || T_len <= 0 ||
      Hq % Hkv != 0 || B > 65535 || Hq > 65535 || kv_len < 0 ||
      kv_len > T_len || window < 0)
    return cudaErrorInvalidValue;
  const Layout ql{strides[0], strides[1], strides[2]};
  const Layout kl{strides[3], strides[4], strides[5]};
  const Layout vl{strides[6], strides[7], strides[8]};
  const Layout ol{strides[9], strides[10], strides[11]};
  const int esize = bf16 ? 2 : 4;
  if (!aligned(q, ql, esize) || !aligned(k, kl, esize) ||
      !aligned(v, vl, esize) || !aligned(o, ol, esize))
    return cudaErrorMisalignedAddress;
  const Args a{q,      k,      v,      o,      ql,     kl,
               vl,     ol,     B,      Hq,     Hkv,    S,
               T_len,  kv_len, causal, window, scale * kLog2e,
               static_cast<cudaStream_t>(stream)};
  switch (Dh) {
    case 32:
      return launch<32>(a, bf16);
    case 64:
      return launch<64>(a, bf16);
    case 80:
      return launch<80>(a, bf16);
    case 128:
      return launch<128>(a, bf16);
    default:
      return cudaErrorInvalidValue;
  }
}
