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
// repeated in memory). Positions run from 0 for q and k alike; a key is
// attended when k_pos < kv_len, and diff = q_pos - k_pos >= 0 (causal) and
// diff < window (window > 0). Inputs f32 or bf16; scores, softmax
// statistics and the accumulator f32; output in the input dtype. A
// masked score never contributes (p = 0), and the denominator is floored
// at 1e-30, so a row with no key to attend is 0, never NaN. Dh is 32, 64
// or 128. S and T are taken as they are: the ragged last q tile and the
// rows past T or kv_len are masked here, nothing is padded.
//
// Design: the TPU grid swept the kv blocks in order (nk fastest) against
// VMEM scratch carried from step to step. Here one CTA owns a tile of 64
// q rows of one (q-head, batch) and loops over the kv tiles of 64 rows
// itself, staging each K and V tile in shared memory, with the running
// max, denominator and accumulator of its rows in registers (f32). The
// loop covers only the kv tiles the q tile can attend, the TPU kernel's
// `relevant` test: causal stops at the tile's last row, a window starts
// at q_start - window + 1, and kv_len ends it. CTAs of the last (under
// causal, longest) q tiles are scheduled first. No atomics and a fixed order
// of sums: each result repeats bit for bit. Two kernels:
//
//  * bf16 (the model's dtype): tensor cores through mma.sync m16n8k16
//    (bf16 in, f32 accumulate). 4 warps, 16 q rows each; a warp keeps its
//    Q rows as A fragments in registers, computes its 16 x 64 block of
//    S = Q K^T from K fragments read out of shared memory, rescales it
//    online (row max and sum over the 4 lanes that share a row by xor
//    shuffles), rounds P to bf16 in the A-fragment layout the S fragments
//    already have, and adds P V with V fragments read by ldmatrix.trans.
//    Tiles are padded by 8 elements a row, so neither read conflicts on
//    shared-memory banks (34 KB at Dh = 128).
//  * f32: CUDA cores. 256 threads, 4 per q row; thread r of a row holds
//    the row's q (pre-scaled by scale * log2 e) and output for the
//    columns 16 i + 4 r .. + 3; K and V tiles in f32 shared memory (64 KB
//    at Dh = 128, opted into above 48 KB); per 16 keys the partial dots
//    are summed over the row's 4 threads by xor shuffles, then one
//    online-softmax update. A warp reads one K or V row at a time, 64
//    contiguous bytes broadcast to its 8 rows: no bank conflicts.
//
// Bound: operations. A causal prefill at (4, 16, 4096, 128) attends 537 M
// (q, k) pairs at 4 Dh flops each, 275 GFLOP: 0.28 ms at the card's 989
// TFLOP/s of bf16 tensor-core rate, against 268 MB of q, k, v and o in
// bf16 (0.08 ms at 3.35 TB/s); in f32, 4.1 ms at the 67 TFLOP/s of the
// CUDA cores. mma.sync reaches only part of the rate that wgmma does, and
// these kernels load each tile synchronously, with no overlap of loads,
// softmax and products; wgmma, TMA loads, pipelining and warp
// specialisation are the later PR that makes K11 fast.
#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kBlockM = 64;            // q rows per CTA
constexpr int kBlockN = 64;            // kv rows per shared-memory tile
constexpr float kNegInf = -1e30f;      // the TPU kernel's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ bool attended(int qpos, int kpos, int kv_len,
                                         int causal, int window) {
  const int diff = qpos - kpos;
  return kpos < kv_len && (!causal || diff >= 0) &&
         (window <= 0 || diff < window);
}

// The kv tiles [first, end) a q tile starting at q_start can attend.
__device__ __forceinline__ void kv_tiles(int q_start, int T_len, int kv_len,
                                         int causal, int window, int* first,
                                         int* end) {
  int k_end = min(T_len, kv_len);
  if (causal) k_end = min(k_end, q_start + kBlockM);
  const int k_begin = window > 0 ? max(0, q_start - window + 1) : 0;
  *first = k_begin / kBlockN;
  *end = (k_end + kBlockN - 1) / kBlockN;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;       // 4 warps x 16 q rows

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices from shared memory, each transposed: lane l
// gives the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* p) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Stage rows [k0, k0 + kBlockN) of a (T, DH) bf16 matrix into a padded
// shared tile (row stride STR); rows at or past T are zero (and masked).
template <int DH, int STR>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src, int k0,
                                           int T_len) {
  constexpr int kChunks = DH / 8;      // 16-byte chunks a row
  for (int c = threadIdx.x; c < kBlockN * kChunks; c += kMmaThreads) {
    const int r = c / kChunks, d = 8 * (c % kChunks);
    const int row = k0 + r;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (row < T_len)
      x = *reinterpret_cast<const uint4*>(src + static_cast<int64_t>(row) * DH + d);
    *reinterpret_cast<uint4*>(dst + r * STR + d) = x;
  }
}

template <int DH>
__global__ void __launch_bounds__(kMmaThreads)
    flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, int S, int T_len, int Hq,
                     int group, int kv_len, int causal, int window,
                     float scale_log2) {
  constexpr int STR = DH + 8;          // padded row: conflict-free reads
  constexpr int KS = DH / 16;          // k-steps of Q K^T; 16-column pairs of P V
  constexpr int NT = kBlockN / 8;      // 8-key column tiles of S
  __shared__ __align__(16) __nv_bfloat16 Ks[kBlockN * STR];
  __shared__ __align__(16) __nv_bfloat16 Vs[kBlockN * STR];

  const int qt = gridDim.x - 1 - blockIdx.x;   // long causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int Hkv = Hq / group;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;        // fragment row, column pair
  const int q_start = qt * kBlockM;
  const int row0 = q_start + warp * 16 + g, row1 = row0 + 8;
  const int64_t q_base = (static_cast<int64_t>(b) * Hq + h) * S * DH;
  const int64_t kv_base =
      (static_cast<int64_t>(b) * Hkv + h / group) * T_len * DH;

  // this warp's Q rows as A fragments
  uint32_t qa[KS][4];
  const __nv_bfloat16* q0 = q + q_base + static_cast<int64_t>(row0) * DH;
  const __nv_bfloat16* q1 = q + q_base + static_cast<int64_t>(row1) * DH;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int c = 16 * kk + 2 * t;
    qa[kk][0] = row0 < S ? ld32(q0 + c) : 0u;
    qa[kk][1] = row1 < S ? ld32(q1 + c) : 0u;
    qa[kk][2] = row0 < S ? ld32(q0 + c + 8) : 0u;
    qa[kk][3] = row1 < S ? ld32(q1 + c + 8) : 0u;
  }
  float acc[DH / 8][4];
#pragma unroll
  for (int dn = 0; dn < DH / 8; ++dn)
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  int kt, kt_end;
  kv_tiles(q_start, T_len, kv_len, causal, window, &kt, &kt_end);
  for (; kt < kt_end; ++kt) {
    const int k0 = kt * kBlockN;
    __syncthreads();   // the previous tile is consumed
    stage_bf16<DH, STR>(Ks, k + kv_base, k0, T_len);
    stage_bf16<DH, STR>(Vs, v + kv_base, k0, T_len);
    __syncthreads();

    // S = Q K^T, 16 x 64 per warp
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const __nv_bfloat16* kr = Ks + (8 * n + g) * STR + 16 * kk + 2 * t;
        mma_bf16(s[n], qa[kk], ld32(kr), ld32(kr + 8));
      }
    }

    // mask, scale to log2 units, row max over the 4 lanes of a row
    uint32_t valid = 0u;
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + 8 * n + 2 * t + (e & 1);
        const bool ok =
            attended(e < 2 ? row0 : row1, kpos, kv_len, causal, window);
        valid |= ok ? 1u << (4 * n + e) : 0u;
        s[n][e] = ok ? s[n][e] * scale_log2 : kNegInf;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    // P = 2^(S - m), 0 where masked; this lane's share of the row sums
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = (valid >> (4 * n + e)) & 1u
                            ? exp2f(s[n][e] - (e < 2 ? mn0 : mn1))
                            : 0.f;
        s[n][e] = p;
        if (e < 2) ps0 += p; else ps1 += p;
      }
    }
    l0 = l0 * c0 + ps0;
    l1 = l1 * c1 + ps1;
#pragma unroll
    for (int dn = 0; dn < DH / 8; ++dn) {
      acc[dn][0] *= c0;
      acc[dn][1] *= c0;
      acc[dn][2] *= c1;
      acc[dn][3] *= c1;
    }

    // O += P V: P's A fragments are S's accumulator fragments, in bf16
#pragma unroll
    for (int j = 0; j < kBlockN / 16; ++j) {
      const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
      const int mi = lane / 8, ri = lane % 8;
      const __nv_bfloat16* vr =
          Vs + (16 * j + 8 * (mi & 1) + ri) * STR + 8 * (mi >> 1);
#pragma unroll
      for (int dp = 0; dp < KS; ++dp) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vr + 16 * dp);
        mma_bf16(acc[2 * dp], pa, vb[0], vb[1]);
        mma_bf16(acc[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* o0 = o + q_base + static_cast<int64_t>(row0) * DH;
  __nv_bfloat16* o1 = o + q_base + static_cast<int64_t>(row1) * DH;
#pragma unroll
  for (int dn = 0; dn < DH / 8; ++dn) {
    const int c = 8 * dn + 2 * t;
    if (row0 < S)
      *reinterpret_cast<uint32_t*>(o0 + c) =
          pack_bf16(acc[dn][0] * inv0, acc[dn][1] * inv0);
    if (row1 < S)
      *reinterpret_cast<uint32_t*>(o1 + c) =
          pack_bf16(acc[dn][2] * inv1, acc[dn][3] * inv1);
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreadsPerRow = 4;
constexpr int kF32Threads = kBlockM * kThreadsPerRow;
constexpr int kChunk = 16;             // keys per online-softmax update

// Stage rows [k0, k0 + kBlockN) of a (T, DH) f32 matrix into shared
// memory; rows at or past T are zero (and masked).
template <int DH>
__device__ __forceinline__ void stage_f32(float* dst, const float* src,
                                          int k0, int T_len) {
  constexpr int kQuads = DH / 4;
  for (int c = threadIdx.x; c < kBlockN * kQuads; c += kF32Threads) {
    const int r = c / kQuads, d = 4 * (c % kQuads);
    const int row = k0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < T_len)
      x = *reinterpret_cast<const float4*>(src + static_cast<int64_t>(row) * DH + d);
    *reinterpret_cast<float4*>(dst + r * DH + d) = x;
  }
}

template <int DH>
__global__ void __launch_bounds__(kF32Threads, 2)
    flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     int S, int T_len, int Hq, int group, int kv_len,
                     int causal, int window, float scale_log2) {
  constexpr int NC = DH / 16;   // float4 column chunks per thread
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kBlockN * DH;

  const int qt = gridDim.x - 1 - blockIdx.x;   // long causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int Hkv = Hq / group;
  const int row = threadIdx.x / kThreadsPerRow;
  const int part = threadIdx.x % kThreadsPerRow;
  const int q_start = qt * kBlockM;
  const int qi = q_start + row;
  const int64_t q_base = (static_cast<int64_t>(b) * Hq + h) * S * DH;
  const int64_t kv_base =
      (static_cast<int64_t>(b) * Hkv + h / group) * T_len * DH;

  float qr[NC][4], acc[NC][4];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int d = 16 * i + 4 * part;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (qi < S)
      x = *reinterpret_cast<const float4*>(
          q + q_base + static_cast<int64_t>(qi) * DH + d);
    qr[i][0] = x.x * scale_log2;
    qr[i][1] = x.y * scale_log2;
    qr[i][2] = x.z * scale_log2;
    qr[i][3] = x.w * scale_log2;
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  int kt, kt_end;
  kv_tiles(q_start, T_len, kv_len, causal, window, &kt, &kt_end);
  for (; kt < kt_end; ++kt) {
    const int k0 = kt * kBlockN;
    __syncthreads();   // the previous tile is consumed
    stage_f32<DH>(Ks, k + kv_base, k0, T_len);
    stage_f32<DH>(Vs, v + kv_base, k0, T_len);
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
    float* out = o + q_base + static_cast<int64_t>(qi) * DH;
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

struct Args {
  const void *q, *k, *v;
  void* o;
  int B, Hq, Hkv, S, T_len, kv_len, causal, window;
  float scale_log2;
  cudaStream_t stream;
};

template <int DH>
cudaError_t launch_bf16(const Args& a) {
  const dim3 grid((a.S + kBlockM - 1) / kBlockM, a.Hq, a.B);
  flash_mma_kernel<DH><<<grid, kMmaThreads, 0, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<__nv_bfloat16*>(a.o), a.S, a.T_len, a.Hq, a.Hq / a.Hkv,
      a.kv_len, a.causal, a.window, a.scale_log2);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_f32(const Args& a) {
  const size_t smem = 2 * kBlockN * DH * sizeof(float);
  cudaError_t err = kern::allow_smem(flash_f32_kernel<DH>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + kBlockM - 1) / kBlockM, a.Hq, a.B);
  flash_f32_kernel<DH><<<grid, kF32Threads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.S,
      a.T_len, a.Hq, a.Hq / a.Hkv, a.kv_len, a.causal, a.window,
      a.scale_log2);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch(const Args& a, int bf16) {
  return bf16 ? launch_bf16<DH>(a) : launch_f32<DH>(a);
}

}  // namespace

// C entry point, called through ctypes. q, k, v, o contiguous, 16-byte
// aligned; bf16 != 0 means __nv_bfloat16 tensors, else float. Returns a
// cudaError_t (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Hq,
                                      int Hkv, int S, int T_len, int Dh,
                                      int kv_len, int causal, int window,
                                      float scale, int bf16, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || S <= 0 || T_len <= 0 ||
      Hq % Hkv != 0 || B > 65535 || Hq > 65535 || kv_len < 0 ||
      kv_len > T_len || window < 0)
    return cudaErrorInvalidValue;
  const Args a{q,      k,      v,      o,      B,
               Hq,     Hkv,    S,      T_len,  kv_len,
               causal, window, scale * kLog2e, static_cast<cudaStream_t>(stream)};
  switch (Dh) {
    case 32:
      return launch<32>(a, bf16);
    case 64:
      return launch<64>(a, bf16);
    case 128:
      return launch<128>(a, bf16);
    default:
      return cudaErrorInvalidValue;
  }
}
