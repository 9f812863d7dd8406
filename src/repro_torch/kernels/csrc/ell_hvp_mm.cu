// Fused blocked-ELL multi-vector Hessian-vector product
// Y = A (c .* (A^T U))  from the transposed layout alone, for Hopper
// (sm_90a), over s <= kern::kMaxCols probe vectors at once.
//
// Replaces the Pallas TPU kernel repro/kernels/sparse_hvp.py::ell_hvp_mm
// (_ell_hvp_mm_kernel). On the DiSCO main path it is the s-step round's
// batched local HVP under hvp_fused=True: every DiSCO-S round, and the
// DiSCO-F round on a single shard.
//
// Layout: dataT (ncb, WT, bc, br) f32 tiles of A^T, colsT (ncb, WT) int32,
// U (nrb * br, s) f32 row-major with row stride ldu >= s (DiSCO-F passes
// the first s columns of its (., s+1) basis as a view; u_len floats are
// readable from U on), c (ncb * bc,) f32 or null, Y (nrb * br, s) f32
// row-major, zeroed by the caller; sched, state, cz (ncb, bc, s) and
// scratch (2, ctas, 2, bc, s) as for ell_hvp.
//
// Design: ell_hvp_stream.cuh with S = s, one instance per s: the stepped
// cooperative grid of ell_hvp, each stage holding beside a pass-A tile the
// (br, ldu) span of U it multiplies, copied s-major into shared memory
// (reads of the strided span itself would meet 4- to 32-way bank
// conflicts);
// one read of a tile serves all s columns in each pass. Pass A keeps 8 s
// sums a lane (at most 64 registers), pass B s sums a column. z repeats
// bit for bit, Y to f32 rounding.
//
// Bound: device-memory bytes. Each live tile element is read once from
// device memory and used in 4 s flops (32 at s = 8 against the card's
// ~20 flops per byte balance for 4-byte elements, so at s = 8 the two
// bounds are close; at the main path's s = 5, bytes).
#include "ell_hvp_stream.cuh"

// C entry point, called through ctypes (the body: ellh::hvp_mm in the
// header). Launches the kernel, writes the path taken to *path (0 direct,
// 1 bulk copies), and returns a cudaError_t (0 = launched).
extern "C" int ell_hvp_mm_launch(const float* dataT, const int* colsT,
                                 const int* sched, int* state, int ctas,
                                 int steps, int epoch, const float* U,
                                 long long ldu, long long u_len,
                                 const float* c, float* Y, float* cz,
                                 float* scratch, int ncb, int WT, int bc,
                                 int br, int nrb, int s, int* path,
                                 void* stream) {
  return ellh::hvp_mm(dataT, colsT, sched, state, ctas, steps, epoch, U, ldu,
                      u_len, c, Y, cz, scratch, ncb, WT, bc, br, nrb, s,
                      path, stream);
}
