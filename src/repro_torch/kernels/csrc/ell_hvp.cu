// Fused blocked-ELL Hessian-vector product  y = A (c .* (A^T u))  from the
// transposed layout alone, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/sparse_hvp.py::ell_hvp
// (_ell_hvp_kernel). On the DiSCO main path it is the local curvature
// product under hvp_fused=True: every DiSCO-S HVP, and the DiSCO-F HVP on a
// single shard.
//
// Layout: dataT (ncb, WT, bc, br) f32 tiles of A^T, colsT (ncb, WT) int32,
// u (nrb * br,) f32, c (ncb * bc,) f32 or null, y (nrb * br,) f32 zeroed
// by the caller; sched and state the layout's step schedule
// (kernels/sparse_hvp.py ell_hvp_schedule) and its counters and flags,
// cz (ncb, bc) and scratch (2, ctas, 2, bc) f32 buffers of the call.
//
// Design: the one-column case of ell_hvp_stream.cuh. The TPU kernel kept a
// whole transposed tile row in VMEM and read each tile from HBM once; on
// this card a tile row (up to 370 tiles of 64 KB at the rcv1-train shape)
// is far past shared memory but within the 50 MB L2. So one cooperative
// grid of one CTA an SM walks the live tiles in steps that fit a share of
// the L2: pass A of a step reads its tiles from device memory into a ring
// of bulk copies and sums z per row-block; pass B sums the partials of cut
// row-blocks in CTA order (the first CTA there once all have arrived),
// reads the same tiles again, from L2, on the same CTA, and scatters
// cz^T tile into y with f32 reductions. z repeats bit for bit; y only to f32 rounding (the
// reductions arrive in no fixed order). The header's notes say how each
// edge is resolved.
//
// Bound: device-memory bytes: every live tile element is read once from
// device memory and used in two multiply-adds (4 flops per 4 bytes).
#include "ell_hvp_stream.cuh"

// C entry point, called through ctypes (the body: ellh::hvp in the header).
// Launches the kernel, writes the path taken to *path (0 direct, 1 bulk
// copies), and returns a cudaError_t (0 = launched).
extern "C" int ell_hvp_launch(const float* dataT, const int* colsT,
                              const int* sched, int* state, int ctas,
                              int steps, int epoch, const float* u,
                              const float* c, float* y, float* cz,
                              float* scratch, int ncb, int WT, int bc,
                              int br, int nrb, int* path, void* stream) {
  return ellh::hvp(dataT, colsT, sched, state, ctas, steps, epoch, u, c, y,
                   cz, scratch, ncb, WT, bc, br, nrb, path, stream);
}
