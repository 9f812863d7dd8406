// Fused one-pass dense HVP core  y = X (c .* (X^T u))  for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/glm_hvp.py::x_c_xt_u
// (_x_c_xt_u_kernel). On the DiSCO main path it is the local curvature
// product under hvp_fused=True: every DiSCO-S HVP, and the DiSCO-F HVP on a
// single shard (there also the basis operator of fused s-step rounds).
//
// Layout: X (d, n) f32, row-major with row stride ld >= n elements; c
// (optional, n) and u (d,) f32; scratch (clusters, d) f32; y (d,) f32;
// cz_out (optional, n) f32 receives the hand-off c .* z (checks only).
//
// Design: the S = 1 case of fused_stream.cuh. The TPU kernel kept a whole
// (d, 512) column panel in VMEM; here a cluster of Q CTAs shares a panel of
// 32 (or 16) columns, each CTA holding d / Q of its rows, brought in by TMA
// into a ring of stages; only the panel's partial z crosses the cluster,
// through distributed shared memory. The header's notes say how each edge
// is resolved.
//
// Bound: device-memory bytes (4 flops per 4-byte element of X).
#include "fused_stream.cuh"

// C entry point, called through ctypes; c and cz_out may be null (no scale;
// no copy of the hand-off). q, bn and stages are the host's plan
// (glm_hvp.fused_plan); clusters > 0 fixes the cluster count, else as many
// as the card holds at once, at most cap (the scratch's rows). Writes the path taken (0 direct, 1 TMA) to *path and
// the clusters used to *used; returns a cudaError_t (0 = launched), 1000 +
// a CUresult when the tensor map cannot be encoded, or 2000 when no
// cluster of the plan can be placed.
extern "C" int x_c_xt_u_launch(const float* X, long long ld, const float* c,
                               const float* u, float* y, float* cz_out,
                               float* scratch, int d, int n, int q, int bn,
                               int stages, int clusters, int cap, int* path,
                               int* used, void* stream) {
  return fused::run<float, 1>(X, ld, c, u, 1, y, cz_out, scratch, d, n, q,
                              bn, stages, clusters, cap, path, used,
                              static_cast<cudaStream_t>(stream));
}
