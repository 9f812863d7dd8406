"""HVP kernels: hand-written CUDA for Hopper, with a plain PyTorch version
beside each.

Dense (feature-major ``X (d, n)``):

  xt_u         z = X^T u                            (kernel ``xt_u``)
  x_cz_local   y = X (c .* z)                       (kernel ``x_cz``)
  x_c_xt_u     fused one-pass y = X (c .* (X^T u))  (kernel ``x_c_xt_u``)
  xt_multi     Z = X^T U, U (d, s)                  (kernel ``xt_multi``)
  x_cz_multi   Y = X (c .* Z), Z (n, s)             (kernel ``x_cz_multi``)

(``ops.glm_hvp``, the whole H u, is not re-exported here: the name is
the kernels' module :mod:`repro_torch.kernels.glm_hvp`.)

Blocked ELL (sparse):

  ell_matvec   y = A (c .* v)                       (kernel ``ell_mv``)
  ell_hvp      fused one-pass y = A (c .* (A^T u))  (kernel ``ell_hvp``)
  ell_matmat   Y = A (c .* V), V (ncb * bc, s)      (kernel ``ell_mm``)
  ell_hvp_mm   fused one-pass Y = A (c .* (A^T U))  (kernel ``ell_hvp_mm``)

All dispatch by device: CUDA tensors launch the kernels
(:mod:`repro_torch.kernels.glm_hvp`, :mod:`repro_torch.kernels.sparse_hvp`,
built by :mod:`repro_torch.kernels.build`), CPU tensors run the plain
versions (:mod:`repro_torch.kernels.ref`).
"""
from repro_torch.kernels.ops import (ell_hvp, ell_hvp_mm, ell_matmat,
                                     ell_matvec, x_c_xt_u, x_cz_local,
                                     x_cz_multi, xt_multi, xt_u)

__all__ = ["ell_matvec", "ell_hvp", "ell_matmat", "ell_hvp_mm", "xt_u",
           "x_cz_local", "x_c_xt_u", "xt_multi", "x_cz_multi"]
