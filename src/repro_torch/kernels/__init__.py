"""HVP and attention kernels: hand-written CUDA for Hopper, with a plain
PyTorch version beside each.

Dense (feature-major ``X (d, n)``):

  xt_u         z = X^T u                            (kernel ``xt_u``)
  x_cz_local   y = X (c .* z)                       (kernel ``x_cz``)
  x_c_xt_u     fused one-pass y = X (c .* (X^T u))  (kernel ``x_c_xt_u``)
  xt_multi     Z = X^T U, U (d, s)                  (kernel ``xt_multi``)
  x_cz_multi   Y = X (c .* Z), Z (n, s)             (kernel ``x_cz_multi``)
  x_c_xt_multi fused one-pass Y = X (c .* (X^T U))  (kernel ``x_c_xt_multi``)

(``ops.glm_hvp``, the whole H u, and ``ops.flash_attention`` are not
re-exported here: the names are the kernels' modules
:mod:`repro_torch.kernels.glm_hvp` and
:mod:`repro_torch.kernels.flash_attention`.)

Blocked ELL (sparse):

  ell_matvec   y = A (c .* v)                       (kernel ``ell_mv``)
  ell_hvp      fused one-pass y = A (c .* (A^T u))  (kernel ``ell_hvp``)
  ell_matmat   Y = A (c .* V), V (ncb * bc, s)      (kernel ``ell_mm``)
  ell_hvp_mm   fused one-pass Y = A (c .* (A^T U))  (kernel ``ell_hvp_mm``)

Attention (``ops.flash_attention``): online-softmax attention with GQA and
causal / sliding-window masks (kernel ``flash_attention``).

The multi-vector ops take any number of columns (on the card, launches
of at most ``build.MAX_COLS`` each). All dispatch by device: CUDA tensors
launch the kernels (:mod:`repro_torch.kernels.glm_hvp`,
:mod:`repro_torch.kernels.sparse_hvp`,
:mod:`repro_torch.kernels.flash_attention`, built by
:mod:`repro_torch.kernels.build`), CPU tensors run the plain versions
(:mod:`repro_torch.kernels.ref`).
"""
from repro_torch.kernels.ops import (ell_hvp, ell_hvp_mm, ell_matmat,
                                     ell_matvec, x_c_xt_multi, x_c_xt_u,
                                     x_cz_local, x_cz_multi, xt_multi, xt_u)

__all__ = ["ell_matvec", "ell_hvp", "ell_matmat", "ell_hvp_mm", "xt_u",
           "x_cz_local", "x_c_xt_u", "xt_multi", "x_cz_multi",
           "x_c_xt_multi"]
