"""Blocked-ELL sparse HVP kernels: hand-written CUDA for Hopper, with a
plain PyTorch version beside each.

  ell_matvec   blocked-ELL y = A (c .* v)            (kernel ``ell_mv``)
  ell_hvp      fused one-pass y = A (c .* (A^T u))   (kernel ``ell_hvp``)

Both dispatch by device: CUDA tensors launch the kernels
(:mod:`repro_torch.kernels.sparse_hvp`), CPU tensors run the plain
versions (:mod:`repro_torch.kernels.ref`).
"""
from repro_torch.kernels.ops import ell_hvp, ell_matvec

__all__ = ["ell_matvec", "ell_hvp"]
