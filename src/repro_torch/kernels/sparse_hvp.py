"""Hand-written CUDA kernels for the blocked-ELL sparse HVP, and their
launch wrappers.

Two kernels, in ``csrc/``, each built and bound by
:mod:`repro_torch.kernels.build` and called on PyTorch's current stream:

* ``ell_mv``  (``csrc/ell_mv.cu``) — ``y = A (c .* v)`` on a blocked-ELL
  operand; replaces ``repro/kernels/sparse_hvp.py::ell_mv``.
* ``ell_hvp`` (``csrc/ell_hvp.cu``) — the fused ``y = A (c .* (A^T u))``
  from the transposed layout alone; replaces
  ``repro/kernels/sparse_hvp.py::ell_hvp``.

A failed launch raises; nothing here falls back to the plain versions in
:mod:`repro_torch.kernels.ref`. Each wrapper counts its launches
(:func:`repro_torch.kernels.build.launch_counts`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import (ELL_HVP, ELL_MV, check_card,
                                       check_tensor, ptr, stream_of)

THREADS = 256          # threads per CTA for both kernels


def ell_mv(data, cols, v, c=None, *, out_dtype=torch.float32):
    """y = A @ (c .* v) for a blocked-ELL operand, on the card.

    data : (nb, W, br, bc) f32 tiles;  cols : (nb, W) int32
    v    : (ncb * bc,) f32 input vector (padded length)
    c    : optional (ncb * bc,) f32 per-element scale (fused in-kernel)
    returns (nb * br,) in ``out_dtype`` (f32 accumulation)
    """
    dev = data.device
    check_card(dev)
    check_tensor("data", data, torch.float32, 4, dev)
    nb, w, br, bc = data.shape
    check_tensor("cols", cols, torch.int32, 2, dev)
    if tuple(cols.shape) != (nb, w):
        raise ValueError(f"cols {tuple(cols.shape)} != {(nb, w)}")
    check_tensor("v", v, torch.float32, 1, dev)
    if v.shape[0] % bc:
        raise ValueError(f"len(v) = {v.shape[0]} is not a multiple of {bc}")
    if c is not None:
        check_tensor("c", c, torch.float32, 1, dev)
        if c.shape != v.shape:
            raise ValueError(f"c {tuple(c.shape)} != v {tuple(v.shape)}")
    y = torch.empty(nb * br, dtype=torch.float32, device=dev)
    if nb == 0:
        return y.to(out_dtype)
    with torch.cuda.device(dev):
        ELL_MV.launch(ptr(data), ptr(cols), ptr(v), ptr(c), ptr(y), nb, w,
                      br, bc, v.shape[0] // bc, THREADS, stream_of(dev))
    return y.to(out_dtype)


def ell_hvp(dataT, colsT, u, c=None, *, out_dtype=torch.float32):
    """One-pass blocked-ELL HVP on the card: y = A (c .* (A^T u)).

    dataT/colsT : the *transposed* blocked-ELL layout of A, shapes
    (ncb, WT, bc, br) / (ncb, WT). u : (nrb * br,) over A's padded row
    axis; c : optional (ncb * bc,) scale over A's padded column axis.
    Returns (nrb * br,) in ``out_dtype`` (f32 accumulation; the atomic
    scatter makes the summation order vary between runs).
    """
    dev = dataT.device
    check_card(dev)
    check_tensor("dataT", dataT, torch.float32, 4, dev)
    ncb, wt, bc, br = dataT.shape
    check_tensor("colsT", colsT, torch.int32, 2, dev)
    if tuple(colsT.shape) != (ncb, wt):
        raise ValueError(f"colsT {tuple(colsT.shape)} != {(ncb, wt)}")
    check_tensor("u", u, torch.float32, 1, dev)
    if u.shape[0] % br or u.shape[0] == 0:
        raise ValueError(f"len(u) = {u.shape[0]} is not a positive "
                         f"multiple of {br}")
    if c is not None:
        check_tensor("c", c, torch.float32, 1, dev)
        if c.shape[0] != ncb * bc:
            raise ValueError(f"len(c) = {c.shape[0]} != {ncb * bc}")
    y = torch.zeros(u.shape[0], dtype=torch.float32, device=dev)
    if ncb == 0:
        return y.to(out_dtype)
    with torch.cuda.device(dev):
        ELL_HVP.launch(ptr(dataT), ptr(colsT), ptr(u), ptr(c), ptr(y), ncb,
                       wt, bc, br, u.shape[0] // br, THREADS, stream_of(dev))
    return y.to(out_dtype)
