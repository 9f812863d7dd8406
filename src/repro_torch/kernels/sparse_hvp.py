"""Hand-written CUDA kernels for the blocked-ELL sparse HVP, and their
launch wrappers.

Four kernels, in ``csrc/``, each built and bound by
:mod:`repro_torch.kernels.build` and called on PyTorch's current stream:

* ``ell_mv``  (``csrc/ell_mv.cu``) — ``y = A (c .* v)`` on a blocked-ELL
  operand; replaces ``repro/kernels/sparse_hvp.py::ell_mv``.
* ``ell_hvp`` (``csrc/ell_hvp.cu``) — the fused ``y = A (c .* (A^T u))``
  from the transposed layout alone; replaces
  ``repro/kernels/sparse_hvp.py::ell_hvp``.
* ``ell_mm``  (``csrc/ell_mm.cu``) — ``Y = A (c .* V)`` over s vectors;
  replaces ``repro/kernels/sparse_hvp.py::ell_mm``.
* ``ell_hvp_mm`` (``csrc/ell_hvp_mm.cu``) — the fused
  ``Y = A (c .* (A^T U))`` over s vectors from the transposed layout;
  replaces ``repro/kernels/sparse_hvp.py::ell_hvp_mm``.

The multi-vector kernels take the true ``s`` (1 to
:data:`~repro_torch.kernels.build.MAX_COLS`) and a row-major block with
any row stride; nothing is padded.

A failed launch raises; nothing here falls back to the plain versions in
:mod:`repro_torch.kernels.ref`. Each wrapper counts its launches
(:func:`repro_torch.kernels.build.launch_counts`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import (ELL_HVP, ELL_HVP_MM, ELL_MM, ELL_MV,
                                       check_card, check_columns,
                                       check_tensor, ptr, stream_of)

THREADS = 256          # threads per CTA of ell_mv and ell_hvp
MM_THREADS = 512       # threads per CTA of ell_mm and ell_hvp_mm


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


def _check_layout(data, cols, dev):
    check_card(dev)
    check_tensor("data", data, torch.float32, 4, dev)
    check_tensor("cols", cols, torch.int32, 2, dev)
    if tuple(cols.shape) != tuple(data.shape[:2]):
        raise ValueError(f"cols {tuple(cols.shape)} != "
                         f"{tuple(data.shape[:2])}")


def ell_mm(data, cols, V, c=None, *, out_dtype=torch.float32):
    """Y = A @ (c[:, None] .* V) over s vectors, on the card.

    data : (nb, W, br, bc) f32 tiles;  cols : (nb, W) int32
    V    : (ncb * bc, s) f32, row-major with any row stride
    c    : optional (ncb * bc,) f32 scale (fused in-kernel)
    returns (nb * br, s) in ``out_dtype`` (f32 accumulation; no atomics)
    """
    dev = data.device
    _check_layout(data, cols, dev)
    nb, w, br, bc = data.shape
    if V.dim() != 2 or V.shape[0] % bc or V.shape[0] == 0:
        raise ValueError(f"V {tuple(V.shape)} is not (k * {bc}, s)")
    s, ldv = check_columns("V", V, V.shape[0], dev)
    if c is not None:
        check_tensor("c", c, torch.float32, 1, dev)
        if c.shape[0] != V.shape[0]:
            raise ValueError(f"len(c) = {c.shape[0]} != {V.shape[0]}")
    Y = torch.empty((nb * br, s), dtype=torch.float32, device=dev)
    if nb == 0:
        return Y.to(out_dtype)
    with torch.cuda.device(dev):
        ELL_MM.launch(ptr(data), ptr(cols), ptr(V), ldv, ptr(c), ptr(Y), nb,
                      w, br, bc, V.shape[0] // bc, s, MM_THREADS,
                      stream_of(dev))
    return Y.to(out_dtype)


def ell_hvp_mm(dataT, colsT, U, c=None, *, out_dtype=torch.float32):
    """One-pass blocked-ELL multi-vector HVP on the card:
    Y = A (c .* (A^T U)).

    dataT/colsT : the transposed layout of A, (ncb, WT, bc, br) /
    (ncb, WT). U : (nrb * br, s) row-major with any row stride; c :
    optional (ncb * bc,). Returns (nrb * br, s) in ``out_dtype`` (f32
    accumulation; the atomic scatter makes the summation order vary
    between runs).
    """
    dev = dataT.device
    _check_layout(dataT, colsT, dev)
    ncb, wt, bc, br = dataT.shape
    if U.dim() != 2 or U.shape[0] % br or U.shape[0] == 0:
        raise ValueError(f"U {tuple(U.shape)} is not (k * {br}, s), k > 0")
    s, ldu = check_columns("U", U, U.shape[0], dev)
    if c is not None:
        check_tensor("c", c, torch.float32, 1, dev)
        if c.shape[0] != ncb * bc:
            raise ValueError(f"len(c) = {c.shape[0]} != {ncb * bc}")
    Y = torch.zeros((U.shape[0], s), dtype=torch.float32, device=dev)
    if ncb == 0:
        return Y.to(out_dtype)
    with torch.cuda.device(dev):
        ELL_HVP_MM.launch(ptr(dataT), ptr(colsT), ptr(U), ldu, ptr(c),
                          ptr(Y), ncb, wt, bc, br, U.shape[0] // br, s,
                          MM_THREADS, stream_of(dev))
    return Y.to(out_dtype)
