"""Public blocked-ELL ops, dispatched by the device of their tensors.

CUDA tensors go to the hand-written kernels of
:mod:`repro_torch.kernels.sparse_hvp` (a failed launch raises); CPU tensors
go to the plain versions of :mod:`repro_torch.kernels.ref`. There is no
switch that routes CUDA tensors to the plain versions.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels import sparse_hvp as _sparse


def _on_cuda(*tensors) -> bool:
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    kind = devices.pop().type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device type {kind!r}")
    return kind == "cuda"


def ell_matvec(data, cols, v, c=None, *, out_dtype=torch.float32):
    """y = A @ (c .* v) for a blocked-ELL operand (sparse HVP pass).

    data : (nb, W, br, bc) tiles; cols : (nb, W) int32 column-block ids
    v    : (ncb * bc,) padded input; c optional same-length fused scale
    returns (nb * br,) in ``out_dtype`` (f32 accumulation). Streaming a
    shard's forward layout computes ``X_loc @ (c * z)`` (pass B); its
    transposed layout computes ``X_loc^T u`` (pass A).
    """
    if _on_cuda(data, cols, v, c):
        return _sparse.ell_mv(data, cols, v, c, out_dtype=out_dtype)
    return _ref.ref_ell_mv(data, cols, v, c, out_dtype=out_dtype)


def ell_hvp(dataT, colsT, u, c=None, *, fwd=None, out_dtype=torch.float32):
    """One-pass blocked-ELL HVP: y = A (c .* (A^T u)).

    Reads only the *transposed* layout (``dataT``/``colsT``); ``u`` lives
    on A's padded row axis (nrb * br), ``c`` on its padded column axis.
    On the card it is always the fused kernel. On the CPU, ``fwd=(data,
    cols)`` (the forward layout) makes it replay the exact two-pass pair
    of plain versions, so a fused CPU run equals a two-pass one bit for
    bit; without ``fwd`` it runs the plain fused version.
    """
    if _on_cuda(dataT, colsT, u, c):
        return _sparse.ell_hvp(dataT, colsT, u, c, out_dtype=out_dtype)
    if fwd is not None:
        z = _ref.ref_ell_mv(dataT, colsT, u)
        return _ref.ref_ell_mv(fwd[0], fwd[1], z, c, out_dtype=out_dtype)
    return _ref.ref_ell_hvp_t(dataT, colsT, u, c, out_dtype=out_dtype)
