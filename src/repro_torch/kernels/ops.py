"""Public HVP ops, dense and blocked-ELL, dispatched by the device of their
tensors.

CUDA tensors go to the hand-written kernels of
:mod:`repro_torch.kernels.glm_hvp` (dense) and
:mod:`repro_torch.kernels.sparse_hvp` (blocked ELL); a failed launch
raises. CPU tensors go to the plain versions of
:mod:`repro_torch.kernels.ref`. There is no switch that routes CUDA
tensors to the plain versions. The dense ops port ``repro/kernels/ops.py``
without its per-call padding: the kernels take ragged shapes and strided
row-major views as they are.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import glm_hvp as _dense
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


# ---------------------------------------------------------------------------
# dense GLM HVP
# ---------------------------------------------------------------------------

def glm_hvp(X, c, u, lam, *, fused=False):
    """H u = X diag(c) X^T u / n + lam u through the dense kernels.

    ``fused=True`` takes the one-pass :func:`x_c_xt_u`; otherwise pass A
    (:func:`xt_u`) then pass B (:func:`x_cz_local`).
    """
    y = x_c_xt_u(X, c, u) if fused else x_cz_local(X, c, xt_u(X, u))
    return y / X.shape[1] + lam * u


def xt_u(X, u):
    """z = X^T u (pass A only — what DiSCO-F all-reduces).
    X (d, n), u (d,) -> z (n,) f32."""
    if _on_cuda(X, u):
        return _dense.xt_u(X, u)
    return _ref.ref_xt_u(X, u)


def x_cz_local(X, c, z):
    """y = X (c .* z) (pass B only; the scale is fused in the kernel).
    X (d, n), c (optional) and z (n,) -> y (d,) f32."""
    if _on_cuda(X, c, z):
        return _dense.x_cz(X, c, z)
    return _ref.ref_x_cz(X, z if c is None else c * z)


def xt_multi(X, U):
    """Z = X^T U over s probe vectors (multi-vector pass A, s-step rounds).
    X (d, n), U (d, s) row-major (``U.stride(1) == 1``, any row stride)
    -> Z (n, s) f32."""
    if _on_cuda(X, U):
        return _dense.xt_multi(X, U)
    return _ref.ref_xt_multi(X, U)


def x_cz_multi(X, c, Z):
    """Y = X (c[:, None] .* Z) (multi-vector pass B, the scale fused).
    X (d, n), c (optional, n,), Z (n, s) -> Y (d, s) f32."""
    if _on_cuda(X, c, Z):
        return _dense.x_cz_multi(X, c, Z)
    return _ref.ref_x_cz_multi(X, c, Z)


def x_c_xt_u(X, c, u):
    """y = X (c .* (X^T u)) in one streaming pass over X.

    Legal wherever no collective separates the two passes (every DiSCO-S
    local product, single-shard DiSCO-F). On the card it is the fused
    kernel when its panel fits shared memory
    (:func:`repro_torch.kernels.glm_hvp.fused_panel_width`), else the
    two-pass route: the ``xt_u`` kernel, then ``x_cz``.
    """
    if _on_cuda(X, c, u):
        if _dense.fused_panel_width(X.shape[0]) is not None:
            return _dense.x_c_xt_u(X, c, u)
        return _dense.x_cz(X, c, _dense.xt_u(X, u))
    if c is None:
        return _ref.ref_x_cz(X, _ref.ref_xt_u(X, u))
    return _ref.ref_x_c_xt_u(X, c, u)


# ---------------------------------------------------------------------------
# blocked-ELL sparse HVP
# ---------------------------------------------------------------------------


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


def ell_matmat(data, cols, V, c=None, *, out_dtype=torch.float32):
    """Y = A @ (c[:, None] .* V) over s probe vectors (s-step rounds).

    V : (ncb * bc, s) row-major (``V.stride(1) == 1``, any row stride)
    -> (nb * br, s) in ``out_dtype``. The kernel takes the true ``s`` (up
    to :data:`repro_torch.kernels.sparse_hvp.MAX_COLS`); nothing is
    padded.
    """
    if _on_cuda(data, cols, V, c):
        return _sparse.ell_mm(data, cols, V, c, out_dtype=out_dtype)
    return _ref.ref_ell_mm(data, cols, V, c, out_dtype=out_dtype)


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


def ell_hvp_mm(dataT, colsT, U, c=None, *, fwd=None,
               out_dtype=torch.float32):
    """One-pass blocked-ELL multi-vector HVP: Y = A (c .* (A^T U)).

    U : (nrb * br, s) -> (nrb * br, s); the layout and ``fwd`` contract of
    :func:`ell_hvp`: on the card always the fused kernel, on the CPU with
    ``fwd`` the exact two-pass pair of plain versions.
    """
    if _on_cuda(dataT, colsT, U, c):
        return _sparse.ell_hvp_mm(dataT, colsT, U, c, out_dtype=out_dtype)
    if fwd is not None:
        Z = _ref.ref_ell_mm(dataT, colsT, U)
        return _ref.ref_ell_mm(fwd[0], fwd[1], Z, c, out_dtype=out_dtype)
    return _ref.ref_ell_hvp_mm_t(dataT, colsT, U, c, out_dtype=out_dtype)
