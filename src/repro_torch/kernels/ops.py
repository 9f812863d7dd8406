"""Public HVP ops, dense and blocked-ELL, and flash attention, dispatched by
the device of their tensors.

The dense ops take f32 or bf16 X (``hvp_dtype='bfloat16'``); at bf16
they launch the bf16 instances of their kernels, the one-pass ones
included, and on the CPU the plain versions round where those kernels
round.

CUDA tensors go to the hand-written kernels of
:mod:`repro_torch.kernels.glm_hvp` (dense),
:mod:`repro_torch.kernels.sparse_hvp` (blocked ELL) and
:mod:`repro_torch.kernels.flash_attention`; a failed launch
raises. CPU tensors go to the plain versions of
:mod:`repro_torch.kernels.ref`. There is no switch that routes CUDA
tensors to the plain versions. The dense ops port ``repro/kernels/ops.py``
without its per-call padding: the kernels take ragged shapes and strided
row-major views as they are.

The multi-vector ops (:func:`xt_multi`, :func:`x_cz_multi`,
:func:`x_c_xt_multi`, :func:`ell_matmat`, :func:`ell_hvp_mm`) take any
number of columns. A kernel launch takes at most
:data:`~repro_torch.kernels.build.MAX_COLS`, so on the card a wider block
(a K-class softmax HVP is K columns, its s-step round K (s + 1)) goes in
column groups of that many, each a strided view, one launch (one read of
the data) per group, and the results are joined.

:func:`flash_attention` ports the JAX op without its per-call padding of S
and T to block multiples: the kernel masks its ragged tiles.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import glm_hvp as _dense
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import sparse_hvp as _sparse
from repro_torch.kernels.build import MAX_COLS
from repro_torch.obs import tracer as obs

# (tracer, modes it has seen): kernel.dispatch is traced once per
# distinct mode a tracer sees, not once per op
_seen_dispatch: tuple = (None, frozenset())


def _trace_dispatch(mode: str) -> None:
    global _seen_dispatch
    tracer = obs.get_tracer()
    seen = _seen_dispatch[1] if _seen_dispatch[0] is tracer else frozenset()
    if mode not in seen:
        _seen_dispatch = (tracer, seen | {mode})
        obs.instant("kernel.dispatch", mode=mode)


def _on_cuda(*tensors) -> bool:
    """True for CUDA tensors (the kernels), False for CPU tensors (the
    plain versions): the port's one device dispatch."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    kind = devices.pop().type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device type {kind!r}")
    if obs.enabled():
        _trace_dispatch("cuda" if kind == "cuda" else "plain")
    return kind == "cuda"


def _by_columns(launch, M):
    """``launch`` over the column groups of ``M`` (at most MAX_COLS
    columns each, strided views), the results joined along columns."""
    s = M.shape[1]
    if s <= MAX_COLS:
        return launch(M)
    return torch.cat([launch(M[:, i:i + MAX_COLS])
                      for i in range(0, s, MAX_COLS)], dim=1)


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


def glm_hvp_multi(X, c, U, lam, *, fused=False):
    """Batched H U = X diag(c) X^T U / n + lam U over s probe vectors
    through the multi-vector kernels.

    ``fused=True`` takes the one-pass :func:`x_c_xt_multi`; otherwise
    pass A (:func:`xt_multi`) then pass B (:func:`x_cz_multi`).
    """
    Y = (x_c_xt_multi(X, c, U) if fused
         else x_cz_multi(X, c, xt_multi(X, U)))
    return Y / X.shape[1] + lam * U


def xt_u(X, u):
    """z = X^T u (pass A only — what DiSCO-F all-reduces).
    X (d, n) f32 or bf16 tiles, u (d,) -> z (n,) f32."""
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
        return _by_columns(lambda G: _dense.xt_multi(X, G), U)
    return _ref.ref_xt_multi(X, U)


def x_cz_multi(X, c, Z):
    """Y = X (c[:, None] .* Z) (multi-vector pass B, the scale fused).
    X (d, n), c (optional, n,), Z (n, s) -> Y (d, s) f32."""
    if _on_cuda(X, c, Z):
        return _by_columns(lambda G: _dense.x_cz_multi(X, c, G), Z)
    return _ref.ref_x_cz_multi(X, c, Z)


def x_c_xt_multi(X, c, U):
    """Y = X (c[:, None] .* (X^T U)) in one streaming pass over X per
    column group (the s-step round's batched HVP on fused dense input).

    X (d, n) f32 or bf16, c (optional, n,), U (d, s) row-major (any row
    stride) -> Y (d, s) f32. Legal where :func:`x_c_xt_u` is. On the card
    each group of at most MAX_COLS columns is the fused kernel of X's tile
    dtype when a plan fits shared memory
    (:func:`repro_torch.kernels.glm_hvp.fused_plan` at X's dtype), else
    the two-pass route of the same dtype: the ``xt_multi`` kernel, then
    ``x_cz_multi``. On the CPU the plain version is the two-pass pair's,
    rounding where both routes round.
    """
    if _on_cuda(X, c, U):
        def launch(G):
            if _dense.fused_plan(X.shape[0], G.shape[1],
                                 dtype=X.dtype) is not None:
                return _dense.x_c_xt_multi(X, c, G)
            return _dense.x_cz_multi(X, c, _dense.xt_multi(X, G))
        return _by_columns(launch, U)
    return _ref.ref_x_c_xt_multi(X, c, U)


def x_c_xt_u(X, c, u):
    """y = X (c .* (X^T u)) in one streaming pass over X.

    Legal wherever no collective separates the two passes (every DiSCO-S
    local product, single-shard DiSCO-F). X (d, n) f32 or bf16. On the
    card it is the fused kernel of X's tile dtype when a plan fits shared
    memory (:func:`repro_torch.kernels.glm_hvp.fused_plan` at X's dtype),
    else the two-pass route of the same dtype: the ``xt_u`` kernel, then
    ``x_cz``. On the CPU the plain version is the two-pass pair's.
    """
    if _on_cuda(X, c, u):
        if _dense.fused_plan(X.shape[0], dtype=X.dtype) is not None:
            return _dense.x_c_xt_u(X, c, u)
        return _dense.x_cz(X, c, _dense.xt_u(X, u))
    if c is None:
        return _ref.ref_x_cz(X, _ref.ref_xt_u(X, u))
    return _ref.ref_x_c_xt_u(X, c, u)


def softmax_coupling(probs, V, weights=None):
    """Softmax class coupling ``S = P .* V - P .* rowsum(P .* V)``, the
    (n, K) term between pass A and pass B of the multinomial Hessian
    product: elementwise work and one row sum, plain torch on the tensors'
    device (the reference's op has no kernel either)."""
    return _ref.ref_softmax_coupling(probs, V, weights)


def softmax_hvp(X, probs, U, *, lam=0.0, n_global=None, weights=None):
    """Multinomial softmax Hessian product ``H U = X S / n + lam U``.

    On the card all K classes of ``U`` (d, K) ride one multi-vector pass
    each way through the port's softmax solver's operator
    (:class:`repro_torch.core.hvp.SoftmaxHvpOperator`): ``xt_multi`` (K8),
    the class coupling (:func:`softmax_coupling`), then ``x_cz_multi``
    (K9), in column groups of ``MAX_COLS``. The one-pass K10 cannot carry
    the coupling, which sits between the passes. On the CPU the plain
    :func:`repro_torch.kernels.ref.ref_softmax_hvp`.
    """
    # the solver's operator (imported here: core imports this module)
    from repro_torch.core.hvp import DenseKernelOperator, SoftmaxHvpOperator
    n = X.shape[1] if n_global is None else n_global
    if not _on_cuda(X, probs, U, weights):
        return _ref.ref_softmax_hvp(X, probs, U, lam, n_global=n,
                                    weights=weights)
    op = SoftmaxHvpOperator(DenseKernelOperator(X, None), probs, weights)
    return op.apply(U) / n + lam * U


# ---------------------------------------------------------------------------
# blocked-ELL sparse HVP
# ---------------------------------------------------------------------------


def ell_matvec(data, cols, v, c=None, *, sched=None,
               out_dtype=torch.float32):
    """y = A @ (c .* v) for a blocked-ELL operand (sparse HVP pass).

    data : (nb, W, br, bc) tiles; cols : (nb, W) int32 column-block ids
    v    : (ncb * bc,) padded input; c optional same-length fused scale
    sched: the layout's live-tile schedule
    (:func:`repro_torch.kernels.sparse_hvp.ell_schedule`): the kernel
    reads only the live tiles; None reads every slot. The plain version
    reads every slot (the tiles past the live ones are zero).
    returns (nb * br,) in ``out_dtype`` (f32 accumulation). Streaming a
    shard's forward layout computes ``X_loc @ (c * z)`` (pass B); its
    transposed layout computes ``X_loc^T u`` (pass A).
    """
    if _on_cuda(data, cols, v, c, sched):
        return _sparse.ell_mv(data, cols, v, c, sched=sched,
                              out_dtype=out_dtype)
    return _ref.ref_ell_mv(data, cols, v, c, out_dtype=out_dtype)


def ell_matmat(data, cols, V, c=None, *, sched=None,
               out_dtype=torch.float32):
    """Y = A @ (c[:, None] .* V) over s probe vectors (s-step rounds).

    V : (ncb * bc, s) row-major (``V.stride(1) == 1``, any row stride)
    -> (nb * br, s) in ``out_dtype``; ``sched`` as for
    :func:`ell_matvec`. The kernel takes the true ``s`` (up to MAX_COLS
    per launch, in column groups past that); nothing is padded.
    """
    if _on_cuda(data, cols, V, c, sched):
        return _by_columns(lambda G: _sparse.ell_mm(
            data, cols, G, c, sched=sched, out_dtype=out_dtype), V)
    return _ref.ref_ell_mm(data, cols, V, c, out_dtype=out_dtype)


def ell_hvp(dataT, colsT, u, c=None, *, sched=None, fwd=None,
            out_dtype=torch.float32):
    """One-pass blocked-ELL HVP: y = A (c .* (A^T u)).

    Reads only the *transposed* layout (``dataT``/``colsT``); ``u`` lives
    on A's padded row axis (nrb * br), ``c`` on its padded column axis.
    On the card it is always the fused kernel, walking the layout's step
    schedule ``sched``
    (:func:`repro_torch.kernels.sparse_hvp.ell_hvp_schedule`; None reads
    every slot). On the CPU, ``fwd=(data, cols)`` (the forward layout)
    makes it replay the exact two-pass pair of plain versions, so a fused
    CPU run equals a two-pass one bit for bit; without ``fwd`` it runs
    the plain fused version. The plain versions read every slot.
    """
    if _on_cuda(dataT, colsT, u, c):
        return _sparse.ell_hvp(dataT, colsT, u, c, sched=sched,
                               out_dtype=out_dtype)
    if fwd is not None:
        z = _ref.ref_ell_mv(dataT, colsT, u)
        return _ref.ref_ell_mv(fwd[0], fwd[1], z, c, out_dtype=out_dtype)
    return _ref.ref_ell_hvp_t(dataT, colsT, u, c, out_dtype=out_dtype)


def ell_hvp_mm(dataT, colsT, U, c=None, *, sched=None, fwd=None,
               out_dtype=torch.float32):
    """One-pass blocked-ELL multi-vector HVP: Y = A (c .* (A^T U)).

    U : (nrb * br, s) -> (nrb * br, s); the layout, ``sched`` and ``fwd``
    contract of :func:`ell_hvp`: on the card always the fused kernel, on
    the CPU with ``fwd`` the exact two-pass pair of plain versions.
    """
    if _on_cuda(dataT, colsT, U, c):
        return _by_columns(lambda G: _sparse.ell_hvp_mm(
            dataT, colsT, G, c, sched=sched, out_dtype=out_dtype), U)
    if fwd is not None:
        Z = _ref.ref_ell_mm(dataT, colsT, U)
        return _ref.ref_ell_mm(fwd[0], fwd[1], Z, c, out_dtype=out_dtype)
    return _ref.ref_ell_hvp_mm_t(dataT, colsT, U, c, out_dtype=out_dtype)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def flash_attention(q, k, v, *, causal=True, window=0, scale=None):
    """Flash attention with GQA and causal / sliding-window masking.

    q (B, Hq, S, Dh), k/v (B, Hkv, T, Dh) -> (B, Hq, S, Dh) in q's dtype,
    positions from 0 for q and k. CUDA tensors launch the hand-written
    kernel (:func:`repro_torch.kernels.flash_attention.flash_attention`);
    CPU tensors take :func:`~repro_torch.kernels.ref.flash_attention_ref`.
    """
    if _on_cuda(q, k, v):
        return _flash.flash_attention(q, k, v, causal=causal, window=window,
                                      scale=scale)
    return _ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                    scale=scale)
