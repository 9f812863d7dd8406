"""Hessian-vector-product dispatch: the cell registry and the local operators.

The PCG loops (:mod:`repro_torch.core.pcg`) are generic in the *local*
curvature product ``u -> X_loc (c .* X_loc^T u)``; collectives, the 1/n
scaling and the ridge term are framing the solver adds per partitioning.

The registry gives every (family, layout, partition, fusion, dtype) cell
the same supported/unsupported verdict as the JAX package's
``repro.core.hvp``; :func:`resolve_cell` turns an unsupported combination
into an :class:`UnsupportedHvpError` naming the cell, and
:func:`render_support_matrix` prints the registry as a table. The port
implements the dense layouts (:class:`DenseOperator`, plain
``torch.matmul``; :class:`DenseKernelOperator`, the dense kernels) and
the blocked-ELL one (:class:`EllOperator`), the streamed one
(:class:`StreamedHvpOperator`, the out-of-core solve's chunk scans) and
the K-class softmax product on the in-memory ones
(:class:`SoftmaxHvpOperator`).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.data.sparse import EllPair
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import ref_softmax_coupling
from repro_torch.obs import tracer as obs

FAMILIES = ("binary", "softmax")
LAYOUTS = ("dense", "dense_kernel", "ell", "streamed")
PARTITIONS = ("samples", "features")
DTYPES = ("float32", "bfloat16")

_DTYPE_SHORT = {"float32": "f32", "bfloat16": "bf16"}


class UnsupportedHvpError(ValueError):
    """A (loss, layout, partition, fusion, dtype) dispatch cell that no
    registered operator implements. Raised at solver setup."""


class OperatorCell(NamedTuple):
    """One dispatch cell of the HVP operator registry."""

    family: str      # 'binary' (margin GLM losses) | 'softmax' (K-class)
    layout: str      # 'dense' | 'dense_kernel' | 'ell' | 'streamed'
    partition: str   # 'samples' (DiSCO-S) | 'features' (DiSCO-F)
    fused: bool      # one-pass fused kernels requested
    dtype: str       # HVP tile storage dtype: 'float32' | 'bfloat16'
    supported: bool
    reason: str = ""
    note: str = ""


def cell_id(family: str, layout: str, partition: str, fused: bool,
            dtype: str) -> str:
    """Canonical short name of a dispatch cell, e.g.
    ``binary/ell/features/fused/bf16``."""
    return "/".join([family, layout, partition,
                     "fused" if fused else "two-pass",
                     _DTYPE_SHORT.get(dtype, dtype)])


def _cell_verdict(family: str, layout: str, partition: str, fused: bool,
                  dtype: str) -> tuple[bool, str, str]:
    """(supported, reason, note) for one cell — the reference's rules."""
    if dtype not in DTYPES:
        return False, (f"unknown hvp_dtype {dtype!r}; supported: "
                       f"{'|'.join(DTYPES)}"), ""
    if family == "softmax" and layout == "streamed":
        return False, "streamed softmax is not implemented", ""
    if family == "softmax" and fused:
        return False, ("the softmax class coupling runs between pass A "
                       "and pass B, so no one-pass fused kernel exists"), ""
    if layout == "dense" and fused:
        return False, ("the plain-jnp dense path has no one-pass kernel; "
                       "set use_kernel=True for fused dense HVPs"), ""
    if layout == "streamed" and partition == "features" and fused:
        return False, ("streamed DiSCO-F accumulates pass A chunk by "
                       "chunk, so no collective-free one-pass kernel can "
                       "cover the full HVP (this flag used to be silently "
                       "ignored here)"), ""
    note = ""
    if fused and layout == "streamed":
        note = ("VMEM-gated: oversized chunk panels fall back to the "
                "two-pass chunk stream")
    elif fused and partition == "features":
        note = ("fuses the s-step basis operator at any shard count; the "
                "full HVP fuses only on a 1-shard axis (the z psum "
                "separates the passes otherwise)")
    return True, "", note


def operator_cells() -> list[OperatorCell]:
    """Every registered dispatch cell, supported or not, in deterministic
    order."""
    cells = []
    for family in FAMILIES:
        for layout in LAYOUTS:
            for partition in PARTITIONS:
                for fused in (False, True):
                    for dtype in DTYPES:
                        ok, reason, note = _cell_verdict(
                            family, layout, partition, fused, dtype)
                        cells.append(OperatorCell(
                            family, layout, partition, fused, dtype,
                            ok, reason, note))
    return cells


def resolve_cell(family: str, layout: str, partition: str, fused: bool,
                 dtype: str = "float32") -> OperatorCell:
    """Look up one dispatch cell; raise :class:`UnsupportedHvpError`
    naming the cell if it is unsupported."""
    ok, reason, note = _cell_verdict(family, layout, partition, fused,
                                     dtype)
    cell = OperatorCell(family, layout, partition, fused, dtype, ok,
                        reason, note)
    if not ok:
        raise UnsupportedHvpError(
            f"HVP dispatch cell {cell_id(family, layout, partition, fused, dtype)} "
            f"is unsupported: {reason}")
    return cell


def validate_solver_cell(*, family: str, partition: str, fused: bool,
                         dtype: str, sparse: bool = False,
                         use_kernel: bool = False,
                         streaming: bool = False) -> OperatorCell:
    """Solver-setup validation: map solver flags to the registry layout
    and resolve the cell, raising early with the cell named; a resolved
    cell is traced as an ``hvp.dispatch`` instant."""
    if streaming:
        layout = "streamed"
    elif sparse:
        layout = "ell"
    elif use_kernel:
        layout = "dense_kernel"
    else:
        layout = "dense"
    cell = resolve_cell(family, layout, partition, fused, dtype)
    obs.instant("hvp.dispatch",
                cell=cell_id(family, layout, partition, fused, dtype))
    return cell


def render_support_matrix() -> str:
    """The registry's fusion/support matrix as a Markdown table, the same
    text as the reference's ``render_support_matrix``."""
    lines = ["| family | layout | partition | two-pass | fused | dtypes |",
             "|---|---|---|---|---|---|"]
    for family in FAMILIES:
        for layout in LAYOUTS:
            for partition in PARTITIONS:
                row = [family, layout, partition]
                for fused in (False, True):
                    ok, reason, note = _cell_verdict(
                        family, layout, partition, fused, "float32")
                    if ok:
                        row.append("yes" + (f" ({note})" if note else ""))
                    else:
                        row.append(f"no — {reason}")
                row.append("f32, bf16")
                lines.append("| " + " | ".join(row) + " |")
    return "\n".join(lines)


class HvpOperator:
    """Interface of a *local* curvature product on one shard.

    ``apply(u) = X_loc (c .* X_loc^T u)`` with no collectives, no ``1/n``
    and no ridge term. The split passes exist so multi-shard DiSCO-F can
    all-reduce the n-vector between them.
    """

    family = "binary"
    layout = "ell"
    fused = False

    def pass_a(self, u):
        """Pass A: ``z = X_loc^T u`` (an n-vector)."""
        raise NotImplementedError

    def pass_b(self, z):
        """Pass B: ``X_loc (c .* z)`` (back to the feature axis)."""
        raise NotImplementedError

    def apply(self, u):
        """Full local product ``X_loc (c .* X_loc^T u)``."""
        return self.pass_b(self.pass_a(u))

    def pass_a_multi(self, U):
        """Batched pass A: ``Z = X_loc^T U`` for U (d_loc, s)."""
        raise NotImplementedError

    def pass_b_multi(self, Z):
        """Batched pass B: ``X_loc (c[:, None] .* Z)`` for Z (n_loc, s)."""
        raise NotImplementedError

    def apply_multi(self, U):
        """Batched full local product (the s-step round's HVP)."""
        return self.pass_b_multi(self.pass_a_multi(U))


# elements of X upcast at a time by the plain dense layout at bf16 (a
# block of rows: 64 MiB of f32)
UPCAST_ELEMS = 1 << 24


def _upcast_rows(X):
    """Row blocks ``(rows, X[rows] as f32)`` of a bf16 X, at most
    :data:`UPCAST_ELEMS` elements each, so that no f32 copy of the whole
    shard is made."""
    d, n = X.shape
    step = max(1, UPCAST_ELEMS // max(n, 1))
    for i in range(0, max(d, 1), step):
        yield slice(i, i + step), X[i:i + step].float()


def _xt_dot(X, v):
    """``X^T v`` in f32 for f32 or bf16 X (bf16 upcast by row blocks; v
    not rounded)."""
    if X.dtype == torch.float32:
        return X.T @ v
    out = None
    for rows, Xf in _upcast_rows(X):
        part = Xf.T @ v[rows]
        out = part if out is None else out.add_(part)
    return out


def _x_dot(X, v):
    """``X v`` in f32 for f32 or bf16 X (bf16 upcast by row blocks; v not
    rounded)."""
    if X.dtype == torch.float32:
        return X @ v
    return torch.cat([Xf @ v for _, Xf in _upcast_rows(X)])


class DenseOperator(HvpOperator):
    """Dense layout in plain ``torch.matmul`` (two-pass only; no kernel).

    On bf16 X (``hvp_dtype='bfloat16'``) it follows its reference
    counterpart, whose ``X_bf16 @ u`` promotes: X is upcast and the
    vector is not rounded (the kernels' layout rounds it, F10). The upcast
    runs over blocks of rows, so no f32 copy of the shard is made."""

    layout = "dense"

    def __init__(self, X, coeffs):
        self.X = X
        self.coeffs = coeffs

    def pass_a(self, u):
        """``X^T u`` via a dense matvec."""
        return _xt_dot(self.X, u)

    def pass_b(self, z):
        """``X (c .* z)``; with no coefficients, plain ``X z``."""
        if self.coeffs is None:
            return _x_dot(self.X, z)
        return _x_dot(self.X, self.coeffs * z)

    def pass_a_multi(self, U):
        """``X^T U`` via one dense matmul."""
        return _xt_dot(self.X, U)

    def pass_b_multi(self, Z):
        """``X (c[:, None] .* Z)`` via one dense matmul."""
        if self.coeffs is None:
            return _x_dot(self.X, Z)
        return _x_dot(self.X, self.coeffs[:, None] * Z)


class DenseKernelOperator(HvpOperator):
    """Dense layout through the dense GLM kernels (``xt_u``, ``x_cz`` and
    their multi-vector ``xt_multi``, ``x_cz_multi``; on bf16 X their bf16
    instances, which round the vector operand as the TPU kernels do);
    ``fused=True`` selects the one-pass ``x_c_xt_u`` and ``x_c_xt_multi``
    for the full products (their bf16 instances on bf16 X)."""

    layout = "dense_kernel"

    def __init__(self, X, coeffs, fused=False):
        self.X = X
        self.coeffs = coeffs
        self.fused = bool(fused)

    def pass_a(self, u):
        """``X^T u`` via the ``xt_u`` kernel."""
        return kops.xt_u(self.X, u)

    def pass_b(self, z):
        """``X (c .* z)`` via the ``x_cz`` kernel, the scale fused."""
        return kops.x_cz_local(self.X, self.coeffs, z)

    def pass_a_multi(self, U):
        """``X^T U`` via the ``xt_multi`` kernel."""
        return kops.xt_multi(self.X, U)

    def pass_b_multi(self, Z):
        """``X (c[:, None] .* Z)`` via the ``x_cz_multi`` kernel."""
        return kops.x_cz_multi(self.X, self.coeffs, Z)

    def apply(self, u):
        """Full product; the one-pass fused kernel when built fused."""
        if self.fused:
            return kops.x_c_xt_u(self.X, self.coeffs, u)
        return self.pass_b(self.pass_a(u))

    def apply_multi(self, U):
        """Batched full product; the one-pass ``x_c_xt_multi`` kernel
        when built fused."""
        if self.fused:
            return kops.x_c_xt_multi(self.X, self.coeffs, U)
        return self.pass_b_multi(self.pass_a_multi(U))


class EllOperator(HvpOperator):
    """Blocked-ELL sparse layout; the pair carries forward + transposed
    tilings, and ``fused=True`` completes both directions from the
    transposed layout alone (the ``ell_hvp`` kernel)."""

    layout = "ell"

    def __init__(self, ell: EllPair, coeffs, fused=False):
        self.ell = ell
        self.coeffs = coeffs
        self.fused = bool(fused)

    def pass_a(self, u):
        """``X^T u`` over the transposed ELL tiles."""
        return kops.ell_matvec(self.ell.dataT, self.ell.colsT, u,
                               sched=self.ell.schedT)

    def pass_b(self, z):
        """``X (c .* z)`` over the forward ELL tiles."""
        return kops.ell_matvec(self.ell.data, self.ell.cols, z, self.coeffs,
                               sched=self.ell.sched)

    def pass_a_multi(self, U):
        """``X^T U`` over the transposed ELL tiles."""
        return kops.ell_matmat(self.ell.dataT, self.ell.colsT, U,
                               sched=self.ell.schedT)

    def pass_b_multi(self, Z):
        """``X (c[:, None] .* Z)`` over the forward ELL tiles."""
        return kops.ell_matmat(self.ell.data, self.ell.cols, Z, self.coeffs,
                               sched=self.ell.sched)

    def apply(self, u):
        """Full product; the one-pass fused ELL kernel when built fused."""
        if self.fused:
            return kops.ell_hvp(self.ell.dataT, self.ell.colsT, u,
                                self.coeffs, sched=self.ell.hvp_sched,
                                fwd=(self.ell.data, self.ell.cols))
        return self.pass_b(self.pass_a(u))

    def apply_multi(self, U):
        """Batched full product; the one-pass ``ell_hvp_mm`` kernel when
        built fused."""
        if self.fused:
            return kops.ell_hvp_mm(self.ell.dataT, self.ell.colsT, U,
                                   self.coeffs, sched=self.ell.hvp_sched,
                                   fwd=(self.ell.data, self.ell.cols))
        return self.pass_b_multi(self.pass_a_multi(U))


class StreamedHvpOperator(HvpOperator):
    """Out-of-core layout: the streaming solver supplies chunk-scan
    callables (each one prefetched pass over the
    :class:`repro_torch.data.store.ShardStore`), and this class gives them
    the common operator face. ``fused`` records whether the
    sample-partition scans run the one-pass chunk kernels (decided from
    the plan's tile geometry by
    :meth:`repro_torch.data.stream.StreamPlan.fused_hvp_fits`). Each full
    product is an ``hvp.apply`` span.
    """

    layout = "streamed"

    def __init__(self, apply: Callable, apply_multi: Callable,
                 pass_a: Callable | None = None,
                 pass_b: Callable | None = None,
                 pass_a_multi: Callable | None = None,
                 pass_b_multi: Callable | None = None,
                 fused: bool = False):
        self._apply = apply
        self._apply_multi = apply_multi
        self._pass_a = pass_a
        self._pass_b = pass_b
        self._pass_a_multi = pass_a_multi
        self._pass_b_multi = pass_b_multi
        self.fused = bool(fused)

    def _need(self, fn, name):
        if fn is None:
            raise UnsupportedHvpError(
                f"streamed operator was built without {name} (the "
                "sample-partition chunk scan completes both directions "
                "per chunk, so split passes do not exist there)")
        return fn

    def pass_a(self, u):
        """Pass A chunk scan (features partition streams)."""
        return self._need(self._pass_a, "pass_a")(u)

    def pass_b(self, z):
        """Pass B chunk scan (features partition streams)."""
        return self._need(self._pass_b, "pass_b")(z)

    def pass_a_multi(self, U):
        """Batched pass A chunk scan."""
        return self._need(self._pass_a_multi, "pass_a_multi")(U)

    def pass_b_multi(self, Z):
        """Batched pass B chunk scan."""
        return self._need(self._pass_b_multi, "pass_b_multi")(Z)

    def apply(self, u):
        """Full streamed product (one pass over the store)."""
        with obs.span("hvp.apply", multi=False, fused=self.fused):
            return self._apply(u)

    def apply_multi(self, U):
        """Batched full streamed product: one chunk read serves every
        column."""
        with obs.span("hvp.apply", multi=True, fused=self.fused):
            return self._apply_multi(U)


class SoftmaxHvpOperator:
    """K-class softmax Hessian application as one multi-vector HVP.

    For multinomial softmax with weights ``W`` (d, K) and probabilities
    ``P = softmax(X^T W)`` the local Hessian product on a direction ``U``
    (d, K) is

        ``H_loc U = X S,   S = P .* V - P .* rowsum(P .* V),  V = X^T U``

    — pass A and pass B are the base operator's multi-vector passes (all
    K classes in one op call each), with the class coupling ``S`` between
    them. Because the coupling sits between the passes, no one-pass fused
    kernel exists for softmax (the registry marks those cells
    unsupported).

    Args:
        base: any :class:`HvpOperator` over the local shard (built with
            ``coeffs=None``: the coupling replaces the scalar d2
            coefficients).
        probs: ``(n_loc, K)`` class probabilities at the current iterate.
        weights: optional ``(n_loc,)`` sample weights (padding).
    """

    family = "softmax"
    fused = False

    def __init__(self, base: HvpOperator, probs, weights=None):
        self.base = base
        self.layout = base.layout
        self.probs = probs
        self.weights = weights

    def coupling(self, V):
        """The class coupling ``S = P.*V - P.*rowsum(P.*V)`` of ``V``
        (n, K) or (n, K, s) (per trailing batch column), sample weights
        folded in."""
        return ref_softmax_coupling(self.probs, V, self.weights)

    def apply(self, U):
        """Local K-class Hessian product on one ``(d_loc, K)`` direction:
        one multi-vector pass each way."""
        return self.base.pass_b_multi(self.coupling(
            self.base.pass_a_multi(U)))

    def apply_batch(self, U3):
        """Batched product on ``(d_loc, K, s)`` stacked directions: the
        s-step round's s directions times K classes ride one multi-vector
        op of width ``K * s`` each way."""
        d, K, s = U3.shape
        V = self.base.pass_a_multi(U3.reshape(d, K * s))
        n = V.shape[0]
        S = self.coupling(V.reshape(n, K, s))
        return self.base.pass_b_multi(S.reshape(n, K * s)).reshape(d, K, s)


def make_local_operator(X_loc, coeffs, *, use_kernel: bool = False,
                        fused: bool = False,
                        partition: str = "samples") -> HvpOperator:
    """Build the local HVP operator for one shard — the one dispatch point
    the PCG loops use. An :class:`EllPair` selects :class:`EllOperator`; a
    dense ``(d_loc, n_loc)`` tensor selects :class:`DenseKernelOperator`
    with ``use_kernel``, else :class:`DenseOperator`."""
    if isinstance(X_loc, EllPair):
        resolve_cell("binary", "ell", partition, fused)
        return EllOperator(X_loc, coeffs, fused=fused)
    if not isinstance(X_loc, torch.Tensor) or X_loc.dim() != 2:
        raise TypeError("X_loc must be an EllPair or a 2-D tensor")
    layout = "dense_kernel" if use_kernel else "dense"
    resolve_cell("binary", layout, partition, fused)
    if use_kernel:
        return DenseKernelOperator(X_loc, coeffs, fused=fused)
    return DenseOperator(X_loc, coeffs)
