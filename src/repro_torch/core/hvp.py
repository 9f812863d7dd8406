"""Hessian-vector-product dispatch: the cell registry and the local operators.

The PCG loops (:mod:`repro_torch.core.pcg`) are generic in the *local*
curvature product ``u -> X_loc (c .* X_loc^T u)``; collectives, the 1/n
scaling and the ridge term are framing the solver adds per partitioning.

The registry gives every (family, layout, partition, fusion, dtype) cell
the same supported/unsupported verdict as the JAX package's
``repro.core.hvp``; :func:`resolve_cell` turns an unsupported combination
into an :class:`UnsupportedHvpError` naming the cell. The port implements
the dense layouts (:class:`DenseOperator`, plain ``torch.matmul``;
:class:`DenseKernelOperator`, the dense kernels) and the blocked-ELL one
(:class:`EllOperator`); the streamed layout is not yet ported.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.data.sparse import EllPair
from repro_torch.kernels import ops as kops

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
    and resolve the cell, raising early with the cell named."""
    if streaming:
        layout = "streamed"
    elif sparse:
        layout = "ell"
    elif use_kernel:
        layout = "dense_kernel"
    else:
        layout = "dense"
    return resolve_cell(family, layout, partition, fused, dtype)


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


class DenseOperator(HvpOperator):
    """Dense layout in plain ``torch.matmul`` (two-pass only; no kernel)."""

    layout = "dense"

    def __init__(self, X, coeffs):
        self.X = X
        self.coeffs = coeffs

    def pass_a(self, u):
        """``X^T u`` via a dense matvec."""
        return self.X.T @ u

    def pass_b(self, z):
        """``X (c .* z)``; with no coefficients, plain ``X z``."""
        if self.coeffs is None:
            return self.X @ z
        return self.X @ (self.coeffs * z)

    def pass_a_multi(self, U):
        """``X^T U`` via one dense matmul."""
        return self.X.T @ U

    def pass_b_multi(self, Z):
        """``X (c[:, None] .* Z)`` via one dense matmul."""
        if self.coeffs is None:
            return self.X @ Z
        return self.X @ (self.coeffs[:, None] * Z)


class DenseKernelOperator(HvpOperator):
    """Dense layout through the dense GLM kernels (``xt_u``, ``x_cz`` and
    their multi-vector ``xt_multi``, ``x_cz_multi``); ``fused=True``
    selects the one-pass ``x_c_xt_u`` for the full product. The fused
    multi-vector product needs ``x_c_xt_multi``, which is not yet
    ported."""

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
        """Batched full product (two-pass); built fused, it needs the
        ``x_c_xt_multi`` kernel and raises."""
        if self.fused:
            raise NotImplementedError(
                "the fused dense multi-vector HVP (the x_c_xt_multi "
                "kernel) is not yet ported to repro_torch")
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
        return kops.ell_matvec(self.ell.dataT, self.ell.colsT, u)

    def pass_b(self, z):
        """``X (c .* z)`` over the forward ELL tiles."""
        return kops.ell_matvec(self.ell.data, self.ell.cols, z, self.coeffs)

    def pass_a_multi(self, U):
        """``X^T U`` over the transposed ELL tiles."""
        return kops.ell_matmat(self.ell.dataT, self.ell.colsT, U)

    def pass_b_multi(self, Z):
        """``X (c[:, None] .* Z)`` over the forward ELL tiles."""
        return kops.ell_matmat(self.ell.data, self.ell.cols, Z, self.coeffs)

    def apply(self, u):
        """Full product; the one-pass fused ELL kernel when built fused."""
        if self.fused:
            return kops.ell_hvp(self.ell.dataT, self.ell.colsT, u,
                                self.coeffs,
                                fwd=(self.ell.data, self.ell.cols))
        return self.pass_b(self.pass_a(u))

    def apply_multi(self, U):
        """Batched full product; the one-pass ``ell_hvp_mm`` kernel when
        built fused."""
        if self.fused:
            return kops.ell_hvp_mm(self.ell.dataT, self.ell.colsT, U,
                                   self.coeffs,
                                   fwd=(self.ell.data, self.ell.cols))
        return self.pass_b_multi(self.pass_a_multi(U))


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
