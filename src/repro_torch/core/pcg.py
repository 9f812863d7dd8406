"""Distributed Preconditioned Conjugate Gradient — paper Algorithms 2 and 3.

Both variants solve the Newton system  H v = g  inexactly to
``||r|| <= eps`` and return (v, delta, iters) with delta = sqrt(v^T H v) for
the damped step of Algorithm 1.

* ``pcg_samples``  (Algorithm 2, DiSCO-S): data sharded by **samples**.
  PCG state vectors are replicated R^d (one copy here, since every shard
  would hold the same); each H u costs one d-vector all-reduce.
* ``pcg_features`` (Algorithm 3, DiSCO-F): data sharded by **features**.
  Every PCG vector is sharded, a stacked ``(m, d_j)`` tensor; each H u
  costs one n-vector all-reduce plus two scalar all-reduces, and the
  Woodbury preconditioner is block-diagonal and fully local.

The shards live in an :class:`repro_torch.parallel.InProcessGroup`; every
cross-shard sum is its ordered ``all_reduce``. The JAX package's
``lax.while_loop`` is a Python loop here with the same condition
(``t < max_iter and ||r|| > eps``) and the same update order, so the
iteration counts match. The condition reads ``||r||`` on the host, one
device sync per PCG iteration.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Union

import torch

from repro_torch.core.hvp import make_local_operator
from repro_torch.core.preconditioner import WoodburyPreconditioner
from repro_torch.data.sparse import EllPair
from repro_torch.parallel.collectives import InProcessGroup

# one shard's data: a blocked-ELL pair, or a dense (d_loc, n_loc) tensor
# (a view into the solver's whole matrix)
Shard = Union[EllPair, torch.Tensor]


class PCGResult(NamedTuple):
    v: torch.Tensor       # inexact Newton direction ((m, d_j) in DiSCO-F)
    delta: torch.Tensor   # sqrt(v^T H v)  (scalar)
    iters: int            # PCG iterations
    r_norm: torch.Tensor  # final residual norm


def _pcg_loop(hvp, apply_precond, psum_dot, g, eps, max_iter):
    """Shared PCG skeleton.

    hvp(u) -> H u            (performs its own collectives)
    apply_precond(r) -> s    (local / replicated, zero comm by construction)
    psum_dot(a, b) -> scalar <a, b> over all shards
    """
    v = torch.zeros_like(g)
    r = g
    s = apply_precond(r)
    u = s
    Hv = torch.zeros_like(g)
    rs = psum_dot(r, s)
    t = 0
    while t < max_iter and bool(torch.sqrt(psum_dot(r, r)) > eps):
        Hu = hvp(u)
        alpha = rs / psum_dot(u, Hu)
        v = v + alpha * u
        Hv = Hv + alpha * Hu
        r = r - alpha * Hu
        s = apply_precond(r)
        rs_new = psum_dot(r, s)
        beta = rs_new / rs
        u = s + beta * u
        rs = rs_new
        t += 1
    delta = torch.sqrt(torch.clamp(psum_dot(v, Hv), min=0.0))
    r_norm = torch.sqrt(psum_dot(r, r))
    return PCGResult(v=v, delta=delta, iters=t, r_norm=r_norm)


def _check_classic(block_s: int) -> None:
    if block_s > 1:
        raise NotImplementedError("s-step PCG (block_s > 1) is not yet "
                                  "ported to repro_torch")


# ---------------------------------------------------------------------------
# preconditioner factories
# ---------------------------------------------------------------------------

def _samples_precond(precond, X_tau, coeffs_tau, lam, mu):
    if precond == "woodbury":
        return WoodburyPreconditioner.build(X_tau, coeffs_tau, lam,
                                            mu).apply_inv
    if precond == "none":
        return lambda r: r
    if precond == "sag":
        raise NotImplementedError("precond='sag' is not yet ported to "
                                  "repro_torch")
    raise ValueError(f"unknown precond {precond!r}")


def _features_precond(precond, X_tau_loc, coeffs_tau, lam, mu):
    """Block-diagonal P^{[j]} per shard from its rows ``X_tau_loc[j]``."""
    if precond == "woodbury":
        if X_tau_loc is None:
            raise ValueError("pcg_features needs the dense X_tau_loc slab "
                             "for the Woodbury preconditioner")
        blocks = [WoodburyPreconditioner.build_blockdiag(
            X_tau_loc[s], coeffs_tau, lam, mu)
            for s in range(X_tau_loc.shape[0])]
        return lambda r: torch.stack([P.apply_inv(r[s])
                                      for s, P in enumerate(blocks)])
    if precond == "none":
        return lambda r: r
    raise ValueError(f"unknown precond {precond!r}")


# ---------------------------------------------------------------------------
# Algorithm 2 — DiSCO-S (sample partitioning)
# ---------------------------------------------------------------------------

def pcg_samples(X_locs: Sequence[Shard], coeffs_loc, n_global, lam, g,
                eps, max_iter, X_tau=None, coeffs_tau=None, mu=0.0,
                group: InProcessGroup | None = None, precond="woodbury",
                block_s=1, hvp_fused=False, use_kernel=False):
    """Classic PCG of DiSCO-S over the shards of ``group``.

    X_locs     : per shard, its sample columns: an :class:`EllPair`, or a
                 dense (d, n_loc) tensor
    coeffs_loc : (m, n_loc) phi'' at w_k, one row per shard
    g          : (d,) replicated gradient
    X_tau      : (d, tau) replicated preconditioner samples
    precond    : 'woodbury' | 'none'
    hvp_fused  : every local product runs the one-pass kernel
                 (``ell_hvp`` or ``x_c_xt_u``: the sample-partitioned
                 product completes both directions before the all-reduce)
    use_kernel : dense shards go through the dense kernels (else plain
                 ``torch.matmul``); ignored for ELL shards
    """
    _check_classic(block_s)
    group = group or InProcessGroup(len(X_locs))
    n_global = torch.tensor(float(n_global), dtype=g.dtype, device=g.device)
    ops = [make_local_operator(X_locs[s], coeffs_loc[s],
                               use_kernel=use_kernel, fused=hvp_fused,
                               partition="samples")
           for s in range(group.size)]

    def hvp(u):
        return group.all_reduce([op.apply(u) for op in ops]) / n_global \
            + lam * u

    apply_precond = _samples_precond(precond, X_tau, coeffs_tau, lam, mu)
    return _pcg_loop(hvp, apply_precond, torch.dot, g, eps, max_iter)


# ---------------------------------------------------------------------------
# Algorithm 3 — DiSCO-F (feature partitioning)
# ---------------------------------------------------------------------------

def pcg_features(X_locs: Sequence[Shard], coeffs, n_global, lam, g_loc,
                 eps, max_iter, coeffs_tau=None, mu=0.0,
                 group: InProcessGroup | None = None, precond="woodbury",
                 block_s=1, X_tau_loc=None, hvp_fused=False,
                 use_kernel=False):
    """Classic PCG of DiSCO-F over the shards of ``group``.

    X_locs    : per shard, its feature rows: an :class:`EllPair`, or a
                dense (d_j, n) tensor
    coeffs    : (n,) phi'' at w_k, replicated
    g_loc     : (m, d_j) gradient, one row per shard
    X_tau_loc : (m, d_j, tau) dense shard rows of the preconditioner
                samples
    hvp_fused : on a one-shard group the whole HVP runs the one-pass
                kernel (``ell_hvp`` or ``x_c_xt_u``); with more shards the
                n-vector all-reduce separates the passes, so they stay
                two-pass
    use_kernel: dense shards go through the dense kernels (else plain
                ``torch.matmul``); ignored for ELL shards
    """
    _check_classic(block_s)
    group = group or InProcessGroup(len(X_locs))
    n_global = torch.tensor(float(n_global), dtype=g_loc.dtype,
                            device=g_loc.device)
    ops = [make_local_operator(X_locs[s], coeffs, use_kernel=use_kernel,
                               fused=hvp_fused, partition="features")
           for s in range(group.size)]
    fuse_full = hvp_fused and group.size == 1

    if fuse_full:
        def hvp(u_loc):
            return ops[0].apply(u_loc[0])[None] / n_global + lam * u_loc
    else:
        def hvp(u_loc):
            # THE communication of DiSCO-F: one reduceAll of an R^n
            # vector between pass A and pass B.
            z = group.all_reduce([op.pass_a(u_loc[s])
                                  for s, op in enumerate(ops)])
            return torch.stack([op.pass_b(z) for op in ops]) / n_global \
                + lam * u_loc

    apply_precond = _features_precond(precond, X_tau_loc, coeffs_tau, lam,
                                      mu)

    def psum_dot(a, b):
        return group.all_reduce([torch.dot(a[s], b[s])
                                 for s in range(group.size)])

    return _pcg_loop(hvp, apply_precond, psum_dot, g_loc, eps, max_iter)
