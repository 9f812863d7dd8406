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

``block_s > 1`` selects the s-step (communication-avoiding) engine: per
*round* it builds an (s+1)-column trial basis
``U = [K_s(M^{-1} H~, M^{-1} r), p_prev]`` from a zero-communication basis
operator H~ (the exact local Hessian on one shard or for DiSCO-F's local
block, the replicated tau-sample estimate for DiSCO-S on several), applies
the true H to the basis in one batched multi-vector HVP (one collective),
assembles the small Gram system and takes the Galerkin step over span(U).
``iters`` then counts rounds, each worth up to ``s`` classic iterations.

The shards live in a group (:mod:`repro_torch.parallel`), all in this
process or one a process; the loops here run over the shards this process
holds (``group.local``), and every cross-shard sum is the group's ordered
``all_reduce``. An op whose bits could follow how many shards one call
batches (DiSCO-F's s-step ``U @ a``) runs shard by shard, so a given
``m`` gives the same bits in either group. The JAX package's
``lax.while_loop`` is a Python loop here with the same condition
(``t < max_iter and ||r|| > eps``) and the same update order, so the
iteration (or round) counts match. The condition reads ``||r||`` on the
host, one device sync per PCG iteration or round. The s-step round's
Gram solve runs on the device and makes its threshold decisions with
``torch.where``, as the JAX package does with ``jnp.where``; on the card
its eigen-solves, like the Woodbury solve, read their error flags on the
host.

:func:`pcg_streamed` runs the same two engines for the streamed
(out-of-core) solve, whose HVPs are passes over a store's chunks, with a
``pcg.round`` span a round and a hook between rounds (the elastic
re-plan's window).
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Sequence, Union

import torch

from repro_torch.core.hvp import make_local_operator
from repro_torch.core.preconditioner import (WoodburyPreconditioner,
                                             sag_solve)
from repro_torch.data.sparse import EllPair
from repro_torch.obs import tracer as obs
from repro_torch.parallel.collectives import InProcessGroup

# one shard's data: a blocked-ELL pair, or a dense (d_loc, n_loc) tensor
# (a view into the solver's whole matrix)
Shard = Union[EllPair, torch.Tensor]


class PCGResult(NamedTuple):
    v: torch.Tensor       # inexact Newton direction ((m, d_j) in DiSCO-F)
    delta: torch.Tensor   # sqrt(v^T H v)  (scalar)
    iters: int            # PCG iterations
    r_norm: torch.Tensor  # final residual norm


class _Rounds:
    """Per-round hooks of the host-driven loops (the streamed solve's):
    ``span(t)`` wraps round ``t`` (its residual test included, so a span
    covers a completed round), ``after()`` runs between rounds."""

    def __init__(self, span=None, after=None):
        self._span, self._after = span, after

    def span(self, t):
        return self._span(t) if self._span else contextlib.nullcontext()

    def after(self):
        if self._after is not None:
            self._after()


_NO_ROUNDS = _Rounds()


def _above(psum_dot, r, eps) -> bool:
    """The loops' residual test ``||r|| > eps``: one host sync."""
    return bool(torch.sqrt(psum_dot(r, r)) > eps)


def _pcg_loop(hvp, apply_precond, psum_dot, g, eps, max_iter,
              rounds=_NO_ROUNDS):
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
    more = t < max_iter and _above(psum_dot, r, eps)
    while more:
        with rounds.span(t):
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
            more = t < max_iter and _above(psum_dot, r, eps)
        rounds.after()
    delta = torch.sqrt(torch.clamp(psum_dot(v, Hv), min=0.0))
    r_norm = torch.sqrt(psum_dot(r, r))
    return PCGResult(v=v, delta=delta, iters=t, r_norm=r_norm)


# ---------------------------------------------------------------------------
# s-step engine (communication-avoiding PCG)
# ---------------------------------------------------------------------------

def _solve_round(G, B, b, s, kappa_max=1e10):
    """Galerkin coefficients over the trial basis:  a ~= G^+ b.

    Whitened with the basis Gram matrix B = U^T U: eigendirections of B
    below ``5e-8 * max`` (degenerate or parallel columns, such as the
    zero p_prev of round one) are dropped, the rest scaled to unit length,
    and the projected Hessian is pseudo-inverted on eigenvalues above
    ``1e-6 * max``. If the monomial block B[:s, :s] has a condition number
    above ``kappa_max`` or the solve is not finite, the closed-form 2 x 2
    Galerkin step over {q_1, p_prev} (one classic PCG iteration) is taken
    instead. Branch-free, as the JAX package's ``_solve_round``.
    """
    tiny = torch.full((), 1e-30, dtype=G.dtype, device=G.device)
    zero = torch.zeros((), dtype=G.dtype, device=G.device)
    G = 0.5 * (G + G.T)
    B = 0.5 * (B + B.T)

    beig, Vb = torch.linalg.eigh(B)
    bmax = torch.maximum(torch.max(torch.abs(beig)), tiny)
    keep = beig > 5e-8 * bmax
    inv_sqrt = torch.where(keep, torch.rsqrt(torch.where(keep, beig, 1.0)),
                           zero)
    T = Vb * inv_sqrt[None, :]                       # whitening transform

    Gt = T.T @ G @ T
    Gt = 0.5 * (Gt + Gt.T)
    geig, Vg = torch.linalg.eigh(Gt)
    gmax = torch.maximum(torch.max(torch.abs(geig)), tiny)
    gkeep = geig > 1e-6 * gmax
    ginv = torch.where(gkeep, 1.0 / torch.where(gkeep, geig, 1.0), zero)
    a = T @ (Vg @ (ginv * (Vg.T @ (T.T @ b))))

    beig_m = torch.linalg.eigvalsh(B[:s, :s])        # monomial block only
    cond_m = torch.max(beig_m) / torch.maximum(torch.min(beig_m), tiny)

    # 2 x 2 Galerkin over columns {q_1, p_prev} (indices 0 and s), in
    # closed form; the pure q_1 step when p_prev = 0 (det = 0)
    g00, g01, g11 = G[0, 0], G[0, s], G[s, s]
    b0, b1 = b[0], b[s]
    det = g00 * g11 - g01 * g01
    safe_det = torch.maximum(det, tiny)
    two = det > tiny * torch.maximum(g00 * g11, tiny)
    x0 = torch.where(two, (g11 * b0 - g01 * b1) / safe_det,
                     b0 / torch.maximum(g00, tiny))
    x1 = torch.where(two, (g00 * b1 - g01 * b0) / safe_det, zero)
    a_fb = torch.cat([x0[None], torch.zeros_like(b[1:s]), x1[None]])

    bad = torch.logical_or(cond_m > kappa_max,
                           torch.logical_not(torch.all(torch.isfinite(a))))
    return torch.where(bad, a_fb, a)


def _sstep_loop(build_basis, hvp_round, gram, update_scales, psum_dot,
                g, eps, max_rounds, s, rounds=_NO_ROUNDS,
                combine=torch.matmul):
    """Shared s-step round skeleton (both partitionings).

    build_basis(r, p_prev, scales) -> U (..., s+1), zero communication
    hvp_round(U, Hp) -> H U with the round's one batched collective;
                     ``Hp = H p_prev`` is carried (last round's ``W a``)
    gram(U, W, r) -> (U^T W, U^T U, U^T r) summed over the shards
    update_scales(scales, B) -> next round's basis scale estimates
    combine(U, a) -> U a (the step over the basis; DiSCO-F's shard by
                     shard)
    """
    v = torch.zeros_like(g)
    r = g
    p = torch.zeros_like(g)
    Hp = torch.zeros_like(g)
    Hv = torch.zeros_like(g)
    scales = torch.ones((max(s - 1, 1),), dtype=g.dtype, device=g.device)
    t = 0
    more = t < max_rounds and _above(psum_dot, r, eps)
    while more:
        with rounds.span(t):
            U = build_basis(r, p, scales)
            W = hvp_round(U, Hp)
            G, B, b = gram(U, W, r)
            a = _solve_round(G, B, b, s)
            dv = combine(U, a)
            Hdv = combine(W, a)
            v, r, p, Hp, Hv = v + dv, r - Hdv, dv, Hdv, Hv + Hdv
            scales = update_scales(scales, B)
            t += 1
            more = t < max_rounds and _above(psum_dot, r, eps)
        rounds.after()
    delta = torch.sqrt(torch.clamp(psum_dot(v, Hv), min=0.0))
    r_norm = torch.sqrt(psum_dot(r, r))
    return PCGResult(v=v, delta=delta, iters=t, r_norm=r_norm)


def _krylov_columns(r, apply_precond, basis_op, s, scales):
    """[q_1, ..., q_s] with q_1 = M^{-1} r, q_{i+1} = M^{-1} H~ q_i / scale_i;
    an overflowed entry becomes 0 (a poor but harmless trial direction)."""
    cols = [apply_precond(r)]
    for i in range(s - 1):
        nxt = apply_precond(basis_op(cols[-1])) / scales[i]
        cols.append(torch.where(torch.isfinite(nxt), nxt,
                                torch.zeros_like(nxt)))
    return cols


def _mgs(cols):
    """Modified Gram-Schmidt over replicated vectors (DiSCO-S, where every
    dot is local). A column that vanishes (exhausted Krylov space, zero
    p_prev) comes back as zeros, for the whitened solve to drop."""
    out = []
    for c in cols:
        w = c
        for o in out:
            w = w - torch.dot(o, w) * o
        nw = torch.sqrt(torch.dot(w, w))
        out.append(torch.where(nw > 1e-30, w / torch.clamp(nw, min=1e-30),
                               torch.zeros_like(w)))
    return out


def _feature_scales_update(scales, B, s):
    """Next round's Krylov column scales from diag(B) (DiSCO-F): the
    per-step growth of the column norms, non-finite ratios read as 1,
    clipped to [1e-6, 1e6]."""
    dgn = torch.sqrt(torch.clamp(torch.diagonal(B)[:s], min=1e-30))
    ratios = dgn[1:] / torch.clamp(dgn[:-1], min=1e-30)
    ratios = torch.where(torch.isfinite(ratios), ratios,
                         torch.ones_like(ratios))
    return torch.clamp(scales * ratios, 1e-6, 1e6)


def _sharded_gram(group, U, W, r):
    """(U^T W, U^T U, U^T r) of sharded ``(nl, rows, k)`` bases (this
    process's shards), in one all-reduce of the concatenated payload
    (DiSCO-F's Gram collective)."""
    k = U.shape[2]
    payload = group.all_reduce([torch.cat([
        (U[j].T @ W[j]).reshape(-1), (U[j].T @ U[j]).reshape(-1),
        U[j].T @ r[j]]) for j in range(len(group.local))])
    return (payload[:k * k].reshape(k, k),
            payload[k * k:2 * k * k].reshape(k, k), payload[2 * k * k:])


# ---------------------------------------------------------------------------
# preconditioner factories
# ---------------------------------------------------------------------------

def _samples_precond(precond, X_tau, coeffs_tau, lam, mu, sag_epochs):
    if precond == "woodbury":
        return WoodburyPreconditioner.build(X_tau, coeffs_tau, lam,
                                            mu).apply_inv
    if precond == "sag":
        # original DiSCO: the iterative inner solve, replicated (the
        # master bottleneck)
        return lambda r: sag_solve(X_tau, coeffs_tau, lam, mu, r,
                                   epochs=sag_epochs)
    if precond == "none":
        return lambda r: r
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
                sag_epochs=5, block_s=1, hvp_fused=False, use_kernel=False):
    """Classic PCG of DiSCO-S over the shards of ``group``.

    X_locs     : per shard this process holds (``group.local``), its
                 sample columns: an :class:`EllPair`, or a dense
                 (d, n_loc) tensor
    coeffs_loc : (nl, n_loc) phi'' at w_k, one row per local shard
    g          : (d,) replicated gradient
    X_tau      : (d, tau) replicated preconditioner samples
    precond    : 'woodbury' (DiSCO-S), 'sag' (original DiSCO, ``sag_epochs``
                 inner epochs per application) or 'none' (CG)
    hvp_fused  : every local product runs the one-pass kernel
                 (``ell_hvp`` or ``x_c_xt_u``: the sample-partitioned
                 product completes both directions before the all-reduce)
    use_kernel : dense shards go through the dense kernels (else plain
                 ``torch.matmul``); ignored for ELL shards
    block_s    : > 1 selects the s-step engine, ``block_s`` Krylov
                 dimensions per round (``max_iter`` then caps rounds)
    """
    group = group or InProcessGroup(len(X_locs))
    n_global = torch.tensor(float(n_global), dtype=g.dtype, device=g.device)
    ops = [make_local_operator(X_locs[j], coeffs_loc[j],
                               use_kernel=use_kernel, fused=hvp_fused,
                               partition="samples")
           for j in range(len(group.local))]

    def hvp(u):
        return group.all_reduce([op.apply(u) for op in ops]) / n_global \
            + lam * u

    def hvp_multi(U):
        return group.all_reduce([op.apply_multi(U) for op in ops]) \
            / n_global + lam * U

    apply_precond = _samples_precond(precond, X_tau, coeffs_tau, lam, mu,
                                     sag_epochs)
    basis_op = None
    if block_s > 1:
        basis_op = _samples_basis_op(hvp, group.size, X_tau, coeffs_tau,
                                     lam)
    return _samples_engine(hvp, hvp_multi, basis_op, apply_precond, g, eps,
                           max_iter, block_s)


def _samples_basis_op(hvp, m, X_tau, coeffs_tau, lam):
    """The s-step basis operator of DiSCO-S: zero-communication, the exact
    Hessian ``hvp`` on one shard, else the replicated tau-sample estimate
    (plain torch.matmul, which the JAX package also leaves outside any
    kernel)."""
    if m == 1:
        return hvp
    if X_tau is None:
        raise ValueError("s-step DiSCO-S on several shards needs the "
                         "replicated X_tau for its basis operator")
    tau = torch.tensor(float(X_tau.shape[1]), dtype=X_tau.dtype,
                       device=X_tau.device)

    def basis_op(u):
        return X_tau @ (coeffs_tau * (X_tau.T @ u)) / tau + lam * u
    return basis_op


def _samples_engine(hvp, hvp_multi, basis_op, apply_precond, g, eps,
                    max_iter, block_s, rounds=_NO_ROUNDS):
    """DiSCO-S's PCG over replicated (d,) vectors: classic, or s-step
    rounds of an MGS-orthonormalized basis (``block_s > 1``)."""
    if block_s <= 1:
        return _pcg_loop(hvp, apply_precond, torch.dot, g, eps, max_iter,
                         rounds)

    s = int(block_s)
    ones = torch.ones((max(s - 1, 1),), dtype=g.dtype, device=g.device)

    def build_basis(r, p, scales):
        # MGS normalizes exactly, so no scale estimates are needed
        cols = _krylov_columns(r, apply_precond, basis_op, s, ones)
        cols.append(p)
        return torch.stack(_mgs(cols), dim=1)

    # MGS mixes p_prev into every column, so the whole basis goes through
    # the batched HVP; the all-reduce after it is the round's only
    # collective
    def hvp_round(U, Hp):
        return hvp_multi(U)

    def gram(U, W, r):
        return U.T @ W, U.T @ U, U.T @ r

    return _sstep_loop(build_basis, hvp_round, gram,
                       lambda scales, B: scales, torch.dot, g, eps,
                       max_iter, s, rounds)


# ---------------------------------------------------------------------------
# Algorithm 3 — DiSCO-F (feature partitioning)
# ---------------------------------------------------------------------------

def pcg_features(X_locs: Sequence[Shard], coeffs, n_global, lam, g_loc,
                 eps, max_iter, coeffs_tau=None, mu=0.0,
                 group: InProcessGroup | None = None, precond="woodbury",
                 block_s=1, X_tau_loc=None, hvp_fused=False,
                 use_kernel=False):
    """Classic PCG of DiSCO-F over the shards of ``group``.

    X_locs    : per shard this process holds (``group.local``), its
                feature rows: an :class:`EllPair`, or a dense (d_j, n)
                tensor
    coeffs    : (n,) phi'' at w_k, replicated
    g_loc     : (nl, d_j) gradient, one row per local shard
    X_tau_loc : (nl, d_j, tau) dense local shard rows of the
                preconditioner samples
    hvp_fused : on a one-shard group the whole HVP runs the one-pass
                kernel (``ell_hvp`` or ``x_c_xt_u``); with more shards the
                n-vector all-reduce separates the passes, so they stay
                two-pass
    use_kernel: dense shards go through the dense kernels (else plain
                ``torch.matmul``); ignored for ELL shards
    block_s   : > 1 selects the s-step engine (see :func:`pcg_samples`);
                its basis operator is each shard's local product, fused
                at any shard count with ``hvp_fused``
    """
    group = group or InProcessGroup(len(X_locs))
    n_global = torch.tensor(float(n_global), dtype=g_loc.dtype,
                            device=g_loc.device)
    ops = [make_local_operator(X_locs[j], coeffs, use_kernel=use_kernel,
                               fused=hvp_fused, partition="features")
           for j in range(len(group.local))]
    fuse_full = hvp_fused and group.size == 1

    if fuse_full:
        def hvp(u_loc):
            return ops[0].apply(u_loc[0])[None] / n_global + lam * u_loc

        def hvp_multi(Uk):
            return ops[0].apply_multi(Uk[0])[None] / n_global + lam * Uk
    else:
        def hvp(u_loc):
            # THE communication of DiSCO-F: one reduceAll of an R^n
            # vector between pass A and pass B.
            z = group.all_reduce([op.pass_a(u_loc[j])
                                  for j, op in enumerate(ops)])
            return torch.stack([op.pass_b(z) for op in ops]) / n_global \
                + lam * u_loc

        def hvp_multi(Uk):
            Z = group.all_reduce([op.pass_a_multi(Uk[j])
                                  for j, op in enumerate(ops)])  # (n, s)
            return torch.stack([op.pass_b_multi(Z) for op in ops]) \
                / n_global + lam * Uk

    # zero-communication basis operator: the block-diagonal local Hessian
    # (exact on one shard); no collective separates its passes, so it
    # fuses at any shard count
    def basis_op(u_loc):
        return torch.stack([op.apply(u_loc[j]) for j, op in enumerate(ops)]
                           ) / n_global + lam * u_loc

    apply_precond = _features_precond(precond, X_tau_loc, coeffs_tau, lam,
                                      mu)
    return _features_engine(hvp, hvp_multi, basis_op, apply_precond, group,
                            g_loc, eps, max_iter, block_s)


def _features_engine(hvp, hvp_multi, basis_op, apply_precond, group, g_loc,
                     eps, max_iter, block_s, rounds=_NO_ROUNDS):
    """DiSCO-F's PCG over sharded ``(nl, d_j)`` vectors (this process's
    shards): classic, or s-step rounds whose basis keeps scale-managed
    Krylov columns and the carried ``H p_prev`` (``hvp_multi`` takes the
    s Krylov columns only)."""
    nl = len(group.local)

    def psum_dot(a, b):
        return group.all_reduce([torch.dot(a[j], b[j]) for j in range(nl)])

    if block_s <= 1:
        return _pcg_loop(hvp, apply_precond, psum_dot, g_loc, eps,
                         max_iter, rounds)

    s = int(block_s)

    def build_basis(r_loc, p_loc, scales):
        # sharded vectors: the columns are range-managed with last round's
        # growth estimates instead of exact norms (a psum per column)
        cols = _krylov_columns(r_loc, apply_precond, basis_op, s, scales)
        cols.append(p_loc)
        return torch.stack(cols, dim=2)             # (nl, d_j, s+1)

    # the basis keeps p_prev verbatim and H p_prev is carried, so only
    # the s Krylov columns (a strided view of U) ride the batched HVP
    def hvp_round(U, Hp):
        Wk = hvp_multi(U[:, :, :s])
        return torch.cat([Wk, Hp[:, :, None]], dim=2)

    def gram(U, W, r_loc):
        return _sharded_gram(group, U, W, r_loc)

    # U a shard by shard: a batched (nl, d_j, k) @ (k,) may block its
    # rows by the batch, and the groups batch different shard counts
    def combine(U, a):
        return torch.stack([U[j] @ a for j in range(nl)])

    return _sstep_loop(build_basis, hvp_round, gram,
                       lambda scales, B: _feature_scales_update(scales, B, s),
                       psum_dot, g_loc, eps, max_iter, s, rounds, combine)


# ---------------------------------------------------------------------------
# host-driven streamed PCG (the out-of-core solve)
# ---------------------------------------------------------------------------

def pcg_streamed(hvp, apply_precond, g, eps, max_iter, *, block_s=1,
                 hvp_multi=None, basis_op=None, variant="features",
                 between_rounds=None, group: InProcessGroup | None = None):
    """PCG over a *streamed* Hessian operator: the same recurrences as the
    in-memory loops (:func:`pcg_samples` / :func:`pcg_features` run the
    same engines), around callables that scan the store:

    hvp(u)        -> H u        (one prefetched pass, its collectives inside)
    hvp_multi(U)  -> H U        (batched: one chunk read serves every column;
                   'features' passes the s Krylov columns only)
    basis_op(u)   -> H~ u       the s-step basis operator (the streamed
                   block-diagonal local Hessian for 'features', the exact
                   streamed HVP on one shard or the resident tau-sample
                   estimate for 'samples')

    ``variant='samples'``: ``g`` is the replicated (d,) gradient and the
    s-step basis is MGS-orthonormalized; ``'features'``: ``g`` is the
    sharded ``(m, d_j)`` gradient of ``group`` (its dots all-reduced), the
    basis scale-managed with the carried ``H p_prev``. ``iters`` counts
    rounds with ``block_s > 1``.

    Each round is a ``pcg.round`` span (its residual test, the loops' one
    host sync a round, included), adds the paper's rounds to the
    ``comm.rounds`` counter (2 a round for 'samples', 1 for 'features', as
    :mod:`repro_torch.core.comm` counts them) with a ``comm.allreduce``
    instant each, then calls ``between_rounds`` (the elastic re-plan
    window: the PCG state is unpermuted, so a callback that swaps what
    ``hvp`` streams, not what it computes, leaves the recurrence exact).
    """
    if variant not in ("samples", "features"):
        raise ValueError(f"unknown streamed variant {variant!r}")
    s = int(block_s)
    if s > 1 and (hvp_multi is None or basis_op is None):
        raise ValueError("streamed s-step PCG (block_s > 1) needs both "
                         "hvp_multi (the batched streamed HVP) and "
                         "basis_op (the zero-communication basis operator)")
    rpi = 2 if variant == "samples" else 1

    def after():
        if obs.enabled():
            obs.count("comm.rounds", rpi)
            for _ in range(rpi):
                obs.instant("comm.allreduce", phase="pcg")
        if between_rounds is not None:
            between_rounds()

    rounds = _Rounds(
        span=lambda t: obs.span("pcg.round", t=t, variant=variant,
                                block_s=s),
        after=after)
    if variant == "samples":
        return _samples_engine(hvp, hvp_multi, basis_op, apply_precond, g,
                               eps, max_iter, s, rounds)
    return _features_engine(hvp, hvp_multi, basis_op, apply_precond,
                            group or InProcessGroup(g.shape[0]), g, eps,
                            max_iter, s, rounds)
