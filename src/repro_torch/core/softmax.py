"""Multinomial softmax regression on the DiSCO skeleton.

The K-class extension of problem (P): weights ``W`` (d, K), margins
``A = X^T W``, class probabilities ``P = softmax(A)`` and the
cross-entropy objective

    f(W) = -(1/n) sum_i log P[i, y_i] + (lam/2) ||W||_F^2.

Gradient and Hessian products stay GLM-shaped (``grad = X (P - Y1) / n +
lam W`` and ``H U = X S / n + lam U`` with the class coupling ``S`` of
:class:`repro_torch.core.hvp.SoftmaxHvpOperator`), so the machinery of
:mod:`repro_torch.core.disco` carries over: both partitionings over a
group of shards (an :class:`repro_torch.parallel.InProcessGroup`, or a
:class:`repro_torch.parallel.DistributedGroup` whose rank holds its own
shard), the damped Newton outer loop, classic and s-step PCG
(:mod:`repro_torch.core.pcg`'s loops). Every Hessian product moves all K
classes through one multi-vector op each way (``xt_multi`` /
``x_cz_multi`` with ``use_kernel=True``, which the ops split into
launches of at most 8 columns on the card), and an s-step round batches
its ``K * (s + 1)`` (DiSCO-S) or ``K * s`` (DiSCO-F) basis columns the
same way.

Softmax cells never fuse (the coupling sits between the passes) and the
streamed layout is not implemented: both are registry-unsupported cells
that raise :class:`repro_torch.core.hvp.UnsupportedHvpError` at set-up.
The port of ``repro.core.softmax``, dense input only, with the same
padding: DiSCO-F pads d to a multiple of the shard count with zero rows,
DiSCO-S pads n with zero-weight samples. At ``hvp_dtype='bfloat16'`` the
Hessian products run on one bf16 copy of X (with ``use_kernel=True`` the
bf16 instances of the multi-vector kernels); the margins, the gradient
and the s-step tau operator keep the f32 X, as in the reference.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core.disco import _to_device, resolve_device, shard_views
from repro_torch.core.hvp import (SoftmaxHvpOperator, make_local_operator,
                                  validate_solver_cell)
from repro_torch.core.pcg import (_feature_scales_update, _krylov_columns,
                                  _mgs, _pcg_loop, _sharded_gram,
                                  _sstep_loop)
from repro_torch.data.sparse import hvp_tile_dtype
from repro_torch.parallel.collectives import InProcessGroup, local_slice
from repro_torch.utils.padding import pad_to_multiple


@dataclasses.dataclass(frozen=True)
class SoftmaxConfig:
    """Hyperparameters of one multinomial softmax solve — the fields and
    defaults of the JAX package's ``repro.core.softmax.SoftmaxConfig``.

    ``n_classes=0`` infers K from the labels. The preconditioner is the
    identity (plain CG): the Woodbury closed form does not extend to the
    (dK x dK) coupled system. ``hvp_fused`` is always an unsupported cell
    (kept so the registry names it); ``hvp_dtype`` is 'float32' or
    'bfloat16' (PCG's products on one bf16 copy of X, as in the module
    notes).
    """

    n_classes: int = 0              # 0 = infer from labels
    lam: float = 1e-4
    partition: str = "samples"      # 'samples' (DiSCO-S) | 'features'
    max_outer: int = 30
    max_pcg: int = 200
    pcg_rel_tol: float = 0.05
    grad_tol: float = 1e-8
    pcg_block_s: int = 1            # s-step PCG rounds
    tau: int = 100                  # s-step basis-estimate sample count
    use_kernel: bool = False        # the dense multi-vector kernels
    hvp_fused: bool = False         # always unsupported for softmax
    hvp_dtype: str = "float32"      # HVP tile storage: float32 | bfloat16


@dataclasses.dataclass
class SoftmaxResult:
    """Outcome of :meth:`SoftmaxSolver.fit`: ``W`` is (d, K) in original
    feature order; ``history`` carries per-outer-iteration stats like
    :class:`repro_torch.core.disco.DiscoResult` (``iter_s`` included)."""

    W: np.ndarray
    history: list[dict[str, Any]]
    converged: bool

    @property
    def grad_norms(self) -> np.ndarray:
        """(outer_iters,) gradient norms, one per outer iteration."""
        return np.array([h["grad_norm"] for h in self.history])


def _labels(y) -> np.ndarray:
    if isinstance(y, torch.Tensor):
        y = y.detach().cpu().numpy()
    return np.asarray(y).astype(np.int64)


class SoftmaxProblem:
    """Single-matrix softmax oracle (the K-class twin of
    :class:`repro_torch.core.glm.GLMProblem`): value, gradient and HVP on
    one ``(d, n)`` tensor. A numpy ``X`` goes to ``device`` (default the
    card; raises with none), a tensor stays where it is."""

    def __init__(self, X, y, n_classes: int = 0, lam: float = 1e-4,
                 device=None):
        if device is not None or not isinstance(X, torch.Tensor):
            device = resolve_device(device)
            X = _to_device(X, device)
        self.X = X.to(torch.float32)
        y = _labels(y)
        K = int(n_classes) or int(y.max()) + 1
        self.n_classes = K
        self.Y1 = torch.from_numpy(np.eye(K, dtype=np.float32)[y]).to(
            self.X.device)
        self.lam = float(lam)
        self.d, self.n = self.X.shape

    def probs(self, W):
        """Row-stochastic class probabilities ``softmax(X^T W)``."""
        return torch.softmax(self.X.T @ W, dim=-1)

    def value(self, W):
        """Regularized mean cross-entropy at ``W``."""
        A = self.X.T @ W
        ce = -torch.sum(self.Y1 * torch.log_softmax(A, dim=-1), dim=-1)
        return torch.mean(ce) + 0.5 * self.lam * torch.sum(W * W)

    def grad(self, W):
        """Gradient ``X (P - Y1) / n + lam W`` (a (d, K) tensor)."""
        return self.X @ (self.probs(W) - self.Y1) / self.n + self.lam * W

    def hvp(self, W, U):
        """K-class Hessian product ``H U`` through the class coupling."""
        op = SoftmaxHvpOperator(make_local_operator(self.X, None),
                                self.probs(W))
        return op.apply(U) / self.n + self.lam * U

    def hessian(self, W):
        """Dense (dK, dK) Hessian, column by column (tiny problems only)."""
        dK = self.d * self.n_classes
        eye = torch.eye(dK, dtype=W.dtype, device=W.device)
        return torch.stack([self.hvp(W, eye[:, j].reshape(W.shape))
                            .reshape(-1) for j in range(dK)], dim=1)


class SoftmaxSolver:
    """Distributed damped-Newton multinomial softmax on dense data.

    The outer loop and both partitionings of
    :class:`repro_torch.core.disco.DiscoSolver`; every Hessian product is
    one multi-vector HVP through :class:`SoftmaxHvpOperator`.

    Args:
        X: (d, n) dense numpy array or tensor (moved to ``device`` as
            f32, without a copy when it is already there and needs no
            padding).
        y: (n,) integer class labels in ``[0, K)``.
        cfg: solver hyperparameters.
        group: the shards (default: one shard): an
            :class:`InProcessGroup`, or a
            :class:`repro_torch.parallel.DistributedGroup`, whose rank
            moves only its own shard of ``X`` to ``device`` (the whole
            ``X`` is given on every rank; :meth:`from_local_block` takes
            only the rank's block).
        device: where the data and the solve live; default ``'cuda'``.
    """

    def __init__(self, X, y, cfg: SoftmaxConfig, group=None, device=None):
        if not isinstance(X, torch.Tensor):
            X = np.asarray(X, np.float32)
        y = _labels(y)
        if len(X.shape) != 2 or y.shape != (X.shape[1],):
            raise ValueError("X must be (d, n), y (n,) int labels")
        K = int(cfg.n_classes) or int(y.max()) + 1
        self._setup(cfg, tuple(X.shape), K, group, device)
        Y1 = np.eye(K, dtype=np.float32)[y]                 # (n, K)
        X_tau, Y1_tau = X[:, :self.tau], Y1[:self.tau]
        axis = 0 if cfg.partition == "features" else 1
        Xp, npad = pad_to_multiple(X, axis, self.m)
        # this process's block of the padded X: its shards' rows
        # (DiSCO-F) or columns (DiSCO-S)
        size, lo = Xp.shape[axis] // self.m, local_slice(self.group)
        block = slice(lo.start * size, lo.stop * size)
        state = dict(X=Xp[block] if axis == 0 else Xp[:, block],
                     X_tau=X_tau, Y1_tau=Y1_tau)
        if cfg.partition == "features":
            state.update(Y1=Y1)
        else:
            state.update(Y1=np.pad(Y1, ((0, npad), (0, 0))),
                         wts=np.pad(np.ones(self.n, np.float32), (0, npad)))
        self._load_state(state)

    @classmethod
    def from_local_block(cls, X_loc, y, cfg: SoftmaxConfig, *, d: int,
                         group=None, device=None) -> "SoftmaxSolver":
        """A solver given only this process's block of the padded X, so
        no process holds the whole matrix: ``X_loc`` is its shards' rows
        (DiSCO-F, ``(d_padded / m * len(group.local), n)``) or columns
        (DiSCO-S, ``(d, n_padded / m * len(group.local))``), as the
        constructor would cut them from the whole ``X`` of ``d`` features
        and ``len(y)`` samples. A tensor already on ``device`` is used
        without a copy. DiSCO-S's tau-sample slab, the first tau columns
        of X, lies in the first shards: the processes holding them
        broadcast it (``group.broadcast_object``)."""
        y = _labels(y)
        K = int(cfg.n_classes) or int(y.max()) + 1
        self = cls.__new__(cls)
        self._setup(cfg, (int(d), len(y)), K, group, device)
        Y1 = np.eye(K, dtype=np.float32)[y]
        X_loc = _to_device(X_loc, self.device)
        if cfg.partition == "features":
            state = dict(X=X_loc, Y1=Y1, Y1_tau=Y1[:self.tau],
                         X_tau=np.zeros((self.d, 0), np.float32))
        else:
            npad = -self.n % self.m
            state = dict(X=X_loc, Y1=np.pad(Y1, ((0, npad), (0, 0))),
                         wts=np.pad(np.ones(self.n, np.float32), (0, npad)),
                         X_tau=self._tau_columns(X_loc),
                         Y1_tau=Y1[:self.tau])
        self._load_state(state)
        return self

    def _tau_columns(self, X_loc) -> np.ndarray:
        """DiSCO-S's first tau columns of X, given this process's block
        ``X_loc``: each shard that holds some of them sends its part
        (``broadcast_object`` from its rank, shard ``s`` being rank ``s``
        in a group of one shard a process)."""
        size = X_loc.shape[1] // self._nl
        parts = []
        for s in range(-(-self.tau // size)):
            mine = s in self.group.local
            j = s - self.group.local[0]
            part = (X_loc[:, j * size:(j + 1) * size][:, :self.tau - s * size]
                    .cpu().numpy() if mine else None)
            parts.append(part if self._nl == self.m
                         else self.group.broadcast_object(part, src=s))
        return np.concatenate(parts, axis=1)

    def _setup(self, cfg: SoftmaxConfig, shape, K: int, group,
               device) -> None:
        validate_solver_cell(family="softmax", partition=cfg.partition,
                             fused=cfg.hvp_fused, dtype=cfg.hvp_dtype,
                             use_kernel=cfg.use_kernel)
        self.hvp_dtype = hvp_tile_dtype(cfg.hvp_dtype)
        if cfg.partition not in ("features", "samples"):
            raise ValueError(f"unknown partition {cfg.partition!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.d, self.n = shape
        self.K = int(K)
        self.tau = min(cfg.tau, self.n)
        self.group = group or InProcessGroup(1)
        self.m = self.group.size
        self._lo = local_slice(self.group)
        self._nl = len(self.group.local)

    def _load_state(self, state: dict) -> None:
        """Move the state to the device and build the step: ``X`` this
        process's block of the padded X (the whole (d_padded, n) for
        DiSCO-F, (d, n_padded) for DiSCO-S in a process holding every
        shard), each local shard a view of it; ``Y1`` (n[_padded], K)
        one-hot labels; ``wts`` (n_padded,) sample weights (DiSCO-S), of
        which this process keeps its shards' rows; ``X_tau``,
        ``Y1_tau``."""
        m, nl, lo = self.m, self._nl, self._lo
        put = lambda a: _to_device(a, self.device)
        self.X = put(state["X"])
        self.Y1 = put(state["Y1"])
        self.X_tau = put(state["X_tau"])
        self.Y1_tau = put(state["Y1_tau"])
        # PCG's shards: views of X at f32 (no copy), else of one copy of X
        # in hvp_dtype, as the reference's X_hvp; the margins, gradient and
        # tau operator stay on the f32 X
        self.X_h = (self.X if self.X.dtype == self.hvp_dtype
                    else self.X.to(self.hvp_dtype))
        self._locs, rem = shard_views(self.X, self.cfg.partition, nl)
        self._hvp_locs = (self._locs if self.X_h is self.X
                          else shard_views(self.X_h, self.cfg.partition,
                                           nl)[0])
        if self.cfg.partition == "features":
            self.d_padded = self.X.shape[0] // nl * m
            self.wts = None
        else:
            self.d_padded = self.d
            self.wts = put(state["wts"].reshape(m, -1)[lo])
            self.Y1 = self.Y1.reshape(m, -1, self.K)[lo]
        if rem:
            raise ValueError(f"X {tuple(self.X.shape)} does not split into "
                             f"{m} equal shards")
        self._step = self._build_step()

    # ------------------------------------------------------------------
    def _pcg(self, hvp_flat, basis_parts, psum_dot, g_flat, eps):
        """Classic or s-step PCG over the flattened (d * K) system."""
        cfg = self.cfg
        if cfg.pcg_block_s <= 1:
            return _pcg_loop(hvp_flat, lambda r: r, psum_dot, g_flat, eps,
                             cfg.max_pcg)
        build_basis, hvp_round, gram, update_scales = basis_parts
        combine = torch.matmul
        if cfg.partition == "features":
            # U a shard by shard: a batched (nl, dl K, k) @ (k,) may block
            # its rows by the batch, and the groups batch different shard
            # counts
            def combine(U, a):
                return torch.stack([U[j] @ a for j in range(self._nl)])
        return _sstep_loop(build_basis, hvp_round, gram, update_scales,
                           psum_dot, g_flat, eps, cfg.max_pcg,
                           int(cfg.pcg_block_s), combine=combine)

    def _build_step(self):
        """The Newton step over this process's shards ``self._locs``;
        returns ``step(W) -> (W_new, stats)``."""
        cfg, group, K = self.cfg, self.group, self.K
        n, tau, m, nl, lam = self.n, self.tau, self.m, self._nl, cfg.lam
        s = int(cfg.pcg_block_s)
        locs = self._locs
        bases = [make_local_operator(X_loc, None, use_kernel=cfg.use_kernel,
                                     partition=cfg.partition)
                 for X_loc in self._hvp_locs]

        if cfg.partition == "samples":
            dp = self.d_padded

            def step(W):                                   # W: (dp, K)
                A = [X_loc.T @ W for X_loc in locs]        # (n_loc, K) each
                P = [torch.softmax(a, dim=-1) for a in A]
                fval = group.all_reduce([
                    torch.sum(-torch.sum(self.Y1[j] * torch.log_softmax(
                        A[j], dim=-1), dim=-1) * self.wts[j])
                    for j in range(nl)]) / n + 0.5 * lam * torch.sum(W * W)
                G = group.all_reduce([
                    locs[j] @ ((P[j] - self.Y1[j]) * self.wts[j][:, None])
                    for j in range(nl)]) / n + lam * W
                gnorm = torch.sqrt(torch.sum(G * G))
                soms = [SoftmaxHvpOperator(bases[j], P[j],
                                           weights=self.wts[j])
                        for j in range(nl)]

                def hvp_flat(u):
                    U = u.reshape(dp, K)
                    HU = group.all_reduce([som.apply(U) for som in soms]) \
                        / n + lam * U
                    return HU.reshape(-1)

                # s-step (MGS basis; all s + 1 columns ride one batched
                # K (s + 1)-wide multi-vector product)
                if m == 1:
                    basis_flat = hvp_flat     # exact single-shard operator
                else:
                    som_tau = SoftmaxHvpOperator(
                        make_local_operator(self.X_tau, None),
                        torch.softmax(self.X_tau.T @ W, dim=-1))

                    def basis_flat(u):
                        U = u.reshape(dp, K)
                        return (som_tau.apply(U) / tau + lam * U).reshape(-1)

                ones = torch.ones((max(s - 1, 1),), dtype=W.dtype,
                                  device=W.device)

                def build_basis(r, p, scales):
                    cols = _krylov_columns(r, lambda x: x, basis_flat, s,
                                           ones)
                    cols.append(p)
                    return torch.stack(_mgs(cols), dim=1)

                def hvp_round(U, Hp):
                    U3 = U.reshape(dp, K, U.shape[1])
                    W3 = group.all_reduce([som.apply_batch(U3)
                                           for som in soms]) / n + lam * U3
                    return W3.reshape(dp * K, U.shape[1])

                def gram(U, Wm, r):
                    return U.T @ Wm, U.T @ U, U.T @ r

                res = self._pcg(hvp_flat, (build_basis, hvp_round, gram,
                                           lambda scales, B: scales),
                                torch.dot, G.reshape(-1),
                                cfg.pcg_rel_tol * gnorm)
                W_new = W - res.v.reshape(dp, K) / (1.0 + res.delta)
                return W_new, dict(grad_norm=gnorm, f=fval,
                                   pcg_iters=res.iters, delta=res.delta,
                                   pcg_r_norm=res.r_norm)

        else:  # features
            dl = self.d_padded // m

            def step(W):                                  # W: (nl, dl, K)
                A = group.all_reduce([locs[j].T @ W[j] for j in range(nl)])
                P = torch.softmax(A, dim=-1)               # (n, K)
                ce = -torch.sum(self.Y1 * torch.log_softmax(A, dim=-1),
                                dim=-1)
                fval = torch.sum(ce) / n + 0.5 * lam * group.all_reduce(
                    [torch.sum(W[j] * W[j]) for j in range(nl)])
                G = torch.stack([X_loc @ (P - self.Y1) for X_loc in locs]) \
                    / n + lam * W
                gnorm = torch.sqrt(group.all_reduce(
                    [torch.sum(G[j] * G[j]) for j in range(nl)]))
                soms = [SoftmaxHvpOperator(base, P) for base in bases]

                def psum_dot(a, b):
                    return group.all_reduce([torch.dot(a[j], b[j])
                                             for j in range(nl)])

                def hvp_flat(u):
                    # the DiSCO-F communication, K columns wide: one (n, K)
                    # all-reduce between pass A and pass B
                    U = u.reshape(nl, dl, K)
                    V = group.all_reduce([bases[j].pass_a_multi(U[j])
                                          for j in range(nl)])
                    S = soms[0].coupling(V)
                    HU = torch.stack([base.pass_b_multi(S)
                                      for base in bases]) / n + lam * U
                    return HU.reshape(nl, -1)

                def basis_flat(u):
                    # zero-communication block-diagonal local operator
                    U = u.reshape(nl, dl, K)
                    HU = torch.stack([soms[j].apply(U[j])
                                      for j in range(nl)]) / n + lam * U
                    return HU.reshape(nl, -1)

                def build_basis(r, p, scales):
                    cols = _krylov_columns(r, lambda x: x, basis_flat, s,
                                           scales)
                    cols.append(p)
                    return torch.stack(cols, dim=2)    # (nl, dl K, s + 1)

                def hvp_round(U, Hp):
                    U3 = U[:, :, :s].reshape(nl, dl, K, s)
                    V = group.all_reduce([
                        bases[j].pass_a_multi(U3[j].reshape(dl, K * s))
                        for j in range(nl)])             # (n, K s)
                    S = soms[0].coupling(V.reshape(-1, K, s)).reshape(
                        -1, K * s)
                    W3 = torch.stack([base.pass_b_multi(S).reshape(dl, K, s)
                                      for base in bases]) / n + lam * U3
                    return torch.cat([W3.reshape(nl, dl * K, s),
                                      Hp[:, :, None]], dim=2)

                res = self._pcg(
                    hvp_flat,
                    (build_basis, hvp_round,
                     lambda U, Wm, r: _sharded_gram(group, U, Wm, r),
                     lambda scales, B: _feature_scales_update(scales, B,
                                                              s)),
                    psum_dot, G.reshape(nl, -1), cfg.pcg_rel_tol * gnorm)
                W_new = W - res.v.reshape(nl, dl, K) / (1.0 + res.delta)
                return W_new, dict(grad_norm=gnorm, f=fval,
                                   pcg_iters=res.iters, delta=res.delta,
                                   pcg_r_norm=res.r_norm)

        return step

    # ------------------------------------------------------------------
    def fit(self, W0: np.ndarray | None = None) -> SoftmaxResult:
        """Damped Newton outer loop from ``W0`` (default zeros); ``W0``
        and the returned ``W`` are (d, K) in original feature order. A
        process starts from its shards' rows of ``W0`` (DiSCO-F) and ends
        with every shard's rows gathered (``group.all_gather``), so every
        process returns the same ``W``."""
        cfg = self.cfg
        W = np.zeros((self.d_padded, self.K), np.float32)
        if W0 is not None:
            W0 = np.asarray(W0, np.float32)
            W[:W0.shape[0]] = W0
        if cfg.partition == "features":
            W = W.reshape(self.m, -1, self.K)[self._lo]
        W = torch.from_numpy(np.ascontiguousarray(W)).to(self.device)

        history: list[dict[str, Any]] = []
        converged = False
        for k in range(cfg.max_outer):
            t_it = time.perf_counter()
            W, stats = self._step(W)
            # the float() reads wait for the step's device work
            stats = {name: float(v) for name, v in stats.items()}
            stats.update(iter_s=time.perf_counter() - t_it, outer_iter=k)
            history.append(stats)
            if stats["grad_norm"] <= cfg.grad_tol:
                converged = True
                break
        if cfg.partition == "features":
            W = self.group.all_gather(W)
        W = W.reshape(self.d_padded, self.K)[:self.d]
        return SoftmaxResult(W=W.cpu().numpy(), history=history,
                             converged=converged)


def softmax_fit(X, y, cfg: SoftmaxConfig | None = None, group=None,
                W0: np.ndarray | None = None, device=None) -> SoftmaxResult:
    """One-call convenience wrapper: build a :class:`SoftmaxSolver`, fit.

    Args:
        X: (d, n) dense feature-major data (numpy array or tensor).
        y: (n,) integer class labels in ``[0, K)``.
        cfg: solver hyperparameters (defaults: :class:`SoftmaxConfig`).
        group: the shards (default: one shard): an ``InProcessGroup`` or
            a ``DistributedGroup`` (call it on every rank).
        W0: optional (d, K) warm start.
        device: default ``'cuda'``; ``'cpu'`` runs the plain versions.
    """
    cfg = cfg or SoftmaxConfig()
    return SoftmaxSolver(X, y, cfg, group=group, device=device).fit(W0)
