"""DiSCO: inexact damped Newton (paper Algorithm 1) with distributed PCG.

``DiscoSolver`` owns the sharded data on one device, the Newton step and the
outer loop. The step — gradient, PCG (Algorithm 2 or 3), damped update —
runs over the ``m`` shards of an :class:`repro_torch.parallel.InProcessGroup`,
so every collective the algorithm pays is an explicit ``all_reduce``.

Partitioning:
  * ``partition='samples'``  -> DiSCO-S (Algorithm 2)
  * ``partition='features'`` -> DiSCO-F (Algorithm 3)

The damped update is  w_{k+1} = w_k - v_k / (1 + delta_k),
delta_k = sqrt(v_k^T H v_k).

The port runs the in-memory paths: a sparse :class:`CSRMatrix` input
(every product with X through the blocked-ELL ops) or a dense ``(d, n)``
f32 array or tensor (margins and gradient in ``torch.matmul``, as the JAX
package leaves them to XLA; every HVP of PCG through the dense kernels
with ``use_kernel=True``, else ``torch.matmul``), classic or s-step PCG
(``pcg_block_s > 1``), f32. On the card the ops are the CUDA kernels.
Hessian subsampling, the SAG preconditioner, bf16 tiles, checkpointing,
tracing and s-step PCG on fused dense input (its ``x_c_xt_multi``
kernel) are not yet ported and raise.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core import comm
from repro_torch.core.hvp import validate_solver_cell
from repro_torch.core.losses import get_loss
from repro_torch.core.pcg import pcg_features, pcg_samples
from repro_torch.data.partition import Partition, make_partition
from repro_torch.data.sparse import (CSRMatrix, EllPair,
                                     build_shard_ell_pairs, hvp_tile_dtype,
                                     shard_csrs_from_partition)
from repro_torch.kernels import ops as kops
from repro_torch.parallel.collectives import InProcessGroup
from repro_torch.utils.padding import pad_to_multiple


@dataclasses.dataclass(frozen=True)
class DiscoConfig:
    """Hyperparameters of one DiSCO solve — the same fields and defaults
    as the JAX package's ``repro.core.DiscoConfig``.

    Ported here: loss, lam, mu, tau, partition, precond ('woodbury' |
    'none'), max_outer, max_pcg, pcg_rel_tol, grad_tol, use_kernel (dense
    input), hvp_fused, pcg_block_s (s-step PCG; ``max_pcg`` then caps
    rounds), partition_strategy, partition_block, ell_block_d,
    ell_block_n (sparse input). The fields for the paths not yet ported
    must keep their defaults (``hessian_subsample=1``,
    ``hvp_dtype='float32'``, ``trace=False``, ``precond != 'sag'``), and
    ``pcg_block_s > 1`` with fused dense kernels
    (``use_kernel=hvp_fused=True``) raises for DiSCO-S and for DiSCO-F
    on one shard, whose s-step round needs the ``x_c_xt_multi`` kernel;
    the out-of-core fields are unused.
    """

    loss: str = "logistic"
    lam: float = 1e-4
    mu: float = 1e-2                # preconditioner damping (paper uses 1e-2)
    tau: int = 100                  # preconditioner sample count (paper: ~100)
    partition: str = "features"     # 'features' (DiSCO-F) | 'samples' (DiSCO-S)
    precond: str = "woodbury"       # 'woodbury' | 'sag' (orig. DiSCO) | 'none'
    max_outer: int = 30
    max_pcg: int = 256
    pcg_rel_tol: float = 0.05       # eps_k = pcg_rel_tol * ||grad||
    grad_tol: float = 1e-8
    hessian_subsample: float = 1.0  # paper §5.4; fraction of samples in H u
    sag_epochs: int = 5             # inner epochs for the 'sag' baseline
    use_kernel: bool = False        # dense inputs only
    hvp_fused: bool = False         # one-pass fused HVP (ell_hvp kernel)
    hvp_dtype: str = "float32"      # HVP tile storage: float32 | bfloat16
    pcg_block_s: int = 1            # s-step PCG: Krylov vectors per comm round
    partition_strategy: str = "lpt"  # sparse: 'lpt' (nnz-balanced) | 'width'
    partition_block: int = 1        # nnz-balancer granularity (indices/block)
    ell_block_d: int = 128          # sparse tile rows (feature axis)
    ell_block_n: int = 128          # sparse tile cols (sample axis)
    stream_chunk_size: int = 4096   # out-of-core: indices per disk chunk
    prefetch_depth: int = 2         # out-of-core: chunks prefetched ahead
    elastic_replan: bool = False    # re-plan shards on measured chunk cost
    replan_threshold: float = 1.5   # observed max/mean seconds that arms it
    io_retries: int = 3             # stream-step retries on transient I/O
    io_backoff_s: float = 0.05      # first-retry backoff (doubles each try)
    io_deadline_s: float = 0.0      # per-step wall-clock budget (0 = none)
    trace: bool = False             # tracing plane (not yet ported)
    seed: int = 0


@dataclasses.dataclass
class DiscoResult:
    """Outcome of :meth:`DiscoSolver.fit`.

    Attributes:
        w: (d,) solution in the *original* feature order.
        history: per-outer-iteration stats dicts (grad_norm, f,
            pcg_iters (rounds with ``pcg_block_s > 1``), delta, pcg_r_norm, iter_s, outer_iter,
            comm_rounds_cum, comm_floats_cum).
        ledger: analytic communication totals (:class:`comm.CommLedger`).
        converged: True iff ||grad|| reached ``cfg.grad_tol``.
        partition_info: :meth:`Partition.stats` of the load balance
            (sparse input; None for dense, which slices equal-width).
        stream_stats, replan_events: out-of-core fields, always empty here.
    """

    w: np.ndarray
    history: list[dict[str, Any]]
    ledger: comm.CommLedger
    converged: bool
    partition_info: dict[str, Any] | None = None
    stream_stats: dict[str, Any] | None = None
    replan_events: list[dict[str, Any]] = dataclasses.field(
        default_factory=list)

    @property
    def grad_norms(self) -> np.ndarray:
        """(outer_iters,) gradient norms, one per outer iteration."""
        return np.array([h["grad_norm"] for h in self.history])

    @property
    def comm_rounds(self) -> np.ndarray:
        """(outer_iters,) cumulative paper-style communication rounds."""
        return np.array([h["comm_rounds_cum"] for h in self.history])


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch device; ``None`` means the card. Raises when a
    CUDA device is asked for (or implied) and none is present — the port
    never quietly continues on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    return dev


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not yet ported to repro_torch")


def _to_device(a, device) -> torch.Tensor:
    """A numpy array or tensor on ``device``, floating types as f32,
    contiguous; no copy when it is already so."""
    if not isinstance(a, torch.Tensor):
        a = np.ascontiguousarray(a)
        if not a.flags.writeable:     # e.g. read from another framework
            a = a.copy()
        a = torch.from_numpy(a)
    if a.is_floating_point():
        a = a.to(torch.float32)
    return a.to(device).contiguous()


class DiscoSolver:
    """Distributed inexact damped Newton for problem (P).

    Args:
        X: (d, n) data in the feature-major convention: a
            :class:`CSRMatrix` (sparse), or a dense numpy array or tensor
            (any device; it is moved to ``device`` as f32, without a copy
            when it is already there).
        y: (n,) labels (+-1 for classification losses).
        cfg: solver hyperparameters.
        group: the shards (default: one shard).
        device: where the data and the solve live; default ``'cuda'``.
    """

    def __init__(self, X, y, cfg: DiscoConfig,
                 group: InProcessGroup | None = None, device=None):
        sparse = isinstance(X, CSRMatrix)
        if not sparse and not isinstance(X, torch.Tensor):
            X = np.asarray(X)
        if len(X.shape) != 2:
            raise ValueError("X must be (d, n)")
        if isinstance(y, torch.Tensor):
            y = y.detach().cpu().numpy()
        y = np.asarray(y)
        if y.shape != (X.shape[1],):
            raise ValueError("X must be (d, n), y (n,)")
        self._setup(cfg, tuple(X.shape), group, device, sparse=sparse)
        if sparse:
            self._init_sparse(X, y)
        else:
            self._init_dense(X, y)

    def _setup(self, cfg: DiscoConfig, shape, group, device, *,
               sparse: bool) -> None:
        if cfg.hessian_subsample < 1.0:
            raise _not_ported("hessian_subsample < 1")
        if cfg.precond == "sag":
            raise _not_ported("precond='sag'")
        if cfg.trace:
            raise _not_ported("tracing (trace=True)")
        hvp_tile_dtype(cfg.hvp_dtype)
        validate_solver_cell(family="binary", partition=cfg.partition,
                             fused=cfg.hvp_fused, dtype=cfg.hvp_dtype,
                             sparse=sparse, use_kernel=cfg.use_kernel)
        if cfg.partition not in ("features", "samples"):
            raise ValueError(f"unknown partition {cfg.partition!r}")
        self.cfg = cfg
        self.loss = get_loss(cfg.loss)
        self.device = resolve_device(device)
        self.d, self.n = shape
        self.tau = min(cfg.tau, self.n)
        self.group = group or InProcessGroup(1)
        self.m = self.group.size
        if (cfg.pcg_block_s > 1 and not sparse and cfg.use_kernel
                and cfg.hvp_fused
                and (cfg.partition == "samples" or self.m == 1)):
            raise _not_ported("s-step PCG on fused dense input (its round "
                              "needs the x_c_xt_multi kernel)")
        self._sparse = sparse
        self._part: Partition | None = None
        self.smask = None

    def _init_sparse(self, X: CSRMatrix, y):
        """Partition (load-balanced), tile and shard a sparse matrix.

        The chosen axis is permuted by the nnz-aware partitioner, each
        shard's local matrix is laid out as a forward + transposed
        blocked-ELL pair, and the tau preconditioner samples are
        materialized as a small dense slab.
        """
        cfg, m = self.cfg, self.m
        br, bc = cfg.ell_block_d, cfg.ell_block_n
        d, n = self.d, self.n
        dtype = X.dtype

        # preconditioner samples: the first tau *original* columns
        X_tau = X.take_cols_dense(np.arange(self.tau))          # (d, tau)
        y_tau = y[: self.tau].copy()
        part = make_partition(X, cfg.partition, m, cfg.partition_strategy,
                              block=cfg.partition_block,
                              pad_multiple=br if cfg.partition == "features"
                              else bc)
        shard_csrs = shard_csrs_from_partition(X, part, cfg.partition)
        data, cols, dataT, colsT = build_shard_ell_pairs(shard_csrs, br, bc)
        state = dict(ell_data=data, ell_cols=cols, ell_dataT=dataT,
                     ell_colsT=colsT, y_tau=y_tau)
        if cfg.partition == "features":
            n_padded = dataT.shape[1] * bc
            smask = np.zeros(n_padded, dtype)
            smask[:n] = 1.0
            X_tau_p = np.zeros((len(part.perm), self.tau), dtype)
            valid = part.perm < d
            X_tau_p[valid] = X_tau[part.perm[valid]]
            state.update(y=np.pad(y, (0, n_padded - n)), smask=smask,
                         X_tau=X_tau_p)
        else:
            n_padded = len(part.perm)
            ext = lambda v: np.pad(v, (0, n_padded - n))
            X_tau_p = np.zeros((data.shape[1] * br, self.tau), dtype)
            X_tau_p[:d] = X_tau
            state.update(y=ext(y)[part.perm],
                         weights=ext(np.ones(n, dtype))[part.perm],
                         X_tau=X_tau_p)
        self._part = part
        self._load_state(state, part.perm)

    def _init_dense(self, X, y):
        """Pad and shard a dense matrix, once.

        DiSCO-F pads d to a multiple of m with zero rows, DiSCO-S pads n
        with zero columns of zero weight; the preconditioner samples are
        the first tau columns. A tensor already on the device with no
        padding to do is used as it is, without a copy.
        """
        cfg, m, tau = self.cfg, self.m, self.tau
        X_tau, y_tau = X[:, :tau], y[:tau]
        if cfg.partition == "features":
            Xp, _ = pad_to_multiple(X, 0, m)
            X_tau_p, _ = pad_to_multiple(X_tau, 0, m)
            state = dict(X=Xp, X_tau=X_tau_p, y=y, y_tau=y_tau)
        else:
            Xp, _ = pad_to_multiple(X, 1, m)
            yp, npad = pad_to_multiple(y, 0, m)
            wts = np.pad(np.ones(self.n, np.float32), (0, npad))
            state = dict(X=Xp, X_tau=X_tau, y=yp, weights=wts, y_tau=y_tau)
        self._load_dense_state(state)

    def _load_state(self, state: dict, perm: np.ndarray) -> None:
        """Move the host arrays of the sharded sparse state to the device.

        Samples state: ``y``/``weights`` (n_padded,) in partition order,
        ``X_tau`` (d_padded, tau) replicated. Features state: ``y``/
        ``smask`` (n_padded,) replicated, ``X_tau`` (d_padded, tau) in
        partition order. Both: the stacked ``(m, ...)`` ELL arrays.
        """
        m = self.m
        put = lambda a: _to_device(a, self.device)
        self._perm = np.asarray(perm)
        self.ell_data = put(state["ell_data"])
        self.ell_cols = put(state["ell_cols"])
        self.ell_dataT = put(state["ell_dataT"])
        self.ell_colsT = put(state["ell_colsT"])
        if self.ell_data.shape[0] != m:
            raise ValueError(f"state has {self.ell_data.shape[0]} shards, "
                             f"the group {m}")
        self._locs = [EllPair(self.ell_data[s], self.ell_cols[s],
                              self.ell_dataT[s], self.ell_colsT[s])
                      for s in range(m)]
        if self.cfg.partition == "features":
            self.smask = put(state["smask"])
        self._load_vectors(state)

    def _load_dense_state(self, state: dict) -> None:
        """Move the dense state to the device: ``X`` (d_padded, n) for
        DiSCO-F, (d, n_padded) for DiSCO-S, and the vectors as for the
        sparse state (without ``smask``: DiSCO-F pads only d). Each shard
        is a view of ``X``: a block of rows (DiSCO-F) or of columns
        (DiSCO-S)."""
        m = self.m
        self.X = _to_device(state["X"], self.device)
        if self.cfg.partition == "features":
            d_loc, rem = divmod(self.X.shape[0], m)
            self._locs = [self.X[s * d_loc:(s + 1) * d_loc]
                          for s in range(m)]
            self._perm = np.arange(self.X.shape[0])
        else:
            n_loc, rem = divmod(self.X.shape[1], m)
            self._locs = [self.X[:, s * n_loc:(s + 1) * n_loc]
                          for s in range(m)]
        if rem:
            raise ValueError(f"X {tuple(self.X.shape)} does not split into "
                             f"{m} equal shards")
        self._load_vectors(state)

    def _load_vectors(self, state: dict) -> None:
        """The vectors and the preconditioner slab, and the step built on
        the loaded shards."""
        m = self.m
        put = lambda a: _to_device(a, self.device)
        self.y_tau = put(state["y_tau"])
        X_tau = put(state["X_tau"])
        if self.cfg.partition == "features":
            self.y = put(state["y"])
            self.X_tau = X_tau.reshape(m, -1, X_tau.shape[1])
            self._w_shape = (m, X_tau.shape[0] // m)
        else:
            self.y = put(state["y"]).reshape(m, -1)
            self.weights = put(state["weights"]).reshape(m, -1)
            self.X_tau = X_tau
            self._w_shape = (X_tau.shape[0],)
        self._step = self._build_step()

    # ------------------------------------------------------------------
    def _build_step(self):
        """The Newton step over the shards ``self._locs``. Margins and
        gradient go through the blocked-ELL ops (sparse) or
        ``torch.matmul`` (dense); PCG's HVPs through the local operator
        of :func:`repro_torch.core.hvp.make_local_operator`. Returns
        ``step(w) -> (w_new, stats)``."""
        cfg, loss, group = self.cfg, self.loss, self.group
        n, tau, m = self.n, self.tau, self.m
        locs = self._locs
        if self._sparse:
            def xt(s, v):                  # X_s^T v
                return kops.ell_matvec(locs[s].dataT, locs[s].colsT, v)

            def xv(s, v):                  # X_s v
                return kops.ell_matvec(locs[s].data, locs[s].cols, v)
        else:
            def xt(s, v):
                return locs[s].T @ v

            def xv(s, v):
                return locs[s] @ v

        if cfg.partition == "features":
            smask = self.smask

            def step(w):                                   # w: (m, d_j)
                margins = group.all_reduce([xt(s, w[s]) for s in range(m)])
                d1 = loss.d1(margins, self.y)
                c = loss.d2(margins, self.y)
                vals = loss.value(margins, self.y)
                if smask is not None:          # ELL-padded samples
                    d1, c, vals = d1 * smask, c * smask, vals * smask
                g = torch.stack([xv(s, d1) for s in range(m)]) / n \
                    + cfg.lam * w
                gnorm = torch.sqrt(group.all_reduce(
                    [torch.dot(g[s], g[s]) for s in range(m)]))
                fval = torch.sum(vals) / n + 0.5 * cfg.lam * \
                    group.all_reduce([torch.dot(w[s], w[s])
                                      for s in range(m)])
                coeffs_tau = loss.d2(margins[:tau], self.y_tau)

                eps = cfg.pcg_rel_tol * gnorm
                res = pcg_features(
                    locs, c, n, cfg.lam, g, eps, cfg.max_pcg,
                    coeffs_tau=coeffs_tau, mu=cfg.mu, group=group,
                    precond=cfg.precond, block_s=cfg.pcg_block_s,
                    X_tau_loc=self.X_tau, hvp_fused=cfg.hvp_fused,
                    use_kernel=cfg.use_kernel)
                w_new = w - res.v / (1.0 + res.delta)
                return w_new, dict(grad_norm=gnorm, f=fval,
                                   pcg_iters=res.iters, delta=res.delta,
                                   pcg_r_norm=res.r_norm)

        else:  # samples
            def step(w):                                   # w: (d_padded,)
                margins = torch.stack([xt(s, w) for s in range(m)])
                d1 = loss.d1(margins, self.y) * self.weights   # (m, n_loc)
                c = loss.d2(margins, self.y) * self.weights
                g = group.all_reduce(
                    [xv(s, d1[s]) for s in range(m)]) / n + cfg.lam * w
                gnorm = torch.sqrt(torch.dot(g, g))
                fval = group.all_reduce(
                    [torch.sum(loss.value(margins[s], self.y[s])
                               * self.weights[s]) for s in range(m)]) / n \
                    + 0.5 * cfg.lam * torch.dot(w, w)
                coeffs_tau = loss.d2(self.X_tau.T @ w, self.y_tau)

                eps = cfg.pcg_rel_tol * gnorm
                res = pcg_samples(
                    locs, c, n, cfg.lam, g, eps, cfg.max_pcg,
                    X_tau=self.X_tau, coeffs_tau=coeffs_tau, mu=cfg.mu,
                    group=group, precond=cfg.precond,
                    block_s=cfg.pcg_block_s, hvp_fused=cfg.hvp_fused,
                    use_kernel=cfg.use_kernel)
                w_new = w - res.v / (1.0 + res.delta)
                return w_new, dict(grad_norm=gnorm, f=fval,
                                   pcg_iters=res.iters, delta=res.delta,
                                   pcg_r_norm=res.r_norm)

        return step

    # ------------------------------------------------------------------
    def _comm_costs(self, pcg_iters: int) -> tuple[int, int, int]:
        """Paper-style (rounds, floats, spmd) of one outer step;
        ``pcg_iters`` is PCG iterations, or rounds (each worth up to
        ``pcg_block_s`` iterations) on the s-step path."""
        s = self.cfg.pcg_block_s
        if self.cfg.partition == "features":
            r1, f1, s1 = comm.disco_f_outer_cost(self.n, self.d, self.m)
            if s > 1:
                r2, f2, s2 = comm.disco_f_sstep_cost(self.n, s, pcg_iters)
            else:
                r2, f2, s2 = comm.disco_f_pcg_cost(self.n, pcg_iters)
        else:
            r1, f1, s1 = comm.disco_s_outer_cost(self.d)
            if s > 1:
                r2, f2, s2 = comm.disco_s_sstep_cost(self.d, s, pcg_iters)
            else:
                r2, f2, s2 = comm.disco_s_pcg_cost(self.d, pcg_iters)
        return r1 + r2, f1 + f2, s1 + s2

    def _w_to_original(self, w) -> np.ndarray:
        """Iterate ``w`` back in the original feature order (padding
        slots dropped, any load-balancing permutation undone)."""
        w_np = w.detach().reshape(-1).cpu().numpy()
        if self.cfg.partition == "features":
            w_full = np.zeros(self.d, w_np.dtype)
            valid = self._perm < self.d
            w_full[self._perm[valid]] = w_np[valid]
            return w_full
        return w_np[: self.d]

    def _w_from_original(self, w0) -> torch.Tensor:
        """``w0`` (original order) padded, permuted and on the device."""
        size = int(np.prod(self._w_shape))
        w0 = np.pad(np.asarray(w0), (0, size - len(w0)))
        if self.cfg.partition == "features":
            w0 = w0[self._perm]  # into load-balanced order
        return torch.from_numpy(w0.astype(np.float32)).to(
            self.device).reshape(self._w_shape)

    def fit(self, w0: np.ndarray | None = None, *,
            checkpoint_dir: str | None = None, checkpoint_every: int = 1,
            resume: bool = False) -> DiscoResult:
        """Run the damped Newton outer loop from ``w0`` (default zeros).

        ``w0`` is given — and ``DiscoResult.w`` returned — in the
        original feature order. Checkpointing is not yet ported.
        """
        if checkpoint_dir is not None or resume:
            raise _not_ported("checkpoint/resume")
        cfg = self.cfg
        history: list[dict[str, Any]] = []
        ledger = comm.CommLedger()
        if w0 is None:
            w = torch.zeros(self._w_shape, dtype=torch.float32,
                            device=self.device)
        else:
            w = self._w_from_original(w0)

        converged = False
        for k in range(cfg.max_outer):
            t_it = time.perf_counter()
            w, stats = self._step(w)
            # the float() reads wait for the step's device work, so
            # iter_s covers the whole step
            stats = {name: float(v) for name, v in stats.items()}
            stats["iter_s"] = time.perf_counter() - t_it
            rounds, floats, spmd = self._comm_costs(int(stats["pcg_iters"]))
            ledger.add(rounds, floats, spmd)
            stats.update(outer_iter=k, comm_rounds_cum=ledger.rounds,
                         comm_floats_cum=ledger.floats)
            history.append(stats)
            if stats["grad_norm"] <= cfg.grad_tol:
                converged = True
                break

        return DiscoResult(w=self._w_to_original(w), history=history,
                           ledger=ledger, converged=converged,
                           partition_info=(self._part.stats()
                                           if self._part else None))


def disco_fit(X, y, cfg: DiscoConfig | None = None,
              group: InProcessGroup | None = None,
              w0: np.ndarray | None = None, device=None) -> DiscoResult:
    """One-call convenience wrapper: build a :class:`DiscoSolver`, fit.

    Args:
        X: (d, n) feature-major :class:`CSRMatrix`, or a dense numpy
            array or tensor.
        y: (n,) labels.
        cfg: solver hyperparameters (defaults: :class:`DiscoConfig`).
        group: the shards (default: one shard).
        w0: optional (d,) warm start in original feature order.
        device: default ``'cuda'``; ``'cpu'`` runs the plain versions.
    """
    cfg = cfg or DiscoConfig()
    return DiscoSolver(X, y, cfg, group=group, device=device).fit(w0)
