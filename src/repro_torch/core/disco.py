"""DiSCO: inexact damped Newton (paper Algorithm 1) with distributed PCG.

``DiscoSolver`` owns the sharded data, the Newton step and the outer loop.
The step — gradient, PCG (Algorithm 2 or 3), damped update — runs over the
shards of a group: all ``m`` in this process on one device
(:class:`repro_torch.parallel.InProcessGroup`), or one a process
(:class:`repro_torch.parallel.DistributedGroup`, each rank holding its
shard on its device); either way every collective the algorithm pays is
an explicit ``all_reduce`` and the loops run over ``group.local``, the
shards this process holds. At a given ``m`` the two groups give the same
result bit for bit: the host builds the same partition and layouts, each
process keeps its shards of them, and every cross-shard sum is the
groups' ordered sum.

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
(``pcg_block_s > 1``), with the Woodbury, SAG (the original DiSCO's) or
no preconditioner and optional Hessian subsampling. On the card the ops
are the CUDA kernels. PCG's HVP tiles are f32 or bf16
(``hvp_dtype='bfloat16'``: bf16 copies of the two sparse layouts, or of
the dense X, for PCG, the f32 data kept for the margins and the
gradient, as in the reference; with the two-pass or the one-pass
kernels alike). ``trace=True`` turns on the tracing plane
(:mod:`repro_torch.obs`: a ``newton.outer`` span a step and the analytic
``comm.*`` counters); ``fit(checkpoint_dir=..., resume=True)`` writes and
resumes atomic checkpoints (:mod:`repro_torch.robust.checkpoint`, the
reference's format). :meth:`DiscoSolver.with_lam`
re-targets a built solver at another ``lam`` on the same device tensors
(the λ-path, :mod:`repro_torch.core.lambda_path`).
:meth:`DiscoSolver.from_store` (and :func:`disco_fit_streaming`) runs the
same solve out of core: X stays in a :class:`repro_torch.data.store
.ShardStore` and every product with it is a prefetched pass over the
store's chunks (:mod:`repro_torch.data.stream`), with retries, elastic
re-planning and ``DiscoResult.stream_stats``.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core import comm
from repro_torch.core.hvp import StreamedHvpOperator, validate_solver_cell
from repro_torch.core.losses import get_loss
from repro_torch.core.pcg import (_features_precond, _samples_basis_op,
                                  _samples_precond, pcg_features,
                                  pcg_samples, pcg_streamed)
from repro_torch.data.partition import Partition, make_partition
from repro_torch.data.sparse import (CSRMatrix, EllPair,
                                     build_shard_ell_pairs, hvp_tile_dtype,
                                     shard_csrs_from_partition)
from repro_torch.data.store import ShardStore
from repro_torch.data.stream import plan_streams
from repro_torch.kernels import ops as kops
from repro_torch.kernels.sparse_hvp import (default_ctas,
                                            ell_hvp_schedule,
                                            ell_schedule,
                                            schedule_parts)
from repro_torch.obs import tracer as obs
from repro_torch.parallel.collectives import InProcessGroup, local_slice
from repro_torch.robust.checkpoint import (CheckpointState, load_checkpoint,
                                           save_checkpoint)
from repro_torch.robust.faults import FaultInjector, FaultPlan
from repro_torch.robust.retry import RetryPolicy
from repro_torch.robust.straggler import ChunkTimingLedger, ElasticReplanner
from repro_torch.utils.device import resolve_device
from repro_torch.utils.padding import pad_to_multiple


@dataclasses.dataclass(frozen=True)
class DiscoConfig:
    """Hyperparameters of one DiSCO solve — the same fields and defaults
    as the JAX package's ``repro.core.DiscoConfig``.

    Ported here: loss, lam, mu, tau, partition, precond ('woodbury' |
    'sag' (DiSCO-S only, ``sag_epochs`` inner epochs) | 'none'),
    max_outer, max_pcg, pcg_rel_tol, grad_tol, hessian_subsample (each
    outer step draws fresh masks from ``seed``: :func:`subsample_mask`),
    use_kernel (dense input), hvp_fused, hvp_dtype ('float32' or
    'bfloat16', on every input, two-pass or fused),
    pcg_block_s (s-step PCG; ``max_pcg`` then caps rounds),
    partition_strategy, partition_block, ell_block_d, ell_block_n (sparse
    input), trace (turns on the process-global tracing plane,
    :func:`repro_torch.obs.enable`, at solver construction; global and
    sticky; left out of the checkpoint's config fingerprint), and the
    out-of-core fields of :meth:`DiscoSolver.from_store`:
    stream_chunk_size (the chunk of :func:`disco_fit_streaming`'s store),
    prefetch_depth (steps staged ahead of the kernels), elastic_replan and
    replan_threshold (re-plan on measured chunk seconds), io_retries,
    io_backoff_s and io_deadline_s (a stream step's retries).
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
    trace: bool = False             # enable the repro_torch.obs tracing plane
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
        stream_stats: streamed solves only, the data plane's byte ledger
            (``passes``, ``steps``, ``bytes_loaded``, ``peak_bytes``,
            ``max_step_bytes``; :class:`repro_torch.data.stream
            .PrefetchStats`); None otherwise.
        replan_events: the elastic re-plans that fired (plain dicts of
            :class:`repro_torch.robust.straggler.ReplanEvent`).
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


def subsample_mask(seed: int, outer_iter: int, shard: int | None,
                   frac: float, shape: tuple[int, ...]) -> torch.Tensor:
    """Bernoulli(``frac``) mask of the samples entering the Hessian at
    outer step ``outer_iter`` (paper §5.4), a bool CPU tensor of
    ``shape``.

    Drawn from a ``torch.Generator`` seeded from ``(seed, outer_iter,
    shard)``: a fresh draw every step, and an independent one per shard
    (DiSCO-S, ``shard`` its index); DiSCO-F draws one mask that every
    shard shares (``shard=None``). Drawn on the CPU, so the card and the
    CPU use the same masks.
    """
    entropy = (seed, outer_iter, 0 if shard is None else shard + 1)
    state = np.random.SeedSequence(entropy).generate_state(1, np.uint64)
    gen = torch.Generator().manual_seed(int(state[0]) >> 1)
    return torch.rand(shape, generator=gen) < frac


def shard_views(X, partition: str, m: int):
    """The m shards of a dense ``X`` as views: blocks of rows (DiSCO-F,
    ``partition='features'``) or of columns (DiSCO-S); and the remainder
    of the split axis over m (nonzero: X does not split evenly)."""
    if partition == "features":
        size, rem = divmod(X.shape[0], m)
        return [X[s * size:(s + 1) * size] for s in range(m)], rem
    size, rem = divmod(X.shape[1], m)
    return [X[:, s * size:(s + 1) * size] for s in range(m)], rem


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
        group: the shards (default: one shard): an
            :class:`InProcessGroup`, or a
            :class:`repro_torch.parallel.DistributedGroup`, whose rank
            keeps only its own shard on ``device`` (the whole ``X`` is
            given on every rank; the host partitions it as one process
            would).
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
               sparse: bool, streaming: bool = False) -> None:
        if cfg.trace:
            obs.enable()
        # a fault plan's executor, set by callers that inject faults (the
        # tests' kill-and-resume); fit() calls its on_outer_step(k)
        self._faults: FaultInjector | None = None
        self._streaming = streaming
        self._replanner: ElasticReplanner | None = None
        self._replan_events: list[dict] = []
        self._outer_iter = 0
        self.hvp_dtype = hvp_tile_dtype(cfg.hvp_dtype)
        validate_solver_cell(family="binary", partition=cfg.partition,
                             fused=cfg.hvp_fused, dtype=cfg.hvp_dtype,
                             sparse=sparse, use_kernel=cfg.use_kernel,
                             streaming=streaming)
        if cfg.partition not in ("features", "samples"):
            raise ValueError(f"unknown partition {cfg.partition!r}")
        self.cfg = cfg
        self.loss = get_loss(cfg.loss)
        self.device = resolve_device(device)
        self.d, self.n = shape
        self.tau = min(cfg.tau, self.n)
        self.group = group or InProcessGroup(1)
        self.m = self.group.size
        # the shards this process holds: a slice of the shard axis
        self._lo = local_slice(self.group)
        self._nl = len(self.group.local)
        if getattr(self.group, "backend", None) == "nccl" \
                and self.device.type != "cuda":
            raise ValueError("an nccl group's solve runs on its card, not "
                             f"{self.device}")
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
        # a process of a multi-process solve tiles only its shards, at the
        # widths common to all
        data, cols, dataT, colsT = build_shard_ell_pairs(
            shard_csrs, br, bc,
            local=self._lo if self._nl < self.m else None)
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
        partition order. Both: the stacked ``(m, ...)`` f32 ELL arrays, of
        which only this process's shards go to the device (or only those
        shards' rows, as :meth:`_init_sparse` builds them for a process
        that holds some of the shards).

        PCG's HVP tiles (``ell_data_h`` / ``ell_dataT_h``) are the f32
        layouts themselves at ``hvp_dtype='float32'`` (no copy), else
        copies in that dtype cast on the device; the margins and the
        gradient keep the f32 layouts, as in the reference. The live-tile
        schedules are the f32 layouts' (a tile nonzero at bf16 is nonzero
        at f32, so their live tiles cover the copies'); the one-pass
        HVP's step schedule is built at the HVP tiles' element size.
        """
        m, lo, nl = self.m, self._lo, self._nl
        held = state["ell_data"].shape[0]
        if held not in (m, nl):
            raise ValueError(f"state has {held} shards, the group {m}")
        put = lambda a: _to_device(a[lo] if held == m else a, self.device)
        self._perm = np.asarray(perm)
        self.ell_data = put(state["ell_data"])
        self.ell_cols = put(state["ell_cols"])
        self.ell_dataT = put(state["ell_dataT"])
        self.ell_colsT = put(state["ell_colsT"])
        # each layout's live-tile schedule, built once here and passed
        # with every product
        ctas = default_ctas(self.device)
        self.ell_sched = torch.stack([
            ell_schedule(self.ell_data[s], self.ell_cols[s], ctas)
            for s in range(nl)])
        self.ell_schedT = torch.stack([
            ell_schedule(self.ell_dataT[s], self.ell_colsT[s], ctas)
            for s in range(nl)])
        if self.ell_data.dtype == self.hvp_dtype:
            self.ell_data_h, self.ell_dataT_h = self.ell_data, self.ell_dataT
        else:
            self.ell_data_h = self.ell_data.to(self.hvp_dtype)
            self.ell_dataT_h = self.ell_dataT.to(self.hvp_dtype)
        # the one-pass HVP's step schedule over the HVP tiles, from the
        # transposed layout's live counts
        nbT = self.ell_dataT.shape[1]
        self.ell_hvp_sched = [
            ell_hvp_schedule(self.ell_dataT_h[s], self.ell_colsT[s], ctas,
                             live=schedule_parts(self.ell_schedT[s], nbT)[0])
            for s in range(nl)]
        pairs = lambda data, dataT, hvp_sched: [
            EllPair(data[s], self.ell_cols[s], dataT[s], self.ell_colsT[s],
                    self.ell_sched[s], self.ell_schedT[s], hvp_sched[s])
            for s in range(nl)]
        # the margins' and the gradient's shards (f32), and PCG's
        self._hvp_locs = pairs(self.ell_data_h, self.ell_dataT_h,
                               self.ell_hvp_sched)
        self._locs = (self._hvp_locs if self.ell_data_h is self.ell_data
                      else pairs(self.ell_data, self.ell_dataT, [None] * nl))
        if self.cfg.partition == "features":
            self.smask = _to_device(state["smask"], self.device)
        self._load_vectors(state)

    def _load_dense_state(self, state: dict) -> None:
        """Move the dense state to the device: ``X`` (d_padded, n) for
        DiSCO-F, (d, n_padded) for DiSCO-S, and the vectors as for the
        sparse state (without ``smask``: DiSCO-F pads only d). Each shard
        is a view of ``X``: a block of rows (DiSCO-F) or of columns
        (DiSCO-S). A process holding some of the shards moves only their
        block (a contiguous copy of it) and views that.

        PCG's shards (``_hvp_locs``) are the same views at
        ``hvp_dtype='float32'`` (no copy), else the same views of one copy
        of ``X`` in that dtype (``X_h``, cast on the device), as the
        reference's ``X_hvp``; the margins, the gradient and the tau slab
        stay on the f32 ``X``."""
        m, lo, nl = self.m, self._lo, self._nl
        X = state["X"]
        axis = 0 if self.cfg.partition == "features" else 1
        size, rem = divmod(X.shape[axis], m)
        if rem:
            raise ValueError(f"X {tuple(X.shape)} does not split into "
                             f"{m} equal shards")
        if nl < m:
            block = slice(lo.start * size, lo.stop * size)
            X = X[block] if axis == 0 else X[:, block]
        self.X = _to_device(X, self.device)
        self.X_h = (self.X if self.X.dtype == self.hvp_dtype
                    else self.X.to(self.hvp_dtype))
        self._locs = shard_views(self.X, self.cfg.partition, nl)[0]
        self._hvp_locs = (self._locs if self.X_h is self.X
                          else shard_views(self.X_h, self.cfg.partition,
                                           nl)[0])
        if self.cfg.partition == "features":
            self._perm = np.arange(state["X"].shape[0])
        self._load_vectors(state)

    def _load_vectors(self, state: dict) -> None:
        """The vectors and the preconditioner slab, and the step built on
        the loaded shards. Sharded ones (DiSCO-F's tau slab, DiSCO-S's
        labels and weights) keep this process's shards; ``_w_shape`` is
        the iterate this process holds (DiSCO-F: its rows), and
        ``_w_full_shape`` the whole one."""
        m, lo = self.m, self._lo
        put = lambda a: _to_device(a, self.device)
        self.y_tau = put(state["y_tau"])
        X_tau = state["X_tau"]
        if self.cfg.partition == "features":
            self.y = put(state["y"])
            self.X_tau = put(X_tau.reshape(m, -1, X_tau.shape[1])[lo])
            self._w_full_shape = (m, X_tau.shape[0] // m)
            self._w_shape = (self._nl, X_tau.shape[0] // m)
        else:
            self.y = put(state["y"].reshape(m, -1)[lo])
            self.weights = put(state["weights"].reshape(m, -1)[lo])
            self.X_tau = put(X_tau)
            self._w_full_shape = self._w_shape = (X_tau.shape[0],)
        self._step = self._build_step()

    # ------------------------------------------------------------------
    def _build_step(self):
        """The Newton step over the shards ``self._locs``. Margins and
        gradient go through the blocked-ELL ops (sparse) or
        ``torch.matmul`` (dense); PCG's HVPs through the local operator
        of :func:`repro_torch.core.hvp.make_local_operator` on the HVP
        shards ``self._hvp_locs`` (the bf16 copies at
        ``hvp_dtype='bfloat16'``), with the step's subsampled
        coefficients when ``hessian_subsample < 1``. Returns
        ``step(w, outer_iter=0) -> (w_new, stats)``."""
        cfg, loss, group = self.cfg, self.loss, self.group
        n, tau, nl = self.n, self.tau, self._nl
        locs, hvp_locs = self._locs, self._hvp_locs
        if self._sparse:
            def xt(s, v):                  # X_s^T v
                return kops.ell_matvec(locs[s].dataT, locs[s].colsT, v,
                                       sched=locs[s].schedT)

            def xv(s, v):                  # X_s v
                return kops.ell_matvec(locs[s].data, locs[s].cols, v,
                                       sched=locs[s].sched)
        else:
            def xt(s, v):
                return locs[s].T @ v

            def xv(s, v):
                return locs[s] @ v

        if cfg.partition == "features":
            smask = self.smask

            def step(w, outer_iter=0):                    # w: (nl, d_j)
                margins = group.all_reduce([xt(s, w[s]) for s in range(nl)])
                d1 = loss.d1(margins, self.y)
                c = loss.d2(margins, self.y)
                vals = loss.value(margins, self.y)
                if smask is not None:          # ELL-padded samples
                    d1, c, vals = d1 * smask, c * smask, vals * smask
                g = torch.stack([xv(s, d1) for s in range(nl)]) / n \
                    + cfg.lam * w
                gnorm = torch.sqrt(group.all_reduce(
                    [torch.dot(g[s], g[s]) for s in range(nl)]))
                fval = torch.sum(vals) / n + 0.5 * cfg.lam * \
                    group.all_reduce([torch.dot(w[s], w[s])
                                      for s in range(nl)])
                coeffs_tau = loss.d2(margins[:tau], self.y_tau)

                eps = cfg.pcg_rel_tol * gnorm
                res = pcg_features(
                    hvp_locs, self._subsample(c, outer_iter), n, cfg.lam, g,
                    eps, cfg.max_pcg,
                    coeffs_tau=coeffs_tau, mu=cfg.mu, group=group,
                    precond=cfg.precond, block_s=cfg.pcg_block_s,
                    X_tau_loc=self.X_tau, hvp_fused=cfg.hvp_fused,
                    use_kernel=cfg.use_kernel)
                w_new = w - res.v / (1.0 + res.delta)
                return w_new, dict(grad_norm=gnorm, f=fval,
                                   pcg_iters=res.iters, delta=res.delta,
                                   pcg_r_norm=res.r_norm)

        else:  # samples
            def step(w, outer_iter=0):                     # w: (d_padded,)
                margins = [xt(s, w) for s in range(nl)]
                # the loss shard by shard: a vectorized exp or log rounds
                # a row's tail apart from its body, so one call over the
                # stacked rows would round by how many shards it holds
                d1 = torch.stack([loss.d1(margins[s], self.y[s])
                                  for s in range(nl)]) * self.weights
                c = torch.stack([loss.d2(margins[s], self.y[s])
                                 for s in range(nl)]) * self.weights
                g = group.all_reduce(
                    [xv(s, d1[s]) for s in range(nl)]) / n + cfg.lam * w
                gnorm = torch.sqrt(torch.dot(g, g))
                fval = group.all_reduce(
                    [torch.sum(loss.value(margins[s], self.y[s])
                               * self.weights[s]) for s in range(nl)]) / n \
                    + 0.5 * cfg.lam * torch.dot(w, w)
                coeffs_tau = loss.d2(self.X_tau.T @ w, self.y_tau)

                eps = cfg.pcg_rel_tol * gnorm
                res = pcg_samples(
                    hvp_locs, self._subsample(c, outer_iter), n, cfg.lam, g,
                    eps, cfg.max_pcg, X_tau=self.X_tau,
                    coeffs_tau=coeffs_tau, mu=cfg.mu, group=group,
                    precond=cfg.precond, sag_epochs=cfg.sag_epochs,
                    block_s=cfg.pcg_block_s, hvp_fused=cfg.hvp_fused,
                    use_kernel=cfg.use_kernel)
                w_new = w - res.v / (1.0 + res.delta)
                return w_new, dict(grad_norm=gnorm, f=fval,
                                   pcg_iters=res.iters, delta=res.delta,
                                   pcg_r_norm=res.r_norm)

        return step

    def _subsample(self, c: torch.Tensor, outer_iter: int) -> torch.Tensor:
        """The Hessian's coefficients at step ``outer_iter``: ``c`` itself,
        or ``c * mask / frac`` when ``hessian_subsample = frac < 1``.
        DiSCO-F's ``c`` is the (n,) vector every shard shares (the padded
        n on sparse input), so one mask; DiSCO-S's is (nl, n_loc), one
        mask per local shard over its padded local width, drawn for the
        shard's global index."""
        frac = self.cfg.hessian_subsample
        if frac >= 1.0:
            return c
        seed = self.cfg.seed
        if self.cfg.partition == "features":
            mask = subsample_mask(seed, outer_iter, None, frac,
                                  tuple(c.shape))
        else:
            mask = torch.stack([
                subsample_mask(seed, outer_iter, s, frac, tuple(c.shape[1:]))
                for s in self.group.local])
        return c * mask.to(c.device) / frac

    # ------------------------------------------------------------------
    def with_lam(self, lam: float) -> "DiscoSolver":
        """A shallow copy at another regularization weight, the λ-path's
        primitive (:mod:`repro_torch.core.lambda_path`).

        Shares every device tensor (X or its ELL layouts and their HVP
        copies, the shard views, labels, weights, the tau slab) with
        ``self`` and rebuilds
        only the Newton step, whose closure reads ``lam`` from the
        config; the step holds no state of its own between fits.
        In-memory solvers only: a streamed solver is rebuilt with
        :meth:`from_store` for each ``lam``.
        """
        if self._streaming:
            raise ValueError(
                "with_lam shares in-memory device arrays; a streaming "
                "solver must be rebuilt with DiscoSolver.from_store for "
                "each lam")
        new = copy.copy(self)
        new.cfg = dataclasses.replace(self.cfg, lam=float(lam))
        new._step = new._build_step()
        return new

    # ------------------------------------------------------------------
    # the streamed (out-of-core) solve
    # ------------------------------------------------------------------

    @classmethod
    def from_store(cls, store, cfg: DiscoConfig,
                   group: InProcessGroup | None = None, device=None,
                   fault_plan: FaultPlan | None = None) -> "DiscoSolver":
        """A solver that *streams* a
        :class:`repro_torch.data.store.ShardStore` instead of holding X.

        The store's chunked axis must match ``cfg.partition``. Every
        product with X is one prefetched pass over the store
        (:mod:`repro_torch.data.stream`): each chunk's CSR goes to the
        device, its tiles are assembled there, and the blocked-ELL ops run
        on it with the chunk's schedule (K1 ``ell_mv`` for margins,
        gradient and two-pass HVPs, K6 ``ell_mm`` in s-step rounds, K2 /
        K7 for the fused DiSCO-S HVP), at ``cfg.hvp_dtype`` in PCG. Peak
        data-plane memory is ``cfg.prefetch_depth + 2`` steps of this
        process's chunks (one a shard it holds), never the dataset. Under
        a :class:`repro_torch.parallel.DistributedGroup` every rank plans
        all ``m`` shards from the header (the same plan on every rank)
        and streams only its own shard's chunks. The chunk-granular LPT
        assigns chunks to shards from the store's header; at
        ``partition_block = stream_chunk_size`` the in-memory solver
        realises the same partition. The outer loop, damped step,
        stopping rules and preconditioners are the in-memory solver's;
        :meth:`fit` additionally reports ``stream_stats``.

        Robustness: stream steps are retried per ``cfg.io_retries`` /
        ``io_backoff_s`` / ``io_deadline_s``; with ``cfg.elastic_replan``
        the per-chunk timing ledger feeds an
        :class:`repro_torch.robust.straggler.ElasticReplanner` that
        re-balances the chunk->shard schedule on *measured* seconds
        (DiSCO-S between PCG rounds, DiSCO-F between outer steps; the
        ranks of a multi-process solve merge their ledgers there first).
        ``fault_plan`` threads a :class:`repro_torch.robust.faults.FaultPlan`
        into the chunk reads and the outer loop (tests).
        """
        if store.axis != cfg.partition:
            raise ValueError(
                f"store is chunked along {store.axis!r} but cfg.partition "
                f"is {cfg.partition!r}; rebuild the store along the "
                f"partition axis")
        self = cls.__new__(cls)
        self._setup(cfg, tuple(store.shape), group, device, sparse=True,
                    streaming=True)
        self._faults = (FaultInjector(fault_plan)
                        if fault_plan is not None else None)
        retry = (RetryPolicy(max_retries=cfg.io_retries,
                             backoff_s=cfg.io_backoff_s,
                             deadline_s=cfg.io_deadline_s)
                 if cfg.io_retries > 0 or cfg.io_deadline_s > 0 else None)
        ledger = ChunkTimingLedger(store.n_chunks)
        if cfg.elastic_replan:
            self._replanner = ElasticReplanner(
                ledger, threshold=cfg.replan_threshold)
        self._plan = plan_streams(
            store, self.m, cfg.partition_strategy, local=self.group.local,
            block_rows=cfg.ell_block_d, block_cols=cfg.ell_block_n,
            prefetch_depth=cfg.prefetch_depth, device=self.device,
            hvp_dtype=self.hvp_dtype, timing_ledger=ledger,
            fault_injector=self._faults, retry=retry)
        self._part = self._plan.partition
        self._init_streaming()
        self._step = self._build_step_streaming()
        return self

    def _init_streaming(self):
        """The resident (small) tensors of a streamed solve: labels,
        sample weights or mask, and the dense tau-sample preconditioner
        slab, of this process's shards where they are sharded; the X
        chunks stay in the store."""
        plan, store, tau = self._plan, self._plan.store, self.tau
        n, lo = self.n, self._lo
        put = lambda a: _to_device(a, self.device)
        y = np.asarray(store.labels(), np.float32)
        width = plan.width_local
        if self.cfg.partition == "features":
            n_padded = plan.other_padded
            smask = np.zeros(n_padded, np.float32)
            smask[:n] = 1.0
            self.y = put(np.pad(y, (0, n_padded - n)))
            self.smask = put(smask)
            self._perm = np.asarray(self._part.perm)
            self._build_tau_features()
            self._w_full_shape = (self.m, width)
            self._w_shape = (self._nl, width)
        else:
            n_padded = plan.axis_padded
            perm = self._part.perm
            local = lambda v: put(np.pad(v, (0, n_padded - n))[perm]
                                  .reshape(self.m, -1)[lo])
            self.y = local(y)
            self.weights = local(np.ones(n, np.float32))
            # the first tau *original* samples, read from the chunks that
            # cover them (sample chunks are in the original order)
            X_tau = np.zeros((plan.other_padded, tau), np.float32)
            pos = 0
            while pos < tau:
                cid = pos // store.chunk_size
                info = store.chunks[cid]
                cnt = min(tau, info.stop) - pos
                sub = store.chunk_csr(cid).take_rows(
                    np.arange(pos - info.start, pos - info.start + cnt))
                X_tau[:self.d, pos:pos + cnt] = sub.todense().T
                pos += cnt
            self.X_tau = put(X_tau)
            self._w_full_shape = self._w_shape = (plan.other_padded,)
        self.y_tau = put(y[:tau])

    def _build_tau_features(self):
        """(Re)build DiSCO-F's dense tau slab ``(nl, width, tau)`` of this
        process's shards from the CURRENT schedule, chunk by chunk (the
        tau columns of each chunk's feature rows), so an elastic re-plan
        rebuilds it for the new chunk->shard membership."""
        plan, store, tau = self._plan, self._plan.store, self.tau
        chunk = plan.chunk_size
        X_tau = np.zeros((self._nl, plan.width_local, tau), np.float32)
        for j, s in enumerate(self.group.local):
            for t in range(plan.n_steps):
                cid = int(plan.schedule[s, t])
                if cid < 0:
                    continue
                slab = store.chunk_csr(cid).take_cols_dense(np.arange(tau))
                X_tau[j, t * chunk: t * chunk + slab.shape[0]] = slab
        self.X_tau = _to_device(X_tau, self.device)

    # -- streamed X products: each is one prefetched pass over this
    # process's chunks; payloads and sharded vectors are indexed by the
    # local shard j (global shard group.local[j])
    def _slab(self, vec, j, t):
        """Local shard ``j``'s step-``t`` chunk of a sharded ``(nl, width,
        ...)`` vector."""
        chunk = self._plan.chunk_size
        return vec[j, t * chunk:(t + 1) * chunk]

    def _stream_xt(self, u, local=False, multi=False, hvp=False):
        """Pass A of DiSCO-F, ``z = X^T u``: the transposed chunk layouts,
        each shard's chunks summed in schedule order, then the shards'
        sums all-reduced into the ``(n_padded[, k])`` vector; with
        ``local=True`` the per-shard sums ``(nl, n_padded[, k])`` (the
        s-step basis operator, no collective). ``hvp=True`` streams the
        tiles in ``cfg.hvp_dtype`` (PCG's passes)."""
        op = kops.ell_matmat if multi else kops.ell_matvec
        acc = [None] * self._nl
        with self._plan.stream("tr", hvp=hvp) as pf:
            for t, pl in enumerate(pf):
                for j in range(self._nl):
                    part = op(pl["dataT"][j], pl["colsT"][j],
                              self._slab(u, j, t), sched=pl["schedT"][j])
                    acc[j] = part if acc[j] is None else acc[j] + part
        if local:
            return torch.stack(acc)
        return self.group.all_reduce(acc)

    def _stream_x(self, z, coeffs=None, local=False, multi=False,
                  hvp=False):
        """Pass B of DiSCO-F, ``X (c .* z)``: the forward chunk layouts,
        each chunk giving its slab of its shard's rows, joined in schedule
        order into ``(nl, width[, k])``; ``local=True`` reads the
        per-shard inputs ``z[j]``."""
        op = kops.ell_matmat if multi else kops.ell_matvec
        parts = [[None] * self._plan.n_steps for _ in range(self._nl)]
        with self._plan.stream("fwd", hvp=hvp) as pf:
            for t, pl in enumerate(pf):
                for j in range(self._nl):
                    parts[j][t] = op(pl["data"][j], pl["cols"][j],
                                     z[j] if local else z, coeffs,
                                     sched=pl["sched"][j])
        return torch.stack([torch.cat(p) for p in parts])

    def _stream_hvp_samples(self, u, coeffs, multi=False):
        """DiSCO-S's local products, ``sum_s sum_t X_st (c_st .*
        (X_st^T u))``: each sample chunk completes both directions, so one
        pass serves the whole product, each shard's chunks summed in
        schedule order, then the shards' sums all-reduced. With
        ``cfg.hvp_fused`` (when the plan's tile shape fits the fused
        kernels, :meth:`StreamPlan.fused_hvp_fits`) only the transposed
        layout is streamed and each chunk runs K2 ``ell_hvp`` / K7
        ``ell_hvp_mm`` with its step schedule; else the two-pass K1 / K6
        pair. Tiles in ``cfg.hvp_dtype`` either way; the choice is made
        once per stream."""
        plan, nl = self._plan, self._nl
        acc = [None] * nl
        fused = self.cfg.hvp_fused and plan.fused_hvp_fits(
            self.d, s=(u.shape[1] if multi else 1))
        if fused:
            op = kops.ell_hvp_mm if multi else kops.ell_hvp
            with plan.stream("tr", hvp=True, fused=True) as pf:
                for t, pl in enumerate(pf):
                    for j in range(nl):
                        part = op(pl["dataT"][j], pl["colsT"][j], u,
                                  self._slab(coeffs, j, t),
                                  sched=pl["hvp_sched"][j])
                        acc[j] = part if acc[j] is None else acc[j] + part
            return self.group.all_reduce(acc)
        op = kops.ell_matmat if multi else kops.ell_matvec
        with plan.stream("both", hvp=True) as pf:
            for t, pl in enumerate(pf):
                for j in range(nl):
                    z = op(pl["dataT"][j], pl["colsT"][j], u,
                           sched=pl["schedT"][j])
                    part = op(pl["data"][j], pl["cols"][j], z,
                              self._slab(coeffs, j, t), sched=pl["sched"][j])
                    acc[j] = part if acc[j] is None else acc[j] + part
        return self.group.all_reduce(acc)

    def _by_chunk(self, fn, margins):
        """``fn(margins, y)`` of DiSCO-S's ``(nl, width)`` margins, one
        call a chunk slab."""
        steps = self._plan.n_steps
        return torch.stack([torch.cat([
            fn(self._slab(margins, j, t), self._slab(self.y, j, t))
            for t in range(steps)]) for j in range(self._nl)])

    def _stream_margins_samples(self, w):
        """DiSCO-S margins, ``(nl, width)``: one 'tr' pass, each chunk
        giving its slab of its shard's margins."""
        parts = [[None] * self._plan.n_steps for _ in range(self._nl)]
        with self._plan.stream("tr") as pf:
            for t, pl in enumerate(pf):
                for j in range(self._nl):
                    parts[j][t] = kops.ell_matvec(
                        pl["dataT"][j], pl["colsT"][j], w,
                        sched=pl["schedT"][j])
        return torch.stack([torch.cat(p) for p in parts])

    def _stream_grad_samples(self, d1):
        """DiSCO-S's ``sum_s X_s d1_s``: one 'fwd' pass, each shard's
        chunks summed in schedule order, then all-reduced."""
        acc = [None] * self._nl
        with self._plan.stream("fwd") as pf:
            for t, pl in enumerate(pf):
                for j in range(self._nl):
                    part = kops.ell_matvec(pl["data"][j], pl["cols"][j],
                                           self._slab(d1, j, t),
                                           sched=pl["sched"][j])
                    acc[j] = part if acc[j] is None else acc[j] + part
        return self.group.all_reduce(acc)

    # -- elastic re-planning ---------------------------------------------
    def _replan(self, trigger: str):
        """The re-planner's decision at a re-plan window: ``(new_plan,
        event)`` or None. A process of a multi-process solve has timed
        only its own chunks, so the ranks first merge their ledgers in one
        all-reduce (each chunk's seconds and count from the rank that
        streams it, zeros from the others) and every rank then decides on
        the same numbers."""
        ledger = self._replanner.ledger
        if self._nl < self.m:
            own = self._plan.schedule[self._lo].reshape(-1)
            part = torch.from_numpy(ledger.snapshot(own[own >= 0])).to(
                self.device)
            ledger.restore(self.group.all_reduce([part]).cpu().numpy())
        return self._replanner.maybe_replan(
            self._plan, outer_iter=self._outer_iter, trigger=trigger)

    def _replan_mapping(self, new_plan) -> torch.Tensor:
        """Index map old-permuted-position -> new-permuted-position, on
        the device: ``vec_new = vec_old.reshape(-1)[mapping]`` re-permutes
        a vector of the sharded (permuted, padded) axis to the new plan's
        layout."""
        mapping = self._part.inv[new_plan.partition.perm]
        return torch.from_numpy(np.asarray(mapping, np.int64)).to(
            self.device)

    def _permute(self, vec, mapping):
        """A sharded ``(nl, width)`` vector in the new plan's layout: the
        whole ``(m, width)`` vector (gathered from every process when this
        one holds only some shards) re-permuted, then this process's
        rows."""
        full = self.group.all_gather(vec) if self._nl < self.m else vec
        return full.reshape(-1)[mapping].reshape(self.m, -1)[self._lo]

    def _maybe_replan_samples(self, state: dict) -> None:
        """Between-PCG-rounds re-plan window of streamed DiSCO-S.

        The PCG state is replicated d-space and never permuted, so
        swapping the schedule mid-solve is exact; only the n-space
        resident vectors (labels, sample weights and the in-flight
        Hessian coefficients in ``state``) are re-permuted here."""
        if self._replanner is None:
            return
        out = self._replan("pcg")
        if out is None:
            return
        new_plan, event = out
        mapping = self._replan_mapping(new_plan)
        self.y = self._permute(self.y, mapping)
        self.weights = self._permute(self.weights, mapping)
        for k in state:
            state[k] = self._permute(state[k], mapping)
        self._plan, self._part = new_plan, new_plan.partition
        self._replan_events.append(event.to_dict())

    def _maybe_replan_features(self, w):
        """Outer-boundary re-plan window of streamed DiSCO-F: its PCG
        state and block-diagonal preconditioner are tied to the shard
        membership, so the swap happens only between outer steps: the
        iterate is re-permuted and the tau slab rebuilt."""
        if self._replanner is None:
            return w
        out = self._replan("outer")
        if out is None:
            return w
        new_plan, event = out
        w = self._permute(w, self._replan_mapping(new_plan))
        self._plan, self._part = new_plan, new_plan.partition
        self._perm = np.asarray(self._part.perm)
        self._build_tau_features()
        self._replan_events.append(event.to_dict())
        return w

    def _build_step_streaming(self):
        """The host-driven Newton step of a streamed solve: the in-memory
        step's arithmetic with every product a prefetched chunk scan and
        PCG run by :func:`repro_torch.core.pcg.pcg_streamed`. Returns
        ``step(w, outer_iter=0) -> (w_new, stats)``."""
        cfg, loss, group = self.cfg, self.loss, self.group
        n, tau, m, nl = self.n, self.tau, self.m, self._nl
        lam = cfg.lam
        # PCG's 1/n as the in-memory PCG has it, a device scalar (a Python
        # number would divide by its reciprocal on the card)
        n_t = torch.tensor(float(n), dtype=torch.float32, device=self.device)

        def outer_rounds(r_outer):
            # the outer margins / gradient rounds, counted at their call
            # site (the streamed path's own tally)
            if obs.enabled():
                obs.count("comm.rounds", r_outer)
                for _ in range(r_outer):
                    obs.instant("comm.allreduce", phase="outer")

        if cfg.partition == "features":
            def step(w, outer_iter=0):                    # w: (nl, width)
                w = self._maybe_replan_features(w)
                margins = self._stream_xt(w)
                d1 = loss.d1(margins, self.y) * self.smask
                c = loss.d2(margins, self.y) * self.smask
                vals = loss.value(margins, self.y) * self.smask
                g = self._stream_x(d1) / n + lam * w
                gnorm = torch.sqrt(group.all_reduce(
                    [torch.dot(g[j], g[j]) for j in range(nl)]))
                outer_rounds(comm.disco_f_outer_cost(n, self.d, m)[0])
                fval = torch.sum(vals) / n + 0.5 * lam * group.all_reduce(
                    [torch.dot(w[j], w[j]) for j in range(nl)])
                c_eff = self._subsample(c, outer_iter)
                coeffs_tau = loss.d2(margins[:tau], self.y_tau)
                apply_precond = _features_precond(
                    cfg.precond, self.X_tau, coeffs_tau, lam, cfg.mu)

                # two-pass only: the all-reduce of pass A's chunk sums
                # separates the passes (the registry refuses fused)
                op = StreamedHvpOperator(
                    apply=lambda u: self._stream_x(
                        self._stream_xt(u, hvp=True), coeffs=c_eff,
                        hvp=True),
                    apply_multi=lambda U: self._stream_x(
                        self._stream_xt(U, multi=True, hvp=True),
                        coeffs=c_eff, multi=True, hvp=True),
                    pass_a=lambda u: self._stream_xt(u, hvp=True),
                    pass_b=lambda z: self._stream_x(z, coeffs=c_eff,
                                                    hvp=True),
                    pass_a_multi=lambda U: self._stream_xt(
                        U, multi=True, hvp=True),
                    pass_b_multi=lambda Z: self._stream_x(
                        Z, coeffs=c_eff, multi=True, hvp=True))

                def basis_op(u):
                    z_loc = self._stream_xt(u, local=True, hvp=True)
                    return self._stream_x(z_loc, coeffs=c_eff, local=True,
                                          hvp=True) / n_t + lam * u

                res = pcg_streamed(
                    lambda u: op.apply(u) / n_t + lam * u, apply_precond, g,
                    cfg.pcg_rel_tol * gnorm, cfg.max_pcg,
                    block_s=cfg.pcg_block_s,
                    hvp_multi=lambda U: op.apply_multi(U) / n_t + lam * U,
                    basis_op=basis_op, variant="features", group=group)
                w_new = w - res.v / (1.0 + res.delta)
                return w_new, dict(grad_norm=gnorm, f=fval,
                                   pcg_iters=res.iters, delta=res.delta,
                                   pcg_r_norm=res.r_norm)

        else:  # samples
            def step(w, outer_iter=0):                     # w: (d_padded,)
                margins = self._stream_margins_samples(w)  # (nl, width)
                # the loss chunk by chunk, as the in-memory step takes it
                # shard by shard (so the solve whose shards are the
                # chunks rounds it alike)
                d1 = self._by_chunk(loss.d1, margins) * self.weights
                c = self._by_chunk(loss.d2, margins) * self.weights
                g = self._stream_grad_samples(d1) / n + lam * w
                gnorm = torch.sqrt(torch.dot(g, g))
                outer_rounds(comm.disco_s_outer_cost(self.d)[0])
                fval = group.all_reduce(
                    [torch.sum(loss.value(margins[j], self.y[j])
                               * self.weights[j]) for j in range(nl)]) / n \
                    + 0.5 * lam * torch.dot(w, w)
                coeffs_tau = loss.d2(self.X_tau.T @ w, self.y_tau)
                apply_precond = _samples_precond(
                    cfg.precond, self.X_tau, coeffs_tau, lam, cfg.mu,
                    cfg.sag_epochs)

                # the n-space (permuted) coefficients in a holder: a
                # re-plan between PCG rounds re-permutes them, so the
                # closures always stream the current schedule's layout
                state = dict(c_eff=self._subsample(c, outer_iter))
                op = StreamedHvpOperator(
                    apply=lambda u: self._stream_hvp_samples(
                        u, state["c_eff"]),
                    apply_multi=lambda U: self._stream_hvp_samples(
                        U, state["c_eff"], multi=True),
                    fused=cfg.hvp_fused)

                def hvp(u):
                    return op.apply(u) / n_t + lam * u

                basis_op = None
                if cfg.pcg_block_s > 1:
                    basis_op = _samples_basis_op(hvp, m, self.X_tau,
                                                 coeffs_tau, lam)
                between = ((lambda: self._maybe_replan_samples(state))
                           if self._replanner is not None else None)
                res = pcg_streamed(
                    hvp, apply_precond, g, cfg.pcg_rel_tol * gnorm,
                    cfg.max_pcg, block_s=cfg.pcg_block_s,
                    hvp_multi=lambda U: op.apply_multi(U) / n_t + lam * U,
                    basis_op=basis_op, variant="samples",
                    between_rounds=between)
                w_new = w - res.v / (1.0 + res.delta)
                return w_new, dict(grad_norm=gnorm, f=fval,
                                   pcg_iters=res.iters, delta=res.delta,
                                   pcg_r_norm=res.r_norm)

        return step

    def _stream_stats(self) -> dict:
        """The data plane's byte ledger (``PrefetchStats``) as a dict."""
        st = self._plan.stats
        return dict(passes=st.passes, steps=st.steps,
                    bytes_loaded=st.bytes_loaded, peak_bytes=st.peak_bytes,
                    max_step_bytes=st.max_step_bytes)

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
        slots dropped, any load-balancing permutation undone); DiSCO-F's
        rows are first gathered from every shard."""
        if self.cfg.partition == "features":
            w = self.group.all_gather(w)
        w_np = w.detach().reshape(-1).cpu().numpy()
        if self.cfg.partition == "features":
            w_full = np.zeros(self.d, w_np.dtype)
            valid = self._perm < self.d
            w_full[self._perm[valid]] = w_np[valid]
            return w_full
        return w_np[: self.d]

    def _w_from_original(self, w0) -> torch.Tensor:
        """``w0`` (original order, the whole vector on every process)
        padded, permuted, cut to this process's rows and on the device."""
        size = int(np.prod(self._w_full_shape))
        w0 = np.pad(np.asarray(w0), (0, size - len(w0)))
        if self.cfg.partition == "features":
            # into load-balanced order, then this process's shards
            w0 = w0[self._perm].reshape(self._w_full_shape)[self._lo]
        return torch.from_numpy(np.ascontiguousarray(
            w0, np.float32)).to(self.device).reshape(self._w_shape)

    def _cfg_fingerprint(self) -> dict:
        """JSON-canonical view of ``cfg`` (what checkpoints compare).
        ``trace`` is left out: tracing changes nothing about the solve, so
        a traced resume of an untraced checkpoint (or the other way round)
        is allowed. The fields are the reference's, so a checkpoint of
        either package matches the other's config."""
        cfg_dict = dataclasses.asdict(self.cfg)
        cfg_dict.pop("trace", None)
        return json.loads(json.dumps(cfg_dict, default=float))

    def _key_data(self) -> np.ndarray:
        """The ``key`` a checkpoint stores: the reference's format (uint32,
        length 2; its ``PRNGKey(seed)``). The port draws its subsampling
        masks from ``(seed, outer_iter, shard)`` (:func:`subsample_mask`),
        so it has no RNG state to save and ignores ``key`` on load."""
        seed = int(self.cfg.seed)
        return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                        np.uint32)

    def fit(self, w0: np.ndarray | None = None, *,
            checkpoint_dir: str | None = None, checkpoint_every: int = 1,
            resume: bool = False) -> DiscoResult:
        """Run the damped Newton outer loop from ``w0`` (default zeros).

        ``w0`` is given — and ``DiscoResult.w`` returned — in the
        original feature order.

        Checkpointing: with ``checkpoint_dir`` the outer state (iterate in
        the original feature order, history, communication ledger) is
        saved atomically every ``checkpoint_every`` steps
        (:mod:`repro_torch.robust.checkpoint`). ``resume=True`` restarts
        from the newest snapshot there (from ``w0`` when there is none)
        and continues the uninterrupted trajectory: the step's subsampling
        masks depend on ``(seed, outer_iter, shard)`` only, so there is no
        RNG state to restore. A checkpoint written with another config
        raises ``ValueError``. Checkpoints of the JAX package's in-memory
        fit resume here and the other way round (at
        ``hessian_subsample=1.0``, where neither draws).

        Tracing adds no device work: the ``newton.outer`` span ends after
        the step's ``float()`` reads, as ``iter_s`` does, and the
        ``comm.*`` counters are the analytic tally of ``CommLedger``.

        Under a :class:`repro_torch.parallel.DistributedGroup` every rank
        calls ``fit`` with the same ``w0`` and gets the same result
        (DiSCO-F's rows are gathered). Checkpoints there: every rank
        gathers the iterate, rank 0 alone writes it and a barrier follows;
        on resume rank 0 reads the directory (which need exist on its host
        only) and broadcasts the state, so every rank checks the same
        config and raises the same ``ValueError`` together.
        """
        cfg, group = self.cfg, self.group
        history: list[dict[str, Any]] = []
        ledger = comm.CommLedger()
        start_iter = 0
        if checkpoint_dir is not None and resume:
            state = group.broadcast_object(
                load_checkpoint(checkpoint_dir) if group.rank == 0
                else None)
            if state is not None:
                if state.cfg != self._cfg_fingerprint():
                    raise ValueError(
                        f"checkpoint at {checkpoint_dir!r} was written "
                        "by a solve with a different config; refusing "
                        "to resume (delete the checkpoint directory or "
                        "match the config)")
                w0 = state.w
                history = list(state.history)
                ledger = comm.CommLedger(**state.ledger)
                start_iter = state.next_iter
                self._replan_events = list(state.replan_events)
        if w0 is None:
            w = torch.zeros(self._w_shape, dtype=torch.float32,
                            device=self.device)
        else:
            w = self._w_from_original(w0)

        converged = False
        for k in range(start_iter, cfg.max_outer):
            self._outer_iter = k
            if self._faults is not None:
                self._faults.on_outer_step(k)
            t_it = time.perf_counter()
            with obs.span("newton.outer", outer_iter=k,
                          streaming=self._streaming):
                w, stats = self._step(w, k)
                # the float() reads wait for the step's device work, so
                # iter_s (and the span) cover the whole step
                stats = {name: float(v) for name, v in stats.items()}
            stats["iter_s"] = time.perf_counter() - t_it
            rounds, floats, spmd = self._comm_costs(int(stats["pcg_iters"]))
            ledger.add(rounds, floats, spmd)
            obs.count("comm.floats", floats)
            obs.count("comm.spmd_collectives", spmd)
            if not self._streaming:
                # in-memory: the analytic tally; a streamed step counts
                # its rounds at their call sites
                obs.count("comm.rounds", rounds)
            stats.update(outer_iter=k, comm_rounds_cum=ledger.rounds,
                         comm_floats_cum=ledger.floats)
            history.append(stats)
            if checkpoint_dir is not None \
                    and (k + 1) % max(checkpoint_every, 1) == 0:
                w_orig = self._w_to_original(w)       # collective
                if group.rank == 0:
                    save_checkpoint(checkpoint_dir, CheckpointState(
                        next_iter=k + 1, w=w_orig,
                        key=self._key_data(), history=history,
                        ledger=dataclasses.asdict(ledger),
                        replan_events=list(self._replan_events),
                        cfg=self._cfg_fingerprint()))
                group.barrier()
            if stats["grad_norm"] <= cfg.grad_tol:
                converged = True
                break

        return DiscoResult(w=self._w_to_original(w), history=history,
                           ledger=ledger, converged=converged,
                           partition_info=(self._part.stats()
                                           if self._part else None),
                           stream_stats=(self._stream_stats()
                                         if self._streaming else None),
                           replan_events=list(self._replan_events))


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


def disco_fit_streaming(X, y, store_path: str,
                        cfg: DiscoConfig | None = None,
                        group: InProcessGroup | None = None,
                        w0: np.ndarray | None = None,
                        device=None) -> DiscoResult:
    """Out-of-core convenience wrapper: convert once, then stream.

    Writes ``(X, y)`` (a :class:`CSRMatrix` and labels) as a
    :class:`repro_torch.data.store.ShardStore` at ``store_path``, chunked
    along ``cfg.partition`` with ``cfg.stream_chunk_size`` indices a
    chunk, and fits it with :meth:`DiscoSolver.from_store`. Reopen an
    existing store with ``DiscoSolver.from_store(ShardStore(path), cfg)``
    to skip the conversion. Under a ``DistributedGroup`` rank 0 alone
    writes the store (on a file system every rank reads) and every rank
    opens it after a barrier.
    """
    cfg = cfg or DiscoConfig()
    group = group or InProcessGroup(1)
    if group.rank == 0:
        ShardStore.from_csr(X, y, store_path, axis=cfg.partition,
                            chunk_size=cfg.stream_chunk_size)
    group.barrier()
    store = ShardStore(store_path)
    return DiscoSolver.from_store(store, cfg, group=group,
                                  device=device).fit(w0)
