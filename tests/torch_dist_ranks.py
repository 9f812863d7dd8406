"""Rank bodies of the multi-process tests (``tests/test_torch_dist.py``,
``tests/test_torch_dist_paths.py``, ``tests/test_torch_isolation.py``,
``tests/test_torch_cuda.py``).

Each function here runs inside a rank that
:func:`repro_torch.parallel.launch.spawn` starts, a new interpreter that
imports this module by name. So this module imports nothing of JAX and
nothing of the JAX package: a rank runs the port alone.
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from repro_torch import (CSRMatrix, DiscoConfig, DiscoSolver, SoftmaxConfig,
                         SoftmaxSolver, disco_fit, disco_fit_streaming,
                         lambda_path_fit, softmax_fit)
from repro_torch.core import disco as port_disco
from repro_torch.core.baselines import (CocoaConfig, DaneConfig, GDConfig,
                                        cocoa_fit, dane_fit, gd_fit)
from repro_torch.data import ShardStore
from repro_torch.glm_serve import ModelRegistry, RefitLoop
from repro_torch.robust import FaultInjector, FaultPlan, SimulatedKill

# history fields that are measurements, not results
TIMINGS = ("iter_s",)
BASELINES = {"gd": (GDConfig, gd_fit), "dane": (DaneConfig, dane_fit),
             "cocoa": (CocoaConfig, cocoa_fit)}


def csr(arrays) -> CSRMatrix:
    indptr, indices, data, shape = arrays
    return CSRMatrix(indptr, indices, data, tuple(shape))


def summary(res) -> dict:
    """A fit's result without its timings: ``w``, the history, the
    ledger and the partition info."""
    led = res.ledger
    return dict(w=np.asarray(res.w),
                history=[{k: v for k, v in h.items() if k not in TIMINGS}
                         for h in res.history],
                ledger=(led.rounds, led.floats, led.spmd_collectives),
                partition_info=res.partition_info)


def inject_masks(masks):
    """Replace the port's ``subsample_mask`` by a lookup of ``masks``
    (``{(outer_iter, shard): bool array}``); returns the original."""
    orig = port_disco.subsample_mask

    def draw(seed, outer_iter, shard, frac, shape):
        mask = masks[(outer_iter, shard)]
        assert mask.shape == tuple(shape), (mask.shape, shape)
        return torch.from_numpy(mask)
    port_disco.subsample_mask = draw
    return orig


def run_case(case: dict, data: dict, group, device):
    """One solver case: ``case`` holds ``data`` (a key of ``data``),
    ``cfg`` (DiscoConfig fields) and optionally ``masks`` (injected
    subsampling masks) or ``lambdas`` (a warm λ-path). Returns a list of
    summaries (one a fit)."""
    X, y = data[case["data"]]
    if isinstance(X, tuple):
        X = csr(X)
    cfg = DiscoConfig(**case["cfg"])
    orig = inject_masks(case["masks"]) if case.get("masks") else None
    try:
        if "lambdas" in case:
            path = lambda_path_fit(X, y, case["lambdas"], cfg, group=group,
                                   device=device)
            return [summary(r) for r in path.results]
        return [summary(disco_fit(X, y, cfg, group=group, device=device))]
    finally:
        if orig is not None:
            port_disco.subsample_mask = orig


def solver_cases(group, cases: dict, data: dict, device="cpu",
                 threads: int = 1) -> dict:
    """Every solver case on this rank: ``{name: (summaries, counts)}``,
    the group's counters reset before each case."""
    torch.set_num_threads(threads)
    out = {}
    for name, case in cases.items():
        group.reset_counts()
        res = run_case(case, data, group, device)
        out[name] = (res, group.counts())
    return out


def run_baseline(case, data, group, device):
    name, loss, kw = case
    X, y = data
    cls, fit = BASELINES[name]
    w, hist, led = fit(X, y, cls(loss=loss, **kw), group=group,
                       device=device)
    return dict(w=np.asarray(w), history=hist,
                ledger=(led.rounds, led.floats, led.spmd_collectives))


def baseline_cases(group, cases, data, device="cpu", threads: int = 1):
    """Every baseline case on this rank: ``{id: (summary, counts)}``."""
    torch.set_num_threads(threads)
    out = {}
    for case in cases:
        group.reset_counts()
        out[f"{case[0]}-{case[1]}"] = (run_baseline(case, data, group,
                                                    device), group.counts())
    return out


def group_units(group, dim: int) -> dict:
    """The group's interface on this rank: what it reports, its ordered
    sum and gather of every rank's part (rank ``r``'s part is drawn from
    seed ``r``), the scalar path, a barrier, a broadcast of rank 0's and
    of the last rank's object, and the errors of wrong part counts."""
    part = torch.from_numpy(np.random.default_rng(group.rank)
                            .standard_normal(dim).astype(np.float32))
    out = dict(size=group.size, rank=group.rank, local=tuple(group.local),
               backend=group.backend)
    out["sum"] = group.all_reduce([part])
    out["scalar"] = group.all_reduce([torch.dot(part, part)])
    out["gather"] = group.all_gather([part])
    group.barrier()
    out["broadcast"] = (group.broadcast_object(("rank", group.rank)),
                        group.broadcast_object(group.rank,
                                               src=group.size - 1))
    out["errors"] = []
    for bad in ([], [part, part]):
        for call in (group.all_reduce, group.all_gather):
            try:
                call(bad)
            except ValueError as exc:
                out["errors"].append(str(exc))
    out["counts"] = group.counts()
    return out


# ---------------------------------------------------------------------------
# softmax, checkpoint/resume, the streamed solve and the serving refit
# (tests/test_torch_dist_paths.py); each case runs the same on an
# InProcessGroup in the test's process and on every rank
# ---------------------------------------------------------------------------

def softmax_summary(res) -> dict:
    return dict(W=np.asarray(res.W), converged=res.converged,
                history=[{k: v for k, v in h.items() if k not in TIMINGS}
                         for h in res.history])


def stream_summary(solver, res) -> dict:
    """A streamed fit's summary, its byte ledger and re-plan events, and
    the chunks this process streamed (those its timing ledger saw)."""
    out = summary(res)
    ledger = solver._plan.timing_ledger
    seen = ledger.snapshot(np.arange(ledger.n_chunks))[1]
    out.update(stream_stats=res.stream_stats,
               replan_events=res.replan_events,
               chunks=sorted(int(c) for c in np.flatnonzero(seen)))
    return out


def _tag(group) -> str:
    return f"ranks{group.size}" if len(group.local) < group.size \
        else f"inproc{group.size}"


def path_case(case: dict, data: dict, group, root: str, device="cpu"):
    """One case of ``tests/test_torch_dist_paths.py`` on ``group``: its
    ``kind`` picks the path; files go under ``root/<group tag>/<name>``."""
    kind, cfg = case["kind"], case.get("cfg", {})
    here = os.path.join(root, _tag(group), case["name"])
    if kind == "softmax":
        X, y = data["softmax"]
        return softmax_summary(softmax_fit(X, y, SoftmaxConfig(**cfg),
                                           group=group, device=device))
    if kind == "softmax_block":
        # only this process's block of X (its shards' columns or rows);
        # a process holding every shard takes the whole X
        X, y = data["softmax_block"]
        if len(group.local) == group.size:
            return softmax_summary(softmax_fit(
                X, y, SoftmaxConfig(**cfg), group=group, device=device))
        size = X.shape[1 if cfg["partition"] == "samples" else 0] \
            // group.size
        lo = slice(group.local[0] * size, (group.local[-1] + 1) * size)
        X_loc = X[:, lo] if cfg["partition"] == "samples" else X[lo]
        solver = SoftmaxSolver.from_local_block(
            X_loc, y, SoftmaxConfig(**cfg), d=X.shape[0], group=group,
            device=device)
        return softmax_summary(solver.fit())
    if kind == "stream":
        plan = (FaultPlan(slow_chunks=case["slow"]) if case.get("slow")
                else None)
        store = data["stores"][case.get("store", cfg["partition"])]
        solver = DiscoSolver.from_store(ShardStore(store),
                                        DiscoConfig(**cfg), group=group,
                                        device=device, fault_plan=plan)
        return stream_summary(solver, solver.fit())
    if kind == "stream_wrapper":
        X, y = data["stream"]
        res = disco_fit_streaming(csr(X), y, here, DiscoConfig(**cfg),
                                  group=group, device="cpu")
        return dict(summary(res), stream_stats=res.stream_stats,
                    store_chunks=ShardStore(here).n_chunks)
    if kind == "refit":
        return refit_case(case, data, group, here)
    raise ValueError(f"unknown case kind {kind!r}")


def refit_case(case, data, group, here) -> dict:
    """ingest -> refit -> refit_path on a store of the first samples,
    every write by rank 0."""
    (X0, y0), (X1, y1), (Xv, yv) = (
        (csr(a), b) for a, b in data["refit"])
    store_path = os.path.join(here, "store")
    if group.rank == 0:
        ShardStore.from_csr(X0, y0, store_path, axis="samples",
                            chunk_size=case["chunk"])
    group.barrier()
    reg = ModelRegistry(os.path.join(here, "registry"))
    loop = RefitLoop(reg, ShardStore(store_path), DiscoConfig(**case["cfg"]),
                     group=group, device="cpu")
    n = loop.ingest(X1, y1)
    v1, r1 = loop.refit()
    after_refit = reg.versions()
    v2, path = loop.refit_path(case["lambdas"], X_val=Xv, y_val=yv)
    return dict(n=n, v1=v1, refit=summary(r1), after_refit=after_refit,
                v2=v2, path=[summary(r) for r in path.results],
                best_index=path.best_index, lam=loop.cfg.lam,
                versions=reg.versions(), active=reg.active_version(),
                store_n=loop.store.shape[1])


def path_cases(group, cases: dict, data: dict, root: str,
               threads: int = 1, device="cpu") -> dict:
    """Every case on this rank: ``{name: (result, counts)}``, the
    group's counters reset before each case."""
    torch.set_num_threads(threads)
    out = {}
    for name, case in cases.items():
        group.reset_counts()
        res = path_case(dict(case, name=name), data, group, root, device)
        out[name] = (res, group.counts())
    return out


def card_paths(group, cases: dict, data: dict, root: str) -> dict:
    """:func:`path_cases` on this rank's card (``group.device``, or
    cuda:0 for gloo ranks sharing it), each case's kernel launches
    beside its result: ``{name: (result, counts, launches)}``."""
    from repro_torch.kernels import build
    out = {}
    for name, case in cases.items():
        build.reset_launch_counts()
        got = path_cases(group, {name: case}, data, root,
                         device=group.device or "cuda")[name]
        torch.cuda.synchronize()
        out[name] = got + (build.launch_counts(),)
    return out


def _ckpt_solver(case: dict, data: dict, group, fault_plan=None):
    """The solver of a checkpoint case: in memory on ``data``'s sparse
    problem, or streamed from ``data``'s store."""
    cfg = DiscoConfig(**case["cfg"])
    if case["kind"] == "stream":
        return DiscoSolver.from_store(
            ShardStore(data["stores"][cfg.partition]), cfg, group=group,
            device="cpu", fault_plan=fault_plan)
    X, y = data["sparse"]
    solver = DiscoSolver(csr(X), y, cfg, group=group, device="cpu")
    if fault_plan is not None:
        solver._faults = FaultInjector(fault_plan)
    return solver


def kill_cases(group, cases: dict, data: dict, dirs: dict,
               threads: int = 1) -> None:
    """Each case's fit with checkpoints into ``dirs[name]``, killed at
    its ``kill_at`` step. Every rank raises ``SimulatedKill`` at the same
    step; the kills of all but the last case are caught here, the last
    one ends the rank (so ``spawn`` raises)."""
    torch.set_num_threads(threads)
    names = list(cases)
    for name in names:
        solver = _ckpt_solver(cases[name], data, group, FaultPlan(
            kill_at_step=cases[name]["kill_at"]))
        try:
            solver.fit(checkpoint_dir=dirs[name])
        except SimulatedKill:
            if name == names[-1]:
                raise
        else:
            raise AssertionError(f"{name}: the fit was not killed")


def resume_cases(group, cases: dict, data: dict, dirs: dict,
                 threads: int = 1) -> dict:
    """Each case resumed from ``dirs[name]``: ``{name: (result,
    counts)}``; a case with ``lam`` changed resumes with that config and
    records the ``ValueError`` and the seconds until it was raised."""
    torch.set_num_threads(threads)
    out = {}
    for name, case in cases.items():
        group.reset_counts()
        if case.get("refuse"):
            bad = dict(case, cfg=dict(case["cfg"], lam=case["refuse"]))
            t0 = time.perf_counter()
            try:
                _ckpt_solver(bad, data, group).fit(
                    checkpoint_dir=dirs[name], resume=True)
                out[name] = (None, time.perf_counter() - t0)
            except ValueError as exc:
                out[name] = (str(exc), time.perf_counter() - t0)
            continue
        solver = _ckpt_solver(case, data, group)
        res = solver.fit(checkpoint_dir=dirs[name], resume=True)
        got = (stream_summary(solver, res) if case["kind"] == "stream"
               else summary(res))
        out[name] = (got, group.counts())
    return out


def raise_on_rank(group, bad_rank: int) -> int:
    """Rank ``bad_rank`` raises; the others wait in a collective."""
    if group.rank == bad_rank:
        raise RuntimeError(f"rank {bad_rank} fails on purpose")
    group.all_reduce([torch.ones(3)])
    return group.rank


def isolated_solve(group, data, root: str) -> list:
    """Small distributed solves (in memory DiSCO-F, streamed DiSCO-S from
    a store rank 0 writes under ``root``, a softmax fit), then a check
    that this interpreter loaded no module of JAX (or its ``ml_dtypes``)
    and none of the JAX package; raises if it did, else returns the
    (empty) list."""
    X, y = data
    kw = dict(tau=16, max_outer=2, ell_block_d=8, ell_block_n=8)
    res = disco_fit(csr(X), y, DiscoConfig(partition="features", **kw),
                    group=group, device="cpu")
    streamed = disco_fit_streaming(
        csr(X), y, os.path.join(root, "store"),
        DiscoConfig(partition="samples", stream_chunk_size=16,
                    partition_block=16, **kw), group=group, device="cpu")
    soft = softmax_fit(csr(X).todense(), (np.asarray(y) > 0).astype(int),
                       SoftmaxConfig(max_outer=2, tau=16), group=group,
                       device="cpu")
    if not all(np.isfinite(a).all() for a in (res.w, streamed.w, soft.W)):
        raise AssertionError("a distributed solve is not finite")
    leaked = sorted(m for m in sys.modules
                    if m == "repro" or m.startswith("repro.")
                    or (m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes")
                        and sys.modules[m] is not None))
    if leaked:
        raise AssertionError(f"rank {group.rank} loaded {leaked}")
    return leaked


def card_solve(group, X, y, kw) -> dict:
    """One sparse solve on this rank's card (``group.device``, or cuda:0
    for gloo ranks sharing it): its summary and the K1 launches."""
    from repro_torch.kernels import build
    build.reset_launch_counts()
    res = disco_fit(csr(X), y, DiscoConfig(**kw), group=group,
                    device=group.device or "cuda")
    torch.cuda.synchronize()
    return dict(summary=summary(res),
                ell_mv=build.launch_counts()["ell_mv"],
                counts=group.counts())
