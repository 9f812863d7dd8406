"""Rank bodies of the multi-process tests (``tests/test_torch_dist.py``,
``tests/test_torch_isolation.py``, ``tests/test_torch_cuda.py``).

Each function here runs inside a rank that
:func:`repro_torch.parallel.launch.spawn` starts, a new interpreter that
imports this module by name. So this module imports nothing of JAX and
nothing of the JAX package: a rank runs the port alone.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from repro_torch import (CSRMatrix, DiscoConfig, DiscoSolver, disco_fit,
                         lambda_path_fit)
from repro_torch.core import disco as port_disco
from repro_torch.core.baselines import (CocoaConfig, DaneConfig, GDConfig,
                                        cocoa_fit, dane_fit, gd_fit)

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
    seed ``r``), the scalar path, and the errors of wrong part counts."""
    part = torch.from_numpy(np.random.default_rng(group.rank)
                            .standard_normal(dim).astype(np.float32))
    out = dict(size=group.size, rank=group.rank, local=tuple(group.local),
               backend=group.backend)
    out["sum"] = group.all_reduce([part])
    out["scalar"] = group.all_reduce([torch.dot(part, part)])
    out["gather"] = group.all_gather([part])
    out["errors"] = []
    for bad in ([], [part, part]):
        for call in (group.all_reduce, group.all_gather):
            try:
                call(bad)
            except ValueError as exc:
                out["errors"].append(str(exc))
    out["counts"] = group.counts()
    return out


def not_ported(group, data: dict, tmp: str) -> dict:
    """What raises NotImplementedError under a DistributedGroup: each
    entry's message, or None if it did not raise."""
    import os
    from repro_torch import SoftmaxConfig, disco_fit_streaming, softmax_fit
    from repro_torch.data import ShardStore
    from repro_torch.glm_serve import ModelRegistry, RefitLoop
    X, y = data["sparse"]
    X = csr(X)
    cfg = DiscoConfig(partition="samples", tau=16, max_outer=1,
                      ell_block_d=16, ell_block_n=16)
    path = os.path.join(tmp, f"rank{group.rank}")
    store = ShardStore.from_csr(X, y, path + "-store", axis="samples",
                                chunk_size=32)
    calls = {
        "from_store": lambda: DiscoSolver.from_store(store, cfg, group=group,
                                                     device="cpu"),
        "disco_fit_streaming": lambda: disco_fit_streaming(
            X, y, path + "-s2", cfg, group=group, device="cpu"),
        "checkpoint": lambda: DiscoSolver(X, y, cfg, group=group,
                                          device="cpu").fit(
            checkpoint_dir=path + "-ckpt"),
        "softmax_fit": lambda: softmax_fit(
            X.todense(), (y > 0).astype(int), SoftmaxConfig(max_outer=1),
            group=group, device="cpu"),
        "refit": lambda: RefitLoop(ModelRegistry(path + "-reg"), store, cfg,
                                   group=group, device="cpu"),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except NotImplementedError as exc:
            out[name] = str(exc)
    out["wrote_streaming_store"] = os.path.exists(path + "-s2")
    return out


def raise_on_rank(group, bad_rank: int) -> int:
    """Rank ``bad_rank`` raises; the others wait in a collective."""
    if group.rank == bad_rank:
        raise RuntimeError(f"rank {bad_rank} fails on purpose")
    group.all_reduce([torch.ones(3)])
    return group.rank


def isolated_solve(group, data) -> list:
    """A small distributed solve, then a check that this interpreter
    loaded no module of JAX (or its ``ml_dtypes``) and none of the JAX
    package; raises if it did, else returns the (empty) list."""
    X, y = data
    res = disco_fit(csr(X), y, DiscoConfig(partition="features", tau=16,
                                           max_outer=2, ell_block_d=8,
                                           ell_block_n=8),
                    group=group, device="cpu")
    if not np.isfinite(res.w).all():
        raise AssertionError("the distributed solve is not finite")
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
