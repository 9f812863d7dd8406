"""Softmax, checkpoint/resume, the streamed solve and the serving refit one
shard a process (``DistributedGroup``, gloo on the CPU), against the same
calls on ``InProcessGroup(4)`` in this process.

Three spawns of four ranks carry every case (the rank bodies are
``tests/torch_dist_ranks.py``, which imports nothing of JAX):

1. the paths: every softmax case of ``tests/test_torch_softmax.py``, the
   streamed DiSCO-S and DiSCO-F (classic, s-step, fused bf16), the
   elastic re-plan with shard 0's chunks slowed, ``disco_fit_streaming``
   and a ``RefitLoop``'s ingest -> refit -> refit_path;
2. the kills: in-memory DiSCO-S and DiSCO-F and streamed DiSCO-S, each
   writing checkpoints and killed at step 2 on every rank (the last kill
   ends the ranks, so ``spawn`` raises ``RankError``);
3. the resumes, in new processes: each killed solve, a checkpoint that
   ``InProcessGroup(4)`` wrote, and a resume with a changed config.

Each case holds ``w`` (or ``W``), the history without timings, the
ledger, ``partition_info``, ``replan_events`` and the group's counters
(transport aside) bit for bit to ``InProcessGroup(4)``, every rank the
same; softmax also to the reference's four-device run at
``tests/test_torch_softmax.py``'s tolerances; a streamed rank streams only
its own shard's chunks and stages at most ``prefetch_depth + 2`` steps of
them. The re-plan's timings are measured, so it is held to the static
solve (as ``tests/test_torch_streaming.py`` holds the in-process re-plan)
and every rank to the same events. Every collective has a timeout
(``TIMEOUT_S``); this process never calls ``init_process_group``.
"""
import shutil
import time

import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from repro_torch import DiscoConfig, DiscoSolver, InProcessGroup
from repro_torch.data import ShardStore
from repro_torch.data.stream import plan_streams
from repro_torch.parallel.launch import RankError, spawn
from repro_torch.robust import latest_checkpoint
from test_torch_disco import KW as DISCO_KW
from test_torch_disco import _data as disco_data
from test_torch_glm_serve import REFIT, _refit_data
from test_torch_softmax import CASES as SOFTMAX_CASES
from test_torch_softmax import DATA as SOFTMAX_DATA
from test_torch_softmax import _assert_matches as softmax_matches
from test_torch_softmax import _data as softmax_data
from test_torch_softmax import _id as softmax_id
from test_torch_softmax import _kw as softmax_kw
from test_torch_softmax import jax_4device_runs  # noqa: F401 (fixture)
from test_torch_streaming import SOLVE as STREAM_SOLVE
from test_torch_streaming import _data as stream_data

M = 4
TIMEOUT_S = 60.0
KILL_AT = 2
TRANSPORT = ("seconds", "staged_bytes")
REPLAN_TOL = {"samples": 2e-5, "features": 1e-4}


def _stream_cfg(partition, **kw):
    return dict(STREAM_SOLVE, partition=partition, **kw)


STREAM_CASES = {
    "stream-samples-classic": _stream_cfg("samples"),
    "stream-samples-s2": _stream_cfg("samples", pcg_block_s=2),
    "stream-features-classic": _stream_cfg("features"),
    "stream-features-s2": _stream_cfg("features", pcg_block_s=2),
    "stream-samples-fused-bf16": _stream_cfg(
        "samples", hvp_fused=True, hvp_dtype="bfloat16"),
}
# tests/test_torch_streaming.py's re-plan problem: (data, config) by axis
REPLAN = {
    "samples": (dict(d=48, n=1024), dict(
        partition="samples", loss="logistic", lam=1e-2, tau=32,
        max_outer=3, grad_tol=1e-10, ell_block_d=16, ell_block_n=64,
        partition_block=64)),
    "features": (dict(d=512, n=96), dict(
        partition="features", loss="logistic", lam=1e-2, tau=32,
        max_outer=12, grad_tol=1e-6, ell_block_d=64, ell_block_n=16,
        partition_block=64)),
}
# softmax from each process's block of X alone (SoftmaxSolver
# .from_local_block); X (10 x 81) is cut at 80, the multiple of 4 no
# padding needs
BLOCK_CASES = [("samples", 2, True), ("features", 2, True)]
CKPT_CASES = {
    "ckpt-samples": dict(kind="memory", cfg=dict(DISCO_KW,
                                                 partition="samples")),
    "ckpt-features": dict(kind="memory", cfg=dict(DISCO_KW,
                                                  partition="features")),
    "ckpt-stream-samples": dict(kind="stream",
                                cfg=_stream_cfg("samples")),
}


def _arrays(X):
    return (X.indptr, X.indices, X.data, X.shape)


def _replan_store(root, partition):
    from repro.data.sparse import make_sparse_glm_data
    from repro_torch import CSRMatrix
    shape, _ = REPLAN[partition]
    X, y, _ = make_sparse_glm_data(density=0.15, alpha=1.0, beta=0.6,
                                   seed=3, **shape)
    X = CSRMatrix(X.indptr, X.indices, X.data, X.shape)
    return ShardStore.from_csr(X, y, str(root / f"replan-{partition}"),
                               axis=partition, chunk_size=64).path


def _slow_chunks(store_path, cfg) -> dict:
    probe = plan_streams(ShardStore(store_path), M,
                         block_rows=cfg["ell_block_d"],
                         block_cols=cfg["ell_block_n"], device="cpu")
    return {int(c): 0.004 for c in probe.schedule[0] if c >= 0}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_paths")
    Xs, ys = softmax_data(**SOFTMAX_DATA)
    _, yst, Xst = stream_data()
    _, yd, Xd = disco_data()
    _, _, parts = _refit_data()
    stores = {axis: ShardStore.from_csr(Xst, yst, str(root / axis),
                                        axis=axis, chunk_size=16).path
              for axis in ("samples", "features")}
    stores.update({f"replan-{p}": _replan_store(root, p) for p in REPLAN})
    data = dict(softmax=(Xs, ys), softmax_block=(Xs[:8, :80], ys[:80]),
                stream=(_arrays(Xst), np.asarray(yst)),
                sparse=(_arrays(Xd), np.asarray(yd)), stores=stores,
                refit=[(_arrays(X), np.asarray(y)) for X, y in parts])
    return root, data


def _path_cases() -> dict:
    cases = {f"softmax-{softmax_id(c)}": dict(kind="softmax",
                                              cfg=softmax_kw(c))
             for c in SOFTMAX_CASES}
    cases.update({f"softmax-block-{softmax_id(c)}": dict(
        kind="softmax_block", cfg=softmax_kw(c)) for c in BLOCK_CASES})
    cases.update({name: dict(kind="stream", cfg=cfg)
                  for name, cfg in STREAM_CASES.items()})
    cases["stream-wrapper"] = dict(kind="stream_wrapper",
                                   cfg=_stream_cfg("samples"))
    cases["refit"] = dict(kind="refit", cfg=REFIT, chunk=16,
                          lambdas=[1e-1, 1e-2])
    return cases


def _replan_cases(data) -> dict:
    """The re-plan cases (the ranks run them; their twin here is the
    static solve)."""
    out = {}
    for p, (_, cfg) in REPLAN.items():
        store = f"replan-{p}"
        out[store] = dict(kind="stream", store=store,
                          slow=_slow_chunks(data["stores"][store], cfg),
                          cfg=dict(cfg, elastic_replan=True,
                                   replan_threshold=1.3))
    return out


@pytest.fixture(scope="module")
def path_runs(setup):
    """name -> (InProcessGroup(4)'s (result, counts) or None, [per rank
    (result, counts)]); the re-plan cases' twin is their static solve."""
    root, data = setup
    cases = _path_cases()
    twins = ranks.path_cases(InProcessGroup(M), cases, data, str(root),
                             threads=torch.get_num_threads())
    replan = _replan_cases(data)
    for name, case in replan.items():
        static = REPLAN[case["cfg"]["partition"]][1]
        twins[name] = (DiscoSolver.from_store(
            ShardStore(data["stores"][name]), DiscoConfig(**static),
            group=InProcessGroup(M), device="cpu").fit().w, None)
    per_rank = spawn(ranks.path_cases, M, backend="gloo", device="cpu",
                     args=(dict(cases, **replan), data, str(root)),
                     timeout_s=TIMEOUT_S)
    return {k: (twins[k], [r[k] for r in per_rank]) for k in twins}


def _same_counts(got: dict, want: dict) -> bool:
    return {k: v for k, v in got.items() if k not in TRANSPORT} == \
        {k: v for k, v in want.items() if k not in TRANSPORT}


def _equal(a: dict, b: dict) -> bool:
    """Bit for bit: ``w``, the history (timings aside), the ledger,
    ``partition_info`` and the re-plan events."""
    return (a["w"].dtype == b["w"].dtype and np.array_equal(a["w"], b["w"])
            and a["history"] == b["history"] and a["ledger"] == b["ledger"]
            and a.get("partition_info") == b.get("partition_info")
            and a.get("replan_events") == b.get("replan_events"))


# ---------------------------------------------------------------------------
# (a) softmax
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", SOFTMAX_CASES, ids=softmax_id)
def test_softmax_distributed_equals_in_process(path_runs, case):
    (twin, twin_counts), per_rank = path_runs[f"softmax-{softmax_id(case)}"]
    for r, (got, counts) in enumerate(per_rank):
        assert np.array_equal(got["W"], twin["W"]), r
        assert got["history"] == twin["history"], r
        assert got["converged"] == twin["converged"]
        assert _same_counts(counts, twin_counts), (r, counts, twin_counts)
        assert counts["staged_bytes"] == 0
    # DiSCO-F's rows are gathered once a fit
    assert per_rank[0][1]["gather_calls"] == (case[0] == "features")
    assert per_rank[0][1]["vector_calls"] > 0


@pytest.mark.parametrize("case", SOFTMAX_CASES, ids=softmax_id)
def test_softmax_distributed_matches_jax_4device(path_runs,
                                                 jax_4device_runs, case):
    """Rank 0's fit against the reference's four-device run, at
    ``tests/test_torch_softmax.py``'s tolerances."""
    got = path_runs[f"softmax-{softmax_id(case)}"][1][0][0]
    res = type("R", (), dict(W=got["W"], history=got["history"]))
    softmax_matches(res, jax_4device_runs[case])


@pytest.mark.parametrize("case", BLOCK_CASES, ids=softmax_id)
def test_softmax_from_local_blocks_equals_in_process(path_runs, case):
    """Each rank given only its shards' block of X (DiSCO-S's tau
    columns broadcast from the ranks holding them) equals
    ``InProcessGroup(4)`` given the whole X, bit for bit."""
    (twin, twin_counts), per_rank = path_runs[
        f"softmax-block-{softmax_id(case)}"]
    for r, (got, counts) in enumerate(per_rank):
        assert np.array_equal(got["W"], twin["W"]), r
        assert got["history"] == twin["history"], r
        # DiSCO-S's tau = 24 columns span shards 0 and 1 (20 each)
        assert counts.pop("broadcast_calls") == 2 * (case[0] == "samples")
        assert _same_counts(counts, {k: v for k, v in twin_counts.items()
                                     if k != "broadcast_calls"})
    assert twin_counts["broadcast_calls"] == 0


# ---------------------------------------------------------------------------
# (c) the streamed solve, (e) the re-plan, (f) the wrapper and the refit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(STREAM_CASES))
def test_streamed_distributed_equals_in_process(path_runs, name):
    (twin, twin_counts), per_rank = path_runs[name]
    for r, (got, counts) in enumerate(per_rank):
        assert _equal(got, twin), (name, r)
        assert _same_counts(counts, twin_counts), (name, r, counts)
    st = [got["stream_stats"] for got, _ in per_rank]
    want = twin["stream_stats"]
    # each rank loads its shard's part of every pass
    assert sum(s["bytes_loaded"] for s in st) == want["bytes_loaded"]
    assert all(s["passes"] == want["passes"] and s["steps"] == want["steps"]
               for s in st)


@pytest.mark.parametrize("name", list(STREAM_CASES))
def test_streamed_rank_stages_only_its_own_chunks(path_runs, setup, name):
    """A rank streams exactly its shard's chunks of the plan, and its
    data plane holds at most ``prefetch_depth + 2`` steps of one shard."""
    _, data = setup
    (twin, _), per_rank = path_runs[name]
    cfg = STREAM_CASES[name]
    plan = plan_streams(ShardStore(data["stores"][cfg["partition"]]), M,
                        block_rows=cfg["ell_block_d"],
                        block_cols=cfg["ell_block_n"], device="cpu")
    one_shard = twin["stream_stats"]["max_step_bytes"] // M
    assert one_shard * M == twin["stream_stats"]["max_step_bytes"]
    for r, (got, _) in enumerate(per_rank):
        own = sorted(int(c) for c in plan.schedule[r] if c >= 0)
        assert got["chunks"] == own, (r, got["chunks"], own)
        st = got["stream_stats"]
        assert st["max_step_bytes"] == one_shard
        assert st["peak_bytes"] <= (STREAM_SOLVE.get("prefetch_depth", 2)
                                    + 2) * one_shard
    assert sorted(c for got, _ in per_rank for c in got["chunks"]) == \
        twin["chunks"]


@pytest.mark.parametrize("partition", list(REPLAN))
def test_elastic_replan_distributed(path_runs, partition):
    """Shard 0's chunks straggle (injected latency on rank 0's reads):
    the ranks merge their timing ledgers, every rank takes the same
    re-plans (at least one), and the solve lands on the static one's
    endpoint within the in-process test's bounds."""
    static_w, per_rank = path_runs[f"replan-{partition}"]
    static_w = static_w[0]
    events = per_rank[0][0]["replan_events"]
    assert len(events) >= 1 and events[0]["moved_chunks"] > 0
    want_trigger = "pcg" if partition == "samples" else "outer"
    assert all(e["trigger"] == want_trigger for e in events)
    for got, _ in per_rank:
        assert got["replan_events"] == events
        assert np.array_equal(got["w"], per_rank[0][0]["w"])
        rel = np.linalg.norm(got["w"] - static_w) / np.linalg.norm(static_w)
        assert rel <= REPLAN_TOL[partition], rel


def test_disco_fit_streaming_distributed(path_runs):
    """Rank 0 writes the store, every rank streams it; each equals the
    in-process wrapper."""
    (twin, twin_counts), per_rank = path_runs["stream-wrapper"]
    for got, counts in per_rank:
        assert _equal(got, twin)
        assert got["store_chunks"] == twin["store_chunks"] > M
        assert _same_counts(counts, twin_counts)
    assert twin_counts["barrier_calls"] == 1


def test_refit_loop_distributed(path_runs):
    """ingest -> refit -> refit_path on four ranks: one version a
    publish, the same on every rank, each fit equal to the in-process
    loop's bit for bit."""
    (twin, twin_counts), per_rank = path_runs["refit"]
    assert (twin["v1"], twin["after_refit"], twin["v2"], twin["versions"],
            twin["active"]) == (1, [1], 2, [1, 2], 2)
    for got, counts in per_rank:
        for k in ("n", "v1", "after_refit", "v2", "versions", "active",
                  "best_index", "lam", "store_n"):
            assert got[k] == twin[k], k
        assert _equal(got["refit"], twin["refit"])
        assert len(got["path"]) == len(twin["path"]) == 2
        assert all(_equal(a, b) for a, b in zip(got["path"], twin["path"]))
        assert _same_counts(counts, twin_counts)
    assert twin["store_n"] == 128


# ---------------------------------------------------------------------------
# (b), (d) kill and resume
# ---------------------------------------------------------------------------

def _ckpt_cases() -> dict:
    return {k: dict(v, kill_at=KILL_AT) for k, v in CKPT_CASES.items()}


@pytest.fixture(scope="module")
def ckpt_runs(setup):
    """Kill every checkpoint case on four ranks, then resume each in new
    processes; also resume the ranks' checkpoints here and an in-process
    checkpoint on the ranks, and a resume with a changed config."""
    root, data = setup
    root = root / "ckpt"
    cases = _ckpt_cases()
    uninterrupted = {}
    for name, case in cases.items():
        solver = ranks._ckpt_solver(case, data, InProcessGroup(M))
        res = solver.fit()
        uninterrupted[name] = (ranks.stream_summary(solver, res)
                               if case["kind"] == "stream"
                               else ranks.summary(res))
    dirs = {name: str(root / "ranks" / name) for name in cases}
    t0 = time.perf_counter()
    with pytest.raises(RankError) as killed:
        spawn(ranks.kill_cases, M, backend="gloo", device="cpu",
              args=(cases, data, dirs), timeout_s=TIMEOUT_S)
    kill_s = time.perf_counter() - t0
    written = {name: latest_checkpoint(d) for name, d in dirs.items()}
    # the ranks' checkpoints, resumed here (on copies)
    here = {}
    for name, case in cases.items():
        copy = str(root / "inproc-resume" / name)
        shutil.copytree(dirs[name], copy)
        group = InProcessGroup(M)
        solver = ranks._ckpt_solver(case, data, group)
        res = solver.fit(checkpoint_dir=copy, resume=True)
        here[name] = ((ranks.stream_summary(solver, res)
                       if case["kind"] == "stream" else ranks.summary(res)),
                      group.counts())
    # an in-process checkpoint for the ranks, and the refused resume
    inproc = "ckpt-features"
    from repro_torch.robust import FaultPlan, SimulatedKill
    solver = ranks._ckpt_solver(cases[inproc], data, InProcessGroup(M),
                                FaultPlan(kill_at_step=KILL_AT))
    with pytest.raises(SimulatedKill):
        solver.fit(checkpoint_dir=str(root / "inproc" / inproc))
    resume = dict(cases, **{
        "from-inproc": cases[inproc],
        "refused": dict(cases["ckpt-samples"], refuse=2e-2)})
    rdirs = dict(dirs, **{"from-inproc": str(root / "inproc" / inproc),
                          "refused": str(root / "refused")})
    shutil.copytree(dirs["ckpt-samples"], rdirs["refused"])
    per_rank = spawn(ranks.resume_cases, M, backend="gloo", device="cpu",
                     args=(resume, data, rdirs), timeout_s=TIMEOUT_S)
    return dict(uninterrupted=uninterrupted, killed=str(killed.value),
                kill_s=kill_s, written=written, here=here,
                ranks={k: [r[k] for r in per_rank] for k in resume},
                dirs=rdirs)


def test_killed_ranks_raise_together(ckpt_runs):
    """Every rank raises ``SimulatedKill`` at step 2 after the step-2
    checkpoint; ``spawn`` raises ``RankError`` at once, not after a
    collective's timeout."""
    assert "SimulatedKill" in ckpt_runs["killed"]
    assert ckpt_runs["kill_s"] < TIMEOUT_S
    assert ckpt_runs["written"] == {k: KILL_AT for k in CKPT_CASES}


@pytest.mark.parametrize("name", list(CKPT_CASES))
def test_resumed_ranks_equal_the_uninterrupted_solve(ckpt_runs, name):
    """A resume in new processes equals the uninterrupted solve bit for
    bit (the in-process twin; the ranks equal it by the path cases), and
    its counters equal the in-process resume of the same checkpoint."""
    want = ckpt_runs["uninterrupted"][name]
    here, here_counts = ckpt_runs["here"][name]
    for got, counts in ckpt_runs["ranks"][name]:
        assert _equal(got, want), name
        assert _same_counts(counts, here_counts), (counts, here_counts)
    steps = (DISCO_KW if CKPT_CASES[name]["kind"] == "memory"
             else STREAM_SOLVE)["max_outer"]
    assert len(want["history"]) == steps > KILL_AT


@pytest.mark.parametrize("name", list(CKPT_CASES))
def test_rank_checkpoint_resumes_in_process(ckpt_runs, name):
    """A checkpoint four ranks wrote (rank 0, the reference's format)
    resumes under ``InProcessGroup(4)`` to the uninterrupted solve."""
    got, counts = ckpt_runs["here"][name]
    assert _equal(got, ckpt_runs["uninterrupted"][name])
    assert counts["broadcast_calls"] == 1
    assert counts["barrier_calls"] == len(got["history"]) - KILL_AT


def test_in_process_checkpoint_resumes_on_ranks(ckpt_runs):
    want = ckpt_runs["uninterrupted"]["ckpt-features"]
    for got, counts in ckpt_runs["ranks"]["from-inproc"]:
        assert _equal(got, want)


def test_resume_refuses_a_changed_config_on_every_rank(ckpt_runs):
    """The broadcast state fails the config check on every rank at once,
    well inside the collectives' timeout; nothing was written."""
    out = ckpt_runs["ranks"]["refused"]
    assert len(out) == M
    for msg, seconds in out:
        assert msg is not None and "different config" in msg
        assert seconds < 10.0, seconds
    assert latest_checkpoint(ckpt_runs["dirs"]["refused"]) == KILL_AT
