"""The multi-process DiSCO solve: one shard a process over
``torch.distributed`` (gloo on the CPU), against the one-process solve.

``repro_torch.parallel.launch.spawn`` starts four ranks, each with a
``DistributedGroup`` and its own shard; the whole ``X`` is given to every
rank. Every solver case runs in one spawn of four ranks and the baselines
in a second (the rank bodies are ``tests/torch_dist_ranks.py``, which
imports nothing of JAX). Each case holds:

(i) bit for bit the same call on ``InProcessGroup(4)`` in this process:
    ``w``, the history (timings aside), the ledger, ``partition_info``;
(ii) the cases of ``tests/test_torch_disco.py``'s ``CASES_4``, the
    Huber and quadratic losses on both partitions and the dense
    ``use_kernel`` cases: the reference's 4-device run (a subprocess with
    four forced host devices) at that file's ``_assert_matches``
    tolerances, but quadratic DiSCO-F, whose ``w`` is held in relative L2
    to twice the reference's own spread between its 8 x 8 and 16 x 16
    tilings (a small entry misses atol 1e-6 while the whole is 1.9e-6
    apart, the tilings 1.1e-6); the other cases' ``InProcessGroup(4)``
    runs are held to the reference by their own files, so (i) carries
    them;
(iii) the same result on every rank;
(iv) the group's count of vector all-reduces equal to the ledger's
    ``spmd_collectives``, but where pinned: classic DiSCO-F PCG's two
    scalar psums an iteration (``u . Hu`` and ``r . s``), which the ledger
    counts as collectives and the groups as scalar all-reduces; and
    CoCoA+'s gradient norm each outer step, a d-vector all-reduce that
    neither package's ledger counts (ROADMAP Queue 3). All counters equal
    the in-process group's.

The sparse cases run on ``tests/test_torch_disco.py``'s data and ``KW``;
the dense ones on ``tests/test_torch_dense.py``'s 98 x 202 problem, ragged
against four shards, so both partitions pad. Every collective has a
timeout (``TIMEOUT_S``), so no case can hang the suite; this process never
calls ``init_process_group``.
"""
import json
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from repro_torch import DistributedGroup, InProcessGroup, make_glm_data
from repro_torch.core import comm
from repro_torch.parallel.launch import RankError, spawn
from test_torch_baselines import CASES as BASELINE_CASES
from test_torch_baselines import DATA as BASELINE_DATA
from test_torch_disco import CASES_4, DATA, KW, _assert_matches, _data
from test_torch_subsample import jax_mask

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
M = 4
TIMEOUT_S = 60.0
DENSE_DATA = dict(d=98, n=202, seed=1)
DENSE_CASES = [("samples", True, False), ("features", True, False)]
LOSSES = ("huber", "quadratic")
# held to the reference's spread between two of its own tilings
SPREAD_CASES = {"quadratic-features": dict(ell_block_d=8, ell_block_n=8)}


def _name(partition, strategy, fused):
    return f"{partition}-{strategy}-{'fused' if fused else '2pass'}"


def _cases() -> dict:
    """Every solver case: name -> (data key, DiscoConfig fields, extras)."""
    cases = {_name(*c): dict(data="sparse", cfg=dict(
        KW, partition=c[0], partition_strategy=c[1], hvp_fused=c[2]))
        for c in CASES_4}
    for p in ("samples", "features"):
        cases[f"sstep3-{p}"] = dict(data="sparse", cfg=dict(
            KW, partition=p, pcg_block_s=3))
        cases[f"dense-{p}"] = dict(data="dense", cfg=dict(
            KW, partition=p, use_kernel=True))
        cases[f"subsample-{p}"] = dict(data="sparse", cfg=dict(
            KW, partition=p, hessian_subsample=0.5))
    cases["dense-fused-samples"] = dict(data="dense", cfg=dict(
        KW, partition="samples", use_kernel=True, hvp_fused=True))
    cases["bf16-features"] = dict(data="sparse", cfg=dict(
        KW, partition="features", hvp_dtype="bfloat16"))
    cases["sag-samples"] = dict(data="sparse", cfg=dict(
        KW, partition="samples", precond="sag"))
    cases["lambda-path-features"] = dict(data="sparse", cfg=dict(
        KW, partition="features"), lambdas=[1e-2, 1e-3])
    for loss in LOSSES:
        for p in ("samples", "features"):
            cases[f"{loss}-{p}"] = dict(data="sparse", cfg=dict(
                KW, partition=p, loss=loss))
    return cases


CASES = _cases()
REFERENCE = {_name(*c): ("sparse", c) for c in CASES_4}
REFERENCE.update({f"dense-{p}": ("dense", (p, uk, fu))
                  for p, uk, fu in DENSE_CASES})
REFERENCE.update({f"{loss}-{p}": ("sparse", (p, "lpt", False, loss))
                  for loss in LOSSES for p in ("samples", "features")})


def _problem():
    X, y, _ = _data()
    Xd, yd, _ = make_glm_data(**DENSE_DATA)
    return {"sparse": ((X.indptr, X.indices, X.data, X.shape),
                       np.asarray(y)),
            "dense": (np.asarray(Xd), np.asarray(yd))}


def _recorded_masks(case, data) -> dict:
    """The reference's masks the in-process solve asks for, by (outer
    step, shard), drawn through ``jax_mask`` as
    ``tests/test_torch_subsample.py`` injects them."""
    masks = {}
    real = ranks.port_disco.subsample_mask

    def draw(seed, outer_iter, shard, frac, shape):
        m = jax_mask(seed, outer_iter, shard, frac, shape).numpy()
        masks[(outer_iter, shard)] = m
        return torch.from_numpy(m)
    ranks.port_disco.subsample_mask = draw
    try:
        ranks.run_case(dict(case, masks=None), data, InProcessGroup(M),
                       "cpu")
    finally:
        ranks.port_disco.subsample_mask = real
    return masks


@pytest.fixture(scope="module")
def solver_runs():
    """Every solver case on InProcessGroup(4) here and on four gloo ranks:
    name -> (in-process (summaries, counts), [per rank (summaries,
    counts)])."""
    data = _problem()
    cases = {k: dict(v) for k, v in CASES.items()}
    for name, case in cases.items():
        if "hessian_subsample" in case["cfg"]:
            case["masks"] = _recorded_masks(case, data)
    twins = ranks.solver_cases(InProcessGroup(M), cases, data,
                               threads=torch.get_num_threads())
    per_rank = spawn(ranks.solver_cases, M, backend="gloo", device="cpu",
                     args=(cases, data), timeout_s=TIMEOUT_S)
    return {k: (twins[k], [r[k] for r in per_rank]) for k in cases}


def _equal(a: dict, b: dict) -> bool:
    """Bit for bit: ``w``, every history entry, the ledger and (DiSCO)
    the partition info."""
    return (a["w"].dtype == b["w"].dtype and np.array_equal(a["w"], b["w"])
            and a["history"] == b["history"] and a["ledger"] == b["ledger"]
            and a.get("partition_info") == b.get("partition_info"))


def _pcg_iters(summaries) -> int:
    return sum(int(h["pcg_iters"]) for s in summaries for h in s["history"])


TRANSPORT = ("seconds", "staged_bytes")


def _same_counts(got: dict, want: dict) -> bool:
    return {k: v for k, v in got.items() if k not in TRANSPORT} == \
        {k: v for k, v in want.items() if k not in TRANSPORT}


@pytest.mark.parametrize("name", list(CASES))
def test_distributed_solve_equals_in_process(solver_runs, name):
    (twin, twin_counts), per_rank = solver_runs[name]
    cfg = CASES[name]["cfg"]
    for r, (got, counts) in enumerate(per_rank):
        assert len(got) == len(twin)
        for g, t in zip(got, twin):                        # (i), (iii)
            assert _equal(g, t), (name, r)
        assert _same_counts(counts, twin_counts), (name, r, counts)
        assert counts["staged_bytes"] == 0              # CPU tensors
    # (iv) vector all-reduces against the ledger, the pinned difference
    counts = per_rank[0][1]
    spmd = sum(s["ledger"][2] for s in twin)
    if cfg["partition"] == "features" and cfg.get("pcg_block_s", 1) == 1:
        assert counts["vector_calls"] == spmd - 2 * _pcg_iters(twin)
    else:
        assert counts["vector_calls"] == spmd
    # DiSCO-F's w is gathered once a fit
    assert counts["gather_calls"] == (len(twin) if cfg["partition"] ==
                                      "features" else 0)
    assert counts["scalar_calls"] > 0


def test_distributed_subsampling_keeps_global_shard_masks():
    """The DiSCO-S solve asks for one mask a step for each global shard
    index, four distinct ones; each rank's solve equals the in-process
    one (above) only if it drew its own shard's."""
    masks = _recorded_masks(CASES["subsample-samples"], _problem())
    steps = KW["max_outer"]
    assert set(masks) == {(k, s) for k in range(steps) for s in range(M)}
    assert len({masks[(0, s)].tobytes() for s in range(M)}) == M


SCRIPT_4 = textwrap.dedent("""
    import dataclasses, json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import numpy as np
    assert len(jax.devices()) == 4
    from repro.core import DiscoConfig, disco_fit
    from repro.data.sparse import make_sparse_glm_data
    from repro.data.synthetic import make_glm_data
    KW, DATA, DENSE, CASES, SPREAD = json.loads(sys.argv[1])
    Xs, ys, _ = make_sparse_glm_data(**DATA)
    Xd, yd, _ = make_glm_data(**DENSE)
    out = {}
    for name, (kind, case) in CASES.items():
        if kind == "sparse":
            partition, strategy, fused, *loss = case
            X, y = Xs, ys
            cfg = DiscoConfig(**dict(KW, partition=partition,
                                     partition_strategy=strategy,
                                     hvp_fused=fused,
                                     loss=loss[0] if loss else KW["loss"]))
        else:
            partition, use_kernel, fused = case
            X, y = Xd, yd
            cfg = DiscoConfig(partition=partition, use_kernel=use_kernel,
                              hvp_fused=fused, **KW)
        axis = "model" if partition == "features" else "data"
        mesh = jax.make_mesh((4,), (axis,))
        r = disco_fit(X, y, cfg, mesh=mesh)
        led = r.ledger
        out[name] = dict(w=np.asarray(r.w).tolist(),
                         pcg_iters=[int(h["pcg_iters"]) for h in r.history],
                         ledger=[led.rounds, led.floats,
                                 led.spmd_collectives],
                         partition_info=r.partition_info)
        if name in SPREAD:
            other = disco_fit(X, y, DiscoConfig(**dict(
                dataclasses.asdict(cfg), **SPREAD[name])), mesh=mesh)
            w, wo = np.asarray(r.w), np.asarray(other.w)
            out[name]["spread"] = float(np.linalg.norm(w - wo)
                                        / np.linalg.norm(w))
    print("RESULT " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def jax_4device_runs():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               REPRO_KERNEL_MODE="interpret")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", SCRIPT_4,
                        json.dumps([KW, DATA, DENSE_DATA, REFERENCE,
                                    SPREAD_CASES])],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    line = [x for x in r.stdout.splitlines() if x.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


@pytest.mark.parametrize("name", list(REFERENCE))
def test_distributed_solve_matches_jax_4device(jax_4device_runs,
                                               solver_runs, name):
    """(ii): rank 0's solve against the reference's 4-device run."""
    got = solver_runs[name][1][0][0][0]
    ref = jax_4device_runs[name]
    res = types.SimpleNamespace(
        w=got["w"], history=got["history"],
        ledger=comm.CommLedger(*got["ledger"]),
        partition_info=got["partition_info"])
    if name not in SPREAD_CASES:
        _assert_matches(res, ref)
        return
    w = np.asarray(ref["w"], np.float32)
    rel = np.linalg.norm(got["w"] - w) / np.linalg.norm(w)
    assert 0 < ref["spread"] and rel <= 2 * ref["spread"], (rel, ref)
    assert [int(h["pcg_iters"]) for h in got["history"]] == ref["pcg_iters"]
    assert list(got["ledger"]) == ref["ledger"]
    assert got["partition_info"] == ref["partition_info"]


# ---------------------------------------------------------------------------
# the baselines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def baseline_runs():
    X, y, _ = make_glm_data(**BASELINE_DATA)
    data = (np.asarray(X), np.asarray(y))
    twins = ranks.baseline_cases(InProcessGroup(M), BASELINE_CASES, data,
                                 threads=torch.get_num_threads())
    per_rank = spawn(ranks.baseline_cases, M, backend="gloo", device="cpu",
                     args=(BASELINE_CASES, data), timeout_s=TIMEOUT_S)
    return {k: (twins[k], [r[k] for r in per_rank]) for k in twins}


@pytest.mark.parametrize("case", BASELINE_CASES,
                         ids=lambda c: f"{c[0]}-{c[1]}")
def test_distributed_baseline_equals_in_process(baseline_runs, case):
    (twin, twin_counts), per_rank = baseline_runs[f"{case[0]}-{case[1]}"]
    for got, counts in per_rank:
        assert np.array_equal(got["w"], twin["w"])
        assert got["history"] == twin["history"]
        assert got["ledger"] == twin["ledger"]
        assert _same_counts(counts, twin_counts)
    counts, iters = per_rank[0][1], len(twin["history"])
    if case[0] == "cocoa":
        # pinned: the reported gradient norm's d-vector all-reduce a step
        assert counts["vector_calls"] == twin["ledger"][2] + iters
    else:
        assert counts["vector_calls"] == twin["ledger"][2]


# ---------------------------------------------------------------------------
# the group itself
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nproc", [2, 4])
def test_group_interface_and_ordered_sum(nproc):
    dim = 37
    out = spawn(ranks.group_units, nproc, backend="gloo", device="cpu",
                args=(dim,), timeout_s=TIMEOUT_S)
    parts = [torch.from_numpy(np.random.default_rng(r).standard_normal(dim)
                              .astype(np.float32)) for r in range(nproc)]
    local = InProcessGroup(nproc)
    assert (local.rank, tuple(local.local)) == (0, tuple(range(nproc)))
    want = local.all_reduce(parts)
    want_scalar = local.all_reduce([torch.dot(p, p) for p in parts])
    for r, o in enumerate(out):
        assert (o["size"], o["rank"], o["local"], o["backend"]) == \
            (nproc, r, (r,), "gloo")
        assert torch.equal(o["sum"], want)
        assert torch.equal(o["scalar"], want_scalar)
        assert torch.equal(o["gather"], torch.stack(parts))
        assert len(o["errors"]) == 4
        assert all("this process holds 1 of the group's" in e
                   for e in o["errors"])
        c = o["counts"]
        assert o["broadcast"] == (("rank", 0), nproc - 1)
        assert (c["vector_calls"], c["vector_floats"], c["scalar_calls"],
                c["gather_calls"], c["gather_floats"], c["barrier_calls"],
                c["broadcast_calls"]) == (1, dim, 1, 1, dim, 1, 2)
    with pytest.raises(ValueError, match=f"holds {nproc} of"):
        local.all_reduce(parts[:1])
    # in process: a barrier waits for nobody, a broadcast is the object
    local.barrier()
    obj = {"w": np.arange(3)}
    assert local.broadcast_object(obj) is obj
    assert (local.barrier_calls, local.broadcast_calls) == (1, 1)


def test_nccl_without_a_card_raises(monkeypatch):
    """An nccl group needs a card: without one it raises before any
    rendezvous and never carries on on the CPU."""
    import torch.distributed as dist
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        DistributedGroup(backend="nccl", rank=0, size=1,
                         init_method="file:///nonexistent/rendezvous")
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="gloo' or 'nccl"):
        DistributedGroup(backend="mpi", rank=0, size=1,
                         init_method="file:///nonexistent/rendezvous")


FROM_ENV = textwrap.dedent("""
    import torch
    from repro_torch import DistributedGroup
    group = DistributedGroup.from_env(backend="gloo", timeout_s=30.0)
    got = group.all_reduce([torch.arange(3.0)])
    print("FROM_ENV", group.rank, group.size, tuple(group.local),
          got.tolist())
    group.close()
""")


def test_from_env_reads_the_torchrun_variables(monkeypatch):
    """``from_env`` builds the group a ``torchrun`` launch describes (one
    rank here, in a subprocess, rendezvous on a free localhost port), and
    without those variables raises."""
    import socket
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun variables"):
        DistributedGroup.from_env(backend="gloo")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=SRC, RANK="0", WORLD_SIZE="1",
               LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port), GLOO_SOCKET_IFNAME="lo")
    r = subprocess.run([sys.executable, "-c", FROM_ENV], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "FROM_ENV 0 1 (0,) [0.0, 1.0, 2.0]" in r.stdout


def test_a_rank_that_raises_makes_spawn_raise():
    with pytest.raises(RankError, match="rank 1 fails on purpose"):
        spawn(ranks.raise_on_rank, 2, backend="gloo", device="cpu",
              args=(1,), timeout_s=TIMEOUT_S)

