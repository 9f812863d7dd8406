"""The port's robustness layer (``repro_torch.robust``) and the
checkpoint/resume of its in-memory solve, against the JAX package's.

Counterparts of the retry, fault, checkpoint and solver cases of
``tests/test_robust.py``. The reference's solver cases stream from a
store, whose streamed solve fails on this JAX (ROADMAP F0); here the
solver cases kill the port's *in-memory* fit through ``solver._faults``
(the reference's hook) and hold it to the reference's in-memory fit,
killed and resumed the same way (``REPRO_KERNEL_MODE=ref``). Cross-package
cases: a checkpoint written by either package loads in the other with
the same fields, and a solve killed in one package resumes in the other
to the other's uninterrupted ``w``.

Tolerances: a port solve resumed from its own checkpoint is its
uninterrupted solve bit for bit (the checkpoint holds the f32 iterate
exactly and the port draws nothing); against the reference, ``w`` within
rtol 1e-4 / atol 1e-6 (another f32 summation order, as
``tests/test_torch_disco.py``), per-step PCG iterations and the ledger
equal.
"""
import json
import os

import numpy as np
import pytest

from repro import obs as jobs
from repro.core import DiscoConfig as JDiscoConfig
from repro.core import DiscoSolver as JDiscoSolver
from repro.data.sparse import make_sparse_glm_data
from repro.robust import checkpoint as jckpt
from repro.robust import faults as jfaults
from repro.robust import retry as jretry
from repro_torch import obs
from repro_torch import CSRMatrix, DiscoConfig, DiscoSolver, InProcessGroup
from repro_torch.robust import (CheckpointState, ChunkReadError,
                                FaultInjector, FaultPlan, RetryPolicy,
                                SimulatedCrash, SimulatedKill,
                                StepDeadlineExceeded, call_with_retries,
                                crashpoint, latest_checkpoint,
                                load_checkpoint, save_checkpoint)
from repro_torch.robust.checkpoint import CHECKPOINT_VERSION

RTOL, ATOL = 1e-4, 1e-6
TRAJECTORY = ("outer_iter", "pcg_iters", "comm_rounds_cum",
              "comm_floats_cum")


@pytest.fixture(autouse=True)
def _obs_clean():
    obs.disable()
    jobs.disable()
    yield
    obs.disable()
    jobs.disable()


@pytest.fixture()
def ref_mode(monkeypatch):
    monkeypatch.setenv("REPRO_KERNEL_MODE", "ref")


# ---------------------------------------------------------------------------
# retry policy
# ---------------------------------------------------------------------------

def test_retry_backoff_schedule():
    """Two failures then success: the recorded sleeps are the exponential
    schedule (the reference's) and the step returns its value."""
    sleeps = []
    policy = RetryPolicy(max_retries=3, backoff_s=0.05, backoff_factor=2.0,
                         sleep=sleeps.append)
    calls = [0]

    def flaky():
        calls[0] += 1
        if calls[0] <= 2:
            raise ChunkReadError("boom")
        return "ok"

    assert call_with_retries(flaky, policy,
                             retryable=(ChunkReadError,)) == "ok"
    assert calls[0] == 3
    assert sleeps == [0.05, 0.1]
    assert policy.backoff_schedule() == [0.05, 0.1, 0.2]
    assert policy.backoff_schedule() == jretry.RetryPolicy(
        max_retries=3, backoff_s=0.05, backoff_factor=2.0).backoff_schedule()


def test_retry_exhaustion_raises_last_error():
    sleeps = []
    policy = RetryPolicy(max_retries=2, backoff_s=0.01, sleep=sleeps.append)
    calls = [0]

    def always_fails():
        calls[0] += 1
        raise ChunkReadError(f"attempt {calls[0]}")

    with pytest.raises(ChunkReadError, match="attempt 3"):
        call_with_retries(always_fails, policy, retryable=(ChunkReadError,))
    assert calls[0] == 3 and len(sleeps) == 2


def test_retry_deadline_escalates():
    clock = [0.0]
    policy = RetryPolicy(max_retries=100, backoff_s=0.0, deadline_s=1.0,
                         sleep=lambda s: None)

    def tick():
        clock[0] += 0.4
        raise ChunkReadError("still down")

    with pytest.raises(StepDeadlineExceeded, match="deadline") as info:
        call_with_retries(tick, policy, retryable=(ChunkReadError,),
                          clock=lambda: clock[0])
    assert isinstance(info.value.__cause__, ChunkReadError)


def test_retry_does_not_swallow_non_retryable():
    policy = RetryPolicy(max_retries=5, sleep=lambda s: None)
    calls = [0]

    def broken():
        calls[0] += 1
        raise ValueError("programming error")

    with pytest.raises(ValueError):
        call_with_retries(broken, policy, retryable=(ChunkReadError,))
    assert calls[0] == 1


def test_retries_are_traced():
    """Each caught failure is one ``io.retry`` instant (attempt, error
    type) and one ``io.retries`` count, as in the reference."""
    tracer = obs.enable(reset=True)
    calls = [0]

    def flaky():
        calls[0] += 1
        if calls[0] <= 2:
            raise ChunkReadError("boom")
        return calls[0]

    call_with_retries(flaky, RetryPolicy(sleep=lambda s: None),
                      retryable=(ChunkReadError,))
    events, counters, _ = tracer.snapshot()
    assert [e.args for e in events if e.kind == "io.retry"] == [
        {"attempt": 0, "error": "ChunkReadError"},
        {"attempt": 1, "error": "ChunkReadError"}]
    assert counters == {"io.retries": 2}


# ---------------------------------------------------------------------------
# fault plans / injector
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,rate", [(7, 0.5), (8, 0.5), (3, 0.1)])
def test_fault_plan_rate_is_deterministic(seed, rate):
    """The faulty-chunk set is a function of (seed, cid) alone, the same
    in both packages."""
    a, b = FaultPlan(seed=seed, read_error_rate=rate), \
        FaultPlan(seed=seed, read_error_rate=rate)
    faulty = [cid for cid in range(64) if a.chunk_is_faulty(cid)]
    assert faulty == [cid for cid in range(64) if b.chunk_is_faulty(cid)]
    assert 0 < len(faulty) < 64
    ref = jfaults.FaultPlan(seed=seed, read_error_rate=rate)
    assert faulty == [cid for cid in range(64) if ref.chunk_is_faulty(cid)]
    other = FaultPlan(seed=seed + 100, read_error_rate=rate)
    assert faulty != [cid for cid in range(64) if other.chunk_is_faulty(cid)]


def test_fault_injector_rearms_after_success():
    inj = FaultInjector(FaultPlan(fail_chunks=frozenset({3}),
                                  read_error_attempts=2),
                        sleep=lambda s: None)
    for _ in range(2):                       # two full passes
        for _ in range(2):
            with pytest.raises(ChunkReadError):
                inj.on_chunk_read(3)
        inj.on_chunk_read(3)                 # third read succeeds
        inj.on_chunk_read(0)                 # a clean chunk never fails
    assert inj.faults_injected == 4
    assert inj.reads == 4                    # only completed reads count


def test_fault_injector_latency_and_kill():
    slept = []
    inj = FaultInjector(FaultPlan(slow_chunks={5: 0.25},
                                  kill_after_reads=3),
                        sleep=slept.append)
    inj.on_chunk_read(5)
    assert slept == [0.25]
    inj.on_chunk_read(0)
    with pytest.raises(SimulatedKill):
        inj.on_chunk_read(1)
    inj2 = FaultInjector(FaultPlan(kill_at_step=2))
    inj2.on_outer_step(0)
    inj2.on_outer_step(1)
    with pytest.raises(SimulatedKill):
        inj2.on_outer_step(2)


def test_crashpoints():
    crashpoint(None, "publish:staged")       # no injector: a no-op
    inj = FaultInjector(FaultPlan(crash_at=frozenset({"publish:staged"})))
    crashpoint(inj, "publish:renamed")
    with pytest.raises(SimulatedCrash, match="publish:staged"):
        crashpoint(inj, "publish:staged")


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _ckpt_state(it, d=5, seed=0, cls=CheckpointState):
    rng = np.random.default_rng(seed + it)
    return cls(
        next_iter=it, w=rng.standard_normal(d).astype(np.float32),
        key=np.array([1, it], np.uint32),
        history=[{"grad_norm": 0.5 / (j + 1)} for j in range(it)],
        ledger=dict(rounds=2 * it, floats=10 * it, spmd_collectives=2 * it),
        replan_events=[{"outer_iter": 0}] if it > 1 else [],
        cfg={"lam": 0.01, "partition": "samples"})


def test_checkpoint_roundtrip_and_prune(tmp_path):
    """Save/load round-trips every field; LATEST tracks the newest
    snapshot; snapshots beyond the newest two are pruned."""
    path = str(tmp_path / "ckpt")
    for it in (1, 2, 3):
        save_checkpoint(path, _ckpt_state(it))
    assert latest_checkpoint(path) == 3
    got = load_checkpoint(path)
    want = _ckpt_state(3)
    np.testing.assert_array_equal(got.w, want.w)
    np.testing.assert_array_equal(got.key, want.key)
    assert got.key.dtype == np.uint32
    assert got.next_iter == 3
    assert got.history == want.history
    assert got.ledger == want.ledger
    assert got.replan_events == want.replan_events
    assert got.cfg == want.cfg
    kept = sorted(n for n in os.listdir(path) if n.startswith("it-"))
    assert kept == ["it-00000002", "it-00000003"]


def test_checkpoint_empty_and_stale_tmp(tmp_path):
    path = str(tmp_path / "ckpt")
    assert load_checkpoint(path) is None
    os.makedirs(os.path.join(path, ".tmp-it-00000001"))  # crash leftover
    save_checkpoint(path, _ckpt_state(1))
    assert load_checkpoint(path).next_iter == 1
    assert not os.path.exists(os.path.join(path, ".tmp-it-00000001"))
    save_checkpoint(path, _ckpt_state(1, seed=9))        # re-save
    np.testing.assert_array_equal(load_checkpoint(path).w,
                                  _ckpt_state(1, seed=9).w)


def test_checkpoint_refuses_other_format(tmp_path):
    path = str(tmp_path / "ckpt")
    snap = save_checkpoint(path, _ckpt_state(2))
    state = os.path.join(snap, "state.json")
    with open(state) as f:
        header = json.load(f)
    header["format_version"] = CHECKPOINT_VERSION + 1
    with open(state, "w") as f:
        json.dump(header, f)
    with pytest.raises(ValueError, match="format"):
        load_checkpoint(path)


def test_checkpoint_write_is_traced_and_dumps_numpy_scalars(tmp_path):
    """A snapshot write is one ``ckpt.write`` span; numpy scalars in the
    history are written as floats."""
    tracer = obs.enable(reset=True)
    state = _ckpt_state(2)
    state.history = [{"grad_norm": np.float32(0.25), "pcg_iters": 3}]
    save_checkpoint(str(tmp_path), state)
    assert [e.args for e in tracer.events if e.kind == "ckpt.write"] == \
        [{"next_iter": 2}]
    assert load_checkpoint(str(tmp_path)).history == \
        [{"grad_norm": 0.25, "pcg_iters": 3}]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoint_format_matches_reference(tmp_path, writer):
    """A checkpoint written by either package loads in the other with
    every field equal, and the two writers leave the same files."""
    path = str(tmp_path / "ckpt")
    for it in (1, 2, 3):
        if writer == "port":
            save_checkpoint(path, _ckpt_state(it))
        else:
            jckpt.save_checkpoint(path, _ckpt_state(
                it, cls=jckpt.CheckpointState))
    got = (jckpt.load_checkpoint if writer == "port" else
           load_checkpoint)(path)
    want = _ckpt_state(3)
    np.testing.assert_array_equal(got.w, want.w)
    np.testing.assert_array_equal(got.key, want.key)
    assert got.key.dtype == np.uint32
    assert (got.next_iter, got.history, got.ledger, got.replan_events,
            got.cfg) == (want.next_iter, want.history, want.ledger,
                         want.replan_events, want.cfg)
    other = str(tmp_path / "other")
    for it in (1, 2, 3):
        if writer == "port":
            jckpt.save_checkpoint(other, _ckpt_state(
                it, cls=jckpt.CheckpointState))
        else:
            save_checkpoint(other, _ckpt_state(it))
    for name in ("LATEST", "it-00000003/state.json", "it-00000003/w.npy"):
        with open(os.path.join(path, name), "rb") as a, \
                open(os.path.join(other, name), "rb") as b:
            assert a.read() == b.read(), name
    assert sorted(os.listdir(path)) == sorted(os.listdir(other))


# ---------------------------------------------------------------------------
# solver integration: kill the in-memory fit, resume it
# ---------------------------------------------------------------------------

def _problem(seed=1):
    X, y, _ = make_sparse_glm_data(d=96, n=160, density=0.2, alpha=1.0,
                                   beta=0.5, seed=seed)
    return X, y, CSRMatrix(X.indptr, X.indices, X.data, X.shape)


def _cfg_kw(**kw):
    base = dict(partition="samples", loss="logistic", lam=1e-2, tau=16,
                max_outer=6, grad_tol=1e-9, ell_block_d=8, ell_block_n=8,
                partition_block=16)
    base.update(kw)
    return base


def _data(kind):
    X, y, Xt = _problem()
    if kind == "dense":
        Xd = X.todense()
        return Xd, y, Xd
    return X, y, Xt


def _kill(solver, ckpt, step, package="port", **fit_kw):
    """Fit with checkpoints until the injected kill at ``step``."""
    if package == "port":
        solver._faults = FaultInjector(FaultPlan(kill_at_step=step))
        with pytest.raises(SimulatedKill):
            solver.fit(checkpoint_dir=ckpt, **fit_kw)
    else:
        solver._faults = jfaults.FaultInjector(
            jfaults.FaultPlan(kill_at_step=step))
        with pytest.raises(jfaults.SimulatedKill):
            solver.fit(checkpoint_dir=ckpt, **fit_kw)
    solver._faults = None


def _same_trajectory(got, want):
    assert len(got.history) == len(want.history)
    for a, b in zip(got.history, want.history):
        for k in TRAJECTORY:
            assert a[k] == b[k], k
    led = lambda r: (r.ledger.rounds, r.ledger.floats,
                     r.ledger.spmd_collectives)
    assert led(got) == led(want)


@pytest.mark.parametrize("kind,partition,m", [
    ("sparse", "samples", 1), ("sparse", "features", 1),
    ("sparse", "samples", 4), ("dense", "samples", 1),
    ("dense", "features", 1), ("dense", "features", 4)])
def test_solver_kill_and_resume_matches(tmp_path, ref_mode, kind,
                                        partition, m):
    """Kill the port's fit at outer step 2, resume from the checkpoint:
    the full history, the uninterrupted ledger and ``w`` bit for bit; the
    reference's in-memory fit killed and resumed the same way lands on the
    port's ``w`` within rtol 1e-4 / atol 1e-6 with the same trajectory."""
    X, y, Xp = _data(kind)
    kw = _cfg_kw(partition=partition)
    solver = DiscoSolver(Xp, y, DiscoConfig(**kw), group=InProcessGroup(m),
                         device="cpu")
    ref = solver.fit()
    ckpt = str(tmp_path / "ckpt")
    _kill(solver, ckpt, 2)
    assert latest_checkpoint(ckpt) == 2
    state = load_checkpoint(ckpt)
    assert len(state.history) == 2 and state.ledger["rounds"] > 0
    for a, b in zip(state.history, ref.history):
        assert set(a) == set(b)
        for k in TRAJECTORY:
            assert a[k] == b[k], k
        assert a["iter_s"] > 0.0
    res = solver.fit(checkpoint_dir=ckpt, resume=True)
    np.testing.assert_array_equal(res.w, ref.w)
    _same_trajectory(res, ref)
    assert latest_checkpoint(ckpt) == len(ref.history)
    if m == 1:
        jsolver = JDiscoSolver(X, y, JDiscoConfig(**kw))
        jckdir = str(tmp_path / "jckpt")
        _kill(jsolver, jckdir, 2, package="reference")
        jres = jsolver.fit(checkpoint_dir=jckdir, resume=True)
        np.testing.assert_allclose(res.w, np.asarray(jres.w), rtol=RTOL,
                                   atol=ATOL)
        _same_trajectory(res, jres)


def test_disco_f_m4_kill_and_resume_every_other_step(tmp_path):
    """DiSCO-F over 4 shards (features permuted by the LPT balancer),
    checkpointed every second step and killed at step 3: the resume
    starts from step 2's snapshot and repeats the uninterrupted solve bit
    for bit (the reference runs this case in a 4-device subprocess)."""
    _, y, Xt = _problem(seed=3)
    cfg = DiscoConfig(**_cfg_kw(partition="features", max_outer=5))
    solver = DiscoSolver(Xt, y, cfg, group=InProcessGroup(4), device="cpu")
    assert not np.array_equal(solver._perm[:len(solver._perm) // 4],
                              np.arange(len(solver._perm) // 4))
    ref = solver.fit()
    ckpt = str(tmp_path / "ckpt")
    _kill(solver, ckpt, 3, checkpoint_every=2)
    assert latest_checkpoint(ckpt) == 2
    fresh = DiscoSolver(Xt, y, cfg, group=InProcessGroup(4), device="cpu")
    res = fresh.fit(checkpoint_dir=ckpt, resume=True, checkpoint_every=2)
    np.testing.assert_array_equal(res.w, ref.w)
    _same_trajectory(res, ref)
    assert latest_checkpoint(ckpt) == 4      # the last multiple of 2


def test_solver_resume_refuses_cfg_mismatch(tmp_path):
    _, y, Xt = _problem()
    ckpt = str(tmp_path / "ckpt")
    solver = DiscoSolver(Xt, y, DiscoConfig(**_cfg_kw()), device="cpu")
    _kill(solver, ckpt, 1)
    other = DiscoSolver(Xt, y, DiscoConfig(**_cfg_kw(lam=2e-2)),
                        device="cpu")
    with pytest.raises(ValueError, match="different config"):
        other.fit(checkpoint_dir=ckpt, resume=True)


def test_traced_resume_of_untraced_checkpoint(tmp_path):
    """``trace`` is left out of the fingerprint: a traced solver resumes
    an untraced one's checkpoint and traces the remaining steps."""
    _, y, Xt = _problem()
    ckpt = str(tmp_path / "ckpt")
    solver = DiscoSolver(Xt, y, DiscoConfig(**_cfg_kw()), device="cpu")
    ref = solver.fit()
    _kill(solver, ckpt, 4)
    assert "trace" not in load_checkpoint(ckpt).cfg
    traced = DiscoSolver(Xt, y, DiscoConfig(**_cfg_kw(trace=True)),
                         device="cpu")
    tracer = obs.get_tracer()
    res = traced.fit(checkpoint_dir=ckpt, resume=True)
    np.testing.assert_array_equal(res.w, ref.w)
    outer = [e.args["outer_iter"] for e in tracer.events
             if e.kind == "newton.outer"]
    assert outer == list(range(4, len(ref.history)))
    # the counters tally the resumed steps only
    assert tracer.counters["comm.rounds"] == \
        ref.ledger.rounds - ref.history[3]["comm_rounds_cum"]
    assert len(res.history) == len(ref.history)


def test_resume_without_a_checkpoint_fits_from_scratch(tmp_path):
    _, y, Xt = _problem()
    solver = DiscoSolver(Xt, y, DiscoConfig(**_cfg_kw(max_outer=3)),
                         device="cpu")
    ref = solver.fit()
    res = solver.fit(checkpoint_dir=str(tmp_path / "none"), resume=True)
    np.testing.assert_array_equal(res.w, ref.w)
    assert latest_checkpoint(str(tmp_path / "none")) == 3


# ---------------------------------------------------------------------------
# a solve killed in one package resumes in the other
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("kind,partition", [("sparse", "samples"),
                                            ("sparse", "features"),
                                            ("dense", "samples")])
def test_checkpoint_resumes_across_packages(tmp_path, ref_mode, writer,
                                            kind, partition):
    """Killed at step 3 in one package, resumed in the other: the
    resumer's uninterrupted ``w`` within rtol 1e-4 / atol 1e-6 and its
    trajectory (PCG iterations, ledger) unchanged."""
    X, y, Xp = _data(kind)
    kw = _cfg_kw(partition=partition)
    port = DiscoSolver(Xp, y, DiscoConfig(**kw), device="cpu")
    ref = JDiscoSolver(X, y, JDiscoConfig(**kw))
    ckpt = str(tmp_path / "ckpt")
    if writer == "port":
        _kill(port, ckpt, 3)
        want = ref.fit()
        got = ref.fit(checkpoint_dir=ckpt, resume=True)
    else:
        _kill(ref, ckpt, 3, package="reference")
        want = port.fit()
        got = port.fit(checkpoint_dir=ckpt, resume=True)
    np.testing.assert_allclose(np.asarray(got.w), np.asarray(want.w),
                               rtol=RTOL, atol=ATOL)
    _same_trajectory(got, want)
