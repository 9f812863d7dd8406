"""The port's streamed (out-of-core) DiSCO solve (``DiscoSolver.from_store``,
``disco_fit_streaming``) against its own in-memory solve and the JAX
package's in-memory solve.

The reference's *streamed* solve fails on this JAX (ROADMAP F0), so it is
never the comparator. At ``partition_block = stream_chunk_size`` the
in-memory solvers of both packages realise the same chunk-granular
partition as the streamed one (``repro/data/stream.py``), so:

* against the port's in-memory solve: the same ``partition_info``, the
  same PCG iterations on every step, and ``w`` within relative L2 1e-5
  (the chunk-sum order alone: about 1e-7 measured, 1.3e-6 at s = 3,
  whose rounds are more sensitive to it, ROADMAP F4); at bf16 tiles within
  3e-4 and PCG iterations within one (ROADMAP F11: a bf16 solve moves
  about 1e-4 with the f32 summation order);
* against the reference's in-memory solve (``REPRO_KERNEL_MODE=ref``; at
  m = 4 in a subprocess with four forced host devices): ``w`` within
  rtol 1e-4 / atol 1e-6, as ``tests/test_streaming.py`` holds the
  reference's own streamed solve; relative L2 3e-4 at bf16; at
  ``hessian_subsample = 1.0`` only (the port draws its masks from
  ``(seed, outer_iter, shard)``, ROADMAP F1).

The subsampled cells run at ``lam = 0.1``: at 1e-2 a subsampled solve of
this problem moves by 1e-2 in ``w`` under a one-ulp nudge of one value of
X (PCG runs 23+ iterations on the subsampled Hessian), which would hide
any fault; at 0.1 it moves by 1e-7, and the streamed solve draws the same
masks as the in-memory one.

Counterparts of the reference's streamed cases: ``tests/test_streaming.py``
(the converged endpoint, the wrapper, the axis check),
``tests/test_hvp_fused.py`` (fused and bf16 byte ratios),
``tests/test_hvp_operator.py`` (the streamed conformance cells;
``binary/streamed/features/fused`` raises), ``tests/test_robust.py`` (retry,
kill and resume, a config mismatch, re-plan against static) and
``tests/test_obs.py`` (traced streamed rounds equal the ledger; a streamed
checkpoint round trip).

The cells against the port's in-memory solve are in
``tests/test_torch_streaming_port.py``, those against the reference's in
``tests/test_torch_streaming_reference.py``; what the three files share is
``tests/torch_streaming_common.py``.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import DiscoConfig as JDiscoConfig
from repro.core import DiscoSolver as JDiscoSolver
from repro.core.hvp import operator_cells as j_operator_cells
from repro.data.sparse import make_sparse_glm_data
from repro_torch import (CSRMatrix, DiscoConfig, DiscoSolver, InProcessGroup,
                         disco_fit, disco_fit_streaming, obs)
from repro_torch.core.hvp import UnsupportedHvpError, cell_id, operator_cells
from repro_torch.data.store import ShardStore
from repro_torch.data.stream import plan_streams
from repro_torch.robust import (FaultPlan, SimulatedKill, latest_checkpoint,
                                load_checkpoint)
# _obs_clean, _one_thread (autouse) and stores are the shared module's
# fixtures
from torch_streaming_common import (_obs_clean, _one_thread, SOLVE, RTOL, ATOL,
                                    VARIANTS, _data, _cfg, stores, _streamed,
                                    _iters, _rel)


# ---------------------------------------------------------------------------
# counterparts of the reference's streamed cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("partition", ["features", "samples"])
def test_streaming_converges_to_inmemory_endpoint(tmp_path, monkeypatch,
                                                  partition):
    """``tests/test_streaming.py``: a converged streamed solve reaches
    the in-memory endpoint (both packages'), with the byte ledger bounded
    by chunk x depth."""
    X, y, Xt = _data()
    store = ShardStore.from_csr(Xt, y, str(tmp_path / "s"), axis=partition,
                                chunk_size=16)
    kw = dict(SOLVE, max_outer=15, grad_tol=2e-8, partition=partition)
    rs = DiscoSolver.from_store(store, DiscoConfig(**kw), device="cpu").fit()
    rm = DiscoSolver(Xt, y, DiscoConfig(**kw), device="cpu").fit()
    monkeypatch.setenv("REPRO_KERNEL_MODE", "ref")
    rj = JDiscoSolver(X, y, JDiscoConfig(**kw)).fit()
    assert rs.converged and rm.converged and rj.converged
    np.testing.assert_allclose(rs.w, rm.w, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(rs.w, np.asarray(rj.w), atol=ATOL, rtol=RTOL)
    assert rs.partition_info == rm.partition_info == rj.partition_info
    st = rs.stream_stats
    assert st["peak_bytes"] <= (2 + 2) * st["max_step_bytes"]
    assert st["peak_bytes"] < st["bytes_loaded"] / 4


@pytest.mark.parametrize("partition", ["features", "samples"])
def test_disco_fit_streaming_wrapper(tmp_path, partition):
    _, y, X = _data(seed=5)
    cfg = DiscoConfig(partition=partition, **dict(SOLVE, max_outer=8,
                                                  grad_tol=1e-9))
    rs = disco_fit_streaming(X, y, str(tmp_path / "s"), cfg,
                             group=InProcessGroup(2), device="cpu")
    rm = disco_fit(X, y, cfg, group=InProcessGroup(2), device="cpu")
    np.testing.assert_allclose(rs.w, rm.w, atol=ATOL, rtol=RTOL)
    assert ShardStore(str(tmp_path / "s")).axis == partition


def test_from_store_axis_mismatch(tmp_path):
    _, y, X = _data(seed=6)
    store = ShardStore.from_csr(X, y, str(tmp_path / "s"), axis="samples",
                                chunk_size=16)
    with pytest.raises(ValueError, match="chunked along"):
        DiscoSolver.from_store(store, DiscoConfig(partition="features"),
                               device="cpu")


def test_streamed_solver_refuses_with_lam(stores):
    solver = _streamed(stores, "samples", 1, _cfg("samples"))
    with pytest.raises(ValueError, match="from_store"):
        solver.with_lam(1e-3)


def test_streaming_fused_bf16_byte_ratio(tmp_path):
    """``tests/test_hvp_fused.py``: the fused f32 stream equals the
    two-pass one to 1e-6 of scale; the fused bf16 stream (one layout, half
    the bytes a value) loads under 0.75x the two-pass f32 stream's bytes
    and lands near the in-memory endpoint."""
    _, y, X = _data(seed=6)
    store = ShardStore.from_csr(X, y, str(tmp_path / "s"), axis="samples",
                                chunk_size=16)
    cfg = DiscoConfig(partition="samples", **dict(SOLVE, max_outer=8,
                                                  grad_tol=1e-9))
    rm = DiscoSolver(X, y, cfg, device="cpu").fit()
    plain = DiscoSolver.from_store(store, cfg, device="cpu").fit()
    f32 = DiscoSolver.from_store(
        store, dataclasses.replace(cfg, hvp_fused=True), device="cpu").fit()
    scale = np.abs(plain.w).max()
    np.testing.assert_allclose(f32.w, plain.w, atol=1e-6 * scale, rtol=1e-6)
    fused = DiscoSolver.from_store(
        store, dataclasses.replace(cfg, hvp_fused=True,
                                   hvp_dtype="bfloat16"), device="cpu").fit()
    np.testing.assert_allclose(plain.w, rm.w, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(fused.w, rm.w, atol=1e-3, rtol=1e-3)
    assert fused.stream_stats["bytes_loaded"] \
        < 0.75 * plain.stream_stats["bytes_loaded"]


STREAMED = [c for c in operator_cells()
            if c.family == "binary" and c.layout == "streamed"]


def test_streamed_cells_match_reference_registry():
    want = [c for c in j_operator_cells()
            if c.family == "binary" and c.layout == "streamed"]
    assert [tuple(c) for c in STREAMED] == [tuple(c) for c in want]


@pytest.mark.parametrize("cell", STREAMED,
                         ids=[cell_id(*c[:5]) for c in STREAMED])
def test_streamed_conformance_cell(tmp_path, cell):
    """``tests/test_hvp_operator.py``'s streamed cells: a supported cell's
    streamed solve lands on the in-memory two-pass f32 endpoint of its
    partitioning (rel. 1e-4 at f32, 1e-2 at bf16); the unsupported one
    (``binary/streamed/features/fused``) raises at set-up, the cell
    named."""
    X, y, _, = make_sparse_glm_data(d=48, n=96, density=0.25, seed=7)
    X = CSRMatrix(X.indptr, X.indices, X.data, X.shape)
    store = ShardStore.from_csr(X, y, str(tmp_path / "s"),
                                axis=cell.partition, chunk_size=16)
    base = DiscoConfig(loss="logistic", lam=1e-2, tau=16, max_outer=4,
                       grad_tol=1e-9, ell_block_d=8, ell_block_n=8,
                       partition_block=16, stream_chunk_size=16,
                       partition=cell.partition)
    cfg = dataclasses.replace(base, hvp_fused=cell.fused,
                              hvp_dtype=cell.dtype)
    if not cell.supported:
        with pytest.raises(UnsupportedHvpError,
                           match=cell_id(*cell[:5]).replace("/", "/")):
            DiscoSolver.from_store(store, cfg, device="cpu")
        return
    res = DiscoSolver.from_store(store, cfg, device="cpu").fit()
    ref = DiscoSolver(X, y, base, device="cpu").fit()
    tol = 1e-4 if cell.dtype == "float32" else 1e-2
    assert _rel(res.w, ref.w) <= tol


# ---------------------------------------------------------------------------
# robustness on streamed solves (tests/test_robust.py)
# ---------------------------------------------------------------------------

def _prefetch_threads():
    import threading
    return [t for t in threading.enumerate()
            if t.name == "repro-chunk-prefetch" and t.is_alive()]


def _robust_cfg(**kw):
    return DiscoConfig(**dict(SOLVE, partition="samples", max_outer=6,
                              grad_tol=1e-9, **kw))


@pytest.mark.parametrize("variant", ["classic", "s2"])
def test_solver_retry_path_matches_fault_free(stores, variant):
    """Transient read faults, retried inside the producer, leave the
    solve bit for bit the fault-free one (K1 and the s-step's K6)."""
    cfg = _robust_cfg(io_backoff_s=0.0, **VARIANTS[variant])
    ref = _streamed(stores, "samples", 1, cfg).fit()
    solver = _streamed(stores, "samples", 1, cfg,
                       fault_plan=FaultPlan(seed=5, read_error_rate=0.5,
                                            read_error_attempts=1))
    res = solver.fit()
    assert solver._faults.faults_injected > 0
    np.testing.assert_array_equal(res.w, ref.w)
    assert len(res.history) == len(ref.history)
    assert _prefetch_threads() == []


@pytest.mark.parametrize("partition,m", [("samples", 1), ("features", 4)])
def test_solver_kill_and_resume_matches(stores, tmp_path, partition, m):
    """Killed at outer step 2 and resumed from the checkpoint: the
    uninterrupted endpoint (rel. <= 1e-7; bit for bit here) and the full
    history; the final checkpoint is the completed solve's."""
    cfg = DiscoConfig(**dict(SOLVE, partition=partition, max_outer=6,
                             grad_tol=1e-9))
    ckpt = str(tmp_path / "ckpt")
    ref = _streamed(stores, partition, m, cfg).fit()
    with pytest.raises(SimulatedKill):
        _streamed(stores, partition, m, cfg,
                  fault_plan=FaultPlan(kill_at_step=2)).fit(
                      checkpoint_dir=ckpt)
    assert latest_checkpoint(ckpt) == 2
    res = _streamed(stores, partition, m, cfg).fit(checkpoint_dir=ckpt,
                                                   resume=True)
    assert len(res.history) == len(ref.history)
    assert _rel(res.w, ref.w) <= 1e-7
    np.testing.assert_array_equal(res.w, ref.w)
    assert latest_checkpoint(ckpt) == len(ref.history)


def test_solver_resume_refuses_cfg_mismatch(stores, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    with pytest.raises(SimulatedKill):
        _streamed(stores, "samples", 1, _robust_cfg(),
                  fault_plan=FaultPlan(kill_at_step=1)).fit(
                      checkpoint_dir=ckpt)
    with pytest.raises(ValueError, match="different config"):
        _streamed(stores, "samples", 1, _robust_cfg(lam=2e-2)).fit(
            checkpoint_dir=ckpt, resume=True)


@pytest.mark.parametrize("partition", ["samples", "features"])
def test_elastic_replan_matches_static(tmp_path, partition):
    """``tests/test_robust.py``'s re-plan case, in process at m = 4: with
    every chunk of shard 0's static plan straggling (injected latency,
    which the timing ledger measures), the re-planned solve fires at least
    one re-plan (DiSCO-S between PCG rounds, DiSCO-F between outer steps)
    and lands on the static solve's endpoint: DiSCO-S within rel. 2e-5
    (the bound the reference's test holds: the swap is exact, only the
    chunk-sum order follows the measured plan); DiSCO-F, whose
    block-diagonal preconditioner follows the shard membership, takes
    other Newton steps, so its converged endpoint within rel. 1e-4."""
    X, y, _ = make_sparse_glm_data(d=48, n=1024, density=0.15, alpha=1.0,
                                   beta=0.6, seed=3)
    if partition == "features":
        X, y, _ = make_sparse_glm_data(d=512, n=96, density=0.15,
                                       alpha=1.0, beta=0.6, seed=3)
    X = CSRMatrix(X.indptr, X.indices, X.data, X.shape)
    store = ShardStore.from_csr(X, y, str(tmp_path / "s"), axis=partition,
                                chunk_size=64)
    kw = dict(partition=partition, loss="logistic", lam=1e-2, tau=32,
              max_outer=3, grad_tol=1e-10, ell_block_d=16,
              ell_block_n=64 if partition == "samples" else 16,
              partition_block=64)
    tol = 2e-5
    if partition == "features":
        # the re-plan changes the block-diagonal preconditioner's blocks,
        # so the Newton steps differ: compare converged endpoints
        kw.update(ell_block_d=64, ell_block_n=16, max_outer=12,
                  grad_tol=1e-6)
        tol = 1e-4
    probe = plan_streams(store, 4, block_rows=kw["ell_block_d"],
                         block_cols=kw["ell_block_n"], device="cpu")
    slow = {int(c): 0.004 for c in probe.schedule[0] if c >= 0}
    group = InProcessGroup(4)
    static = DiscoSolver.from_store(store, DiscoConfig(**kw), group=group,
                                    device="cpu").fit()
    cfg = DiscoConfig(elastic_replan=True, replan_threshold=1.3, **kw)
    r = DiscoSolver.from_store(store, cfg, group=group, device="cpu",
                               fault_plan=FaultPlan(slow_chunks=slow)).fit()
    assert len(r.replan_events) >= 1, r.replan_events
    ev = r.replan_events[0]
    assert ev["moved_chunks"] > 0
    assert ev["barrier_s_after"] < ev["barrier_s_before"]
    assert ev["trigger"] == ("pcg" if partition == "samples" else "outer")
    assert _rel(r.w, static.w) <= tol, _rel(r.w, static.w)


# ---------------------------------------------------------------------------
# tracing and checkpoints of streamed solves (tests/test_obs.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("partition,block_s", [("features", 1),
                                               ("samples", 1),
                                               ("samples", 2),
                                               ("features", 2)])
def test_streamed_rounds_match_ledger(stores, partition, block_s):
    """A streamed solve counts rounds at its call sites; the tally equals
    the analytic ledger and the ``comm.allreduce`` marks; a ``pcg.round``
    span a round, an ``hvp.apply`` span a full product, a ``stream.pass``
    span a pass and a ``stream.chunk_load`` span a real chunk read."""
    tracer = obs.enable(reset=True)
    cfg = _cfg(partition, max_outer=4, pcg_block_s=block_s)
    solver = _streamed(stores, partition, 2, cfg)
    res = solver.fit()
    events, counters, _ = tracer.snapshot()
    assert res.ledger.rounds > 0
    assert counters["comm.rounds"] == res.ledger.rounds
    assert tracer.span_count("comm.allreduce") == res.ledger.rounds
    assert counters["comm.floats"] == res.ledger.floats
    assert counters["comm.spmd_collectives"] == res.ledger.spmd_collectives
    assert tracer.span_count("pcg.round") == sum(_iters(res))
    assert tracer.span_count("newton.outer") == len(res.history)
    assert all(e.args.get("streaming") for e in events
               if e.kind == "newton.outer")
    passes = res.stream_stats["passes"]
    assert tracer.span_count("stream.pass") == passes
    assert tracer.span_count("hvp.apply") > 0
    store = ShardStore(stores[partition])
    assert tracer.span_count("stream.chunk_load") >= store.n_chunks


def test_streamed_checkpoint_roundtrips_history_and_resume(stores,
                                                           tmp_path):
    """A traced, checkpointed streamed solve killed at step 3 resumes to
    the uninterrupted endpoint; the checkpoint carries the history
    (``iter_s`` included), the ledger and the re-plan events."""
    cfg = _cfg("samples", max_outer=6, trace=False)
    ckpt = str(tmp_path / "ckpt")
    whole = _streamed(stores, "samples", 1, cfg).fit()
    obs.enable(reset=True)
    with pytest.raises(SimulatedKill):
        _streamed(stores, "samples", 1, cfg,
                  fault_plan=FaultPlan(kill_at_step=3)).fit(
                      checkpoint_dir=ckpt)
    state = load_checkpoint(ckpt)
    assert state.next_iter == 3 and len(state.history) == 3
    assert all(h["iter_s"] > 0 for h in state.history)
    assert state.replan_events == []
    assert state.ledger["rounds"] == whole.history[2]["comm_rounds_cum"]
    res = _streamed(stores, "samples", 1, cfg).fit(checkpoint_dir=ckpt,
                                                   resume=True)
    np.testing.assert_array_equal(res.w, whole.w)
    assert [h["pcg_iters"] for h in res.history] == \
        [h["pcg_iters"] for h in whole.history]


@pytest.mark.parametrize("variant", ["classic", "bf16"])
def test_streamed_equals_one_shard_per_chunk_bit_for_bit(stores, variant):
    """The streamed DiSCO-S solve at m = 1 is the in-memory solve whose
    shards are the store's chunks (``partition_strategy='width'``, m = the
    chunk count) bit for bit: the same products chunk by chunk, summed in
    the same order. (Against the in-memory m = 1 solve only the sum order
    differs; that difference is what the tolerances above allow.)"""
    _, y, X = _data()
    cfg = _cfg("samples", variant)
    rs = _streamed(stores, "samples", 1, cfg).fit()
    n_chunks = ShardStore(stores["samples"]).n_chunks
    rm = DiscoSolver(X, y, dataclasses.replace(cfg, partition_strategy="width"),
                     group=InProcessGroup(n_chunks), device="cpu").fit()
    np.testing.assert_array_equal(rs.w, rm.w)
    assert _iters(rs) == _iters(rm)
