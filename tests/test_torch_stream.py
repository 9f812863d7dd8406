"""The port's streamed data plane (``repro_torch.data.stream``) and its
straggler layer (``repro_torch.robust.straggler``) against the JAX
package's (``repro.data.stream``, ``repro.robust.straggler``).

* The planner: partition, schedule and the global ELL widths equal the
  reference's on stores along both axes, at m = 1, 2 and 4, with the
  ``lpt`` and the equal-width (``width``) strategies; ``replan_streams``
  on the same measured costs equals the reference's.
* The payloads: every ``_load_step(t, kind, hvp)`` payload (``fwd``,
  ``tr``, ``both``; f32 and bf16) is the reference's numpy payload bit
  for bit (tiles, column ids, the byte count).
* The widths sidecar ``ell_widths.{br}x{bc}.json`` written by either
  package is read by the other.
* ``ell_plan`` + ``ell_fill`` against the reference's ``ell_from_csr``,
  bit for bit, over ragged shapes, empty matrices and both tile dtypes
  (hypothesis).
* Counterparts of the reference's unit tests of the prefetcher, the
  barrier model, the timing ledger and the re-planner
  (``tests/test_robust.py``), each also held to the reference's own
  result on the same inputs where there is one; ``elastic_replan_model``
  equal to the reference's.
* The fused kernels' fit rule mirrors the launch's arithmetic in
  ``csrc/ell_hvp_stream.cuh`` (constants parsed from the headers).

Everything here is exact (integers, or values copied bit for bit), so no
tolerance is needed except ``elastic_replan_model``'s float64 sums, which
are compared with ``==`` too (the same numpy arithmetic).
"""
import json
import os
import re
import threading

import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import comm as jcomm
from repro.data import sparse as jsparse
from repro.data.store import ShardStore as JShardStore
from repro.data import stream as jstream
from repro.robust import straggler as jstraggler
from repro_torch.core import comm
from repro_torch.data import stream
from repro_torch.data.sparse import (CSRMatrix, ell_fill, ell_from_csr,
                                     ell_plan, make_sparse_glm_data)
from repro_torch.data.store import ShardStore
from repro_torch.kernels import sparse_hvp
from repro_torch.robust import straggler
from repro_torch.robust.faults import (ChunkReadError, FaultInjector,
                                       FaultPlan)
from repro_torch.robust.retry import RetryPolicy

CSRC = os.path.join(os.path.dirname(__file__), "..", "src", "repro_torch",
                    "kernels", "csrc")
BLOCK = 8
CHUNK = 16


def _data(seed=1):
    return make_sparse_glm_data(d=96, n=160, density=0.2, alpha=1.0,
                                beta=0.5, seed=seed)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """One store per axis (written by the port; the reference reads the
    same directory)."""
    X, y, _ = _data()
    root = tmp_path_factory.mktemp("stream_stores")
    return {axis: ShardStore.from_csr(X, y, str(root / axis), axis=axis,
                                      chunk_size=CHUNK).path
            for axis in ("samples", "features")}


def _plans(path, m, strategy="lpt", **kw):
    jp = jstream.plan_streams(JShardStore(path), m, strategy,
                              block_rows=BLOCK, block_cols=BLOCK,
                              hvp_dtype=ml_dtypes.bfloat16, **kw)
    p = stream.plan_streams(ShardStore(path), m, strategy,
                            block_rows=BLOCK, block_cols=BLOCK,
                            hvp_dtype=torch.bfloat16, device="cpu", **kw)
    return jp, p


def _same(got: torch.Tensor, want: np.ndarray) -> bool:
    """Bit for bit, the dtypes included (bf16 compared as its bits)."""
    if want.dtype == ml_dtypes.bfloat16:
        return got.dtype == torch.bfloat16 and np.array_equal(
            got.view(torch.int16).numpy(), want.view(np.int16))
    return got.numpy().dtype == want.dtype and np.array_equal(
        got.numpy(), want)


# ---------------------------------------------------------------------------
# the planner and the payloads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axis", ["samples", "features"])
@pytest.mark.parametrize("m", [1, 2, 4])
@pytest.mark.parametrize("strategy", ["lpt", "width"])
def test_plan_matches_reference(stores, axis, m, strategy):
    jp, p = _plans(stores[axis], m, strategy)
    np.testing.assert_array_equal(p.schedule, jp.schedule)
    np.testing.assert_array_equal(p.partition.perm, jp.partition.perm)
    np.testing.assert_array_equal(p.partition.shard_nnz,
                                  jp.partition.shard_nnz)
    assert p.partition.stats() == jp.partition.stats()
    assert (p.w_fwd, p.w_tr) == (jp.w_fwd, jp.w_tr)
    assert (p.n_steps, p.width_local, p.axis_padded, p.other_padded) == \
        (jp.n_steps, jp.width_local, jp.axis_padded, jp.other_padded)


@pytest.mark.parametrize("axis", ["samples", "features"])
@pytest.mark.parametrize("m", [1, 2, 4])
@pytest.mark.parametrize("kind", ["fwd", "tr", "both"])
def test_payloads_match_reference(stores, axis, m, kind):
    """Every step's payload, f32 and bf16 (``hvp=True``), is the
    reference's numpy payload bit for bit, with the same byte count; the
    K1 / K6 schedules are those of each chunk's tiles."""
    jp, p = _plans(stores[axis], m)
    for t in range(p.n_steps):
        for hvp in (False, True):
            want, nb_want = jp._load_step(t, kind, hvp)
            got, nb_got = p._load_step(t, kind, hvp)
            assert nb_got == nb_want
            for k, v in want.items():
                assert _same(got[k], v), (t, hvp, k)
            for kd, kc, ks in (("data", "cols", "sched"),
                               ("dataT", "colsT", "schedT")):
                if kd in got:
                    for s in range(m):
                        ctas = sparse_hvp.default_ctas("cpu")
                        assert torch.equal(got[ks][s], sparse_hvp.ell_schedule(
                            got[kd][s], got[kc][s], ctas))


def test_payloads_without_the_plan_cache(stores, monkeypatch):
    """With no room for cached plans every chunk is planned on every pass,
    and the payloads are the same (the reference's, bit for bit)."""
    monkeypatch.setattr(stream, "PLAN_CACHE_BYTES", 0)
    jp, p = _plans(stores["samples"], 2)
    for t in range(p.n_steps):
        want, _ = jp._load_step(t, "both", True)
        got, _ = p._load_step(t, "both", True)
        for k, v in want.items():
            assert _same(got[k], v), (t, k)
    assert p._cache.plans == {} and p._cache.plan_bytes == 0


def test_plan_streams_defaults_to_the_card(stores, monkeypatch):
    """Left out, ``device`` means the card: with none present the plan
    raises rather than assemble CPU tiles for the plain versions."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        stream.plan_streams(ShardStore(stores["samples"]), 1,
                            block_rows=BLOCK, block_cols=BLOCK)
    p = stream.plan_streams(ShardStore(stores["samples"]), 1,
                            block_rows=BLOCK, block_cols=BLOCK,
                            device="cpu")
    assert p.device == torch.device("cpu")


def test_stream_pass_within_a_low_open_file_limit(tmp_path):
    """The kept memory maps are bounded (three open files a chunk): with
    the process's open-file limit lowered to what is open now plus room
    for :data:`MAP_CACHE_CHUNKS` chunks, two whole passes over a store of
    more than a third of the limit's chunks stream every step, and no
    more than ``MAP_CACHE_CHUNKS`` chunks keep their maps."""
    import resource
    keep = stream.MAP_CACHE_CHUNKS
    is_open = len(os.listdir("/proc/self/fd"))
    limit = is_open + 3 * keep + 32
    n_chunks = limit // 3 + 16
    X, y, _ = make_sparse_glm_data(d=16, n=8 * n_chunks, density=0.1,
                                   seed=3)
    store = ShardStore.from_csr(X, y, str(tmp_path / "s"), axis="samples",
                                chunk_size=8)
    assert store.n_chunks == n_chunks and 3 * n_chunks > limit
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    resource.setrlimit(resource.RLIMIT_NOFILE, (limit, hard))
    try:
        plan = stream.plan_streams(ShardStore(store.path), 1, block_rows=4,
                                   block_cols=4, device="cpu")
        for _ in range(2):
            with plan.stream("both") as pf:
                assert sum(1 for _ in pf) == plan.n_steps == n_chunks
        assert len(plan._cache.maps) == keep
    finally:
        resource.setrlimit(resource.RLIMIT_NOFILE, (soft, hard))


@pytest.mark.parametrize("axis", ["samples", "features"])
def test_fused_payload_carries_step_schedules(stores, axis):
    """A fused stream's payload adds each shard's K2 / K7 step schedule:
    the one ``ell_hvp_schedule`` builds from the chunk's tiles, at the
    HVP tiles' element size, with zeroed state."""
    _, p = _plans(stores[axis], 2)
    for t in range(p.n_steps):
        got, _ = p._load_step(t, "tr", True, fused=True)
        for s in range(2):
            want = sparse_hvp.ell_hvp_schedule(got["dataT"][s],
                                               got["colsT"][s])
            have = got["hvp_sched"][s]
            assert torch.equal(have.table, want.table)
            assert (have.nb, have.ctas, have.steps) == \
                (want.nb, want.ctas, want.steps)
            assert not have.state.any()


@pytest.mark.parametrize("axis", ["samples", "features"])
@pytest.mark.parametrize("m", [2, 4])
def test_replan_streams_matches_reference(stores, axis, m):
    jp, p = _plans(stores[axis], m)
    rng = np.random.default_rng(m)
    cost = rng.integers(1, 10**6, size=p.store.n_chunks)
    jn = jstream.replan_streams(jp, chunk_cost=cost)
    n = stream.replan_streams(p, chunk_cost=cost)
    np.testing.assert_array_equal(n.schedule, jn.schedule)
    np.testing.assert_array_equal(n.partition.perm, jn.partition.perm)
    assert n.partition.stats() == jn.partition.stats()
    assert n.stats is p.stats and (n.w_fwd, n.w_tr) == (p.w_fwd, p.w_tr)


def test_stream_pass_byte_ledger(stores):
    """A whole pass yields every step once, and the ledger holds the
    out-of-core bound: peak <= (depth + 2) x the largest step."""
    _, p = _plans(stores["samples"], 2)
    with p.stream("both", hvp=True) as pf:
        got = [pl["dataT"].dtype for pl in pf]
    assert got == [torch.bfloat16] * p.n_steps
    st_ = p.stats
    assert st_.passes == 1 and st_.steps == p.n_steps
    assert st_.live_bytes == 0
    assert st_.peak_bytes <= (p.prefetch_depth + 2) * st_.max_step_bytes
    with pytest.raises(ValueError, match="unknown stream kind"):
        p.stream("diagonal")


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_widths_sidecar_read_across_packages(tmp_path, writer):
    """The ``ell_widths.{br}x{bc}.json`` sidecar has the same name and
    keys in both packages, and each reads the other's (a planted width
    proves the cache, not a rescan, answered)."""
    X, y, _ = _data(seed=2)
    path = ShardStore.from_csr(X, y, str(tmp_path / "s"), axis="samples",
                               chunk_size=CHUNK).path
    first, second = ((stream, jstream) if writer == "port"
                     else (jstream, stream))
    store_of = {stream: ShardStore, jstream: JShardStore}
    w = first._global_ell_widths(store_of[first](path), BLOCK, BLOCK)
    side = os.path.join(path, f"ell_widths.{BLOCK}x{BLOCK}.json")
    with open(side) as f:
        cached = json.load(f)
    assert set(cached) == {"w_fwd", "w_tr", "n_chunks", "nnz"}
    assert (cached["w_fwd"], cached["w_tr"]) == w
    cached["w_fwd"] += 5
    with open(side, "w") as f:
        json.dump(cached, f)
    assert second._global_ell_widths(store_of[second](path), BLOCK,
                                     BLOCK) == (w[0] + 5, w[1])


# ---------------------------------------------------------------------------
# plan + fill against ell_from_csr
# ---------------------------------------------------------------------------

@st.composite
def _csr(draw):
    d = draw(st.integers(0, 40))
    n = draw(st.integers(1, 40))
    density = draw(st.sampled_from([0.0, 0.05, 0.3, 1.0]))
    seed = draw(st.integers(0, 2**31 - 1))
    rng = np.random.default_rng(seed)
    X = np.where(rng.random((d, n)) < density,
                 rng.standard_normal((d, n)), 0.0).astype(np.float32)
    return jsparse.CSRMatrix.from_dense(X), draw(st.integers(1, 9)), \
        draw(st.integers(1, 9)), draw(st.integers(0, 3))


@settings(max_examples=150, deadline=None)
@given(_csr())
def test_plan_and_fill_equal_ell_from_csr(case):
    """Both layouts, f32 and bf16: ``ell_fill(ell_plan(...))`` is the
    reference's ``ell_from_csr`` (and its bf16 cast) bit for bit, with
    the same column ids, and the live counts are each row-block's tiles;
    the port's ``ell_from_csr`` too. ``extra`` widens the padding."""
    X, br, bc, extra = case
    Xt = CSRMatrix(X.indptr, X.indices, X.data, X.shape)
    for transpose in (False, True):
        want = jsparse.ell_from_csr(X.transpose() if transpose else X,
                                    br, bc)
        w = want.width + extra
        want = jsparse.ell_from_csr(X.transpose() if transpose else X,
                                    br, bc, width=w)
        plan = ell_plan(Xt, br, bc, w, transpose=transpose)
        np.testing.assert_array_equal(plan.cols, want.cols)
        assert plan.shape == want.data.shape
        assert _same(ell_fill(plan, Xt.data), want.data)
        assert _same(ell_fill(plan, Xt.data, dtype=torch.bfloat16),
                     want.data.astype(ml_dtypes.bfloat16))
        nb, wd, r, c = want.data.shape
        np.testing.assert_array_equal(            # no explicit zeros here
            plan.per_block,
            (want.data.reshape(nb, wd, r * c) != 0).any(axis=2).sum(axis=1))
        if not transpose:
            got = ell_from_csr(Xt, br, bc, width=w)
            assert _same(torch.from_numpy(got.data), want.data)
            np.testing.assert_array_equal(got.cols, want.cols)


def test_plan_refuses_a_narrow_width():
    X, _, _ = _data()
    natural = ell_plan(X, BLOCK, BLOCK).shape[1]
    with pytest.raises(ValueError, match="natural max width"):
        ell_plan(X, BLOCK, BLOCK, natural - 1)


def test_plan_bitmap_and_sort_paths_agree(monkeypatch):
    """The tile-id bitmap and the sort of the tile ids give one plan."""
    from repro_torch.data import sparse
    X, _, _ = _data(seed=3)
    a = ell_plan(X, BLOCK, 4, transpose=True)
    monkeypatch.setattr(sparse, "_BITMAP_EXTRA", -10**9)
    b = ell_plan(X, BLOCK, 4, transpose=True)
    for f in ("cols", "per_block", "offsets"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


# ---------------------------------------------------------------------------
# the fused kernels' fit rule
# ---------------------------------------------------------------------------

def _header_int(name, fname):
    with open(os.path.join(CSRC, fname)) as f:
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             f.read()).group(1))


def test_fit_rule_mirrors_the_launch():
    """The constants of the rule are the header's, and the rule takes the
    tile shapes the solver uses, refuses more columns than one launch
    takes, and refuses a tile too tall for the fixed shared memory."""
    assert sparse_hvp._KTHREADS == _header_int("kThreads", "ell_tiles.cuh")
    assert sparse_hvp._KBARRIER_BYTES == _header_int("kBarrierBytes",
                                                     "ell_tiles.cuh")
    from repro_torch.kernels import build, glm_hvp
    assert sparse_hvp.SMEM_OPTIN == glm_hvp.SMEM_LIMIT
    for dt in (torch.float32, torch.bfloat16):
        for blk in (8, 16, 128):
            for s in range(1, build.MAX_COLS + 1):
                assert sparse_hvp.ell_hvp_fits(blk, blk, s, dt)
        assert not sparse_hvp.ell_hvp_fits(128, 128, build.MAX_COLS + 1, dt)
        assert not sparse_hvp.ell_hvp_fits(128, 8192, 8, dt)
    with pytest.raises(ValueError):
        sparse_hvp.ell_hvp_fits(8, 8, 1, torch.float64)


def test_plan_fused_rule_uses_the_plan_geometry(stores):
    _, p = _plans(stores["samples"], 1)
    assert p.fused_hvp_fits(p.other_padded, s=1)
    assert not p.fused_hvp_fits(p.other_padded, s=9)


# ---------------------------------------------------------------------------
# the prefetcher (counterparts of tests/test_robust.py)
# ---------------------------------------------------------------------------

def _prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name == "repro-chunk-prefetch" and t.is_alive()]


def test_prefetcher_close_releases_abandoned_pass():
    pf = stream.ChunkPrefetcher(lambda t: (t, 10), n_steps=200, depth=1)
    it = iter(pf)
    assert next(it) == 0
    assert len(_prefetch_threads()) >= 1     # producer parked on the queue
    pf.close()
    assert _prefetch_threads() == []
    assert pf.stats.live_bytes == 0          # close() released the pass
    del it
    assert list(pf) == list(range(200))
    assert _prefetch_threads() == []
    assert pf.stats.live_bytes == 0


def test_prefetcher_hands_off_every_payload():
    """``on_take`` sees each payload once, in order; ``on_release`` lets
    go of every payload made, taken or not (here a pass abandoned after
    three)."""
    taken, released = [], []
    pf = stream.ChunkPrefetcher(lambda t: (t, 1), n_steps=50, depth=2,
                                on_take=taken.append,
                                on_release=released.append)
    with pf:
        for t in pf:
            if t == 2:
                break
    assert taken == [0, 1, 2]
    assert sorted(released) == list(range(len(released)))
    assert set(taken) <= set(released) and len(released) >= 3
    assert pf.stats.live_bytes == 0


def test_prefetcher_context_manager_closes(tmp_path):
    X, y, _ = make_sparse_glm_data(d=64, n=48, density=0.15, seed=1)
    store = ShardStore.from_csr(X, y, str(tmp_path / "s"), axis="features",
                                chunk_size=8)
    plan = stream.plan_streams(store, m=4, block_rows=4, block_cols=4,
                               device="cpu")
    with plan.stream("fwd") as pf:
        for _ in pf:
            break
    assert _prefetch_threads() == []
    assert plan.stats.live_bytes == 0


def test_prefetcher_retries_transient_loads():
    inj = FaultInjector(FaultPlan(fail_chunks=frozenset({1, 3}),
                                  read_error_attempts=1),
                        sleep=lambda s: None)

    def load(t):
        inj.on_chunk_read(t)
        return t, 1

    policy = RetryPolicy(max_retries=2, backoff_s=0.0, sleep=lambda s: None)
    got = list(stream.ChunkPrefetcher(load, n_steps=5, depth=2,
                                      retry=policy))
    assert got == list(range(5))
    assert inj.faults_injected == 2
    inj2 = FaultInjector(FaultPlan(fail_chunks=frozenset({1}),
                                   read_error_attempts=1),
                         sleep=lambda s: None)

    def load2(t):
        inj2.on_chunk_read(t)
        return t, 1

    with pytest.raises(ChunkReadError):
        list(stream.ChunkPrefetcher(load2, n_steps=5, depth=2))


def test_plan_reads_through_faults_and_ledger(stores):
    """A plan's chunk reads pass the fault injector (retried) and feed the
    timing ledger, once per real chunk a pass."""
    ledger = straggler.ChunkTimingLedger(ShardStore(stores["samples"])
                                         .n_chunks)
    inj = FaultInjector(FaultPlan(fail_chunks=frozenset({0, 4}),
                                  read_error_attempts=1),
                        sleep=lambda s: None)
    p = stream.plan_streams(
        ShardStore(stores["samples"]), 2, block_rows=BLOCK,
        block_cols=BLOCK, device="cpu", timing_ledger=ledger,
        fault_injector=inj,
        retry=RetryPolicy(max_retries=2, backoff_s=0.0,
                          sleep=lambda s: None))
    with p.stream("fwd") as pf:
        assert sum(1 for _ in pf) == p.n_steps
    assert inj.faults_injected == 2 and ledger.complete()


# ---------------------------------------------------------------------------
# the timing ledger and the re-planner
# ---------------------------------------------------------------------------

def test_barrier_seconds_hand_case():
    sched = np.array([[0, 1], [2, -1]])
    cs = np.array([1.0, 2.0, 5.0])
    assert straggler.barrier_seconds(sched, cs) == pytest.approx(7.0)
    assert straggler.barrier_seconds(sched, cs) == \
        jstraggler.barrier_seconds(sched, cs)


def test_timing_ledger_ewma_and_median_fill():
    led = straggler.ChunkTimingLedger(4, alpha=0.5)
    jled = jstraggler.ChunkTimingLedger(4, alpha=0.5)
    for cid, sec in ((0, 1.0), (0, 3.0), (1, 8.0)):
        led.observe(cid, sec)
        jled.observe(cid, sec)
    assert led.n_observed == 2 and not led.complete()
    cs = led.chunk_seconds()
    assert cs[0] == pytest.approx(2.0) and cs[1] == pytest.approx(8.0)
    assert cs[2] == cs[3] == pytest.approx(5.0)
    np.testing.assert_array_equal(cs, jled.chunk_seconds())
    sched = np.array([[0, 1], [2, 3]])
    assert led.observed_straggler(sched) == pytest.approx(1.0)
    np.testing.assert_array_equal(led.shard_seconds(sched),
                                  jled.shard_seconds(sched))
    led.observe(9, 1.0)                       # out of range: ignored
    assert led.n_observed == 2
    led.reset()
    assert led.n_observed == 0


def _plan_with_ledger(tmp_path, m=4, chunk=8):
    X, y, _ = make_sparse_glm_data(d=128, n=48, density=0.15, alpha=1.2,
                                   seed=2)
    store = ShardStore.from_csr(X, y, str(tmp_path / "s"), axis="features",
                                chunk_size=chunk)
    jplan = jstream.plan_streams(JShardStore(store.path), m=m, block_rows=4,
                                 block_cols=4)
    return stream.plan_streams(store, m=m, block_rows=4, block_cols=4,
                               device="cpu"), \
        jplan, store


def test_replanner_fires_moves_chunks_and_cools_down(tmp_path):
    plan, jplan, store = _plan_with_ledger(tmp_path)
    led = straggler.ChunkTimingLedger(store.n_chunks)
    jled = jstraggler.ChunkTimingLedger(store.n_chunks)
    slow = set(int(c) for c in plan.schedule[0] if c >= 0)
    for cid in range(store.n_chunks):
        led.observe(cid, 0.10 if cid in slow else 0.01)
        jled.observe(cid, 0.10 if cid in slow else 0.01)
    rp = straggler.ElasticReplanner(led, threshold=1.5, min_gain=1.05)
    out = rp.maybe_replan(plan, outer_iter=3, trigger="pcg")
    assert out is not None
    new_plan, event = out
    assert event.moved_chunks > 0
    assert event.outer_iter == 3 and event.trigger == "pcg"
    assert event.observed_straggler >= 1.5
    assert event.barrier_s_after < event.barrier_s_before
    assert event.planned_straggler < event.observed_straggler
    real = new_plan.schedule[new_plan.schedule >= 0]
    np.testing.assert_array_equal(np.sort(real), np.arange(store.n_chunks))
    assert new_plan.partition.shard_nnz.sum() == store.nnz
    assert rp.maybe_replan(new_plan) is None
    assert rp.events == [event]
    # the reference's re-planner on the same observations: the same plan
    # and the same event
    jnew, jevent = jstraggler.ElasticReplanner(
        jled, threshold=1.5, min_gain=1.05).maybe_replan(
            jplan, outer_iter=3, trigger="pcg")
    np.testing.assert_array_equal(new_plan.schedule, jnew.schedule)
    assert event.to_dict() == jevent.to_dict()


def test_replanner_quiet_below_threshold(tmp_path):
    plan, _, store = _plan_with_ledger(tmp_path)
    led = straggler.ChunkTimingLedger(store.n_chunks)
    for cid in range(store.n_chunks):
        led.observe(cid, 0.01)
    assert straggler.ElasticReplanner(led, threshold=1.5).maybe_replan(
        plan) is None
    led2 = straggler.ChunkTimingLedger(store.n_chunks)
    led2.observe(0, 10.0)
    assert straggler.ElasticReplanner(led2, threshold=1.0).maybe_replan(
        plan) is None


def test_replan_aligns_expensive_chunks(tmp_path):
    plan, jplan, store = _plan_with_ledger(tmp_path)
    cs = np.full(store.n_chunks, 0.01)
    cs[[int(c) for c in plan.schedule[0] if c >= 0]] = 0.06
    cost = (cs * 1e9).astype(np.int64)
    new = stream.replan_streams(plan, chunk_cost=cost)
    for s in range(new.m):
        row = [c for c in new.schedule[s] if c >= 0]
        assert list(cs[row]) == sorted(cs[row], reverse=True)
    before = straggler.barrier_seconds(plan.schedule, cs)
    after = straggler.barrier_seconds(new.schedule, cs)
    assert before / after >= 2.0
    np.testing.assert_array_equal(
        new.schedule, jstream.replan_streams(jplan, chunk_cost=cost).schedule)


def test_replan_instant_is_traced(tmp_path):
    from repro_torch import obs
    plan, _, store = _plan_with_ledger(tmp_path)
    led = straggler.ChunkTimingLedger(store.n_chunks)
    slow = set(int(c) for c in plan.schedule[0] if c >= 0)
    for cid in range(store.n_chunks):
        led.observe(cid, 0.10 if cid in slow else 0.01)
    tracer = obs.enable(reset=True)
    try:
        assert straggler.ElasticReplanner(led).maybe_replan(plan) is not None
        assert tracer.span_count("robust.replan") == 1
    finally:
        obs.disable()


@pytest.mark.parametrize("overhead", [0.0, 0.05, 10.0])
@pytest.mark.parametrize("passes", [1, 7])
def test_elastic_replan_model_matches_reference(tmp_path, overhead, passes):
    plan, _, store = _plan_with_ledger(tmp_path)
    rng = np.random.default_rng(passes)
    cs = rng.uniform(0.001, 0.1, store.n_chunks)
    new = stream.replan_streams(plan, chunk_cost=(cs * 1e9).astype(np.int64))
    for before, after in ((plan.schedule, new.schedule),
                          (new.schedule, plan.schedule),
                          (plan.schedule, plan.schedule)):
        got = comm.elastic_replan_model(cs, before, after, passes, overhead)
        assert got == jcomm.elastic_replan_model(cs, before, after, passes,
                                                 overhead)
