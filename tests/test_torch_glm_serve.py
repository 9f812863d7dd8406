"""The port's GLM serving plane (``repro_torch.glm_serve``) and the
repaired ``GLMProblem`` inference API against the JAX package's, on the
same numpy inputs; plus the public-surface holes of ROADMAP Queue 1 item 6.

Tolerances: packs, registry round trips and the cost models exactly;
scores against the reference's f32 engine (``REPRO_KERNEL_MODE=ref``)
within rtol 1e-6 / atol 1e-6 (the same f32 products summed in another
order); at bf16 against the reference's engine in interpret mode, whose
kernel rounds ``w`` to bf16 as the port's plain K1 does (ROADMAP F10), at
the same limit; scheduler runs under one fake clock equal in every field;
``refit_path`` within rtol 1e-4 / atol 1e-6 of the reference (as
``tests/test_torch_disco.py``); the streamed refit (the reference's
streamed solve fails on this JAX, ROADMAP F0) against the port's in-memory
solve of the grown CSR whose shards are the store's chunks, bit for bit,
and the in-memory one-shard solve within relative L2 1e-5 (the chunk
sums' order alone), as ``tests/test_torch_streaming.py`` holds the
streamed solve.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro import glm_serve as jserve
from repro import obs as jobs
from repro.core import DiscoConfig as JDiscoConfig
from repro.core import GLMProblem as JGLMProblem
from repro.core import comm as jcomm
from repro.core.disco import DiscoResult as JDiscoResult
from repro.data.sparse import make_sparse_glm_data
from repro.data.store import ShardStore as JShardStore
from repro_torch import (CSRMatrix, DiscoConfig, DiscoSolver, GLMProblem,
                         InProcessGroup, obs)
from repro_torch import glm_serve as serve
from repro_torch.core import comm
from repro_torch.core.disco import DiscoResult
from repro_torch.data.store import ShardStore
from repro_torch.glm_serve import (MicroBatchScheduler, ModelRegistry,
                                   RefitLoop, RequestPacker, ScoreRequest,
                                   ScoringEngine, oracle_margins)
from repro_torch.robust import FaultInjector, FaultPlan, SimulatedCrash

TOL = dict(rtol=1e-6, atol=1e-6)
RTOL, ATOL = 1e-4, 1e-6


@pytest.fixture()
def ref_mode(monkeypatch):
    monkeypatch.setenv("REPRO_KERNEL_MODE", "ref")


@pytest.fixture(autouse=True)
def _obs_clean():
    obs.disable()
    jobs.disable()
    yield
    obs.disable()
    jobs.disable()


def _sparse_problem(d=48, n=160, seed=0):
    X, y, _ = make_sparse_glm_data(d=d, n=n, density=0.15, alpha=1.0,
                                   beta=0.5, seed=seed)
    return X, y


def _port_csr(X):
    return CSRMatrix(X.indptr, X.indices, X.data, X.shape)


def _pairs(requests):
    """The same requests for both packages."""
    return ([ScoreRequest(r.indices, r.values) for r in requests],
            [jserve.ScoreRequest(r.indices, r.values) for r in requests])


def _random_requests(rng, d, k, density=0.2):
    out = []
    for _ in range(k):
        nnz = rng.binomial(d, density)
        idx = rng.choice(d, size=nnz, replace=False).astype(np.int64)
        out.append(ScoreRequest(idx, rng.standard_normal(nnz)
                                .astype(np.float32)))
    return out


# ---------------------------------------------------------------------------
# the repaired GLMProblem inference API (the reference's TestGLMPredict)
# ---------------------------------------------------------------------------

class TestGLMPredict:
    def _fit(self, loss="logistic"):
        X, y = _sparse_problem()
        Xd = X.todense()
        yy = y if loss != "quadratic" else Xd.T @ np.ones(Xd.shape[0])
        w = np.linalg.lstsq(Xd.T, yy, rcond=None)[0].astype(np.float32)
        prob = GLMProblem.create(Xd, yy, loss=loss, lam=1e-2, device="cpu")
        jprob = JGLMProblem.create(Xd, yy, loss=loss, lam=1e-2)
        return prob, jprob, X, _port_csr(X), Xd, w

    def test_decision_function_dense_sparse_parity(self):
        prob, jprob, X, Xp, Xd, w = self._fit()
        a_dense = prob.decision_function(w)
        a_dense2 = prob.decision_function(w, Xd)
        a_sparse = prob.decision_function(w, Xp)        # stays sparse
        assert isinstance(a_sparse, torch.Tensor)
        np.testing.assert_allclose(a_dense, a_dense2, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(a_dense.numpy(), a_sparse.numpy(),
                                   rtol=1e-5, atol=1e-5)
        # the CSR margins are the reference's, bit for bit (one f64 pass)
        assert np.array_equal(a_sparse.numpy(),
                              jprob.decision_function(w, X))
        np.testing.assert_allclose(
            a_dense.numpy(), np.asarray(jprob.decision_function(w)),
            rtol=1e-5, atol=1e-5)

    def test_predict_signs_and_proba(self):
        prob, jprob, X, Xp, Xd, w = self._fit()
        a = prob.decision_function(w, Xp).numpy()
        pred = prob.predict(w, Xp).numpy()
        assert set(np.unique(pred)).issubset({-1.0, 1.0})
        np.testing.assert_array_equal(pred, np.where(a >= 0, 1.0, -1.0))
        np.testing.assert_array_equal(pred, jprob.predict(w, X))
        p = prob.predict_proba(w, Xp).numpy()
        assert p.dtype == np.float32
        assert np.all((p >= 0) & (p <= 1))
        np.testing.assert_allclose(p, jprob.predict_proba(w, X),
                                   rtol=1e-6, atol=0)
        np.testing.assert_array_equal(np.where(p >= 0.5, 1.0, -1.0), pred)
        # dense input: the same probabilities on the problem's device
        np.testing.assert_allclose(prob.predict_proba(w, Xd).numpy(), p,
                                   rtol=1e-5, atol=1e-6)

    def test_quadratic_predicts_margin_and_proba_raises(self):
        prob, jprob, X, Xp, Xd, w = self._fit(loss="quadratic")
        np.testing.assert_array_equal(prob.predict(w, Xp),
                                      prob.decision_function(w, Xp))
        np.testing.assert_array_equal(prob.predict(w, Xp).numpy(),
                                      jprob.predict(w, X))
        with pytest.raises(ValueError, match="logistic"):
            prob.predict_proba(w, Xp)


# ---------------------------------------------------------------------------
# the serving cost models, exactly
# ---------------------------------------------------------------------------

COST_CASES = [
    (1, 5.0, dict(ell_width=1, block_b=8, block_d=128)),
    (64, 76.0, dict(ell_width=370, block_b=8, block_d=128)),
    (7, 12.5, dict(ell_width=3, block_b=2, block_d=8, dispatch_s=1e-5,
                   flops_per_sec=1e12, bytes_per_sec=3e11)),
    (1024, 0.0, dict(ell_width=16, block_b=8, block_d=32)),
]


@pytest.mark.parametrize("batch,nnz,kw", COST_CASES)
def test_serving_cost_models_equal_reference(batch, nnz, kw):
    assert comm.scoring_flops(int(batch * nnz)) == \
        jcomm.scoring_flops(int(batch * nnz))
    assert comm.glm_serving_tick_time(batch, nnz, **kw) == \
        jcomm.glm_serving_tick_time(batch, nnz, **kw)
    assert comm.glm_serving_throughput(batch, nnz, **kw) == \
        jcomm.glm_serving_throughput(batch, nnz, **kw)


# ---------------------------------------------------------------------------
# model registry
# ---------------------------------------------------------------------------

def _fake_result(d=16, seed=0, cls=DiscoResult, ledger=comm.CommLedger):
    rng = np.random.default_rng(seed)
    return cls(
        w=rng.standard_normal(d).astype(np.float32),
        history=[dict(grad_norm=0.5, f=1.0, pcg_iters=3.0, delta=0.1,
                      pcg_r_norm=1e-3, outer_iter=0, comm_rounds_cum=8,
                      comm_floats_cum=128.0)],
        ledger=ledger(rounds=8, floats=128, spmd_collectives=4),
        converged=True,
        partition_info=dict(strategy="lpt", m=2, imbalance=1.25),
        stream_stats=None)


def _same_result(got, want):
    assert got.w.tobytes() == want.w.tobytes() and got.w.dtype == want.w.dtype
    assert got.converged == want.converged
    assert got.history == want.history
    assert dataclasses.asdict(got.ledger) == dataclasses.asdict(want.ledger)
    assert got.partition_info == want.partition_info
    assert got.stream_stats == want.stream_stats
    assert list(got.replan_events) == list(want.replan_events)


class TestRegistry:
    def test_publish_load_roundtrip_exact(self, tmp_path):
        reg = ModelRegistry(str(tmp_path / "reg"))
        cfg = DiscoConfig(partition="samples", lam=3e-3, pcg_block_s=2)
        res = _fake_result()
        v = reg.publish(res, cfg)
        assert v == 1 and reg.active_version() == 1
        pub = reg.load()
        assert pub.cfg == cfg and pub.d == 16 and pub.version == 1
        _same_result(pub.result, res)
        assert pub.w.tobytes() == res.w.tobytes()

    def test_versions_monotone_and_activate(self, tmp_path):
        reg = ModelRegistry(str(tmp_path / "reg"))
        cfg = DiscoConfig()
        v1 = reg.publish(_fake_result(seed=1), cfg)
        v2 = reg.publish(_fake_result(seed=2), cfg)
        v3 = reg.publish(_fake_result(seed=3), cfg, activate=False)
        assert (v1, v2, v3) == (1, 2, 3)
        assert reg.versions() == [1, 2, 3]
        assert reg.active_version() == 2
        reg.activate(3)
        assert reg.active_version() == 3
        assert not np.array_equal(reg.load(1).w, reg.load(3).w)
        with pytest.raises(ValueError, match="no published version"):
            reg.activate(99)

    def test_load_empty_registry_raises(self, tmp_path):
        reg = ModelRegistry(str(tmp_path / "reg"))
        assert reg.active_version() is None
        with pytest.raises(ValueError, match="no active version"):
            reg.load()

    def test_format_version_check(self, tmp_path):
        reg = ModelRegistry(str(tmp_path / "reg"))
        reg.publish(_fake_result(), DiscoConfig())
        mpath = tmp_path / "reg" / "versions" / "v000001" / "model.json"
        header = json.loads(mpath.read_text())
        header["format_version"] = 999
        mpath.write_text(json.dumps(header))
        with pytest.raises(ValueError, match="format"):
            reg.load(1)
        # the reference's reader refuses it with the same words
        with pytest.raises(ValueError, match="format"):
            jserve.ModelRegistry(str(tmp_path / "reg")).load(1)

    def test_no_stale_staging_dirs(self, tmp_path):
        reg = ModelRegistry(str(tmp_path / "reg"))
        reg.publish(_fake_result(), DiscoConfig())
        names = os.listdir(tmp_path / "reg" / "versions")
        assert names == ["v000001"]

    def test_port_published_loads_in_reference(self, tmp_path):
        cfg = DiscoConfig(partition="samples", lam=3e-3, hvp_dtype="bfloat16")
        res = _fake_result(d=24, seed=4)
        res.replan_events.append(dict(outer_iter=1, gain=1.5))
        ModelRegistry(str(tmp_path / "reg")).publish(res, cfg)
        pub = jserve.ModelRegistry(str(tmp_path / "reg")).load()
        assert pub.version == 1
        assert dataclasses.asdict(pub.cfg) == dataclasses.asdict(cfg)
        _same_result(pub.result, res)

    def test_reference_published_loads_in_port(self, tmp_path):
        cfg = JDiscoConfig(partition="features", lam=2e-2, pcg_block_s=3)
        res = _fake_result(d=24, seed=5, cls=JDiscoResult,
                           ledger=jcomm.CommLedger)
        jreg = jserve.ModelRegistry(str(tmp_path / "reg"))
        jreg.publish(res, cfg)
        jreg.publish(_fake_result(d=24, seed=6, cls=JDiscoResult,
                                  ledger=jcomm.CommLedger), cfg,
                     activate=False)
        reg = ModelRegistry(str(tmp_path / "reg"))
        assert reg.versions() == [1, 2] and reg.active_version() == 1
        pub = reg.load()
        assert dataclasses.asdict(pub.cfg) == dataclasses.asdict(cfg)
        _same_result(pub.result, res)
        # and the port goes on from the reference's versions
        assert reg.publish(pub.result, pub.cfg) == 3
        assert jreg.active_version() == 3


def _registry_fixture(tmp_path, fault_injector=None):
    result = DiscoResult(w=np.arange(6, dtype=np.float32),
                         history=[{"grad_norm": 0.1}],
                         ledger=comm.CommLedger(rounds=3, floats=30,
                                                spmd_collectives=3),
                         converged=True)
    reg = ModelRegistry(str(tmp_path / "reg"),
                        fault_injector=fault_injector)
    return reg, result, DiscoConfig(lam=0.01)


def _crash(name):
    return FaultInjector(FaultPlan(crash_at=frozenset({name})))


def test_registry_crash_before_publish_rename(tmp_path):
    reg, result, cfg = _registry_fixture(tmp_path, _crash("publish:staged"))
    with pytest.raises(SimulatedCrash):
        reg.publish(result, cfg)
    assert reg.versions() == [] and reg.active_version() is None
    reg2 = ModelRegistry(reg.path)
    v = reg2.publish(result, cfg)           # over the stage's debris
    assert reg2.versions() == [v] and reg2.active_version() == v
    np.testing.assert_array_equal(reg2.load().w, result.w)
    assert os.listdir(os.path.join(reg.path, "versions")) == ["v000001"]


def test_registry_crash_between_rename_and_activate(tmp_path):
    reg, result, cfg = _registry_fixture(tmp_path)
    v1 = reg.publish(result, cfg)
    reg_f = ModelRegistry(reg.path, fault_injector=_crash("publish:renamed"))
    with pytest.raises(SimulatedCrash):
        reg_f.publish(result, cfg)
    reg3 = ModelRegistry(reg.path)
    assert reg3.versions() == [v1, v1 + 1]
    assert reg3.active_version() == v1
    reg3.activate(v1 + 1)
    assert reg3.active_version() == v1 + 1


def test_registry_crash_before_activate_replace(tmp_path):
    reg, result, cfg = _registry_fixture(tmp_path)
    v1 = reg.publish(result, cfg)
    v2 = reg.publish(result, cfg, activate=False)
    reg_f = ModelRegistry(reg.path, fault_injector=_crash("activate:staged"))
    with pytest.raises(SimulatedCrash):
        reg_f.activate(v2)
    assert ModelRegistry(reg.path).active_version() == v1
    reg.activate(v2)
    assert reg.active_version() == v2


# ---------------------------------------------------------------------------
# request packer: the reference's tiles bit for bit
# ---------------------------------------------------------------------------

def _bits(a) -> bytes:
    """Tile bytes widened to f32 (bf16 -> f32 is exact)."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy().tobytes()
    return np.asarray(a).astype(np.float32).tobytes()


@pytest.mark.parametrize("tiles", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_req", [0, 1, 7, 16])
def test_pack_equals_reference_bit_for_bit(tiles, n_req):
    from repro.data.sparse import hvp_tile_dtype as j_tile_dtype
    from repro_torch.data.sparse import hvp_tile_dtype
    rng = np.random.default_rng(n_req)
    d = 300
    reqs = _random_requests(rng, d, n_req, density=0.05)
    if n_req:
        reqs[0] = ScoreRequest(np.zeros(0, np.int64), np.zeros(0, np.float32))
    # f64 values: both packages cast to the packer's f32 first
    reqs = [ScoreRequest(r.indices[::-1], r.values.astype(np.float64) / 3)
            for r in reqs]
    p = RequestPacker(d, 16, block_b=4, block_d=32,
                      tile_dtype=hvp_tile_dtype(tiles), device="cpu")
    jp = jserve.RequestPacker(d, 16, block_b=4, block_d=32,
                              tile_dtype=j_tile_dtype(tiles))
    ours, theirs = _pairs(reqs)
    data, cols = p.pack(ours)
    jdata, jcols = jp.pack(theirs)
    assert tuple(data.shape) == jdata.shape == (4, 10, 4, 32)
    assert data.dtype == hvp_tile_dtype(tiles) and cols.dtype == torch.int32
    assert _bits(data) == _bits(jdata)
    assert np.array_equal(cols.numpy(), np.asarray(jcols))
    if n_req == 0:
        assert not data.any()
    np.testing.assert_array_equal(p.pad_weights(np.ones(d, np.float32))
                                  .numpy(), jp.pad_weights(np.ones(d)))


def test_pack_narrow_width_and_bad_requests_as_reference():
    p = RequestPacker(d=16, batch=2, block_b=2, block_d=8, width=1,
                      device="cpu")
    jp = jserve.RequestPacker(d=16, batch=2, block_b=2, block_d=8, width=1)
    bad = [
        [ScoreRequest(np.array([0, 15]), np.ones(2, np.float32))],  # width
        [ScoreRequest(np.array([16]), np.array([1.0]))],
        [ScoreRequest(np.array([-1]), np.array([1.0]))],
        [ScoreRequest(np.array([0]), np.array([1.0]))] * 3,
        [ScoreRequest(np.array([3, 3]), np.array([1.0, 2.0], np.float32))],
        [ScoreRequest(np.array([1, 2]), np.array([1.0], np.float32))],
        [ScoreRequest(np.array([1]), np.array([1.0])),
         ScoreRequest(np.array([4, 4]), np.array([1.0, 2.0]))],
    ]
    for reqs in bad:
        with pytest.raises(ValueError) as ours:
            p.pack(reqs)
        with pytest.raises(ValueError) as theirs:
            jp.pack(_pairs(reqs)[1])
        if "width" in str(theirs.value):
            assert "width" in str(ours.value)
        else:
            assert str(ours.value) == str(theirs.value)
    for width in (0, 3):
        with pytest.raises(ValueError) as ours:
            RequestPacker(d=16, batch=2, width=width, device="cpu")
        with pytest.raises(ValueError) as theirs:
            jserve.RequestPacker(d=16, batch=2, width=width)
        assert str(ours.value) == str(theirs.value)


def test_pack_shapes_static_and_schedule_from_plan():
    from repro_torch.kernels.sparse_hvp import ell_schedule
    p = RequestPacker(d=40, batch=6, block_b=4, block_d=16, device="cpu")
    batches = [[], [ScoreRequest(np.array([0]), np.array([1.0]))],
               [ScoreRequest(np.array([], np.int64),
                             np.array([], np.float32))] * 6,
               [ScoreRequest(np.arange(40), np.ones(40, np.float32))] * 3]
    shapes = set()
    for reqs in batches:
        data, cols, sched = p.pack_scheduled(reqs)
        shapes.add((tuple(data.shape), tuple(cols.shape)))
        # the plan's schedule is the one a read of the tiles gives
        assert torch.equal(sched, ell_schedule(data, cols, p.ctas))
    assert shapes == {((2, 3, 4, 16), (2, 3))}


def test_property_packer_matches_oracle():
    """Packed scoring equals the NumPy oracle across request sparsity
    (empty requests included), batch fill, tile geometry and widths."""
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=40, deadline=None)
    @given(d=st.integers(1, 40), batch=st.integers(1, 9),
           block_b=st.integers(1, 4), block_d=st.integers(1, 12),
           n_reqs=st.integers(0, 9), density=st.floats(0.0, 1.0),
           seed=st.integers(0, 2 ** 16))
    def check(d, batch, block_b, block_d, n_reqs, density, seed):
        rng = np.random.default_rng(seed)
        reqs = _random_requests(rng, d, min(n_reqs, batch), density)
        w = rng.standard_normal(d).astype(np.float32)
        eng = ScoringEngine(w, loss="logistic", batch=batch,
                            block_b=block_b, block_d=block_d, device="cpu")
        np.testing.assert_allclose(eng.score(reqs), oracle_margins(reqs, w),
                                   rtol=1e-4, atol=1e-5)

    check()


# ---------------------------------------------------------------------------
# scoring engine
# ---------------------------------------------------------------------------

def _cols_as_requests(X, cols):
    Xd = X.todense()
    return [ScoreRequest.from_dense(Xd[:, j]) for j in cols]


def test_score_matches_reference_f32(ref_mode):
    X, _ = _sparse_problem()
    w = np.random.default_rng(1).standard_normal(X.shape[0]) \
        .astype(np.float32)
    reqs = _cols_as_requests(X, range(19))   # two full packs and a tail
    ours, theirs = _pairs(reqs)
    kw = dict(batch=8, block_b=4, block_d=16)
    eng = ScoringEngine(w, loss="logistic", device="cpu", **kw)
    jeng = jserve.ScoringEngine(w, loss="logistic", **kw)
    got = eng.score(ours)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, jeng.score(theirs), **TOL)
    np.testing.assert_allclose(got, oracle_margins(ours, w), **TOL)
    np.testing.assert_array_equal(eng.predict(ours), jeng.predict(theirs))
    np.testing.assert_allclose(eng.predict_proba(ours),
                               jeng.predict_proba(theirs), **TOL)
    # and GLMProblem's on the requests' CSR (samples as columns)
    Xr = CSRMatrix.from_dense(X.todense()[:, :19])
    prob = GLMProblem.create(X.todense(), np.ones(X.shape[1]), device="cpu")
    np.testing.assert_array_equal(eng.predict(ours),
                                  prob.predict(w, Xr).numpy())
    np.testing.assert_allclose(eng.predict_proba(ours),
                               prob.predict_proba(w, Xr).numpy(), **TOL)
    with pytest.raises(ValueError, match="logistic"):
        ScoringEngine(w, loss="quadratic", device="cpu").predict_proba(ours)


def test_score_matches_reference_bf16_interpret(monkeypatch):
    """At bf16 tiles the port's plain K1 rounds ``w`` to bf16 as the
    reference's kernel does in interpret mode (F10); its ref-mode oracle
    does not."""
    monkeypatch.setenv("REPRO_KERNEL_MODE", "interpret")
    rng = np.random.default_rng(2)
    d = 40
    w = rng.standard_normal(d).astype(np.float32)
    reqs = _random_requests(rng, d, 11, density=0.3)
    ours, theirs = _pairs(reqs)
    kw = dict(batch=8, block_b=4, block_d=16, hvp_dtype="bfloat16")
    got = ScoringEngine(w, loss="logistic", device="cpu", **kw).score(ours)
    want = jserve.ScoringEngine(w, loss="logistic", **kw).score(theirs)
    np.testing.assert_allclose(got, want, **TOL)
    assert np.abs(got - oracle_margins(ours, w)).max() <= 2e-2


def test_engine_needs_a_card_without_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ScoringEngine(np.ones(4, np.float32), loss="logistic")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RequestPacker(4, 2)
    with pytest.raises(ValueError, match="loss"):
        ScoringEngine(np.ones(4, np.float32), device="cpu")


def test_registry_hot_swap_rebuilds_on_new_dimension(tmp_path, ref_mode):
    reg = ModelRegistry(str(tmp_path / "reg"))
    cfg = DiscoConfig(loss="logistic")
    reg.publish(_fake_result(d=24, seed=1), cfg)
    eng = ScoringEngine(reg, batch=4, block_b=2, block_d=8, device="cpu")
    assert eng.version == 1 and not eng.maybe_reload()
    r = ScoreRequest(np.array([0, 5]), np.array([1.0, 2.0], np.float32))
    m1 = eng.score([r])[0]
    res2 = _fake_result(d=40, seed=2)
    reg.publish(res2, cfg)
    assert eng.maybe_reload() and eng.version == 2 and eng.reloads == 1
    assert eng.packer.d == 40 and eng.packer.d_padded == 40
    m2 = eng.score([r])[0]
    assert m1 != m2
    np.testing.assert_allclose(m2, oracle_margins([r], res2.w)[0], **TOL)


# ---------------------------------------------------------------------------
# micro-batching scheduler, both packages under one fake clock
# ---------------------------------------------------------------------------

def _script(pkg, reg_path, reqs, deadlines):
    """One scheduler run: publish v1, submit, tick, publish v2 mid-stream,
    tick to the end; the clock advances 1 ms a reading."""
    t = [0.0]

    def clock():
        t[0] += 1e-3
        return t[0]
    reg = pkg.ModelRegistry(reg_path)
    kw = dict(batch=4, block_b=2, block_d=8)
    eng = (pkg.ScoringEngine(reg, device="cpu", **kw) if pkg is serve
           else pkg.ScoringEngine(reg, **kw))
    sched = pkg.MicroBatchScheduler(eng, clock=clock)
    rids = [sched.submit(r, deadline_s=dl)
            for r, dl in zip(reqs[:9], deadlines[:9])]
    sched.tick()
    sched.tick()
    return reg, eng, sched, rids


def _results(sched, rids):
    return [(c.margin, c.latency_s, c.tick, c.rejected)
            for c in (sched.finished[r] for r in rids)]


def test_scheduler_matches_reference_under_fake_clock(tmp_path, ref_mode):
    rng = np.random.default_rng(3)
    d = 24
    reqs = _random_requests(rng, d, 14, density=0.3)
    deadlines = [None, 1e-3, 0.5, None, 0.0, 1.0, None, 2e-3, None,
                 None, 0.0, 5e-3, None, None]
    runs = {}
    for name, pkg, res_cls, led in (
            ("port", serve, DiscoResult, comm.CommLedger),
            ("ref", jserve, JDiscoResult, jcomm.CommLedger)):
        path = str(tmp_path / name)
        cfg = (DiscoConfig if pkg is serve else JDiscoConfig)(loss="logistic")
        pkg.ModelRegistry(path).publish(
            _fake_result(d=d, seed=1, cls=res_cls, ledger=led), cfg)
        ours = _pairs(reqs)[0 if pkg is serve else 1]
        reg, eng, sched, rids = _script(pkg, path, ours, deadlines)
        reg.publish(_fake_result(d=d, seed=2, cls=res_cls, ledger=led), cfg)
        rids += [sched.submit(r, deadline_s=dl)
                 for r, dl in zip(ours[9:], deadlines[9:])]
        fin = sched.run_until_done()
        assert len(fin) == len(reqs) and eng.reloads == 1
        st = sched.stats
        runs[name] = dict(
            results=_results(sched, rids), completed=st.completed,
            rejected=st.rejected, ticks=st.ticks, busy=st.busy_s,
            lat=list(st.latencies_s), p50=st.p50_s, p99=st.p99_s,
            rps=st.throughput_rps(0.25), taken=sorted(sched.take_finished()),
            left=sched.finished)
    port, ref = runs["port"], runs["ref"]
    assert port["rejected"] > 0 and port["completed"] + port["rejected"] \
        == len(reqs)
    for k in ("completed", "rejected", "ticks", "busy", "lat", "p50", "p99",
              "rps", "taken", "left"):
        assert port[k] == ref[k], k
    for a, b in zip(port["results"], ref["results"]):
        assert a[1:] == b[1:]
        if a[0] is None:
            assert b[0] is None
        else:
            np.testing.assert_allclose(a[0], b[0], **TOL)


def test_scheduler_rejects_malformed_at_submit():
    eng = ScoringEngine(np.ones(8, np.float32), loss="logistic", batch=2,
                        block_b=2, block_d=8, device="cpu")
    sched = MicroBatchScheduler(eng)
    rid = sched.submit(ScoreRequest(np.array([0]), np.array([1.0],
                                                            np.float32)))
    with pytest.raises(ValueError, match="outside"):
        sched.submit(ScoreRequest(np.array([99]), np.array([1.0])))
    with pytest.raises(ValueError, match="duplicate"):
        sched.submit(ScoreRequest(np.array([1, 1]), np.array([1.0, 1.0])))
    assert sched.run_until_done()[rid].margin == 1.0
    assert sched.stats.completed == 1 and sched.stats.ticks == 1


def test_scheduler_ticks_emit_spans_and_gauges(ref_mode):
    rng = np.random.default_rng(0)
    w = rng.standard_normal(24).astype(np.float32)
    eng = ScoringEngine(w, loss="logistic", batch=4, block_b=2, block_d=8,
                        device="cpu")
    sched = MicroBatchScheduler(eng)
    tracer = obs.enable(reset=True)
    for _ in range(9):
        sched.submit(ScoreRequest(np.array([0, 5]),
                                  np.array([1.0, -1.0], np.float32)))
    sched.run_until_done()
    events, counters, gauges = tracer.snapshot()
    ticks = [e for e in events if e.kind == "serve.tick"]
    assert len(ticks) == sched.stats.ticks == 3
    assert [t.args["scored"] for t in ticks] == [4, 4, 1]
    assert counters["serve.scored"] == sched.stats.completed == 9
    assert gauges["serve.ticks"] == sched.stats.ticks
    assert gauges["serve.queue_depth"] == 1


def test_publish_and_hot_swap_are_traced(tmp_path, ref_mode):
    tracer = obs.enable(reset=True)
    reg = ModelRegistry(str(tmp_path / "reg"))
    reg.publish(_fake_result(d=24, seed=1), DiscoConfig())
    eng = ScoringEngine(reg, batch=2, block_b=2, block_d=8, device="cpu")
    reg.publish(_fake_result(d=24, seed=2), DiscoConfig(), activate=False)
    assert not eng.maybe_reload()
    reg.activate(2)
    assert eng.maybe_reload()
    events, _, _ = tracer.snapshot()
    pubs = [e for e in events if e.kind == "registry.publish"]
    assert [(e.args["version"], e.args["activate"]) for e in pubs] == \
        [(1, True), (2, False)]
    swaps = [e for e in events if e.kind == "serve.hot_swap"]
    assert [e.args["version"] for e in swaps] == [2]


# ---------------------------------------------------------------------------
# refits
# ---------------------------------------------------------------------------

REFIT = dict(partition="samples", loss="logistic", lam=1e-3, tau=16,
             max_outer=20, grad_tol=1e-5, pcg_rel_tol=0.01, ell_block_d=8,
             ell_block_n=8, partition_block=16, stream_chunk_size=16)


def _refit_data(seed=4):
    X, y = _sparse_problem(d=32, n=160, seed=seed)
    Xd = X.todense()
    n0, n1 = 112, 128
    parts = [(CSRMatrix.from_dense(Xd[:, a:b]), y[a:b])
             for a, b in ((0, n0), (n0, n1), (n1, 160))]
    return Xd, y, parts


def test_refit_path_matches_reference(tmp_path, ref_mode):
    from repro.data.sparse import CSRMatrix as JCSR
    Xd, y, ((X0, y0), (X1, y1), (Xv, yv)) = _refit_data()
    lams = (1e-1, 1e-2, 1e-3)
    out = {}
    for name in ("port", "ref"):
        port = name == "port"
        pkg = serve if port else jserve
        cfg = (DiscoConfig if port else JDiscoConfig)(**REFIT)
        conv = (lambda X: X) if port else \
            (lambda X: JCSR(X.indptr, X.indices, X.data, X.shape))
        store = (ShardStore if port else JShardStore).from_csr(
            conv(X0), y0, str(tmp_path / f"{name}_s"), axis="samples",
            chunk_size=16)
        reg = pkg.ModelRegistry(str(tmp_path / f"{name}_reg"))
        res0 = _fake_result(d=32, seed=7) if port else _fake_result(
            d=32, seed=7, cls=JDiscoResult, ledger=jcomm.CommLedger)
        reg.publish(res0, cfg)
        loop = (RefitLoop(reg, store, cfg, device="cpu") if port
                else jserve.RefitLoop(reg, store, cfg))
        assert loop.ingest(conv(X1), y1) == 128
        v, path = loop.refit_path(lams, X_val=conv(Xv), y_val=yv)
        out[name] = (v, path, loop.cfg.lam, reg.active_version(),
                     reg.load().w)
    (v, path, lam, act, w), (jv, jpath, jlam, jact, jw) = \
        out["port"], out["ref"]
    assert (v, act) == (jv, jact) == (2, 2)
    assert path.lambdas == list(jpath.lambdas)
    assert path.best_index == jpath.best_index and lam == jlam
    for r, jr in zip(path.results, jpath.results):
        np.testing.assert_allclose(r.w, np.asarray(jr.w), rtol=RTOL,
                                   atol=ATOL)
        assert len(r.history) == len(jr.history)
    np.testing.assert_allclose(path.val_losses, jpath.val_losses,
                               rtol=RTOL)
    np.testing.assert_allclose(w, jw, rtol=RTOL, atol=ATOL)


def test_streamed_refit_matches_inmemory_solve(tmp_path):
    """Warm streamed refit of the grown store against the port's in-memory
    solve of the grown CSR from the same w0 (the one-chunk-a-partition-
    block twin), then the cold refit: warm takes fewer Newton steps."""
    Xd, y, ((X0, y0), (X1, y1), _) = _refit_data()
    cfg = DiscoConfig(**REFIT)
    store = ShardStore.from_csr(X0, y0, str(tmp_path / "s"), axis="samples",
                                chunk_size=16)
    reg = ModelRegistry(str(tmp_path / "reg"))
    reg.publish(DiscoSolver.from_store(store, cfg, device="cpu").fit(), cfg)
    w0 = reg.load().w
    loop = RefitLoop(reg, store, cfg, device="cpu")
    assert loop.ingest(X1, y1) == 128 and store.shape == (32, 128)
    v_warm, warm = loop.refit(warm=True)
    assert v_warm == 2 and reg.active_version() == 2 and warm.converged
    assert warm.stream_stats is not None
    grown = CSRMatrix.from_dense(Xd[:, :128])
    twin = DiscoSolver(grown, y[:128],
                       dataclasses.replace(cfg, partition_strategy="width"),
                       group=InProcessGroup(store.n_chunks),
                       device="cpu").fit(w0=w0)
    np.testing.assert_array_equal(warm.w, twin.w)
    assert [h["pcg_iters"] for h in warm.history] == \
        [h["pcg_iters"] for h in twin.history]
    # the in-memory m = 1 solve differs by the chunk sums' order alone
    one = DiscoSolver(grown, y[:128], cfg, device="cpu").fit(w0=w0)
    assert np.linalg.norm(warm.w - one.w) <= 1e-5 * np.linalg.norm(one.w)
    np.testing.assert_array_equal(reg.load().w, warm.w)
    v_cold, cold = loop.refit(warm=False, activate=False)
    assert v_cold == 3 and reg.active_version() == 2 and cold.converged
    assert loop.newton_iters(warm) < loop.newton_iters(cold)
    np.testing.assert_allclose(warm.w, cold.w, atol=1e-4, rtol=1e-3)


# ---------------------------------------------------------------------------
# the public-surface holes (ROADMAP Queue 1 item 6)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("widths", [(None, None), (5, 7)])
def test_ell_pair_from_csr_matches_reference(widths):
    from repro.data.sparse import ell_pair_from_csr as j_pair
    from repro_torch.data.sparse import ell_pair_from_csr
    X, _ = _sparse_problem(d=40, n=70, seed=5)
    ours = ell_pair_from_csr(_port_csr(X), 8, 16, *widths)
    theirs = j_pair(X, 8, 16, *widths)
    for a, b in zip(ours, theirs):
        assert a.data.tobytes() == np.asarray(b.data).tobytes()
        assert np.array_equal(a.cols, b.cols)
        assert a.shape == b.shape and a.block == b.block


def _softmax_inputs(seed=0, d=24, n=40, K=5):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((d, n)).astype(np.float32)
    A = rng.standard_normal((n, K)).astype(np.float32) * 3
    U = rng.standard_normal((d, K)).astype(np.float32)
    V = rng.standard_normal((n, K)).astype(np.float32)
    wts = (rng.random(n) < 0.8).astype(np.float32)
    return X, A, U, V, wts


@pytest.mark.parametrize("weighted", [False, True])
def test_softmax_ref_and_ops_match_reference(weighted, ref_mode):
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro_torch.kernels import ops, ref
    X, A, U, V, wts = _softmax_inputs(seed=int(weighted))
    T = torch.from_numpy
    w_t, w_j = (T(wts), jnp.asarray(wts)) if weighted else (None, None)
    P = ref.ref_softmax_probs(T(A))
    jP = jref.ref_softmax_probs(jnp.asarray(A))
    np.testing.assert_allclose(P.numpy(), np.asarray(jP), **TOL)
    np.testing.assert_allclose(P.sum(1).numpy(), 1.0, rtol=1e-6)
    np.testing.assert_allclose(
        ref.ref_softmax_coupling(P, T(V), w_t).numpy(),
        np.asarray(jref.ref_softmax_coupling(jP, jnp.asarray(V), w_j)),
        **TOL)
    np.testing.assert_allclose(
        ops.softmax_coupling(P, T(V), w_t).numpy(),
        np.asarray(jops.softmax_coupling(jP, jnp.asarray(V), w_j)), **TOL)
    for n_global in (None, 100):
        want = np.asarray(jref.ref_softmax_hvp(
            jnp.asarray(X), jP, jnp.asarray(U), 1e-2, n_global=n_global,
            weights=w_j))
        got = ref.ref_softmax_hvp(T(X), P, T(U), 1e-2, n_global=n_global,
                                  weights=w_t)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
        got = ops.softmax_hvp(T(X), P, T(U), lam=1e-2, n_global=n_global,
                              weights=w_t)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # the reference's kernel route in interpret mode, at its default blocks
    want = np.asarray(jops.softmax_hvp(
        jnp.asarray(X), jP, jnp.asarray(U), lam=1e-2, weights=w_j,
        mode="interpret"))
    got = ops.softmax_hvp(T(X), P, T(U), lam=1e-2, weights=w_t)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_truncated_normal_matches_reference_distribution():
    """Bounds, mean and std of the reference's distribution within
    sampling error (its draws come from jax.random; ROADMAP F1)."""
    import jax
    import jax.numpy as jnp
    from repro.models.layers import truncated_normal as j_trunc
    from repro_torch.models.layers import truncated_normal
    n, std = 200_000, 0.02
    g = torch.Generator().manual_seed(0)
    ours = truncated_normal(g, (n,), std, torch.bfloat16)
    assert ours.dtype == torch.bfloat16 and ours.shape == (n,)
    ours = ours.float().numpy().astype(np.float64)
    theirs = np.asarray(j_trunc(jax.random.PRNGKey(0), (n,), std,
                                jnp.float32), np.float64)
    for x in (ours, theirs):
        assert np.abs(x).max() <= 2 * std * (1 + 2 ** -7)
    sigma = std * 0.879596      # the std of N(0, 1) truncated to [-2, 2]
    se = sigma / np.sqrt(n)
    assert abs(ours.mean()) <= 5 * se and abs(theirs.mean()) <= 5 * se
    assert abs(ours.std() - theirs.std()) <= 10 * se
    assert abs(ours.std() - sigma) <= 10 * se
    # the same draws as the layers' in-place fill
    g1, g2 = (torch.Generator().manual_seed(3) for _ in range(2))
    from repro_torch.models.layers import truncated_normal_
    p = torch.empty(64, 8)
    truncated_normal_(p, 0.5, g1)
    assert torch.equal(p, truncated_normal(g2, (64, 8), 0.5, torch.float32))


def test_package_exports_match_reference():
    assert serve.__all__ == jserve.__all__
    for name in jserve.__all__:
        if name != "REGISTRY_VERSION":
            assert getattr(serve, name).__module__.startswith(
                "repro_torch.glm_serve."), name
    assert serve.REGISTRY_VERSION == jserve.REGISTRY_VERSION
