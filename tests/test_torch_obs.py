"""The port's tracing plane (``repro_torch.obs``) against the JAX
package's (``repro.obs``): tracer semantics, the exporters, the report,
the closed vocabulary, and the hooks of the in-memory solve.

Counterparts of the in-memory cases of ``tests/test_obs.py`` (tracer
core, exporters, the registry, the traced in-memory solve, the measured
vs predicted rows), plus cross-package checks: the registries carry the
same kind names, layers and event types; the analytic counters of a
traced port solve equal the reference's traced counters exactly; the
cost models and the report give the reference's numbers exactly (the
same float64 arithmetic). The JAX side runs with
``REPRO_KERNEL_MODE=ref``. Solves are compared bit for bit against
themselves (tracing on and off) and to the reference's ``w`` within
rtol 1e-4 / atol 1e-6, as ``tests/test_torch_disco.py`` does.
"""
import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from repro import obs as jobs
from repro.core import DiscoConfig as JDiscoConfig
from repro.core import DiscoSolver as JDiscoSolver
from repro.core import comm as jcomm
from repro.core.hvp import render_support_matrix as j_render_support_matrix
from repro.data.sparse import make_sparse_glm_data
from repro_torch import obs
from repro_torch import CSRMatrix, DiscoConfig, DiscoSolver, InProcessGroup
from repro_torch.core import comm
from repro_torch.core.hvp import render_support_matrix
from repro_torch.obs.tracer import (_NOOP_SPAN, COUNTER_KINDS, GAUGE_KINDS,
                                    SPAN_KINDS, TraceEvent)

ROOT = os.path.join(os.path.dirname(__file__), "..")
PORT_SRC = os.path.join(ROOT, "src", "repro_torch")
RTOL, ATOL = 1e-4, 1e-6

# registered kinds the port does not emit: none since GLM serving was
# ported (its spans, counter and gauges are emitted by repro_torch.glm_serve)
NOT_YET_EMITTED = {"span": set(), "count": set(), "gauge": set()}


@pytest.fixture(autouse=True)
def _obs_clean():
    """Tests toggle both process-global tracers; always leave them off."""
    obs.disable()
    jobs.disable()
    yield
    obs.disable()
    jobs.disable()


@pytest.fixture()
def ref_mode(monkeypatch):
    monkeypatch.setenv("REPRO_KERNEL_MODE", "ref")


def _sparse(seed=1):
    X, y, _ = make_sparse_glm_data(d=96, n=160, density=0.2, alpha=1.0,
                                   beta=0.5, seed=seed)
    return X, y, CSRMatrix(X.indptr, X.indices, X.data, X.shape)


SOLVE = dict(loss="logistic", lam=1e-2, tau=16, max_outer=3,
             grad_tol=1e-10, ell_block_d=8, ell_block_n=8,
             partition_block=16)


# ---------------------------------------------------------------------------
# tracer core
# ---------------------------------------------------------------------------

def test_span_nesting_and_thread_attribution():
    tracer = obs.enable(reset=True)
    with obs.span("newton.outer", outer_iter=0) as sp:
        with obs.span("pcg.round", t=0):
            pass
        sp.set(extra=1)
    obs.instant("comm.allreduce", phase="pcg")

    def worker():
        with obs.span("stream.chunk_load", cid=3, shard=1, layouts="fwd"):
            pass

    th = threading.Thread(target=worker, name="prefetch-test")
    th.start()
    th.join()

    events, _, _ = tracer.snapshot()
    kinds = [e.kind for e in events]
    # exit order: the inner span records before the outer one
    assert kinds == ["pcg.round", "newton.outer", "comm.allreduce",
                     "stream.chunk_load"]
    outer = events[1]
    assert outer.ph == "X" and outer.dur_ns >= 0
    assert outer.args == {"outer_iter": 0, "extra": 1}   # set() merged
    inner = events[0]
    assert inner.t0_ns >= outer.t0_ns                    # nested inside
    assert inner.t0_ns + inner.dur_ns <= outer.t0_ns + outer.dur_ns
    assert events[2].ph == "i" and events[2].dur_ns == 0
    assert events[3].thread == "prefetch-test"
    assert events[3].tid != outer.tid


def test_noop_fast_path_identity():
    obs.disable()
    assert not obs.enabled()
    # the disabled span is one cached singleton: no allocation per site
    s1 = obs.span("newton.outer", outer_iter=0)
    s2 = obs.span("pcg.round")
    assert s1 is s2 is _NOOP_SPAN
    with s1 as sp:
        sp.set(anything=1)
    # disabled emission drops silently, even for unregistered names
    obs.instant("comm.allreduce")
    obs.count("comm.rounds", 5)
    obs.gauge("serve.ticks", 1)
    obs.instant("no.such.kind")
    assert obs.snapshot() == ([], {}, {}) and obs.span_count("x") == 0
    tracer = obs.enable(reset=True)
    assert tracer.snapshot() == ([], {}, {})
    # enable() without reset returns the same tracer (sticky)
    assert obs.enable() is tracer and obs.get_tracer() is tracer


def test_unknown_kinds_raise():
    obs.enable(reset=True)
    with pytest.raises(ValueError, match="SPAN_KINDS"):
        obs.span("no.such.kind")
    with pytest.raises(ValueError, match="SPAN_KINDS"):
        obs.instant("no.such.kind")
    with pytest.raises(ValueError, match="SPAN_KINDS"):
        obs.complete("no.such.kind", 0)
    with pytest.raises(ValueError, match="COUNTER_KINDS"):
        obs.count("no.such.counter")
    with pytest.raises(ValueError, match="GAUGE_KINDS"):
        obs.gauge("no.such.gauge", 1.0)


def test_counters_gauges_and_span_count():
    tracer = obs.enable(reset=True)
    obs.count("comm.rounds", 3)
    obs.count("comm.rounds")
    obs.count("io.retries")
    obs.gauge("serve.queue_depth", 7)
    obs.gauge("serve.queue_depth", 2)        # last value wins
    obs.instant("comm.allreduce")
    obs.instant("comm.allreduce")
    t0 = time.perf_counter_ns()
    obs.complete("ckpt.write", t0, next_iter=1)
    _, counters, gauges = tracer.snapshot()
    assert counters == {"comm.rounds": 4, "io.retries": 1}
    assert gauges == {"serve.queue_depth": 2}
    assert tracer.span_count("comm.allreduce") == 2
    assert obs.span_count("comm.allreduce") == 2
    assert obs.span_count("ckpt.write") == 1
    assert obs.snapshot() == tracer.snapshot()


def test_env_switch_is_read_at_import():
    """``REPRO_TRACE=1`` in the environment enables tracing at import, as
    in the reference; unset or ``0`` leaves it off."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    code = ("import sys; sys.modules['jax'] = None; "
            "from repro_torch import obs; print(obs.enabled())")
    outs = []
    for value in ("1", "0"):
        env["REPRO_TRACE"] = value
        r = subprocess.run([sys.executable, "-c", code], env=env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr
        outs.append(r.stdout.strip())
    assert outs == ["True", "False"]


# ---------------------------------------------------------------------------
# exporters
# ---------------------------------------------------------------------------

def test_chrome_trace_structure(tmp_path):
    tracer = obs.enable(reset=True)
    with obs.span("newton.outer", outer_iter=0):
        obs.instant("comm.allreduce", phase="outer")
    obs.count("comm.rounds", 2)
    obs.gauge("serve.ticks", 1)

    events = obs.export.chrome_trace(tracer)
    json.dumps(events)                       # Perfetto-loadable
    phases = [e["ph"] for e in events]
    assert phases.count("X") == 1 and phases.count("i") == 1
    x = next(e for e in events if e["ph"] == "X")
    assert x["name"] == "newton.outer" and x["dur"] >= 0 and x["ts"] >= 0
    i = next(e for e in events if e["ph"] == "i")
    assert i["s"] == "t"
    metas = [e for e in events if e["ph"] == "M"]
    assert any(m["name"] == "thread_name" for m in metas)
    labels = [m for m in metas if m["name"] == "process_labels"]
    assert labels and "comm.rounds" in str(labels[-1]["args"])

    path = tmp_path / "trace.json"
    obs.export.write_chrome_trace(tracer, str(path))
    assert json.loads(path.read_text()) == json.loads(json.dumps(events))


def test_summary_rows_are_flat_bench_rows():
    sys.path.insert(0, ROOT)
    from benchmarks.common import validate_bench_record

    tracer = obs.enable(reset=True)
    with obs.span("ckpt.write", next_iter=1):
        pass
    obs.count("io.retries", 2)
    obs.gauge("serve.queue_depth", 5)
    rows = obs.export.summary_rows(tracer)
    assert {r["kind"] for r in rows} == {"ckpt.write", "counter:io.retries",
                                         "gauge:serve.queue_depth"}
    validate_bench_record({"bench": "obs-test", "rows": rows})


def _same_events(port_tracer, ref_tracer, events):
    """Record the same (kind, ph, t0, dur, args) events into both."""
    for kind, ph, t0, dur, args in events:
        for tracer, cls in ((port_tracer, TraceEvent),
                            (ref_tracer, jobs.TraceEvent)):
            tracer.events.append(cls(kind=kind, ph=ph, t0_ns=t0,
                                     dur_ns=dur, tid=1, thread="main",
                                     args=dict(args)))


EVENTS = [("stream.chunk_load", "X", 100, 5_000, {"cid": 0, "shard": 0}),
          ("stream.chunk_load", "X", 200, 9_000, {"cid": 1, "shard": 1}),
          ("stream.chunk_load", "X", 300, 2_000, {"cid": 2, "shard": 1}),
          ("newton.outer", "X", 50, 30_000, {"outer_iter": 0}),
          ("comm.allreduce", "i", 60, 0, {"phase": "outer"}),
          ("ckpt.write", "X", 400, 7_000, {"next_iter": 1})]


def test_exports_and_span_rows_match_reference():
    """The same events give the reference's Chrome trace, summary rows
    and per-(shard, kind) rows, the straggler flags included."""
    pt, rt_ = obs.Tracer(), jobs.Tracer()
    rt_.epoch_ns = pt.epoch_ns = 0
    _same_events(pt, rt_, EVENTS)
    pt.counters.update({"comm.rounds": 3})
    rt_.counters.update({"comm.rounds": 3})
    assert obs.export.chrome_trace(pt) == jobs.export.chrome_trace(rt_)
    assert obs.export.summary_rows(pt) == jobs.export.summary_rows(rt_)
    rows = obs.report.span_rows(pt)
    assert rows == jobs.report.span_rows(rt_)
    crit = {(r["kind"], r["shard"]) for r in rows if r["critical"]}
    assert ("stream.chunk_load", "1") in crit


# ---------------------------------------------------------------------------
# the vocabulary
# ---------------------------------------------------------------------------

def _emitted(root) -> dict:
    pat = re.compile(
        r"obs\.(span|instant|complete|count|gauge)\(\s*\n?\s*\"([^\"]+)\"")
    emitted = {"span": set(), "count": set(), "gauge": set()}
    for dirpath, _, files in os.walk(root):
        for fname in files:
            if not fname.endswith(".py") or "obs" in dirpath:
                continue
            with open(os.path.join(dirpath, fname)) as f:
                for fn, kind in pat.findall(f.read()):
                    group = {"instant": "span", "complete": "span"}.get(
                        fn, fn)
                    emitted[group].add(kind)
    return emitted


def test_emitted_kinds_are_registered():
    """Every emission literal in the port's sources is registered, and
    every registered kind is emitted somewhere in the port."""
    emitted = _emitted(PORT_SRC)
    assert emitted["span"] <= set(SPAN_KINDS)
    assert emitted["count"] <= set(COUNTER_KINDS)
    assert emitted["gauge"] <= set(GAUGE_KINDS)
    for group, registry in (("span", SPAN_KINDS), ("count", COUNTER_KINDS),
                            ("gauge", GAUGE_KINDS)):
        assert set(registry) - emitted[group] == NOT_YET_EMITTED[group], \
            group


def test_render_span_kinds_covers_registry():
    text = obs.render_span_kinds()
    for name in list(SPAN_KINDS) + list(COUNTER_KINDS) + list(GAUGE_KINDS):
        assert f"`{name}`" in text
    assert text.count("\n| `") == (len(SPAN_KINDS) + len(COUNTER_KINDS)
                                   + len(GAUGE_KINDS))


@pytest.mark.parametrize("registry", ["span", "counter", "gauge"])
def test_registries_match_reference(registry):
    """The same kind names in the same order, and for spans the same
    layer and event type: a trace reads the same from either package."""
    port, ref = {"span": (SPAN_KINDS, jobs.SPAN_KINDS),
                 "counter": (COUNTER_KINDS, jobs.COUNTER_KINDS),
                 "gauge": (GAUGE_KINDS, jobs.GAUGE_KINDS)}[registry]
    assert list(port) == list(ref)
    if registry == "span":
        for kind in port:
            assert port[kind][:2] == ref[kind][:2], kind


def test_render_support_matrix_matches_reference():
    assert render_support_matrix() == j_render_support_matrix()


# ---------------------------------------------------------------------------
# the cost models behind the report
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("partition", ["samples", "features"])
@pytest.mark.parametrize("s", [1, 4])
def test_streaming_passes_match_reference(partition, s):
    for iters in (0, 1, 7):
        assert comm.streaming_data_passes(partition, iters, s) == \
            jcomm.streaming_data_passes(partition, iters, s)
    with pytest.raises(ValueError):
        comm.streaming_data_passes("rows", 1)


@pytest.mark.parametrize("partition", ["samples", "features"])
@pytest.mark.parametrize("s,fused,dtype_bytes", [(1, False, 4),
                                                 (1, True, 2),
                                                 (3, False, 2),
                                                 (3, True, 4)])
def test_streaming_iter_time_matches_reference(partition, s, fused,
                                               dtype_bytes):
    kw = dict(n=20_242, d=47_236, m=4, s=s, chunk_nnz_max=60_000,
              prefetch_depth=3, hvp_fused=fused,
              hvp_dtype_bytes=dtype_bytes)
    shard_nnz = [380_000, 390_511, 377_001, 386_630]
    got = comm.disco_streaming_iter_time(shard_nnz, 9, partition, **kw)
    want = jcomm.disco_streaming_iter_time(shard_nnz, 9, partition, **kw)
    assert got == want
    assert got["total_s"] <= got["total_no_overlap_s"]


# ---------------------------------------------------------------------------
# traced in-memory solves
# ---------------------------------------------------------------------------

def _port_data(kind, glm_data):
    if kind == "dense":
        X, y, _ = glm_data
        return X, y, X
    X, y, Xt = _sparse()
    return X, y, Xt


@pytest.mark.parametrize("partition", ["samples", "features"])
@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_inmemory_counter_matches_ledger_and_iter_s(ref_mode, glm_data,
                                                    partition, kind):
    """The traced port solve: ``comm.*`` counters equal its CommLedger and
    the reference's traced counters of the same solve; one
    ``newton.outer`` span a step, each no longer than its ``iter_s``; the
    same span kinds as the reference's trace (``kernel.dispatch`` aside,
    which the reference emits once a process); ``w`` within rtol 1e-4 /
    atol 1e-6 of the reference's."""
    X, y, Xp = _port_data(kind, glm_data)
    kw = dict(SOLVE, partition=partition, trace=True)
    jtracer = jobs.enable(reset=True)
    jres = JDiscoSolver(X, y, JDiscoConfig(**kw)).fit()
    tracer = obs.enable(reset=True)
    res = DiscoSolver(Xp, y, DiscoConfig(**kw), device="cpu").fit()
    events, counters, _ = tracer.snapshot()
    assert counters["comm.rounds"] == res.ledger.rounds > 0
    assert counters["comm.floats"] == res.ledger.floats
    assert counters["comm.spmd_collectives"] == res.ledger.spmd_collectives
    assert counters == jtracer.snapshot()[1]
    assert tracer.span_count("newton.outer") == len(res.history)
    outer = [e for e in events if e.kind == "newton.outer"]
    for h, ev in zip(res.history, outer):
        assert h["iter_s"] > 0.0
        assert ev.dur_ns / 1e9 <= h["iter_s"]
        assert ev.args == {"outer_iter": h["outer_iter"],
                           "streaming": False}
    kinds = {e.kind for e in events} - {"kernel.dispatch"}
    jkinds = {e.kind for e in jtracer.snapshot()[0]} - {"kernel.dispatch"}
    assert kinds == jkinds == {"hvp.dispatch", "newton.outer"}
    np.testing.assert_allclose(res.w, np.asarray(jres.w), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("kind,use_kernel,fused,dtype", [
    ("sparse", False, False, "float32"), ("sparse", False, True, "bfloat16"),
    ("dense", False, False, "float32"), ("dense", True, True, "float32"),
    ("dense", True, False, "bfloat16")])
def test_hvp_dispatch_cell_matches_reference(glm_data, kind, use_kernel,
                                             fused, dtype):
    """``DiscoConfig(trace=True)`` enables tracing at construction and the
    setup records the reference's ``hvp.dispatch`` cell id."""
    X, y, Xp = _port_data(kind, glm_data)
    kw = dict(SOLVE, partition="samples", trace=True, use_kernel=use_kernel,
              hvp_fused=fused, hvp_dtype=dtype)
    assert not obs.enabled()
    DiscoSolver(Xp, y, DiscoConfig(**kw), device="cpu")
    assert obs.enabled()
    JDiscoSolver(X, y, JDiscoConfig(**kw))
    cells = [e.args["cell"] for e in obs.get_tracer().events
             if e.kind == "hvp.dispatch"]
    jcells = [e.args["cell"] for e in jobs.get_tracer().events
              if e.kind == "hvp.dispatch"]
    assert cells == jcells and len(cells) == 1


def test_tracing_changes_nothing_in_the_solve():
    """Traced and untraced fits of one solver give the same ``w`` bit for
    bit and the same history (timings aside); ``kernel.dispatch`` is
    recorded once per tracer (mode 'plain' on CPU tensors)."""
    _, y, Xt = _sparse()
    solver = DiscoSolver(Xt, y, DiscoConfig(**dict(SOLVE,
                                                   partition="features")),
                         group=InProcessGroup(4), device="cpu")
    plain = solver.fit()
    for _ in range(2):
        tracer = obs.enable(reset=True)
        traced = solver.fit()
        np.testing.assert_array_equal(traced.w, plain.w)
        for a, b in zip(traced.history, plain.history):
            assert {k: v for k, v in a.items() if k != "iter_s"} == \
                {k: v for k, v in b.items() if k != "iter_s"}
        dispatch = [e for e in tracer.events if e.kind == "kernel.dispatch"]
        assert [e.args for e in dispatch] == [{"mode": "plain"}]
    obs.disable()
    again = solver.fit()
    np.testing.assert_array_equal(again.w, plain.w)


def test_chrome_trace_of_a_fit(tmp_path):
    """A traced solve's Chrome trace writes and reads back: one X event a
    Newton step, the analytic counters on the process labels."""
    _, y, Xt = _sparse()
    tracer = obs.enable(reset=True)
    res = DiscoSolver(Xt, y, DiscoConfig(**dict(SOLVE, partition="samples",
                                                trace=True)),
                      device="cpu").fit()
    path = obs.export.write_chrome_trace(tracer, str(tmp_path / "t.json"))
    back = json.loads(open(path).read())
    assert back == json.loads(json.dumps(obs.export.chrome_trace(tracer)))
    xs = [e for e in back if e["ph"] == "X"]
    assert [e["args"]["outer_iter"] for e in xs] == \
        [h["outer_iter"] for h in res.history]
    labels = json.loads(next(e for e in back if e["name"]
                             == "process_labels")["args"]["labels"])
    assert labels["counters"]["comm.rounds"] == res.ledger.rounds


@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("partition,s", [("samples", 1), ("features", 1),
                                         ("samples", 2)])
def test_measured_vs_predicted_rows(ref_mode, glm_data, streaming,
                                    partition, s):
    """The port's rows over a port solve's history: one a step, the first
    flagged ``compile``, ratio = measured / predicted; the predictions
    equal the reference's report on the same history exactly."""
    X, y, _ = glm_data
    cfg = DiscoConfig(partition=partition, loss="logistic", lam=1e-2,
                      tau=16, max_outer=3, grad_tol=1e-10, pcg_block_s=s)
    res = DiscoSolver(X, y, cfg, device="cpu").fit()
    args = (res.history, [int(np.count_nonzero(X))], partition)
    kw = dict(n=X.shape[1], d=X.shape[0], m=1, s=s, streaming=streaming,
              chunk_nnz_max=512 if streaming else None)
    rows = obs.report.measured_vs_predicted(*args, **kw)
    assert len(rows) == len(res.history)
    assert rows[0]["compile"] and not any(r["compile"] for r in rows[1:])
    for r in rows:
        assert r["measured_s"] > 0 and r["predicted_s"] > 0
        assert r["ratio"] == pytest.approx(r["measured_s"]
                                           / r["predicted_s"])
    assert rows == jobs.report.measured_vs_predicted(*args, **kw)
