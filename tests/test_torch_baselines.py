"""The port's baselines (GD, DANE, CoCoA+) against the JAX package's.

The same numpy data (``make_glm_data``, 40 x 202, ragged against 4
shards so the sample axis pads) through ``repro.core.baselines`` and
``repro_torch.core.baselines`` (``device='cpu'``): per-iteration
``grad_norm`` and ``f`` within rtol 1e-4, final ``w`` within rtol 1e-4 /
atol 1e-6, the same history keys and an equal ``CommLedger``. CoCoA+
visits the reference's own sample order: ``jax.random.randint`` with the
keys the reference draws, injected in place of the port's
``cocoa_sample_order``. At m = 4 the reference runs in a subprocess with
four forced host devices, as ``tests/test_torch_disco.py`` does.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

from repro.core.baselines import (CocoaConfig as JCocoaConfig,
                                  DaneConfig as JDaneConfig,
                                  GDConfig as JGDConfig)
from repro.core.baselines import cocoa_fit as j_cocoa_fit
from repro.core.baselines import dane_fit as j_dane_fit
from repro.core.baselines import gd_fit as j_gd_fit
from repro.core import comm as jcomm
from repro.data.synthetic import make_glm_data
from repro_torch import InProcessGroup
from repro_torch.core import comm
from repro_torch.core.baselines import (CocoaConfig, DaneConfig, GDConfig,
                                        cocoa, cocoa_fit, dane_fit, gd_fit)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
DATA = dict(d=40, n=202, seed=2)
RTOL, ATOL = 1e-4, 1e-6
# name, loss, config fields
CASES = [("gd", "logistic", dict(lam=1e-3, max_outer=12)),
         ("gd", "quadratic", dict(lam=1e-3, max_outer=12)),
         ("dane", "logistic", dict(lam=1e-3, max_outer=4)),
         ("dane", "quadratic", dict(lam=1e-3, max_outer=4)),
         ("cocoa", "logistic", dict(lam=1e-3, max_outer=5)),
         ("cocoa", "quadratic", dict(lam=1e-3, max_outer=5))]
PORT = {"gd": (GDConfig, gd_fit), "dane": (DaneConfig, dane_fit),
        "cocoa": (CocoaConfig, cocoa_fit)}
REF = {"gd": (JGDConfig, j_gd_fit), "dane": (JDaneConfig, j_dane_fit),
       "cocoa": (JCocoaConfig, j_cocoa_fit)}


def _id(case):
    return f"{case[0]}-{case[1]}"


def jax_sample_order(seed, outer_iter, shard, steps, n_loc):
    """The reference CoCoA+'s local sample order: its key split once per
    outer iteration, folded with the shard index."""
    key = jax.random.PRNGKey(seed)
    for _ in range(outer_iter + 1):
        key, sub = jax.random.split(key)
    key = jax.random.fold_in(sub, shard)
    return np.asarray(jax.random.randint(key, (steps,), 0, n_loc))


@pytest.fixture()
def reference_order(monkeypatch):
    monkeypatch.setattr(cocoa, "cocoa_sample_order", jax_sample_order)


def _summary(out) -> dict:
    w, hist, led = out
    return dict(w=np.asarray(w).tolist(), history=hist,
                ledger=[led.rounds, led.floats, led.spmd_collectives])


def _assert_matches(got: dict, ref: dict):
    assert [set(h) for h in got["history"]] == \
        [set(h) for h in ref["history"]]
    for a, b in zip(got["history"], ref["history"]):
        assert a["outer_iter"] == b["outer_iter"]
        assert a["comm_rounds_cum"] == b["comm_rounds_cum"]
        for k in ("grad_norm", "f"):
            np.testing.assert_allclose(a[k], b[k], rtol=RTOL)
    np.testing.assert_allclose(np.asarray(got["w"], np.float32),
                               np.asarray(ref["w"], np.float32),
                               rtol=RTOL, atol=ATOL)
    assert got["ledger"] == ref["ledger"]


def _port(case, m):
    name, loss, kw = case
    X, y, _ = make_glm_data(**DATA)
    cls, fit = PORT[name]
    return _summary(fit(X, y, cls(loss=loss, **kw), group=InProcessGroup(m),
                        device="cpu"))


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_baseline_matches_jax(case, reference_order):
    name, loss, kw = case
    X, y, _ = make_glm_data(**DATA)
    cls, fit = REF[name]
    ref = _summary(fit(X, y, cls(loss=loss, **kw)))
    got = _port(case, 1)
    _assert_matches(got, ref)
    assert len(got["history"]) == kw["max_outer"]
    g = [h["grad_norm"] for h in got["history"]]
    assert g[-1] < g[0]


SCRIPT_4 = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import numpy as np
    assert len(jax.devices()) == 4
    from repro.core import baselines as b
    from repro.data.synthetic import make_glm_data
    DATA, CASES = json.loads(sys.argv[1])
    X, y, _ = make_glm_data(**DATA)
    fits = {"gd": (b.GDConfig, b.gd_fit), "dane": (b.DaneConfig, b.dane_fit),
            "cocoa": (b.CocoaConfig, b.cocoa_fit)}
    out = []
    for name, loss, kw in CASES:
        cls, fit = fits[name]
        w, hist, led = fit(X, y, cls(loss=loss, **kw),
                           mesh=jax.make_mesh((4,), ("data",)))
        out.append(dict(w=np.asarray(w).tolist(), history=hist,
                        ledger=[led.rounds, led.floats,
                                led.spmd_collectives]))
    print("RESULT " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def jax_4device_runs():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               REPRO_KERNEL_MODE="interpret")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", SCRIPT_4,
                        json.dumps([DATA, CASES])], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    line = [x for x in r.stdout.splitlines() if x.startswith("RESULT ")][-1]
    return dict(zip(map(_id, CASES), json.loads(line[len("RESULT "):])))


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_baseline_4shards_matches_jax(jax_4device_runs, case,
                                      reference_order):
    _assert_matches(_port(case, 4), jax_4device_runs[_id(case)])


def test_baseline_cost_models_match_jax():
    for d in (1, 47236):
        assert comm.dane_iter_cost(d) == jcomm.dane_iter_cost(d)
        assert comm.cocoa_iter_cost(d) == jcomm.cocoa_iter_cost(d)


def test_cocoa_sample_order_is_fresh_per_step_and_shard():
    """The port's own order: uniform indices in range, another draw each
    outer iteration and each shard, and the same draw for the same
    arguments (the card and the CPU visit the same samples)."""
    a = cocoa.cocoa_sample_order(0, 0, 0, 4000, 50)
    assert a.shape == (4000,) and a.min() == 0 and a.max() == 49
    assert abs(a.mean() - 24.5) < 1.0
    assert np.array_equal(a, cocoa.cocoa_sample_order(0, 0, 0, 4000, 50))
    for other in (cocoa.cocoa_sample_order(0, 1, 0, 4000, 50),
                  cocoa.cocoa_sample_order(0, 0, 1, 4000, 50),
                  cocoa.cocoa_sample_order(1, 0, 0, 4000, 50)):
        assert np.mean(a == other) < 0.1


def test_baselines_take_tensors_and_warm_start():
    """X and y as tensors give the numpy-input fit bit for bit; DANE's
    ``w0`` warm start continues from where a fit stopped."""
    import torch
    X, y, _ = make_glm_data(**DATA)
    for cls, fit in PORT.values():
        a = fit(X, y, cls(max_outer=2), group=InProcessGroup(4),
                device="cpu")
        b = fit(torch.from_numpy(X), torch.from_numpy(y), cls(max_outer=2),
                group=InProcessGroup(4), device="cpu")
        assert np.array_equal(a[0], b[0])
    w1, h1, _ = dane_fit(X, y, DaneConfig(max_outer=2), device="cpu")
    w2, h2, _ = dane_fit(X, y, DaneConfig(max_outer=1), w0=w1,
                         device="cpu")
    assert h2[0]["grad_norm"] < h1[-1]["grad_norm"]
