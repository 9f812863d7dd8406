"""The port's multinomial softmax solver (``repro_torch.core.softmax``)
against the JAX package's and against the f64 NumPy Newton oracle.

The same numpy data through ``repro.core.softmax.softmax_fit`` (the
Pallas kernels in interpret mode, as the suite's conftest sets, and again
on its plain versions, ``REPRO_KERNEL_MODE=ref``) and
``repro_torch.softmax_fit(device='cpu')``: equal PCG iterations or s-step
rounds per Newton step and ``W`` within rtol 1e-4 / atol 1e-6 of either
reference run. On four shards the JAX reference runs in a subprocess with
four forced host devices; n = 81 is not a multiple of 4, so DiSCO-S pads
three zero-weight samples and DiSCO-F (d = 10) two zero feature rows, as
the reference does. The conformance target is
``tests/oracles.py::softmax_newton_fit`` (rel <= 1e-6, the JAX package's
own bound).
"""
import json
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracles import softmax_newton_fit
from repro.core import hvp as jhvp
from repro.core.softmax import SoftmaxConfig as JSoftmaxConfig
from repro.core.softmax import SoftmaxProblem as JSoftmaxProblem
from repro.core.softmax import SoftmaxSolver as JSoftmaxSolver
from repro.core.softmax import softmax_fit as j_softmax_fit
from repro_torch import InProcessGroup, SoftmaxConfig, softmax_fit
from repro_torch.convert import (SOFTMAX_STATE_KEYS,
                                 softmax_solver_from_arrays)
from repro_torch.core import hvp as thvp
from repro_torch.core.softmax import SoftmaxProblem, SoftmaxSolver

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
RTOL, ATOL = 1e-4, 1e-6
DATA = dict(d=10, n=81, K=3, seed=11)
KW = dict(lam=1e-3, max_outer=5, grad_tol=0.0, tau=24)
# (partition, pcg_block_s, use_kernel)
CASES = [(p, s, uk) for p in ("samples", "features") for s in (1, 2)
         for uk in (False, True)]


def _id(case):
    p, s, uk = case
    return f"{p}-s{s}-{'kernel' if uk else 'matmul'}"


def _data(d, n, K, seed):
    """Gaussian features; labels from a noisy linear model, so that the
    classes are learnable but not separable."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((d, n)).astype(np.float32)
    W = rng.standard_normal((d, K)).astype(np.float32)
    y = np.argmax(X.T @ W + 2.0 * rng.standard_normal((n, K)), axis=1)
    return X, y


def _kw(case) -> dict:
    partition, s, use_kernel = case
    return dict(KW, partition=partition, pcg_block_s=s,
                use_kernel=use_kernel)


def _summary(res) -> dict:
    return dict(W=np.asarray(res.W).tolist(),
                pcg_iters=[int(h["pcg_iters"]) for h in res.history])


def _assert_matches(got, refs):
    """``refs``: the JAX solve in interpret mode and on its plain
    versions."""
    iters = [h["pcg_iters"] for h in got.history]
    assert all(iters == r["pcg_iters"] for r in refs)
    assert min(iters) > 1
    assert any(np.allclose(got.W, np.asarray(r["W"], np.float32),
                           rtol=RTOL, atol=ATOL) for r in refs)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_softmax_fit_matches_jax(case, monkeypatch):
    X, y = _data(**DATA)
    kw = _kw(case)
    refs = []
    for mode in ("interpret", "ref"):
        monkeypatch.setenv("REPRO_KERNEL_MODE", mode)
        refs.append(_summary(j_softmax_fit(X, y, JSoftmaxConfig(**kw))))
    got = softmax_fit(X, y, SoftmaxConfig(**kw), device="cpu")
    assert got.W.shape == (DATA["d"], DATA["K"])
    _assert_matches(got, refs)
    assert got.grad_norms[-1] < 0.1 * got.grad_norms[0]


SCRIPT_4 = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import numpy as np
    assert len(jax.devices()) == 4
    from repro.core.softmax import SoftmaxConfig, softmax_fit
    X = np.asarray(json.loads(sys.argv[1]), np.float32)
    y = np.asarray(json.loads(sys.argv[2]))
    out = []
    for kw in json.loads(sys.argv[3]):
        axis = "model" if kw["partition"] == "features" else "data"
        runs = []
        for mode in ("interpret", "ref"):
            os.environ["REPRO_KERNEL_MODE"] = mode
            r = softmax_fit(X, y, SoftmaxConfig(**kw),
                            mesh=jax.make_mesh((4,), (axis,)))
            runs.append(dict(W=np.asarray(r.W).tolist(),
                             pcg_iters=[int(h["pcg_iters"])
                                        for h in r.history]))
        out.append(runs)
    print("RESULT " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def jax_4device_runs():
    X, y = _data(**DATA)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", SCRIPT_4,
                        json.dumps(X.tolist()), json.dumps(y.tolist()),
                        json.dumps([_kw(c) for c in CASES])],
                       env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout + r.stderr
    line = [x for x in r.stdout.splitlines() if x.startswith("RESULT ")][-1]
    return dict(zip(CASES, json.loads(line[len("RESULT "):])))


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_softmax_fit_4shards_matches_jax(jax_4device_runs, case):
    """Four shards, with the reference's padding: zero-weight samples for
    DiSCO-S (its s-step basis operator on four shards is the replicated
    tau-sample estimate), zero feature rows for DiSCO-F."""
    X, y = _data(**DATA)
    got = softmax_fit(X, y, SoftmaxConfig(**_kw(case)),
                      group=InProcessGroup(4), device="cpu")
    _assert_matches(got, jax_4device_runs[case])


@pytest.mark.parametrize("partition", ["samples", "features"])
@pytest.mark.parametrize("s", [1, 2])
@pytest.mark.parametrize("m", [1, 4])
def test_softmax_matches_numpy_newton(partition, s, m):
    """The JAX package's conformance problem (10 x 80, K = 3, lam = 0.1):
    the port's solution within 1e-6 (relative) of the f64 NumPy Newton
    optimum, on one shard and on four."""
    rng = np.random.default_rng(11)
    d, n, K = 10, 80, 3
    X = rng.standard_normal((d, n)).astype(np.float32)
    y = rng.integers(0, K, size=n)
    lam = 0.1
    W_ref = softmax_newton_fit(X, y, lam, K=K)
    cfg = SoftmaxConfig(lam=lam, partition=partition, max_outer=30,
                        max_pcg=200, pcg_rel_tol=0.01, grad_tol=1e-10,
                        pcg_block_s=s, tau=24)
    res = softmax_fit(X, y, cfg, group=InProcessGroup(m), device="cpu")
    rel = np.linalg.norm(res.W - W_ref) / np.linalg.norm(W_ref)
    assert rel <= 1e-6, (partition, s, m, rel)


def test_softmax_problem_matches_jax(monkeypatch):
    X, y = _data(**DATA)
    rng = np.random.default_rng(3)
    W = (0.3 * rng.standard_normal((DATA["d"], DATA["K"]))).astype(
        np.float32)
    U = rng.standard_normal(W.shape).astype(np.float32)
    jp = JSoftmaxProblem(X, y, lam=1e-2)
    tp = SoftmaxProblem(X, y, lam=1e-2, device="cpu")
    assert tp.n_classes == jp.n_classes == DATA["K"]
    Wt, Wj = torch.from_numpy(W), jnp.asarray(W)
    for got, ref in ((tp.probs(Wt), jp.probs(Wj)),
                     (tp.value(Wt), jp.value(Wj)),
                     (tp.grad(Wt), jp.grad(Wj)),
                     (tp.hvp(Wt, torch.from_numpy(U)),
                      jp.hvp(Wj, jnp.asarray(U)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-6)
    H = tp.hessian(Wt).numpy()
    np.testing.assert_allclose(H, H.T, atol=1e-6)
    np.testing.assert_allclose(H, np.asarray(jp.hessian(Wj)), rtol=1e-5,
                               atol=1e-6)
    # numpy input goes to the card by default, and with none it raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SoftmaxProblem(X, y)


@pytest.mark.parametrize("partition", ["samples", "features"])
def test_converted_softmax_state_one_step_matches_jax(partition):
    """A JAX SoftmaxSolver's arrays, carried over, give the same Newton
    step: W (rtol 1e-5) and its statistics."""
    X, y = _data(**DATA)
    kw = dict(KW, partition=partition, pcg_block_s=2)
    js = JSoftmaxSolver(X, y, JSoftmaxConfig(**kw))
    arrays = {k: np.asarray(getattr(js, k))
              for k in SOFTMAX_STATE_KEYS[partition]}
    ps = softmax_solver_from_arrays(arrays, X.shape, SoftmaxConfig(**kw),
                                    device="cpu")
    assert ps.K == js.K and ps.X.shape == js.X.shape
    W = (0.1 * np.random.default_rng(7).standard_normal(
        (js.d_padded, js.K))).astype(np.float32)
    jW, jstats = js._step(jnp.asarray(W))
    Wt = torch.from_numpy(W)
    if partition == "features":
        Wt = Wt.reshape(1, -1, js.K)
    pW, pstats = ps._step(Wt)
    np.testing.assert_allclose(pW.reshape(W.shape).numpy(), np.asarray(jW),
                               rtol=1e-5, atol=1e-6)
    assert pstats["pcg_iters"] == int(jstats["pcg_iters"]) > 1
    for k in ("grad_norm", "f", "delta", "pcg_r_norm"):
        np.testing.assert_allclose(float(pstats[k]), float(jstats[k]),
                                   rtol=1e-5)


def test_softmax_cells_follow_the_registry():
    """Softmax cells resolve as in the reference: fused and streamed
    softmax are unsupported (with the reference's reason), the dense
    layouts supported, and the solver refuses a fused config at set-up."""
    for fused in (False, True):
        for layout in ("dense", "dense_kernel", "streamed"):
            args = ("softmax", layout, "samples", fused, "float32")
            ref = [c for c in jhvp.operator_cells() if tuple(c[:5]) == args]
            assert len(ref) == 1
            if ref[0].supported:
                assert thvp.resolve_cell(*args).supported
            else:
                with pytest.raises(thvp.UnsupportedHvpError) as exc:
                    thvp.resolve_cell(*args)
                assert ref[0].reason in str(exc.value)
    X, y = _data(**DATA)
    with pytest.raises(thvp.UnsupportedHvpError, match="coupling"):
        SoftmaxSolver(X, y, SoftmaxConfig(hvp_fused=True, use_kernel=True),
                      device="cpu")
