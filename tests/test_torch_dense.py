"""The port's dense in-memory DiSCO against the JAX package's.

The same numpy data (``make_glm_data``, power-law features with unit-norm
columns, logistic labels) through ``repro.core.disco_fit`` (the dense
Pallas kernels in interpret mode, as the suite's conftest sets, or plain
``@`` with ``use_kernel=False``) and ``repro_torch.disco_fit(device='cpu')``
(the plain PyTorch versions): final ``w`` within rtol=1e-4, atol=1e-6;
per-step PCG iterations and the communication ledger equal. The problem
is the paper's tau = 100 preconditioner on a 98 x 202 matrix, ragged
against 4 shards on both axes, so both partitions pad; with it PCG stops
after a few iterations and f32 rounding in another summation order stays
far below the tolerance. At m = 4 the JAX reference runs in one
subprocess with four forced host devices. ``GLMProblem`` is held to the
reference at rtol=1e-5.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DiscoConfig as JDiscoConfig
from repro.core import DiscoSolver as JDiscoSolver
from repro.core import disco_fit as j_disco_fit
from repro.core.glm import GLMProblem as JGLMProblem
from repro.core.hvp import UnsupportedHvpError as JUnsupported
from repro.data.synthetic import make_glm_data as j_make_glm_data
from repro_torch import (DiscoConfig, GLMProblem, InProcessGroup, disco_fit,
                         make_glm_data)
from repro_torch.convert import DENSE_STATE_KEYS, solver_from_arrays, w_to_port
from repro_torch.core.hvp import UnsupportedHvpError

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
KW = dict(loss="logistic", lam=1e-3, tau=100, max_outer=4, grad_tol=0.0)
DATA = dict(d=98, n=202, seed=1)
RTOL, ATOL = 1e-4, 1e-6
# (use_kernel, hvp_fused); the plain dense layout has no fused kernel
VARIANTS = [(False, False), (True, False), (True, True)]
CASES = [(p, uk, fu) for p in ("samples", "features") for uk, fu in VARIANTS]


def _id(case):
    p, uk, fu = case
    return f"{p}-{'kernel' if uk else 'matmul'}-{'fused' if fu else '2pass'}"


def _data():
    X, y, _ = make_glm_data(**DATA)
    return X, y


def _cfg(cls, case):
    partition, use_kernel, fused = case
    return cls(partition=partition, use_kernel=use_kernel, hvp_fused=fused,
               **KW)


def _summary(res) -> dict:
    led = res.ledger
    return dict(w=np.asarray(res.w).tolist(),
                pcg_iters=[int(h["pcg_iters"]) for h in res.history],
                ledger=[led.rounds, led.floats, led.spmd_collectives],
                partition_info=res.partition_info)


def _assert_matches(got, ref: dict):
    np.testing.assert_allclose(got.w, np.asarray(ref["w"], np.float32),
                               rtol=RTOL, atol=ATOL)
    s = _summary(got)
    assert s["pcg_iters"] == ref["pcg_iters"]
    assert s["ledger"] == ref["ledger"]
    assert s["partition_info"] is None and ref["partition_info"] is None


def test_data_matches_jax():
    for got, want in zip(make_glm_data(**DATA), j_make_glm_data(**DATA)):
        assert np.array_equal(got, want)


def test_glm_problem_matches_jax():
    X, y = _data()
    rng = np.random.default_rng(3)
    w = (0.3 * rng.standard_normal(X.shape[0])).astype(np.float32)
    u = rng.standard_normal(X.shape[0]).astype(np.float32)
    jp = JGLMProblem.create(X, y, loss="logistic", lam=1e-3)
    tp = GLMProblem.create(X, y, loss="logistic", lam=1e-3, device="cpu")
    T = torch.from_numpy
    c = np.array(jp.hess_coeffs(w))
    for got, want in (
            (tp.margins(T(w)), jp.margins(w)),
            (tp.value(T(w)), jp.value(w)),
            (tp.grad(T(w)), jp.grad(w)),
            (tp.hess_coeffs(T(w)), c),
            (tp.hvp_with_coeffs(T(c), T(u)), jp.hvp_with_coeffs(c, u)),
            (tp.decision_function(w), jp.decision_function(w))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
    assert np.array_equal(tp.predict(w, X[:, :50]).numpy(),
                          jp.predict(w, X[:, :50]))
    # numpy input goes to the card by default, as the solver's does
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            GLMProblem.create(X, y)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_dense_fit_matches_jax(case):
    X, y = _data()
    ref = _summary(j_disco_fit(X, y, _cfg(JDiscoConfig, case)))
    got = disco_fit(X, y, _cfg(DiscoConfig, case), device="cpu")
    _assert_matches(got, ref)
    assert len(got.history) == KW["max_outer"]
    assert got.grad_norms[-1] < 0.1 * got.grad_norms[0]


@pytest.mark.parametrize("partition", ["samples", "features"])
def test_plain_dense_fused_raises_like_jax(partition):
    X, y = _data()
    case = (partition, False, True)
    with pytest.raises(JUnsupported, match="use_kernel=True"):
        JDiscoSolver(X, y, _cfg(JDiscoConfig, case))
    with pytest.raises(UnsupportedHvpError, match="use_kernel=True"):
        disco_fit(X, y, _cfg(DiscoConfig, case), device="cpu")


def test_dense_tensor_input_equals_numpy_input():
    """X and y as tensors give the numpy-input solve bit for bit."""
    X, y = _data()
    cfg = _cfg(DiscoConfig, ("samples", True, True))
    a = disco_fit(X, y, cfg, group=InProcessGroup(4), device="cpu")
    b = disco_fit(torch.from_numpy(X), torch.from_numpy(y), cfg,
                  group=InProcessGroup(4), device="cpu")
    assert np.array_equal(a.w, b.w)


SCRIPT_4 = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import numpy as np
    assert len(jax.devices()) == 4
    from repro.core import DiscoConfig, disco_fit
    from repro.data.synthetic import make_glm_data
    KW, DATA, CASES = json.loads(sys.argv[1])
    X, y, _ = make_glm_data(**DATA)
    out = []
    for partition, use_kernel, fused in CASES:
        axis = "model" if partition == "features" else "data"
        r = disco_fit(X, y, DiscoConfig(partition=partition,
                                        use_kernel=use_kernel,
                                        hvp_fused=fused, **KW),
                      mesh=jax.make_mesh((4,), (axis,)))
        led = r.ledger
        out.append(dict(w=np.asarray(r.w).tolist(),
                        pcg_iters=[int(h["pcg_iters"]) for h in r.history],
                        ledger=[led.rounds, led.floats,
                                led.spmd_collectives],
                        partition_info=r.partition_info))
    print("RESULT " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def jax_4device_runs():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               REPRO_KERNEL_MODE="interpret")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", SCRIPT_4,
                        json.dumps([KW, DATA, CASES])], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    line = [x for x in r.stdout.splitlines() if x.startswith("RESULT ")][-1]
    return dict(zip(CASES, json.loads(line[len("RESULT "):])))


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_dense_fit_4shards_matches_jax(jax_4device_runs, case):
    X, y = _data()
    got = disco_fit(X, y, _cfg(DiscoConfig, case), group=InProcessGroup(4),
                    device="cpu")
    _assert_matches(got, jax_4device_runs[case])


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_converted_dense_state_one_step_matches_jax(case):
    """The JAX solver's own dense arrays through one port step give the
    JAX step's w_new and stats."""
    X, y = _data()
    partition = case[0]
    js = JDiscoSolver(X, y, _cfg(JDiscoConfig, case))
    arrays = {k: np.asarray(getattr(js, k))
              for k in DENSE_STATE_KEYS[partition]}
    ps = solver_from_arrays(arrays, X.shape, _cfg(DiscoConfig, case),
                            m=js.m, device="cpu")
    w = (0.1 * np.random.default_rng(7).standard_normal(
        int(np.prod(js._w_shape)))).astype(np.float32)
    jw, jstats = js._step(jnp.asarray(w), jax.random.PRNGKey(0))
    pw, pstats = ps._step(w_to_port(ps, w))
    np.testing.assert_allclose(pw.reshape(-1).numpy(), np.asarray(jw),
                               rtol=RTOL, atol=ATOL)
    assert pstats["pcg_iters"] == int(jstats["pcg_iters"]) > 1
    for k in ("grad_norm", "f", "delta", "pcg_r_norm"):
        np.testing.assert_allclose(float(pstats[k]), float(jstats[k]),
                                   rtol=1e-5)


QUADRATIC_REL_L2 = 2e-5
QUADRATIC_CASES = [("samples", True, False), ("features", True, True)]


@pytest.fixture(scope="module")
def jax_4device_quadratic():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               REPRO_KERNEL_MODE="interpret")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", SCRIPT_4,
                        json.dumps([dict(KW, loss="quadratic"), DATA,
                                    QUADRATIC_CASES])],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    line = [x for x in r.stdout.splitlines() if x.startswith("RESULT ")][-1]
    return dict(zip(QUADRATIC_CASES, json.loads(line[len("RESULT "):])))


@pytest.mark.parametrize("m", [1, 4])
@pytest.mark.parametrize("case", QUADRATIC_CASES, ids=_id)
def test_dense_quadratic_matches_jax(case, m, jax_4device_quadratic):
    """``loss='quadratic'`` with Woodbury on the dense kernels (two-pass
    DiSCO-S, fused DiSCO-F): the same PCG iterations and ledger, ``w``
    within relative L2 2e-5 of the reference (its near-zero entries move
    by about atol in another f32 summation order, as in
    ``tests/test_torch_disco.py``'s quadratic cases)."""
    X, y = _data()
    partition, use_kernel, fused = case
    kw = dict(KW, loss="quadratic", partition=partition,
              use_kernel=use_kernel, hvp_fused=fused)
    if m == 1:
        ref = _summary(j_disco_fit(X, y, JDiscoConfig(**kw)))
    else:
        ref = jax_4device_quadratic[case]
    got = disco_fit(X, y, DiscoConfig(**kw), group=InProcessGroup(m),
                    device="cpu")
    s = _summary(got)
    assert s["pcg_iters"] == ref["pcg_iters"]
    assert s["ledger"] == ref["ledger"]
    w_ref = np.asarray(ref["w"], np.float32)
    assert np.linalg.norm(got.w - w_ref) <= \
        QUADRATIC_REL_L2 * np.linalg.norm(w_ref)
    assert got.grad_norms[-1] < 0.5 * got.grad_norms[0]
