"""The port's whole in-memory sparse DiSCO solve against the JAX package's.

Same data through ``repro.core.disco_fit`` (Pallas kernels in interpret
mode) and ``repro_torch.disco_fit(device='cpu')`` (the plain versions):
final ``w`` within rtol=1e-4, atol=1e-6; per-step PCG iterations, the
communication ledger and the partition info equal. The problem is the
paper's tau = 100 preconditioner on a 96 x 200 power-law matrix in 16 x 16
tiles; with it PCG stops after a handful of iterations, so f32 rounding in
another summation order stays far below the tolerance. At m = 4 the JAX
reference runs in a subprocess with four forced host devices.
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
from repro.data.sparse import make_sparse_glm_data
from repro_torch import (CSRMatrix, DiscoConfig, DiscoSolver, InProcessGroup,
                         disco_fit)
from repro_torch.convert import STATE_KEYS, solver_from_arrays, w_to_port

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
KW = dict(loss="logistic", lam=1e-3, tau=100, max_outer=4, grad_tol=0.0,
          ell_block_d=16, ell_block_n=16)
DATA = dict(d=96, n=200, density=0.2, alpha=0.8, beta=0.5, seed=1)
RTOL, ATOL = 1e-4, 1e-6


def _data():
    X, y, _ = make_sparse_glm_data(**DATA)
    return X, y, CSRMatrix(X.indptr, X.indices, X.data, X.shape)


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
    assert s["partition_info"] == ref["partition_info"]


@pytest.mark.parametrize("partition", ["samples", "features"])
@pytest.mark.parametrize("strategy", ["lpt", "width"])
@pytest.mark.parametrize("fused", [False, True])
def test_disco_fit_matches_jax(partition, strategy, fused):
    X, y, Xt = _data()
    kw = dict(partition=partition, partition_strategy=strategy,
              hvp_fused=fused, **KW)
    ref = _summary(j_disco_fit(X, y, JDiscoConfig(**kw)))
    got = disco_fit(Xt, y, DiscoConfig(**kw), device="cpu")
    _assert_matches(got, ref)
    assert len(got.history) == KW["max_outer"]
    assert set(got.history[0]) == {
        "grad_norm", "f", "pcg_iters", "delta", "pcg_r_norm", "iter_s",
        "outer_iter", "comm_rounds_cum", "comm_floats_cum"}
    assert got.grad_norms[-1] < 0.5 * got.grad_norms[0]


CASES_4 = [("samples", "lpt", False), ("samples", "width", True),
           ("features", "lpt", False), ("features", "width", True)]

SCRIPT_4 = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import numpy as np
    assert len(jax.devices()) == 4
    from repro.core import DiscoConfig, disco_fit
    from repro.data.sparse import make_sparse_glm_data
    KW, DATA, CASES = json.loads(sys.argv[1])
    X, y, _ = make_sparse_glm_data(**DATA)
    out = []
    for partition, strategy, fused in CASES:
        axis = "model" if partition == "features" else "data"
        r = disco_fit(X, y, DiscoConfig(partition=partition,
                                        partition_strategy=strategy,
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
                        json.dumps([KW, DATA, CASES_4])], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    line = [x for x in r.stdout.splitlines() if x.startswith("RESULT ")][-1]
    return dict(zip(map(tuple, CASES_4), json.loads(line[len("RESULT "):])))


@pytest.mark.parametrize("case", CASES_4, ids=lambda c: "-".join(map(str, c)))
def test_disco_fit_4shards_matches_jax(jax_4device_runs, case):
    partition, strategy, fused = case
    X, y, Xt = _data()
    got = disco_fit(Xt, y, DiscoConfig(partition=partition,
                                       partition_strategy=strategy,
                                       hvp_fused=fused, **KW),
                    group=InProcessGroup(4), device="cpu")
    assert got.partition_info["m"] == 4
    _assert_matches(got, jax_4device_runs[case])


@pytest.mark.parametrize("partition", ["samples", "features"])
@pytest.mark.parametrize("fused", [False, True])
def test_converted_state_one_step_matches_jax(partition, fused):
    """The JAX solver's own arrays (not the port's partitioner) through one
    port step give the JAX step's w_new and stats."""
    X, y, _ = _data()
    kw = dict(partition=partition, hvp_fused=fused, **KW)
    js = JDiscoSolver(X, y, JDiscoConfig(**kw))
    arrays = {k: np.asarray(getattr(js, k)) for k in STATE_KEYS[partition]}
    arrays["perm"] = js._part.perm
    ps = solver_from_arrays(arrays, X.shape, DiscoConfig(**kw),
                            device="cpu")
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


@pytest.mark.parametrize("override", [
    dict(hessian_subsample=0.5), dict(precond="sag"), dict(pcg_block_s=2),
    dict(hvp_dtype="bfloat16"), dict(trace=True)],
    ids=lambda o: next(iter(o)))
def test_unported_options_raise(override):
    """The options not yet ported raise "not yet ported". s-step PCG is
    ported now: it builds on sparse input and on fused dense kernels (the
    x_c_xt_multi cells, which raised until that kernel was ported). So are
    Hessian subsampling and the SAG preconditioner (they raised until
    then; ``tests/test_torch_subsample.py`` and ``tests/test_torch_sag.py``
    hold them to the reference): they build on sparse and dense input and
    take a step. bf16 HVP tiles (which raised until the sparse and the
    two-pass dense kernels took them; ``tests/test_torch_bf16.py`` and
    ``tests/test_torch_dense_bf16.py`` hold them to the reference) build
    on sparse and dense input and take a step, with the one-pass dense
    kernels (``hvp_fused=True``) too (they raised until K5 and K10 took
    bf16 tiles; ``tests/test_torch_fused_bf16.py``). ``trace=True`` is
    ported too (it raised until the tracing plane was;
    ``tests/test_torch_obs.py`` holds it to the reference): it turns the
    tracer on and the traced step records its HVP cell."""
    X, y, Xt = _data()
    cfg = DiscoConfig(**dict(KW, **override))
    if "trace" in override:
        from repro_torch import obs
        obs.disable()
        try:
            solver = DiscoSolver(Xt, y, cfg, device="cpu")
            assert obs.enabled()
            w, stats = solver._step(torch.zeros(solver._w_shape))
            assert torch.isfinite(w).all() and stats["pcg_iters"] > 0
            assert obs.span_count("hvp.dispatch") == 1
        finally:
            obs.disable()
        return
    if "hvp_dtype" in override:
        solver = DiscoSolver(Xt, y, cfg, device="cpu")
        assert solver.ell_data_h.dtype == torch.bfloat16
        w, stats = solver._step(torch.zeros(solver._w_shape))
        assert torch.isfinite(w).all() and stats["pcg_iters"] > 0
        dense = DiscoSolver(X.todense(), y, cfg, device="cpu")
        assert dense.X_h.dtype == torch.bfloat16
        w, stats = dense._step(torch.zeros(dense._w_shape))
        assert torch.isfinite(w).all() and stats["pcg_iters"] > 0
        fused = DiscoSolver(X.todense(), y, DiscoConfig(**dict(
            KW, use_kernel=True, hvp_fused=True, **override)),
            device="cpu")
        assert fused.X_h.dtype == torch.bfloat16
        w, stats = fused._step(torch.zeros(fused._w_shape))
        assert torch.isfinite(w).all() and stats["pcg_iters"] > 0
        return
    if "hessian_subsample" in override or "precond" in override:
        kw = dict(KW, partition="samples", **override)
        for data in (Xt, X.todense()):
            solver = DiscoSolver(data, y, DiscoConfig(**kw), device="cpu")
            for name, value in override.items():
                assert getattr(solver.cfg, name) == value
            w, stats = solver._step(torch.zeros(solver._w_shape))
            assert torch.isfinite(w).all() and stats["pcg_iters"] > 0
        return
    if "pcg_block_s" in override:
        assert DiscoSolver(Xt, y, cfg, device="cpu").cfg.pcg_block_s == 2
        for m in (1, 4):
            dense = DiscoSolver(X.todense(), y, DiscoConfig(**dict(
                KW, use_kernel=True, hvp_fused=True, partition="samples",
                **override)), group=InProcessGroup(m), device="cpu")
            assert dense.cfg.pcg_block_s == 2 and len(dense._locs) == m
        return
    with pytest.raises(NotImplementedError, match="not yet ported"):
        DiscoSolver(Xt, y, cfg, device="cpu")


QUADRATIC_REL_L2 = 2e-5


@pytest.fixture(scope="module")
def jax_4device_quadratic():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               REPRO_KERNEL_MODE="interpret")
    env.pop("XLA_FLAGS", None)
    cases = [("samples", "lpt", False), ("features", "lpt", False)]
    r = subprocess.run([sys.executable, "-c", SCRIPT_4,
                        json.dumps([dict(KW, loss="quadratic"), DATA,
                                    cases])],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    line = [x for x in r.stdout.splitlines() if x.startswith("RESULT ")][-1]
    return dict(zip(("samples", "features"),
                    json.loads(line[len("RESULT "):])))


@pytest.mark.parametrize("partition", ["samples", "features"])
@pytest.mark.parametrize("m", [1, 4])
def test_quadratic_loss_matches_jax(partition, m, jax_4device_quadratic):
    """``loss='quadratic'`` with Woodbury (Figure 3's other loss): the
    same PCG iterations, ledger and partition info, and ``w`` within
    relative L2 2e-5 of the reference. Its least-squares ``w`` has
    entries near zero that move by more than atol 1e-6 in another f32
    summation order over the solve's 8-9 PCG iterations a step (at m = 4
    DiSCO-F), so the elementwise rtol / atol of the logistic tests does
    not apply."""
    X, y, Xt = _data()
    kw = dict(KW, loss="quadratic", partition=partition)
    if m == 1:
        ref = _summary(j_disco_fit(X, y, JDiscoConfig(**kw)))
    else:
        ref = jax_4device_quadratic[partition]
    got = disco_fit(Xt, y, DiscoConfig(**kw), group=InProcessGroup(m),
                    device="cpu")
    s = _summary(got)
    for k in ("pcg_iters", "ledger", "partition_info"):
        assert s[k] == ref[k], k
    w_ref = np.asarray(ref["w"], np.float32)
    assert np.linalg.norm(got.w - w_ref) <= \
        QUADRATIC_REL_L2 * np.linalg.norm(w_ref)
    assert got.grad_norms[-1] < 0.5 * got.grad_norms[0]


def test_dense_input_and_checkpoint_raise(tmp_path):
    """Dense input fits now (it raised before the dense path was ported;
    tests/test_torch_dense.py holds it to the reference): the same matrix
    dense and sparse gives the same w within rounding. Checkpointing
    raised "not yet ported" until the robustness layer was ported
    (``tests/test_torch_robust.py`` holds it to the reference): a
    checkpointed fit now writes a snapshot a step and gives the
    unchecked fit's w bit for bit."""
    X, y, Xt = _data()
    cfg = DiscoConfig(**KW)
    dense = disco_fit(X.todense(), y, cfg, device="cpu")
    sparse = disco_fit(Xt, y, cfg, device="cpu")
    np.testing.assert_allclose(dense.w, sparse.w, rtol=RTOL, atol=ATOL)
    assert dense.partition_info is None
    solver = DiscoSolver(Xt, y, cfg, device="cpu")
    ckpt = str(tmp_path / "ckpt")
    res = solver.fit(checkpoint_dir=ckpt)
    np.testing.assert_array_equal(res.w, sparse.w)
    with open(os.path.join(ckpt, "LATEST")) as f:
        assert int(f.read()) == KW["max_outer"]


def test_warm_start_roundtrip():
    """w0 goes in (and w comes out) in original feature order even when
    LPT permutes features internally."""
    _, y, Xt = _data()
    cfg = DiscoConfig(partition="features", **dict(KW, max_outer=3))
    r1 = disco_fit(Xt, y, cfg, device="cpu")
    r2 = disco_fit(Xt, y, cfg, w0=r1.w, device="cpu")
    assert r2.grad_norms[0] < r1.grad_norms[-1]
    assert r2.grad_norms[-1] <= r1.grad_norms[-1]
    assert torch.from_numpy(r2.w).isfinite().all()


def _glm_loss_problem(loss):
    """The Poisson / Huber problem of ``tests/test_hvp_operator.py``
    (12 x 120 Gaussian data, lam = 1e-3) and its f64 NumPy Newton
    optimum."""
    rng = np.random.default_rng(13)
    d, n = 12, 120
    X = (rng.standard_normal((d, n)) * 0.3).astype(np.float32)
    w_true = rng.standard_normal(d).astype(np.float32) * 0.2
    a = X.T @ w_true
    if loss == "poisson":
        y = rng.poisson(np.exp(a)).astype(np.float32)
    else:
        y = (a + 0.05 * rng.standard_normal(n)).astype(np.float32)
    Xd, yd, lam = np.asarray(X, np.float64), np.asarray(y, np.float64), 1e-3
    w = np.zeros(d)
    for _ in range(60):
        m = Xd.T @ w
        if loss == "poisson":
            d1, d2 = np.exp(m) - yd, np.exp(m)
        else:                                   # huber, delta = 1.0
            r_ = m - yd
            d1 = np.clip(r_, -1.0, 1.0)
            d2 = (np.abs(r_) <= 1.0).astype(np.float64)
        g = Xd @ d1 / n + lam * w
        H = Xd @ (d2[:, None] * Xd.T) / n + lam * np.eye(d)
        w = w - np.linalg.solve(H, g)
        if np.linalg.norm(g) < 1e-12:
            break
    return X, y, w


@pytest.mark.parametrize("loss", ["poisson", "huber"])
@pytest.mark.parametrize("kind", ["dense", "sparse"])
@pytest.mark.parametrize("partition", ["samples", "features"])
def test_glm_losses_match_jax_and_newton(loss, kind, partition):
    """Poisson and Huber ride the whole solver unchanged (the loss enters
    only through its d1/d2 coefficients): the port's solve equals the JAX
    package's (w within rtol 1e-4 / atol 1e-6, as many Newton steps, the
    same PCG iterations in every step whose gradient norm is above 1e-6;
    below that, 1e-5 of the first step's, the gradient is f32 rounding
    and the two differ in it by several percent) and ends at the f64
    Newton optimum (rel <= 1e-4)."""
    from repro.data.sparse import CSRMatrix as JCSRMatrix
    X, y, w64 = _glm_loss_problem(loss)
    kw = dict(loss=loss, partition=partition, lam=1e-3, max_outer=25,
              max_pcg=100, grad_tol=1e-7, tau=32, ell_block_d=16,
              ell_block_n=16)
    if kind == "sparse":
        Xj, Xt = JCSRMatrix.from_dense(X), CSRMatrix.from_dense(X)
    else:
        Xj = Xt = X
    ref = j_disco_fit(Xj, y, JDiscoConfig(**kw))
    got = disco_fit(Xt, y, DiscoConfig(**kw), device="cpu")
    np.testing.assert_allclose(got.w, np.asarray(ref.w), rtol=RTOL,
                               atol=ATOL)
    assert len(got.history) == len(ref.history)
    for a, b in zip(got.history, ref.history):
        if float(b["grad_norm"]) > 1e-6:
            assert a["pcg_iters"] == int(b["pcg_iters"])
    assert got.history[-1]["grad_norm"] <= 1e-5
    for w in (got.w, np.asarray(ref.w)):
        assert np.linalg.norm(w - w64) / np.linalg.norm(w64) <= 1e-4
