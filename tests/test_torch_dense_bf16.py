"""bf16 HVP tiles (``hvp_dtype='bfloat16'``) on dense input, against the
JAX package.

The same numpy inputs go through the JAX functions (Pallas kernels in
interpret mode, as the suite's conftest sets) and the port on the CPU
(the plain versions of ``repro_torch.kernels.ref``):

* the four two-pass ops (``xt_u``, ``x_cz_local``, ``xt_multi``,
  ``x_cz_multi``) on bf16 X: relative L2 <= 1e-5 (the vector operand is
  rounded to bf16 where the TPU kernels round it, so every product is of
  two bf16 values, exact in f32; only the f32 sum order differs);
* dense F10: the reference's plain layout (``X_bf16 @ u``, which
  promotes) rounds no vector and misses its interpret kernel by more than
  1e-4; the port's plain layout (``DenseOperator``) follows the former,
  its kernel layout (``DenseKernelOperator``) the latter;
* the solver: DiSCO-S and DiSCO-F at m = 1 and 2, classic and s-step
  (s = 2), ``use_kernel`` True and False, and a 3-λ path: the same PCG
  iterations, ``CommLedger`` and partition info, and ``w`` within
  relative L2 :data:`BF16_REL_W` (ROADMAP F11: at bf16 an f32-level
  difference moves a solve by up to about 2e-4 here); one Newton step
  from the reference's own state within rtol 1e-4 / atol 1e-6;
* softmax at K = 3: the same PCG iterations, one Newton step from the
  reference's state within rtol 1e-5 / atol 1e-6, and W no further from
  the reference's than twice what the reference's own solve moves when
  every element of the f32 X is nudged by one ulp (which leaves the bf16
  copy as it is): 3.5e-4 to 1.0e-3 at bf16 on this problem, against
  3e-7 at f32 (F11);
* the bf16 copy of X engaged for PCG only, none made at f32;
* ``ops.glm_hvp_multi``, ``ref.ref_glm_hvp``, ``ref.ref_glm_hvp_multi``
  and ``core.glm.glm_margins`` at f32 and bf16.

At m = 2 the reference runs in a subprocess with two forced host devices.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import DiscoConfig as JDiscoConfig
from repro.core import DiscoSolver as JDiscoSolver
from repro.core import disco_fit as j_disco_fit
from repro.core import lambda_path as jlp
from repro.core.glm import glm_margins as j_glm_margins
from repro.core.softmax import SoftmaxConfig as JSoftmaxConfig
from repro.core.softmax import SoftmaxSolver as JSoftmaxSolver
from repro.core.softmax import softmax_fit as j_softmax_fit
from repro.data.sparse import CSRMatrix as JCSRMatrix
from repro.data.synthetic import make_glm_data
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import (CSRMatrix, DiscoConfig, DiscoSolver, InProcessGroup,
                         SoftmaxConfig, SoftmaxSolver, disco_fit,
                         softmax_fit)
from repro_torch.convert import (DENSE_STATE_KEYS, SOFTMAX_STATE_KEYS,
                                 softmax_solver_from_arrays,
                                 solver_from_arrays, w_to_port)
from repro_torch.core import hvp as thvp
from repro_torch.core import lambda_path as tlp
from repro_torch.core.glm import glm_margins
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
BF16 = ml_dtypes.bfloat16
KERNEL_REL = 1e-5
RTOL, ATOL = 1e-4, 1e-6
# the whole solve: 1.5x the largest distance of the port's bf16 solve from
# the reference's among these cells (2.03e-4, DiSCO-F m = 1, s = 2 on the
# kernels' layout), against 1.6e-7 on the plain layout, which rounds no
# vector (F11)
BF16_REL_W = 3e-4
# tests/test_kernels.py:25's shapes, and one above the 512-block
SHAPES = [(64, 64), (100, 237), (33, 1), (1, 129), (600, 700)]
MULTI_S = [1, 2, 3, 4, 5, 6, 7, 8, 13]
KW = dict(loss="logistic", lam=1e-3, tau=100, max_outer=4, grad_tol=0.0,
          hvp_dtype="bfloat16")
DATA = dict(d=98, n=202, seed=1)


def _rel(got, ref) -> float:
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - ref)
                 / np.linalg.norm(ref))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bf(X):
    """The same bf16 X for both packages: ml_dtypes bf16 for JAX, a torch
    bf16 tensor for the port (both round to nearest even)."""
    return X.astype(BF16), _t(X).to(torch.bfloat16)


def _dense(shape, seed):
    d, n = shape
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((d, n)) / np.sqrt(d)).astype(np.float32)
    c = rng.uniform(0.0, 0.25, n).astype(np.float32)
    return rng, X, c


def _shape_id(shape):
    return "x".join(map(str, shape))


# ---------------------------------------------------------------------------
# the four ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
@pytest.mark.parametrize("with_c", [False, True])
def test_xt_u_and_x_cz_bf16_match_jax(shape, with_c):
    rng, X, c = _dense(shape, sum(shape))
    d, n = shape
    u = rng.standard_normal(d).astype(np.float32)
    z = rng.standard_normal(n).astype(np.float32)
    jX, tX = _bf(X)
    got = tops.xt_u(tX, _t(u))
    assert got.dtype == torch.float32 and got.shape == (n,)
    assert _rel(got.numpy(), jops.xt_u(jX, u)) <= KERNEL_REL
    # the reference's x_cz_local always scales; ones is its "no c"
    want = jops.x_cz_local(jX, c if with_c else np.ones_like(c), z)
    got = tops.x_cz_local(tX, _t(c) if with_c else None, _t(z))
    assert got.dtype == torch.float32 and got.shape == (d,)
    assert _rel(got.numpy(), want) <= KERNEL_REL


@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
@pytest.mark.parametrize("s", MULTI_S)
@pytest.mark.parametrize("with_c", [False, True])
def test_multi_bf16_match_jax(shape, s, with_c):
    rng, X, c = _dense(shape, 10 * s + with_c)
    d, n = shape
    U = rng.standard_normal((d, s)).astype(np.float32)
    Z = rng.standard_normal((n, s)).astype(np.float32)
    jX, tX = _bf(X)
    got = tops.xt_multi(tX, _t(U))
    assert got.dtype == torch.float32 and got.shape == (n, s)
    assert _rel(got.numpy(), jops.xt_multi(jX, U)) <= KERNEL_REL
    want = jops.x_cz_multi(jX, c if with_c else np.ones_like(c), Z)
    got = tops.x_cz_multi(tX, _t(c) if with_c else None, _t(Z))
    assert got.dtype == torch.float32 and got.shape == (d, s)
    assert _rel(got.numpy(), want) <= KERNEL_REL


def test_f10_dense_plain_layout_misses_the_kernel_at_bf16():
    """Dense F10: the reference's plain layout (``X_bf16.T @ u``; jnp
    promotes, so X is upcast and u is not rounded) misses its own
    interpret kernel (u rounded to bf16) by more than 1e-4. The port's
    ``DenseOperator`` matches the former and ``DenseKernelOperator`` (its
    plain versions here) the latter, each within 1e-5."""
    rng, X, c = _dense((100, 237), 5)
    u = rng.standard_normal(100).astype(np.float32)
    z = rng.standard_normal(237).astype(np.float32)
    jX, tX = _bf(X)
    pairs = {
        "pass_a": (np.asarray(jnp.asarray(jX).T @ u),
                   np.asarray(jops.xt_u(jX, u)), _t(u)),
        "pass_b": (np.asarray(jnp.asarray(jX) @ (c * z)),
                   np.asarray(jops.x_cz_local(jX, c, z)), _t(z)),
    }
    plain = thvp.DenseOperator(tX, _t(c))
    kernel = thvp.DenseKernelOperator(tX, _t(c))
    for name, (j_plain, j_kernel, v) in pairs.items():
        assert _rel(j_plain, j_kernel) > 1e-4
        assert _rel(getattr(plain, name)(v).numpy(), j_plain) <= KERNEL_REL
        assert _rel(getattr(kernel, name)(v).numpy(), j_kernel) <= KERNEL_REL
    # at f32 the two layouts agree
    X32 = _t(X)
    assert _rel(thvp.DenseOperator(X32, None).pass_a(_t(u)).numpy(),
                thvp.DenseKernelOperator(X32, None).pass_a(_t(u)).numpy()) \
        <= KERNEL_REL


def test_plain_dense_layout_upcasts_by_row_blocks(monkeypatch):
    """The plain layout at bf16 upcasts X a block of rows at a time; with
    blocks of 3 rows its passes equal the reference's plain products."""
    rng, X, c = _dense((100, 237), 6)
    jX, tX = _bf(X)
    monkeypatch.setattr(thvp, "UPCAST_ELEMS", 3 * 237)
    assert len(list(thvp._upcast_rows(tX))) == 34
    op = thvp.DenseOperator(tX, _t(c))
    u = rng.standard_normal(100).astype(np.float32)
    U = rng.standard_normal((100, 3)).astype(np.float32)
    Z = rng.standard_normal((237, 3)).astype(np.float32)
    Xf = jnp.asarray(jX)
    for got, want in (
            (op.pass_a(_t(u)), Xf.T @ u),
            (op.pass_a_multi(_t(U)), Xf.T @ U),
            (op.pass_b_multi(_t(Z)), Xf @ (c[:, None] * Z))):
        assert got.dtype == torch.float32
        assert _rel(got.numpy(), np.asarray(want)) <= KERNEL_REL


# ---------------------------------------------------------------------------
# the solver
# ---------------------------------------------------------------------------

# partition, pcg_block_s, use_kernel
CELLS = [(p, s, uk) for p in ("samples", "features") for s in (1, 2)
         for uk in (False, True)]


def cell_id(cell):
    p, s, uk = cell
    return f"{p}-s{s}-{'kernel' if uk else 'matmul'}"


def _cfg(cell, **kw):
    partition, s, use_kernel = cell
    return dict(KW, partition=partition, pcg_block_s=s,
                use_kernel=use_kernel, **kw)


def _summary(res) -> dict:
    led = res.ledger
    return dict(w=np.asarray(res.w).tolist(),
                pcg_iters=[int(h["pcg_iters"]) for h in res.history],
                ledger=[led.rounds, led.floats, led.spmd_collectives],
                partition_info=res.partition_info)


def _assert_matches(got, ref: dict):
    s = _summary(got)
    assert s["pcg_iters"] == ref["pcg_iters"]
    assert min(s["pcg_iters"]) >= 1
    assert s["ledger"] == ref["ledger"]
    assert s["partition_info"] == ref["partition_info"]
    assert _rel(got.w, ref["w"]) <= BF16_REL_W


@pytest.mark.parametrize("cell", CELLS, ids=cell_id)
def test_dense_bf16_solve_matches_jax(cell):
    X, y, _ = make_glm_data(**DATA)
    ref = _summary(j_disco_fit(X, y, JDiscoConfig(**_cfg(cell))))
    got = disco_fit(X, y, DiscoConfig(**_cfg(cell)), device="cpu")
    _assert_matches(got, ref)
    assert got.grad_norms[-1] < 0.1 * got.grad_norms[0]


SCRIPT_2 = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax
    import numpy as np
    assert len(jax.devices()) == 2
    from repro.core import DiscoConfig, disco_fit
    from repro.data.synthetic import make_glm_data
    KWS, DATA = json.loads(sys.argv[1])
    X, y, _ = make_glm_data(**DATA)
    out = []
    for kw in KWS:
        axis = "model" if kw["partition"] == "features" else "data"
        r = disco_fit(X, y, DiscoConfig(**kw),
                      mesh=jax.make_mesh((2,), (axis,)))
        led = r.ledger
        out.append(dict(w=np.asarray(r.w).tolist(),
                        pcg_iters=[int(h["pcg_iters"]) for h in r.history],
                        ledger=[led.rounds, led.floats,
                                led.spmd_collectives],
                        partition_info=r.partition_info))
    print("RESULT " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def jax_2device_runs():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               REPRO_KERNEL_MODE="interpret")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", SCRIPT_2,
                        json.dumps([[_cfg(c) for c in CELLS], DATA])],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    line = [x for x in r.stdout.splitlines() if x.startswith("RESULT ")][-1]
    return dict(zip(CELLS, json.loads(line[len("RESULT "):])))


@pytest.mark.parametrize("cell", CELLS, ids=cell_id)
def test_dense_bf16_solve_2shards_matches_jax(jax_2device_runs, cell):
    X, y, _ = make_glm_data(**DATA)
    got = disco_fit(X, y, DiscoConfig(**_cfg(cell)),
                    group=InProcessGroup(2), device="cpu")
    _assert_matches(got, jax_2device_runs[cell])


@pytest.mark.parametrize("partition", ["samples", "features"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_dense_bf16_step_from_reference_state_matches_jax(partition,
                                                         use_kernel):
    """One Newton step from the JAX solver's own arrays and a random
    iterate: w_new and the step's stats within rtol 1e-4 / atol 1e-6, the
    same PCG iterations. The port casts its own bf16 copy of the f32 X,
    which equals the reference's ``X_hvp`` bit for bit."""
    X, y, _ = make_glm_data(**DATA)
    kw = _cfg((partition, 1, use_kernel))
    js = JDiscoSolver(X, y, JDiscoConfig(**kw))
    arrays = {k: np.asarray(getattr(js, k))
              for k in DENSE_STATE_KEYS[partition]}
    ps = solver_from_arrays(arrays, X.shape, DiscoConfig(**kw), m=js.m,
                            device="cpu")
    assert np.array_equal(ps.X_h.float().numpy(),
                          np.asarray(js.X_hvp).astype(np.float32))
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


def test_dense_bf16_copy_engaged_and_f32_makes_no_copy():
    """PCG's shards are views of one bf16 copy of X, the margins' and the
    gradient's views of the f32 X; ``with_lam`` shares the copy; at f32
    PCG's shards are the margins' (no copy), for DiscoSolver and
    SoftmaxSolver alike."""
    X, y, _ = make_glm_data(**DATA)
    labels = (y > 0).astype(np.int64)
    for partition in ("samples", "features"):
        solvers = [
            DiscoSolver(X, y, DiscoConfig(partition=partition,
                                          use_kernel=True,
                                          hvp_dtype="bfloat16"),
                        group=InProcessGroup(2), device="cpu"),
            SoftmaxSolver(X, labels, SoftmaxConfig(partition=partition,
                                                   use_kernel=True,
                                                   hvp_dtype="bfloat16"),
                          group=InProcessGroup(2), device="cpu")]
        for s in solvers:
            assert s.X.dtype == torch.float32
            assert s.X_h.dtype == torch.bfloat16
            assert torch.equal(s.X_h, s.X.to(torch.bfloat16))
            base = s.X_h.untyped_storage().data_ptr()
            for loc, hloc in zip(s._locs, s._hvp_locs):
                assert loc.dtype == torch.float32
                assert hloc.dtype == torch.bfloat16
                assert hloc.untyped_storage().data_ptr() == base
                assert hloc.shape == loc.shape
                assert hloc.stride() == loc.stride()
        lam2 = solvers[0].with_lam(1e-3)
        assert lam2.X_h is solvers[0].X_h
        assert lam2._hvp_locs is solvers[0]._hvp_locs
        for s in (DiscoSolver(X, y, DiscoConfig(partition=partition),
                              group=InProcessGroup(2), device="cpu"),
                  SoftmaxSolver(X, labels, SoftmaxConfig(partition=partition),
                                group=InProcessGroup(2), device="cpu")):
            assert s.X_h is s.X
            assert s._hvp_locs is s._locs


# softmax: partition, pcg_block_s, use_kernel
SOFTMAX_DATA = dict(d=10, n=81, K=3, seed=11)
SOFTMAX_KW = dict(lam=1e-3, max_outer=5, grad_tol=0.0, tau=24,
                  hvp_dtype="bfloat16")


def _softmax_data(d, n, K, seed):
    """``tests/test_torch_softmax.py``'s problem."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((d, n)).astype(np.float32)
    W = rng.standard_normal((d, K)).astype(np.float32)
    y = np.argmax(X.T @ W + 2.0 * rng.standard_normal((n, K)), axis=1)
    return X, y


def _softmax_kw(cell) -> dict:
    partition, s, use_kernel = cell
    return dict(SOFTMAX_KW, partition=partition, pcg_block_s=s,
                use_kernel=use_kernel)


@pytest.mark.parametrize("cell", CELLS, ids=cell_id)
def test_softmax_bf16_matches_jax(cell):
    """Softmax at K = 3 on bf16 tiles: the same PCG iterations (or
    rounds) every step, and W no further from the reference's
    interpret-mode solve than :data:`BF16_REL_W` or twice the distance
    that solve moves when the f32 X is nudged by one ulp, whichever is
    larger (F11; the nudge leaves the bf16 copy as it is, and moves the
    kernels' solve, which rounds the vectors, by more than 1e-5)."""
    X, y = _softmax_data(**SOFTMAX_DATA)
    kw = _softmax_kw(cell)
    ref = j_softmax_fit(X, y, JSoftmaxConfig(**kw))
    X_nudged = np.nextafter(X, np.float32(np.inf))
    assert np.array_equal(X.astype(BF16), X_nudged.astype(BF16))
    spread = _rel(j_softmax_fit(X_nudged, y, JSoftmaxConfig(**kw)).W, ref.W)
    got = softmax_fit(X, y, SoftmaxConfig(**kw), device="cpu")
    iters = [int(h["pcg_iters"]) for h in got.history]
    assert iters == [int(h["pcg_iters"]) for h in ref.history]
    assert min(iters) > 1
    # the plain layout rounds no vector: the nudge moves it at f32 level
    assert spread < 2e-3 and (spread > 1e-5) == kw["use_kernel"]
    assert _rel(got.W, np.asarray(ref.W)) <= max(BF16_REL_W, 2 * spread)
    assert got.grad_norms[-1] < 0.1 * got.grad_norms[0]


@pytest.mark.parametrize("partition", ["samples", "features"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_softmax_bf16_step_from_reference_state_matches_jax(partition,
                                                           use_kernel):
    """A JAX SoftmaxSolver's arrays at bf16, carried over, give the same
    Newton step (s-step, s = 2): W within rtol 1e-5 / atol 1e-6, the same
    rounds and statistics."""
    X, y = _softmax_data(**SOFTMAX_DATA)
    kw = _softmax_kw((partition, 2, use_kernel))
    js = JSoftmaxSolver(X, y, JSoftmaxConfig(**kw))
    arrays = {k: np.asarray(getattr(js, k))
              for k in SOFTMAX_STATE_KEYS[partition]}
    ps = softmax_solver_from_arrays(arrays, X.shape, SoftmaxConfig(**kw),
                                    device="cpu")
    assert np.array_equal(ps.X_h.float().numpy(),
                          np.asarray(js.X_hvp).astype(np.float32))
    W = (0.1 * np.random.default_rng(7).standard_normal(
        (js.d_padded, js.K))).astype(np.float32)
    jW, jstats = js._step(jnp.asarray(W))
    Wt = _t(W)
    if partition == "features":
        Wt = Wt.reshape(1, -1, js.K)
    pW, pstats = ps._step(Wt)
    np.testing.assert_allclose(pW.reshape(W.shape).numpy(), np.asarray(jW),
                               rtol=1e-5, atol=1e-6)
    assert pstats["pcg_iters"] == int(jstats["pcg_iters"]) > 1
    for k in ("grad_norm", "f", "delta", "pcg_r_norm"):
        np.testing.assert_allclose(float(pstats[k]), float(jstats[k]),
                                   rtol=1e-5)


# λ-path: partition, use_kernel, pcg_block_s (two-pass)
PATH_VARIANTS = [("samples", True, 1), ("features", True, 1),
                 ("features", True, 2), ("samples", False, 1)]
LAMBDAS = [1e-4, 1e-2, 1e-3]


def _iters(res):
    return [int(h["pcg_iters"]) for h in res.history]


@pytest.mark.parametrize("variant", PATH_VARIANTS,
                         ids=lambda v: f"{v[0]}-"
                         f"{'kernel' if v[1] else 'matmul'}-s{v[2]}")
def test_lambda_path_bf16_matches_jax(variant):
    """A warm 3-λ path on bf16 tiles (two-pass): the grid, the best λ and
    the validation losses (rtol 1e-4) equal. Each solve's PCG iterations
    equal the reference's wherever the reference's own counts stay put
    when every element of the f32 X is nudged by one ulp (the same bf16
    copy); at λ = 1e-4 on the kernels' layout they do not (a count at
    PCG's threshold follows f32-level differences once the vectors are
    rounded, F11), and there ``w`` alone is held. Every ``w`` within
    relative L2 :data:`BF16_REL_W` or twice the nudge's distance,
    whichever is larger; the X-pass ledger equal when every count is."""
    X, y, _ = make_glm_data(**DATA)
    Xv, yv, _ = make_glm_data(d=98, n=150, seed=2)
    partition, use_kernel, s = variant
    kw = dict(KW, max_outer=8, grad_tol=1e-6, partition=partition,
              use_kernel=use_kernel, pcg_block_s=s)
    ref, nudged = (jlp.lambda_path_fit(A, y, LAMBDAS, JDiscoConfig(**kw),
                                       X_val=Xv, y_val=yv)
                   for A in (X, np.nextafter(X, np.float32(np.inf))))
    got = tlp.lambda_path_fit(X, y, LAMBDAS, DiscoConfig(**kw), X_val=Xv,
                              y_val=yv, device="cpu")
    assert got.lambdas == ref.lambdas
    assert got.best_lambda == ref.best_lambda
    np.testing.assert_allclose(got.val_losses, ref.val_losses, rtol=1e-4)
    stable = 0
    for g, r, rn in zip(got.results, ref.results, nudged.results):
        if _iters(r) == _iters(rn):
            assert _iters(g) == _iters(r)
            stable += 1
        tol = max(BF16_REL_W, 2 * _rel(rn.w, np.asarray(r.w)))
        assert _rel(g.w, np.asarray(r.w)) <= tol
    assert stable >= 2
    if stable == len(LAMBDAS):
        assert got.x_passes == ref.x_passes


# ---------------------------------------------------------------------------
# the public surface: glm_hvp_multi, the HVP oracles, glm_margins
# ---------------------------------------------------------------------------

DTYPES = ["float32", "bfloat16"]


def _both(X, dtype):
    if dtype == "float32":
        return X, _t(X)
    return _bf(X)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("s", [1, 5, 13])
def test_glm_hvp_multi_matches_jax(dtype, fused, s):
    """``ops.glm_hvp_multi`` against ``repro.kernels.ops.glm_hvp_multi``
    (interpret mode, rounding where the TPU kernels round), within 1e-5."""
    rng, X, c = _dense((100, 237), s + fused)
    U = rng.standard_normal((100, s)).astype(np.float32)
    jX, tX = _both(X, dtype)
    want = jops.glm_hvp_multi(jX, c, U, 1e-3, fused=fused)
    got = tops.glm_hvp_multi(tX, _t(c), _t(U), 1e-3, fused=fused)
    assert got.dtype == torch.float32 and got.shape == (100, s)
    assert _rel(got.numpy(), want) <= KERNEL_REL


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_global", [None, 1000])
def test_hvp_oracles_match_jax(dtype, n_global):
    """``ref.ref_glm_hvp`` and ``ref.ref_glm_hvp_multi`` against the JAX
    oracles (X upcast, no vector rounded), within 1e-5."""
    rng, X, c = _dense((100, 237), 9)
    u = rng.standard_normal(100).astype(np.float32)
    U = rng.standard_normal((100, 4)).astype(np.float32)
    jX, tX = _both(X, dtype)
    for got, want in (
            (tref.ref_glm_hvp(tX, _t(c), _t(u), 1e-3, n_global),
             jref.ref_glm_hvp(jX, c, u, 1e-3, n_global)),
            (tref.ref_glm_hvp_multi(tX, _t(c), _t(U), 1e-3, n_global),
             jref.ref_glm_hvp_multi(jX, c, U, 1e-3, n_global))):
        assert got.dtype == torch.float32
        assert _rel(got.numpy(), want) <= KERNEL_REL


def test_glm_margins_matches_jax():
    """``core.glm.glm_margins`` on a dense array, a tensor and a CSR
    matrix, against ``repro.core.glm.glm_margins`` (rtol 1e-6)."""
    rng, X, _ = _dense((100, 237), 4)
    X[np.abs(X) < 0.1] = 0.0
    w = rng.standard_normal(100).astype(np.float32)
    want = np.asarray(j_glm_margins(X, w))
    for got in (glm_margins(X, w), glm_margins(_t(X), w)):
        assert isinstance(got, np.ndarray) and got.shape == (237,)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    jcsr = JCSRMatrix.from_dense(X)
    csr = CSRMatrix(jcsr.indptr, jcsr.indices, jcsr.data, jcsr.shape)
    got = glm_margins(csr, w)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, j_glm_margins(jcsr, w))
