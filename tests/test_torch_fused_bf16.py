"""The one-pass dense kernels (K5 ``x_c_xt_u``, K10 ``x_c_xt_multi``) on
bf16 tiles (``hvp_fused=True, hvp_dtype='bfloat16'`` on dense input),
against the JAX package.

The same numpy inputs go through the JAX functions (Pallas kernels in
interpret mode, as the suite's conftest sets) and the port on the CPU
(the plain versions of ``repro_torch.kernels.ref``):

* the two one-pass ops on bf16 X at ``tests/test_torch_dense_bf16.py``'s
  shapes and column counts, with and without c (c = 1 on the JAX side):
  relative L2 <= 1e-5 end to end; where an element of the hand-off
  ``c .* z`` lies within f32 rounding of a bf16 tie, the two packages'
  summation orders may round it either way (ROADMAP F11), and the call is
  held in its two halves instead: the port's rounded hand-off against the
  reference's pass A (``ref.dense_handoff_flips``), and the reference's
  output against the plain pass B of that hand-off (1e-5);
* the solver: fused DiSCO-S and DiSCO-F at s = 1 and 2, at m = 1 and 2,
  against the reference's ``disco_fit``: the same PCG iterations,
  ``CommLedger`` and partition info, and ``w`` within relative L2
  :data:`BF16_REL_W` (F11); one Newton step from the reference's own state
  within rtol 1e-4 / atol 1e-6; a warm 3-λ path under
  ``test_lambda_path_bf16_matches_jax``'s acceptance; Poisson and Huber;
* on the CPU a fused bf16 solve is, bit for bit, the two-pass bf16 solve
  (the plain one-pass versions are the two-pass chains);
* the fit rule at bf16: every plan fits one CTA's shared memory, mirrors
  the header's layout, and reaches as far as the f32 rule
  (``tests/test_torch_fused_schedule.py`` covers the exchange's partials
  a thread, two from s = 5 on at bf16's 64-column panels).

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
from repro.data.synthetic import make_glm_data
from repro.kernels import ops as jops
from repro_torch import DiscoConfig, DiscoSolver, InProcessGroup, disco_fit
from repro_torch.convert import (DENSE_STATE_KEYS, solver_from_arrays,
                                 w_to_port)
from repro_torch.core import hvp as thvp
from repro_torch.core import lambda_path as tlp
from repro_torch.kernels import build, glm_hvp
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
BF16 = ml_dtypes.bfloat16
KERNEL_REL = 1e-5
RTOL, ATOL = 1e-4, 1e-6
# the whole solve, as tests/test_torch_dense_bf16.py holds the two-pass
# one (F11: at bf16 an f32-level difference moves a solve by up to about
# 2e-4 here)
BF16_REL_W = 3e-4
SHAPES = [(64, 64), (100, 237), (33, 1), (1, 129), (600, 700)]
MULTI_S = [1, 2, 3, 4, 5, 6, 7, 8, 13]
KW = dict(loss="logistic", lam=1e-3, tau=100, max_outer=4, grad_tol=0.0,
          hvp_dtype="bfloat16", use_kernel=True, hvp_fused=True)
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
# the two ops
# ---------------------------------------------------------------------------

def _held(got, want, tX, c, U, jX):
    """The port's one-pass op ``got`` against the reference's ``want``:
    within 1e-5 end to end, or, where a tie of the hand-off rounds either
    way, in halves. Returns the number of hand-off elements that differ
    from the reference pass A's rounding."""
    if _rel(got, want) <= KERNEL_REL:
        return 0
    Ut = _t(U)
    t = tref.ref_dense_handoff(tX, c, Ut)
    slack = tref.dense_handoff_slack(tX, c, Ut, t)
    zj = _t(np.array(jops.xt_u(jX, U) if U.ndim == 1
                     else jops.xt_multi(jX, U)))
    tj = zj if c is None else (c * zj if U.ndim == 1 else c[:, None] * zj)
    flips, ok = tref.dense_handoff_flips(t.to(torch.bfloat16).float(), tj,
                                         slack)
    assert ok and flips >= 1 and tref.handoff_rate_ok(flips, t.numel())
    czj = tj.to(torch.bfloat16).float()
    pass_b = (tref.ref_x_cz(tX, czj) if U.ndim == 1
              else tref.ref_x_cz_multi(tX, None, czj))
    assert _rel(want, pass_b.numpy()) <= KERNEL_REL
    return flips


@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
@pytest.mark.parametrize("with_c", [False, True])
def test_x_c_xt_u_bf16_matches_jax(shape, with_c):
    rng, X, c = _dense(shape, sum(shape) + 3)
    d, n = shape
    u = rng.standard_normal(d).astype(np.float32)
    jX, tX = _bf(X)
    want = np.asarray(jops.x_c_xt_u(jX, c if with_c else np.ones_like(c),
                                    u))
    cc = _t(c) if with_c else None
    got = tops.x_c_xt_u(tX, cc, _t(u))
    assert got.dtype == torch.float32 and got.shape == (d,)
    _held(got.numpy(), want, tX, cc, u, jX)


@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
@pytest.mark.parametrize("s", MULTI_S)
@pytest.mark.parametrize("with_c", [False, True])
def test_x_c_xt_multi_bf16_matches_jax(shape, s, with_c):
    rng, X, c = _dense(shape, 10 * s + with_c + 7)
    d, n = shape
    U = rng.standard_normal((d, s)).astype(np.float32)
    jX, tX = _bf(X)
    want = np.asarray(jops.x_c_xt_multi(
        jX, c if with_c else np.ones_like(c), U))
    cc = _t(c) if with_c else None
    got = tops.x_c_xt_multi(tX, cc, _t(U))
    assert got.dtype == torch.float32 and got.shape == (d, s)
    _held(got.numpy(), want, tX, cc, U, jX)


def test_dense_handoff_criterion():
    """The halves' criterion (``ref.dense_handoff_flips``, with the rate
    of ``ref.handoff_rate_ok``): the plain rounding agrees; the other
    neighbour of an element lying within the slack of a tie agrees; so
    does a small result several bf16 steps off where its products cancel
    within the slack; a rounding toward zero (about half the elements
    off), or one step off where no tie is near, does not."""
    rng, X, c = _dense((600, 700), 21)
    U = rng.standard_normal((600, 3)).astype(np.float32)
    _, tX = _bf(X)
    Ut, ct = _t(U), _t(c)
    t = tref.ref_dense_handoff(tX, ct, Ut)
    slack = tref.dense_handoff_slack(tX, ct, Ut, t)
    cz = t.to(torch.bfloat16).float()
    assert tref.dense_handoff_flips(cz, t, slack) == (0, True)
    # an element moved onto a tie: its other neighbour is a legal rounding
    bits = cz.to(torch.bfloat16).view(torch.int16)
    up = (bits + 1).view(torch.bfloat16).float()
    tied = t.clone()
    tied[0, 0] = (cz[0, 0] + up[0, 0]) / 2
    other = cz.clone()
    other[0, 0] = up[0, 0]
    assert tref.dense_handoff_flips(other, tied, slack) == (1, True)
    assert not tref.dense_handoff_flips(other, t, slack)[1]  # not a tie
    # a cancelled element: within the slack, several small steps away
    small = t.clone()
    small[1, 1] = 0.25 * slack[1, 1]
    moved = small.to(torch.bfloat16).float()
    moved[1, 1] = -0.5 * slack[1, 1]
    moved = moved.to(torch.bfloat16).float()
    assert tref.dense_handoff_flips(moved, small, slack) == (1, True)
    toward_zero = t.to(torch.bfloat16).float()
    trunc = (t.view(torch.int32) & ~0xFFFF).view(torch.float32)
    flips, ok = tref.dense_handoff_flips(trunc, t, slack)
    assert flips > 100 and not ok
    assert not tref.handoff_rate_ok(flips, t.numel())
    assert tref.handoff_rate_ok(3, 2100) and not tref.handoff_rate_ok(4, 2100)
    assert not tref.dense_handoff_flips(toward_zero + 1e-7, t, slack)[1]


# ---------------------------------------------------------------------------
# the solver
# ---------------------------------------------------------------------------

# partition, pcg_block_s
CELLS = [(p, s) for p in ("samples", "features") for s in (1, 2)]


def cell_id(cell):
    return f"{cell[0]}-s{cell[1]}"


def _cfg(cell, **kw):
    partition, s = cell
    return dict(KW, partition=partition, pcg_block_s=s, **kw)


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
def test_fused_bf16_solve_matches_jax(cell):
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
def test_fused_bf16_solve_2shards_matches_jax(jax_2device_runs, cell):
    X, y, _ = make_glm_data(**DATA)
    got = disco_fit(X, y, DiscoConfig(**_cfg(cell)),
                    group=InProcessGroup(2), device="cpu")
    _assert_matches(got, jax_2device_runs[cell])


@pytest.mark.parametrize("partition", ["samples", "features"])
def test_fused_bf16_step_from_reference_state_matches_jax(partition):
    """One fused Newton step from the JAX solver's own arrays and a
    random iterate: w_new and the step's stats within rtol 1e-4 / atol
    1e-6, the same PCG iterations; the port's bf16 copy of the f32 X
    equals the reference's ``X_hvp`` bit for bit."""
    X, y, _ = make_glm_data(**DATA)
    kw = _cfg((partition, 1))
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


# λ-path: partition, pcg_block_s (fused)
PATH_VARIANTS = [("samples", 1), ("samples", 2), ("features", 1)]
LAMBDAS = [1e-4, 1e-2, 1e-3]


def _iters(res):
    return [int(h["pcg_iters"]) for h in res.history]


@pytest.mark.parametrize("variant", PATH_VARIANTS,
                         ids=lambda v: f"{v[0]}-s{v[1]}")
def test_fused_lambda_path_bf16_matches_jax(variant):
    """A warm 3-λ path on the one-pass kernels at bf16 tiles, under
    ``test_lambda_path_bf16_matches_jax``'s acceptance: the grid, the best
    λ and the validation losses (rtol 1e-4) equal; each solve's PCG
    iterations equal the reference's wherever the reference's own counts
    stay put when every element of the f32 X is nudged by one ulp (the
    same bf16 copy); every ``w`` within relative L2 :data:`BF16_REL_W` or
    twice the nudge's distance, whichever is larger; the X-pass ledger
    equal when every count is."""
    X, y, _ = make_glm_data(**DATA)
    Xv, yv, _ = make_glm_data(d=98, n=150, seed=2)
    partition, s = variant
    kw = dict(KW, max_outer=8, grad_tol=1e-6, partition=partition,
              pcg_block_s=s)
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


def _glm_loss_problem(loss):
    """``tests/test_torch_disco.py``'s Poisson / Huber problem (12 x 120
    Gaussian data)."""
    rng = np.random.default_rng(13)
    d, n = 12, 120
    X = (rng.standard_normal((d, n)) * 0.3).astype(np.float32)
    w_true = rng.standard_normal(d).astype(np.float32) * 0.2
    a = X.T @ w_true
    if loss == "poisson":
        y = rng.poisson(np.exp(a)).astype(np.float32)
    else:
        y = (a + 0.05 * rng.standard_normal(n)).astype(np.float32)
    return X, y


@pytest.mark.parametrize("loss", ["poisson", "huber"])
@pytest.mark.parametrize("partition", ["samples", "features"])
def test_fused_bf16_glm_losses_match_jax(loss, partition):
    """Poisson and Huber on the one-pass kernels at bf16 tiles: as many
    Newton steps as the reference, the same PCG iterations in every step
    whose gradient norm is above 1e-6, and w within relative L2
    :data:`BF16_REL_W`."""
    X, y = _glm_loss_problem(loss)
    kw = dict(KW, loss=loss, partition=partition, max_outer=25,
              max_pcg=100, grad_tol=1e-7, tau=32)
    ref = j_disco_fit(X, y, JDiscoConfig(**kw))
    got = disco_fit(X, y, DiscoConfig(**kw), device="cpu")
    assert _rel(got.w, np.asarray(ref.w)) <= BF16_REL_W
    assert len(got.history) == len(ref.history)
    for a, b in zip(got.history, ref.history):
        if float(b["grad_norm"]) > 1e-6:
            assert a["pcg_iters"] == int(b["pcg_iters"])
    assert got.grad_norms[-1] < 1e-3 * got.grad_norms[0]


@pytest.mark.parametrize("partition", ["samples", "features"])
@pytest.mark.parametrize("m,s", [(1, 1), (2, 1), (1, 2), (2, 3)])
def test_fused_bf16_equals_two_pass_on_the_cpu(partition, m, s):
    """On the CPU the plain one-pass versions are the two-pass chains, so
    a fused bf16 solve is the two-pass bf16 solve bit for bit, and
    launches no kernel."""
    X, y, _ = make_glm_data(**DATA)
    build.reset_launch_counts()
    runs = [disco_fit(X, y, DiscoConfig(**dict(
                _cfg((partition, s)), hvp_fused=fused)),
                group=InProcessGroup(m), device="cpu")
            for fused in (True, False)]
    assert np.array_equal(runs[0].w, runs[1].w)
    assert _iters(runs[0]) == _iters(runs[1])
    assert not any(build.launch_counts().values())


def test_fused_bf16_solver_engages_the_copy():
    """The fused bf16 solver's PCG shards are views of one bf16 copy of
    X, its local operators the fused kernel operator on them;
    ``with_lam`` shares the copy."""
    X, y, _ = make_glm_data(**DATA)
    for partition, m in (("samples", 2), ("features", 1)):
        s = DiscoSolver(X, y, DiscoConfig(**_cfg((partition, 1))),
                        group=InProcessGroup(m), device="cpu")
        assert s.X.dtype == torch.float32 and s.X_h.dtype == torch.bfloat16
        base = s.X_h.untyped_storage().data_ptr()
        for h in s._hvp_locs:
            assert h.dtype == torch.bfloat16
            assert h.untyped_storage().data_ptr() == base
            op = thvp.make_local_operator(h, None, use_kernel=True,
                                          fused=True, partition=partition)
            assert isinstance(op, thvp.DenseKernelOperator) and op.fused
        lam2 = s.with_lam(1e-2)
        assert lam2.X_h is s.X_h and lam2._hvp_locs is s._hvp_locs


# ---------------------------------------------------------------------------
# the fit rule at bf16
# ---------------------------------------------------------------------------

COLUMNS = list(range(1, build.MAX_COLS + 1))
DS = [1, 5, 200, 256, 257, 1000, 1024, 2048, 4095, 4096, 4097, 6144, 6145,
      8192, 8193, 9000, 10_240, 10_241, 11_000, 12_288, 12_289, 20_000]
BF = torch.bfloat16


def _header_layout(s, bn, rows, stages, esize):
    """``layout`` of ``csrc/fused_stream.cuh``, written out again: the
    barriers, four exchange slots, eight warps' partials and cz of bn x s
    f32 each, U's slice at padded(s) f32 a row, then the ring at esize
    bytes an element."""
    up = lambda x: -(-x // 128) * 128
    e = bn * s * 4
    return (128 + up(4 * e) + up(8 * e) + up(e)
            + up(rows * glm_hvp.fused_padded(s) * 4)
            + stages * rows * bn * esize)


@pytest.mark.parametrize("s", COLUMNS)
def test_bf16_plans_fit_and_mirror_the_header(s):
    for d in DS:
        plan = glm_hvp.fused_plan(d, s, dtype=BF)
        f32 = glm_hvp.fused_plan(d, s)
        assert (plan is None) == (f32 is None), d
        if plan is None:
            continue
        assert plan.bn in glm_hvp.FUSED_WIDTHS_BY_DTYPE[BF]
        assert plan.cluster in glm_hvp.CLUSTER_SIZES
        assert 2 <= plan.stages <= glm_hvp.FUSED_MAX_STAGES
        assert plan.groups <= glm_hvp.fused_max_groups(s)
        smem = glm_hvp.fused_smem_bytes(plan.rows, plan.bn, plan.stages, s,
                                        BF)
        assert smem == _header_layout(s, plan.bn, plan.rows, plan.stages, 2)
        assert smem <= glm_hvp.SMEM_LIMIT
        # a stage of bf16 is half the f32 bytes of the same panel
        assert smem - glm_hvp.fused_smem_bytes(plan.rows, plan.bn, 0, s,
                                               BF) == \
            plan.stages * plan.rows * plan.bn * 2
        if s <= 5:     # the f32 plan with the panel twice as wide
            assert plan == f32._replace(bn=2 * f32.bn)
    assert glm_hvp.fused_plan(4096, s, dtype=BF) == (
        glm_hvp.FusedPlan(8, 64, 3, 512) if s <= 5
        else glm_hvp.FusedPlan(8, 32, 4, 512))


def test_bf16_fit_rule_reach():
    """The bf16 rule reaches as far as the f32 rule, set by the rows a
    thread's registers hold: 12,288 at s = 1, 10,240 at 2 and 3, 8,192
    at 4 and 5, 6,144 from 6 on; other tile types are refused."""
    for s, limit in ((1, 12_288), (2, 10_240), (3, 10_240), (4, 8192),
                     (5, 8192), (6, 6144), (8, 6144)):
        assert glm_hvp.fused_plan(limit, s, dtype=BF) is not None
        assert glm_hvp.fused_plan(limit + 1, s, dtype=BF) is None
    assert glm_hvp.fused_plan(1024, 1, dtype=BF) == \
        glm_hvp.FusedPlan(2, 64, 3, 512)
    assert glm_hvp.fused_plan(4096, 1, 4, dtype=BF) == \
        glm_hvp.FusedPlan(4, 32, 3, 1024)
    with pytest.raises(TypeError):
        glm_hvp.fused_plan(64, 1, dtype=torch.float16)


def test_fused_path_mirrors_the_tensor_map_rule():
    """``glm_hvp.fused_path``: a tensor map needs a row stride of whole
    16-byte units and a 16-byte aligned base, so at bf16 a DiSCO-S view
    at an offset not a multiple of 8 columns, or rows of a stride not a
    multiple of 8, take the direct path; f32 needs multiples of 4."""
    wide = torch.zeros((64, 3000 + 8), dtype=BF)
    assert wide.data_ptr() % 16 == 0
    odd = torch.zeros((40, 1028), dtype=BF)
    cases = {(wide[:, :3000], "bulk"), (wide[:, 8:3008], "bulk"),
             (wide[:, 1:1025], "direct"), (wide[:, 4:1028], "direct"),
             (odd[:, :1024], "direct"), (torch.zeros((1, 8), dtype=BF),
                                         "bulk"),
             (torch.zeros((1, 4), dtype=BF), "direct"),
             (torch.zeros((70, 1101), dtype=BF), "direct")}
    for X, path in cases:
        assert glm_hvp.fused_path(X) == path, (X.shape, X.stride())
    f32 = torch.zeros((40, 1028))
    assert glm_hvp.fused_path(f32[:, :1024]) == "bulk"
    assert glm_hvp.fused_path(f32[:, 4:1028]) == "bulk"
    assert glm_hvp.fused_path(f32[:, 1:1025]) == "direct"
