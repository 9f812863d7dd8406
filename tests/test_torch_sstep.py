"""The port's s-step PCG (``pcg_block_s > 1``) against the JAX package's.

The engine's pieces (``_solve_round``, ``_mgs``, ``_krylov_columns``,
``_feature_scales_update``) and the s-step communication costs on the
same numpy inputs, then whole solves: the same data through
``repro.core.disco_fit`` (the Pallas kernels in interpret mode, as the
suite's conftest sets) and ``repro_torch.disco_fit(device='cpu')`` (the
plain versions). Each solve asserts equal PCG rounds per Newton step
(above 1), equal communication ledgers, and the final ``w`` within
rtol=1e-4, atol=1e-6, the classic path's tolerance. The problems are
those of ``test_torch_disco.py`` (sparse, 96 x 200, 16 x 16 tiles) and
``test_torch_dense.py`` (dense, 98 x 202); at m = 4 the JAX reference runs
in one subprocess with four forced host devices.

Every solve also runs the JAX package on its plain versions
(``REPRO_KERNEL_MODE=ref``), the reference's own counterpart of the
port's CPU path, and the reference under another summation order. At
s = 4 the basis is ill-conditioned enough that f32 rounding shows: the
two reference runs differ by up to 6.6e-6 in ``w`` (sparse DiSCO-S on
four shards) and 1.1e-4 (sparse DiSCO-F, whose monomial basis spans about
five decades), with the same rounds in every step. So a ``w`` passes
when it is within rtol=1e-4, atol=1e-6 of either reference run, or else
no further from the interpret-mode run than the ref-mode run is: the
port is held to the reference's own f32 spread, never beyond it.
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

from repro.core import DiscoConfig as JDiscoConfig
from repro.core import comm as jcomm
from repro.core import disco_fit as j_disco_fit
from repro.core import pcg as jpcg
from repro.data.sparse import make_sparse_glm_data
from repro.data.synthetic import make_glm_data
from repro_torch import CSRMatrix, DiscoConfig, InProcessGroup, disco_fit
from repro_torch.core import comm as tcomm
from repro_torch.core import pcg as tpcg

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
T = torch.from_numpy
RTOL, ATOL = 1e-4, 1e-6

SPARSE_KW = dict(loss="logistic", lam=1e-3, tau=100, max_outer=4,
                 grad_tol=0.0, ell_block_d=16, ell_block_n=16)
SPARSE_DATA = dict(d=96, n=200, density=0.2, alpha=0.8, beta=0.5, seed=1)
DENSE_KW = dict(loss="logistic", lam=1e-3, tau=100, max_outer=4,
                grad_tol=0.0)
DENSE_DATA = dict(d=98, n=202, seed=1)

# (input, partition, variant, s); sparse variants: fused or two-pass,
# dense: 'matmul' (use_kernel=False), 'kernel' (two-pass kernels),
# 'fused' (DiSCO-F on several shards only: its basis operator fuses, its
# rounds run the two-pass multi-vector kernels)
CASES_1 = ([("sparse", p, v, s) for p in ("samples", "features")
            for v in ("two-pass", "fused") for s in (2, 4)]
           + [("dense", p, v, s) for p in ("samples", "features")
              for v in ("matmul", "kernel") for s in (2, 3)])
CASES_4 = CASES_1 + [("dense", "features", "fused", s) for s in (2, 3)]


def _id(case):
    return "-".join(map(str, case))


def _kw(case) -> dict:
    kind, partition, variant, s = case
    if kind == "sparse":
        return dict(SPARSE_KW, partition=partition, pcg_block_s=s,
                    hvp_fused=variant == "fused")
    return dict(DENSE_KW, partition=partition, pcg_block_s=s,
                use_kernel=variant != "matmul",
                hvp_fused=variant == "fused")


def _data(kind):
    if kind == "sparse":
        X, y, _ = make_sparse_glm_data(**SPARSE_DATA)
        return X, y, CSRMatrix(X.indptr, X.indices, X.data, X.shape)
    X, y, _ = make_glm_data(**DENSE_DATA)
    return X, y, X


def _summary(res) -> dict:
    led = res.ledger
    return dict(w=np.asarray(res.w).tolist(),
                pcg_iters=[int(h["pcg_iters"]) for h in res.history],
                ledger=[led.rounds, led.floats, led.spmd_collectives])


def _assert_matches(got, ref: dict, ref_plain: dict):
    """``ref``: the JAX solve in interpret mode; ``ref_plain``: the same
    solve on the JAX package's plain versions (module docstring)."""
    s = _summary(got)
    assert s["pcg_iters"] == ref["pcg_iters"] == ref_plain["pcg_iters"]
    assert min(s["pcg_iters"]) > 1
    assert s["ledger"] == ref["ledger"]
    w_ref = np.asarray(ref["w"], np.float32)
    w_plain = np.asarray(ref_plain["w"], np.float32)
    if any(np.allclose(got.w, w, rtol=RTOL, atol=ATOL)
           for w in (w_ref, w_plain)):
        return
    own = float(np.max(np.abs(w_plain - w_ref)))
    diff = float(np.max(np.abs(got.w - w_ref)))
    assert diff <= own, (
        f"w differs by up to {diff:.3g} from the reference, beyond rtol "
        f"{RTOL} / atol {ATOL} of both its runs and beyond their own "
        f"spread {own:.3g}")


# ---------------------------------------------------------------------------
# the engine's pieces
# ---------------------------------------------------------------------------

def _gram(U, H):
    """G = U^T H U, B = U^T U and b = U^T r of a trial basis U (f32), and
    U itself."""
    U = U.astype(np.float32)
    r = (H @ U[:, 0] + 0.1).astype(np.float32)
    return ((U.T @ H @ U).astype(np.float32), (U.T @ U).astype(np.float32),
            (U.T @ r).astype(np.float32), U)


def _spd(rng, n, decay):
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return ((Q * decay ** np.arange(n)) @ Q.T).astype(np.float32)


def _solve_cases():
    rng = np.random.default_rng(0)
    H = _spd(rng, 30, 0.9)
    cases = {}
    for s in (2, 3, 4):
        U = np.linalg.qr(rng.standard_normal((30, s + 1)))[0]
        cases[f"orthonormal-s{s}"] = (_gram(U, H), s)
        # columns of growing norm, as unscaled Krylov columns have (the
        # whitening removes the scaling exactly), p_prev beside
        K = rng.standard_normal((30, s)) * 3.0 ** np.arange(s)
        U = np.concatenate([K, rng.standard_normal((30, 1))], axis=1)
        cases[f"graded-s{s}"] = (_gram(U, H), s)
        # round one: p_prev = 0, so B and G have a zero row and column
        U = np.concatenate([K, np.zeros((30, 1))], axis=1)
        cases[f"zero-pprev-s{s}"] = (_gram(U, H), s)
    # a monomial block beyond salvage (a Krylov column zeroed by the
    # overflow guard makes it singular): the closed-form 2 x 2 step over
    # {q_1, p_prev}, or the pure q_1 step when p_prev = 0
    q = rng.standard_normal(30)
    U = np.stack([q, H @ q, np.zeros(30), rng.standard_normal(30)], axis=1)
    cases["fallback-s3"] = (_gram(U, H), 3)
    U = np.stack([q, H @ q, np.zeros(30), np.zeros(30)], axis=1)
    cases["fallback-zero-pprev-s3"] = (_gram(U, H), 3)
    return cases


SOLVE_CASES = _solve_cases()


@pytest.mark.parametrize("name", sorted(SOLVE_CASES))
def test_solve_round_matches_jax(name):
    """The same coefficients (rtol 1e-5) on well-conditioned bases, the
    same dropped column (p_prev = 0) and the same closed-form fallback."""
    (G, B, b, U), s = SOLVE_CASES[name]
    ref = np.asarray(jpcg._solve_round(jnp.asarray(G), jnp.asarray(B),
                                       jnp.asarray(b), s))
    got = tpcg._solve_round(T(G), T(B), T(b), s).numpy()
    assert got.dtype == np.float32
    if name.startswith("fallback"):
        # only columns 0 and s carry a coefficient
        assert np.count_nonzero(got) <= 2 and got[0] != 0
    if "zero-pprev" in name:
        assert got[s] == 0 and ref[s] == 0
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-6 * np.abs(ref).max())
    # the Galerkin condition on the kept span: U^T H U a = U^T r there
    if not name.startswith("fallback"):
        live = np.abs(np.diag(B)) > 0
        np.testing.assert_allclose((G @ got)[live], b[live], rtol=1e-3,
                                   atol=1e-4 * np.abs(b).max())


def test_mgs_and_krylov_columns_match_jax():
    rng = np.random.default_rng(1)
    A = _spd(rng, 20, 0.8)
    M = rng.uniform(0.5, 2.0, 20).astype(np.float32)
    r = rng.standard_normal(20).astype(np.float32)
    s = 4
    # the basis operator multiplies by 1e15, so the third column is about
    # 1e30 / 1e-25: it overflows f32
    A = A * np.float32(1e15)
    scales = np.array([2.0, 1e-25, 0.5], np.float32)
    j_cols = jpcg._krylov_columns(jnp.asarray(r), lambda v: v * M,
                                  lambda v: jnp.asarray(A) @ v, s,
                                  jnp.asarray(scales))
    t_cols = tpcg._krylov_columns(T(r), lambda v: v * T(M),
                                  lambda v: T(A) @ v, s, T(scales))
    assert len(t_cols) == s
    for got, ref in zip(t_cols, j_cols):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-6)
    # the overflowed column is all zeros, not inf or NaN, and so is the
    # one after it
    assert not t_cols[2].any() and not t_cols[3].any()
    assert torch.isfinite(t_cols[1]).all() and t_cols[1].any()
    cols = [c.numpy() for c in t_cols] + [np.zeros(20, np.float32)]
    j_out = jpcg._mgs([jnp.asarray(c) for c in cols])
    t_out = tpcg._mgs([T(c) for c in cols])
    for got, ref in zip(t_out, j_out):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-6)
    Q = torch.stack(t_out, dim=1)
    live = Q[:, Q.norm(dim=0) > 0]
    assert live.shape[1] == 2            # the zero columns stay zero
    np.testing.assert_allclose((live.T @ live).numpy(),
                               np.eye(2, dtype=np.float32), atol=1e-5)


@pytest.mark.parametrize("diag", [
    [4.0, 1.0, 0.25, 9.0, 1.0], [1.0, np.inf, np.inf, 4.0, 1.0],
    [1e-40, 1e30, 1e-30, 1e20, 1.0], [np.nan, 1.0, 2.0, 3.0, 1.0]],
    ids=["plain", "overflow", "clipped", "nan"])
def test_feature_scales_update_matches_jax(diag):
    s = 4
    B = np.diag(np.asarray(diag, np.float32))
    scales = np.array([1.0, 3.0, 0.5], np.float32)
    ref = np.asarray(jpcg._feature_scales_update(jnp.asarray(scales),
                                                 jnp.asarray(B), s))
    got = tpcg._feature_scales_update(T(scales), T(B), s).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    assert np.all((got >= 1e-6) & (got <= 1e6))


@pytest.mark.parametrize("s", [2, 4, 8])
def test_sstep_costs_match_jax(s):
    for rounds in (0, 1, 7):
        assert tcomm.disco_s_sstep_cost(47236, s, rounds) == \
            jcomm.disco_s_sstep_cost(47236, s, rounds)
        assert tcomm.disco_f_sstep_cost(20242, s, rounds) == \
            jcomm.disco_f_sstep_cost(20242, s, rounds)


# ---------------------------------------------------------------------------
# whole solves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES_1, ids=_id)
def test_sstep_fit_matches_jax(case, monkeypatch):
    X, y, Xp = _data(case[0])
    kw = _kw(case)
    ref = _summary(j_disco_fit(X, y, JDiscoConfig(**kw)))
    monkeypatch.setenv("REPRO_KERNEL_MODE", "ref")
    ref_plain = _summary(j_disco_fit(X, y, JDiscoConfig(**kw)))
    got = disco_fit(Xp, y, DiscoConfig(**kw), device="cpu")
    _assert_matches(got, ref, ref_plain)
    assert got.grad_norms[-1] < 0.5 * got.grad_norms[0]


SCRIPT_4 = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import numpy as np
    assert len(jax.devices()) == 4
    from repro.core import DiscoConfig, disco_fit
    from repro.data.sparse import make_sparse_glm_data
    from repro.data.synthetic import make_glm_data
    CASES = json.loads(sys.argv[1])
    data = {"sparse": make_sparse_glm_data(**json.loads(sys.argv[2])),
            "dense": make_glm_data(**json.loads(sys.argv[3]))}
    out = []
    for kind, kw, modes in CASES:
        X, y, _ = data[kind]
        axis = "model" if kw["partition"] == "features" else "data"
        runs = []
        for mode in modes:
            os.environ["REPRO_KERNEL_MODE"] = mode
            r = disco_fit(X, y, DiscoConfig(**kw),
                          mesh=jax.make_mesh((4,), (axis,)))
            led = r.ledger
            runs.append(dict(
                w=np.asarray(r.w).tolist(),
                pcg_iters=[int(h["pcg_iters"]) for h in r.history],
                ledger=[led.rounds, led.floats, led.spmd_collectives]))
        out.append(runs)
    print("RESULT " + json.dumps(out))
""")


def _run_jax_4device():
    """{case: [interpret-mode summary, ref-mode summary]} of CASES_4 from
    one JAX subprocess with four forced host devices."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    cases = [(c[0], _kw(c), ["interpret", "ref"]) for c in CASES_4]
    r = subprocess.run([sys.executable, "-c", SCRIPT_4, json.dumps(cases),
                        json.dumps(SPARSE_DATA), json.dumps(DENSE_DATA)],
                       env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout + r.stderr
    line = [x for x in r.stdout.splitlines() if x.startswith("RESULT ")][-1]
    return dict(zip(CASES_4, json.loads(line[len("RESULT "):])))


@pytest.fixture(scope="module")
def jax_4device_runs():
    return _run_jax_4device()


@pytest.mark.parametrize("case", CASES_4, ids=_id)
def test_sstep_fit_4shards_matches_jax(jax_4device_runs, case):
    _, y, Xp = _data(case[0])
    got = disco_fit(Xp, y, DiscoConfig(**_kw(case)),
                    group=InProcessGroup(4), device="cpu")
    _assert_matches(got, *jax_4device_runs[case])


@pytest.mark.parametrize("partition", ["samples", "features"])
def test_sstep_needs_half_the_rounds(partition):
    """At s = 4 the sparse solve needs at most half the PCG rounds of
    s = 1 (summed over the Newton steps), in the port as in JAX."""
    X, y, Xt = _data("sparse")
    rounds = {}
    for s in (1, 4):
        kw = dict(SPARSE_KW, partition=partition, pcg_block_s=s)
        rounds[s] = (
            sum(h["pcg_iters"] for h in disco_fit(
                Xt, y, DiscoConfig(**kw), device="cpu").history),
            sum(int(h["pcg_iters"]) for h in j_disco_fit(
                X, y, JDiscoConfig(**kw)).history))
    assert rounds[1][0] == rounds[1][1] and rounds[4][0] == rounds[4][1]
    assert rounds[1][0] >= 2 * rounds[4][0]


@pytest.mark.parametrize("partition,m", [("samples", 1), ("samples", 4),
                                         ("features", 1)])
def test_fused_dense_sstep_not_yet_ported(partition, m):
    """The s-step rounds of these cells need the fused multi-vector dense
    kernel (x_c_xt_multi), which is not yet ported: set-up raises."""
    X, y, _ = _data("dense")
    kw = _kw(("dense", partition, "fused", 2))
    with pytest.raises(NotImplementedError, match="x_c_xt_multi"):
        disco_fit(X, y, DiscoConfig(**kw), group=InProcessGroup(m),
                  device="cpu")


def report():
    """Print, for every whole-solve case, the rounds per step and the
    largest differences in ``w``: port against each reference run, and
    between the two reference runs (their own spread)."""
    os.environ["REPRO_KERNEL_MODE"] = "interpret"
    runs4 = _run_jax_4device()
    for m, cases in ((1, CASES_1), (4, CASES_4)):
        for case in cases:
            X, y, Xp = _data(case[0])
            kw = _kw(case)
            if m == 1:
                refs = []
                for mode in ("interpret", "ref"):
                    os.environ["REPRO_KERNEL_MODE"] = mode
                    refs.append(_summary(j_disco_fit(X, y,
                                                     JDiscoConfig(**kw))))
                os.environ["REPRO_KERNEL_MODE"] = "interpret"
            else:
                refs = runs4[case]
            got = disco_fit(Xp, y, DiscoConfig(**kw), group=InProcessGroup(m),
                            device="cpu")
            wi, wr = (np.asarray(r["w"], np.float32) for r in refs)
            print(f"m={m} {_id(case)}: rounds "
                  f"{[int(h['pcg_iters']) for h in got.history]}; max |dw| "
                  f"port-interpret {np.abs(got.w - wi).max():.3g}, "
                  f"port-ref {np.abs(got.w - wr).max():.3g}, "
                  f"ref-interpret {np.abs(wr - wi).max():.3g}", flush=True)


if __name__ == "__main__":
    # PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_sstep.py
    report()
