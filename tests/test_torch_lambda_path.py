"""The port's λ-path (``repro_torch.core.lambda_path``) against the JAX
package's.

The same numpy data and grid through ``repro.core.lambda_path`` (the
Pallas kernels in interpret mode, as the suite's conftest sets, and again
on its plain versions, ``REPRO_KERNEL_MODE=ref``) and
``repro_torch.lambda_path_fit(device='cpu')``: the grid order, every
solve's PCG iterations or s-step rounds, the X-pass ledger, the
validation losses (rtol 1e-5) and the best λ equal; every ``w`` within
rtol 1e-4 / atol 1e-6 of either reference run, or no further from the
interpret-mode run than the plain-version run is (the s-step rule of
``tests/test_torch_sstep.py``). The main case is the dense fused s-step
DiSCO-S solve, whose rounds run the fused multi-vector HVP
(``x_c_xt_multi``); the problem is ``tests/test_torch_dense.py``'s.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import DiscoConfig as JDiscoConfig
from repro.core import lambda_path as jlp
from repro.data.sparse import CSRMatrix as JCSRMatrix
from repro.data.synthetic import make_glm_data
from repro_torch import CSRMatrix, DiscoConfig, DiscoSolver, InProcessGroup
from repro_torch.core import lambda_path as tlp

RTOL, ATOL = 1e-4, 1e-6
LAMBDAS = [1e-4, 1e-2, 1e-3]          # any order; fitted descending
BASE = dict(loss="logistic", tau=100, max_outer=8, grad_tol=1e-6)
# (partition, use_kernel, hvp_fused, pcg_block_s)
VARIANTS = [("samples", True, True, 3), ("features", True, True, 2),
            ("samples", True, True, 1), ("features", False, False, 1)]


def _id(v):
    p, uk, fu, s = v
    return f"{p}-{'fused' if fu else 'kernel' if uk else 'matmul'}-s{s}"


def _data():
    X, y, _ = make_glm_data(d=98, n=202, seed=1)
    Xv, yv, _ = make_glm_data(d=98, n=150, seed=2)
    return X, y, Xv, yv


def _kw(variant) -> dict:
    partition, use_kernel, fused, s = variant
    return dict(BASE, partition=partition, use_kernel=use_kernel,
                hvp_fused=fused, pcg_block_s=s)


def _close(w, w_int, w_ref) -> bool:
    if any(np.allclose(w, r, rtol=RTOL, atol=ATOL) for r in (w_int, w_ref)):
        return True
    return np.max(np.abs(w - w_int)) <= np.max(np.abs(w_ref - w_int))


@pytest.mark.parametrize("warm", [True, False], ids=["warm", "cold"])
@pytest.mark.parametrize("variant", VARIANTS, ids=_id)
def test_lambda_path_matches_jax(variant, warm, monkeypatch):
    X, y, Xv, yv = _data()
    kw = _kw(variant)
    refs = []
    for mode in ("interpret", "ref"):
        monkeypatch.setenv("REPRO_KERNEL_MODE", mode)
        refs.append(jlp.lambda_path_fit(X, y, LAMBDAS, JDiscoConfig(**kw),
                                        warm=warm, X_val=Xv, y_val=yv))
    got = tlp.lambda_path_fit(X, y, LAMBDAS, DiscoConfig(**kw), warm=warm,
                              X_val=Xv, y_val=yv, device="cpu")
    ref = refs[0]
    assert got.lambdas == ref.lambdas == sorted(LAMBDAS, reverse=True)
    assert got.x_passes == ref.x_passes == refs[1].x_passes
    assert got.total_x_passes == ref.total_x_passes
    assert got.best_index == ref.best_index
    assert got.best_lambda == ref.best_lambda
    assert got.best_result is got.results[got.best_index]
    np.testing.assert_allclose(got.val_losses, ref.val_losses, rtol=1e-5)
    for g, r_int, r_ref in zip(got.results, refs[0].results,
                               refs[1].results):
        assert [h["pcg_iters"] for h in g.history] == \
            [int(h["pcg_iters"]) for h in r_int.history]
        assert _close(g.w, np.asarray(r_int.w), np.asarray(r_ref.w))


def test_warm_path_reaches_the_cold_endpoints_for_fewer_passes():
    """Warm starts change where each solve begins, not where it ends: the
    warm path's solutions equal the cold path's (rtol 1e-3 at grad_tol
    1e-6), for fewer X passes in total, in the port as in the JAX
    package (whose total it equals)."""
    X, y, _, _ = _data()
    kw = dict(_kw(VARIANTS[0]), max_outer=20)
    warm = tlp.lambda_path_fit(X, y, LAMBDAS, DiscoConfig(**kw),
                               device="cpu")
    cold = tlp.lambda_path_fit(X, y, LAMBDAS, DiscoConfig(**kw), warm=False,
                               device="cpu")
    for a, b in zip(warm.results, cold.results):
        assert a.converged and b.converged
        np.testing.assert_allclose(a.w, b.w, rtol=1e-3, atol=1e-5)
    assert warm.total_x_passes < cold.total_x_passes
    j_warm = jlp.lambda_path_fit(X, y, LAMBDAS, JDiscoConfig(**kw))
    assert warm.total_x_passes == j_warm.total_x_passes


def test_with_lam_shares_the_device_tensors():
    """``with_lam`` copies the solver shallowly: every device tensor is the
    same object, only the config and the step are new, and the solver it
    came from is unchanged."""
    X, y, _, _ = _data()
    for partition in ("samples", "features"):
        cfg = DiscoConfig(**dict(_kw(VARIANTS[0]), partition=partition,
                                 lam=1e-2))
        base = DiscoSolver(X, y, cfg, group=InProcessGroup(2), device="cpu")
        other = base.with_lam(1e-3)
        assert other.cfg.lam == 1e-3 and base.cfg.lam == 1e-2
        assert other.cfg == dataclasses.replace(base.cfg, lam=1e-3)
        assert other._step is not base._step
        for name in ("X", "X_tau", "y", "y_tau", "_locs", "group"):
            assert getattr(other, name) is getattr(base, name)
        assert all(a is b for a, b in zip(other._locs, base._locs))
        if partition == "samples":
            assert other.weights is base.weights
        # the copy solves its own problem: its first gradient carries its
        # own ridge term, on the same data
        w = torch.full(base._w_shape, 0.1)
        g_base = float(base._step(w)[1]["grad_norm"])
        g_other = float(other._step(w)[1]["grad_norm"])
        assert g_base != g_other
        again = DiscoSolver(X, y, dataclasses.replace(cfg, lam=1e-3),
                            group=InProcessGroup(2), device="cpu")
        assert float(again._step(w)[1]["grad_norm"]) == g_other


@pytest.mark.parametrize("history", [
    [3, 4, 5], [0], [7, 1]], ids=["three", "zero", "two"])
def test_x_passes_matches_jax(history):
    hist = [dict(pcg_iters=k) for k in history]
    for partition in ("samples", "features"):
        for fused in (False, True):
            for s in (1, 2, 4):
                kw = dict(partition=partition, hvp_fused=fused,
                          use_kernel=True, pcg_block_s=s)
                for m in (1, 4):
                    assert tlp.x_passes(hist, DiscoConfig(**kw), m) == \
                        jlp.x_passes(hist, JDiscoConfig(**kw), m)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_validation_loss_matches_jax(kind):
    rng = np.random.default_rng(4)
    _, _, Xv, yv = _data()
    Xv = np.where(rng.uniform(size=Xv.shape) < 0.3, Xv, 0).astype(np.float32)
    w = rng.standard_normal(98).astype(np.float32)
    Xj, Xt = ((JCSRMatrix.from_dense(Xv), CSRMatrix.from_dense(Xv))
              if kind == "sparse" else (Xv, Xv))
    for loss in ("logistic", "squared_hinge"):
        np.testing.assert_allclose(
            tlp.validation_loss(w, Xt, yv, loss, device="cpu"),
            jlp.validation_loss(w, Xj, yv, loss), rtol=1e-5)


def test_lambda_path_four_shards_matches_one():
    """The λ-path over four in-process shards (DiSCO-F, fused s-step: its
    basis operator is each shard's block) gives the one-shard path's
    solutions (rtol 1e-4) and its best λ."""
    X, y, Xv, yv = _data()
    kw = _kw(VARIANTS[1])
    one = tlp.lambda_path_fit(X, y, LAMBDAS, DiscoConfig(**kw), X_val=Xv,
                              y_val=yv, device="cpu")
    four = tlp.lambda_path_fit(X, y, LAMBDAS, DiscoConfig(**kw),
                               group=InProcessGroup(4), X_val=Xv, y_val=yv,
                               device="cpu")
    assert four.best_lambda == one.best_lambda
    for a, b in zip(four.results, one.results):
        np.testing.assert_allclose(a.w, b.w, rtol=1e-4, atol=1e-5)
