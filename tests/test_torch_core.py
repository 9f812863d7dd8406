"""The port's core modules against the JAX package's.

Losses, the communication ledger, the Woodbury preconditioner, the HVP
cell registry and operators, the in-process collectives and one classic
PCG solve of each partition, on the same numpy inputs. Tolerances: 1e-6
for elementwise f32 code, rtol=1e-5/atol=1e-6 for products with sums
taken in another order.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core import comm as jcomm
from repro.core import hvp as jhvp
from repro.core import losses as jlosses
from repro.core.pcg import PCGResult as JPCGResult
from repro.core.pcg import pcg_features as j_pcg_features
from repro.core.pcg import pcg_samples as j_pcg_samples
from repro.core.preconditioner import WoodburyPreconditioner as JWoodbury
from repro.data.sparse import EllPair as JEllPair
from repro.data.sparse import ell_from_csr, make_sparse_glm_data
from repro.utils.compat import shard_map
from repro_torch.core import comm as tcomm
from repro_torch.core import hvp as thvp
from repro_torch.core import losses as tlosses
from repro_torch.core.pcg import pcg_features, pcg_samples
from repro_torch.core.preconditioner import (IdentityPreconditioner,
                                             WoodburyPreconditioner)
from repro_torch.data.sparse import EllPair
from repro_torch.parallel import InProcessGroup

T = torch.from_numpy
LAM = 1e-2     # ridge weight of the PCG problems


@pytest.mark.parametrize("name", sorted(jlosses.LOSSES))
def test_losses_match_jax(name):
    rng = np.random.default_rng(0)
    a = rng.standard_normal(257).astype(np.float32) * 3
    y = (np.sign(rng.standard_normal(257)) if name in (
        "logistic", "squared_hinge") else rng.standard_normal(257)
         ).astype(np.float32)
    jl, tl = jlosses.get_loss(name), tlosses.get_loss(name)
    assert tl.M == jl.M
    for fn in ("value", "d1", "d2"):
        ref = np.asarray(getattr(jl, fn)(jnp.asarray(a), jnp.asarray(y)))
        got = getattr(tl, fn)(T(a), T(y)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_make_huber_and_unknown_loss():
    a = np.linspace(-3, 3, 61, dtype=np.float32)
    y = np.zeros_like(a)
    jh, th = jlosses.make_huber(0.5), tlosses.make_huber(0.5)
    for fn in ("value", "d1", "d2"):
        np.testing.assert_allclose(getattr(th, fn)(T(a), T(y)).numpy(),
                                   np.asarray(getattr(jh, fn)(a, y)),
                                   rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="unknown loss"):
        tlosses.get_loss("hinge")


def test_comm_costs_match_jax():
    for fn, args in (("disco_s_outer_cost", (96,)),
                     ("disco_s_pcg_cost", (96, 17)),
                     ("disco_f_outer_cost", (200, 96, 4)),
                     ("disco_f_pcg_cost", (200, 17))):
        assert getattr(tcomm, fn)(*args) == getattr(jcomm, fn)(*args)
    tl, jl = tcomm.CommLedger(), jcomm.CommLedger()
    for led in (tl, jl):
        led.add(2, 192, 1)
        led.add(1, 202)
    assert (tl.rounds, tl.floats, tl.spmd_collectives, tl.bytes) == \
        (jl.rounds, jl.floats, jl.spmd_collectives, jl.bytes)
    m = tl.merged(tl)
    assert (m.rounds, m.floats) == (2 * tl.rounds, 2 * tl.floats)


def test_woodbury_matches_jax_and_inverts():
    rng = np.random.default_rng(1)
    X_tau = (0.1 * rng.standard_normal((48, 100))).astype(np.float32)
    c = rng.uniform(0.0, 0.25, 100).astype(np.float32)
    r = rng.standard_normal(48).astype(np.float32)
    jp = JWoodbury.build(jnp.asarray(X_tau), jnp.asarray(c), 1e-3, 1e-2)
    tp = WoodburyPreconditioner.build(T(X_tau), T(c), 1e-3, 1e-2)
    got = tp.apply_inv(T(r))
    np.testing.assert_allclose(got.numpy(), np.asarray(jp.apply_inv(r)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose((tp.dense() @ got).numpy(), r,
                               rtol=1e-4, atol=1e-4)
    bd = WoodburyPreconditioner.build_blockdiag(T(X_tau), T(c), 1e-3, 1e-2)
    assert torch.equal(bd.apply_inv(T(r)), got)
    assert torch.equal(IdentityPreconditioner().apply_inv(T(r)), T(r))


def test_cell_registry_matches_jax():
    assert thvp.operator_cells() == [tuple(c) for c in jhvp.operator_cells()]
    for cell in jhvp.operator_cells():
        args = (cell.family, cell.layout, cell.partition, cell.fused,
                cell.dtype)
        assert thvp.cell_id(*args) == jhvp.cell_id(*args)
        if cell.supported:
            assert thvp.resolve_cell(*args).supported
        else:
            with pytest.raises(thvp.UnsupportedHvpError,
                               match=re.escape(cell.reason)):
                thvp.resolve_cell(*args)
    with pytest.raises(thvp.UnsupportedHvpError, match="streamed"):
        thvp.validate_solver_cell(family="binary", partition="features",
                                  fused=True, dtype="float32",
                                  streaming=True)


def test_dense_layout_not_yet_ported():
    """The dense layouts build their operators now, the one-pass kernels
    on bf16 tiles too (that raised "not yet ported" until K5 and K10 took
    bf16 tiles), and the plain dense layout has no fused kernel, as in
    the reference. s-step PCG builds on two-pass and on fused dense
    kernels (the fused round, x_c_xt_multi, is ported)."""
    from repro_torch import DiscoConfig, DiscoSolver
    X = torch.zeros((8, 8))
    assert isinstance(thvp.make_local_operator(X, None),
                      thvp.DenseOperator)
    assert isinstance(thvp.make_local_operator(X, None, use_kernel=True),
                      thvp.DenseKernelOperator)
    with pytest.raises(thvp.UnsupportedHvpError, match="use_kernel=True"):
        thvp.make_local_operator(X, None, fused=True)
    fused_bf16 = DiscoSolver(np.eye(8, dtype=np.float32), np.ones(8),
                             DiscoConfig(use_kernel=True, hvp_fused=True,
                                         hvp_dtype="bfloat16"),
                             device="cpu")
    assert fused_bf16.X_h.dtype == torch.bfloat16
    op = thvp.make_local_operator(fused_bf16._hvp_locs[0], None,
                                  use_kernel=True, fused=True)
    assert isinstance(op, thvp.DenseKernelOperator) and op.fused
    # the dense s-step paths build, two-pass and fused, and the fused one
    # runs a step
    DiscoSolver(np.eye(8, dtype=np.float32), np.ones(8),
                DiscoConfig(use_kernel=True, pcg_block_s=2), device="cpu")
    for partition in ("samples", "features"):
        solver = DiscoSolver(np.eye(8, dtype=np.float32), np.ones(8),
                             DiscoConfig(use_kernel=True, hvp_fused=True,
                                         pcg_block_s=2, max_outer=1,
                                         partition=partition, tau=4),
                             device="cpu")
        assert np.isfinite(solver.fit().w).all()


@pytest.mark.parametrize("use_kernel,fused",
                         [(False, False), (True, False), (True, True)])
def test_dense_operators_match_jax(use_kernel, fused):
    rng = np.random.default_rng(4)
    X = (rng.standard_normal((40, 70)) / np.sqrt(40)).astype(np.float32)
    c = rng.uniform(0, 0.25, 70).astype(np.float32)
    u = rng.standard_normal(40).astype(np.float32)
    z = rng.standard_normal(70).astype(np.float32)
    jop = jhvp.make_local_operator(jnp.asarray(X), jnp.asarray(c),
                                   use_kernel=use_kernel, fused=fused)
    top = thvp.make_local_operator(T(X), T(c), use_kernel=use_kernel,
                                   fused=fused)
    assert type(top).__name__ == type(jop).__name__
    assert top.layout == jop.layout and top.fused == fused
    for name, arg in (("pass_a", u), ("pass_b", z), ("apply", u)):
        np.testing.assert_allclose(getattr(top, name)(T(arg)).numpy(),
                                   np.asarray(getattr(jop, name)(arg)),
                                   rtol=1e-5, atol=1e-6)


def _pair(block=16, seed=0):
    X, _, _ = make_sparse_glm_data(d=96, n=200, density=0.1, seed=seed)
    fwd = ell_from_csr(X, block, block)
    tr = ell_from_csr(X.transpose(), block, block)
    return (fwd.data, fwd.cols, tr.data, tr.cols), X


@pytest.mark.parametrize("fused", [False, True])
def test_ell_operator_matches_jax(fused):
    rng = np.random.default_rng(2)
    arrs, X = _pair()
    nr, nc = arrs[0].shape[0] * 16, arrs[2].shape[0] * 16
    c = rng.uniform(0, 0.25, nc).astype(np.float32)
    u = rng.standard_normal(nr).astype(np.float32)
    z = rng.standard_normal(nc).astype(np.float32)
    jop = jhvp.make_local_operator(JEllPair(*arrs), jnp.asarray(c),
                                   fused=fused)
    top = thvp.make_local_operator(EllPair(*map(T, arrs)), T(c),
                                   fused=fused)
    assert isinstance(top, thvp.EllOperator) and top.fused == fused
    for name, arg in (("pass_a", u), ("pass_b", z), ("apply", u)):
        np.testing.assert_allclose(getattr(top, name)(T(arg)).numpy(),
                                   np.asarray(getattr(jop, name)(arg)),
                                   rtol=1e-5, atol=1e-6)


def test_in_process_group_ordered_sum():
    parts = [torch.tensor([1e8, 1.0]), torch.tensor([-1e8, 1.0]),
             torch.tensor([1.0, 1.0])]
    g = InProcessGroup(3)
    out = g.all_reduce(parts)
    # (1e8 + -1e8) + 1 in shard order; any other order loses the 1
    assert out.tolist() == [1.0, 3.0]
    assert torch.equal(g.all_reduce(torch.stack(parts)), out)
    one = InProcessGroup(1)
    assert one.all_reduce([parts[0]]) is parts[0]
    with pytest.raises(ValueError):
        g.all_reduce(parts[:2])
    with pytest.raises(ValueError):
        InProcessGroup(0)


def _run_single_device(fn, in_specs, out_specs, axis, *args):
    mesh = jax.make_mesh((1,), (axis,))
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs, check_vma=False))(*args)


def _pcg_problem(seed=3):
    """A logistic Newton system at a random w on a 96 x 200 sparse X."""
    rng = np.random.default_rng(seed)
    arrs, X = _pair(seed=seed)
    Xd = X.todense().astype(np.float64)
    d, n = X.shape
    y = np.sign(rng.standard_normal(n))
    w = rng.standard_normal(d) * 0.3
    a = Xd.T @ w
    s = 1 / (1 + np.exp(-y * a))
    c = (s * (1 - s)).astype(np.float32)
    g = (Xd @ (-y * (1 - s)) / n + LAM * w).astype(np.float32)
    return arrs, Xd.astype(np.float32), c, g


@pytest.mark.parametrize("precond", ["woodbury", "none"])
def test_pcg_samples_matches_jax(precond):
    arrs, Xd, c, g = _pcg_problem()
    d, n = Xd.shape
    nr, nc = arrs[0].shape[0] * 16, arrs[2].shape[0] * 16
    cp = np.pad(c, (0, nc - n))
    gp = np.pad(g, (0, nr - d))
    tau = 100
    X_tau = np.pad(Xd[:, :tau], ((0, nr - d), (0, 0)))
    eps = 0.05 * float(np.linalg.norm(g))

    def body(cc, gg, Xt, ct):
        return j_pcg_samples(JEllPair(*arrs), cc, n, LAM, gg, eps, 256,
                             X_tau=Xt, coeffs_tau=ct, mu=1e-2,
                             axis_name="data", precond=precond)

    ref = _run_single_device(body, (P(), P(), P(), P()),
                             JPCGResult(P(), P(), P(), P()), "data",
                             cp, gp, X_tau, c[:tau])
    got = pcg_samples([EllPair(*map(T, arrs))], T(cp)[None], n, LAM,
                      T(gp), eps, 256, X_tau=T(X_tau), coeffs_tau=T(c[:tau]),
                      mu=1e-2, precond=precond)
    assert got.iters == int(ref.iters) and got.iters > 1
    np.testing.assert_allclose(got.v.numpy(), np.asarray(ref.v),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(got.delta), float(ref.delta),
                               rtol=1e-5)


@pytest.mark.parametrize("precond", ["woodbury", "none"])
def test_pcg_features_matches_jax(precond):
    arrs, Xd, c, g = _pcg_problem(seed=4)
    d, n = Xd.shape
    nr, nc = arrs[0].shape[0] * 16, arrs[2].shape[0] * 16
    cp = np.pad(c, (0, nc - n))
    gp = np.pad(g, (0, nr - d))
    tau = 100
    X_tau = np.pad(Xd[:, :tau], ((0, nr - d), (0, 0)))
    eps = 0.05 * float(np.linalg.norm(g))

    def body(cc, gg, Xt, ct):
        return j_pcg_features(JEllPair(*arrs), cc, n, LAM, gg, eps, 256,
                              coeffs_tau=ct, mu=1e-2, axis_name="model",
                              precond=precond, X_tau_loc=Xt, axis_size=1)

    ref = _run_single_device(body, (P(), P("model"), P("model", None), P()),
                             JPCGResult(P("model"), P(), P(), P()), "model",
                             cp, gp, X_tau, c[:tau])
    got = pcg_features([EllPair(*map(T, arrs))], T(cp), n, LAM,
                       T(gp)[None], eps, 256, coeffs_tau=T(c[:tau]),
                       mu=1e-2, precond=precond, X_tau_loc=T(X_tau)[None])
    assert got.iters == int(ref.iters) and got.iters > 1
    np.testing.assert_allclose(got.v[0].numpy(), np.asarray(ref.v),
                               rtol=1e-4, atol=1e-5)


def test_pcg_sstep_not_yet_ported():
    """s-step PCG is ported now (it raised before): one s-step solve of
    each partition (no preconditioner, so it takes several rounds) matches
    the JAX package's on the same Newton system (the same rounds, v within
    rtol 1e-4, as the classic solves here), and a fused dense operator's
    batched product (x_c_xt_multi, which raised "not yet ported" before)
    matches the JAX package's fused dense operator."""
    arrs, Xd, c, g = _pcg_problem(seed=5)
    d, n = Xd.shape
    nr, nc = arrs[0].shape[0] * 16, arrs[2].shape[0] * 16
    cp = np.pad(c, (0, nc - n))
    gp = np.pad(g, (0, nr - d))
    tau = 100
    X_tau = np.pad(Xd[:, :tau], ((0, nr - d), (0, 0)))
    eps = 0.05 * float(np.linalg.norm(g))

    def body_s(cc, gg, Xt, ct):
        return j_pcg_samples(JEllPair(*arrs), cc, n, LAM, gg, eps, 256,
                             X_tau=Xt, coeffs_tau=ct, mu=1e-2,
                             axis_name="data", precond="none", block_s=3,
                             axis_size=1)

    def body_f(cc, gg, Xt, ct):
        return j_pcg_features(JEllPair(*arrs), cc, n, LAM, gg, eps, 256,
                              coeffs_tau=ct, mu=1e-2, axis_name="model",
                              X_tau_loc=Xt, precond="none", block_s=3,
                              axis_size=1)

    ref_s = _run_single_device(body_s, (P(), P(), P(), P()),
                               JPCGResult(P(), P(), P(), P()), "data",
                               cp, gp, X_tau, c[:tau])
    ref_f = _run_single_device(body_f, (P(), P("model"), P("model", None),
                                        P()),
                               JPCGResult(P("model"), P(), P(), P()),
                               "model", cp, gp, X_tau, c[:tau])
    pair = [EllPair(*map(T, arrs))]
    got_s = pcg_samples(pair, T(cp)[None], n, LAM, T(gp), eps, 256,
                        X_tau=T(X_tau), coeffs_tau=T(c[:tau]), mu=1e-2,
                        precond="none", block_s=3)
    got_f = pcg_features(pair, T(cp), n, LAM, T(gp)[None], eps, 256,
                         coeffs_tau=T(c[:tau]), mu=1e-2,
                         X_tau_loc=T(X_tau)[None], precond="none",
                         block_s=3)
    for got, v, ref in ((got_s, got_s.v, ref_s), (got_f, got_f.v[0], ref_f)):
        assert got.iters == int(ref.iters) and got.iters > 1
        np.testing.assert_allclose(v.numpy(), np.asarray(ref.v), rtol=1e-4,
                                   atol=1e-5)
    rng = np.random.default_rng(6)
    Xs = rng.standard_normal((12, 30)).astype(np.float32)
    cs = rng.uniform(0.0, 0.25, 30).astype(np.float32)
    Us = rng.standard_normal((12, 3)).astype(np.float32)
    op = thvp.make_local_operator(T(Xs), T(cs), use_kernel=True, fused=True)
    jop = jhvp.make_local_operator(jnp.asarray(Xs), jnp.asarray(cs),
                                   use_kernel=True, fused=True)
    np.testing.assert_allclose(op.apply_multi(T(Us)).numpy(),
                               np.asarray(jop.apply_multi(jnp.asarray(Us))),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_softmax_operator_matches_jax(use_kernel, weighted):
    """The K-class coupling, the one-direction product and the batched
    (d, K, s) product of SoftmaxHvpOperator against the JAX package's on
    the same probabilities, directions and sample weights (rtol 1e-5)."""
    rng = np.random.default_rng(14)
    d, n, K, s = 9, 40, 3, 2
    X = rng.standard_normal((d, n)).astype(np.float32)
    A = rng.standard_normal((n, K)).astype(np.float32)
    P = np.exp(A) / np.exp(A).sum(axis=1, keepdims=True)
    wts = (rng.uniform(0, 1, n) > 0.2).astype(np.float32) if weighted \
        else None
    U = rng.standard_normal((d, K)).astype(np.float32)
    U3 = rng.standard_normal((d, K, s)).astype(np.float32)
    jop = jhvp.SoftmaxHvpOperator(
        jhvp.make_local_operator(jnp.asarray(X), None,
                                 use_kernel=use_kernel),
        jnp.asarray(P), None if wts is None else jnp.asarray(wts))
    top = thvp.SoftmaxHvpOperator(
        thvp.make_local_operator(T(X), None, use_kernel=use_kernel), T(P),
        None if wts is None else T(wts))
    assert top.family == "softmax" and not top.fused
    assert top.layout == ("dense_kernel" if use_kernel else "dense")
    V = (X.T @ U).astype(np.float32)
    for got, ref in (
            (top.coupling(T(V)), jop.coupling(jnp.asarray(V))),
            (top.apply(T(U)), jop.apply(jnp.asarray(U))),
            (top.apply_batch(T(U3)), jop.apply_batch(jnp.asarray(U3)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)
