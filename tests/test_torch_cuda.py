"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``; each test skips when no CUDA device is present (the
kernels have no CPU mode). Imports nothing of JAX, so it runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: relative L2 error <= 1e-5 in f32 (sums in another order, and
for ``ell_hvp`` atomics in a varying order).
"""
import numpy as np
import pytest
import torch

from repro_torch import DiscoConfig, InProcessGroup, disco_fit
from repro_torch.data.sparse import ell_from_csr, make_sparse_glm_data
from repro_torch.data.synthetic import make_glm_data
from repro_torch.kernels import build, glm_hvp, ops, ref, sparse_hvp

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _layouts(block, seed=0):
    """Forward + transposed layouts of a power-law matrix, with padding
    slots."""
    if block <= 16:
        X, _, _ = make_sparse_glm_data(d=70, n=90, density=0.05, seed=seed)
    else:
        X, _, _ = make_sparse_glm_data(d=2000, n=1500, density=0.005,
                                       seed=seed)
    fwd = ell_from_csr(X, block, block)
    tr = ell_from_csr(X.transpose(), block, block)
    assert (fwd.cols[:, 1:] == 0).any()
    return fwd, tr


def _rel(got, want):
    return float(torch.linalg.norm(got - want) / torch.linalg.norm(want))


@pytest.mark.parametrize("block", [8, 16, 128])
@pytest.mark.parametrize("with_c", [False, True])
def test_cuda_ell_mv_matches_plain(dev, block, with_c):
    rng = np.random.default_rng(block)
    fwd, _ = _layouts(block)
    T = lambda a: torch.from_numpy(a).to(dev)
    data, cols = T(fwd.data), T(fwd.cols)
    n_in = fwd.n_col_blocks * block
    v = T(rng.standard_normal(n_in).astype(np.float32))
    c = T(rng.uniform(0, 1, n_in).astype(np.float32)) if with_c else None
    got = sparse_hvp.ell_mv(data, cols, v, c)
    torch.cuda.synchronize()
    assert _rel(got, ref.ref_ell_mv(data, cols, v, c)) <= 1e-5


@pytest.mark.parametrize("block", [8, 16, 128])
@pytest.mark.parametrize("with_c", [False, True])
def test_cuda_ell_hvp_matches_plain(dev, block, with_c):
    rng = np.random.default_rng(block)
    fwd, tr = _layouts(block, seed=1)
    T = lambda a: torch.from_numpy(a).to(dev)
    dataT, colsT = T(tr.data), T(tr.cols)
    u = T(rng.standard_normal(fwd.n_row_blocks * block).astype(np.float32))
    c = (T(rng.uniform(0, 1, tr.n_row_blocks * block).astype(np.float32))
         if with_c else None)
    got = sparse_hvp.ell_hvp(dataT, colsT, u, c)
    torch.cuda.synchronize()
    assert _rel(got, ref.ref_ell_hvp_t(dataT, colsT, u, c)) <= 1e-5


def test_cuda_ops_launch_the_kernels(dev):
    fwd, tr = _layouts(16)
    T = lambda a: torch.from_numpy(a).to(dev)
    build.reset_launch_counts()
    ops.ell_matvec(T(fwd.data), T(fwd.cols),
                   torch.ones(fwd.n_col_blocks * 16, device=dev))
    ops.ell_hvp(T(tr.data), T(tr.cols),
                torch.ones(fwd.n_row_blocks * 16, device=dev),
                fwd=(T(fwd.data), T(fwd.cols)))
    assert build.launch_counts() == {"ell_mv": 1, "ell_hvp": 1, "xt_u": 0,
                                     "x_cz": 0, "x_c_xt_u": 0}


@pytest.mark.parametrize("partition", ["samples", "features"])
@pytest.mark.parametrize("fused", [False, True])
def test_cuda_disco_fit_matches_cpu(dev, partition, fused):
    """A small solve on the card equals the same solve on the CPU (whose
    plain versions the CPU tests hold to the JAX package)."""
    X, y, _ = make_sparse_glm_data(d=96, n=200, density=0.2, alpha=0.8,
                                   beta=0.5, seed=1)
    cfg = DiscoConfig(loss="logistic", lam=1e-3, tau=100, max_outer=4,
                      grad_tol=0.0, ell_block_d=16, ell_block_n=16,
                      partition=partition, hvp_fused=fused)
    on_card = disco_fit(X, y, cfg)
    on_cpu = disco_fit(X, y, cfg, device="cpu")
    np.testing.assert_allclose(on_card.w, on_cpu.w, rtol=1e-4, atol=1e-6)
    assert [h["pcg_iters"] for h in on_card.history] == \
        [h["pcg_iters"] for h in on_cpu.history]


# ---------------------------------------------------------------------------
# dense GLM HVP kernels
# ---------------------------------------------------------------------------

# ragged shapes (n % 4 != 0 takes the scalar loads), a multiple-of-4 one
# (16-byte loads), and a d past the fused kernel's widest panel (bn = 16)
DENSE_SHAPES = [(200, 300), (131, 77), (64, 4099), (2000, 2048)]


def _dense(dev, d, n, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    X = torch.randn((d, n), generator=g, device=dev) / d ** 0.5
    u = torch.randn(d, generator=g, device=dev)
    z = torch.randn(n, generator=g, device=dev)
    c = torch.rand(n, generator=g, device=dev)
    return X, u, z, c


@pytest.mark.parametrize("shape", DENSE_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("with_c", [False, True])
def test_cuda_dense_kernels_match_plain(dev, shape, with_c):
    X, u, z, c = _dense(dev, *shape, seed=sum(shape))
    c = c if with_c else None
    cz = z if c is None else c * z
    cases = [(glm_hvp.xt_u(X, u), ref.ref_xt_u(X, u)),
             (glm_hvp.x_cz(X, c, z), ref.ref_x_cz(X, cz)),
             (glm_hvp.x_c_xt_u(X, c, u),
              ref.ref_x_cz(X, ref.ref_xt_u(X, u) * (1 if c is None else c)))]
    torch.cuda.synchronize()
    for got, want in cases:
        assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("block_n", glm_hvp.PANEL_WIDTHS)
def test_cuda_fused_every_panel_width(dev, block_n):
    X, u, _, c = _dense(dev, 300, 1001, seed=block_n)
    got = glm_hvp.x_c_xt_u(X, c, u, _block_n=block_n)
    assert _rel(got, ref.ref_x_c_xt_u(X, c, u)) <= 1e-5
    again = glm_hvp.x_c_xt_u(X, c, u, _block_n=block_n)
    assert torch.equal(got, again)          # no atomics: repeatable


def test_cuda_dense_kernels_take_column_slices(dev):
    """A DiSCO-S shard is a column slice (a strided view) of X."""
    X, u, z, c = _dense(dev, 96, 1024, seed=3)
    view = X[:, 256:512]
    cs, zs = c[256:512], z[256:512]
    for kernel, plain in (
            (lambda A: glm_hvp.xt_u(A, u), lambda A: ref.ref_xt_u(A, u)),
            (lambda A: glm_hvp.x_cz(A, cs, zs),
             lambda A: ref.ref_x_cz(A, cs * zs)),
            (lambda A: glm_hvp.x_c_xt_u(A, cs, u),
             lambda A: ref.ref_x_c_xt_u(A, cs, u))):
        assert _rel(kernel(view), plain(view.contiguous())) <= 1e-5


def test_cuda_dense_ops_launch_the_kernels(dev):
    X, u, z, c = _dense(dev, 64, 256, seed=4)
    build.reset_launch_counts()
    ops.xt_u(X, u)
    ops.x_cz_local(X, c, z)
    ops.x_c_xt_u(X, c, u)
    big = torch.zeros((12_000, 8), device=dev)   # past the fit rule
    ops.x_c_xt_u(big, None, torch.zeros(12_000, device=dev))
    assert build.launch_counts() == {"ell_mv": 0, "ell_hvp": 0, "xt_u": 2,
                                     "x_cz": 2, "x_c_xt_u": 1}


@pytest.mark.parametrize("partition", ["samples", "features"])
@pytest.mark.parametrize("m,fused", [(1, False), (1, True), (4, False)])
def test_cuda_dense_disco_fit_matches_cpu(dev, partition, m, fused):
    X, y, _ = make_glm_data(d=98, n=202, seed=1)
    cfg = DiscoConfig(loss="logistic", lam=1e-3, tau=100, max_outer=4,
                      grad_tol=0.0, partition=partition, use_kernel=True,
                      hvp_fused=fused)
    build.reset_launch_counts()
    on_card = disco_fit(X, y, cfg, group=InProcessGroup(m))
    counts = build.launch_counts()
    on_cpu = disco_fit(X, y, cfg, group=InProcessGroup(m), device="cpu")
    np.testing.assert_allclose(on_card.w, on_cpu.w, rtol=1e-4, atol=1e-6)
    assert [h["pcg_iters"] for h in on_card.history] == \
        [h["pcg_iters"] for h in on_cpu.history]
    if fused and (partition == "samples" or m == 1):
        assert counts["x_c_xt_u"] > 0 and counts["xt_u"] == 0
    else:
        assert counts["xt_u"] > 0 and counts["x_cz"] > 0
