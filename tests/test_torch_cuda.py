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

from repro_torch import DiscoConfig, disco_fit
from repro_torch.data.sparse import ell_from_csr, make_sparse_glm_data
from repro_torch.kernels import ops, ref, sparse_hvp

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
    sparse_hvp.reset_launch_counts()
    ops.ell_matvec(T(fwd.data), T(fwd.cols),
                   torch.ones(fwd.n_col_blocks * 16, device=dev))
    ops.ell_hvp(T(tr.data), T(tr.cols),
                torch.ones(fwd.n_row_blocks * 16, device=dev),
                fwd=(T(fwd.data), T(fwd.cols)))
    assert sparse_hvp.launch_counts() == {"ell_mv": 1, "ell_hvp": 1}


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
