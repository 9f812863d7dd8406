"""The port's blocked-ELL ops against the JAX package's kernels.

Same numpy layouts and vectors through ``repro.kernels.ops`` (the Pallas
kernels, in interpret mode as the suite's conftest sets) and
``repro_torch.kernels.ops`` on CPU tensors, which run the plain PyTorch
versions. Tolerance rtol=1e-5, atol=1e-6: f32 sums taken in another
order. The CUDA kernels themselves run only on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

from repro.data.sparse import ell_from_csr, make_sparse_glm_data
from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops
from repro_torch.kernels import sparse_hvp

RTOL, ATOL = 1e-5, 1e-6


def _layouts(block, seed=0):
    """Forward + transposed blocked-ELL layouts of a random power-law
    matrix; tile widths differ across row-blocks, so padding slots
    (cols = 0, zero tile) are present."""
    if block <= 16:
        X, _, _ = make_sparse_glm_data(d=70, n=90, density=0.05, seed=seed)
    else:
        X, _, _ = make_sparse_glm_data(d=2000, n=1500, density=0.005,
                                       seed=seed)
    fwd = ell_from_csr(X, block, block)
    tr = ell_from_csr(X.transpose(), block, block)
    assert (np.diff(fwd.cols, axis=1) <= 0).any()
    return fwd, tr


def _vec(rng, size):
    return rng.standard_normal(size).astype(np.float32)


@pytest.mark.parametrize("block", [8, 16])
@pytest.mark.parametrize("with_c", [False, True])
@pytest.mark.parametrize("layout", ["forward", "transposed"])
def test_ell_matvec_matches_jax(block, with_c, layout):
    rng = np.random.default_rng(block)
    fwd, tr = _layouts(block)
    ell = fwd if layout == "forward" else tr
    n_in = ell.n_col_blocks * block
    v = _vec(rng, n_in)
    c = rng.uniform(0.0, 0.25, n_in).astype(np.float32) if with_c else None
    ref = np.asarray(jops.ell_matvec(ell.data, ell.cols, v, c))
    got = tops.ell_matvec(torch.from_numpy(ell.data),
                          torch.from_numpy(ell.cols), torch.from_numpy(v),
                          None if c is None else torch.from_numpy(c))
    assert got.dtype == torch.float32
    assert got.shape == (ell.n_row_blocks * block,)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("block", [8, 16])
@pytest.mark.parametrize("with_c", [False, True])
@pytest.mark.parametrize("with_fwd", [False, True])
def test_ell_hvp_matches_jax(block, with_c, with_fwd):
    rng = np.random.default_rng(10 + block)
    fwd, tr = _layouts(block, seed=1)
    u = _vec(rng, fwd.n_row_blocks * block)
    c = (rng.uniform(0.0, 0.25, tr.n_row_blocks * block).astype(np.float32)
         if with_c else None)
    jf = (fwd.data, fwd.cols) if with_fwd else None
    ref = np.asarray(jops.ell_hvp(tr.data, tr.cols, u, c, fwd=jf))
    T = torch.from_numpy
    tf = (T(fwd.data), T(fwd.cols)) if with_fwd else None
    got = tops.ell_hvp(T(tr.data), T(tr.cols), T(u),
                       None if c is None else T(c), fwd=tf)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_ell_hvp_fwd_replays_two_pass_exactly():
    """On the CPU a fused call given the forward layout is the two-pass
    pair of plain versions bit for bit (what makes a fused CPU solve
    equal a two-pass one)."""
    rng = np.random.default_rng(3)
    fwd, tr = _layouts(16, seed=2)
    T = torch.from_numpy
    u = T(_vec(rng, fwd.n_row_blocks * 16))
    c = T(rng.uniform(0, 1, tr.n_row_blocks * 16).astype(np.float32))
    z = tops.ell_matvec(T(tr.data), T(tr.cols), u)
    two_pass = tops.ell_matvec(T(fwd.data), T(fwd.cols), z, c)
    fused = tops.ell_hvp(T(tr.data), T(tr.cols), u, c,
                         fwd=(T(fwd.data), T(fwd.cols)))
    assert torch.equal(fused, two_pass)
    # without fwd: the plain fused version, equal within rounding
    one_pass = tops.ell_hvp(T(tr.data), T(tr.cols), u, c)
    np.testing.assert_allclose(one_pass.numpy(), two_pass.numpy(),
                               rtol=RTOL, atol=ATOL)


def test_cpu_calls_launch_no_kernel():
    sparse_hvp.reset_launch_counts()
    fwd, tr = _layouts(8)
    T = torch.from_numpy
    tops.ell_matvec(T(fwd.data), T(fwd.cols),
                    torch.ones(fwd.n_col_blocks * 8))
    tops.ell_hvp(T(tr.data), T(tr.cols), torch.ones(fwd.n_row_blocks * 8))
    assert sparse_hvp.launch_counts() == {"ell_mv": 0, "ell_hvp": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch or raise; they never run the plain
    version themselves."""
    fwd, tr = _layouts(8)
    T = torch.from_numpy
    with pytest.raises(ValueError, match="CUDA"):
        sparse_hvp.ell_mv(T(fwd.data), T(fwd.cols),
                          torch.ones(fwd.n_col_blocks * 8))
    with pytest.raises(ValueError, match="CUDA"):
        sparse_hvp.ell_hvp(T(tr.data), T(tr.cols),
                           torch.ones(fwd.n_row_blocks * 8))


def test_ops_refuse_other_devices():
    data = torch.zeros((1, 1, 8, 8), device="meta")
    cols = torch.zeros((1, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tops.ell_matvec(data, cols, torch.zeros(8, device="meta"))
    with pytest.raises(ValueError, match="several devices"):
        tops.ell_matvec(torch.zeros((1, 1, 8, 8)),
                        torch.zeros((1, 1), dtype=torch.int32),
                        torch.zeros(8, device="meta"))


def test_kernel_sources_and_build_target():
    for k in sparse_hvp.KERNELS:
        assert k.source.is_file()
        assert k.library_path().parent == sparse_hvp.BUILD_DIR
    assert "arch=compute_90a,code=sm_90a" in sparse_hvp.NVCC_FLAGS
    # the build directory is ignored by git
    gitignore = sparse_hvp.BUILD_DIR.parents[1] / ".gitignore"
    assert "build/" in gitignore.read_text().split()
