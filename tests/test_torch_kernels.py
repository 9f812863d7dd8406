"""The port's HVP ops, blocked-ELL and dense, against the JAX package's
kernels.

Same numpy layouts and vectors through ``repro.kernels.ops`` (the Pallas
kernels, in interpret mode as the suite's conftest sets) and
``repro_torch.kernels.ops`` on CPU tensors, which run the plain PyTorch
versions. Tolerance: rtol=1e-5 with atol=1e-6 (ELL) or 1e-5 (dense, whose
sums run over up to 300 terms): f32 sums taken in another order. The CUDA
kernels themselves run only on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

from repro.data.sparse import ell_from_csr, make_sparse_glm_data
from repro.kernels import ops as jops
from repro_torch.data.synthetic import make_glm_data
from repro_torch.kernels import build, glm_hvp
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


# s values of the multi-vector ops: 1, a power of two, DiSCO-S at s = 4
# (5 columns), and the kernels' cap
MULTI_S = [1, 2, 5, 8]


@pytest.mark.parametrize("block", [8, 16])
@pytest.mark.parametrize("with_c", [False, True])
@pytest.mark.parametrize("layout", ["forward", "transposed"])
@pytest.mark.parametrize("s", MULTI_S)
def test_ell_matmat_matches_jax(block, with_c, layout, s):
    rng = np.random.default_rng(100 + block + s)
    fwd, tr = _layouts(block)
    ell = fwd if layout == "forward" else tr
    n_in = ell.n_col_blocks * block
    V = rng.standard_normal((n_in, s)).astype(np.float32)
    c = rng.uniform(0.0, 0.25, n_in).astype(np.float32) if with_c else None
    ref = np.asarray(jops.ell_matmat(ell.data, ell.cols, V, c))
    T = torch.from_numpy
    got = tops.ell_matmat(T(ell.data), T(ell.cols), T(V),
                          None if c is None else T(c))
    assert got.dtype == torch.float32
    assert got.shape == (ell.n_row_blocks * block, s)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("block", [8, 16])
@pytest.mark.parametrize("with_c", [False, True])
@pytest.mark.parametrize("with_fwd", [False, True])
@pytest.mark.parametrize("s", MULTI_S)
def test_ell_hvp_mm_matches_jax(block, with_c, with_fwd, s):
    rng = np.random.default_rng(200 + block + s)
    fwd, tr = _layouts(block, seed=1)
    U = rng.standard_normal((fwd.n_row_blocks * block, s)).astype(np.float32)
    c = (rng.uniform(0.0, 0.25, tr.n_row_blocks * block).astype(np.float32)
         if with_c else None)
    jf = (fwd.data, fwd.cols) if with_fwd else None
    ref = np.asarray(jops.ell_hvp_mm(tr.data, tr.cols, U, c, fwd=jf))
    T = torch.from_numpy
    tf = (T(fwd.data), T(fwd.cols)) if with_fwd else None
    got = tops.ell_hvp_mm(T(tr.data), T(tr.cols), T(U),
                          None if c is None else T(c), fwd=tf)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_multi_ops_equal_their_columns():
    """Each column of a multi-vector op is the single-vector op on that
    column (within f32 rounding), also for a strided column view (the
    first s columns of an (., s + 1) basis)."""
    rng = np.random.default_rng(5)
    fwd, tr = _layouts(16, seed=2)
    T = torch.from_numpy
    data, cols, dataT, colsT = map(T, (fwd.data, fwd.cols, tr.data,
                                       tr.cols))
    basis = T(rng.standard_normal((fwd.n_row_blocks * 16, 5))
              .astype(np.float32))
    U = basis[:, :4]
    assert not U.is_contiguous()
    c = T(rng.uniform(0, 1, tr.n_row_blocks * 16).astype(np.float32))
    Z = tops.ell_matmat(dataT, colsT, U)
    Y = tops.ell_hvp_mm(dataT, colsT, U, c, fwd=(data, cols))
    for j in range(4):
        u = U[:, j].contiguous()
        np.testing.assert_allclose(
            Z[:, j].numpy(), tops.ell_matvec(dataT, colsT, u).numpy(),
            rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            Y[:, j].numpy(),
            tops.ell_hvp(dataT, colsT, u, c, fwd=(data, cols)).numpy(),
            rtol=1e-6, atol=1e-6)
    X, u, _, cd = _dense_inputs(40, 96, seed=6)
    Xt = T(X)
    Ub = T(rng.standard_normal((40, 3)).astype(np.float32))
    Zd = tops.xt_multi(Xt, Ub)
    Yd = tops.x_cz_multi(Xt, T(cd), Zd)
    for j in range(3):
        np.testing.assert_allclose(Zd[:, j].numpy(),
                                   tops.xt_u(Xt, Ub[:, j]).numpy(),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            Yd[:, j].numpy(),
            tops.x_cz_local(Xt, T(cd), Zd[:, j].contiguous()).numpy(),
            rtol=1e-6, atol=1e-6)


def test_multi_kernels_cap_their_columns():
    """The multi-vector kernels take 1 to MAX_COLS row-major columns with
    any row stride; their wrappers check that before a launch."""
    cpu = torch.device("cpu")
    basis = torch.ones((32, build.MAX_COLS + 1))
    assert build.check_columns("U", basis[:, :3], 32, cpu) == (3, 9)
    assert build.check_columns("U", torch.ones((1, 2)), 1, cpu) == (2, 2)
    with pytest.raises(ValueError, match=f"1 to {build.MAX_COLS}"):
        build.check_columns("U", basis, 32, cpu)
    with pytest.raises(ValueError, match="row-major"):
        build.check_columns("U", basis.T[:, :2], 9, cpu)
    with pytest.raises(ValueError, match=r"\(16, s\)"):
        build.check_columns("U", basis, 16, cpu)
    # the plain versions on the CPU take any width
    X = torch.ones((6, 10))
    assert tops.xt_multi(X, torch.ones((6, 12))).shape == (10, 12)


def test_cpu_calls_launch_no_kernel():
    build.reset_launch_counts()
    fwd, tr = _layouts(8)
    T = torch.from_numpy
    tops.ell_matvec(T(fwd.data), T(fwd.cols),
                    torch.ones(fwd.n_col_blocks * 8))
    tops.ell_hvp(T(tr.data), T(tr.cols), torch.ones(fwd.n_row_blocks * 8))
    X = torch.ones((6, 10))
    tops.xt_u(X, torch.ones(6))
    tops.x_cz_local(X, torch.ones(10), torch.ones(10))
    tops.x_c_xt_u(X, torch.ones(10), torch.ones(6))
    tops.ell_matmat(T(fwd.data), T(fwd.cols),
                    torch.ones((fwd.n_col_blocks * 8, 3)))
    tops.ell_hvp_mm(T(tr.data), T(tr.cols),
                    torch.ones((fwd.n_row_blocks * 8, 3)))
    tops.xt_multi(X, torch.ones((6, 3)))
    tops.x_cz_multi(X, None, torch.ones((10, 3)))
    assert build.launch_counts() == {
        "ell_mv": 0, "ell_hvp": 0, "xt_u": 0, "x_cz": 0, "x_c_xt_u": 0,
        "ell_mm": 0, "ell_hvp_mm": 0, "xt_multi": 0, "x_cz_multi": 0}


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
    with pytest.raises(ValueError, match="CUDA"):
        sparse_hvp.ell_mm(T(fwd.data), T(fwd.cols),
                          torch.ones((fwd.n_col_blocks * 8, 2)))
    with pytest.raises(ValueError, match="CUDA"):
        sparse_hvp.ell_hvp_mm(T(tr.data), T(tr.cols),
                              torch.ones((fwd.n_row_blocks * 8, 2)))
    X = torch.ones((6, 10))
    for call in (lambda: glm_hvp.xt_u(X, torch.ones(6)),
                 lambda: glm_hvp.x_cz(X, None, torch.ones(10)),
                 lambda: glm_hvp.x_c_xt_u(X, None, torch.ones(6)),
                 lambda: glm_hvp.xt_multi(X, torch.ones((6, 2))),
                 lambda: glm_hvp.x_cz_multi(X, None, torch.ones((10, 2)))):
        with pytest.raises(ValueError, match="CUDA"):
            call()


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
    assert [k.name for k in build.KERNELS] == [
        "ell_mv", "ell_hvp", "xt_u", "x_cz", "x_c_xt_u", "ell_mm",
        "ell_hvp_mm", "xt_multi", "x_cz_multi"]
    for k in build.KERNELS:
        assert k.source.is_file()
        assert k.library_path().parent == build.BUILD_DIR
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    # each library is named by its source and the headers it includes
    names = lambda k: [p.name for p in build.local_includes(k.source)]
    assert names(build.ELL_MV) == ["ell_common.cuh", "common.cuh"]
    assert names(build.X_CZ) == ["common.cuh"]
    assert names(build.XT_U) == ["partials.cuh", "common.cuh"]
    assert names(build.ELL_HVP_MM) == ["ell_common.cuh", "common.cuh"]
    assert names(build.XT_MULTI) == ["partials.cuh", "common.cuh"]
    assert names(build.X_CZ_MULTI) == ["common.cuh"]
    # the C header's column cap is the one the wrappers check
    assert f"kMaxCols = {build.MAX_COLS};" in (
        build.CSRC / "common.cuh").read_text()
    # the build directory is ignored by git
    gitignore = build.BUILD_DIR.parents[1] / ".gitignore"
    assert "build/" in gitignore.read_text().split()


# ---------------------------------------------------------------------------
# dense GLM HVP ops
# ---------------------------------------------------------------------------

DENSE_RTOL, DENSE_ATOL = 1e-5, 1e-5
DENSE_SHAPES = [(200, 300), (131, 77)]      # ragged against every block
DENSE_CASES = [("xt_u", False), ("x_cz_local", False), ("x_cz_local", True),
               ("x_c_xt_u", False), ("x_c_xt_u", True)]


def _dense_inputs(d, n, seed):
    """The solver's kind of data: power-law features, unit-norm columns."""
    X, _, _ = make_glm_data(d, n, seed=seed)
    rng = np.random.default_rng(seed)
    u = rng.standard_normal(d).astype(np.float32)
    z = rng.standard_normal(n).astype(np.float32)
    c = rng.uniform(0.0, 0.25, n).astype(np.float32)
    return X, u, z, c


@pytest.mark.parametrize("shape", DENSE_SHAPES, ids=lambda s: "x".join(
    map(str, s)))
@pytest.mark.parametrize("case", DENSE_CASES, ids=lambda c: f"{c[0]}-c{c[1]}")
def test_dense_ops_match_jax(shape, case):
    """xt_u, x_cz_local and x_c_xt_u at ragged shapes (the JAX wrappers pad
    to 512 blocks; the port does not pad), with and without the scale c
    (JAX's ops always take one: ones stand for none)."""
    op, with_c = case
    X, u, z, c = _dense_inputs(*shape, seed=sum(shape))
    T = torch.from_numpy
    c_j = c if with_c else np.ones_like(c)
    c_t = T(c) if with_c else None
    if op == "xt_u":
        ref, got = jops.xt_u(X, u), tops.xt_u(T(X), T(u))
    elif op == "x_cz_local":
        ref = jops.x_cz_local(X, c_j, z)
        got = tops.x_cz_local(T(X), c_t, T(z))
    else:
        ref = jops.x_c_xt_u(X, c_j, u)
        got = tops.x_c_xt_u(T(X), c_t, T(u))
    assert got.dtype == torch.float32
    assert got.shape == np.shape(ref)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=DENSE_RTOL, atol=DENSE_ATOL)


@pytest.mark.parametrize("fused", [False, True])
def test_dense_glm_hvp_matches_jax(fused):
    X, u, _, c = _dense_inputs(200, 300, seed=5)
    T = torch.from_numpy
    ref = jops.glm_hvp(X, c, u, 1e-3, fused=fused)
    got = tops.glm_hvp(T(X), T(c), T(u), 1e-3, fused=fused)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=DENSE_RTOL, atol=DENSE_ATOL)


@pytest.mark.parametrize("shape", DENSE_SHAPES, ids=lambda s: "x".join(
    map(str, s)))
@pytest.mark.parametrize("op", ["xt_multi", "x_cz_multi", "x_cz_multi-c"])
@pytest.mark.parametrize("s", MULTI_S)
def test_dense_multi_ops_match_jax(shape, op, s):
    """xt_multi and x_cz_multi at ragged shapes and true widths s (the JAX
    wrappers pad s to 128 lanes and d, n to 512 blocks; the port pads
    nothing), with and without c (JAX's x_cz_multi always takes one)."""
    d, n = shape
    X, _, _, c = _dense_inputs(d, n, seed=d + n + s)
    rng = np.random.default_rng(s)
    T = torch.from_numpy
    if op == "xt_multi":
        U = rng.standard_normal((d, s)).astype(np.float32)
        ref, got = jops.xt_multi(X, U), tops.xt_multi(T(X), T(U))
    else:
        Z = rng.standard_normal((n, s)).astype(np.float32)
        with_c = op.endswith("-c")
        ref = jops.x_cz_multi(X, c if with_c else np.ones_like(c), Z)
        got = tops.x_cz_multi(T(X), T(c) if with_c else None, T(Z))
    assert got.dtype == torch.float32
    assert got.shape == np.shape(ref)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=DENSE_RTOL, atol=DENSE_ATOL)


def test_dense_ops_take_strided_views():
    """A DiSCO-S shard is a column slice of the whole matrix: the ops take
    it as a view and give what they give on a copy."""
    X, u, _, c = _dense_inputs(40, 96, seed=2)
    Xt = torch.from_numpy(X)
    view = Xt[:, 32:64]
    assert not view.is_contiguous()
    cs, ut = torch.from_numpy(c[32:64]), torch.from_numpy(u)
    for f in (lambda A: tops.xt_u(A, ut),
              lambda A: tops.x_cz_local(A, cs, torch.ones(32)),
              lambda A: tops.x_c_xt_u(A, cs, ut)):
        assert torch.equal(f(view), f(view.contiguous()))


def test_fused_fit_rule():
    """The fused kernel's panel fits one CTA's shared memory: 8 columns
    at d = 4096, none past d of about 11,000."""
    assert glm_hvp.fused_panel_width(4096) == 8
    assert glm_hvp.fused_panel_width(1024) == 32
    assert glm_hvp.fused_panel_width(11_000) == 4
    assert glm_hvp.fused_panel_width(12_000) is None
    for d in (1, 200, 4096, 11_000):
        bn = glm_hvp.fused_panel_width(d)
        assert glm_hvp.fused_smem_bytes(d, bn) <= glm_hvp.SMEM_LIMIT
    assert glm_hvp.fused_smem_bytes(4096, 8) == 4 * (4096 * 9 + 33 * 8)


def test_fused_op_routes_past_the_fit_rule(monkeypatch):
    """On the card, a panel that does not fit takes the two-pass route
    through the xt_u and x_cz kernels, never a plain version."""
    calls = []
    monkeypatch.setattr(tops, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(glm_hvp, "xt_u",
                        lambda X, u: calls.append("xt_u") or X.T @ u)
    monkeypatch.setattr(glm_hvp, "x_cz",
                        lambda X, c, z: calls.append("x_cz") or X @ (c * z))
    monkeypatch.setattr(glm_hvp, "x_c_xt_u",
                        lambda X, c, u: calls.append("x_c_xt_u"))
    for d in (4096, 12_000):
        X = torch.zeros((d, 3))
        tops.x_c_xt_u(X, torch.ones(3), torch.ones(d))
    assert calls == ["x_c_xt_u", "xt_u", "x_cz"]


def test_xt_u_slices_fill_the_card():
    assert glm_hvp.xt_u_slices(4096, 262_144, 132) == 5
    assert glm_hvp.xt_u_slices(4096, 4 * 256 * 1056, 132) == 1
    assert glm_hvp.xt_u_slices(100, 10, 132) == 2     # 64 rows at least
