"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``; each test skips when no CUDA device is present (the
kernels have no CPU mode). Imports nothing of JAX, so it runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: relative L2 error <= 1e-5 in f32 (sums in another order, and
for ``ell_hvp`` and ``ell_hvp_mm`` reductions into the output in a
varying order). The bf16 instances of the blocked-ELL and of the two-pass
dense kernels are held to the plain versions at bf16 tiles at the same
1e-5 (their products are exact in f32); the fused ones in two halves, since their hand-off
``c .* z`` rounds to bf16 (ROADMAP F11): the kernel's hand-off equals the
plain one's rounding except at ties within the f32 summation error bound,
and the output equals the plain pass B of the kernel's hand-off.
"""
import shutil

import numpy as np
import pytest
import torch

from repro_torch import DiscoConfig, InProcessGroup, disco_fit
from repro_torch.data.sparse import (CSRMatrix, ell_from_csr,
                                     make_sparse_glm_data)
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
    assert build.launch_counts() == {
        "ell_mv": 1, "ell_hvp": 1, "xt_u": 0, "x_cz": 0, "x_c_xt_u": 0,
        "ell_mm": 0, "ell_hvp_mm": 0, "xt_multi": 0, "x_cz_multi": 0,
        "x_c_xt_multi": 0, "flash_attention": 0, "ell_mv_bf16": 0,
        "ell_hvp_bf16": 0, "ell_mm_bf16": 0, "ell_hvp_mm_bf16": 0,
        "xt_u_bf16": 0, "x_cz_bf16": 0, "xt_multi_bf16": 0,
        "x_cz_multi_bf16": 0, "x_c_xt_u_bf16": 0, "x_c_xt_multi_bf16": 0}


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


@pytest.mark.parametrize("cluster", glm_hvp.CLUSTER_SIZES)
def test_cuda_fused_every_panel_width(dev, cluster):
    """x_c_xt_u on the fit rule's plan for each cluster size (ranks past d
    at 4 and 8): within 1e-5 of the plain version, repeatable."""
    X, u, _, c = _dense(dev, 300, 1001, seed=cluster)
    got = glm_hvp.x_c_xt_u(X, c, u, _cluster=cluster)
    assert glm_hvp.last_fused["x_c_xt_u"].plan == \
        glm_hvp.fused_plan(300, 1, cluster)
    assert _rel(got, ref.ref_x_c_xt_u(X, c, u)) <= 1e-5
    again = glm_hvp.x_c_xt_u(X, c, u, _cluster=cluster)
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


def _dense_edge(dev, name):
    """An X at an edge of the dense split (csrc/dense_stream.cuh), and the
    copy path it calls for: bulk copies need n and ld multiples of 4 and
    a 16-byte aligned X."""
    g = torch.Generator(device=dev).manual_seed(len(name))
    mat = lambda d, n: torch.randn((d, n), generator=g, device=dev)
    wide = mat(64, 3000)
    solver = mat(256, 4096)     # the dense slice at d cut 16-fold
    return {
        "ragged_n": (mat(70, 1101), "direct"),
        "d_below_ctas": (mat(5, 2048), "bulk"),
        "n_below_tile": (mat(64, 100), "bulk"),
        "n_below_tile_ragged": (mat(64, 99), "direct"),
        "d1_n1": (mat(1, 1), "direct"),
        "d1_n4": (mat(1, 4), "bulk"),
        "view_at_0": (wide[:, 0:1024], "bulk"),
        "view_at_1": (wide[:, 1:1025], "direct"),
        "view_at_4": (wide[:, 4:1028], "bulk"),
        "ld_not_4": (mat(40, 1027)[:, :1024], "direct"),
        "full": (solver, "bulk"),
        "S_m4_view": (solver[:, :1024], "bulk"),
        "F_m4_rows": (solver[:64], "bulk"),
    }[name]


DENSE_EDGES = ["ragged_n", "d_below_ctas", "n_below_tile",
               "n_below_tile_ragged", "d1_n1", "d1_n4", "view_at_0",
               "view_at_1", "view_at_4", "ld_not_4", "full", "S_m4_view",
               "F_m4_rows"]


@pytest.mark.parametrize("name", DENSE_EDGES)
@pytest.mark.parametrize("ctas", [None, 1, 7])
def test_cuda_dense_stream_edge_shapes(dev, name, ctas):
    """K3 and K4 at an edge of the split, on the card's CTA count and on
    1 and 7 CTAs (every unit cut, or few CTAs over many units), with and
    without c: on the copy path the shape calls for, within 1e-5 of the
    plain versions, and repeated bit for bit."""
    X, path = _dense_edge(dev, name)
    d, n = X.shape
    g = torch.Generator(device=dev).manual_seed(d * n)
    u = torch.randn(d, generator=g, device=dev)
    z = torch.randn(n, generator=g, device=dev)
    c = torch.rand(n, generator=g, device=dev)
    got = glm_hvp.xt_u(X, u, _ctas=ctas)
    assert glm_hvp.last_path["xt_u"] == path
    again = glm_hvp.xt_u(X, u, _ctas=ctas)
    torch.cuda.synchronize()
    assert got.shape == (n,)
    assert _rel(got, ref.ref_xt_u(X.contiguous(), u)) <= 1e-5
    assert torch.equal(got, again)
    for cc in (None, c):
        got = glm_hvp.x_cz(X, cc, z, _ctas=ctas)
        assert glm_hvp.last_path["x_cz"] == path
        again = glm_hvp.x_cz(X, cc, z, _ctas=ctas)
        torch.cuda.synchronize()
        assert got.shape == (d,)
        want = ref.ref_x_cz(X.contiguous(), z if cc is None else cc * z)
        assert _rel(got, want) <= 1e-5
        assert torch.equal(got, again)


def _fused_edge(dev, name):
    """An X at an edge of the fused kernels' plan and split
    (csrc/fused_stream.cuh), and the copy path it calls for: a tensor map
    needs ld a multiple of 4 and a 16-byte aligned X."""
    g = torch.Generator(device=dev).manual_seed(7 + len(name))
    mat = lambda d, n: torch.randn((d, n), generator=g, device=dev)
    wide = mat(64, 3000)
    solver = mat(512, 4096)     # the dense slice at d cut 8-fold
    return {
        "ragged_n": (mat(70, 1101), "direct"),
        "ragged_panel": (mat(70, 1100), "bulk"),
        "d_below_q": (mat(5, 2048), "bulk"),
        "d_not_multiple_of_q": (mat(1001, 700), "bulk"),
        "n_below_bn": (mat(64, 20), "bulk"),
        "n_below_bn_direct": (mat(64, 7), "direct"),
        "d1_n1": (mat(1, 1), "direct"),
        "d1_n4": (mat(1, 4), "bulk"),
        "view_at_0": (wide[:, 0:1024], "bulk"),
        "view_at_1": (wide[:, 1:1025], "direct"),
        "view_at_4": (wide[:, 4:1028], "bulk"),
        "ld_above_n": (mat(40, 1028)[:, :1000], "bulk"),
        "ld_not_4": (mat(40, 1027)[:, :1024], "direct"),
        "S_m4_view": (solver[:, :1024], "bulk"),
        "F_m4_rows": (solver[:128], "bulk"),
    }[name]


FUSED_EDGES = ["ragged_n", "ragged_panel", "d_below_q",
               "d_not_multiple_of_q", "n_below_bn", "n_below_bn_direct",
               "d1_n1", "d1_n4", "view_at_0", "view_at_1", "view_at_4",
               "ld_above_n", "ld_not_4", "S_m4_view", "F_m4_rows"]


@pytest.mark.parametrize("name", FUSED_EDGES)
@pytest.mark.parametrize("cluster", glm_hvp.CLUSTER_SIZES)
def test_cuda_fused_edge_shapes(dev, name, cluster):
    """K5 and K10 (s = 1..8, U the first s of s + 1 columns) at an edge of
    the plan and split, on each cluster size the fit rule allows there, on
    as many clusters as fit and on 3: on the copy path the shape calls
    for, within 1e-5 of the plain versions, repeated bit for bit."""
    X, path = _fused_edge(dev, name)
    d, n = X.shape
    g = torch.Generator(device=dev).manual_seed(d * n + cluster)
    u = torch.randn(d, generator=g, device=dev)
    c = torch.rand(n, generator=g, device=dev)
    ran = 0
    for clusters in (None, 3):
        if glm_hvp.fused_plan(d, 1, cluster) is not None:
            for cc in (None, c):
                kw = dict(_cluster=cluster, _clusters=clusters)
                got = glm_hvp.x_c_xt_u(X, cc, u, **kw)
                run = glm_hvp.last_fused["x_c_xt_u"]
                again = glm_hvp.x_c_xt_u(X, cc, u, **kw)
                torch.cuda.synchronize()
                assert run.path == glm_hvp.last_path["x_c_xt_u"] == path
                assert run.plan.cluster == cluster
                assert run.clusters == (clusters or run.clusters) >= 1
                A = X.contiguous()
                zu = ref.ref_xt_u(A, u)
                want = ref.ref_x_cz(A, zu if cc is None else cc * zu)
                assert _rel(got, want) <= 1e-5 or float(
                    torch.linalg.norm(want)) == 0.0
                assert torch.equal(got, again)
                ran += 1
        for s in range(1, build.MAX_COLS + 1):
            if glm_hvp.fused_plan(d, s, cluster) is None:
                continue
            U = _basis(dev, d, s, s + cluster, strided=True)
            got = glm_hvp.x_c_xt_multi(X, c, U, _cluster=cluster,
                                       _clusters=clusters)
            again = glm_hvp.x_c_xt_multi(X, c, U, _cluster=cluster,
                                         _clusters=clusters)
            torch.cuda.synchronize()
            assert glm_hvp.last_path["x_c_xt_multi"] == path
            assert got.shape == (d, s)
            assert _rel(got, ref.ref_x_c_xt_multi(X.contiguous(), c, U)) \
                <= 1e-5
            assert torch.equal(got, again)
            ran += 1
    if not ran:
        pytest.skip(f"no plan of {cluster} CTAs a cluster at d = {d}")


def test_cuda_dense_stream_refuses_another_split(dev, monkeypatch):
    """The entry points take the piece shape the wrapper's split assumes
    and refuse one that is not their header's, before any launch."""
    X, u, z, c = _dense(dev, 64, 1024, seed=5)
    monkeypatch.setattr(glm_hvp, "TILE_ROWS", glm_hvp.TILE_ROWS // 2)
    glm_hvp.dense_split.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="xt_u launch failed"):
            glm_hvp.xt_u(X, u)
        with pytest.raises(RuntimeError, match="x_cz launch failed"):
            glm_hvp.x_cz(X, c, z)
    finally:
        glm_hvp.dense_split.cache_clear()


def test_cuda_dense_ops_launch_the_kernels(dev):
    X, u, z, c = _dense(dev, 64, 256, seed=4)
    build.reset_launch_counts()
    ops.xt_u(X, u)
    ops.x_cz_local(X, c, z)
    ops.x_c_xt_u(X, c, u)
    big = torch.zeros((13_000, 8), device=dev)   # past the fit rule
    ops.x_c_xt_u(big, None, torch.zeros(13_000, device=dev))
    ops.x_c_xt_multi(X, c, torch.ones((64, 5), device=dev))
    ops.x_c_xt_multi(X, c, torch.ones((64, 20), device=dev))   # 8 + 8 + 4
    bigger = torch.zeros((20_000, 8), device=dev)   # past the multi fit rule
    ops.x_c_xt_multi(bigger, None, torch.zeros((20_000, 8), device=dev))
    assert build.launch_counts() == {
        "ell_mv": 0, "ell_hvp": 0, "xt_u": 2, "x_cz": 2, "x_c_xt_u": 1,
        "ell_mm": 0, "ell_hvp_mm": 0, "xt_multi": 1, "x_cz_multi": 1,
        "x_c_xt_multi": 4, "flash_attention": 0, "ell_mv_bf16": 0,
        "ell_hvp_bf16": 0, "ell_mm_bf16": 0, "ell_hvp_mm_bf16": 0,
        "xt_u_bf16": 0, "x_cz_bf16": 0, "xt_multi_bf16": 0,
        "x_cz_multi_bf16": 0, "x_c_xt_u_bf16": 0, "x_c_xt_multi_bf16": 0}


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


# ---------------------------------------------------------------------------
# multi-vector kernels (the s-step rounds)
# ---------------------------------------------------------------------------

# 1, a power of two, DiSCO-S at s = 4 (5 columns), the cap
MULTI_S = [1, 2, 4, 5, 8]


def _basis(dev, rows, s, seed, strided):
    """(rows, s) probe vectors; ``strided``: the first s columns of a
    (rows, s + 1) basis, as DiSCO-F passes them."""
    g = torch.Generator(device=dev).manual_seed(seed)
    B = torch.randn((rows, s + 1), generator=g, device=dev)
    return B[:, :s] if strided else B[:, :s].contiguous()


@pytest.mark.parametrize("block", [8, 16, 128])
@pytest.mark.parametrize("s", MULTI_S)
@pytest.mark.parametrize("with_c", [False, True])
def test_cuda_ell_mm_matches_plain(dev, block, s, with_c):
    fwd, tr = _layouts(block)
    T = lambda a: torch.from_numpy(a).to(dev)
    for ell, seed in ((fwd, s), (tr, 100 + s)):
        data, cols = T(ell.data), T(ell.cols)
        n_in = ell.n_col_blocks * block
        V = _basis(dev, n_in, s, seed, strided=s % 2 == 1)
        c = torch.rand(n_in, device=dev) if with_c else None
        got = sparse_hvp.ell_mm(data, cols, V, c)
        torch.cuda.synchronize()
        assert got.shape == (ell.n_row_blocks * block, s)
        assert _rel(got, ref.ref_ell_mm(data, cols, V, c)) <= 1e-5
        assert torch.equal(got, sparse_hvp.ell_mm(data, cols, V, c))


def _edge_layout(name):
    """A layout at an edge of K1's and K6's live-tile schedule, and the
    copy path its shape takes."""
    rng = np.random.default_rng(11)

    def tiled(dense, br, bc):
        return ell_from_csr(CSRMatrix.from_dense(dense), br, bc)

    if name in ("8x8", "16x16", "128x128"):
        return _layouts(int(name.split("x")[0]), seed=2)[0], "bulk"
    if name == "w300":          # 3 row-blocks of 300 tiles: fewer than SMs
        dense = rng.standard_normal((3 * 16, 300 * 16)).astype(np.float32)
        dense[rng.random(dense.shape) > 0.05] = 0.0
        ell = tiled(dense, 16, 16)
        assert ell.data.shape[:2] == (3, 300)
        return ell, "bulk"
    if name == "one_full":      # one full row-block among empty ones
        dense = np.zeros((200 * 16, 40 * 16), np.float32)
        dense[77 * 16:78 * 16] = rng.standard_normal((16, 40 * 16))
        return tiled(dense, 16, 16), "bulk"
    if name == "w1":            # W = 1, every other row-block empty
        dense = np.zeros((300 * 8, 300 * 8), np.float32)
        for i in range(0, 300, 2):
            dense[i * 8:(i + 1) * 8, i * 8:(i + 1) * 8] = \
                rng.standard_normal((8, 8))
        ell = tiled(dense, 8, 8)
        assert ell.width == 1
        return ell, "bulk"
    X, _, _ = make_sparse_glm_data(d=1000, n=900, density=0.01, seed=4)
    br, bc = map(int, name.split("x"))
    # 12 x 6: a tile row of 24 bytes, which a bulk copy cannot take
    return ell_from_csr(X, br, bc), "direct" if bc % 4 else "bulk"


EDGE_LAYOUTS = ["8x8", "16x16", "128x128", "w300", "one_full", "w1",
                "256x32", "32x256", "12x6"]


@pytest.mark.parametrize("name", EDGE_LAYOUTS)
@pytest.mark.parametrize("scheduled", [False, True])
def test_cuda_ell_mv_mm_edge_layouts(dev, name, scheduled):
    """K1 and K6 against their plain versions on a layout at an edge of
    the schedule, with the layout's schedule or without (every slot
    live), with and without c, K6 at every s on a strided V; every call
    repeated bit for bit, on the copy path the shape calls for."""
    ell, path = _edge_layout(name)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    data, cols = T(ell.data), T(ell.cols)
    nb, _, br, bc = data.shape
    sched = (sparse_hvp.ell_schedule(data, cols,
                                     sparse_hvp.default_ctas(dev))
             if scheduled else None)
    n_in = ell.n_col_blocks * bc
    g = torch.Generator(device=dev).manual_seed(len(name))
    v = torch.randn(n_in, generator=g, device=dev)
    for c in (None, torch.rand(n_in, generator=g, device=dev)):
        got = sparse_hvp.ell_mv(data, cols, v, c, sched=sched)
        assert sparse_hvp.last_path["ell_mv"] == path
        again = sparse_hvp.ell_mv(data, cols, v, c, sched=sched)
        torch.cuda.synchronize()
        assert got.shape == (nb * br,)
        assert _rel(got, ref.ref_ell_mv(data, cols, v, c)) <= 1e-5
        assert torch.equal(got, again)
        for s in MULTI_S:
            V = _basis(dev, n_in, s, s, strided=True)
            got = sparse_hvp.ell_mm(data, cols, V, c, sched=sched)
            assert sparse_hvp.last_path["ell_mm"] == path
            again = sparse_hvp.ell_mm(data, cols, V, c, sched=sched)
            torch.cuda.synchronize()
            assert got.shape == (nb * br, s)
            assert _rel(got, ref.ref_ell_mm(data, cols, V, c)) <= 1e-5
            assert torch.equal(got, again)


@pytest.mark.parametrize("name", EDGE_LAYOUTS)
def test_cuda_ell_mv_mm_skip_the_padding(dev, name):
    """With the schedule, K1 and K6 read no padding tile: NaN put into
    every slot past a row-block's live ones after the schedule is built
    leaves the results finite and equal to those on the clean layout."""
    ell, _ = _edge_layout(name)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    data, cols = T(ell.data), T(ell.cols)
    nb, w = data.shape[:2]
    sched = sparse_hvp.ell_schedule(data, cols, sparse_hvp.default_ctas(dev))
    live = sched[:nb].long()
    padding = torch.arange(w, device=dev)[None, :] >= live[:, None]
    poisoned = data.clone()
    poisoned[padding] = float("nan")
    n_in = ell.n_col_blocks * data.shape[3]
    v = torch.randn(n_in, device=dev)
    c = torch.rand(n_in, device=dev)
    V = _basis(dev, n_in, 5, 1, strided=True)
    y = sparse_hvp.ell_mv(poisoned, cols, v, c, sched=sched)
    Y = sparse_hvp.ell_mm(poisoned, cols, V, c, sched=sched)
    torch.cuda.synchronize()
    assert bool(y.isfinite().all()) and bool(Y.isfinite().all())
    assert torch.equal(y, sparse_hvp.ell_mv(data, cols, v, c, sched=sched))
    assert torch.equal(Y, sparse_hvp.ell_mm(data, cols, V, c, sched=sched))


def test_cuda_ell_ops_pass_the_schedule(dev):
    """The ops hand ``sched`` to the kernels: poisoned padding stays out
    of ``ops.ell_matvec`` and ``ops.ell_matmat`` (past 8 columns too)."""
    ell, _ = _edge_layout("16x16")
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    data, cols = T(ell.data), T(ell.cols)
    nb, w = data.shape[:2]
    sched = sparse_hvp.ell_schedule(data, cols, sparse_hvp.default_ctas(dev))
    padding = torch.arange(w, device=dev)[None, :] >= sched[:nb, None].long()
    poisoned = data.clone()
    poisoned[padding] = float("nan")
    n_in = ell.n_col_blocks * 16
    v, V = torch.randn(n_in, device=dev), torch.randn((n_in, 11), device=dev)
    build.reset_launch_counts()
    y = ops.ell_matvec(poisoned, cols, v, sched=sched)
    Y = ops.ell_matmat(poisoned, cols, V, sched=sched)
    torch.cuda.synchronize()
    assert build.launch_counts()["ell_mv"] == 1
    assert build.launch_counts()["ell_mm"] == 2
    assert _rel(y, ref.ref_ell_mv(data, cols, v)) <= 1e-5
    assert _rel(Y, ref.ref_ell_mm(data, cols, V)) <= 1e-5


@pytest.mark.parametrize("block", [8, 16, 128])
@pytest.mark.parametrize("s", MULTI_S)
@pytest.mark.parametrize("with_c", [False, True])
def test_cuda_ell_hvp_mm_matches_plain(dev, block, s, with_c):
    fwd, tr = _layouts(block, seed=1)
    T = lambda a: torch.from_numpy(a).to(dev)
    data, cols, dataT, colsT = map(T, (fwd.data, fwd.cols, tr.data,
                                       tr.cols))
    U = _basis(dev, fwd.n_row_blocks * block, s, s, strided=True)
    c = (torch.rand(tr.n_row_blocks * block, device=dev) if with_c
         else None)
    got = sparse_hvp.ell_hvp_mm(dataT, colsT, U, c)
    torch.cuda.synchronize()
    assert _rel(got, ref.ref_ell_hvp_mm_t(dataT, colsT, U, c)) <= 1e-5
    # and against the two-pass pair of ell_mm kernels
    two_pass = sparse_hvp.ell_mm(data, cols,
                                 sparse_hvp.ell_mm(dataT, colsT, U), c)
    assert _rel(got, two_pass) <= 1e-5


def _forward_of(ell):
    """The forward layout of A whose transposed layout is ``ell`` (tiles
    of A^T), for the two-pass pair."""
    nb, w, br, bc = ell.data.shape
    M = np.zeros((nb * br, ell.n_col_blocks * bc), np.float32)
    for i in range(nb):
        for k in range(w):
            j = ell.cols[i, k]
            M[i * br:(i + 1) * br, j * bc:(j + 1) * bc] += ell.data[i, k]
    return ell_from_csr(CSRMatrix.from_dense(np.ascontiguousarray(M.T)),
                        bc, br)


def _hvp_schedule(dataT, colsT, steps):
    """The step schedule of a test: None (every slot live), the default
    step_bytes, one below a row-block's tiles (every row-block a step
    alone) or one above the whole layout (one step)."""
    if steps == "none":
        return None
    step_bytes = {"default": None, "small": 1, "whole": 1 << 40}[steps]
    return sparse_hvp.ell_hvp_schedule(dataT, colsT,
                                       sparse_hvp.default_ctas(dataT.device),
                                       step_bytes)


@pytest.mark.parametrize("name", EDGE_LAYOUTS + ["6x12"])
@pytest.mark.parametrize("steps", ["none", "default", "small", "whole"])
def test_cuda_ell_hvp_edge_layouts(dev, name, steps):
    """K2 and K7 on an edge layout taken as the transposed layout (6 x 12:
    partial z of 6 s floats, summed as floats, not float4), with its step
    schedule at three step sizes or without one, with and without c, K7
    at every s on contiguous and strided U: against their plain versions
    and against the two-pass pair (ell_mv / ell_mm on the transposed,
    then the forward layout), on the copy path the shape calls for. With
    a schedule, NaN in every padding slot changes nothing."""
    ell, path = _edge_layout(name)
    fwd = _forward_of(ell)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    dataT, colsT, data, cols = T(ell.data), T(ell.cols), T(fwd.data), \
        T(fwd.cols)
    nb, w, R, C = dataT.shape
    n_u, n_c = ell.n_col_blocks * C, nb * R
    sched = _hvp_schedule(dataT, colsT, steps)
    if sched is not None:
        live = sched.parts()[0].long()
        dataT[torch.arange(w, device=dev)[None, :] >= live[:, None]] = \
            float("nan")
        assert sched.steps == {"default": sched.steps, "small":
                               int((live > 0).sum()), "whole": 1}[steps]
    g = torch.Generator(device=dev).manual_seed(len(name))
    u = torch.randn(n_u, generator=g, device=dev)
    clean = T(ell.data)
    for c in (None, torch.rand(n_c, generator=g, device=dev)):
        got = sparse_hvp.ell_hvp(dataT, colsT, u, c, sched=sched)
        assert sparse_hvp.last_path["ell_hvp"] == path
        two_pass = sparse_hvp.ell_mv(data, cols,
                                     sparse_hvp.ell_mv(clean, colsT, u), c)
        torch.cuda.synchronize()
        assert got.shape == (n_u,) and bool(got.isfinite().all())
        assert _rel(got, ref.ref_ell_hvp_t(clean, colsT, u, c)) <= 1e-5
        assert _rel(got, two_pass) <= 1e-5
        for s in MULTI_S:
            for strided in (False, True):
                U = _basis(dev, n_u, s, s, strided)
                got = sparse_hvp.ell_hvp_mm(dataT, colsT, U, c, sched=sched)
                assert sparse_hvp.last_path["ell_hvp_mm"] == path
                two_pass = sparse_hvp.ell_mm(
                    data, cols, sparse_hvp.ell_mm(clean, colsT, U), c)
                torch.cuda.synchronize()
                assert got.shape == (n_u, s)
                assert bool(got.isfinite().all())
                assert _rel(got, ref.ref_ell_hvp_mm_t(clean, colsT, U,
                                                      c)) <= 1e-5
                assert _rel(got, two_pass) <= 1e-5
    if sched is not None:      # the counters are back at zero
        assert int(sched.state[:nb].abs().sum()) == 0


def test_cuda_ell_hvp_ops_pass_the_schedule(dev):
    """``ops.ell_hvp`` and ``ops.ell_hvp_mm`` hand ``sched`` to the
    kernels (past 8 columns too): poisoned padding stays out."""
    ell, _ = _edge_layout("16x16")
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    clean, colsT = T(ell.data), T(ell.cols)
    sched = _hvp_schedule(clean, colsT, "default")
    nb, w = clean.shape[:2]
    poisoned = clean.clone()
    poisoned[torch.arange(w, device=dev)[None, :]
             >= sched.parts()[0].long()[:, None]] = float("nan")
    n_u = ell.n_col_blocks * 16
    u, U = torch.randn(n_u, device=dev), torch.randn((n_u, 11), device=dev)
    c = torch.rand(nb * 16, device=dev)
    build.reset_launch_counts()
    y = ops.ell_hvp(poisoned, colsT, u, c, sched=sched)
    Y = ops.ell_hvp_mm(poisoned, colsT, U, c, sched=sched)
    torch.cuda.synchronize()
    assert build.launch_counts()["ell_hvp"] == 1
    assert build.launch_counts()["ell_hvp_mm"] == 2
    assert _rel(y, ref.ref_ell_hvp_t(clean, colsT, u, c)) <= 1e-5
    assert _rel(Y, ref.ref_ell_hvp_mm_t(clean, colsT, U, c)) <= 1e-5


def test_cuda_ell_hvp_refuses_a_grid_the_card_cannot_hold(dev):
    """The grid is launched cooperative: a schedule for more CTAs than
    the card holds at once is refused (raises), never left to spin."""
    ell, _ = _edge_layout("128x128")
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    dataT, colsT = T(ell.data), T(ell.cols)
    sched = sparse_hvp.ell_hvp_schedule(
        dataT, colsT, 8 * sparse_hvp.default_ctas(dev))
    u = torch.randn(ell.n_col_blocks * 128, device=dev)
    with pytest.raises(RuntimeError, match="ell_hvp launch failed"):
        sparse_hvp.ell_hvp(dataT, colsT, u, sched=sched)
    torch.cuda.synchronize()
    # the card is still usable
    got = sparse_hvp.ell_hvp(dataT, colsT, u)
    torch.cuda.synchronize()
    assert _rel(got, ref.ref_ell_hvp_t(dataT, colsT, u)) <= 1e-5


@pytest.mark.parametrize("shape", DENSE_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("s", MULTI_S + [13])
@pytest.mark.parametrize("ctas", [None, 1, 7, 1000])
def test_cuda_dense_multi_kernels_match_plain(dev, shape, s, ctas):
    """K8 and K9 (csrc/dense_multi.cuh) on f32 X, whole rows and as a
    column view at an offset of 1 (the direct path), on strided and
    contiguous blocks, K9 with and without c; on the card's CTA count, on
    fewer CTAs (1, 7) and on more CTAs than pieces (1,000): the path the
    host's rule predicts, within 1e-5 of the plain versions, repeated bit
    for bit. 13 columns go through the ops (two launches)."""
    d, n = shape
    X, _, _, c = _dense(dev, d, n + 1, seed=d + n + s)
    views = (X[:, :n].contiguous(), X[:, 1:])
    U = _basis(dev, d, s, s, strided=True)
    Z = _basis(dev, n, s, s + 1, strided=s % 2 == 1)
    c = c[:n]
    for A in views:
        path = glm_hvp.dense_path(A)
        if s <= 8:
            calls = [("xt_multi", lambda: glm_hvp.xt_multi(A, U, _ctas=ctas),
                      ref.ref_xt_multi(A, U))]
            calls += [("x_cz_multi",
                       lambda cc=cc: glm_hvp.x_cz_multi(A, cc, Z, _ctas=ctas),
                       ref.ref_x_cz_multi(A, cc, Z)) for cc in (None, c)]
        else:
            calls = [("xt_multi", lambda: ops.xt_multi(A, U),
                      ref.ref_xt_multi(A, U))]
            calls += [("x_cz_multi", lambda cc=cc: ops.x_cz_multi(A, cc, Z),
                       ref.ref_x_cz_multi(A, cc, Z)) for cc in (None, c)]
        for name, fn, want in calls:
            got = fn()
            assert glm_hvp.last_path[name] == path
            again = fn()
            torch.cuda.synchronize()
            assert _rel(got, want) <= 1e-5
            assert torch.equal(got, again)                # no atomics


def test_cuda_multi_kernels_refuse_too_many_columns(dev):
    X = torch.ones((8, 16), device=dev)
    with pytest.raises(ValueError, match="1 to 8"):
        glm_hvp.xt_multi(X, torch.ones((8, 9), device=dev))
    with pytest.raises(ValueError, match="1 to 8"):
        glm_hvp.x_cz_multi(X, None, torch.ones((16, 9), device=dev))
    with pytest.raises(ValueError, match="1 to 8"):
        glm_hvp.x_c_xt_multi(X, None, torch.ones((8, 9), device=dev))


@pytest.mark.parametrize("case", [
    ("sparse", "samples", 1, False, 4), ("sparse", "samples", 1, True, 4),
    ("sparse", "features", 1, True, 2), ("sparse", "features", 4, False, 2),
    ("dense", "samples", 1, False, 3), ("dense", "features", 4, True, 2),
    ("dense", "samples", 1, True, 3), ("dense", "samples", 4, True, 2),
    ("dense", "features", 1, True, 2)],
    ids=lambda c: "-".join(map(str, c)))
def test_cuda_sstep_disco_fit_matches_cpu(dev, case):
    """A small s-step solve on the card equals the same solve on the CPU,
    and launches the multi-vector kernels of its round. DiSCO-F runs at
    s = 2: at s = 4 its monomial basis is so ill-conditioned that f32
    rounding in another order moves w by up to about 1e-4 (the JAX
    package against itself, tests/test_torch_sstep.py), beyond rtol
    1e-4."""
    kind, partition, m, fused, s = case
    kw = dict(loss="logistic", lam=1e-3, tau=100, max_outer=4,
              grad_tol=0.0, partition=partition, hvp_fused=fused,
              pcg_block_s=s)
    if kind == "sparse":
        X, y, _ = make_sparse_glm_data(d=96, n=200, density=0.2, alpha=0.8,
                                       beta=0.5, seed=1)
        kw.update(ell_block_d=16, ell_block_n=16)
        round_kernels = ("ell_hvp_mm",) if fused else ("ell_mm",)
    else:
        X, y, _ = make_glm_data(d=98, n=202, seed=1)
        kw.update(use_kernel=True)
        round_kernels = (("x_c_xt_multi",)
                         if fused and (partition == "samples" or m == 1)
                         else ("xt_multi", "x_cz_multi"))
    cfg = DiscoConfig(**kw)
    build.reset_launch_counts()
    on_card = disco_fit(X, y, cfg, group=InProcessGroup(m))
    counts = build.launch_counts()
    on_cpu = disco_fit(X, y, cfg, group=InProcessGroup(m), device="cpu")
    np.testing.assert_allclose(on_card.w, on_cpu.w, rtol=1e-4, atol=1e-6)
    assert [h["pcg_iters"] for h in on_card.history] == \
        [h["pcg_iters"] for h in on_cpu.history]
    for k in round_kernels:
        assert counts[k] > 0, (k, counts)


def _small_problem(kind):
    if kind == "sparse":
        X, y, _ = make_sparse_glm_data(d=96, n=200, density=0.2, alpha=0.8,
                                       beta=0.5, seed=1)
        return X, y, dict(ell_block_d=16, ell_block_n=16), "ell_mv"
    X, y, _ = make_glm_data(d=98, n=202, seed=1)
    return X, y, dict(use_kernel=True), "xt_u"


@pytest.mark.parametrize("kind", ["sparse", "dense"])
@pytest.mark.parametrize("m,s", [(1, 1), (4, 1), (1, 3)])
def test_cuda_sag_disco_fit_matches_cpu(dev, kind, m, s):
    """The original DiSCO (``precond='sag'``, DiSCO-S) on the card equals
    the same solve on the CPU (w within rtol 1e-4 / atol 1e-6, the same
    PCG iterations), its HVPs on the kernels."""
    X, y, kw, kernel = _small_problem(kind)
    cfg = DiscoConfig(loss="logistic", lam=1e-3, tau=100, max_outer=4,
                      grad_tol=0.0, partition="samples", precond="sag",
                      sag_epochs=5, pcg_block_s=s, **kw)
    build.reset_launch_counts()
    on_card = disco_fit(X, y, cfg, group=InProcessGroup(m))
    counts = build.launch_counts()
    on_cpu = disco_fit(X, y, cfg, group=InProcessGroup(m), device="cpu")
    np.testing.assert_allclose(on_card.w, on_cpu.w, rtol=1e-4, atol=1e-6)
    assert [h["pcg_iters"] for h in on_card.history] == \
        [h["pcg_iters"] for h in on_cpu.history]
    assert counts[kernel] > 0, counts


def test_cuda_sag_solve_matches_cpu(dev):
    """``sag_solve`` at the rcv1 slab's width (d = 47,236, tau = 100):
    card against CPU within relative L2 1e-5."""
    from repro_torch.core.preconditioner import sag_solve
    rng = np.random.default_rng(0)
    X_tau = (rng.standard_normal((47236, 100)) * (rng.random((47236, 100))
                                                  < 0.004)).astype(np.float32)
    coeffs = rng.uniform(0.05, 0.25, 100).astype(np.float32)
    r = rng.standard_normal(47236).astype(np.float32) * 1e-3
    T = torch.from_numpy
    want = sag_solve(T(X_tau), T(coeffs), 1e-4, 1e-2, T(r))
    got = sag_solve(T(X_tau).to(dev), T(coeffs).to(dev), 1e-4, 1e-2,
                    T(r).to(dev))
    assert _rel(got.cpu(), want) <= 1e-5


@pytest.mark.parametrize("kind", ["sparse", "dense"])
@pytest.mark.parametrize("partition", ["samples", "features"])
@pytest.mark.parametrize("m", [1, 4])
def test_cuda_subsampled_disco_fit_matches_cpu(dev, kind, partition, m):
    """Hessian subsampling with the same seed on the card and the CPU: the
    same masks (drawn on the CPU), so the same solve (w within rtol 1e-4
    / atol 1e-6, the same PCG iterations)."""
    X, y, kw, _ = _small_problem(kind)
    cfg = DiscoConfig(loss="logistic", lam=1e-2, tau=100, max_outer=4,
                      grad_tol=0.0, partition=partition,
                      hessian_subsample=0.5, seed=3, **kw)
    on_card = disco_fit(X, y, cfg, group=InProcessGroup(m))
    on_cpu = disco_fit(X, y, cfg, group=InProcessGroup(m), device="cpu")
    np.testing.assert_allclose(on_card.w, on_cpu.w, rtol=1e-4, atol=1e-6)
    assert [h["pcg_iters"] for h in on_card.history] == \
        [h["pcg_iters"] for h in on_cpu.history]


@pytest.mark.parametrize("loss", ["logistic", "quadratic"])
def test_cuda_baselines_match_cpu(dev, loss):
    """GD, DANE and CoCoA+ on the card equal the same fits on the CPU
    (per-iteration gradient norms within rtol 1e-4, w within rtol 1e-4 /
    atol 1e-6, equal ledgers)."""
    from repro_torch.core.baselines import (CocoaConfig, DaneConfig,
                                            GDConfig, cocoa_fit, dane_fit,
                                            gd_fit)
    X, y, _ = make_glm_data(d=40, n=202, seed=2)
    for fit, cfg in ((gd_fit, GDConfig(loss=loss, lam=1e-3, max_outer=8)),
                     (dane_fit, DaneConfig(loss=loss, lam=1e-3,
                                           max_outer=3)),
                     (cocoa_fit, CocoaConfig(loss=loss, lam=1e-3,
                                             max_outer=3))):
        for m in (1, 4):
            a = fit(X, y, cfg, group=InProcessGroup(m))
            b = fit(X, y, cfg, group=InProcessGroup(m), device="cpu")
            np.testing.assert_allclose(a[0], b[0], rtol=1e-4, atol=1e-6)
            np.testing.assert_allclose([h["grad_norm"] for h in a[1]],
                                       [h["grad_norm"] for h in b[1]],
                                       rtol=1e-4)
            assert a[2] == b[2]


# ---------------------------------------------------------------------------
# the fused multi-vector kernel (x_c_xt_multi), the column split, and the
# entry points on it
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", DENSE_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("s", MULTI_S)
@pytest.mark.parametrize("with_c", [False, True])
def test_cuda_x_c_xt_multi_matches_plain(dev, shape, s, with_c):
    """On every cluster size the fit rule allows, on contiguous and
    strided U: the plain version (relative L2 <= 1e-5), repeatable bit for
    bit; and the kernel against the xt_multi + x_cz_multi pair and, column
    by column, against x_c_xt_u."""
    d, n = shape
    X, _, _, c = _dense(dev, d, n, seed=d + n + s)
    c = c if with_c else None
    for strided in (False, True):
        U = _basis(dev, d, s, 7 * s, strided=strided)
        want = ref.ref_x_c_xt_multi(X, c, U)
        sizes = [q for q in glm_hvp.CLUSTER_SIZES
                 if glm_hvp.fused_plan(d, s, q) is not None]
        assert sizes
        for q in sizes:
            got = glm_hvp.x_c_xt_multi(X, c, U, _cluster=q)
            torch.cuda.synchronize()
            assert _rel(got, want) <= 1e-5, (q, strided)
            assert torch.equal(got, glm_hvp.x_c_xt_multi(X, c, U,
                                                         _cluster=q))
    got = glm_hvp.x_c_xt_multi(X, c, U)
    pair = glm_hvp.x_cz_multi(X, c, glm_hvp.xt_multi(X, U))
    assert _rel(got, pair) <= 1e-5
    for k in range(s):
        col = glm_hvp.x_c_xt_u(X, c, U[:, k].contiguous())
        assert _rel(got[:, k], col) <= 1e-5


def test_cuda_multi_ops_split_columns(dev):
    """Every multi-vector op at 20 columns: launches of 8, 8 and 4
    columns, joined, equal to one plain call (relative L2 <= 1e-5)."""
    X, _, _, c = _dense(dev, 200, 300, seed=9)
    U = _basis(dev, 200, 20, 1, strided=False)
    Z = _basis(dev, 300, 20, 2, strided=True)
    fwd, tr = _layouts(16)
    T = lambda a: torch.from_numpy(a).to(dev)
    data, cols, dataT, colsT = map(T, (fwd.data, fwd.cols, tr.data,
                                       tr.cols))
    V = _basis(dev, fwd.n_col_blocks * 16, 20, 3, strided=False)
    W = _basis(dev, fwd.n_row_blocks * 16, 20, 4, strided=True)
    cv = torch.rand(fwd.n_col_blocks * 16, device=dev)
    build.reset_launch_counts()
    cases = [
        (ops.xt_multi(X, U), ref.ref_xt_multi(X, U)),
        (ops.x_cz_multi(X, c, Z), ref.ref_x_cz_multi(X, c, Z)),
        (ops.x_c_xt_multi(X, c, U), ref.ref_x_c_xt_multi(X, c, U)),
        (ops.ell_matmat(data, cols, V, cv), ref.ref_ell_mm(data, cols, V,
                                                           cv)),
        (ops.ell_hvp_mm(dataT, colsT, W, cv),
         ref.ref_ell_hvp_mm_t(dataT, colsT, W, cv))]
    counts = build.launch_counts()
    for name in ("xt_multi", "x_cz_multi", "x_c_xt_multi", "ell_mm",
                 "ell_hvp_mm"):
        assert counts[name] == 3, (name, counts)
    for got, want in cases:
        assert got.shape == want.shape and _rel(got, want) <= 1e-5


@pytest.mark.parametrize("partition,m,s,use_kernel", [
    ("samples", 1, 1, True), ("samples", 1, 2, True),
    ("samples", 4, 2, False), ("features", 4, 1, True),
    ("features", 4, 2, True)], ids=lambda v: str(v))
def test_cuda_softmax_fit_matches_cpu(dev, partition, m, s, use_kernel):
    """A small softmax solve (K = 10 classes, so every HVP is a column
    split of 8 + 2) on the card equals the same solve on the CPU."""
    from repro_torch import SoftmaxConfig, softmax_fit
    X, _, _ = make_glm_data(d=40, n=301, seed=3)
    rng = np.random.default_rng(2)
    y = np.argmax(X.T @ rng.standard_normal((40, 10))
                  + 0.1 * rng.standard_normal((301, 10)), axis=1)
    cfg = SoftmaxConfig(lam=1e-3, partition=partition, pcg_block_s=s,
                        use_kernel=use_kernel, max_outer=4, grad_tol=0.0,
                        tau=64)
    build.reset_launch_counts()
    on_card = softmax_fit(X, y, cfg, group=InProcessGroup(m))
    counts = build.launch_counts()
    on_cpu = softmax_fit(X, y, cfg, group=InProcessGroup(m), device="cpu")
    np.testing.assert_allclose(on_card.W, on_cpu.W, rtol=1e-4, atol=1e-6)
    assert [h["pcg_iters"] for h in on_card.history] == \
        [h["pcg_iters"] for h in on_cpu.history]
    if use_kernel:
        assert counts["xt_multi"] > 0 and counts["x_cz_multi"] > 0


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("K", [5, 13])
def test_cuda_softmax_hvp_matches_plain(dev, weighted, K):
    """``ops.softmax_hvp`` on the card (K8, the class coupling, K9; at
    K = 13 in column groups of 8 + 5) against the plain
    ``ref.ref_softmax_hvp`` on the same inputs (relative L2 1e-5), with
    ``lam``, ``n_global`` and, weighted, a 0/1 mask of padded samples."""
    rng = np.random.default_rng(10 * K + weighted)
    d, n = 300, 517
    T = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    X = T(rng.standard_normal((d, n)))
    P = ref.ref_softmax_probs(T(rng.standard_normal((n, K))))
    U = T(rng.standard_normal((d, K)))
    wts = T(rng.uniform(size=n) > 0.2) if weighted else None
    build.reset_launch_counts()
    got = ops.softmax_hvp(X, P, U, lam=1e-3, n_global=2 * n, weights=wts)
    counts = build.launch_counts()
    groups = -(-K // build.MAX_COLS)
    assert counts["xt_multi"] == counts["x_cz_multi"] == groups, counts
    want = ref.ref_softmax_hvp(X, P, U, 1e-3, n_global=2 * n, weights=wts)
    assert got.shape == (d, K) and _rel(got, want) <= 1e-5


def test_cuda_lambda_path_matches_cpu(dev):
    """A small λ-path on the fused dense s-step solve (x_c_xt_multi in
    every round) on the card equals the same path on the CPU."""
    from repro_torch import lambda_path_fit
    X, y, _ = make_glm_data(d=98, n=202, seed=1)
    Xv, yv, _ = make_glm_data(d=98, n=150, seed=2)
    cfg = DiscoConfig(loss="logistic", tau=100, max_outer=6, grad_tol=1e-6,
                      partition="samples", use_kernel=True, hvp_fused=True,
                      pcg_block_s=3)
    build.reset_launch_counts()
    on_card = lambda_path_fit(X, y, [1e-2, 1e-3, 1e-4], cfg, X_val=Xv,
                              y_val=yv)
    assert build.launch_counts()["x_c_xt_multi"] > 0
    on_cpu = lambda_path_fit(X, y, [1e-2, 1e-3, 1e-4], cfg, X_val=Xv,
                             y_val=yv, device="cpu")
    assert on_card.x_passes == on_cpu.x_passes
    assert on_card.best_lambda == on_cpu.best_lambda
    np.testing.assert_allclose(on_card.val_losses, on_cpu.val_losses,
                               rtol=1e-5)
    for a, b in zip(on_card.results, on_cpu.results):
        np.testing.assert_allclose(a.w, b.w, rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# flash attention (K11) and the dense decoders
# ---------------------------------------------------------------------------

FLASH_CASES = [
    # B, Hq, Hkv, S, T, Dh, causal, window, kv_len
    (2, 4, 2, 128, 128, 64, True, 0, None),
    (1, 8, 2, 256, 256, 64, True, 64, None),
    (2, 2, 2, 96, 96, 32, False, 0, None),
    (1, 16, 1, 97, 97, 128, True, 0, None),
    (1, 5, 1, 63, 200, 128, False, 50, 150),
    (1, 4, 4, 200, 130, 32, True, 0, 100),
    # the bf16 kernel's edges: 128-row q tiles (64 a warpgroup), 128-key
    # kv tiles, a window inside one tile and one across more than two,
    # kv_len inside the last tile, group 16
    (1, 4, 2, 127, 127, 128, True, 0, None),
    (1, 4, 2, 128, 128, 32, True, 0, None),
    (2, 4, 1, 129, 129, 64, True, 0, None),
    (1, 4, 2, 257, 257, 128, True, 0, None),
    (1, 4, 4, 257, 257, 64, True, 100, None),
    (1, 4, 2, 600, 600, 128, True, 300, None),
    (1, 2, 2, 257, 257, 32, False, 300, None),
    (1, 4, 2, 129, 257, 128, True, 0, 250),
    (1, 8, 2, 300, 300, 64, False, 0, 290),
    (1, 32, 2, 257, 257, 128, True, 0, None),
    (1, 16, 1, 128, 129, 128, False, 0, None),
    # q tiles that attend no key: alone, and paired with one that does
    (1, 4, 1, 600, 97, 32, True, 64, None),
    # Dh = 80 (zamba2-2.7b's shared attention): the bf16 kernel's
    # 128-column tiles, columns 80-127 TMA's zero fill
    (1, 4, 2, 257, 257, 80, True, 100, None),
    (2, 32, 32, 130, 130, 80, True, 0, None),
    (1, 5, 1, 63, 200, 80, False, 50, 150),
]
# contiguous (B, H, S, Dh); a (B, S, H, Dh) tensor transposed, as the
# model passes its projections; the same cut from rows of Dh + 8
FLASH_LAYOUTS = ("contiguous", "head_major", "sliced")


def _flash_inputs(dev, B, Hq, Hkv, S, T, Dh, dtype, seed=0,
                  layout="contiguous"):
    g = torch.Generator(device=dev).manual_seed(seed)
    if layout == "contiguous":
        mk = lambda b, h, n: torch.randn((b, h, n, Dh), device=dev,
                                         generator=g).to(dtype)
    else:
        pad = 8 if layout == "sliced" else 0
        mk = lambda b, h, n: torch.randn(
            (b, n, h, Dh + pad), device=dev,
            generator=g).to(dtype)[..., :Dh].transpose(1, 2)
    return mk(B, Hq, S), mk(B, Hkv, T), mk(B, Hkv, T)


@pytest.mark.parametrize("layout", FLASH_LAYOUTS)
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_flash_attention_matches_plain(dev, case, dtype, layout):
    """Relative L2 <= 1e-5 in f32 against the plain version in full f32
    (TF32 off); in bf16 <= 1e-2 against the plain version in f32 on the
    same bf16 inputs (the output's rounding). Bit-for-bit repeatable. The
    output of a transposed (B, S, H, Dh) view lies the same way."""
    from repro_torch.kernels import flash_attention as flash
    B, Hq, Hkv, S, T, Dh, causal, window, kv_len = case
    q, k, v = _flash_inputs(dev, B, Hq, Hkv, S, T, Dh, dtype, layout=layout)
    torch.backends.cuda.matmul.allow_tf32 = False
    build.reset_launch_counts()
    got = flash.flash_attention(q, k, v, causal=causal, window=window,
                                kv_len=kv_len)
    again = flash.flash_attention(q, k, v, causal=causal, window=window,
                                  kv_len=kv_len)
    torch.cuda.synchronize()
    assert build.launch_counts()["flash_attention"] == 2
    assert got.dtype == dtype and torch.equal(got, again)
    assert got.transpose(1, 2).is_contiguous() == (layout == "head_major")
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                   causal=causal, window=window,
                                   kv_len=kv_len)
    assert _rel(got.float(), want) <= (1e-5 if dtype == torch.float32
                                       else 1e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_flash_attention_without_keys_is_zero(dev, dtype):
    """kv_len = 0: no q tile has a key to attend, and every row is 0."""
    from repro_torch.kernels import flash_attention as flash
    q, k, v = _flash_inputs(dev, 1, 2, 1, 130, 64, 64, dtype)
    got = flash.flash_attention(q, k, v, causal=False, kv_len=0)
    torch.cuda.synchronize()
    assert torch.equal(got, torch.zeros_like(got))


@pytest.mark.parametrize("scale", [0.3, -0.2, 0.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_flash_attention_scale(dev, scale, dtype):
    """Any scale, a negative one and 0 included (the bf16 kernel takes the
    max of the raw scores, or their min under a negative scale)."""
    from repro_torch.kernels import flash_attention as flash
    q, k, v = _flash_inputs(dev, 1, 4, 2, 300, 300, 128, dtype, seed=5)
    got = flash.flash_attention(q, k, v, causal=True, window=200,
                                scale=scale)
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                   causal=True, window=200, scale=scale)
    assert _rel(got.float(), want) <= (1e-5 if dtype == torch.float32
                                       else 1e-2)


@pytest.mark.parametrize("Dh", [32, 64, 80, 128])
@pytest.mark.parametrize("S", [100, 256])
def test_cuda_flash_attention_one_key_per_row(dev, Dh, S):
    """Each q row scores one key far above the rest, so P is a permutation
    and the bf16 kernel's output is that key's v row exactly: a check of
    the S accumulator -> P operand -> P V fragment layouts and of the
    swizzled K and V tiles."""
    from repro_torch.kernels import flash_attention as flash
    g = torch.Generator(device=dev).manual_seed(Dh + S)
    T = 256
    perm = torch.randperm(T, generator=g, device=dev)[:S]
    keys = torch.randn((T, Dh), generator=g, device=dev)
    keys = 40 * keys / keys.norm(dim=1, keepdim=True)
    q = keys[perm].to(torch.bfloat16)[None, None]
    k = keys.to(torch.bfloat16)[None, None]
    v = torch.randn((1, 1, T, Dh), generator=g, device=dev).to(torch.bfloat16)
    got = flash.flash_attention(q, k, v, causal=False, scale=1.0)
    torch.cuda.synchronize()
    assert torch.equal(got[0, 0], v[0, 0][perm])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("window", [0, 512])
def test_cuda_flash_attention_head_dim_80(dev, dtype, window):
    """K11 at zamba2-2.7b's heads (32, Dh = 80) on head-major views of
    (B, S, H, Dh) projections, as its shared attention passes them, in
    f32 (<= 1e-5) and bf16 (<= 1e-2, and at most 1.5 times the error of
    rounding the plain f32 output to bf16); repeated bit for bit."""
    from repro_torch.kernels import flash_attention as flash
    q, k, v = _flash_inputs(dev, 2, 32, 32, 1100, 1100, 80, dtype, seed=8,
                            layout="head_major")
    torch.backends.cuda.matmul.allow_tf32 = False
    got = flash.flash_attention(q, k, v, causal=True, window=window)
    again = flash.flash_attention(q, k, v, causal=True, window=window)
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                   causal=True, window=window)
    assert torch.equal(got, again) and got.transpose(1, 2).is_contiguous()
    e = _rel(got.float(), want)
    if dtype == torch.float32:
        assert e <= 1e-5
    else:
        assert e <= 1e-2
        assert e <= 1.5 * _rel(want.to(torch.bfloat16).float(), want)


def test_cuda_dense_decoder_matches_cpu(dev):
    """chatglm3-6b's smoke config (GQA, partial RoPE, QKV bias) in f32:
    prefill and decode on the card equal the CPU's (relative L2 <= 1e-4:
    f32 sums in another order through two layers), and the prefill runs
    one flash launch per layer, decode none."""
    from repro_torch import (Engine, Request, decode_step, forward,
                             get_smoke_config, init_cache, init_params)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config("chatglm3-6b")
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    on_cpu = init_params(cfg, device="cpu")
    on_cpu.load_state_dict(model.state_dict())
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 40))
    build.reset_launch_counts()
    got, _ = forward(cfg, model, {"tokens": tokens})
    assert build.launch_counts()["flash_attention"] == cfg.num_layers
    want, _ = forward(cfg, on_cpu, {"tokens": tokens})
    assert _rel(got.cpu(), want) <= 1e-4
    cache = init_cache(cfg, 2, 48)
    build.reset_launch_counts()
    for t in range(8):
        step, cache = decode_step(cfg, model, tokens[:, t:t + 1], cache)
        assert _rel(step[:, 0].cpu(), want[:, t]) <= 1e-4
    assert build.launch_counts()["flash_attention"] == 0
    reqs = [Request(prompt=[5, 6, 7], max_new_tokens=5)]
    assert Engine(cfg, model, batch_size=2, max_len=32).generate(reqs)[0] \
        .tokens == Engine(cfg, on_cpu, batch_size=2,
                          max_len=32).generate(reqs)[0].tokens


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "qwen3-moe-30b-a3b"])
def test_cuda_moe_decoder_matches_cpu(dev, arch):
    """The MoE smoke configs in f32 (mixtral's at window 16, so the mask
    acts): the routing tables of every layer on the card equal the CPU's,
    prefill and decode equal the CPU's (relative L2 <= 1e-4), the prefill
    runs one flash launch per layer and repeats bit for bit, decode none,
    and greedy serving gives the CPU's tokens."""
    from repro_torch import (Engine, Request, decode_step, forward,
                             get_smoke_config, init_cache, init_params)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config(arch).replace(capacity_factor=4.0)
    if cfg.attention == "sliding":
        cfg = cfg.replace(window=16)
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    on_cpu = init_params(cfg, device="cpu")
    on_cpu.load_state_dict(model.state_dict())
    assert model.layers[0].moe.router.dtype == torch.float32
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 40))
    layers = [(a.moe, b.moe) for a, b in zip(model.layers, on_cpu.layers)]
    for a, b in layers:
        a.routes, b.routes = [], []
    build.reset_launch_counts()
    got, aux = forward(cfg, model, {"tokens": tokens})
    assert build.launch_counts()["flash_attention"] == cfg.num_layers
    want, want_aux = forward(cfg, on_cpu, {"tokens": tokens})
    tables = [(a.routes[0][2], b.routes[0][2]) for a, b in layers]
    for a, b in layers:
        a.routes = b.routes = None
    for a, b in tables:
        assert torch.equal(a.sel.cpu(), b.sel)
        assert torch.equal(a.buf_tok.cpu(), b.buf_tok)
        assert torch.equal(a.tok_slot.cpu(), b.tok_slot)
    assert _rel(got.cpu(), want) <= 1e-4
    assert abs(float(aux) - float(want_aux)) <= 1e-5 * float(want_aux)
    assert torch.equal(got, forward(cfg, model, {"tokens": tokens})[0])
    cache = init_cache(cfg, 2, 48)
    build.reset_launch_counts()
    for t in range(24):
        step, cache = decode_step(cfg, model, tokens[:, t:t + 1], cache)
        assert _rel(step[:, 0].cpu(), want[:, t]) <= 1e-4
    assert build.launch_counts()["flash_attention"] == 0
    reqs = [Request(prompt=[5, 6, 7], max_new_tokens=5)]
    assert Engine(cfg, model, batch_size=2, max_len=32).generate(reqs)[0] \
        .tokens == Engine(cfg, on_cpu, batch_size=2,
                          max_len=32).generate(reqs)[0].tokens


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-2.7b"])
def test_cuda_ssm_and_hybrid_decoders_match_cpu(dev, arch):
    """The SSM and hybrid smoke configs in f32 over 80 tokens (past
    zamba2-smoke's window of 64, across chunks of 32): prefill and decode
    on the card equal the CPU's (relative L2 <= 1e-4), the prefill repeats
    bit for bit and runs one flash launch per shared-block invocation
    (none in the SSM), decode none, and greedy serving gives the CPU's
    tokens."""
    from repro_torch import (Engine, Request, decode_step, forward,
                             get_smoke_config, init_cache, init_params)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config(arch)
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    on_cpu = init_params(cfg, device="cpu")
    on_cpu.load_state_dict(model.state_dict())
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 80))
    build.reset_launch_counts()
    got, _ = forward(cfg, model, {"tokens": tokens})
    invocations = (cfg.num_layers // cfg.shared_attn_period
                   if cfg.arch_type == "hybrid" else 0)
    assert build.launch_counts()["flash_attention"] == invocations
    want, _ = forward(cfg, on_cpu, {"tokens": tokens})
    assert _rel(got.cpu(), want) <= 1e-4
    assert torch.equal(got, forward(cfg, model, {"tokens": tokens})[0])
    cache = init_cache(cfg, 2, 96)
    build.reset_launch_counts()
    for t in range(80):
        step, cache = decode_step(cfg, model, tokens[:, t:t + 1], cache)
        assert _rel(step[:, 0].cpu(), want[:, t]) <= 1e-4
    assert build.launch_counts()["flash_attention"] == 0
    reqs = [Request(prompt=[5, 6, 7], max_new_tokens=5)]
    assert Engine(cfg, model, batch_size=2, max_len=32).generate(reqs)[0] \
        .tokens == Engine(cfg, on_cpu, batch_size=2,
                          max_len=32).generate(reqs)[0].tokens


# ---------------------------------------------------------------------------
# bf16 tiles: the bf16 instances of K1, K2, K6 and K7
# ---------------------------------------------------------------------------

def _bf16_path(bc):
    """The copy path a bf16 layout takes: bulk when a tile row is a
    multiple of 16 bytes."""
    return "bulk" if bc % 8 == 0 else "direct"


@pytest.mark.parametrize("name", EDGE_LAYOUTS)
def test_cuda_bf16_ell_mv_mm_match_plain(dev, name):
    """K1 and K6 on bf16 tiles against their plain versions on the same
    tiles, with and without the schedule and c, K6 at every s on a
    strided V; repeated bit for bit, on the path the shape calls for; the
    bf16 instances counted, not the f32 ones."""
    ell, _ = _edge_layout(name)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    data, cols = T(ell.data).to(torch.bfloat16), T(ell.cols)
    nb, _, br, bc = data.shape
    n_in = ell.n_col_blocks * bc
    g = torch.Generator(device=dev).manual_seed(len(name))
    v = torch.randn(n_in, generator=g, device=dev)
    build.reset_launch_counts()
    for sched in (None, sparse_hvp.ell_schedule(
            data, cols, sparse_hvp.default_ctas(dev))):
        for c in (None, torch.rand(n_in, generator=g, device=dev)):
            got = sparse_hvp.ell_mv(data, cols, v, c, sched=sched)
            assert sparse_hvp.last_path["ell_mv_bf16"] == _bf16_path(bc)
            again = sparse_hvp.ell_mv(data, cols, v, c, sched=sched)
            torch.cuda.synchronize()
            assert _rel(got, ref.ref_ell_mv(data, cols, v, c)) <= 1e-5
            assert torch.equal(got, again)
            for s in MULTI_S:
                V = _basis(dev, n_in, s, s, strided=True)
                got = sparse_hvp.ell_mm(data, cols, V, c, sched=sched)
                assert sparse_hvp.last_path["ell_mm_bf16"] == _bf16_path(bc)
                again = sparse_hvp.ell_mm(data, cols, V, c, sched=sched)
                torch.cuda.synchronize()
                assert _rel(got, ref.ref_ell_mm(data, cols, V, c)) <= 1e-5
                assert torch.equal(got, again)
    counts = build.launch_counts()
    assert counts["ell_mv_bf16"] == 8 and counts["ell_mm_bf16"] == 40
    assert counts["ell_mv"] == counts["ell_mm"] == 0


@pytest.mark.parametrize("name", EDGE_LAYOUTS + ["6x12"])
def test_cuda_bf16_ell_hvp_match_plain(dev, name):
    """K2 and K7 on bf16 tiles (an edge layout taken as the transposed
    layout), with the default step schedule (NaN in the padding) and
    without, with and without c, K7 at every s on contiguous and strided
    U: the hand-off against the plain one's rounding (ties aside) and the
    output against the plain pass B of the kernel's hand-off; then
    against the two-pass pair of bf16 K1 / K6 the same way."""
    ell, _ = _edge_layout(name)
    fwd = _forward_of(ell)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    clean = T(ell.data).to(torch.bfloat16)
    colsT = T(ell.cols)
    data, cols = T(fwd.data).to(torch.bfloat16), T(fwd.cols)
    nb, w, R, C = clean.shape
    n_u, n_c = ell.n_col_blocks * C, nb * R
    g = torch.Generator(device=dev).manual_seed(len(name))
    u = torch.randn(n_u, generator=g, device=dev)
    sched = sparse_hvp.ell_hvp_schedule(clean, colsT)
    poisoned = clean.clone()
    live = sched.parts()[0].long()
    poisoned[torch.arange(w, device=dev)[None, :] >= live[:, None]] = \
        float("nan")
    for dataT, sc in ((clean, None), (poisoned, sched)):
        for c in (None, torch.rand(n_c, generator=g, device=dev)):
            for s in MULTI_S:
                for strided in (False, True):
                    U = _basis(dev, n_u, s, s, strided)
                    cz = torch.zeros(n_c * s, device=dev)
                    if s == 1 and not strided:
                        got = sparse_hvp.ell_hvp(dataT, colsT, U[:, 0], c,
                                                 sched=sc, cz_out=cz)
                        assert sparse_hvp.last_path["ell_hvp_bf16"] == \
                            _bf16_path(C)
                        got = got[:, None]
                    else:
                        got = sparse_hvp.ell_hvp_mm(dataT, colsT, U, c,
                                                    sched=sc, cz_out=cz)
                        assert sparse_hvp.last_path["ell_hvp_mm_bf16"] == \
                            _bf16_path(C)
                    z_pair = sparse_hvp.ell_mm(clean, colsT, U)
                    torch.cuda.synchronize()
                    assert bool(got.isfinite().all())
                    cz = cz.reshape(n_c, s)
                    t = ref.ref_ell_handoff_t(clean, colsT, U, c)
                    slack = ref.ell_handoff_slack(clean, colsT, U, c, t)
                    assert ref.ell_handoff_flips(cz, t, slack)[1]
                    assert _rel(got, ref.ref_ell_scatter_t(
                        clean, colsT, cz, n_u)) <= 1e-5
                    t_pair = z_pair if c is None else c[:, None] * z_pair
                    assert ref.ell_handoff_flips(cz, t_pair, slack)[1]
                    assert _rel(got, sparse_hvp.ell_mm(data, cols, cz)) \
                        <= 1e-5
    assert int(sched.state[:nb].abs().sum()) == 0


def test_cuda_bf16_ops_launch_the_bf16_kernels(dev):
    fwd, tr = _layouts(16)
    T = lambda a: torch.from_numpy(a).to(dev)
    bf = lambda a: T(a).to(torch.bfloat16)
    build.reset_launch_counts()
    ops.ell_matvec(bf(fwd.data), T(fwd.cols),
                   torch.ones(fwd.n_col_blocks * 16, device=dev))
    ops.ell_hvp(bf(tr.data), T(tr.cols),
                torch.ones(fwd.n_row_blocks * 16, device=dev),
                fwd=(bf(fwd.data), T(fwd.cols)))
    ops.ell_matmat(bf(fwd.data), T(fwd.cols),
                   torch.ones((fwd.n_col_blocks * 16, 10), device=dev))
    ops.ell_hvp_mm(bf(tr.data), T(tr.cols),
                   torch.ones((fwd.n_row_blocks * 16, 3), device=dev))
    counts = build.launch_counts()
    assert {k: v for k, v in counts.items() if v} == {
        "ell_mv_bf16": 1, "ell_hvp_bf16": 1, "ell_mm_bf16": 2,
        "ell_hvp_mm_bf16": 1}


@pytest.mark.parametrize("partition", ["samples", "features"])
@pytest.mark.parametrize("m,fused,s", [(1, False, 1), (1, True, 1),
                                       (2, False, 1), (1, True, 2),
                                       (2, True, 2)])
def test_cuda_bf16_disco_fit_matches_cpu(dev, partition, m, fused, s):
    """A small bf16 solve on the card against the same solve on the CPU:
    the same PCG iterations (or rounds) every step, and w within relative
    L2 3e-4 (another f32 summation order moves a bf16 solve that far:
    ROADMAP F11, ``tests/test_torch_bf16.py``); the bf16 kernels ran."""
    X, y, _ = make_sparse_glm_data(d=96, n=200, density=0.2, alpha=0.8,
                                   beta=0.5, seed=1)
    cfg = DiscoConfig(loss="logistic", lam=1e-2, tau=100, max_outer=4,
                      grad_tol=0.0, ell_block_d=16, ell_block_n=16,
                      partition=partition, hvp_fused=fused, pcg_block_s=s,
                      hvp_dtype="bfloat16")
    build.reset_launch_counts()
    on_card = disco_fit(X, y, cfg, group=InProcessGroup(m))
    counts = build.launch_counts()
    on_cpu = disco_fit(X, y, cfg, group=InProcessGroup(m), device="cpu")
    assert [h["pcg_iters"] for h in on_card.history] == \
        [h["pcg_iters"] for h in on_cpu.history]
    assert np.linalg.norm(on_card.w - on_cpu.w) <= \
        3e-4 * np.linalg.norm(on_cpu.w)
    # f32 layouts: the margins and the gradient only, one each a shard a
    # step; PCG's products all on the bf16 instances
    assert counts["ell_mv"] == 2 * m * len(on_card.history)
    assert counts["ell_hvp"] == counts["ell_mm"] == counts["ell_hvp_mm"] == 0
    assert sum(counts[k + "_bf16"] for k in ("ell_mv", "ell_hvp", "ell_mm",
                                            "ell_hvp_mm")) > 0


# ---------------------------------------------------------------------------
# bf16 tiles: the bf16 instances of K3, K4, K8 and K9
# ---------------------------------------------------------------------------

def _bf16_dense_edge(dev, name):
    """A bf16 X at an edge of the dense split or of the bulk-copy rule
    (rows of whole 16-byte units: n and the row stride multiples of 8),
    and the copy path it calls for."""
    g = torch.Generator(device=dev).manual_seed(len(name))
    mat = lambda d, n: torch.randn((d, n), generator=g,
                                   device=dev).to(torch.bfloat16)
    wide = mat(64, 3000)
    solver = mat(256, 4096)
    return {
        "ragged_n": (mat(70, 1101), "direct"),
        "d_below_ctas": (mat(5, 2048), "bulk"),
        "n_below_tile": (mat(64, 104), "bulk"),
        "n_4": (mat(64, 100), "direct"),
        "d1_n8": (mat(1, 8), "bulk"),
        "d1_n4": (mat(1, 4), "direct"),
        "view_at_0": (wide[:, 0:1024], "bulk"),
        "view_at_4": (wide[:, 4:1028], "direct"),
        "view_at_8": (wide[:, 8:1032], "bulk"),
        "ld_not_8": (mat(40, 1028)[:, :1024], "direct"),
        "full": (solver, "bulk"),
        "S_m4_view": (solver[:, 1024:2048], "bulk"),
        "S_m4_view_odd": (mat(32, 4 * 1025)[:, 1025:2050], "direct"),
        "F_m4_rows": (solver[64:128], "bulk"),
    }[name]


BF16_DENSE_EDGES = ["ragged_n", "d_below_ctas", "n_below_tile", "n_4",
                    "d1_n8", "d1_n4", "view_at_0", "view_at_4",
                    "view_at_8", "ld_not_8", "full", "S_m4_view",
                    "S_m4_view_odd", "F_m4_rows"]


@pytest.mark.parametrize("name", BF16_DENSE_EDGES)
@pytest.mark.parametrize("ctas", [None, 1, 7])
def test_cuda_bf16_dense_stream_edge_shapes(dev, name, ctas):
    """K3 and K4 on bf16 X at an edge of the split or of the bulk-copy
    rule, on the card's CTA count and on 1 and 7 CTAs, with and without
    c: on the copy path the shape calls for (and the wrapper's mirror
    predicts), within 1e-5 of the plain versions at bf16, repeated bit
    for bit; only the bf16 instances counted."""
    X, path = _bf16_dense_edge(dev, name)
    d, n = X.shape
    g = torch.Generator(device=dev).manual_seed(d * n)
    u = torch.randn(d, generator=g, device=dev)
    z = torch.randn(n, generator=g, device=dev)
    c = torch.rand(n, generator=g, device=dev)
    assert glm_hvp.dense_path(X, c, z) == path
    build.reset_launch_counts()
    got = glm_hvp.xt_u(X, u, _ctas=ctas)
    assert glm_hvp.last_path["xt_u_bf16"] == path
    again = glm_hvp.xt_u(X, u, _ctas=ctas)
    torch.cuda.synchronize()
    assert got.shape == (n,) and got.dtype == torch.float32
    assert _rel(got, ref.ref_xt_u(X, u)) <= 1e-5
    assert torch.equal(got, again)
    for cc in (None, c):
        got = glm_hvp.x_cz(X, cc, z, _ctas=ctas)
        assert glm_hvp.last_path["x_cz_bf16"] == path
        again = glm_hvp.x_cz(X, cc, z, _ctas=ctas)
        torch.cuda.synchronize()
        assert got.shape == (d,)
        want = ref.ref_x_cz(X, z if cc is None else cc * z)
        assert _rel(got, want) <= 1e-5
        assert torch.equal(got, again)
    counts = build.launch_counts()
    assert counts["xt_u_bf16"] == 2 and counts["x_cz_bf16"] == 4
    assert counts["xt_u"] == counts["x_cz"] == 0


@pytest.mark.parametrize("shape", DENSE_SHAPES + [(256, 4096)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("s", MULTI_S + [13])
@pytest.mark.parametrize("ctas", [None, 1, 7, 1000])
def test_cuda_bf16_dense_multi_match_plain(dev, shape, s, ctas):
    """K8 and K9 on bf16 X (the tensor cores), whole rows and as column
    views at offsets 1, 4 and 8 and a row stride not a multiple of 8, with
    and without c, on strided U and Z; on the card's CTA count, on fewer
    CTAs and on more CTAs than pieces: the path the host's rule predicts,
    within 1e-5 of the plain versions at bf16, repeated bit for bit. 13
    columns go through the ops (two launches)."""
    d, n = shape
    g = torch.Generator(device=dev).manual_seed(d * n + s)
    wide = torch.randn((d, n + 8), generator=g,
                       device=dev).to(torch.bfloat16)
    odd = torch.randn((d, n + 4), generator=g,
                      device=dev).to(torch.bfloat16)
    c = torch.rand(n, generator=g, device=dev)
    U = _basis(dev, d, s, s, strided=True)
    Z = _basis(dev, n, s, s + 1, strided=True)
    for X in (wide[:, :n].contiguous(), wide[:, 1:n + 1], wide[:, 4:n + 4],
              wide[:, 8:], odd[:, :n]):
        path = glm_hvp.dense_path(X)
        for cc in (None, c):
            for name, got_fn, want in (
                    ("xt_multi_bf16",
                     lambda: (glm_hvp.xt_multi(X, U, _ctas=ctas) if s <= 8
                              else ops.xt_multi(X, U)),
                     ref.ref_xt_multi(X, U)),
                    ("x_cz_multi_bf16",
                     lambda: (glm_hvp.x_cz_multi(X, cc, Z, _ctas=ctas)
                              if s <= 8 else ops.x_cz_multi(X, cc, Z)),
                     ref.ref_x_cz_multi(X, cc, Z))):
                got = got_fn()
                assert glm_hvp.last_path[name] == path
                again = got_fn()
                torch.cuda.synchronize()
                assert got.dtype == torch.float32
                assert _rel(got, want) <= 1e-5
                assert torch.equal(got, again)


def test_cuda_bf16_dense_dispatch(dev):
    """The ops dispatch by X's dtype: bf16 X launches the bf16 instances
    only (13 columns: two launches each), the one-pass ones included, f32
    X the f32 kernels only; past the bf16 fit rule's reach (d = 12,289 at
    one column, 6,145 at eight) the one-pass ops take the bf16 two-pass
    pair; any other dtype is refused before a launch."""
    X, u, z, c = _dense(dev, 64, 256, seed=8)
    Xh = X.to(torch.bfloat16)
    U = torch.ones((64, 13), device=dev)
    Z = torch.ones((256, 13), device=dev)
    build.reset_launch_counts()
    ops.xt_u(Xh, u)
    ops.x_cz_local(Xh, c, z)
    ops.xt_multi(Xh, U)
    ops.x_cz_multi(Xh, None, Z)
    ops.x_c_xt_u(Xh, c, u)
    ops.x_c_xt_multi(Xh, c, U)
    assert {k: v for k, v in build.launch_counts().items() if v} == {
        "xt_u_bf16": 1, "x_cz_bf16": 1, "xt_multi_bf16": 2,
        "x_cz_multi_bf16": 2, "x_c_xt_u_bf16": 1, "x_c_xt_multi_bf16": 2}
    build.reset_launch_counts()
    ops.xt_u(X, u)
    ops.xt_multi(X, U[:, :3])
    ops.x_c_xt_u(X, c, u)
    assert {k: v for k, v in build.launch_counts().items() if v} == {
        "xt_u": 1, "xt_multi": 1, "x_c_xt_u": 1}
    bf = torch.bfloat16
    for d, s in ((12_289, 1), (6145, 8)):
        assert glm_hvp.fused_plan(d, s, dtype=bf) is None
        assert glm_hvp.fused_plan(d - 1, s, dtype=bf) is not None
        Xb = torch.randn((d, 64), device=dev).to(bf)
        ub = torch.randn((d, s), device=dev)
        build.reset_launch_counts()
        if s == 1:
            got = ops.x_c_xt_u(Xb, c[:64], ub[:, 0])
            want = ref.ref_x_c_xt_u(Xb, c[:64], ub[:, 0])
            pair = {"xt_u_bf16": 1, "x_cz_bf16": 1}
        else:
            got = ops.x_c_xt_multi(Xb, c[:64], ub)
            want = ref.ref_x_c_xt_multi(Xb, c[:64], ub)
            pair = {"xt_multi_bf16": 1, "x_cz_multi_bf16": 1}
        torch.cuda.synchronize()
        assert {k: v for k, v in build.launch_counts().items() if v} == pair
        assert got.shape == want.shape
        with pytest.raises(ValueError, match="no x_c_xt"):
            (glm_hvp.x_c_xt_u(Xb, c[:64], ub[:, 0]) if s == 1
             else glm_hvp.x_c_xt_multi(Xb, c[:64], ub))
    build.reset_launch_counts()
    for fn in (lambda: glm_hvp.xt_u(X.half(), u),
               lambda: glm_hvp.x_cz_multi(X.half(), c, Z[:, :2]),
               lambda: glm_hvp.x_c_xt_u(X.half(), c, u)):
        with pytest.raises(TypeError):
            fn()
    assert not any(build.launch_counts().values())


def test_cuda_bf16_dense_failed_launch_raises(dev, monkeypatch):
    """A launch the bf16 entry points refuse raises, naming the bf16
    instance: a piece shape other than the header's (K3, K4, K8, K9)."""
    X, u, z, c = _dense(dev, 64, 1024, seed=6)
    Xh = X.to(torch.bfloat16)
    monkeypatch.setattr(glm_hvp, "TILE_ROWS", glm_hvp.TILE_ROWS // 2)
    glm_hvp.dense_split.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="xt_u_bf16 launch failed"):
            glm_hvp.xt_u(Xh, u)
        with pytest.raises(RuntimeError, match="x_cz_bf16 launch failed"):
            glm_hvp.x_cz(Xh, c, z)
    finally:
        glm_hvp.dense_split.cache_clear()
    pieces = dict(glm_hvp.MULTI_PIECES)
    monkeypatch.setitem(glm_hvp.MULTI_PIECES, "xt_multi",
                        tuple((r * 2, b) for r, b in pieces["xt_multi"]))
    monkeypatch.setitem(glm_hvp.MULTI_PIECES, "x_cz_multi",
                        tuple((r * 2, b) for r, b in pieces["x_cz_multi"]))
    glm_hvp.multi_split.cache_clear()
    try:
        with pytest.raises(RuntimeError,
                           match="xt_multi_bf16 launch failed"):
            glm_hvp.xt_multi(Xh, torch.ones((64, 2), device=dev))
        with pytest.raises(RuntimeError,
                           match="x_cz_multi_bf16 launch failed"):
            glm_hvp.x_cz_multi(Xh, c, torch.ones((1024, 2), device=dev))
    finally:
        glm_hvp.multi_split.cache_clear()


@pytest.mark.parametrize("partition", ["samples", "features"])
@pytest.mark.parametrize("m,s,use_kernel", [(1, 1, True), (2, 1, True),
                                            (1, 2, True), (1, 1, False)])
def test_cuda_dense_bf16_disco_fit_matches_cpu(dev, partition, m, s,
                                               use_kernel):
    """A small bf16 dense solve on the card against the same solve on the
    CPU: the same PCG iterations (or rounds) every step, and w within
    relative L2 3e-4 (F11); with the kernels, PCG's products on the bf16
    instances only (the margins and the gradient are cuBLAS on the f32
    X)."""
    X, y, _ = make_glm_data(d=98, n=202, seed=1)
    cfg = DiscoConfig(loss="logistic", lam=1e-3, tau=100, max_outer=4,
                      grad_tol=0.0, partition=partition, pcg_block_s=s,
                      use_kernel=use_kernel, hvp_dtype="bfloat16")
    build.reset_launch_counts()
    on_card = disco_fit(X, y, cfg, group=InProcessGroup(m))
    counts = build.launch_counts()
    on_cpu = disco_fit(X, y, cfg, group=InProcessGroup(m), device="cpu")
    assert [h["pcg_iters"] for h in on_card.history] == \
        [h["pcg_iters"] for h in on_cpu.history]
    assert np.linalg.norm(on_card.w - on_cpu.w) <= \
        3e-4 * np.linalg.norm(on_cpu.w)
    f32 = ("xt_u", "x_cz", "xt_multi", "x_cz_multi", "x_c_xt_u",
           "x_c_xt_multi")
    assert not any(counts[k] for k in f32)
    bf16 = sum(counts[k + "_bf16"] for k in f32[:4])
    assert (bf16 > 0) == use_kernel


# ---------------------------------------------------------------------------
# bf16 tiles: the bf16 instances of K5 and K10
# ---------------------------------------------------------------------------

def _fused_bf16_edge(dev, name):
    """A bf16 X at an edge of the fused kernels' plan and split, and the
    copy path it calls for: a tensor map needs a row stride of whole
    16-byte units (ld a multiple of 8) and a 16-byte aligned X."""
    g = torch.Generator(device=dev).manual_seed(11 + len(name))
    mat = lambda d, n: (torch.randn((d, n), generator=g, device=dev)
                        / d ** 0.5).to(torch.bfloat16)
    wide = mat(64, 3000)
    solver = mat(512, 4096)     # the dense slice at d cut 8-fold
    return {
        "ragged_n": (mat(70, 1101), "direct"),
        "ragged_panel": (mat(70, 1104), "bulk"),
        "d_below_q": (mat(5, 2048), "bulk"),
        "d_not_multiple_of_q": (mat(1001, 704), "bulk"),
        "n_below_bn": (mat(64, 24), "bulk"),
        "n_below_bn_direct": (mat(64, 7), "direct"),
        "d1_n1": (mat(1, 1), "direct"),
        "d1_n8": (mat(1, 8), "bulk"),
        "view_at_0": (wide[:, 0:1024], "bulk"),
        "view_at_1": (wide[:, 1:1025], "direct"),
        "view_at_4": (wide[:, 4:1028], "direct"),
        "view_at_8": (wide[:, 8:1032], "bulk"),
        "ld_above_n": (mat(40, 1032)[:, :1000], "bulk"),
        "ld_not_8": (mat(40, 1028)[:, :1024], "direct"),
        "S_m4_view": (solver[:, :1024], "bulk"),
        "S_m4_view_odd": (mat(32, 4 * 1025)[:, 1025:2050], "direct"),
        "F_m4_rows": (solver[:128], "bulk"),
    }[name]


FUSED_BF16_EDGES = ["ragged_n", "ragged_panel", "d_below_q",
                    "d_not_multiple_of_q", "n_below_bn",
                    "n_below_bn_direct", "d1_n1", "d1_n8", "view_at_0",
                    "view_at_1", "view_at_4", "view_at_8", "ld_above_n",
                    "ld_not_8", "S_m4_view", "S_m4_view_odd", "F_m4_rows"]


def _fused_bf16_halves(X, c, U, got, cz):
    """A bf16 K5 (U a vector) or K10 call held in its two halves, against
    the plain version and against the bf16 two-pass pair: the hand-off
    ``cz`` is the plain (and the pair's pass A) hand-off rounded to bf16
    but for roundings of values within the f32 summation slack (F11),
    and ``got`` is the plain pass B (and the pair's bf16 pass B) of the
    kernel's own hand-off. Returns (hand-offs agree, rel err vs plain,
    rel err vs the pair's pass B, elements rounded the other way against
    the plain and the pair, elements); the caller holds the rate over all
    its calls (``ref.handoff_rate_ok``)."""
    t = ref.ref_dense_handoff(X, c, U)
    slack = ref.dense_handoff_slack(X, c, U, t)
    cz = cz.reshape(t.shape)
    flips, ok = ref.dense_handoff_flips(cz, t, slack)
    if U.dim() == 1:
        pz = glm_hvp.xt_u(X, U)
        tp = pz if c is None else c * pz
        want, pair_y = ref.ref_x_cz(X, cz), glm_hvp.x_cz(X, None, cz)
    else:
        pz = glm_hvp.xt_multi(X, U)
        tp = pz if c is None else c[:, None] * pz
        want = ref.ref_x_cz_multi(X, None, cz)
        pair_y = glm_hvp.x_cz_multi(X, None, cz)
    pflips, pair_ok = ref.dense_handoff_flips(cz, tp, slack)
    torch.cuda.synchronize()
    if float(torch.linalg.norm(want)) == 0.0:
        e, ep = float(got.abs().max()), float((got - pair_y).abs().max())
    else:
        e, ep = _rel(got, want), _rel(got, pair_y)
    return ok and pair_ok, e, ep, (flips, pflips, t.numel())


class _Flips:
    """Hand-off elements rounded the other way over a test's calls,
    against the plain version and the pair, and the elements seen."""

    def __init__(self):
        self.plain = self.pair = self.numel = 0

    def add(self, counts):
        self.plain += counts[0]
        self.pair += counts[1]
        self.numel += counts[2]

    def ok(self):
        """The rate against the plain version (cuBLAS's sum); the pair's
        K3 / K8 sum its rows in order, so more of its elements sit off a
        tie's other side (each within the slack, checked per call)."""
        return ref.handoff_rate_ok(self.plain, self.numel)


@pytest.mark.parametrize("name", FUSED_BF16_EDGES)
@pytest.mark.parametrize("cluster", glm_hvp.CLUSTER_SIZES)
def test_cuda_bf16_fused_edge_shapes(dev, name, cluster):
    """The bf16 K5 (with and without c) and K10 (s = 1..8, U the first s
    of s + 1 columns; without c too at s = 1 and 5) at an edge of the plan
    and split, on each cluster size the bf16 fit rule allows there, on
    as many clusters as fit and on 3: on the copy path the shape calls
    for, held in halves (:func:`_fused_bf16_halves`) at 1e-5, repeated
    bit for bit, the rate of hand-off elements rounded the other way
    over the test's calls at most one in a thousand; only the bf16
    instances counted."""
    X, path = _fused_bf16_edge(dev, name)
    assert glm_hvp.fused_path(X) == path
    d, n = X.shape
    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(d * n + cluster)
    u = torch.randn(d, generator=g, device=dev)
    c = torch.rand(n, generator=g, device=dev)
    ran = 0
    flips = _Flips()
    build.reset_launch_counts()
    for clusters in (None, 3):
        kw = dict(_cluster=cluster, _clusters=clusters)
        if glm_hvp.fused_plan(d, 1, cluster, dtype=bf) is not None:
            for cc in (None, c):
                cz = torch.zeros(n, device=dev)
                got = glm_hvp.x_c_xt_u(X, cc, u, cz_out=cz, **kw)
                run = glm_hvp.last_fused["x_c_xt_u_bf16"]
                again = glm_hvp.x_c_xt_u(X, cc, u, **kw)
                torch.cuda.synchronize()
                assert run.path == glm_hvp.last_path["x_c_xt_u_bf16"] == path
                assert run.plan == glm_hvp.fused_plan(d, 1, cluster,
                                                      dtype=bf)
                assert run.clusters == (clusters or run.clusters) >= 1
                ok, e, ep, cnt = _fused_bf16_halves(X, cc, u, got, cz)
                flips.add(cnt)
                assert ok and e <= 1e-5 and ep <= 1e-5, (e, ep)
                assert torch.equal(got, again)
                ran += 1
        for s in range(1, build.MAX_COLS + 1):
            if glm_hvp.fused_plan(d, s, cluster, dtype=bf) is None:
                continue
            U = _basis(dev, d, s, s + cluster, strided=True)
            for cc in (c, None) if s in (1, 5) else (c,):
                cz = torch.zeros((n, s), device=dev)
                got = glm_hvp.x_c_xt_multi(X, cc, U, cz_out=cz, **kw)
                again = glm_hvp.x_c_xt_multi(X, cc, U, **kw)
                torch.cuda.synchronize()
                assert glm_hvp.last_path["x_c_xt_multi_bf16"] == path
                assert got.shape == (d, s) and got.dtype == torch.float32
                ok, e, ep, cnt = _fused_bf16_halves(X, cc, U, got, cz)
                flips.add(cnt)
                assert ok and e <= 1e-5 and ep <= 1e-5, (s, e, ep)
                assert torch.equal(got, again)
                ran += 1
    assert flips.ok(), vars(flips)
    counts = build.launch_counts()
    assert counts["x_c_xt_u"] == counts["x_c_xt_multi"] == 0
    if not ran:
        pytest.skip(f"no bf16 plan of {cluster} CTAs a cluster at d = {d}")


@pytest.mark.parametrize("shape", DENSE_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("s", MULTI_S)
@pytest.mark.parametrize("with_c", [False, True])
def test_cuda_bf16_x_c_xt_multi_matches_plain(dev, shape, s, with_c):
    """The bf16 K10 on every cluster size the bf16 fit rule allows, on
    contiguous and strided U, X whole and as a column view at offset 1
    (direct path): held in halves against the plain version and the bf16
    two-pass pair (1e-5), repeated bit for bit; at s = 1 the bf16 K5
    likewise."""
    d, n = shape
    X, _, _, c = _dense(dev, d, n + 1, seed=d + n + s)
    Xh = X.to(torch.bfloat16)
    c = c[:n] if with_c else None
    flips = _Flips()
    for A in (Xh[:, :n].contiguous(), Xh[:, 1:]):
        for strided in (False, True):
            U = _basis(dev, d, s, 7 * s, strided=strided)
            sizes = [q for q in glm_hvp.CLUSTER_SIZES
                     if glm_hvp.fused_plan(d, s, q,
                                           dtype=torch.bfloat16) is not None]
            assert sizes
            for q in sizes:
                cz = torch.zeros((n, s), device=dev)
                got = glm_hvp.x_c_xt_multi(A, c, U, cz_out=cz, _cluster=q)
                again = glm_hvp.x_c_xt_multi(A, c, U, _cluster=q)
                ok, e, ep, k = _fused_bf16_halves(A, c, U, got, cz)
                flips.add(k)
                assert ok and e <= 1e-5 and ep <= 1e-5, (q, strided, e, ep)
                assert torch.equal(got, again)
                if s == 1:
                    u = U[:, 0].contiguous()
                    cz = torch.zeros(n, device=dev)
                    got = glm_hvp.x_c_xt_u(A, c, u, cz_out=cz, _cluster=q)
                    ok, e, ep, k = _fused_bf16_halves(A, c, u, got, cz)
                    flips.add(k)
                    assert ok and e <= 1e-5 and ep <= 1e-5, (q, e, ep)
    assert flips.ok(), vars(flips)


def test_cuda_bf16_fused_failed_launch_raises(dev, monkeypatch):
    """A plan the bf16 entry points refuse (a panel width of the f32
    kernels' narrow 16, not one of bf16's 64 and 32) raises, naming the
    bf16 instance, and counts no launch."""
    X, u, _, c = _dense(dev, 64, 1024, seed=12)
    Xh = X.to(torch.bfloat16)
    bad = glm_hvp.FusedPlan(1, 16, 2, 256)
    monkeypatch.setattr(glm_hvp, "fused_plan", lambda *a, **k: bad)
    build.reset_launch_counts()
    with pytest.raises(RuntimeError, match="x_c_xt_u_bf16 launch failed"):
        glm_hvp.x_c_xt_u(Xh, c, u)
    with pytest.raises(RuntimeError,
                       match="x_c_xt_multi_bf16 launch failed"):
        glm_hvp.x_c_xt_multi(Xh, c, torch.ones((64, 3), device=dev))
    assert not any(build.launch_counts().values())


@pytest.mark.parametrize("partition", ["samples", "features"])
@pytest.mark.parametrize("m,s", [(1, 1), (2, 1), (1, 2)])
def test_cuda_dense_bf16_fused_disco_fit_matches_cpu(dev, partition, m, s):
    """A small fused bf16 dense solve on the card against the same solve
    on the CPU: the same PCG iterations (or rounds) every step, w within
    relative L2 3e-4 (F11); PCG's products on the bf16 instances only,
    the one-pass ones wherever no collective separates the passes."""
    X, y, _ = make_glm_data(d=98, n=202, seed=1)
    cfg = DiscoConfig(loss="logistic", lam=1e-3, tau=100, max_outer=4,
                      grad_tol=0.0, partition=partition, pcg_block_s=s,
                      use_kernel=True, hvp_fused=True,
                      hvp_dtype="bfloat16")
    build.reset_launch_counts()
    on_card = disco_fit(X, y, cfg, group=InProcessGroup(m))
    counts = build.launch_counts()
    on_cpu = disco_fit(X, y, cfg, group=InProcessGroup(m), device="cpu")
    assert [h["pcg_iters"] for h in on_card.history] == \
        [h["pcg_iters"] for h in on_cpu.history]
    assert np.linalg.norm(on_card.w - on_cpu.w) <= \
        3e-4 * np.linalg.norm(on_cpu.w)
    f32 = ("xt_u", "x_cz", "xt_multi", "x_cz_multi", "x_c_xt_u",
           "x_c_xt_multi")
    assert not any(counts[k] for k in f32)
    fused = counts["x_c_xt_u_bf16"] + counts["x_c_xt_multi_bf16"]
    assert fused > 0 if partition == "samples" or m == 1 else fused == 0


def test_cuda_bf16_lambda_path_matches_cpu(dev):
    """A small warm λ-path on the fused bf16 s-step solve (the bf16 K5
    for the basis products, K10 for the rounds) on the card against the
    same path on the CPU: the same best λ, each point's w within relative
    L2 3e-4 (F11); no f32 dense kernel launched."""
    from repro_torch import lambda_path_fit
    X, y, _ = make_glm_data(d=98, n=202, seed=1)
    Xv, yv, _ = make_glm_data(d=98, n=150, seed=2)
    cfg = DiscoConfig(loss="logistic", tau=100, max_outer=6, grad_tol=1e-6,
                      partition="samples", use_kernel=True, hvp_fused=True,
                      pcg_block_s=3, hvp_dtype="bfloat16")
    build.reset_launch_counts()
    on_card = lambda_path_fit(X, y, [1e-2, 1e-3, 1e-4], cfg, X_val=Xv,
                              y_val=yv)
    counts = build.launch_counts()
    assert counts["x_c_xt_u_bf16"] > 0 and counts["x_c_xt_multi_bf16"] > 0
    assert counts["x_c_xt_u"] == counts["x_c_xt_multi"] == 0
    on_cpu = lambda_path_fit(X, y, [1e-2, 1e-3, 1e-4], cfg, X_val=Xv,
                             y_val=yv, device="cpu")
    assert on_card.best_lambda == on_cpu.best_lambda
    for a, b in zip(on_card.results, on_cpu.results):
        assert np.linalg.norm(a.w - b.w) <= 3e-4 * np.linalg.norm(b.w)


# ---------------------------------------------------------------------------
# tracing and checkpoint/resume on the card
# ---------------------------------------------------------------------------

def _trace_problem(kind):
    if kind == "sparse":
        X, y, _ = make_sparse_glm_data(d=300, n=500, density=0.05, seed=4)
        return X, y, dict(ell_block_d=16, ell_block_n=16)
    X, y, _ = make_glm_data(d=200, n=1000, seed=4)
    return X, y, dict(use_kernel=True)


@pytest.mark.parametrize("kind", ["sparse", "dense"])
@pytest.mark.parametrize("partition", ["samples", "features"])
def test_cuda_tracing_adds_no_launch(dev, kind, partition):
    """A traced fit launches the same kernels as an untraced one, the
    same number of times, and gives the same w bit for bit (the two-pass
    kernels repeat bit for bit); its comm.rounds counter is the ledger's
    and kernel.dispatch says 'cuda'."""
    from repro_torch import DiscoSolver, obs
    X, y, kw = _trace_problem(kind)
    cfg = DiscoConfig(loss="logistic", lam=1e-3, tau=64, max_outer=4,
                      grad_tol=0.0, partition=partition, **kw)
    solver = DiscoSolver(X, y, cfg, device=dev)
    counts = []
    results = []
    for traced in (False, True):
        obs.disable()
        tracer = obs.enable(reset=True) if traced else None
        build.reset_launch_counts()
        results.append(solver.fit())
        torch.cuda.synchronize()
        counts.append(build.launch_counts())
    obs.disable()
    assert counts[0] == counts[1] and sum(counts[0].values()) > 0
    np.testing.assert_array_equal(results[0].w, results[1].w)
    assert tracer.counters["comm.rounds"] == results[1].ledger.rounds
    assert tracer.span_count("newton.outer") == len(results[1].history)
    assert [e.args["mode"] for e in tracer.events
            if e.kind == "kernel.dispatch"] == ["cuda"]


@pytest.mark.parametrize("kind", ["sparse", "dense"])
@pytest.mark.parametrize("partition,m", [("samples", 1), ("features", 4)])
def test_cuda_kill_and_resume_matches(dev, tmp_path, kind, partition, m):
    """A card fit killed at step 2 and resumed from its checkpoint gives
    the uninterrupted card fit's w bit for bit and its trajectory; the
    checkpoint resumes on the CPU to the CPU's own uninterrupted w within
    rtol 1e-4 / atol 1e-6, the card-against-CPU tolerance of these
    problems (``test_cuda_disco_fit_matches_cpu``,
    ``test_cuda_dense_disco_fit_matches_cpu``)."""
    from repro_torch import DiscoSolver
    from repro_torch.robust import FaultInjector, FaultPlan, SimulatedKill
    if kind == "sparse":
        X, y, _ = make_sparse_glm_data(d=96, n=200, density=0.2, alpha=0.8,
                                       beta=0.5, seed=1)
        kw = dict(ell_block_d=16, ell_block_n=16)
    else:
        X, y, _ = make_glm_data(d=98, n=202, seed=1)
        kw = dict(use_kernel=True)
    cfg = DiscoConfig(loss="logistic", lam=1e-3, tau=100, max_outer=4,
                      grad_tol=0.0, partition=partition, **kw)
    group = InProcessGroup(m)
    solver = DiscoSolver(X, y, cfg, group=group, device=dev)
    whole = solver.fit()
    ckpt = str(tmp_path / "ckpt")
    solver._faults = FaultInjector(FaultPlan(kill_at_step=2))
    with pytest.raises(SimulatedKill):
        solver.fit(checkpoint_dir=ckpt)
    solver._faults = None
    shutil.copytree(ckpt, ckpt + "-cpu")
    res = solver.fit(checkpoint_dir=ckpt, resume=True)
    np.testing.assert_array_equal(res.w, whole.w)
    assert [h["pcg_iters"] for h in res.history] == \
        [h["pcg_iters"] for h in whole.history]
    assert res.ledger == whole.ledger
    cpu = DiscoSolver(X, y, cfg, group=group, device="cpu")
    on_cpu = cpu.fit(checkpoint_dir=ckpt + "-cpu", resume=True)
    np.testing.assert_allclose(on_cpu.w, cpu.fit().w, rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# the streamed (out-of-core) solve: chunks staged to the card, tiles
# assembled there
# ---------------------------------------------------------------------------

def _stores(tmp_path, seed=1):
    from repro_torch.data.store import ShardStore
    X, y, _ = make_sparse_glm_data(d=96, n=160, density=0.2, alpha=1.0,
                                   beta=0.5, seed=seed)
    return X, y, {axis: ShardStore.from_csr(X, y, str(tmp_path / axis),
                                            axis=axis, chunk_size=16)
                  for axis in ("samples", "features")}


STREAM_SOLVE = dict(loss="logistic", lam=1e-2, tau=16, max_outer=4,
                    grad_tol=1e-10, ell_block_d=8, ell_block_n=8,
                    partition_block=16, stream_chunk_size=16)
STREAM_CELLS = [("samples", 1, {}), ("samples", 4, {}),
                ("samples", 1, dict(pcg_block_s=2)),
                ("samples", 1, dict(hvp_fused=True)),
                ("samples", 1, dict(hvp_fused=True, pcg_block_s=2)),
                ("samples", 1, dict(hvp_fused=True, hvp_dtype="bfloat16")),
                ("features", 1, {}), ("features", 4, {}),
                ("features", 4, dict(pcg_block_s=2)),
                ("features", 1, dict(hvp_dtype="bfloat16"))]


@pytest.mark.parametrize("partition,m,kw", STREAM_CELLS,
                         ids=[f"{p}-m{m}-" + "-".join(
                             f"{k}={v}" for k, v in kw.items())
                             for p, m, kw in STREAM_CELLS])
def test_cuda_streamed_solve_matches_cpu(dev, tmp_path, partition, m, kw):
    """A small streamed solve on the card against the same streamed solve
    on the CPU: ``w`` within rtol 1e-4 / atol 1e-6 (relative L2 1e-3 at
    bf16, ROADMAP F11: a bf16 solve moves with the f32 sum order, and the
    card sums each chunk's products in its own order, the CPU in the
    plain one; 3.2e-4 and 3.7e-4 measured on the card's first runs of
    these cells, above the in-memory cells' 3e-4), the same partition,
    PCG iterations within one at
    bf16 and equal at f32, and the same bytes staged with the same
    iterations; and K1 (with K2 / K6
    / K7 where the cell runs them) launched."""
    from repro_torch import DiscoSolver
    from repro_torch.data.store import ShardStore
    _, _, stores = _stores(tmp_path)
    cfg = DiscoConfig(partition=partition, **STREAM_SOLVE, **kw)
    group = InProcessGroup(m)
    build.reset_launch_counts()
    card = DiscoSolver.from_store(ShardStore(stores[partition].path), cfg,
                                  group=group, device=dev).fit()
    counts = build.launch_counts()
    cpu = DiscoSolver.from_store(ShardStore(stores[partition].path), cfg,
                                 group=group, device="cpu").fit()
    its = [int(h["pcg_iters"]) for h in card.history]
    its_cpu = [int(h["pcg_iters"]) for h in cpu.history]
    assert card.partition_info == cpu.partition_info
    if its == its_cpu:                 # the same passes, the same bytes
        for k in ("passes", "steps", "bytes_loaded", "max_step_bytes"):
            assert card.stream_stats[k] == cpu.stream_stats[k], k
    if kw.get("hvp_dtype") == "bfloat16":
        rel = np.linalg.norm(card.w - cpu.w) / np.linalg.norm(cpu.w)
        assert rel <= 1e-3, rel
        assert all(abs(a - b) <= 1 for a, b in zip(its, its_cpu))
    else:
        np.testing.assert_allclose(card.w, cpu.w, rtol=1e-4, atol=1e-6)
        assert its == its_cpu
    bf16 = kw.get("hvp_dtype") == "bfloat16"
    assert counts["ell_mv"] > 0
    fused = "ell_hvp_mm" if kw.get("pcg_block_s", 1) > 1 else "ell_hvp"
    if kw.get("hvp_fused"):
        assert counts[fused + ("_bf16" if bf16 else "")] > 0
    elif kw.get("pcg_block_s", 1) > 1:
        assert counts["ell_mm"] > 0


@pytest.mark.parametrize("axis", ["samples", "features"])
@pytest.mark.parametrize("hvp", [False, True])
def test_cuda_stream_tiles_match_host(dev, tmp_path, axis, hvp):
    """Every payload assembled on the card equals the CPU's payload bit for
    bit (tiles in both layouts, f32 and bf16, column ids, the K1 / K6
    schedules and the K2 / K7 step tables), which ``ell_from_csr`` and the
    reference's payloads give on the host
    (``tests/test_torch_stream.py``)."""
    from repro_torch.data.stream import plan_streams
    _, _, stores = _stores(tmp_path)
    kw = dict(block_rows=8, block_cols=8, hvp_dtype=torch.bfloat16)
    card = plan_streams(stores[axis], 2, device=dev, **kw)
    cpu = plan_streams(stores[axis], 2, device="cpu", **kw)
    kinds = [("both", False), ("tr", True)] if axis == "samples" \
        else [("both", False)]
    for kind, fused in kinds:
        with card.stream(kind, hvp=hvp, fused=fused) as pf:
            for t, pl in enumerate(pf):
                want, _ = cpu._load_step(t, kind, hvp, fused)
                assert set(pl) == set(want)
                for k, v in want.items():
                    if k == "hvp_sched":
                        for a, b in zip(pl[k], v):
                            assert torch.equal(a.table.cpu(), b.table)
                            assert a.steps == b.steps
                            assert not a.state.any()
                        continue
                    got = pl[k].cpu()
                    assert got.dtype == v.dtype and torch.equal(got, v), k


def _prefetch_threads():
    import threading
    return [t for t in threading.enumerate()
            if t.name == "repro-chunk-prefetch" and t.is_alive()]


def test_cuda_prefetcher_closed_mid_pass(dev, tmp_path):
    """A pass abandoned after one payload and closed leaves no producer
    thread, every device buffer back in the ring with its events
    complete, and the next pass whole."""
    from repro_torch.data.stream import plan_streams
    _, _, stores = _stores(tmp_path)
    plan = plan_streams(stores["samples"], 1, block_rows=8, block_cols=8,
                        device=dev, prefetch_depth=2)
    pf = plan.stream("both")
    it = iter(pf)
    next(it)
    pf.close()
    assert _prefetch_threads() == []
    plane = plan._plane
    assert plane.free.qsize() == len(plane.slots) == plan.prefetch_depth + 2
    torch.cuda.synchronize()
    assert all(s.ready.query() and s.release.query() for s in plane.slots)
    assert all(p.copied.query() for p in plane.pinned)
    assert plan.stats.live_bytes == 0
    with plan.stream("both") as pf:
        assert sum(1 for _ in pf) == plan.n_steps
    assert _prefetch_threads() == []


def test_cuda_streamed_pass_has_no_host_sync(dev, tmp_path):
    """A streamed pass (stage, fill, K1 on every chunk) makes no host
    sync, and a streamed fit makes no more than the in-memory fit with
    the same PCG iterations: the loops' residual tests and the step's
    reads."""
    import warnings
    from repro_torch import DiscoSolver
    from repro_torch.data.store import ShardStore
    X, y, stores = _stores(tmp_path)

    def syncs(fn):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        # (setting the mode warns that it is a prototype: not a sync)
        return sum("called a synchronizing" in str(w.message)
                   for w in caught)

    cfg = DiscoConfig(partition="samples", **STREAM_SOLVE)
    streamed = DiscoSolver.from_store(ShardStore(stores["samples"].path),
                                      cfg, device=dev)
    plan = streamed._plan
    w = torch.ones(plan.other_padded, device=dev)

    def one_pass():
        with plan.stream("both") as pf:
            for pl in pf:
                ops.ell_matvec(pl["dataT"][0], pl["colsT"][0], w,
                               sched=pl["schedT"][0])
    one_pass()
    assert syncs(one_pass) == 0
    inmem = DiscoSolver(X, y, cfg, device=dev)
    streamed.fit()                 # the first fits' one-off syncs
    inmem.fit()
    res_s, res_m = [], []
    n_s = syncs(lambda: res_s.append(streamed.fit()))
    n_m = syncs(lambda: res_m.append(inmem.fit()))
    assert [h["pcg_iters"] for h in res_s[0].history] == \
        [h["pcg_iters"] for h in res_m[0].history]
    assert n_s <= n_m, (n_s, n_m)


@pytest.mark.parametrize("kw", [{}, dict(hvp_dtype="bfloat16")],
                         ids=["f32", "bf16"])
def test_cuda_streamed_equals_one_shard_per_chunk(dev, tmp_path, kw):
    """On the card too, the streamed DiSCO-S m = 1 two-pass solve is the
    in-memory solve whose shards are the chunks (equal-width partition,
    m = the chunk count) bit for bit: K1 is deterministic, and the chunks'
    products are summed in the same order."""
    from repro_torch import DiscoSolver
    from repro_torch.data.store import ShardStore
    X, y, stores = _stores(tmp_path)
    cfg = DiscoConfig(partition="samples", **STREAM_SOLVE, **kw)
    streamed = DiscoSolver.from_store(ShardStore(stores["samples"].path),
                                      cfg, device=dev).fit()
    n_chunks = stores["samples"].n_chunks
    import dataclasses
    inmem = DiscoSolver(X, y, dataclasses.replace(
        cfg, partition_strategy="width"), group=InProcessGroup(n_chunks),
        device=dev).fit()
    np.testing.assert_array_equal(streamed.w, inmem.w)
    assert [h["pcg_iters"] for h in streamed.history] == \
        [h["pcg_iters"] for h in inmem.history]


# ---------------------------------------------------------------------------
# GLM serving: K1 on the scoring micro-batch layouts, engine card vs CPU
# ---------------------------------------------------------------------------

def _serve_requests(d, k, seed, nnz=24):
    """``k`` requests of ``nnz`` features each, every fifth one empty."""
    from repro_torch.glm_serve import ScoreRequest
    rng = np.random.default_rng(seed)
    out = []
    for i in range(k):
        m = 0 if i % 5 == 4 else nnz
        idx = rng.choice(d, size=m, replace=False).astype(np.int64)
        out.append(ScoreRequest(idx, rng.standard_normal(m)
                                .astype(np.float32)))
    return out


def _sync_count(fn):
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("called a synchronizing" in str(w.message) for w in caught)


@pytest.mark.parametrize("tiles", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch", [1, 7, 64, 1024])
def test_cuda_k1_on_scoring_layouts(dev, tiles, batch):
    """K1 at 8 x 128 tiles on packed micro-batches (a short batch
    included): with the plan's schedule and without, against the plain
    version at the same tiles (1e-5), repeated bit for bit, and with NaN
    in the slots past each row-block's live ones, which the scheduled call
    must not read. The card's pack equals the CPU's bit for bit."""
    from repro_torch.data.sparse import hvp_tile_dtype
    from repro_torch.glm_serve import RequestPacker
    d = 3000
    reqs = _serve_requests(d, max(1, batch - batch // 3), seed=batch)
    kw = dict(block_b=8, block_d=128, tile_dtype=hvp_tile_dtype(tiles))
    p = RequestPacker(d, batch, device=dev, **kw)
    data, cols, sched = p.pack_scheduled(reqs)
    cdata, ccols = RequestPacker(d, batch, device="cpu", **kw).pack(reqs)
    assert torch.equal(data.cpu().float(), cdata.float())
    assert torch.equal(cols.cpu(), ccols)
    w = p.pad_weights(np.random.default_rng(0).standard_normal(d)
                      .astype(np.float32))
    want = ref.ref_ell_mv(data, cols, w)
    for s in (sched, None):
        got = ops.ell_matvec(data, cols, w, sched=s)
        assert _rel(got, want) <= 1e-5
        assert torch.equal(got, ops.ell_matvec(data, cols, w, sched=s))
    live = sched[:data.shape[0]].long()
    pad = torch.arange(data.shape[1], device=dev)[None, :] >= live[:, None]
    poisoned = data.clone()
    poisoned[pad] = float("nan")
    got = ops.ell_matvec(poisoned, cols, w, sched=sched)
    assert torch.equal(got, ops.ell_matvec(data, cols, w, sched=sched))


def test_cuda_k1_empty_scoring_batch(dev):
    """An all-padding pack has a schedule with no live tile: K1 writes
    zeros."""
    from repro_torch.glm_serve import RequestPacker
    p = RequestPacker(1000, 64, device=dev)
    data, cols, sched = p.pack_scheduled([])
    assert int(sched[:data.shape[0]].sum()) == 0
    y = ops.ell_matvec(data, cols, p.pad_weights(np.ones(1000, np.float32)),
                       sched=sched)
    assert torch.equal(y, torch.zeros_like(y))


@pytest.mark.parametrize("hvp_dtype", ["float32", "bfloat16"])
def test_cuda_scoring_engine_matches_cpu(dev, hvp_dtype, tmp_path):
    """The engine on the card against the same engine on the CPU (1e-6)
    and the oracle (1e-5 at f32, 2e-2 at bf16), each of the largest
    margin (bench_serving's gate: a margin's own f32 sum of 40 products
    rounds by more than 1e-6 of itself where they cancel), one host sync
    a tick, K1 launched once a tick, and the scheduler's completions equal
    ``score``'s."""
    from repro_torch.glm_serve import (MicroBatchScheduler, ScoringEngine,
                                       oracle_margins)
    d = 5000
    reqs = _serve_requests(d, 300, seed=1, nnz=40)
    w = np.random.default_rng(2).standard_normal(d).astype(np.float32)
    eng = ScoringEngine(w, loss="logistic", hvp_dtype=hvp_dtype, device=dev)
    cpu = ScoringEngine(w, loss="logistic", hvp_dtype=hvp_dtype,
                        device="cpu")
    got = eng.score(reqs)
    want = oracle_margins(reqs, w)
    scale = np.abs(want).max()
    assert np.abs(got - cpu.score(reqs)).max() <= 1e-6 * scale
    lim = 1e-5 if hvp_dtype == "float32" else 2e-2
    assert np.abs(got - want).max() <= lim * scale
    name = "ell_mv" if hvp_dtype == "float32" else "ell_mv_bf16"
    build.reset_launch_counts()
    n = _sync_count(lambda: eng.score(reqs[:64]))
    assert n == 1, n
    assert build.launch_counts()[name] == 1
    build.reset_launch_counts()
    eng.score(reqs)
    assert build.launch_counts()[name] == -(-len(reqs) // 64)
    sched = MicroBatchScheduler(eng)
    rids = [sched.submit(r) for r in reqs]
    fin = sched.run_until_done()
    assert [fin[r].margin for r in rids] == [float(a) for a in got]


# the multi-process solve on the card: ranks of launch.spawn
DIST_KW = dict(loss="logistic", lam=1e-4, tau=100, max_outer=4,
               grad_tol=0.0)


def _dist_problem():
    X, y, _ = make_sparse_glm_data(d=2000, n=1500, density=0.005, seed=3)
    return (X.indptr, X.indices, X.data, X.shape), y, X


@pytest.mark.parametrize("partition", ["samples", "features"])
def test_cuda_two_gloo_ranks_equal_in_process(dev, partition):
    """Two gloo ranks sharing the card, each holding its shard there (the
    payloads staged through pinned host buffers), give the card's
    InProcessGroup(2) solve bit for bit, on every rank, with K1 launched
    on each."""
    import torch_dist_ranks as ranks
    from repro_torch.parallel.launch import spawn
    arrays, y, X = _dist_problem()
    kw = dict(DIST_KW, partition=partition)
    twin = ranks.summary(disco_fit(X, y, DiscoConfig(**kw),
                                   group=InProcessGroup(2), device=dev))
    out = spawn(ranks.card_solve, 2, backend="gloo", device="cuda",
                args=(arrays, y, kw), timeout_s=120.0)
    for o in out:
        got = o["summary"]
        assert np.array_equal(got["w"], twin["w"])
        assert got["history"] == twin["history"]
        assert got["ledger"] == twin["ledger"]
        assert got["partition_info"] == twin["partition_info"]
        assert o["ell_mv"] > 0 and o["counts"]["staged_bytes"] > 0


def test_cuda_one_nccl_rank_equals_in_process(dev):
    """One NCCL rank (cuda:0) gives the card's one-shard solve bit for
    bit, its collectives on the card (nothing staged)."""
    import torch_dist_ranks as ranks
    from repro_torch.parallel.launch import spawn
    arrays, y, X = _dist_problem()
    kw = dict(DIST_KW, partition="samples")
    twin = ranks.summary(disco_fit(X, y, DiscoConfig(**kw),
                                   group=InProcessGroup(1), device=dev))
    (o,) = spawn(ranks.card_solve, 1, backend="nccl", args=(arrays, y, kw),
                 timeout_s=120.0)
    got = o["summary"]
    assert np.array_equal(got["w"], twin["w"])
    assert got["history"] == twin["history"]
    assert got["ledger"] == twin["ledger"]
    assert o["ell_mv"] > 0 and o["counts"]["staged_bytes"] == 0
    assert o["counts"]["vector_calls"] > 0


def test_cuda_two_gloo_ranks_softmax_and_stream_equal_in_process(
        dev, tmp_path):
    """Two gloo ranks sharing the card run softmax (K8 / K9) and the
    streamed DiSCO-S (K1), each rank streaming its own chunks: both equal
    the card's InProcessGroup(2) run bit for bit, on every rank."""
    import torch_dist_ranks as ranks
    from repro_torch.data import ShardStore
    from repro_torch.parallel.launch import spawn
    rng = np.random.default_rng(5)
    Xs = rng.standard_normal((64, 2048)).astype(np.float32)
    ys = np.argmax(Xs.T @ rng.standard_normal((64, 4)), axis=1)
    _, y, X = _dist_problem()
    store = ShardStore.from_csr(X, y, str(tmp_path / "store"),
                                axis="samples", chunk_size=256).path
    data = dict(softmax=(Xs, ys), stores=dict(samples=store))
    cases = {
        "softmax": dict(kind="softmax", cfg=dict(
            lam=1e-3, max_outer=3, grad_tol=0.0, tau=24, use_kernel=True,
            partition="features", pcg_block_s=2)),
        "stream": dict(kind="stream", cfg=dict(
            DIST_KW, partition="samples", max_outer=2, partition_block=256,
            stream_chunk_size=256)),
    }
    twins = {name: ranks.path_case(dict(case, name=name), data,
                                   InProcessGroup(2), str(tmp_path), dev)
             for name, case in cases.items()}
    out = spawn(ranks.card_paths, 2, backend="gloo", device="cuda",
                args=(cases, data, str(tmp_path)), timeout_s=120.0)
    for o in out:
        got, counts, launches = o["softmax"]
        want = twins["softmax"]
        assert np.array_equal(got["W"], want["W"])
        assert got["history"] == want["history"]
        assert launches["xt_multi"] > 0 and launches["x_cz_multi"] > 0
        assert counts["staged_bytes"] > 0
        got, counts, launches = o["stream"]
        want = twins["stream"]
        assert np.array_equal(got["w"], want["w"])
        assert got["history"] == want["history"]
        assert got["ledger"] == want["ledger"]
        assert launches["ell_mv"] > 0
    assert sorted(c for o in out for c in o["stream"][0]["chunks"]) == \
        twins["stream"]["chunks"]
