"""The live-tile schedule of ``ell_mv`` / ``ell_mm`` (K1 / K6) on the CPU.

``repro_torch.kernels.sparse_hvp.ell_schedule`` is plain torch, so its
contract is checked here on ``ell_from_csr`` layouts (forward and
transposed, one shard and four shards stacked to the global width) and on
random live counts: the live counts are ell_from_csr's per-row-block tile
counts, every nonzero tile lies in exactly one CTA range, and the ranges
differ in size by at most one tile. The ops with ``sched=`` run their
plain versions here, which must equal the JAX ops on the same numpy
inputs (rtol 1e-5, atol 1e-6: f32 sums in another order), and the sparse
solver keeps each layout's schedule beside it. The kernels that walk the
schedule run only on the card (``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.data.sparse import ell_from_csr as j_ell_from_csr
from repro.data.sparse import make_sparse_glm_data as j_make_sparse
from repro.kernels import ops as jops
from repro_torch import DiscoConfig, DiscoSolver, InProcessGroup
from repro_torch.data.partition import make_partition
from repro_torch.data.sparse import (ell_from_csr, make_sparse_glm_data,
                                     shard_csrs_from_partition,
                                     stack_shard_ells)
from repro_torch.kernels import ops as tops
from repro_torch.kernels.sparse_hvp import (default_ctas, ell_schedule,
                                            schedule_parts)

RTOL, ATOL = 1e-5, 1e-6


def _tile_counts(csr, br, bc):
    """Real tiles per row-block of ``csr`` cut into (br, bc) tiles, from
    its indices alone (what ``ell_from_csr`` keeps)."""
    d, n = csr.shape
    nrb, ncb = -(-d // br), max(-(-n // bc), 1)
    rows = np.repeat(np.arange(d), np.diff(csr.indptr))
    ids = np.unique((rows // br).astype(np.int64) * ncb + csr.indices // bc)
    return np.bincount(ids // ncb, minlength=nrb)


def _check_ranges(sched, data):
    """Every nonzero tile of ``data`` lies in exactly one CTA range, the
    ranges tile [0, total) in order, and their sizes differ by at most
    one. Returns (live, prefix, bounds) as numpy."""
    nb, w = data.shape[:2]
    live, prefix, bounds = (t.numpy().astype(np.int64)
                            for t in schedule_parts(sched, nb))
    assert sched.dtype == torch.int32
    assert prefix[0] == 0 and (np.diff(prefix) == live).all()
    total = prefix[-1]
    assert bounds[0] == 0 and bounds[-1] == total
    sizes = np.diff(bounds)
    assert (sizes >= 0).all() and sizes.max() - sizes.min() <= 1
    nonzero = (data.reshape(nb, w, -1) != 0).any(dim=2).numpy()
    for i, slot in zip(*np.nonzero(nonzero)):
        assert slot < live[i]
        t = prefix[i] + slot
        owners = np.nonzero((bounds[:-1] <= t) & (t < bounds[1:]))[0]
        assert len(owners) == 1
    # the slots past a row-block's live ones hold zero tiles
    slots = np.arange(w)[None, :]
    assert not (nonzero & (slots >= live[:, None])).any()
    return live, prefix, bounds


def _rcv1_like(seed=0):
    X, _, _ = make_sparse_glm_data(d=300, n=260, density=0.02, seed=seed)
    return X


@pytest.mark.parametrize("layout", ["forward", "transposed"])
@pytest.mark.parametrize("block", [(8, 8), (16, 16), (16, 8)])
@pytest.mark.parametrize("ctas", [1, 7, 132])
def test_schedule_of_one_layout(layout, block, ctas):
    X = _rcv1_like()
    br, bc = block
    if layout == "transposed":
        X, (br, bc) = X.transpose(), (bc, br)
    ell = ell_from_csr(X, br, bc)
    data = torch.from_numpy(ell.data)
    sched = ell_schedule(data, torch.from_numpy(ell.cols), ctas)
    assert sched.shape == (2 * ell.n_row_blocks + ctas + 2,)
    live, _, _ = _check_ranges(sched, data)
    np.testing.assert_array_equal(live, _tile_counts(X, br, bc))
    assert live.max() == ell.width


@pytest.mark.parametrize("axis", ["samples", "features"])
@pytest.mark.parametrize("layout", ["forward", "transposed"])
def test_schedule_of_shards_stacked_to_the_global_width(axis, layout):
    """m = 4 shards padded to the widest shard's W: each shard's live
    counts are its own tiles, the padding past them is skipped."""
    X = _rcv1_like(seed=1)
    part = make_partition(X, axis, 4, "lpt", pad_multiple=16)
    shards = shard_csrs_from_partition(X, part, axis)
    transpose = layout == "transposed"
    data, cols = stack_shard_ells(shards, 16, 16, transpose=transpose)
    csrs = [c.transpose() for c in shards] if transpose else shards
    ells = [ell_from_csr(c, 16, 16) for c in csrs]
    assert min(e.width for e in ells) < data.shape[2]   # padded shards
    for s, e in enumerate(ells):        # each shard's own layout, padded
        np.testing.assert_array_equal(data[s, :, :e.width], e.data)
        np.testing.assert_array_equal(cols[s, :, :e.width], e.cols)
        assert not data[s, :, e.width:].any()
        assert not cols[s, :, e.width:].any()
    for s, csr in enumerate(csrs):
        sched = ell_schedule(torch.from_numpy(data[s]),
                             torch.from_numpy(cols[s]), 132)
        live, _, _ = _check_ranges(sched, torch.from_numpy(data[s]))
        np.testing.assert_array_equal(live, _tile_counts(csr, 16, 16))


def test_schedule_with_more_ctas_than_live_tiles():
    ell = ell_from_csr(make_sparse_glm_data(d=20, n=24, density=0.05,
                                            seed=2)[0], 8, 8)
    data = torch.from_numpy(ell.data)
    total = int((data.reshape(*data.shape[:2], -1) != 0).any(2).sum())
    ctas = 4 * total + 3
    sched = ell_schedule(data, torch.from_numpy(ell.cols), ctas)
    _, _, bounds = _check_ranges(sched, data)
    sizes = np.diff(bounds)
    assert set(sizes.tolist()) == {0, 1}
    assert (sizes == 0).sum() == ctas - total


def test_schedule_counts_a_zero_tile_before_a_nonzero_one():
    """Live slots run up to the last nonzero tile: an explicit zero tile
    inside a row-block is counted (and read); one at the end is not."""
    data = torch.zeros((3, 4, 2, 2))
    data[0, 0, 0, 0] = 1.0
    data[0, 2, 1, 1] = -2.0          # slot 1 of row-block 0 is zero
    data[1, 3, 0, 1] = 3.0           # slots 0-2 of row-block 1 are zero
    cols = torch.zeros((3, 4), dtype=torch.int32)
    live, prefix, bounds = schedule_parts(ell_schedule(data, cols, 2), 3)
    assert live.tolist() == [3, 4, 0]
    assert prefix.tolist() == [0, 3, 7, 7]
    assert bounds.tolist() == [0, 3, 7]


def test_schedule_of_an_all_zero_layout():
    data = torch.zeros((5, 2, 4, 4))
    sched = ell_schedule(data, torch.zeros((5, 2), dtype=torch.int32), 3)
    live, prefix, bounds = schedule_parts(sched, 5)
    assert live.tolist() == [0] * 5 and prefix.tolist() == [0] * 6
    assert bounds.tolist() == [0] * 4


def test_schedule_refuses_what_is_not_a_layout():
    data = torch.zeros((2, 3, 4, 4))
    with pytest.raises(ValueError, match="not a blocked-ELL layout"):
        ell_schedule(data, torch.zeros((2, 4), dtype=torch.int32), 1)
    with pytest.raises(ValueError, match="must be positive"):
        ell_schedule(data, torch.zeros((2, 3), dtype=torch.int32), 0)


def test_default_ctas_on_the_cpu_is_the_h100s():
    assert default_ctas("cpu") == 132


@settings(max_examples=60, deadline=None)
@given(live=st.lists(st.integers(0, 9), min_size=1, max_size=40),
       ctas=st.integers(1, 50), holes=st.integers(0, 2**31 - 1))
def test_schedule_of_random_live_counts(live, ctas, holes):
    """Row-blocks whose last nonzero tile is at slot live[i] - 1, with
    random zero tiles before it."""
    nb, w = len(live), max(max(live), 1)
    rng = np.random.default_rng(holes)
    data = np.zeros((nb, w, 1, 2), np.float32)
    for i, n in enumerate(live):
        if n:
            data[i, :n - 1, 0, 1] = rng.integers(0, 2, n - 1)
            data[i, n - 1, 0, 0] = 1.0
    data = torch.from_numpy(data)
    sched = ell_schedule(data, torch.zeros((nb, w), dtype=torch.int32), ctas)
    got, prefix, bounds = _check_ranges(sched, data)
    assert got.tolist() == live
    np.testing.assert_array_equal(
        bounds, np.arange(ctas + 1) * sum(live) // ctas)


@pytest.mark.parametrize("layout", ["forward", "transposed"])
@pytest.mark.parametrize("with_c", [False, True])
@pytest.mark.parametrize("s", [None, 1, 5, 8])
def test_ops_with_a_schedule_match_jax(layout, with_c, s):
    """``ops.ell_matvec`` (s None) and ``ops.ell_matmat`` with ``sched=``
    on CPU tensors equal the JAX ops on the same numpy inputs."""
    rng = np.random.default_rng(7 + (s or 0))
    X, _, _ = j_make_sparse(d=70, n=90, density=0.05, seed=3)
    ell = j_ell_from_csr(X if layout == "forward" else X.transpose(), 16, 16)
    n_in = ell.n_col_blocks * 16
    c = rng.uniform(0.0, 0.25, n_in).astype(np.float32) if with_c else None
    T = torch.from_numpy
    data, cols = T(ell.data), T(ell.cols)
    sched = ell_schedule(data, cols, 5)
    tc = None if c is None else T(c)
    if s is None:
        v = rng.standard_normal(n_in).astype(np.float32)
        want = np.asarray(jops.ell_matvec(ell.data, ell.cols, v, c))
        got = tops.ell_matvec(data, cols, T(v), tc, sched=sched)
    else:
        V = rng.standard_normal((n_in, s)).astype(np.float32)
        want = np.asarray(jops.ell_matmat(ell.data, ell.cols, V, c))
        got = tops.ell_matmat(data, cols, T(V), tc, sched=sched)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("partition", ["samples", "features"])
@pytest.mark.parametrize("m", [1, 4])
def test_sparse_solver_keeps_each_layouts_schedule(partition, m):
    """``DiscoSolver`` builds each shard's two schedules once at set-up and
    hands them to the shards' ``EllPair`` (the products pass them on)."""
    X, y, _ = make_sparse_glm_data(d=96, n=200, density=0.2, seed=1)
    cfg = DiscoConfig(loss="logistic", lam=1e-3, tau=50, max_outer=2,
                      ell_block_d=16, ell_block_n=16, partition=partition)
    solver = DiscoSolver(X, y, cfg, group=InProcessGroup(m), device="cpu")
    assert solver.ell_sched.shape[0] == m == len(solver._locs)
    for s, loc in enumerate(solver._locs):
        for sched, data, cols in ((loc.sched, loc.data, loc.cols),
                                  (loc.schedT, loc.dataT, loc.colsT)):
            assert torch.equal(sched, ell_schedule(data, cols, 132))
            _check_ranges(sched, data)
        assert loc.sched is not None and loc.schedT is not None
    assert np.isfinite(solver.fit().w).all()
