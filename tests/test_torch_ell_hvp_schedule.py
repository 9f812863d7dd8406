"""The step schedule of ``ell_hvp`` / ``ell_hvp_mm`` (K2 / K7) on the CPU.

``repro_torch.kernels.sparse_hvp.ell_hvp_schedule`` is plain torch, so its
contract is checked here: every live tile lies in exactly one step and one
CTA range, steps are runs of whole row-blocks, no step holds more than
``step_bytes`` of tiles unless it holds one live row-block, and the ranges
within a step differ by at most one tile; on empty row-blocks, W = 1, and
``step_bytes`` below any row-block or above the whole layout.

A plain-torch walk repeats the kernels' order (steps, each CTA's range,
the partial z of each row-block summed in CTA order, the scale c, then the
scatter of pass B) and reads only the live slots. On ``ell_from_csr``
layouts with NaN written into every padding slot it is held against the
JAX package's ``ell_hvp`` / ``ell_hvp_mm`` Pallas kernels in interpret mode
and against ``ref_ell_hvp_t`` / ``ref_ell_hvp_mm_t`` on the clean layout,
at relative L2 <= 1e-5 (f32 sums in another order). The CUDA kernels that
walk the schedule run only on the card (``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import sparse_hvp as jsparse
from repro_torch import DiscoConfig, DiscoSolver, InProcessGroup
from repro_torch.data.sparse import ell_from_csr, make_sparse_glm_data
from repro_torch.kernels import build, ops, ref, sparse_hvp
from repro_torch.kernels.sparse_hvp import (HvpSchedule, default_step_bytes,
                                            ell_hvp_schedule, ell_schedule,
                                            schedule_parts)

REL_TOL = 1e-5


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _check_steps(sched, data):
    """The schedule's contract on layout ``data``; returns its parts as
    numpy."""
    nb, w, r, c = data.shape
    tile_bytes = r * c * 4
    live, prefix, first, bounds = (t.numpy().astype(np.int64)
                                   for t in sched.parts())
    assert sched.table.dtype == torch.int32 and sched.nb == nb
    assert bounds.shape == (sched.steps, sched.ctas + 1)
    assert sched.state.shape == (2 * nb,) and not sched.state.any()
    # live counts as ell_schedule takes them
    np.testing.assert_array_equal(
        live, schedule_parts(ell_schedule(data, torch.zeros((nb, w),
                                          dtype=torch.int32), 1), nb)[0])
    assert prefix[0] == 0 and (np.diff(prefix) == live).all()
    # steps: consecutive runs of whole row-blocks covering all of them
    assert first[0] == 0 and first[-1] == nb and (np.diff(first) > 0).all()
    for i in range(sched.steps):
        lo, hi = prefix[first[i]], prefix[first[i + 1]]
        held = live[first[i]:first[i + 1]]
        if hi - lo > 0 and (hi - lo) * tile_bytes > sched.step_bytes:
            assert (held > 0).sum() == 1          # one row-block alone
        if i + 1 < sched.steps:                   # greedy: the next live
            nxt = live[first[i + 1]]              # row-block did not fit
            assert nxt > 0 and (hi - lo + nxt) * tile_bytes > sched.step_bytes
        # the CTAs' ranges tile the step's live tiles, sizes within one
        b = bounds[i]
        assert b[0] == lo and b[-1] == hi and (np.diff(b) >= 0).all()
        sizes = np.diff(b)
        assert sizes.max() - sizes.min() <= 1
    # every live tile in exactly one step and one CTA range
    total = prefix[-1]
    owners = np.zeros(total, np.int64)
    for i in range(sched.steps):
        for k in range(sched.ctas):
            owners[bounds[i, k]:bounds[i, k + 1]] += 1
    assert (owners == 1).all()
    return live, prefix, first, bounds


def _transposed(seed, br, bc, d=300, n=260, density=0.02):
    """The transposed layout of a seeded power-law matrix (tiles of
    A^T), and the clean and NaN-padded tensors."""
    X, _, _ = make_sparse_glm_data(d=d, n=n, density=density, seed=seed)
    return ell_from_csr(X.transpose(), bc, br)


@pytest.mark.parametrize("block", [(8, 8), (16, 16), (16, 8)])
@pytest.mark.parametrize("ctas", [1, 7, 132])
@pytest.mark.parametrize("step_tiles", [0, 1, 30, None, 10**9])
def test_step_schedule_of_a_layout(block, ctas, step_tiles):
    """step_tiles: step_bytes in tiles (0: below any row-block; None: the
    default; 10**9: above the whole layout)."""
    ell = _transposed(0, *block)
    data = torch.from_numpy(ell.data)
    nb, w, r, c = data.shape
    step_bytes = (None if step_tiles is None
                  else max(1, step_tiles * r * c * 4))
    sched = ell_hvp_schedule(data, torch.from_numpy(ell.cols), ctas,
                             step_bytes)
    live, _, _, _ = _check_steps(sched, data)
    assert sched.ctas == ctas
    if step_tiles == 0:
        assert sched.steps == (live > 0).sum()
    if step_tiles == 10**9 or step_tiles is None:
        assert sched.steps == 1                   # the layout is small


def test_step_schedule_of_empty_row_blocks_and_w1():
    data = torch.zeros((9, 1, 2, 4))
    for i in (1, 2, 5, 8):
        data[i, 0, 1, 3] = 1.0
    cols = torch.zeros((9, 1), dtype=torch.int32)
    for step_bytes in (1, 2 * 32, 10**6):
        sched = ell_hvp_schedule(data, cols, 3, step_bytes)
        live, _, first, bounds = _check_steps(sched, data)
        assert live.tolist() == [0, 1, 1, 0, 0, 1, 0, 0, 1]
    assert sched.steps == 1 and bounds[0].tolist() == [0, 1, 2, 4]
    # every live row-block a step: the empty ones join the step they fall in
    sched = ell_hvp_schedule(data, cols, 3, 1)
    assert sched.parts()[2].tolist() == [0, 2, 5, 8, 9]


def test_step_schedule_of_an_all_zero_layout():
    data = torch.zeros((4, 3, 2, 2))
    sched = ell_hvp_schedule(data, torch.zeros((4, 3), dtype=torch.int32),
                             5, 1)
    live, _, first, bounds = _check_steps(sched, data)
    assert sched.steps == 1 and first.tolist() == [0, 4]
    assert not live.any() and not bounds.any()


@settings(max_examples=80, deadline=None)
@given(live=st.lists(st.integers(0, 12), min_size=1, max_size=40),
       ctas=st.integers(1, 20), step_tiles=st.integers(1, 40),
       seed=st.integers(0, 2**31 - 1))
def test_step_schedule_of_random_live_counts(live, ctas, step_tiles, seed):
    """Row-blocks whose last nonzero tile is at slot live[i] - 1, with
    random zero tiles before it; step_bytes of 1 to 40 tiles."""
    nb, w = len(live), max(max(live), 1)
    rng = np.random.default_rng(seed)
    data = np.zeros((nb, w, 1, 2), np.float32)
    for i, n in enumerate(live):
        if n:
            data[i, :n - 1, 0, 1] = rng.integers(0, 2, n - 1)
            data[i, n - 1, 0, 0] = 1.0
    data = torch.from_numpy(data)
    sched = ell_hvp_schedule(data, torch.zeros((nb, w), dtype=torch.int32),
                             ctas, step_tiles * 8)
    got, _, _, _ = _check_steps(sched, data)
    assert got.tolist() == live


def test_step_schedule_takes_the_live_counts_it_is_given():
    ell = _transposed(1, 16, 16)
    data, cols = torch.from_numpy(ell.data), torch.from_numpy(ell.cols)
    live = schedule_parts(ell_schedule(data, cols, 132), data.shape[0])[0]
    a = ell_hvp_schedule(data, cols, 132, 4096)
    b = ell_hvp_schedule(data, cols, 132, 4096, live=live)
    assert torch.equal(a.table, b.table) and a.steps == b.steps


def test_step_schedule_defaults_and_refusals():
    assert default_step_bytes("cpu") == 50 * 2**20 * 3 // 8
    data = torch.zeros((2, 3, 4, 4))
    data[0, 0, 0, 0] = 1.0
    cols = torch.zeros((2, 3), dtype=torch.int32)
    sched = ell_hvp_schedule(data, cols)
    assert sched.ctas == 132 and sched.step_bytes == default_step_bytes("cpu")
    assert [sched.next_epoch() for _ in range(3)] == [1, 2, 3]
    with pytest.raises(ValueError, match="not a blocked-ELL layout"):
        ell_hvp_schedule(data, torch.zeros((2, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="must be positive"):
        ell_hvp_schedule(data, cols, 0)
    with pytest.raises(ValueError, match="must be positive"):
        ell_hvp_schedule(data, cols, 4, 0)
    # the wrappers take a schedule of this layout only
    with pytest.raises(TypeError, match="HvpSchedule"):
        sparse_hvp._check_hvp_schedule(torch.zeros(3, dtype=torch.int32),
                                       data)
    other = ell_hvp_schedule(torch.zeros((3, 3, 4, 4)),
                             torch.zeros((3, 3), dtype=torch.int32), 4)
    with pytest.raises(ValueError, match="row-blocks"):
        sparse_hvp._check_hvp_schedule(other, data)
    # None: every slot live, cached per shape and device
    every = sparse_hvp._check_hvp_schedule(None, data)
    assert every.parts()[0].tolist() == [3, 3]
    assert sparse_hvp._check_hvp_schedule(None, data) is every


def test_scratch_sets_match_the_kernels_header():
    header = (build.CSRC / "ell_hvp_stream.cuh").read_text()
    assert (f"kScratchSets = {sparse_hvp.SCRATCH_SETS};" in header)


def walk_hvp(dataT, colsT, U, c, sched):
    """Y = A (c .* (A^T U)) in the kernels' order: per step, each CTA's
    range of live tiles in pass A (a partial z per row-block segment), the
    partials of each row-block summed in CTA order and scaled by c, then
    pass B over the same ranges scattering cz^T tile into Y. Reads only
    the live slots."""
    nb, _, r, cc = dataT.shape
    s = U.shape[1]
    live, prefix, first, bounds = sched.parts()
    prefix, bounds = prefix.tolist(), bounds.tolist()
    Ub = U.reshape(-1, cc, s)
    Y = torch.zeros_like(Ub)

    def segments(b0, b1):
        for j in range(nb):
            lo, hi = max(prefix[j], b0), min(prefix[j + 1], b1)
            if lo < hi:
                yield j, range(lo - prefix[j], hi - prefix[j])

    for step in range(sched.steps):
        bnd = bounds[step]
        parts = {}                                   # row-block -> [z]
        for k in range(sched.ctas):                  # pass A, CTA order
            for j, slots in segments(bnd[k], bnd[k + 1]):
                z = torch.zeros((r, s))
                for t in slots:
                    z += dataT[j, t] @ Ub[colsT[j, t]]
                parts.setdefault(j, []).append(z)
        cz = {}
        for j, zs in parts.items():
            z = zs[0]
            for more in zs[1:]:
                z = z + more
            cz[j] = z if c is None else c.reshape(nb, r)[j][:, None] * z
        for k in range(sched.ctas):                  # pass B
            for j, slots in segments(bnd[k], bnd[k + 1]):
                for t in slots:
                    Y[colsT[j, t]] += dataT[j, t].T @ cz[j]
    return Y.reshape(-1, s)


@pytest.mark.parametrize("block", [(8, 8), (16, 8)])
@pytest.mark.parametrize("s", [None, 1, 3, 5])
@pytest.mark.parametrize("with_c", [False, True])
@pytest.mark.parametrize("ctas,step_tiles", [(1, None), (7, 0), (7, 12),
                                             (132, None), (5, 10**9)])
def test_walk_matches_jax_and_the_plain_versions(block, s, with_c, ctas,
                                                 step_tiles):
    """The walk on the NaN-padded layout against the JAX kernels in
    interpret mode and the plain versions on the clean layout."""
    br, bc = block
    ell = _transposed(2, br, bc, d=120, n=100, density=0.05)
    nb, w, r, cc = ell.data.shape
    rng = np.random.default_rng(10 * br + (s or 0))
    n_u = ell.n_col_blocks * cc
    u = rng.standard_normal((n_u, s or 1)).astype(np.float32)
    c = (rng.uniform(0.0, 0.25, nb * r).astype(np.float32) if with_c
         else None)
    T = torch.from_numpy
    clean, colsT = T(ell.data), T(ell.cols)
    step_bytes = (None if step_tiles is None
                  else max(1, step_tiles * r * cc * 4))
    sched = ell_hvp_schedule(clean, colsT, ctas, step_bytes)
    live = sched.parts()[0].long()
    poisoned = clean.clone()
    poisoned[torch.arange(w)[None, :] >= live[:, None]] = float("nan")
    assert poisoned.isnan().any()
    tc = None if c is None else T(c)
    got = walk_hvp(poisoned, colsT, T(u), tc, sched)
    assert bool(got.isfinite().all())
    if s is None:
        want_jax = np.asarray(jsparse.ell_hvp(ell.data, ell.cols, u[:, 0], c,
                                              interpret=True))
        want = ref.ref_ell_hvp_t(clean, colsT, T(u[:, 0]), tc)
        got = got[:, 0]
    else:
        want_jax = np.asarray(jsparse.ell_hvp_mm(ell.data, ell.cols, u, c,
                                                 interpret=True))
        want = ref.ref_ell_hvp_mm_t(clean, colsT, T(u), tc)
    assert got.shape == want.shape
    assert _rel(got, want_jax) <= REL_TOL
    assert _rel(got, want) <= REL_TOL


def test_ops_take_the_step_schedule_on_the_cpu():
    """On CPU tensors the ops accept ``sched`` and run the plain versions,
    which read every slot (the padding holds zero tiles)."""
    ell = _transposed(3, 16, 16)
    T = torch.from_numpy
    dataT, colsT = T(ell.data), T(ell.cols)
    sched = ell_hvp_schedule(dataT, colsT, 132)
    n_u = ell.n_col_blocks * 16
    u, U = torch.randn(n_u), torch.randn((n_u, 11))
    c = torch.rand(dataT.shape[0] * 16)
    build.reset_launch_counts()
    y = ops.ell_hvp(dataT, colsT, u, c, sched=sched)
    Y = ops.ell_hvp_mm(dataT, colsT, U, c, sched=sched)
    assert sum(build.launch_counts().values()) == 0
    assert torch.equal(y, ref.ref_ell_hvp_t(dataT, colsT, u, c))
    assert torch.equal(Y, ref.ref_ell_hvp_mm_t(dataT, colsT, U, c))
    assert _rel(walk_hvp(dataT, colsT, u[:, None], c, sched)[:, 0],
                y) <= REL_TOL


@pytest.mark.parametrize("partition", ["samples", "features"])
@pytest.mark.parametrize("m", [1, 4])
def test_sparse_solver_keeps_the_step_schedule(partition, m):
    """``DiscoSolver`` builds each shard's step schedule once at set-up,
    from the transposed layout's live counts, and hands it to the shard's
    ``EllPair`` (the fused products pass it on)."""
    X, y, _ = make_sparse_glm_data(d=96, n=200, density=0.2, seed=1)
    cfg = DiscoConfig(loss="logistic", lam=1e-3, tau=50, max_outer=2,
                      ell_block_d=16, ell_block_n=16, partition=partition,
                      hvp_fused=True)
    solver = DiscoSolver(X, y, cfg, group=InProcessGroup(m), device="cpu")
    assert len(solver.ell_hvp_sched) == m
    for loc in solver._locs:
        hs = loc.hvp_sched
        assert isinstance(hs, HvpSchedule)
        want = ell_hvp_schedule(loc.dataT, loc.colsT, 132)
        assert torch.equal(hs.table, want.table)
        assert hs.step_bytes == default_step_bytes("cpu")
        _check_steps(hs, loc.dataT)
    assert np.isfinite(solver.fit().w).all()
