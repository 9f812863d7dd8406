"""The plan and split of the fused dense kernels (K5 ``x_c_xt_u``, K10
``x_c_xt_multi``) on the CPU.

``repro_torch.kernels.glm_hvp.fused_plan`` (the fit rule) and
``fused_split`` are plain Python over ints, and ``csrc/fused_stream.cuh``
computes the same rows, layout and panel bounds on the card. Checked here:
every plan fits one CTA's shared memory and reaches every shape the fused
kernels took before (panels of a whole column height); the split gives
every panel to exactly one cluster, shares differing by at most one panel;
and a walk of the algorithm, written after the kernel (Q CTAs of a cluster
each holding a slice of a panel's rows, the partial X^T U of each panel
published into one of four exchange slots, read back in rank order once
every CTA of the cluster has arrived, pass 2 one panel behind pass 1, the
clusters' partials added in cluster order), run under random interleavings
of the CTAs, never overwrites a slot a peer has still to read and gives
X (c .* (X^T U)) exactly on integer data; within a CTA every partial of
the exchange belongs to one consumer thread at both tile types (two a
thread from s = 5 on at bf16's 64-column panels). The ops at the
solver's m = 4 shard shapes run their plain versions here, which must
equal the JAX ops on the same numpy inputs (rtol 1e-5, atol 1e-5: f32
sums in another order). The kernels themselves run only on the card
(``tests/test_torch_cuda.py``).
"""
import random
import re

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import torch

from repro.data.synthetic import make_glm_data
from repro.kernels import ops as jops
from repro_torch.kernels import build, glm_hvp
from repro_torch.kernels import ops as tops
from repro_torch.kernels.glm_hvp import (FusedPlan, fused_plan, fused_split,
                                         fused_smem_bytes)

COLUMNS = list(range(1, build.MAX_COLS + 1))
DS = [1, 5, 200, 256, 257, 1000, 1024, 2048, 4095, 4096, 4097, 6144, 8192,
      9000, 10_240, 11_000, 12_288, 12_289, 20_000]


def _old_rule_fits(d, s):
    """Whether the fused kernels of earlier versions took (d, s): a CTA
    held a whole-height panel of at least 4 columns beside its partial Y
    (d, s) and (warps + 1) x 4 x s partials (1024 threads up to s = 5,
    512 above)."""
    warps = (1024 if s <= 5 else 512) // 32
    return 4 * (4 * d + d * s + (warps + 1) * 4 * s) <= glm_hvp.SMEM_LIMIT


@pytest.mark.parametrize("s", COLUMNS)
def test_every_plan_fits_one_cta(s):
    for d in DS:
        plan = fused_plan(d, s)
        if plan is None:
            continue
        assert plan.cluster in glm_hvp.CLUSTER_SIZES
        assert plan.bn in glm_hvp.FUSED_WIDTHS
        assert 2 <= plan.stages <= glm_hvp.FUSED_MAX_STAGES
        assert plan.rows % glm_hvp.FUSED_ROW_QUANTUM == 0
        assert plan.cluster * plan.rows >= d > (plan.cluster * plan.rows
                                                - plan.cluster * 256)
        assert plan.groups <= glm_hvp.fused_max_groups(s)
        assert plan.lag == (1 if plan.stages >= 3 else 0)
        assert fused_smem_bytes(plan.rows, plan.bn, plan.stages, s) <= \
            glm_hvp.SMEM_LIMIT


@pytest.mark.parametrize("s", COLUMNS)
def test_plan_reaches_every_shape_the_old_panels_took(s):
    """No shape that took the fused kernel before goes to the two-pass
    route now; past the rule's reach nothing fits."""
    reach = max(d for d in range(1, 16_000, 7) if fused_plan(d, s))
    for d in range(1, 16_000, 7):
        if _old_rule_fits(d, s):
            assert fused_plan(d, s) is not None, d
        assert (fused_plan(d, s) is not None) == (d <= reach)
    limit = {1: 12_288, 2: 10_240, 3: 10_240, 4: 8192, 5: 8192}.get(s, 6144)
    assert fused_plan(limit, s) is not None
    assert fused_plan(limit + 1, s) is None


def test_plan_at_the_solver_shapes():
    """Full width and the DiSCO-S view (d = 4,096): clusters of 8, panels
    of 32 columns, 512 rows a CTA, three 64 KB stages at every s; the
    DiSCO-F m = 4 rows (d = 1,024): clusters of 2."""
    for s in COLUMNS:
        assert fused_plan(4096, s) == FusedPlan(8, 32, 3, 512)
    assert fused_plan(1024) == FusedPlan(2, 32, 3, 512)
    assert fused_plan(200) == FusedPlan(1, 32, 4, 256)
    assert fused_plan(11_000) == FusedPlan(8, 16, 2, 1536)
    assert fused_smem_bytes(512, 32, 3, 8) == \
        128 + 4 * 256 * 4 + 8 * 256 * 4 + 256 * 4 + 512 * 8 * 4 + 3 * 65_536
    # one cluster size asked for: the same rule over that size alone
    assert fused_plan(4096, 1, 4) == FusedPlan(4, 16, 3, 1024)
    assert fused_plan(4096, 1, 1) is None
    assert fused_plan(4096, 8, 2) is None


@pytest.mark.parametrize("n", [1, 31, 32, 33, 1101, 65_536, 262_144])
@pytest.mark.parametrize("clusters", [1, 3, 16, 66, 200])
@pytest.mark.parametrize("bn", glm_hvp.FUSED_WIDTHS)
def test_every_panel_in_one_cluster(n, clusters, bn):
    split = fused_split(n, bn, clusters)
    assert split.panels == -(-n // bn)
    cover = np.zeros(n, np.int64)
    sizes = []
    for k in range(clusters):
        lo, hi = split.bound(k), split.bound(k + 1)
        sizes.append(hi - lo)
        for t in range(lo, hi):
            assert split.owner(t) == k
            a, b = split.columns(t)
            cover[a:b] += 1
    assert split.bound(0) == 0 and split.bound(clusters) == split.panels
    assert (cover == 1).all()
    assert max(sizes) - min(sizes) <= 1


def test_split_is_cached_and_checked():
    a = fused_split(262_144, 32, 16)
    assert fused_split(262_144, 32, 16) is a
    assert a.panels == 8192 and a.bound(1) == 512
    for bad in ((0, 32, 1), (8, 0, 1), (8, 32, 0)):
        with pytest.raises(ValueError):
            fused_split(*bad)


class _Cluster:
    """One cluster of Q CTAs of the fused kernel on the host, each CTA a
    generator stepped by a random scheduler. Models the exchange: four
    slots a CTA, each with a barrier that every CTA of the cluster arrives
    on once a panel and whose waiters test the phase's parity."""

    SLOTS = glm_hvp.FUSED_SLOTS

    def __init__(self, X, c, U, panels, plan, bn, rng):
        self.X, self.c, self.U = X, c, U
        self.panels, self.plan, self.bn, self.rng = panels, plan, bn, rng
        q = plan.cluster
        self.slot = [[None] * self.SLOTS for _ in range(q)]   # (panel, z)
        self.readers = [[set() for _ in range(self.SLOTS)] for _ in range(q)]
        self.arrived = [[0] * self.SLOTS for _ in range(q)]
        self.phases = [[0] * self.SLOTS for _ in range(q)]
        self.y = [None] * q

    def rows(self, rank):
        d = self.X.shape[0]
        lo = rank * self.plan.rows
        return slice(min(d, lo), min(d, lo + self.plan.rows))

    def cols(self, m):
        n = self.X.shape[1]
        lo = self.panels[m] * self.bn
        return slice(lo, min(n, lo + self.bn))

    def publish(self, rank, m):
        q, sl = self.plan.cluster, m % self.SLOTS
        old = self.slot[rank][sl]
        if old is not None:      # every peer read the panel it held
            assert self.readers[rank][sl] == set(range(q)), (rank, m, old[0])
        rows, cols = self.rows(rank), self.cols(m)
        self.slot[rank][sl] = (m, self.X[rows, cols].T @ self.U[rows])
        self.readers[rank][sl] = set()
        for peer in range(q):    # this CTA's arrival on every peer
            # the arrival belongs to the phase of this panel, not a later one
            assert self.phases[peer][sl] == m // self.SLOTS
            self.arrived[peer][sl] += 1
            if self.arrived[peer][sl] == q:
                self.arrived[peer][sl] = 0
                self.phases[peer][sl] += 1

    def run_cta(self, rank):
        q, lag, np_ = self.plan.cluster, self.plan.lag, len(self.panels)
        rows = self.rows(rank)
        y = np.zeros((rows.stop - rows.start, self.U.shape[1]))

        def pass2(m):
            sl = m % self.SLOTS
            # try_wait.parity: done once the phase of parity (m / 4) & 1 has
            # completed; it must be this panel's phase, not two later
            while self.phases[rank][sl] % 2 == (m // self.SLOTS) % 2:
                yield
            assert self.phases[rank][sl] == m // self.SLOTS + 1
            z = 0
            for peer in range(q):            # rank order
                tag, part = self.slot[peer][sl]
                assert tag == m
                self.readers[peer][sl].add(rank)
                z = z + part
            cols = self.cols(m)
            y[:] += self.X[rows, cols] @ (self.c[cols, None] * z)

        if np_:
            self.publish(rank, 0)
            yield
            if lag and np_ > 1:
                self.publish(rank, 1)
                yield
            for m in range(np_):
                yield from pass2(m)
                if m + 1 + lag < np_:
                    self.publish(rank, m + 1 + lag)
                    yield
        self.y[rank] = y

    def run(self):
        ctas = {r: self.run_cta(r) for r in range(self.plan.cluster)}
        while ctas:
            r = self.rng.choice(sorted(ctas))
            try:
                next(ctas[r])
            except StopIteration:
                del ctas[r]
        return np.concatenate(self.y)


def _walk(X, c, U, plan, clusters, seed):
    """The fused kernel's algorithm on the host: per cluster, its panels,
    its CTAs interleaved at random; then the clusters' partials of Y added
    in cluster order."""
    d, n = X.shape
    split = fused_split(n, plan.bn, clusters)
    rng = random.Random(seed)
    scratch = np.full((clusters, d, U.shape[1]), np.nan)
    for k in range(clusters):
        panels = list(range(split.bound(k), split.bound(k + 1)))
        scratch[k] = _Cluster(X, c, U, panels, plan, plan.bn, rng).run()
    out = scratch[0].copy()
    for k in range(1, clusters):
        out += scratch[k]
    return out


@pytest.mark.parametrize("cluster", glm_hvp.CLUSTER_SIZES)
@pytest.mark.parametrize("stages", [2, 3])
@settings(max_examples=12, deadline=None)
@given(d=st.integers(1, 700), n=st.integers(1, 300), s=st.integers(1, 3),
       clusters=st.integers(1, 5), seed=st.integers(0, 2**16))
def test_walk_of_the_algorithm_is_exact(cluster, stages, d, n, s, clusters,
                                        seed):
    """Integer data: every sum is exact, so the walk must give
    X (c .* (X^T U)) to the last bit, whatever the interleaving; a row or
    panel missed, counted twice, or a slot read after its overwrite would
    show (the last also trips the walk's own asserts)."""
    # a row quantum of 8 in place of 256 keeps ragged ranks and ranks past
    # d in reach at small d
    rows = -(-(-(-d // cluster)) // 8) * 8
    plan = FusedPlan(cluster, 16, stages, rows)
    rng = np.random.default_rng(seed)
    X = rng.integers(-4, 5, (d, n)).astype(np.float64)
    c = rng.integers(0, 4, n).astype(np.float64)
    U = rng.integers(-3, 4, (d, s)).astype(np.float64)
    got = _walk(X, c, U, plan, clusters, seed)
    np.testing.assert_array_equal(got, X @ (c[:, None] * (X.T @ U)))


def test_walk_at_ragged_ranks_and_long_ranges():
    """Many panels a cluster (the slots wrap many times), d not a multiple
    of Q, and a rank wholly past d."""
    rng = np.random.default_rng(5)
    for d, n, q, rows in ((13, 400, 8, 2), (30, 257, 4, 8), (9, 64, 2, 8)):
        X = rng.integers(-4, 5, (d, n)).astype(np.float64)
        c = rng.integers(0, 4, n).astype(np.float64)
        U = rng.integers(-3, 4, (d, 2)).astype(np.float64)
        for stages in (2, 3):
            plan = FusedPlan(q, 16, stages, rows)
            got = _walk(X, c, U, plan, 2, seed=d * n)
            np.testing.assert_array_equal(got, X @ (c[:, None] * (X.T @ U)))


def test_header_and_wrapper_agree_on_the_plan():
    """The host's constants and the two little rules are the header's, and
    both entry points include the design header."""
    text = (build.CSRC / "fused_stream.cuh").read_text()
    get = lambda k: int(re.search(rf"constexpr int {k} = (\d+);", text)[1])
    assert get("kThreads") == glm_hvp.FUSED_THREADS
    assert get("kRowQuantum") == glm_hvp.FUSED_ROW_QUANTUM
    assert get("kSlots") == glm_hvp.FUSED_SLOTS
    assert get("kMaxStages") == glm_hvp.FUSED_MAX_STAGES
    assert get("kBarrierBytes") == glm_hvp.FUSED_BARRIER_BYTES
    assert "return S == 1 ? 6 : S <= 3 ? 5 : S <= 5 ? 4 : 3;" in text
    assert [glm_hvp.fused_max_groups(s) for s in COLUMNS] == \
        [6, 5, 5, 4, 4, 3, 3, 3]
    assert "return S <= 2 ? S : S <= 4 ? 4 : 8;" in text
    assert [glm_hvp.fused_padded(s) for s in COLUMNS] == \
        [1, 2, 4, 4, 8, 8, 8, 8]
    # the panel widths: rows of 128 and 64 bytes, 16 bytes a thread's read
    assert "constexpr int kVec = 16 / static_cast<int>(sizeof(T));" in text
    assert "constexpr int kWide = 8 * kVec<T>;" in text
    assert "constexpr int kNarrow = 4 * kVec<T>;" in text
    assert "bn == kWide<T> || bn == kNarrow<T>" in text
    assert glm_hvp.FUSED_WIDTHS_BY_DTYPE == {
        dt: (8 * 16 // dt.itemsize, 4 * 16 // dt.itemsize)
        for dt in glm_hvp.TILE_DTYPES}
    assert glm_hvp.FUSED_WIDTHS == (32, 16)
    assert set(glm_hvp.last_fused) == {"x_c_xt_u", "x_c_xt_multi",
                                       "x_c_xt_u_bf16", "x_c_xt_multi_bf16"}
    for src in ("x_c_xt_u.cu", "x_c_xt_multi.cu", "x_c_xt_u_bf16.cu",
                "x_c_xt_multi_bf16.cu"):
        assert '#include "fused_stream.cuh"' in \
            (build.CSRC / src).read_text()


@pytest.mark.parametrize("s", COLUMNS)
@pytest.mark.parametrize("dtype", glm_hvp.TILE_DTYPES,
                         ids=["f32", "bf16"])
def test_exchange_partials_cover_the_panel(s, dtype):
    """The exchange's E = bn s partials of a panel over the 256 consumer
    threads, as the kernel unrolls them (thread t takes t + 256 h for h <
    PER = E / 256 rounded up, the same loop in the publish and in pass 2,
    so the threads that wait on the exchange are the ones that read it):
    every partial summed over the warps, published and read back by
    exactly one thread; PER is 1 at f32 and 2 from s = 5 on at bf16's
    64-column panels. A walk of the publish on integer data is exact."""
    text = (build.CSRC / "fused_stream.cuh").read_text()
    assert "constexpr int PER = (E + kThreads - 1) / kThreads;" in text
    assert text.count("const int i = t + h * kThreads;") == 2
    rng = np.random.default_rng(s)
    threads = glm_hvp.FUSED_THREADS
    for bn in glm_hvp.FUSED_WIDTHS_BY_DTYPE[dtype]:
        E = bn * s
        per = -(-E // threads)
        owner = {}
        for t in range(threads):
            for h in range(per):
                i = t + h * threads
                if i < E:
                    assert i not in owner
                    owner[i] = t
        assert sorted(owner) == list(range(E))
        assert (per > 1) == (dtype == torch.bfloat16 and bn == 64
                             and s >= 5)
        red = rng.integers(-9, 10, (8, E))
        slots = np.full(E, np.nan)
        for i, t in owner.items():
            slots[i] = red[:, i].sum()
        np.testing.assert_array_equal(slots, red.sum(axis=0))


SHARDS = {"S_m4_view": (slice(None), slice(0, 512)),
          "F_m4_rows": (slice(0, 16), slice(None))}


@pytest.mark.parametrize("shard", list(SHARDS))
@pytest.mark.parametrize("with_c", [False, True])
def test_fused_ops_match_jax_at_shard_shapes(shard, with_c):
    """x_c_xt_u and x_c_xt_multi (s = 5) on the dense slice's m = 4 shard
    shapes at a reduced size (X (64, 2048)): a DiSCO-S column view and a
    DiSCO-F row block, passed as views, against the JAX ops on copies."""
    X, _, _ = make_glm_data(64, 2048, seed=4)
    rows, cols = SHARDS[shard]
    rng = np.random.default_rng(4)
    A = np.ascontiguousarray(X[rows, cols])
    d, n = A.shape
    u = rng.standard_normal(d).astype(np.float32)
    U = rng.standard_normal((d, 5)).astype(np.float32)
    c = rng.uniform(0.0, 0.25, n).astype(np.float32)
    view = torch.from_numpy(X)[rows, cols]
    T = torch.from_numpy
    cj = c if with_c else np.ones_like(c)
    got = tops.x_c_xt_u(view, T(c) if with_c else None, T(u))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jops.x_c_xt_u(A, cj, u)),
                               rtol=1e-5, atol=1e-5)
    got = tops.x_c_xt_multi(view, T(c) if with_c else None, T(U))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jops.x_c_xt_multi(A, cj, U)),
                               rtol=1e-5, atol=1e-5)
