"""The split of the dense streaming kernels (K3 ``xt_u``, K4 ``x_cz``) on
the CPU.

``repro_torch.kernels.glm_hvp.dense_split`` is plain Python over ints, and
``csrc/dense_stream.cuh`` computes the same bounds on the card. Its
contract is checked here over ragged shapes and CTA counts: every element
of X lies in exactly one piece of exactly one CTA, CTA shares differ by
at most one piece, and a cut unit is summed from its CTAs' partials in CTA
order. A walk of the split written after the kernel (whole units to the
output, cut ones to scratch slots, then the fix-up) reproduces X^T u and
X (c .* z) exactly on integer data. The ops at the solver's shard shapes
(a DiSCO-S column view, a DiSCO-F row block) run their plain versions
here, which must equal the JAX ops on the same numpy inputs (rtol 1e-5,
atol 1e-5: f32 sums in another order). The kernels themselves run only on
the card (``tests/test_torch_cuda.py``).
"""
import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.data.synthetic import make_glm_data
from repro.kernels import ops as jops
from repro_torch.kernels import build, glm_hvp
from repro_torch.kernels import ops as tops
from repro_torch.kernels.glm_hvp import dense_split
from repro_torch.kernels.sparse_hvp import default_ctas

KERNELS = ["xt_u", "x_cz"]
SHAPES = [(1, 1), (5, 2048), (31, 511), (33, 513), (64, 1024), (70, 1101),
          (100, 5000)]
CTAS = [1, 2, 7, 132, 1000]


def _ranges(split):
    return [(split.bound(k), split.bound(k + 1)) for k in range(split.ctas)]


def _piece_box(split, t, d, n):
    """(rows, cols) slices of X that piece t covers."""
    g, k = split.piece(t)
    r0, c0 = g * split.tile_rows, k * split.tile_cols
    return (slice(r0, min(d, r0 + split.tile_rows)),
            slice(c0, min(n, c0 + split.tile_cols)))


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("ctas", CTAS)
def test_every_element_in_one_piece_of_one_cta(kernel, shape, ctas):
    d, n = shape
    split = dense_split(kernel, d, n, ctas)
    assert split.groups == -(-d // glm_hvp.TILE_ROWS)
    assert split.chunks == -(-n // glm_hvp.TILE_COLS)
    cover = np.zeros((d, n), np.int64)
    ranges = _ranges(split)
    assert ranges[0][0] == 0 and ranges[-1][1] == split.pieces
    for (lo, hi), (nxt, _) in zip(ranges, ranges[1:]):
        assert hi == nxt            # the ranges tile [0, pieces) in order
    sizes = [hi - lo for lo, hi in ranges]
    assert max(sizes) - min(sizes) <= 1
    for k, (lo, hi) in enumerate(ranges):
        for t in range(lo, hi):
            assert split.owner(t) == k
            cover[_piece_box(split, t, d, n)] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("ctas", CTAS)
def test_fixup_sums_a_cut_unit_in_cta_order(kernel, shape, ctas):
    """A unit's pieces are a contiguous run (chunk-major for xt_u,
    row-group-major for x_cz); a cut unit lists every nonempty CTA that
    holds one of them, ascending, each CTA in slot 0 for the unit that
    holds its first piece and slot 1 for the other, at most one of each."""
    split = dense_split(kernel, *shape, ctas)
    slots = {}
    for unit in range(split.units):
        base = unit * split.per_unit
        pieces = range(base, base + split.per_unit)
        unit_of = (lambda t: split.piece(t)[1]) if split.by_chunk else \
            (lambda t: split.piece(t)[0])
        assert all(unit_of(t) == unit for t in pieces)
        owners = sorted({split.owner(t) for t in pieces})
        terms = split.fixup(unit)
        if len(owners) == 1:
            assert terms == []
            continue
        assert [k for k, _ in terms] == owners
        for k, slot in terms:
            first = split.bound(k)
            assert slot == (0 if base <= first < base + split.per_unit
                            else 1)
            assert (k, slot) not in slots
            slots[(k, slot)] = unit


def _walk(split, X, u=None, cz=None):
    """The kernel's walk on the host: each CTA's sums over its pieces,
    unit by unit, whole units to the output and cut ones to scratch slots,
    then the fix-up in CTA order."""
    d, n = X.shape
    length = n if split.by_chunk else d
    out = np.full(length, np.nan)
    scratch = np.full((split.ctas, 2, split.unit_len), np.nan)
    for k in range(split.ctas):
        b0, b1 = split.bound(k), split.bound(k + 1)
        acc = np.zeros(split.unit_len)
        for t in range(b0, b1):
            rows, cols = _piece_box(split, t, d, n)
            tile = X[rows, cols]
            if split.by_chunk:
                acc[:tile.shape[1]] += u[rows] @ tile
            else:
                acc[:tile.shape[0]] += tile @ cz[cols]
            pos = t % split.per_unit
            if pos + 1 < split.per_unit and t + 1 < b1:
                continue
            unit, base = t // split.per_unit, t - pos
            lo = unit * split.unit_len
            hi = min(length, lo + split.unit_len)
            if base >= b0 and base + split.per_unit <= b1:
                out[lo:hi] = acc[:hi - lo]
            else:
                scratch[k, 0 if base <= b0 else 1, :hi - lo] = acc[:hi - lo]
            acc[:] = 0
    for unit in range(split.units):
        terms = split.fixup(unit)
        if terms:
            lo = unit * split.unit_len
            hi = min(length, lo + split.unit_len)
            out[lo:hi] = sum(scratch[k, slot, :hi - lo] for k, slot in terms)
    return out


@settings(max_examples=40, deadline=None)
@given(d=st.integers(1, 80), n=st.integers(1, 1600),
       ctas=st.integers(1, 40), seed=st.integers(0, 2**16))
def test_walk_of_the_split_gives_the_products_exactly(d, n, ctas, seed):
    """Integer data: every sum is exact, so the walk must give X^T u and
    X (c .* z) to the last bit; an element missed, counted twice or a
    partial in the wrong slot would show."""
    rng = np.random.default_rng(seed)
    X = rng.integers(-8, 9, (d, n)).astype(np.float64)
    u = rng.integers(-4, 5, d).astype(np.float64)
    cz = rng.integers(-4, 5, n).astype(np.float64)
    z = _walk(dense_split("xt_u", d, n, ctas), X, u=u)
    y = _walk(dense_split("x_cz", d, n, ctas), X, cz=cz)
    np.testing.assert_array_equal(z, X.T @ u)
    np.testing.assert_array_equal(y, X @ cz)


def test_split_is_cached_and_checked():
    a = dense_split("xt_u", 4096, 262_144, 132)
    assert dense_split("xt_u", 4096, 262_144, 132) is a
    groups = -(-4096 // glm_hvp.TILE_ROWS)
    chunks = -(-262_144 // glm_hvp.TILE_COLS)
    assert (a.groups, a.chunks) == (groups, chunks)
    assert (a.units, a.per_unit, a.unit_len) == (chunks, groups,
                                                 glm_hvp.TILE_COLS)
    b = dense_split("x_cz", 4096, 262_144, 132)
    assert (b.units, b.per_unit, b.unit_len) == (groups, chunks,
                                                 glm_hvp.TILE_ROWS)
    for bad in (("xt_multi", 8, 8, 1), ("xt_u", 0, 8, 1),
                ("x_cz", 8, 8, 0)):
        with pytest.raises(ValueError):
            dense_split(*bad)


def test_split_at_the_dense_slice_shapes_has_no_wave_tail():
    """At the full width and both m = 4 shard shapes every one of the
    card's 132 CTAs has work, and shares differ by at most one piece."""
    for d, n in ((4096, 262_144), (4096, 65_536), (1024, 262_144)):
        for kernel in KERNELS:
            split = dense_split(kernel, d, n, 132)
            sizes = [hi - lo for lo, hi in _ranges(split)]
            assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1


def test_header_and_wrapper_agree_on_the_piece():
    """The wrapper's piece and CTA count are the header's and the card's
    (132 SMs on the CPU, as for an H100); both entry points include the
    design header."""
    text = (build.CSRC / "dense_stream.cuh").read_text()
    get = lambda k: int(re.search(rf"constexpr int {k} = (\d+);", text)[1])
    assert (get("kTileRows"), get("kTileCols")) == (glm_hvp.TILE_ROWS,
                                                   glm_hvp.TILE_COLS)
    assert default_ctas("cpu") == 132
    assert glm_hvp.PATHS == ("direct", "bulk")
    assert set(glm_hvp.last_path) == {"xt_u", "x_cz", "xt_u_bf16",
                                      "x_cz_bf16", "x_c_xt_u",
                                      "x_c_xt_multi", "x_c_xt_u_bf16",
                                      "x_c_xt_multi_bf16", "xt_multi",
                                      "x_cz_multi", "xt_multi_bf16",
                                      "x_cz_multi_bf16"}
    for src in ("xt_u.cu", "x_cz.cu", "xt_u_bf16.cu", "x_cz_bf16.cu"):
        assert '#include "dense_stream.cuh"' in (build.CSRC / src).read_text()


SHARDS = {"full": (slice(None), slice(None)),
          "S_m4_view": (slice(None), slice(0, 512)),
          "F_m4_rows": (slice(0, 16), slice(None))}


@pytest.mark.parametrize("shard", list(SHARDS))
@pytest.mark.parametrize("with_c", [False, True])
def test_dense_ops_match_jax_at_shard_shapes(shard, with_c):
    """xt_u and x_cz_local on the dense slice's shard shapes at a reduced
    size (X (64, 2048)): the whole X, a DiSCO-S column view and a DiSCO-F
    row block, passed as views, against the JAX ops on copies."""
    X, _, _ = make_glm_data(64, 2048, seed=3)
    rows, cols = SHARDS[shard]
    rng = np.random.default_rng(3)
    A = np.ascontiguousarray(X[rows, cols])
    d, n = A.shape
    u = rng.standard_normal(d).astype(np.float32)
    z = rng.standard_normal(n).astype(np.float32)
    c = rng.uniform(0.0, 0.25, n).astype(np.float32)
    view = torch.from_numpy(X)[rows, cols]
    T = torch.from_numpy
    np.testing.assert_allclose(tops.xt_u(view, T(u)).numpy(),
                               np.asarray(jops.xt_u(A, u)),
                               rtol=1e-5, atol=1e-5)
    got = tops.x_cz_local(view, T(c) if with_c else None, T(z))
    want = jops.x_cz_local(A, c if with_c else np.ones_like(c), z)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# bf16 tiles: the same split, a deeper ring, the 16-byte rule in bf16
# ---------------------------------------------------------------------------

def test_bf16_split_and_ring_mirror_the_header():
    """bf16 keeps the piece in elements (16 x 1536: the header's one
    kTileCols), so its split equals the f32 one at every shape; the ring
    the wrapper's mirror sizes from the header's constants takes 2 stages
    of f32 pieces and 4 (xt_u) or 3 (x_cz, whose stages also hold the f32
    z and c) of bf16 ones in 227 KB."""
    text = (build.CSRC / "dense_stream.cuh").read_text()
    get = lambda k: int(re.search(rf"constexpr int {k} = (\d+);", text)[1])
    assert get("kTileCols") == glm_hvp.TILE_COLS
    assert glm_hvp.TILE_DTYPES == (torch.float32, torch.bfloat16)
    assert (get("kMaxStages"), get("kBarrierBytes"), get("kThreads")) == (
        glm_hvp.DENSE_MAX_STAGES, glm_hvp.DENSE_BARRIER_BYTES,
        glm_hvp.DENSE_THREADS)
    for kernel in KERNELS:
        for d, n in SHAPES + [(4096, 262_144), (4096, 65_536)]:
            assert (dense_split(kernel, d, n, 132, torch.bfloat16)
                    == dense_split(kernel, d, n, 132))
    assert [glm_hvp.dense_stages(k, dt) for k in KERNELS
            for dt in (torch.float32, torch.bfloat16)] == [2, 4, 2, 3]
    with pytest.raises(TypeError):
        dense_split("xt_u", 8, 8, 1, torch.float16)


BF16_PATHS = {
    # name: (rows, columns allocated, view columns [lo, hi), path at f32,
    # path at bf16): rows of whole 16-byte units, 4 f32 or 8 bf16 elements
    "full": (64, 1024, (0, 1024), "bulk", "bulk"),
    "n_4": (64, 1028, (0, 1028), "bulk", "direct"),
    "view_at_4": (64, 2048, (4, 1028), "bulk", "direct"),
    "view_at_8": (64, 2048, (8, 1032), "bulk", "bulk"),
    "view_at_1": (64, 2048, (1, 1025), "direct", "direct"),
    "ld_1028": (64, 1028, (0, 1024), "bulk", "direct"),
    "ld_1032": (64, 1032, (0, 1024), "bulk", "bulk"),
    "S_m4_view_odd": (16, 4 * 1025, (1025, 2050), "direct", "direct"),
}


@pytest.mark.parametrize("name", list(BF16_PATHS))
def test_dense_path_mirrors_the_bulk_rule(name):
    """The copy path the wrapper's mirror predicts for an X view at f32
    and at bf16: a DiSCO-S column view at an offset not a multiple of 8
    takes the direct path at bf16 (the kernels report the path they took;
    ``tests/test_torch_cuda.py`` holds them to it)."""
    rows, cols, (lo, hi), want32, want16 = BF16_PATHS[name]
    base = torch.zeros((rows, cols))
    for dtype, want in ((torch.float32, want32), (torch.bfloat16, want16)):
        X = base.to(dtype)[:, lo:hi]
        assert glm_hvp.dense_path(X) == want


@pytest.mark.parametrize("shard", list(SHARDS))
@pytest.mark.parametrize("with_c", [False, True])
def test_dense_bf16_ops_match_jax_at_shard_shapes(shard, with_c):
    """The bf16 ops on the shard views of a bf16 X (64, 2048) against the
    JAX ops in interpret mode on bf16 copies: relative L2 <= 1e-5 (the
    products are exact in f32)."""
    import ml_dtypes
    X, _, _ = make_glm_data(64, 2048, seed=3)
    rows, cols = SHARDS[shard]
    rng = np.random.default_rng(4)
    A = np.ascontiguousarray(X[rows, cols]).astype(ml_dtypes.bfloat16)
    d, n = A.shape
    u = rng.standard_normal(d).astype(np.float32)
    z = rng.standard_normal(n).astype(np.float32)
    c = rng.uniform(0.0, 0.25, n).astype(np.float32)
    view = torch.from_numpy(X).to(torch.bfloat16)[rows, cols]
    T = torch.from_numpy
    rel = lambda a, b: (np.linalg.norm(a - np.asarray(b))
                        / np.linalg.norm(np.asarray(b)))
    assert rel(tops.xt_u(view, T(u)).numpy(), jops.xt_u(A, u)) <= 1e-5
    got = tops.x_cz_local(view, T(c) if with_c else None, T(z))
    want = jops.x_cz_local(A, c if with_c else np.ones_like(c), z)
    assert rel(got.numpy(), want) <= 1e-5
