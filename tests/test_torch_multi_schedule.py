"""The split of the dense multi-vector kernels (K8 ``xt_multi``, K9
``x_cz_multi``) on the CPU.

``repro_torch.kernels.glm_hvp.multi_split`` is plain Python over ints, and
``csrc/dense_multi.cuh`` computes the same bounds on the card over its
pieces (``multi_tile``: rows by columns by kernel and tile dtype). Its
contract is checked here, for both kernels and both tile dtypes, over
ragged shapes and CTA counts: every element of X lies in exactly one
piece of exactly one CTA, CTA shares differ by at most one piece, and a
cut unit is summed from its CTAs' partials in CTA order. A walk of the
split written after the kernel (whole units to the output, cut ones to
scratch slots of a unit's length times s, then the fix-up) reproduces
X^T U and X (c .* Z) exactly on integer data at every s in 1-8. The
header's constants are parsed and held to the wrapper's mirror, and the
ring the mirror sizes fits one CTA's shared memory. The ops at the
solver's shard shapes run their plain versions here, which must equal
the JAX ops on the same numpy inputs. The kernels themselves run only on
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
from repro_torch.kernels.glm_hvp import multi_split, multi_tile

KERNELS = ["xt_multi", "x_cz_multi"]
DTYPES = [torch.float32, torch.bfloat16]
SHAPES = [(1, 1), (5, 2048), (31, 511), (33, 1025), (97, 600),
          (130, 3000), (200, 5000)]
CTAS = [1, 2, 7, 132, 1000]
COLS = list(range(1, build.MAX_COLS + 1))
HEADER = build.CSRC / "dense_multi.cuh"


def _dt(dtype):
    return str(dtype).split(".")[-1]


def _ranges(split):
    return [(split.bound(k), split.bound(k + 1)) for k in range(split.ctas)]


def _piece_box(split, t, d, n):
    """(rows, cols) slices of X that piece t covers."""
    g, k = split.piece(t)
    r0, c0 = g * split.tile_rows, k * split.tile_cols
    return (slice(r0, min(d, r0 + split.tile_rows)),
            slice(c0, min(n, c0 + split.tile_cols)))


def _header_int(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         HEADER.read_text())[1])


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("dtype", DTYPES, ids=_dt)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("ctas", CTAS)
def test_every_element_in_one_piece_of_one_cta(kernel, dtype, shape, ctas):
    d, n = shape
    split = multi_split(kernel, d, n, ctas, dtype)
    rows, cols = multi_tile(kernel, dtype)
    assert (split.tile_rows, split.tile_cols) == (rows, cols)
    assert split.groups == -(-d // rows) and split.chunks == -(-n // cols)
    assert split.by_chunk == (kernel == "xt_multi")
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
@pytest.mark.parametrize("dtype", DTYPES, ids=_dt)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("ctas", CTAS)
def test_fixup_sums_a_cut_unit_in_cta_order(kernel, dtype, shape, ctas):
    """A unit's pieces are a contiguous run (chunk-major for xt_multi,
    row-group-major for x_cz_multi); a cut unit lists every nonempty CTA
    that holds one of them, ascending, each CTA in slot 0 for the unit
    that holds its first piece and slot 1 for the other, at most one of
    each: the order csrc/dense_multi.cuh's fixup_kernel adds them in."""
    split = multi_split(kernel, *shape, ctas, dtype)
    unit_of = ((lambda t: split.piece(t)[1]) if split.by_chunk
               else (lambda t: split.piece(t)[0]))
    slots = {}
    for unit in range(split.units):
        base = unit * split.per_unit
        pieces = range(base, base + split.per_unit)
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


def _walk(split, X, U=None, cz=None):
    """The kernel's walk on the host: each CTA's sums over its pieces,
    unit by unit, whole units to the output and cut ones to scratch slots
    of unit_len x s floats, then the fix-up in CTA order."""
    d, n = X.shape
    s = (U if split.by_chunk else cz).shape[1]
    length = n if split.by_chunk else d
    out = np.full((length, s), np.nan)
    scratch = np.full((split.ctas, 2, split.unit_len, s), np.nan)
    for k in range(split.ctas):
        b0, b1 = split.bound(k), split.bound(k + 1)
        acc = np.zeros((split.unit_len, s))
        for t in range(b0, b1):
            rows, cols = _piece_box(split, t, d, n)
            tile = X[rows, cols]
            if split.by_chunk:
                acc[:tile.shape[1]] += tile.T @ U[rows]
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


@pytest.mark.parametrize("dtype", DTYPES, ids=_dt)
@pytest.mark.parametrize("s", COLS)
@settings(max_examples=12, deadline=None)
@given(d=st.integers(1, 220), n=st.integers(1, 2600),
       ctas=st.integers(1, 40), seed=st.integers(0, 2**16))
def test_walk_of_the_split_gives_the_products_exactly(dtype, s, d, n, ctas,
                                                      seed):
    """Integer data: every sum is exact, so the walk must give X^T U and
    X (c .* Z) to the last bit at s columns; an element missed, counted
    twice or a partial in the wrong slot would show."""
    rng = np.random.default_rng(seed)
    X = rng.integers(-8, 9, (d, n)).astype(np.float64)
    U = rng.integers(-4, 5, (d, s)).astype(np.float64)
    cz = rng.integers(-4, 5, (n, s)).astype(np.float64)
    Z = _walk(multi_split("xt_multi", d, n, ctas, dtype), X, U=U)
    Y = _walk(multi_split("x_cz_multi", d, n, ctas, dtype), X, cz=cz)
    np.testing.assert_array_equal(Z, X.T @ U)
    np.testing.assert_array_equal(Y, X @ cz)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("dtype", DTYPES, ids=_dt)
def test_split_at_the_dense_slice_shapes_has_no_wave_tail(kernel, dtype):
    """At the full width and both m = 4 shard shapes every one of the
    card's 132 CTAs has work, and shares differ by at most one piece."""
    for d, n in ((4096, 262_144), (4096, 65_536), (1024, 262_144)):
        split = multi_split(kernel, d, n, 132, dtype)
        sizes = [hi - lo for lo, hi in _ranges(split)]
        assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1


def test_split_is_cached_and_checked():
    a = multi_split("xt_multi", 4096, 262_144, 132)
    assert multi_split("xt_multi", 4096, 262_144, 132) is a
    assert (a.units, a.per_unit, a.unit_len) == (256, 256, 1024)
    b = multi_split("x_cz_multi", 4096, 262_144, 132, torch.bfloat16)
    assert (b.units, b.per_unit, b.unit_len) == (43, 512, 96)
    for bad in (("xt_u", 8, 8, 1), ("xt_multi", 0, 8, 1),
                ("x_cz_multi", 8, 8, 0)):
        with pytest.raises(ValueError):
            multi_split(*bad)
    with pytest.raises(TypeError):
        multi_split("xt_multi", 8, 8, 1, torch.float16)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("dtype", DTYPES, ids=_dt)
def test_header_and_wrapper_agree_on_the_piece(kernel, dtype):
    """The wrapper's pieces, ring constants and copy paths are the
    header's, parsed from csrc/dense_multi.cuh; the four entry points
    include it; the bf16 tiles take the tensor cores."""
    tag = {"xt_multi": "Xt", "x_cz_multi": "Cz"}[kernel]
    suffix = {torch.float32: "F32", torch.bfloat16: "Bf16"}[dtype]
    rows = _header_int(f"k{tag}Rows{suffix}")
    row_bytes = _header_int(f"k{tag}RowBytes{suffix}")
    assert multi_tile(kernel, dtype) == (rows, row_bytes // dtype.itemsize)
    assert glm_hvp.MULTI_PIECES[kernel][glm_hvp.TILE_DTYPES.index(dtype)] \
        == (rows, row_bytes)
    assert (_header_int("kThreads"), _header_int("kMaxStages"),
            _header_int("kBarrierBytes"), _header_int("kRowPad")) == (
        glm_hvp.MULTI_THREADS, glm_hvp.MULTI_MAX_STAGES,
        glm_hvp.MULTI_BARRIER_BYTES, glm_hvp.MULTI_ROW_PAD)
    assert "constexpr bool kMmaAtBf16 = true;" in HEADER.read_text()
    name = kernel + ("_bf16" if dtype == torch.bfloat16 else "")
    assert '#include "dense_multi.cuh"' in (
        build.CSRC / f"{name}.cu").read_text()
    assert name in glm_hvp.last_path
    assert getattr(build, name.upper()).argtypes == getattr(
        build, kernel.upper()).argtypes


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("dtype", DTYPES, ids=_dt)
@pytest.mark.parametrize("s", COLS)
def test_ring_fits_shared_memory_at_every_s(kernel, dtype, s):
    """The shared memory the mirror of ``run`` lays out (barriers, two
    buffers of kMaxCols vector rows, the ring) fits one CTA's 227 KB with
    at least two stages, whatever s (the vector buffers hold kMaxCols
    rows); the direct path's one stage fits too. x_cz_multi's c and Z of a
    piece are at most a quarter of its X at s."""
    rows, cols = multi_tile(kernel, dtype)
    size = dtype.itemsize
    stages = glm_hvp.multi_stages(kernel, dtype)
    assert 2 <= stages <= glm_hvp.MULTI_MAX_STAGES
    length = rows if kernel == "xt_multi" else cols
    vec = -(-build.MAX_COLS * (length + 16 // size) * size // 128) * 128
    stage = rows * (cols * size + glm_hvp.MULTI_ROW_PAD)
    ring_off = glm_hvp.MULTI_BARRIER_BYTES + 2 * vec
    assert ring_off + stages * stage <= glm_hvp.SMEM_LIMIT
    assert ring_off + (stages + 1) * stage > glm_hvp.SMEM_LIMIT or \
        stages == glm_hvp.MULTI_MAX_STAGES
    assert s <= build.MAX_COLS
    if kernel == "x_cz_multi":
        assert 4 * cols * (s + 1) <= rows * cols * size / 4
    # the thread mappings of csrc/dense_multi.cuh's static_asserts: f32
    # xt_multi 4 columns a thread, bf16 xt_multi whole 16 x 16 tiles a
    # warp; x_cz_multi a row slab a warp, whole quads a lane, and at bf16
    # a 16-row tile a warp
    threads, warps = glm_hvp.MULTI_THREADS, glm_hvp.MULTI_THREADS // 32
    if kernel == "xt_multi" and dtype == torch.float32:
        assert cols % (4 * threads) == 0
    elif kernel == "xt_multi":
        assert rows % 16 == 0 and cols % (16 * warps) == 0
    else:
        assert rows % warps == 0 and cols % 128 == 0
        assert dtype == torch.float32 or (rows % 16 == 0
                                          and rows <= 16 * warps)


MULTI_PATHS = {
    # name: (rows, columns allocated, view columns [lo, hi), path at f32,
    # path at bf16): rows of whole 16-byte units, 4 f32 or 8 bf16 elements
    "full": (64, 1024, (0, 1024), "bulk", "bulk"),
    "n_4": (64, 1028, (0, 1028), "bulk", "direct"),
    "view_at_1": (64, 2048, (1, 1025), "direct", "direct"),
    "view_at_4": (64, 2048, (4, 1028), "bulk", "direct"),
    "view_at_8": (64, 2048, (8, 1032), "bulk", "bulk"),
    "ld_1028": (64, 1028, (0, 1024), "bulk", "direct"),
    "ld_1032": (64, 1032, (0, 1024), "bulk", "bulk"),
    "S_m4_view": (16, 4 * 1024, (1024, 2048), "bulk", "bulk"),
}


@pytest.mark.parametrize("name", list(MULTI_PATHS))
def test_multi_path_mirrors_the_bulk_rule(name):
    """The copy path ``dense_path(X)`` predicts for an X view at f32 and
    at bf16, which K8 and K9 take (they report the path they took;
    ``tests/test_torch_cuda.py`` holds them to it): X's rows alone decide
    it, since the vector blocks are staged by ordinary loads, so a
    strided or unaligned U, Z or c changes nothing."""
    rows, cols, (lo, hi), want32, want16 = MULTI_PATHS[name]
    base = torch.zeros((rows, cols))
    for dtype, want in ((torch.float32, want32), (torch.bfloat16, want16)):
        X = base.to(dtype)[:, lo:hi]
        assert glm_hvp.dense_path(X) == want


SHARDS = {"full": (slice(None), slice(None)),
          "S_m4_view": (slice(None), slice(0, 512)),
          "F_m4_rows": (slice(0, 16), slice(None))}


@pytest.mark.parametrize("shard", list(SHARDS))
@pytest.mark.parametrize("s", [1, 5, 8, 13])
@pytest.mark.parametrize("with_c", [False, True])
def test_multi_ops_match_jax_at_shard_shapes(shard, s, with_c):
    """xt_multi and x_cz_multi on the dense slice's shard shapes at a
    reduced size (X (64, 2048)), passed as views, U a strided column group
    as DiSCO-F passes it, against the JAX ops on copies (rtol 1e-5, atol
    1e-5: f32 sums in another order)."""
    X, _, _ = make_glm_data(64, 2048, seed=5)
    rows, cols = SHARDS[shard]
    rng = np.random.default_rng(s)
    A = np.ascontiguousarray(X[rows, cols])
    d, n = A.shape
    U = rng.standard_normal((d, s + 1)).astype(np.float32)
    Z = rng.standard_normal((n, s)).astype(np.float32)
    c = rng.uniform(0.0, 0.25, n).astype(np.float32)
    view = torch.from_numpy(X)[rows, cols]
    T = torch.from_numpy
    np.testing.assert_allclose(
        tops.xt_multi(view, T(U)[:, :s]).numpy(),
        np.asarray(jops.xt_multi(A, np.ascontiguousarray(U[:, :s]))),
        rtol=1e-5, atol=1e-5)
    got = tops.x_cz_multi(view, T(c) if with_c else None, T(Z))
    want = jops.x_cz_multi(A, c if with_c else np.ones_like(c), Z)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
