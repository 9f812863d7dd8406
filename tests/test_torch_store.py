"""The port's checksummed shard store (``repro_torch.data.store``) and its
data helpers against the JAX package's.

Counterparts of the non-streamed cases of ``tests/test_store.py`` (store
round trips and header, memmapped random access, version and argument
checks, the libsvm builders, appends, the property round trip, chunk
partitions, ELL widths and row padding, v2 checksums against real bit
flips and torn files, v1 reads), run on the port's package; plus
cross-package cases: a store written by either package has the same
bytes, file for file (chunk arrays, labels, ``meta.json`` with its
CRC32s), and opens and verifies in the other. Every comparison is exact:
the store moves bytes, it computes nothing.
"""
import json
import os

import numpy as np
import pytest

from repro.data import partition as jpartition
from repro.data import sparse as jsparse
from repro.data.store import ShardStore as JShardStore
from repro.robust import faults as jfaults
from repro_torch.data.libsvm import save_libsvm
from repro_torch.data.partition import chunk_partition, lpt_partition
from repro_torch.data.sparse import (CSRMatrix, ell_from_csr,
                                     ell_tile_widths, make_sparse_glm_data,
                                     pad_csr_rows)
from repro_torch.data.store import ShardStore
from repro_torch import obs
from repro_torch.robust.faults import (ChunkCorruptionError,
                                       corrupt_chunk_file,
                                       truncate_chunk_file)


def _random_csr(d, n, density, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    Xd = np.where(rng.random((d, n)) < density,
                  rng.standard_normal((d, n)), 0.0).astype(dtype)
    return CSRMatrix.from_dense(Xd, dtype=dtype), Xd


def _to_ref(X: CSRMatrix):
    return jsparse.CSRMatrix(X.indptr, X.indices, X.data, X.shape)


def _tree(path) -> dict:
    """{relative path: bytes} of every file under ``path``."""
    out = {}
    for dirpath, _, files in os.walk(path):
        for f in files:
            full = os.path.join(dirpath, f)
            with open(full, "rb") as fh:
                out[os.path.relpath(full, path)] = fh.read()
    return out


# ---------------------------------------------------------------------------
# store basics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axis", ["features", "samples"])
def test_store_roundtrip_and_header(tmp_path, axis):
    X, Xd = _random_csr(23, 17, 0.3, seed=0)
    y = np.arange(17, dtype=np.float32)
    store = ShardStore.from_csr(X, y, str(tmp_path / "s"), axis=axis,
                                chunk_size=5)
    n_items = 23 if axis == "features" else 17
    assert store.n_chunks == -(-n_items // 5)
    assert store.n_items == n_items
    assert store.nnz == X.nnz
    assert int(store.chunk_nnz.sum()) == X.nnz
    last = store.chunks[-1]
    assert last.stop == n_items and last.stop - last.start <= 5
    assert store.data_bytes() == sum(
        (c.stop - c.start + 1) * 8 + c.nnz * 8 for c in store.chunks)
    X2, y2 = store.to_csr()
    np.testing.assert_array_equal(X2.todense(), Xd)
    np.testing.assert_array_equal(y2, y)


def test_store_chunks_are_memmapped_and_random_access(tmp_path):
    X, Xd = _random_csr(16, 9, 0.4, seed=1)
    y = np.zeros(9, np.float32)
    store = ShardStore.from_csr(X, y, str(tmp_path / "s"),
                                axis="features", chunk_size=4)
    slab = store.chunk_csr(1)
    assert isinstance(slab.data, np.memmap)
    assert not isinstance(store.chunk_csr(1, mmap=False).data, np.memmap)
    for i in np.random.default_rng(0).permutation(store.n_chunks):
        info = store.chunks[i]
        np.testing.assert_array_equal(store.chunk_csr(int(i)).todense(),
                                      Xd[info.start:info.stop])


def test_store_version_check(tmp_path):
    X, _ = _random_csr(4, 4, 0.5, seed=2)
    store = ShardStore.from_csr(X, np.zeros(4, np.float32),
                                str(tmp_path / "s"), chunk_size=2)
    meta_path = os.path.join(store.path, "meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    meta["version"] = 999
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="version"):
        ShardStore(store.path)


def test_store_rejects_bad_args(tmp_path):
    X, _ = _random_csr(4, 4, 0.5, seed=3)
    y = np.zeros(4, np.float32)
    with pytest.raises(ValueError, match="axis"):
        ShardStore.from_csr(X, y, str(tmp_path / "a"), axis="rows")
    with pytest.raises(ValueError, match="chunk_size"):
        ShardStore.from_csr(X, y, str(tmp_path / "b"), chunk_size=0)
    with pytest.raises(ValueError, match="labels"):
        ShardStore.from_csr(X, np.zeros(3, np.float32),
                            str(tmp_path / "c"))
    with pytest.raises(ValueError, match="axis"):
        ShardStore.from_libsvm("none.svm", str(tmp_path / "d"), axis="rows")
    ShardStore.from_csr(X, y, str(tmp_path / "e"))
    with pytest.raises(FileExistsError):
        ShardStore.from_csr(X, y, str(tmp_path / "e"))


def test_store_from_libsvm_streams_sample_chunks(tmp_path):
    rng = np.random.default_rng(4)
    Xd = np.where(rng.random((7, 13)) < 0.4,
                  rng.standard_normal((7, 13)), 0.0).astype(np.float32)
    y = np.sign(rng.standard_normal(13)).astype(np.float32)
    y[y == 0] = 1.0
    p = str(tmp_path / "f.svm")
    save_libsvm(p, Xd, y)
    store = ShardStore.from_libsvm(p, str(tmp_path / "s"), axis="samples",
                                   chunk_size=4, n_features=7)
    assert store.shape == (7, 13) and store.n_chunks == 4
    X2, y2 = store.to_csr()
    np.testing.assert_allclose(X2.todense(), Xd, atol=1e-6, rtol=1e-5)
    np.testing.assert_array_equal(y2, y)
    # an explicit small n_features truncates through the shared clamp
    store_t = ShardStore.from_libsvm(p, str(tmp_path / "t"),
                                     axis="samples", chunk_size=4,
                                     n_features=3)
    Xt, _ = store_t.to_csr()
    np.testing.assert_allclose(Xt.todense(), Xd[:3], atol=1e-6, rtol=1e-5)


def test_store_from_libsvm_features_axis_delegates(tmp_path):
    rng = np.random.default_rng(5)
    Xd = np.where(rng.random((9, 6)) < 0.5,
                  rng.standard_normal((9, 6)), 0.0).astype(np.float32)
    y = np.ones(6, np.float32)
    p = str(tmp_path / "f.svm")
    save_libsvm(p, Xd, y)
    store = ShardStore.from_libsvm(p, str(tmp_path / "s"),
                                   axis="features", chunk_size=3,
                                   n_features=9)
    assert store.axis == "features"
    X2, _ = store.to_csr()
    np.testing.assert_allclose(X2.todense(), Xd, atol=1e-6, rtol=1e-5)


# ---------------------------------------------------------------------------
# appends
# ---------------------------------------------------------------------------

APPENDS = [(10, 7, 4), (8, 5, 4), (3, 1, 8), (6, 0, 4)]


def _append_case(n0, n1):
    d = 9
    rng = np.random.default_rng(n0 * 17 + n1)
    Xd = np.where(rng.random((d, n0 + n1)) < 0.4,
                  rng.standard_normal((d, n0 + n1)), 0.0
                  ).astype(np.float32)
    y = rng.standard_normal(n0 + n1).astype(np.float32)
    return d, Xd, y


@pytest.mark.parametrize("n0,n1,chunk", APPENDS)
def test_store_append_chunks_roundtrip(tmp_path, n0, n1, chunk):
    """append_chunks equals building the store from the joined data: the
    same header, chunks and labels, also after a fresh open."""
    d, Xd, y = _append_case(n0, n1)
    store = ShardStore.from_csr(CSRMatrix.from_dense(Xd[:, :n0]), y[:n0],
                                str(tmp_path / "a"), axis="samples",
                                chunk_size=chunk)
    store.append_chunks(CSRMatrix.from_dense(Xd[:, n0:]), y[n0:])
    oracle = ShardStore.from_csr(CSRMatrix.from_dense(Xd), y,
                                 str(tmp_path / "b"), axis="samples",
                                 chunk_size=chunk)
    assert store.shape == oracle.shape == (d, n0 + n1)
    assert [(c.start, c.stop, c.nnz, c.crc) for c in store.chunks] \
        == [(c.start, c.stop, c.nnz, c.crc) for c in oracle.chunks]
    X2, y2 = store.to_csr()
    np.testing.assert_array_equal(X2.todense(), Xd)
    np.testing.assert_array_equal(y2, y)
    reopened = ShardStore(store.path)
    assert reopened.shape == (d, n0 + n1)
    assert reopened.nnz == oracle.nnz
    X3, y3 = reopened.to_csr()
    np.testing.assert_array_equal(X3.todense(), Xd)
    np.testing.assert_array_equal(y3, y)


def test_store_append_chunks_rejects_bad_input(tmp_path):
    X, _ = _random_csr(6, 8, 0.4, seed=8)
    y = np.zeros(8, np.float32)
    samples = ShardStore.from_csr(X, y, str(tmp_path / "s"),
                                  axis="samples", chunk_size=4)
    feats = ShardStore.from_csr(X, y, str(tmp_path / "f"),
                                axis="features", chunk_size=4)
    Xn, _ = _random_csr(6, 3, 0.4, seed=9)
    with pytest.raises(ValueError, match="samples"):
        feats.append_chunks(Xn, np.zeros(3, np.float32))
    bad_d, _ = _random_csr(5, 3, 0.4, seed=10)
    with pytest.raises(ValueError, match="features"):
        samples.append_chunks(bad_d, np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="labels"):
        samples.append_chunks(Xn, np.zeros(2, np.float32))


def test_store_append_chunks_casts_to_store_dtype(tmp_path):
    rng = np.random.default_rng(11)
    Xd = np.where(rng.random((5, 10)) < 0.5,
                  rng.standard_normal((5, 10)), 0.0)
    store = ShardStore.from_csr(
        CSRMatrix.from_dense(Xd[:, :6], dtype=np.float32),
        np.zeros(6, np.float32), str(tmp_path / "s"), axis="samples",
        chunk_size=4)
    store.append_chunks(CSRMatrix.from_dense(Xd[:, 6:], dtype=np.float64),
                        np.zeros(4, np.float64))
    assert store.dtype == np.float32
    for c in store.chunks:
        assert store.chunk_csr(c.index).dtype == np.float32
    X2, y2 = store.to_csr()
    assert X2.dtype == np.float32 and y2.dtype == np.float32
    np.testing.assert_allclose(X2.todense(), Xd.astype(np.float32),
                               rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# round trips over the edge cases
# ---------------------------------------------------------------------------

def test_store_property_roundtrip(tmp_path):
    """CSR -> store -> CSR is exact for both axes across chunk sizes that
    give empty chunks, single-index chunks and ragged tails; the dtype is
    kept; chunks read in any order reproduce the source."""
    from hypothesis import given, settings, strategies as st

    counter = [0]

    @settings(max_examples=30, deadline=None)
    @given(d=st.integers(1, 14), n=st.integers(1, 14),
           density=st.floats(0.0, 0.9), chunk=st.integers(1, 16),
           axis=st.sampled_from(["features", "samples"]),
           dtype=st.sampled_from([np.float32, np.float64]),
           seed=st.integers(0, 2 ** 16))
    def roundtrip(d, n, density, chunk, axis, dtype, seed):
        rng = np.random.default_rng(seed)
        Xd = np.where(rng.random((d, n)) < density,
                      rng.standard_normal((d, n)), 0.0).astype(dtype)
        X = CSRMatrix.from_dense(Xd, dtype=dtype)
        y = rng.standard_normal(n).astype(dtype)
        counter[0] += 1
        store = ShardStore.from_csr(X, y, str(tmp_path / f"s{counter[0]}"),
                                    axis=axis, chunk_size=chunk)
        X2, y2 = store.to_csr()
        assert X2.dtype == dtype and store.dtype == dtype
        assert X2.shape == (d, n)
        np.testing.assert_array_equal(X2.todense(), Xd)
        np.testing.assert_array_equal(y2, y)
        src = X if axis == "features" else X.transpose()
        for i in rng.permutation(store.n_chunks):
            info = store.chunks[int(i)]
            np.testing.assert_array_equal(
                store.chunk_csr(int(i)).todense(),
                src.take_rows(np.arange(info.start, info.stop)).todense())

    roundtrip()


EDGES = [(6, 5, 0.0, 2, np.float32),    # all-empty chunks
         (9, 4, 0.5, 1, np.float64),    # single-index chunks, f64 kept
         (1, 1, 1.0, 3, np.float32),    # chunk larger than the axis
         (13, 7, 0.3, 5, np.float32)]   # ragged tail


@pytest.mark.parametrize("axis", ["features", "samples"])
@pytest.mark.parametrize("d,n,density,chunk,dtype", EDGES)
def test_store_roundtrip_edge_cases(tmp_path, axis, d, n, density, chunk,
                                    dtype):
    rng = np.random.default_rng(d * 31 + n)
    Xd = np.where(rng.random((d, n)) < density,
                  rng.standard_normal((d, n)), 0.0).astype(dtype)
    X = CSRMatrix.from_dense(Xd, dtype=dtype)
    y = rng.standard_normal(n).astype(dtype)
    store = ShardStore.from_csr(X, y, str(tmp_path / "s"), axis=axis,
                                chunk_size=chunk)
    X2, y2 = store.to_csr()
    assert X2.dtype == dtype
    np.testing.assert_array_equal(X2.todense(), Xd)
    np.testing.assert_array_equal(y2, y)


# ---------------------------------------------------------------------------
# chunk partition, ELL widths, row padding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", ["lpt", "width"])
@pytest.mark.parametrize("m", [2, 4])
def test_chunk_partition_matches_index_level(strategy, m):
    """chunk_partition from header stats equals lpt_partition at block =
    chunk from per-index counts, and the reference's chunk_partition."""
    X, _, _ = make_sparse_glm_data(d=96, n=64, density=0.1, alpha=1.2,
                                   seed=0)
    counts = X.nnz_per_row()
    chunk = 8
    chunk_nnz = np.add.reduceat(counts, np.arange(0, len(counts), chunk))
    pc = chunk_partition(chunk_nnz, chunk, len(counts), m, strategy)
    if strategy == "lpt":
        pi = lpt_partition(counts, m, block=chunk, pad_multiple=4)
        np.testing.assert_array_equal(pc.perm, pi.perm)
        np.testing.assert_array_equal(pc.shard_nnz, pi.shard_nnz)
    assert pc.width % chunk == 0
    assert sorted(pc.perm.tolist()) == list(range(len(pc.perm)))
    assert pc.shard_nnz.sum() == counts.sum()
    ref = jpartition.chunk_partition(chunk_nnz, chunk, len(counts), m,
                                     strategy)
    for f in ("perm", "inv", "shard_nnz"):
        np.testing.assert_array_equal(getattr(pc, f), getattr(ref, f))
    assert (pc.n_items, pc.m, pc.strategy) == (ref.n_items, ref.m,
                                               ref.strategy)


@pytest.mark.parametrize("m", [2, 3, 4])
def test_chunk_partition_cost_order_matches_reference(m):
    """With measured per-chunk costs: the reference's assignment and its
    descending-cost order within each shard, nnz bookkeeping intact."""
    rng = np.random.default_rng(m)
    chunk_nnz = rng.integers(0, 500, 11)
    cost = rng.integers(1, 10 ** 6, 11)
    pc = chunk_partition(chunk_nnz, 4, 43, m, chunk_cost=cost)
    ref = jpartition.chunk_partition(chunk_nnz, 4, 43, m, chunk_cost=cost)
    np.testing.assert_array_equal(pc.perm, ref.perm)
    np.testing.assert_array_equal(pc.shard_nnz, ref.shard_nnz)
    assert pc.shard_nnz.sum() == chunk_nnz.sum()
    with pytest.raises(ValueError, match="chunk_cost"):
        chunk_partition(chunk_nnz, 4, 43, m, chunk_cost=cost[:-1])


def test_chunk_partition_rejects_unknown_strategy():
    with pytest.raises(ValueError):
        chunk_partition(np.array([1, 2]), 4, 8, 2, "magic")


@pytest.mark.parametrize("d,n,block", [(24, 18, 8), (33, 70, 16),
                                       (5, 300, 128)])
def test_ell_tile_widths_match_natural(d, n, block):
    X, _ = _random_csr(d, n, 0.25, seed=6)
    wf, wt = ell_tile_widths(X, block, block)
    assert wf == ell_from_csr(X, block, block).width
    assert wt == ell_from_csr(X.transpose(), block, block).width
    assert (wf, wt) == jsparse.ell_tile_widths(_to_ref(X), block, block)
    empty = CSRMatrix(indptr=np.zeros(9, np.int64),
                      indices=np.zeros(0, np.int32),
                      data=np.zeros(0, np.float32), shape=(8, 8))
    assert ell_tile_widths(empty, 4, 4) == (1, 1)


def test_pad_csr_rows():
    X, Xd = _random_csr(5, 7, 0.5, seed=7)
    Xp = pad_csr_rows(X, 9)
    assert Xp.shape == (9, 7)
    np.testing.assert_array_equal(Xp.todense()[:5], Xd)
    assert Xp.todense()[5:].sum() == 0
    ref = jsparse.pad_csr_rows(_to_ref(X), 9)
    np.testing.assert_array_equal(Xp.indptr, ref.indptr)
    assert pad_csr_rows(X, 5) is X
    with pytest.raises(ValueError):
        pad_csr_rows(X, 3)


# ---------------------------------------------------------------------------
# v2 checksums: corruption detected at the read site, v1 still readable
# ---------------------------------------------------------------------------

def _checksum_store(tmp_path, name="s", d=12, n=10, chunk=4):
    X, Xd = _random_csr(d, n, 0.5, seed=20)
    y = np.arange(n, dtype=np.float32)
    store = ShardStore.from_csr(X, y, str(tmp_path / name),
                                axis="features", chunk_size=chunk)
    return store, Xd, y


@pytest.mark.parametrize("field", ["indptr", "indices", "data"])
def test_store_checksum_detects_bit_flip(tmp_path, field):
    store, _, _ = _checksum_store(tmp_path)
    cid = 1
    corrupt_chunk_file(store, cid, field=field, seed=3)
    with pytest.raises(ChunkCorruptionError,
                       match=f"chunk {cid} field '{field}'"):
        store.chunk_csr(cid)
    store.chunk_csr(0)                       # other chunks verify clean
    store.chunk_csr(cid, verify=False)       # the opt-out reads the bytes
    ShardStore(store.path, verify=False).chunk_csr(cid)


def test_store_checksum_detects_truncation(tmp_path):
    store, _, _ = _checksum_store(tmp_path)
    truncate_chunk_file(store, 2, field="data", drop_bytes=3)
    with pytest.raises(ChunkCorruptionError, match="chunk 2"):
        store.chunk_csr(2, mmap=False)


def test_store_labels_checksum(tmp_path):
    store, _, y = _checksum_store(tmp_path)
    p = os.path.join(store.path, "labels.npy")
    size = os.path.getsize(p)
    with open(p, "r+b") as f:
        f.seek(size - 2)
        b = f.read(1)
        f.seek(size - 2)
        f.write(bytes([b[0] ^ 0x01]))
    with pytest.raises(ChunkCorruptionError, match="labels"):
        store.labels()
    np.testing.assert_array_equal(store.labels(verify=False).shape, y.shape)


def test_store_checksum_property(tmp_path):
    """Any single bit flip in any chunk field, and any truncation, is
    detected with the damaged chunk named."""
    from hypothesis import given, settings, strategies as st

    counter = [0]

    @settings(max_examples=25, deadline=None)
    @given(cid=st.integers(0, 2),
           field=st.sampled_from(["indptr", "indices", "data"]),
           damage=st.sampled_from(["flip", "truncate"]),
           seed=st.integers(0, 2 ** 16))
    def detects(cid, field, damage, seed):
        counter[0] += 1
        store, _, _ = _checksum_store(tmp_path, name=f"h{counter[0]}")
        if damage == "flip":
            corrupt_chunk_file(store, cid, field=field, seed=seed)
        else:
            truncate_chunk_file(store, cid, field=field,
                                drop_bytes=1 + seed % 16)
        with pytest.raises(ChunkCorruptionError, match=f"chunk {cid}"):
            store.chunk_csr(cid, mmap=False)

    detects()


def _to_v1(path):
    meta_path = os.path.join(path, "meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    meta["version"] = 1
    meta.pop("labels_crc", None)
    for c in meta["chunks"]:
        c.pop("crc", None)
    with open(meta_path, "w") as f:
        json.dump(meta, f)


def test_store_v1_backward_compat(tmp_path):
    """A v1 store (no checksums) opens and reads: verification is
    skipped, the data round-trips exactly."""
    store, Xd, y = _checksum_store(tmp_path)
    _to_v1(store.path)
    v1 = ShardStore(store.path)
    assert v1.version == 1
    assert v1.labels_crc is None
    assert all(c.crc is None for c in v1.chunks)
    X2, y2 = v1.to_csr()
    np.testing.assert_array_equal(X2.todense(), Xd)
    np.testing.assert_array_equal(y2, y)


def test_chunk_reads_are_traced(tmp_path):
    """Each chunk read is one ``store.chunk_read`` span naming the chunk
    and whether it was verified."""
    store, _, _ = _checksum_store(tmp_path)
    tracer = obs.enable(reset=True)
    try:
        store.to_csr()
        store.chunk_csr(1, verify=False)
    finally:
        obs.disable()
    reads = [e.args for e in tracer.events if e.kind == "store.chunk_read"]
    assert reads == [{"cid": i, "verify": True}
                     for i in range(store.n_chunks)] + \
        [{"cid": 1, "verify": False}]


# ---------------------------------------------------------------------------
# the two packages' stores are the same bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axis", ["features", "samples"])
@pytest.mark.parametrize("d,n,density,chunk,dtype", EDGES + [
    (40, 33, 0.15, 8, np.float32)])
def test_store_bytes_match_reference(tmp_path, axis, d, n, density, chunk,
                                     dtype):
    """``from_csr`` of the same matrix writes the same files with the same
    bytes in both packages (chunk arrays, labels, meta.json and its
    CRC32s)."""
    rng = np.random.default_rng(d * 7 + n)
    Xd = np.where(rng.random((d, n)) < density,
                  rng.standard_normal((d, n)), 0.0).astype(dtype)
    X = CSRMatrix.from_dense(Xd, dtype=dtype)
    y = rng.standard_normal(n).astype(dtype)
    ShardStore.from_csr(X, y, str(tmp_path / "port"), axis=axis,
                        chunk_size=chunk)
    JShardStore.from_csr(_to_ref(X), y, str(tmp_path / "ref"), axis=axis,
                         chunk_size=chunk)
    port, ref = _tree(tmp_path / "port"), _tree(tmp_path / "ref")
    assert sorted(port) == sorted(ref)
    for name in ref:
        assert port[name] == ref[name], name


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("axis", ["features", "samples"])
@pytest.mark.parametrize("version", [1, 2])
def test_store_opens_in_the_other_package(tmp_path, writer, axis, version):
    """A store written by either package opens in the other with the same
    header and checksums, and verifies and reads back the same arrays;
    damage one package's checker catches, the other's catches too."""
    X, Xd = _random_csr(30, 26, 0.3, seed=12)
    y = np.linspace(-1, 1, 26).astype(np.float32)
    path = str(tmp_path / "s")
    if writer == "port":
        ShardStore.from_csr(X, y, path, axis=axis, chunk_size=7)
    else:
        JShardStore.from_csr(_to_ref(X), y, path, axis=axis, chunk_size=7)
    if version == 1:
        _to_v1(path)
    port, ref = ShardStore(path), JShardStore(path)
    assert (port.version, port.axis, port.shape, port.chunk_size,
            port.labels_crc) == (ref.version, ref.axis, ref.shape,
                                 ref.chunk_size, ref.labels_crc)
    assert [(c.start, c.stop, c.nnz, c.crc) for c in port.chunks] == \
        [(c.start, c.stop, c.nnz, c.crc) for c in ref.chunks]
    (Xp, yp), (Xr, yr) = port.to_csr(), ref.to_csr()
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(Xp, f), getattr(Xr, f))
    np.testing.assert_array_equal(Xp.todense(), Xd)
    np.testing.assert_array_equal(yp, yr)
    if version == 2:
        corrupt_chunk_file(port, 1, field="indices", seed=5)
        with pytest.raises(ChunkCorruptionError, match="chunk 1"):
            port.chunk_csr(1)
        with pytest.raises(jfaults.ChunkCorruptionError, match="chunk 1"):
            ref.chunk_csr(1)


def test_store_from_libsvm_bytes_match_reference(tmp_path):
    """The streaming libsvm conversion writes the reference's bytes."""
    rng = np.random.default_rng(13)
    Xd = np.where(rng.random((11, 29)) < 0.3,
                  rng.standard_normal((11, 29)), 0.0).astype(np.float32)
    y = np.sign(rng.standard_normal(29)).astype(np.float32)
    p = str(tmp_path / "f.svm")
    save_libsvm(p, Xd, y)
    for axis in ("samples", "features"):
        ShardStore.from_libsvm(p, str(tmp_path / f"port-{axis}"), axis=axis,
                               chunk_size=6, n_features=11)
        JShardStore.from_libsvm(p, str(tmp_path / f"ref-{axis}"), axis=axis,
                                chunk_size=6, n_features=11)
        assert _tree(tmp_path / f"port-{axis}") == \
            _tree(tmp_path / f"ref-{axis}")


@pytest.mark.parametrize("n0,n1,chunk", APPENDS)
def test_store_append_bytes_match_reference(tmp_path, n0, n1, chunk):
    """An append rewrites the same bytes as the reference's append."""
    _, Xd, y = _append_case(n0, n1)
    X0, X1 = CSRMatrix.from_dense(Xd[:, :n0]), CSRMatrix.from_dense(Xd[:, n0:])
    ShardStore.from_csr(X0, y[:n0], str(tmp_path / "p"), axis="samples",
                        chunk_size=chunk).append_chunks(X1, y[n0:])
    JShardStore.from_csr(_to_ref(X0), y[:n0], str(tmp_path / "r"),
                         axis="samples", chunk_size=chunk
                         ).append_chunks(_to_ref(X1), y[n0:])
    assert _tree(tmp_path / "p") == _tree(tmp_path / "r")


def test_corruption_offsets_match_reference(tmp_path):
    """The port's damage helpers pick the reference's byte for a seed and
    leave the same file size."""
    X, _ = _random_csr(12, 10, 0.5, seed=20)
    y = np.zeros(10, np.float32)
    a = ShardStore.from_csr(X, y, str(tmp_path / "a"), axis="features",
                            chunk_size=4)
    b = JShardStore.from_csr(_to_ref(X), y, str(tmp_path / "b"),
                             axis="features", chunk_size=4)
    for seed in range(5):
        assert corrupt_chunk_file(a, 0, "data", seed=seed) == \
            jfaults.corrupt_chunk_file(b, 0, "data", seed=seed)
    assert truncate_chunk_file(a, 1, "indices", 5) == \
        jfaults.truncate_chunk_file(b, 1, "indices", 5)
    assert _tree(a.path) == _tree(b.path)
