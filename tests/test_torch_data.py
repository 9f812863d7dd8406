"""The port's host-side data code gives the JAX package's arrays exactly.

Same seeds, same numpy inputs through ``repro.data`` and
``repro_torch.data``: synthetic data, partitions and the stacked
blocked-ELL layouts must be identical, not merely close.
"""
import numpy as np
import pytest
import torch

from repro.data import partition as jpart
from repro.data import sparse as jsparse
from repro_torch.data import partition as tpart
from repro_torch.data import sparse as tsparse
from repro_torch.utils.padding import pad_to_multiple


def _both_data(**kw):
    return (jsparse.make_sparse_glm_data(**kw),
            tsparse.make_sparse_glm_data(**kw))


def _port_csr(X):
    return tsparse.CSRMatrix(X.indptr, X.indices, X.data, X.shape)


@pytest.mark.parametrize("kw", [
    dict(d=96, n=200, density=0.2, alpha=0.8, beta=0.5, seed=1),
    dict(d=256, n=128, density=0.05, seed=3),
    dict(d=64, n=150, density=0.25, alpha=1.0, seed=3, task="regression"),
])
def test_make_sparse_glm_data_identical(kw):
    (Xj, yj, wj), (Xt, yt, wt) = _both_data(**kw)
    for a in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(Xt, a), getattr(Xj, a))
    assert Xt.shape == Xj.shape
    np.testing.assert_array_equal(yt, yj)
    np.testing.assert_array_equal(wt, wj)


@pytest.mark.parametrize("axis", ["features", "samples"])
@pytest.mark.parametrize("strategy", ["lpt", "width"])
@pytest.mark.parametrize("m", [1, 4])
def test_make_partition_identical(axis, strategy, m):
    (Xj, _, _), _ = _both_data(d=96, n=200, density=0.2, alpha=0.8,
                               beta=0.5, seed=1)
    pj = jpart.make_partition(Xj, axis, m, strategy, pad_multiple=16)
    pt = tpart.make_partition(_port_csr(Xj), axis, m, strategy,
                              pad_multiple=16)
    np.testing.assert_array_equal(pt.perm, pj.perm)
    np.testing.assert_array_equal(pt.inv, pj.inv)
    np.testing.assert_array_equal(pt.shard_nnz, pj.shard_nnz)
    assert pt.stats() == pj.stats()


def test_lpt_partition_blocks_identical():
    counts = np.random.default_rng(0).integers(0, 50, size=103)
    for block in (1, 4, 8):
        pj = jpart.lpt_partition(counts, 4, block=block, pad_multiple=8)
        pt = tpart.lpt_partition(counts, 4, block=block, pad_multiple=8)
        np.testing.assert_array_equal(pt.perm, pj.perm)
        assert pt.imbalance == pj.imbalance == tpart.imbalance(pt.shard_nnz)


@pytest.mark.parametrize("axis", ["features", "samples"])
@pytest.mark.parametrize("m", [1, 4])
@pytest.mark.parametrize("block", [8, 16])
def test_build_shard_ell_pairs_identical(axis, m, block):
    (Xj, _, _), _ = _both_data(d=96, n=200, density=0.2, alpha=0.8,
                               beta=0.5, seed=1)
    pj = jpart.make_partition(Xj, axis, m, "lpt", pad_multiple=block)
    pt = tpart.make_partition(_port_csr(Xj), axis, m, "lpt",
                              pad_multiple=block)
    ref = jsparse.build_shard_ell_pairs(
        jsparse.shard_csrs_from_partition(Xj, pj, axis), block, block)
    got = tsparse.build_shard_ell_pairs(
        tsparse.shard_csrs_from_partition(_port_csr(Xj), pt, axis),
        block, block)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("br,bc", [(8, 8), (16, 16), (8, 16)])
def test_ell_from_csr_identical_and_roundtrips(br, bc):
    (Xj, _, _), _ = _both_data(d=50, n=70, density=0.15, seed=2)
    ej = jsparse.ell_from_csr(Xj, br, bc)
    et = tsparse.ell_from_csr(_port_csr(Xj), br, bc)
    np.testing.assert_array_equal(et.data, ej.data)
    np.testing.assert_array_equal(et.cols, ej.cols)
    np.testing.assert_array_equal(et.todense(), Xj.todense())
    # padding slots are present: some row-block is narrower than W
    assert (np.diff(et.cols, axis=1) <= 0).any()


def test_csr_ops_identical():
    (Xj, _, _), _ = _both_data(d=40, n=60, density=0.2, seed=5)
    Xt = _port_csr(Xj)
    idx = np.array([3, 45, 0, 39, 41])            # 41, 45 are empty rows
    for got, ref in ((Xt.take_rows(idx), Xj.take_rows(idx)),
                     (Xt.transpose(), Xj.transpose())):
        np.testing.assert_array_equal(got.todense(), ref.todense())
    np.testing.assert_array_equal(Xt.take_cols_dense(np.arange(7)),
                                  Xj.take_cols_dense(np.arange(7)))
    np.testing.assert_array_equal(Xt.nnz_per_row(), Xj.nnz_per_row())
    np.testing.assert_array_equal(Xt.nnz_per_col(), Xj.nnz_per_col())
    dense = Xj.todense()
    np.testing.assert_array_equal(
        tsparse.CSRMatrix.from_dense(dense).todense(), dense)


def test_hvp_tile_dtype_f32_only():
    assert tsparse.hvp_tile_dtype("float32") == np.float32
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tsparse.hvp_tile_dtype("bfloat16")
    with pytest.raises(ValueError):
        tsparse.hvp_tile_dtype("float16")


def test_pad_to_multiple_numpy_and_torch():
    a = np.arange(10, dtype=np.float32).reshape(2, 5)
    p, pad = pad_to_multiple(a, 1, 4)
    assert pad == 3 and p.shape == (2, 8) and (p[:, 5:] == 0).all()
    t, pad_t = pad_to_multiple(torch.from_numpy(a), 1, 4)
    assert pad_t == 3 and isinstance(t, torch.Tensor)
    np.testing.assert_array_equal(t.numpy(), p)
    same, zero = pad_to_multiple(a, 0, 2)
    assert zero == 0 and same is a
