"""The port's libsvm readers and writer against the JAX package's.

Files written by the reference's ``save_libsvm`` (and by hand, for the
explicit-``n_features`` cases of ``tests/test_data.py``) through
``repro.data`` and ``repro_torch.data``: the same CSR arrays, dense
matrices, labels and chunks, exactly (one parser, the same numpy code).
The port's ``save_libsvm`` writes the reference's bytes. A file read by
each package's reader and solved by each package's ``disco_fit`` ends at
the same ``w`` (rtol 1e-4 / atol 1e-6).
"""
import numpy as np
import pytest

from repro.core import DiscoConfig as JDiscoConfig
from repro.core import disco_fit as j_disco_fit
from repro.data import libsvm as jlibsvm
from repro.data import sparse as jsparse
from repro.data.sparse import make_sparse_glm_data
from repro_torch import (CSRMatrix, DiscoConfig, disco_fit, load_libsvm,
                         load_libsvm_sparse, save_libsvm)
from repro_torch.data import iter_libsvm_chunks, truncate_features


def _random_file(tmp_path, d=13, n=37, seed=0):
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((d, n)) * (rng.random((d, n)) < 0.3)
         ).astype(np.float32)
    X[:, 5] = 0.0                         # a sample with no feature
    X[d - 1] = 0.0                        # the last feature never seen
    y = np.sign(rng.standard_normal(n)).astype(np.float32)
    y[y == 0] = 1.0
    path = str(tmp_path / "data.svm")
    jlibsvm.save_libsvm(path, X, y)
    return path, X, y


def _same_csr(a, b):
    assert a.shape == b.shape
    for k in ("indptr", "indices", "data"):
        got, want = getattr(a, k), getattr(b, k)
        assert got.dtype == want.dtype and np.array_equal(got, want), k


@pytest.mark.parametrize("n_features", [None, 13, 5, 20])
@pytest.mark.parametrize("chunk", [1, 2, 7, 8192])
def test_load_libsvm_sparse_matches_jax(tmp_path, n_features, chunk):
    path, X, _ = _random_file(tmp_path)
    got_X, got_y = load_libsvm_sparse(path, n_features=n_features,
                                      chunk_samples=chunk)
    want_X, want_y = jsparse.load_libsvm_sparse(path, n_features=n_features,
                                                chunk_samples=chunk)
    assert isinstance(got_X, CSRMatrix)
    _same_csr(got_X, want_X)
    assert np.array_equal(got_y, want_y)
    d = n_features if n_features is not None else 12   # max index seen
    assert got_X.shape == (d, X.shape[1])


@pytest.mark.parametrize("n_features", [None, 5, 20])
def test_load_libsvm_dense_matches_jax(tmp_path, n_features):
    path, X, y = _random_file(tmp_path)
    got_X, got_y = load_libsvm(path, n_features=n_features)
    want_X, want_y = jlibsvm.load_libsvm(path, n_features=n_features)
    assert np.array_equal(got_X, want_X) and np.array_equal(got_y, want_y)
    if n_features == 20:
        np.testing.assert_allclose(got_X[:13], X, rtol=1e-5, atol=1e-6)
        assert not got_X[13:].any()
    assert np.array_equal(got_y, y)


@pytest.mark.parametrize("chunk", [1, 3, 8192])
@pytest.mark.parametrize("n_features", [None, 4])
def test_iter_libsvm_chunks_matches_jax(tmp_path, chunk, n_features):
    path, _, _ = _random_file(tmp_path)
    got = list(iter_libsvm_chunks(path, chunk, n_features=n_features))
    want = list(jsparse.iter_libsvm_chunks(path, chunk,
                                           n_features=n_features))
    assert len(got) == len(want) == -(-37 // chunk)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        if n_features is not None:
            assert (g[0] < n_features).all()


def test_save_libsvm_writes_the_reference_bytes(tmp_path):
    _, X, y = _random_file(tmp_path)
    a, b = str(tmp_path / "port.svm"), str(tmp_path / "ref.svm")
    save_libsvm(a, X, y)
    jlibsvm.save_libsvm(b, X, y)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    X2, y2 = load_libsvm(a, n_features=X.shape[0])
    np.testing.assert_allclose(X2, X, rtol=1e-5, atol=1e-6)
    assert np.array_equal(y2, y)


def test_explicit_small_n_features_truncates(tmp_path):
    """``tests/test_data.py``'s truncation case: features at index >=
    n_features are dropped, in all three readers alike."""
    p = str(tmp_path / "trunc.svm")
    with open(p, "w") as f:
        f.write("1 1:1.5 7:2.5\n-1 2:3.5 3:4.5\n")
    X, y = load_libsvm(p, n_features=3)
    want = np.zeros((3, 2), np.float32)
    want[0, 0], want[1, 1], want[2, 1] = 1.5, 3.5, 4.5
    np.testing.assert_allclose(X, want)
    np.testing.assert_array_equal(y, [1.0, -1.0])
    jX, jy = jlibsvm.load_libsvm(p, n_features=3)
    assert np.array_equal(X, jX) and np.array_equal(y, jy)

    p = str(tmp_path / "t.svm")
    with open(p, "w") as f:
        f.write("1 1:1.0 5:5.0\n-1 2:2.0 9:9.0\n1 3:3.0\n")
    Xd, yd = load_libsvm(p, n_features=3)
    Xs, ys = load_libsvm_sparse(p, n_features=3, chunk_samples=2)
    np.testing.assert_allclose(Xs.todense(), Xd)
    np.testing.assert_array_equal(ys, yd)
    assert Xd[0, 0] == 1.0 and Xd[1, 1] == 2.0 and Xd[2, 2] == 3.0
    flat = [(int(f), int(s), float(v))
            for fi, si, vs, _ in iter_libsvm_chunks(p, chunk_samples=2,
                                                    n_features=3)
            for f, s, v in zip(fi, si, vs)]
    assert flat == [(0, 0, 1.0), (1, 1, 2.0), (2, 2, 3.0)]


def test_n_features_pads_and_truncate_is_a_noop_in_range(tmp_path):
    p = str(tmp_path / "pad.svm")
    with open(p, "w") as f:
        f.write("1 1:2.0\n")
    X, _ = load_libsvm(p, n_features=5)
    assert X.shape == (5, 1) and X[0, 0] == 2.0 and X[1:].sum() == 0
    fi, si, vs = (np.array([0, 2]), np.array([0, 1]),
                  np.array([1.0, 2.0], np.float32))
    out = truncate_features(fi, si, vs, 3)
    assert all(a is b for a, b in zip(out, (fi, si, vs)))
    assert [a.tolist() for a in truncate_features(fi, si, vs, 2)] == \
        [a.tolist() for a in jsparse.truncate_features(fi, si, vs, 2)]


@pytest.mark.parametrize("partition", ["samples", "features"])
def test_solve_from_a_libsvm_file_matches_jax(tmp_path, partition):
    """A sparse problem written to a libsvm file, read by each package's
    reader and solved by each package's ``disco_fit``."""
    X, y, _ = make_sparse_glm_data(d=96, n=200, density=0.2, alpha=0.8,
                                   beta=0.5, seed=1)
    path = str(tmp_path / "glm.svm")
    jlibsvm.save_libsvm(path, X.todense(), y)
    kw = dict(loss="logistic", lam=1e-3, tau=100, max_outer=4,
              grad_tol=0.0, ell_block_d=16, ell_block_n=16,
              partition=partition)
    jX, jy = jsparse.load_libsvm_sparse(path, n_features=96)
    pX, py = load_libsvm_sparse(path, n_features=96)
    ref = j_disco_fit(jX, jy, JDiscoConfig(**kw))
    got = disco_fit(pX, py, DiscoConfig(**kw), device="cpu")
    np.testing.assert_allclose(got.w, np.asarray(ref.w), rtol=1e-4,
                               atol=1e-6)
    assert [h["pcg_iters"] for h in got.history] == \
        [int(h["pcg_iters"]) for h in ref.history]
