"""libsvm-format reader and writer (the paper's datasets ship as libsvm).

Dense materialization, for the laptop-scale reproductions; sparse data
goes through :func:`repro_torch.data.sparse.load_libsvm_sparse`, which
returns the :class:`~repro_torch.data.sparse.CSRMatrix` the solver takes.
"""
from __future__ import annotations

import numpy as np

from repro_torch.data.sparse import load_libsvm_sparse


def load_libsvm(path: str, n_features: int | None = None, dtype=np.float32):
    """Return X (d, n), y (n,) — the paper's feature-major convention.

    An explicit ``n_features`` fixes the feature dimension: indices beyond
    it are *truncated* (dropped, the standard libsvm-reader convention —
    the shared :func:`repro_torch.data.sparse.truncate_features` clamp)
    rather than written out of the intended range; a larger value pads
    with empty features. Without it, ``d`` is the max index seen.

    The dense materialization of :func:`load_libsvm_sparse` (one parser,
    one clamp, the same semantics).
    """
    X, y = load_libsvm_sparse(path, n_features=n_features, dtype=dtype)
    return X.todense(), y


def save_libsvm(path: str, X: np.ndarray, y: np.ndarray):
    """Write a dense feature-major ``X (d, n)``, ``y (n,)`` pair as
    libsvm text (1-based feature indices, zeros omitted)."""
    d, n = X.shape
    with open(path, "w") as f:
        for j in range(n):
            nz = np.nonzero(X[:, j])[0]
            toks = " ".join(f"{i + 1}:{X[i, j]:.6g}" for i in nz)
            f.write(f"{y[j]:g} {toks}\n")
