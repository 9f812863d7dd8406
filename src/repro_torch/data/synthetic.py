"""Synthetic dense GLM data with a controllable d/n regime and conditioning.

The port's own numpy copy of the JAX package's ``repro.data.synthetic``:
the same seed gives the same arrays. The paper's datasets (Table 5) span
three regimes, reproduced here at laptop scale with dense Gaussians whose
Gram spectrum decays like real text data (power-law):

    news20-like        d >> n
    rcv1-like          d <  n
    splice-site-like   d ~= n
"""
from __future__ import annotations

import numpy as np

REGIMES = {
    # name: (d, n) scaled-down analogues of the paper's Table 5
    "news20_like": (2048, 256),      # d >> n
    "rcv1_like": (256, 4096),        # d <  n
    "splice_like": (1024, 1024),     # d ~= n
}


def make_glm_data(d: int, n: int, task: str = "classification",
                  cond_decay: float = 0.8, noise: float = 0.1,
                  seed: int = 0, dtype=np.float32):
    """Return X (d, n), y (n,), w_true (d,).

    cond_decay in (0, 1]: singular values of the feature covariance decay as
    k^{-cond_decay}; smaller -> better conditioned. Columns have unit norm;
    classification labels are +-1 drawn from a logistic model.
    """
    rng = np.random.default_rng(seed)
    scales = (np.arange(1, d + 1, dtype=np.float64) ** (-cond_decay))
    Q = rng.standard_normal((d, d))
    Q, _ = np.linalg.qr(Q)
    A = Q * np.sqrt(scales)[None, :]
    X = (A @ rng.standard_normal((d, n))).astype(dtype)
    X /= np.maximum(np.linalg.norm(X, axis=0, keepdims=True), 1e-12)

    w_true = rng.standard_normal(d).astype(dtype) / np.sqrt(d)
    margins = X.T @ w_true
    if task == "classification":
        p = 1.0 / (1.0 + np.exp(-margins / max(margins.std(), 1e-9)))
        y = np.where(rng.random(n) < p, 1.0, -1.0).astype(dtype)
    elif task == "regression":
        y = (margins + noise * rng.standard_normal(n)).astype(dtype)
    else:
        raise ValueError(f"unknown task {task!r}")
    return X, y, w_true


def make_regime(name: str, seed: int = 0, task: str = "classification"):
    d, n = REGIMES[name]
    return make_glm_data(d, n, task=task, seed=seed)
