"""Plain distributed gradient descent — sanity baseline.

One d-vector reduceAll per iteration; fixed 1/L step from a power-iteration
estimate of the top Hessian eigenvalue.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import comm
from repro_torch.core.baselines.shards import SampleShards
from repro_torch.core.losses import get_loss
from repro_torch.parallel.collectives import InProcessGroup


@dataclasses.dataclass(frozen=True)
class GDConfig:
    loss: str = "logistic"
    lam: float = 1e-4
    max_outer: int = 500
    grad_tol: float = 1e-8
    step: float | None = None  # default: 1/L estimated by power iteration


def _power_step(X: torch.Tensor, lam: float) -> float:
    """1 / (2 lambda_max(X X^T) / n + lam), an upper bound of L for the
    losses here (c_max <= 2): 20 power iterations from the JAX package's
    start vector (``default_rng(0)``), on X's device."""
    d, n = X.shape
    v = torch.from_numpy(np.random.default_rng(0).standard_normal(d)
                         .astype(np.float32)).to(X.device)
    for _ in range(20):
        v = X @ (X.T @ v)
        v = v / torch.linalg.vector_norm(v)
    lmax = float(v @ (X @ (X.T @ v)))
    return 1.0 / (2.0 * lmax / n + lam)


def gd_fit(X, y, cfg: GDConfig | None = None,
           group: InProcessGroup | None = None, device=None):
    """Returns (w, history, ledger). X is a dense (d, n) numpy array or
    tensor, sharded by samples over ``group`` (under a
    ``DistributedGroup`` every rank passes the whole X and gets the same
    result); ``device`` None means the card."""
    cfg = cfg or GDConfig()
    loss = get_loss(cfg.loss)
    # the step from the whole (padded) X on every process, then the shards
    padded = SampleShards.pad(X, y, (group or InProcessGroup(1)).size,
                              device)
    step = _power_step(padded[0][:, :padded[3]], cfg.lam) \
        if cfg.step is None else cfg.step
    sh = SampleShards.create(X, y, group, device, padded=padded)
    del padded

    w = torch.zeros(sh.d, dtype=torch.float32, device=sh.X.device)
    history: list[dict[str, Any]] = []
    ledger = comm.CommLedger()
    for k in range(cfg.max_outer):
        g, fval = sh.objective(loss, cfg.lam, w)
        gnorm = torch.sqrt(torch.dot(g, g))
        w = w - step * g
        stats = dict(grad_norm=float(gnorm), f=float(fval))
        ledger.add(1, sh.d, 1)
        stats.update(outer_iter=k, comm_rounds_cum=ledger.rounds)
        history.append(stats)
        if stats["grad_norm"] <= cfg.grad_tol:
            break
    return w.cpu().numpy(), history, ledger
