"""DANE baseline (Shamir, Srebro & Zhang 2013) — paper eq. (1).

Each iteration:
  round 1: reduceAll gradient  g = (1/m) sum_j grad f_j(w_k)
  local   : w_j = argmin_w f_j(w) - (grad f_j(w_k) - eta g)^T w
                                 + (mu/2)||w - w_k||^2
  round 2: reduceAll average   w_{k+1} = (1/m) sum_j w_j

The local subproblem is solved with a few damped-Newton-CG iterations on
the shard's own samples, in plain ``torch.matmul`` (the JAX package also
leaves these products outside any kernel).
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
class DaneConfig:
    loss: str = "logistic"
    lam: float = 1e-4
    mu: float = 1e-2
    eta: float = 1.0
    max_outer: int = 50
    local_newton_iters: int = 8
    local_cg_iters: int = 32
    grad_tol: float = 1e-8


def _local_cg(hvp, b, iters):
    """Plain CG for the local Newton system (no communication), a fixed
    ``iters`` iterations."""
    x = torch.zeros_like(b)
    r = b
    p = r
    rs = torch.dot(r, r)
    for _ in range(iters):
        Hp = hvp(p)
        alpha = rs / torch.clamp(torch.dot(p, Hp), min=1e-30)
        x = x + alpha * p
        r = r - alpha * Hp
        rs_new = torch.dot(r, r)
        p = r + (rs_new / torch.clamp(rs, min=1e-30)) * p
        rs = rs_new
    return x


def dane_fit(X, y, cfg: DaneConfig | None = None,
             group: InProcessGroup | None = None,
             w0: np.ndarray | None = None, device=None):
    """Returns (w, history, ledger). X is a dense (d, n) numpy array or
    tensor, sharded by samples over ``group`` (under a
    ``DistributedGroup`` every rank passes the whole X and gets the same
    result); ``device`` None means the card."""
    cfg = cfg or DaneConfig()
    loss = get_loss(cfg.loss)
    sh = SampleShards.create(X, y, group, device)
    m, nl = sh.m, len(sh.locs)
    n_loc_eff = sh.n / m  # effective local sample count (uniform partition)

    def local_grad(s, wv):
        a = sh.locs[s].T @ wv
        return sh.locs[s] @ (loss.d1(a, sh.y[s]) * sh.wts[s]) / n_loc_eff \
            + cfg.lam * wv

    def local_hvp_at(s, wv):
        X_loc = sh.locs[s]
        c = loss.d2(X_loc.T @ wv, sh.y[s]) * sh.wts[s]

        def hvp(u):
            return X_loc @ (c * (X_loc.T @ u)) / n_loc_eff \
                + (cfg.lam + cfg.mu) * u
        return hvp

    def local_solve(s, w, a_vec):
        # local damped Newton on h(v) = f_j(v) - a^T v + mu/2 ||v - w||^2
        v = w
        for _ in range(cfg.local_newton_iters):
            grad_h = local_grad(s, v) - a_vec + cfg.mu * (v - w)
            v = v - _local_cg(local_hvp_at(s, v), grad_h,
                              cfg.local_cg_iters)
        return v

    dev = sh.X.device
    w = torch.zeros(sh.d, dtype=torch.float32, device=dev) if w0 is None \
        else torch.from_numpy(np.asarray(w0, np.float32)).to(dev)
    history: list[dict[str, Any]] = []
    ledger = comm.CommLedger()
    for k in range(cfg.max_outer):
        gj = [local_grad(s, w) for s in range(nl)]
        g = sh.group.all_reduce(gj) / m              # round 1 (reduceAll d)
        gnorm = torch.sqrt(torch.dot(g, g))
        w_new = sh.group.all_reduce(                 # round 2 (reduceAll d)
            [local_solve(s, w, gj[s] - cfg.eta * g) for s in range(nl)]) / m
        fval = sh.value(loss, cfg.lam, w)
        w = w_new
        stats = dict(grad_norm=float(gnorm), f=float(fval))
        ledger.add(*comm.dane_iter_cost(sh.d))
        stats.update(outer_iter=k, comm_rounds_cum=ledger.rounds)
        history.append(stats)
        if stats["grad_norm"] <= cfg.grad_tol:
            break
    return w.cpu().numpy(), history, ledger
