"""CoCoA+ baseline (Jaggi et al. 2014; Ma et al. 2015 "adding" variant).

Maximizes the dual (D) with local SDCA on each shard's own dual block and
a single d-vector reduceAll per outer iteration:

    w(alpha) = (1/(lam n)) X alpha
    each shard: H SDCA coordinate steps on its local alpha block against
                v = w + (sigma'/(lam n)) X_j dalpha_j   (sigma' = m, gamma = 1)
    round     : w += sum_j (1/(lam n)) X_j dalpha_j     (reduceAll d)

Closed-form coordinate step for quadratic loss; a 40-step bisection for
logistic (its conjugate has no closed-form maximizer). The shards' local
passes run side by side: step t of every shard this process holds is one
set of (nl,)-wide device operations (the same arithmetic per shard as a
pass of its own), with no host read inside the pass.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import comm
from repro_torch.core.baselines.shards import SampleShards
from repro_torch.core.losses import get_loss
from repro_torch.parallel.collectives import InProcessGroup, local_slice


@dataclasses.dataclass(frozen=True)
class CocoaConfig:
    loss: str = "logistic"        # 'logistic' | 'quadratic'
    lam: float = 1e-4
    max_outer: int = 100
    local_steps: int | None = None  # H; default = local sample count
    grad_tol: float = 1e-8
    seed: int = 0


def cocoa_sample_order(seed: int, outer_iter: int, shard: int, steps: int,
                       n_loc: int) -> np.ndarray:
    """The (steps,) local sample indices shard ``shard`` visits at outer
    iteration ``outer_iter``, uniform with replacement, from a
    ``torch.Generator`` seeded from ``(seed, outer_iter, shard)``."""
    state = np.random.SeedSequence((seed, outer_iter, shard)).generate_state(
        1, np.uint64)
    gen = torch.Generator().manual_seed(int(state[0]) >> 1)
    return torch.randint(0, n_loc, (steps,), generator=gen).numpy()


def _delta_quadratic(alpha_i, yi, xv, qi, sigma_p, lam_n):
    # phi(a) = (a - y)^2  =>  phi*(u) = u^2/4 + u y
    denom = 0.5 + sigma_p * qi / lam_n
    return (yi - xv - 0.5 * alpha_i) / denom


def _delta_logistic(alpha_i, yi, xv, qi, sigma_p, lam_n):
    # Maximize over delta with b = (alpha+delta) y in (0,1). Stationarity
    #   G(b) = -y log(b/(1-b)) - xv - kappa (b y - alpha) = 0,
    # G is strictly monotone in b (sign of -y) -> bisection is exact.
    kappa = sigma_p * qi / lam_n
    eps = 1e-7
    lo = torch.full_like(xv, eps)
    hi = torch.full_like(xv, 1.0 - eps)
    neg_y, y_pos = -yi, yi > 0
    for _ in range(40):
        mid = 0.5 * (lo + hi)
        G = neg_y * (torch.log(mid) - torch.log1p(-mid)) - xv \
            - kappa * (mid * yi - alpha_i)
        root_right = (G > 0) == y_pos
        lo = torch.where(root_right, mid, lo)
        hi = torch.where(root_right, hi, mid)
    b = 0.5 * (lo + hi)
    return b * yi - alpha_i


def cocoa_fit(X, y, cfg: CocoaConfig | None = None,
              group: InProcessGroup | None = None, device=None):
    """Returns (w, history, ledger). X is a dense (d, n) numpy array or
    tensor, sharded by samples over ``group`` (under a
    ``DistributedGroup`` every rank passes the whole X and gets the same
    result); ``device`` None means the card."""
    cfg = cfg or CocoaConfig()
    loss = get_loss(cfg.loss)
    group = group or InProcessGroup(1)
    padded = SampleShards.pad(X, y, group.size, device)
    sh = SampleShards.create(X, y, group, device, padded=padded)
    m, d, n_loc, nl = sh.m, sh.d, sh.n_loc, len(sh.locs)
    dev = sh.X.device
    sigma_p = float(m)  # safe aggregation parameter for gamma = 1 (adding)
    H = cfg.local_steps or n_loc
    lam_n = cfg.lam * sh.n
    delta_fn = (_delta_quadratic if cfg.loss == "quadratic"
                else _delta_logistic)

    # a shard's samples as rows, for the per-step gather; label, squared
    # column norm and weight side by side, one gather a step. The norms
    # shard by shard: a column sum over the whole block rounds its last
    # columns by the block's width
    XT = sh.X.T.reshape(nl, n_loc, d).contiguous()
    sq = torch.stack([torch.sum(loc * loc, dim=0) for loc in sh.locs])
    side = torch.stack([sh.y, sq, sh.wts], dim=2)
    rows = torch.arange(nl, device=dev)

    def local_pass(alpha, w, idx):
        dxa = torch.zeros((nl, d), dtype=w.dtype, device=dev)
        for t in range(H):
            i = idx[:, t]
            xi = XT[rows, i]                                      # (m, d)
            v = w + (sigma_p / lam_n) * dxa
            v_dot = torch.bmm(xi[:, None, :], v[:, :, None]).reshape(nl)
            yi, qi, wi = side[rows, i].unbind(1)
            delta = delta_fn(alpha[rows, i], yi, v_dot, qi, sigma_p,
                             lam_n) * wi
            alpha.index_put_((rows, i), delta, accumulate=True)
            dxa = dxa + delta[:, None] * xi
        return dxa

    # feasible dual start: alpha*y in (0,1) for logistic; 0 fine for
    # quadratic. w must start dual-consistent: w0 = X alpha0 / (lam n),
    # from the whole padded X on every process (no collective, as the
    # reference's host product)
    Xp, yp, wts = padded[:3]
    alpha = 0.5 * yp * wts if cfg.loss == "logistic" \
        else torch.zeros_like(yp)
    w = (Xp @ alpha) / lam_n
    alpha = alpha.reshape(m, n_loc)[local_slice(group)]
    del padded, Xp, yp, wts

    history: list[dict[str, Any]] = []
    ledger = comm.CommLedger()
    for k in range(cfg.max_outer):
        idx = torch.from_numpy(np.stack([
            cocoa_sample_order(cfg.seed, k, s, H, n_loc)
            for s in group.local])).to(dev)
        dxa = local_pass(alpha, w, idx)
        w = w + sh.group.all_reduce(dxa) / lam_n  # the ONE d-vector reduceAll
        g, fval = sh.objective(loss, cfg.lam, w)
        stats = dict(grad_norm=float(torch.sqrt(torch.dot(g, g))),
                     f=float(fval))
        ledger.add(*comm.cocoa_iter_cost(d))
        stats.update(outer_iter=k, comm_rounds_cum=ledger.rounds)
        history.append(stats)
        if stats["grad_norm"] <= cfg.grad_tol:
            break
    return w.cpu().numpy(), history, ledger
