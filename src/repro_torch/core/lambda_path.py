"""λ-path sweeps: warm-started regularization grids on one data layout.

Model selection fits the same GLM at many regularization weights λ and
picks the best by validation loss. Fit independently ("cold"), every λ
pays the whole Newton trajectory from zero, and every Newton or PCG
iteration is passes over X. The path sweep walks the grid from the most
to the least regularized λ, warm-starting each solve at the previous
solution: the damped Newton method is self-concordant and affine
invariant, so a near-solution re-converges in a few outer iterations,
and the whole grid rides one data layout
(:meth:`repro_torch.core.disco.DiscoSolver.with_lam` shares the device
tensors, so X is placed once for the whole path).

The analytic X-pass ledger (:func:`x_passes`) counts data passes as the
kernels move bytes: a multi-vector pass (``xt_multi``, ``ell_matmat``,
the s-step round's batch) reads X once for all its columns, and a fused
one-pass HVP halves the two-pass count. The port of
``repro.core.lambda_path``, with the same grid order, warm starts and
ledger.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core.disco import (DiscoConfig, DiscoResult, DiscoSolver,
                                    resolve_device)
from repro_torch.core.glm import GLMProblem
from repro_torch.core.losses import get_loss
from repro_torch.data.sparse import CSRMatrix
from repro_torch.parallel.collectives import InProcessGroup


@dataclasses.dataclass
class LambdaPathResult:
    """Outcome of :func:`lambda_path_fit`.

    Attributes:
        lambdas: the grid in the order fitted (descending λ).
        results: one :class:`repro_torch.core.disco.DiscoResult` per λ.
        x_passes: analytic passes over X each solve cost
            (:func:`x_passes`).
        val_losses: mean validation loss per λ (None without a
            validation set).
        best_index: argmin of ``val_losses`` (None without one).
    """

    lambdas: list[float]
    results: list[DiscoResult]
    x_passes: list[int]
    val_losses: list[float] | None = None
    best_index: int | None = None

    @property
    def total_x_passes(self) -> int:
        """Total analytic X passes over the whole grid."""
        return int(sum(self.x_passes))

    @property
    def best_lambda(self) -> float | None:
        """λ minimizing the validation loss (None without one)."""
        return (None if self.best_index is None
                else self.lambdas[self.best_index])

    @property
    def best_result(self) -> DiscoResult | None:
        """The winning fit (None without a validation set)."""
        return (None if self.best_index is None
                else self.results[self.best_index])


def x_passes(history: Sequence[dict[str, Any]], cfg: DiscoConfig,
             axis_size: int = 1) -> int:
    """Analytic count of full passes over X for one solve's history.

    Per outer iteration: 2 passes for margins and gradient, plus PCG —

    * classic PCG (``pcg_block_s == 1``): each iteration is one HVP, 2
      passes two-pass, 1 fused;
    * s-step: each round pays one batched multi-vector HVP (a
      multi-vector pass reads X once whatever its column count) plus
      ``s - 1`` basis-operator products. DiSCO-S's basis operator on
      several shards runs on the replicated tau slab (no X pass); on one
      shard, and DiSCO-F's, it reads X (fused 1, two-pass 2).
    """
    per_hvp = 1 if cfg.hvp_fused else 2
    s = cfg.pcg_block_s
    total = 0
    for h in history:
        inner_units = int(h["pcg_iters"])
        if s <= 1:
            inner = inner_units * per_hvp
        else:
            basis_uses_x = not (cfg.partition == "samples"
                                and axis_size > 1)
            per_round = per_hvp + (s - 1) * (per_hvp if basis_uses_x
                                             else 0)
            inner = inner_units * per_round
        total += 2 + inner
    return total


def _csr_margins(X: CSRMatrix, w: np.ndarray) -> np.ndarray:
    """``X^T w`` of a feature-major sparse matrix, on the host."""
    d, n = X.shape
    feature = np.repeat(np.arange(d), np.diff(X.indptr))
    prod = X.data.astype(np.float64) * np.asarray(w, np.float64)[feature]
    return np.bincount(X.indices, weights=prod, minlength=n).astype(
        np.float32)


def validation_loss(w, X_val, y_val, loss_name: str = "logistic",
                    device=None) -> float:
    """Mean validation loss of a fitted ``w`` on held-out data: a dense
    ``(d, n_val)`` array or tensor (margins through
    :class:`repro_torch.core.glm.GLMProblem` on ``device``, default the
    card; a tensor stays where it is) or a :class:`CSRMatrix`."""
    loss = get_loss(loss_name)
    if isinstance(X_val, CSRMatrix):
        dev = resolve_device(device)
        a = torch.from_numpy(_csr_margins(X_val, w)).to(dev)
        y = torch.as_tensor(np.asarray(y_val, np.float32), device=dev)
    else:
        prob = GLMProblem.create(X_val, y_val, loss=loss, device=device)
        a = prob.margins(torch.as_tensor(np.asarray(w, np.float32),
                                         device=prob.X.device))
        y = prob.y
    return float(torch.mean(loss.value(a, y)))


def lambda_path_fit(X, y, lambdas: Sequence[float],
                    cfg: DiscoConfig | None = None,
                    group: InProcessGroup | None = None, device=None,
                    warm: bool = True, X_val=None, y_val=None,
                    w0: np.ndarray | None = None) -> LambdaPathResult:
    """Fit a λ grid, warm-started down the path, on one data layout.

    The grid is sorted descending (strongest regularization first) and
    each later λ starts at the previous optimum through
    :meth:`DiscoSolver.with_lam` copies that share every device tensor.
    ``warm=False`` is the cold baseline (the same shared layout, every λ
    from ``w0`` or zeros).

    With a validation set (``X_val``, ``y_val``) each fit is scored by
    :func:`validation_loss` on the solver's device, and ``best_index`` /
    ``best_lambda`` name the winner.

    Args:
        X: (d, n) dense array or tensor, or a :class:`CSRMatrix`.
        y: (n,) labels.
        lambdas: regularization grid (any order; fitted descending).
        cfg: base solver config; its ``lam`` is replaced per grid point.
        group: the shards (default: one shard); under a
            ``DistributedGroup`` every rank calls this with the same
            arguments and gets the same result.
        device: default ``'cuda'``; ``'cpu'`` runs the plain versions.
        warm: warm-start each λ at the previous solution.
        X_val, y_val: optional held-out set for model selection.
        w0: optional start for the first (or with ``warm=False``, every)
            solve.
    """
    cfg = cfg or DiscoConfig()
    lams = sorted((float(l) for l in lambdas), reverse=True)
    if not lams:
        raise ValueError("lambda_path_fit needs at least one lambda")

    solver = DiscoSolver(X, y, dataclasses.replace(cfg, lam=lams[0]),
                         group=group, device=device)
    results: list[DiscoResult] = []
    passes: list[int] = []
    w_prev = w0
    for i, lam in enumerate(lams):
        if i > 0:
            solver = solver.with_lam(lam)
        res = solver.fit(w0=(w_prev if (warm or i == 0) else w0))
        results.append(res)
        passes.append(x_passes(res.history, solver.cfg, axis_size=solver.m))
        if warm:
            w_prev = res.w

    val_losses = None
    best_index = None
    if X_val is not None and y_val is not None:
        val_losses = [validation_loss(r.w, X_val, y_val, cfg.loss,
                                      device=solver.device)
                      for r in results]
        best_index = int(np.argmin(val_losses))
    return LambdaPathResult(lambdas=lams, results=results,
                            x_passes=passes, val_losses=val_losses,
                            best_index=best_index)
