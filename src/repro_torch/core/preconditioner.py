"""Woodbury-formula preconditioner (paper Section 4, Algorithm 4).

The preconditioning matrix built from tau << n samples is

    P = (lam + mu) I + (1/tau) sum_{i<=tau} c_i x_i x_i^T          (eq. 5/8/9)

``P s = r`` is solved *exactly* via the Woodbury identity:

    U = X_tau diag(sqrt(c / tau))                 # (d, tau)
    P = delta I + U U^T,    delta = lam + mu
    P^{-1} r = y - Z (I + U^T Z)^{-1} U^T y,      y = r / delta, Z = U / delta

which costs one tau x tau dense solve. For DiSCO-F the preconditioner is
block-diagonal: each feature shard builds its own from its rows of
X_tau, with zero communication.

:func:`sag_solve` is the original DiSCO's inner solver, the iterative
baseline the closed form replaces.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class WoodburyPreconditioner:
    """Closed-form inverse application of P = delta I + U U^T."""

    U: torch.Tensor     # (d_local, tau) = X_tau * sqrt(c/tau)
    delta: float        # lam + mu
    K: torch.Tensor     # (tau, tau) = I + U^T U / delta

    @classmethod
    def build(cls, X_tau: torch.Tensor, coeffs: torch.Tensor, lam: float,
              mu: float) -> "WoodburyPreconditioner":
        """X_tau: (d_local, tau) sample columns; coeffs: (tau,) phi''."""
        tau = X_tau.shape[1]
        delta = lam + mu
        scale = torch.sqrt(torch.clamp(coeffs, min=0.0) / tau)
        U = X_tau * scale[None, :]
        K = torch.eye(tau, dtype=X_tau.dtype, device=X_tau.device) \
            + (U.T @ U) / delta
        return cls(U=U, delta=delta, K=K)

    @classmethod
    def build_blockdiag(cls, X_tau_local: torch.Tensor, coeffs: torch.Tensor,
                        lam: float, mu: float) -> "WoodburyPreconditioner":
        """DiSCO-F local block P^{[j]} from the shard's feature rows."""
        return cls.build(X_tau_local, coeffs, lam, mu)

    def apply_inv(self, r: torch.Tensor) -> torch.Tensor:
        """s = P^{-1} r via Algorithm 4."""
        y = r / self.delta
        v = torch.linalg.solve(self.K, self.U.T @ y)
        return y - (self.U @ v) / self.delta

    def dense(self) -> torch.Tensor:
        """Materialized P — tests only."""
        d = self.U.shape[0]
        return self.delta * torch.eye(d, dtype=self.U.dtype,
                                      device=self.U.device) \
            + self.U @ self.U.T


@dataclasses.dataclass(frozen=True)
class IdentityPreconditioner:
    """No preconditioning (plain CG) — baseline / ablation."""

    def apply_inv(self, r: torch.Tensor) -> torch.Tensor:
        return r


def sag_solve(X_tau: torch.Tensor, coeffs: torch.Tensor, lam: float,
              mu: float, r: torch.Tensor, epochs: int = 5,
              step: float | None = None) -> torch.Tensor:
    """Original-DiSCO inner solver: solve P s = r *iteratively* with SAG.

    P s = r is the optimality condition of the quadratic

        g(s) = (1/2tau) sum_i c_i <x_i, s>^2 + (delta/2)||s||^2 - <r, s>

    whose per-sample gradient is c_i x_i <x_i, s> + delta s - r. SAG keeps
    one scalar per sample (g_i = c_i <x_i, s_at_last_visit>) and sweeps the
    samples cyclically, ``epochs`` times, from the warm start s0 = r/delta.
    The default step is 1/L_max over the per-sample Lipschitz constants
    L_i = c_i ||x_i||^2 + delta, kept on the device.

    Each step refreshes one table entry and recomputes the average
    ``X_tau @ table / tau`` in full, as the JAX package does (an O(d)
    incremental update rounds differently over the steps). The loop reads
    nothing back to the host: ``epochs * tau`` serial steps of a few
    small launches each, on one device, while the shards wait — the
    master bottleneck the paper's Woodbury closed form removes.
    """
    tau = X_tau.shape[1]
    delta = lam + mu
    if step is None:
        lmax = torch.max(coeffs * torch.sum(X_tau * X_tau, dim=0)) + delta
        step = 1.0 / lmax
    s = r / delta
    table = coeffs * (X_tau.T @ s)
    for _ in range(epochs):
        for i in range(tau):
            table[i] = coeffs[i] * torch.dot(X_tau[:, i], s)
            g = X_tau @ table / tau + delta * s - r
            s = s - step * g
    return s
