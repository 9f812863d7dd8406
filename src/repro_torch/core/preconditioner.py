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
