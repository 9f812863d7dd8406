"""Regularized empirical risk minimization problem (P) on a GLM.

    f(w) = (1/n) sum_i phi(<w, x_i>, y_i) + (lam/2) ||w||^2

The data matrix follows the paper's convention X in R^{d x n} (features x
samples), as a dense tensor. Every routine is *local* (one tensor; plain
``torch.matmul``, and the dense kernels for the Hessian-vector product):
it is the oracle the solver is tested against and the model a served
solve scores with; the distributed solve shards X in
:mod:`repro_torch.core.disco`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.disco import resolve_device
from repro_torch.core.losses import Loss, get_loss
from repro_torch.kernels import ops as kops


def glm_margins(X, w) -> np.ndarray:
    """Margins ``X^T w`` of a feature-major ``(d, n)`` matrix, dense or
    sparse, as a host ``(n,)`` array (``repro.core.glm.glm_margins``).

    A :class:`repro_torch.data.sparse.CSRMatrix` stays sparse (one O(nnz)
    pass, :meth:`~repro_torch.data.sparse.CSRMatrix.xt_dot`); a numpy
    array is multiplied on the host; a tensor where it lies (``w`` moved
    there in its dtype), the result brought to the host.
    """
    from repro_torch.data.sparse import CSRMatrix

    if isinstance(X, CSRMatrix):
        return X.xt_dot(w)
    if isinstance(X, torch.Tensor):
        w = torch.as_tensor(np.asarray(w), dtype=X.dtype, device=X.device)
        return (X.T @ w).cpu().numpy()
    return np.asarray(X).T @ np.asarray(w)


def _tensor(a, device=None) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.array(a, dtype=np.float32))
    return t.to(device=device, dtype=torch.float32).contiguous()


@dataclasses.dataclass(frozen=True)
class GLMProblem:
    """Holds the (local or global) data and problem constants."""

    X: torch.Tensor  # (d, n)
    y: torch.Tensor  # (n,)
    loss: Loss
    lam: float

    @property
    def d(self) -> int:
        return self.X.shape[0]

    @property
    def n(self) -> int:
        return self.X.shape[1]

    @classmethod
    def create(cls, X, y, loss="logistic", lam=1e-4,
               device=None) -> "GLMProblem":
        """From numpy arrays or tensors, as f32 on ``device``. By default a
        tensor stays where it is and a numpy array goes to the card (raises
        with no card; pass ``device="cpu"`` for the plain versions)."""
        if isinstance(loss, str):
            loss = get_loss(loss)
        if device is not None or not isinstance(X, torch.Tensor):
            device = resolve_device(device)
        X = _tensor(X, device)
        return cls(X=X, y=_tensor(y, X.device), loss=loss, lam=lam)

    # -- margins -----------------------------------------------------------
    def margins(self, w: torch.Tensor) -> torch.Tensor:
        """a = X^T w, shape (n,)."""
        return self.X.T @ w

    # -- objective ---------------------------------------------------------
    def value(self, w: torch.Tensor) -> torch.Tensor:
        a = self.margins(w)
        return torch.mean(self.loss.value(a, self.y)) \
            + 0.5 * self.lam * torch.dot(w, w)

    def grad(self, w: torch.Tensor) -> torch.Tensor:
        a = self.margins(w)
        return self.X @ self.loss.d1(a, self.y) / self.n + self.lam * w

    # -- curvature ---------------------------------------------------------
    def hess_coeffs(self, w: torch.Tensor) -> torch.Tensor:
        """c_i = phi''(<w, x_i>, y_i); H = (1/n) X diag(c) X^T + lam I."""
        return self.loss.d2(self.margins(w), self.y)

    def hvp_with_coeffs(self, c: torch.Tensor,
                        u: torch.Tensor) -> torch.Tensor:
        """H u with precomputed coefficients (margins fixed across PCG),
        through the dense kernels on the card."""
        return kops.glm_hvp(self.X, c, u, self.lam)

    # -- inference ---------------------------------------------------------
    def decision_function(self, w, X=None) -> torch.Tensor:
        """Margins ``X^T w`` for new data (default: the training data), on
        the problem's device.

        ``X`` may be a dense ``(d, n_new)`` array or tensor, multiplied on
        the problem's device, or a feature-major
        :class:`repro_torch.data.sparse.CSRMatrix`, which stays sparse (one
        O(nnz) host pass, :func:`glm_margins`) and whose margins are then
        moved there: both give the same margins, as in
        ``repro.core.glm.GLMProblem.decision_function``.
        """
        from repro_torch.data.sparse import CSRMatrix

        if isinstance(X, CSRMatrix):
            w = w.cpu().numpy() if isinstance(w, torch.Tensor) \
                else np.asarray(w)
            return torch.from_numpy(glm_margins(X, w)).to(self.X.device)
        X = self.X if X is None else _tensor(X, self.X.device)
        return X.T @ _tensor(w, X.device)

    def predict(self, w, X=None) -> torch.Tensor:
        """Predicted response for a fitted ``w`` (``X`` as for
        :meth:`decision_function`).

        Classification losses ('logistic', 'squared_hinge') return +-1
        by the sign of the margin (ties break to +1); 'quadratic' and
        'huber' return the margin itself; 'poisson' returns the
        predicted mean rate ``exp(margin)`` (canonical log link).
        """
        a = self.decision_function(w, X)
        if self.loss.name in ("quadratic", "huber"):
            return a
        if self.loss.name == "poisson":
            return torch.exp(a)
        return torch.where(a >= 0, 1.0, -1.0).to(a.dtype)

    def predict_proba(self, w, X=None) -> torch.Tensor:
        """P(y = +1 | x) under the logistic model: ``sigmoid(margin)``,
        computed in float64 and cast back to the margins' dtype. Only the
        'logistic' loss has this reading; any other raises ValueError."""
        if self.loss.name != "logistic":
            raise ValueError(
                f"predict_proba needs the 'logistic' loss, problem uses "
                f"{self.loss.name!r}")
        a = self.decision_function(w, X)
        return (1.0 / (1.0 + torch.exp(-a.double()))).to(a.dtype)
