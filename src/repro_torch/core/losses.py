"""Self-concordant loss functions for regularized ERM (paper Table 1).

Each loss operates on the margin ``a = <w, x>`` and label ``y`` and exposes
value / first / second derivatives w.r.t. the margin, which is all that GLM
gradient and Hessian computations need:

    grad f(w)  = (1/n) X phi'(X^T w, y) + lam * w
    H(w) u     = (1/n) X (phi''(X^T w, y) * (X^T u)) + lam * u

``M`` is the self-concordance parameter from Assumption 1. All functions
are elementwise torch code on tensors of any device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class Loss:
    """A scalar loss phi(a, y) on the margin with its derivatives."""

    name: str
    value: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    d1: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    d2: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    M: float  # self-concordance constant (Assumption 1)


def _quadratic_value(a, y):
    return (y - a) ** 2


def _quadratic_d1(a, y):
    return 2.0 * (a - y)


def _quadratic_d2(a, y):
    return torch.full_like(a, 2.0)


def _sq_hinge_value(a, y):
    # smooth squared hinge for y in {-1, +1}; M = 0 (piecewise quadratic)
    return torch.clamp(1.0 - y * a, min=0.0) ** 2


def _sq_hinge_d1(a, y):
    return -2.0 * y * torch.clamp(1.0 - y * a, min=0.0)


def _sq_hinge_d2(a, y):
    return 2.0 * (1.0 - y * a > 0).to(a.dtype)


def _logistic_value(a, y):
    # log(1 + exp(-y a)), numerically stable
    return torch.logaddexp(torch.zeros_like(a), -y * a)


def _logistic_d1(a, y):
    return -y * torch.sigmoid(-y * a)


def _logistic_d2(a, y):
    s = torch.sigmoid(y * a)
    return s * (1.0 - s)


def _poisson_value(a, y):
    # Poisson negative log-likelihood (up to the y!-constant), log link
    return torch.exp(a) - y * a


def _poisson_d1(a, y):
    return torch.exp(a) - y


def _poisson_d2(a, y):
    return torch.exp(a)


def make_huber(delta: float = 1.0) -> Loss:
    """Huber regression loss on the residual ``r = a - y``: quadratic
    inside ``|r| <= delta``, linear outside. Piecewise quadratic, so
    ``M = 0``."""
    d = float(delta)

    def value(a, y):
        r = a - y
        return torch.where(torch.abs(r) <= d, 0.5 * r * r,
                           d * torch.abs(r) - 0.5 * d * d)

    def d1(a, y):
        r = a - y
        return torch.where(torch.abs(r) <= d, r, d * torch.sign(r))

    def d2(a, y):
        r = a - y
        return (torch.abs(r) <= d).to(a.dtype)

    return Loss("huber", value, d1, d2, M=0.0)


QUADRATIC = Loss("quadratic", _quadratic_value, _quadratic_d1, _quadratic_d2, M=0.0)
SQUARED_HINGE = Loss("squared_hinge", _sq_hinge_value, _sq_hinge_d1, _sq_hinge_d2, M=0.0)
LOGISTIC = Loss("logistic", _logistic_value, _logistic_d1, _logistic_d2, M=1.0)
POISSON = Loss("poisson", _poisson_value, _poisson_d1, _poisson_d2, M=1.0)
HUBER = make_huber(1.0)

LOSSES = {l.name: l for l in (QUADRATIC, SQUARED_HINGE, LOGISTIC,
                              POISSON, HUBER)}


def get_loss(name: str) -> Loss:
    """Look up a :class:`Loss` by name ('quadratic' | 'squared_hinge' |
    'logistic' | 'poisson' | 'huber'); raises ValueError listing the
    options otherwise."""
    try:
        return LOSSES[name]
    except KeyError:
        raise ValueError(f"unknown loss {name!r}; available: {sorted(LOSSES)}")
