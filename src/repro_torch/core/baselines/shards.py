"""A dense ``(d, n)`` problem split by samples over the shards of an
:class:`~repro_torch.parallel.InProcessGroup`, as the baselines take it.

The sample axis is zero-padded to a multiple of ``m``; padded samples
carry weight 0 (the JAX package's ``pad_to_multiple`` + weights). Each
shard is a column view of the one device matrix.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.disco import _to_device, resolve_device
from repro_torch.parallel.collectives import InProcessGroup
from repro_torch.utils.padding import pad_to_multiple


@dataclasses.dataclass
class SampleShards:
    X: torch.Tensor        # (d, n_padded), f32 on the device
    y: torch.Tensor        # (m, n_loc) labels, 0 in the padding
    wts: torch.Tensor      # (m, n_loc) 1 for real samples, 0 for padding
    locs: list             # m column views (d, n_loc) of X
    group: InProcessGroup
    n: int                 # real samples

    @property
    def d(self) -> int:
        return self.X.shape[0]

    @property
    def m(self) -> int:
        return self.group.size

    @property
    def n_loc(self) -> int:
        return self.y.shape[1]

    @classmethod
    def create(cls, X, y, group: InProcessGroup | None, device
               ) -> "SampleShards":
        """``X`` a dense (d, n) numpy array or tensor, ``y`` (n,);
        ``device`` None means the card."""
        group = group or InProcessGroup(1)
        m = group.size
        dev = resolve_device(device)
        if not isinstance(X, torch.Tensor):
            X = np.asarray(X)
        if isinstance(y, torch.Tensor):
            y = y.detach().cpu().numpy()
        y = np.asarray(y, np.float32)
        if len(X.shape) != 2 or y.shape != (X.shape[1],):
            raise ValueError("X must be (d, n), y (n,)")
        n = X.shape[1]
        Xp, _ = pad_to_multiple(_to_device(X, dev), 1, m)
        yp, npad = pad_to_multiple(y, 0, m)
        wts = np.pad(np.ones(n, np.float32), (0, npad))
        n_loc = Xp.shape[1] // m
        return cls(X=Xp, y=_to_device(yp, dev).reshape(m, n_loc),
                   wts=_to_device(wts, dev).reshape(m, n_loc),
                   locs=[Xp[:, s * n_loc:(s + 1) * n_loc] for s in range(m)],
                   group=group, n=n)

    def _margins_value(self, loss, lam: float, w: torch.Tensor):
        a = [loc.T @ w for loc in self.locs]
        fval = self.group.all_reduce(
            [torch.sum(loss.value(a[s], self.y[s]) * self.wts[s])
             for s in range(self.m)]) / self.n + 0.5 * lam * torch.dot(w, w)
        return a, fval

    def value(self, loss, lam: float, w: torch.Tensor) -> torch.Tensor:
        """f(w) of the regularized problem (one scalar all-reduce)."""
        return self._margins_value(loss, lam, w)[1]

    def objective(self, loss, lam: float, w: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
        """(gradient, f) at ``w``: the gradient's one d-vector all-reduce
        and the loss sum's scalar one."""
        a, fval = self._margins_value(loss, lam, w)
        g = self.group.all_reduce(
            [self.locs[s] @ (loss.d1(a[s], self.y[s]) * self.wts[s])
             for s in range(self.m)]) / self.n + lam * w
        return g, fval
