"""A dense ``(d, n)`` problem split by samples over the shards of a group
(:mod:`repro_torch.parallel`), as the baselines take it.

The sample axis is zero-padded to a multiple of ``m``; padded samples
carry weight 0 (the JAX package's ``pad_to_multiple`` + weights). A
process keeps only the shards it holds (``group.local``): each is a
column view of its one device block.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.disco import _to_device, resolve_device
from repro_torch.parallel.collectives import InProcessGroup, local_slice
from repro_torch.utils.padding import pad_to_multiple


@dataclasses.dataclass
class SampleShards:
    X: torch.Tensor        # (d, nl * n_loc) the local shards' columns, f32
    y: torch.Tensor        # (nl, n_loc) labels, 0 in the padding
    wts: torch.Tensor      # (nl, n_loc) 1 for real samples, 0 for padding
    locs: list             # nl column views (d, n_loc) of X
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

    @staticmethod
    def pad(X, y, m: int, device):
        """The whole problem padded to ``m`` shards on ``device`` (None
        means the card): ``(Xp (d, n_padded), yp, wts (n_padded,), n)``.
        ``X`` a dense (d, n) numpy array or tensor, ``y`` (n,)."""
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
        return Xp, _to_device(yp, dev), _to_device(wts, dev), n

    @classmethod
    def create(cls, X, y, group: InProcessGroup | None, device,
               padded=None) -> "SampleShards":
        """This process's shards of ``X`` (d, n), ``y`` (n,); ``padded``
        is :meth:`pad`'s result when the caller already made it (to
        compute something of the whole problem first)."""
        group = group or InProcessGroup(1)
        m, lo, nl = group.size, local_slice(group), len(group.local)
        Xp, yp, wts, n = padded or cls.pad(X, y, m, device)
        n_loc = Xp.shape[1] // m
        if nl < m:
            Xp = Xp[:, lo.start * n_loc:lo.stop * n_loc].contiguous()
        return cls(X=Xp, y=yp.reshape(m, n_loc)[lo],
                   wts=wts.reshape(m, n_loc)[lo],
                   locs=[Xp[:, s * n_loc:(s + 1) * n_loc]
                         for s in range(nl)],
                   group=group, n=n)

    def _margins_value(self, loss, lam: float, w: torch.Tensor):
        a = [loc.T @ w for loc in self.locs]
        fval = self.group.all_reduce(
            [torch.sum(loss.value(a[s], self.y[s]) * self.wts[s])
             for s in range(len(self.locs))]) / self.n \
            + 0.5 * lam * torch.dot(w, w)
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
             for s in range(len(self.locs))]) / self.n + lam * w
        return g, fval
