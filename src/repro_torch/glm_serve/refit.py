"""Warm-start refits: ingest new data, re-fit, hot-publish.

The port of ``repro.glm_serve.refit``. DiSCO's damped Newton started near
the solution re-converges in a few outer steps, and appending samples only
adds chunks to a samples-axis store, so a model is refreshed online:

1. **ingest**: new samples land in the
   :class:`repro_torch.data.store.ShardStore`
   (:meth:`~repro_torch.data.store.ShardStore.append_chunks`);
2. **refit**: :meth:`repro_torch.core.disco.DiscoSolver.from_store`
   streams the grown store from the served weights (``fit(w0=)``);
3. **publish**: the new :class:`DiscoResult` becomes the next registry
   version and ``ACTIVE`` flips; scoring engines pick it up between ticks.

Under a :class:`repro_torch.parallel.DistributedGroup` every rank runs the
loop: rank 0 alone appends to the store and publishes, a barrier follows
each write, and the other ranks re-read the store's header, so every
rank refits the same data from the same weights and returns the same
``(version, result)``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.disco import DiscoConfig, DiscoResult, DiscoSolver
from repro_torch.core.lambda_path import lambda_path_fit
from repro_torch.data.sparse import CSRMatrix
from repro_torch.data.store import ShardStore
from repro_torch.glm_serve.registry import ModelRegistry
from repro_torch.parallel.collectives import InProcessGroup


class RefitLoop:
    """Ingest -> warm refit -> publish, against one store and registry.

    Args:
        registry: where fitted versions are published (and where the
            warm-start weights come from).
        store: the samples-axis :class:`ShardStore` of the training data,
            grown in place by :meth:`ingest`.
        cfg: solver hyperparameters of every refit; ``cfg.partition``
            must match the store's axis (``DiscoSolver.from_store`` checks).
        group: the shards (default one), as for :class:`DiscoSolver`: an
            :class:`InProcessGroup`, or a ``DistributedGroup`` whose ranks
            all run the loop (each refit streams this rank's chunks).
        device: where the refits run (default the card; ``'cpu'`` for the
            plain versions).
    """

    def __init__(self, registry: ModelRegistry, store: ShardStore,
                 cfg: DiscoConfig, group=None, device=None):
        self.registry = registry
        self.store = store
        self.cfg = cfg
        self.group = group or InProcessGroup(1)
        self.device = device

    def ingest(self, X_new: CSRMatrix, y_new: np.ndarray) -> int:
        """Append new samples to the store; returns the new sample count.
        Nothing is re-read or re-fit until :meth:`refit`. In a
        multi-process loop rank 0 appends once no rank reads the store
        (a barrier before) and the others, after a barrier, re-read the
        header (``ShardStore`` reads it once)."""
        self.group.barrier()
        if self.group.rank == 0:
            self.store.append_chunks(X_new, y_new)
        self.group.barrier()
        if self.group.rank != 0:
            self.store = ShardStore(self.store.path,
                                    verify=self.store.verify)
        return self.store.shape[1]

    def _publish(self, result: DiscoResult, cfg: DiscoConfig,
                 activate: bool) -> int:
        """Rank 0 publishes; every rank gets the new version number."""
        version = (self.registry.publish(result, cfg, activate=activate)
                   if self.group.rank == 0 else None)
        self.group.barrier()
        return self.group.broadcast_object(version)

    def _active_w(self, warm: bool):
        if warm and self.registry.active_version() is not None:
            return self.registry.load().w
        return None

    def refit(self, warm: bool = True, activate: bool = True
              ) -> tuple[int, DiscoResult]:
        """One streamed re-fit over the store's current contents, from the
        registry's active weights (``warm=True``) or from zeros (the cold
        baseline), published and (``activate``) made active. Returns
        ``(version, result)``."""
        w0 = self._active_w(warm)
        solver = DiscoSolver.from_store(self.store, self.cfg,
                                        group=self.group, device=self.device)
        result = solver.fit(w0=w0)
        return self._publish(result, self.cfg, activate), result

    def refit_path(self, lambdas, X_val=None, y_val=None,
                   warm: bool = True, activate: bool = True):
        """Model-selection refit: sweep a λ grid, publish the winner.

        Reads the store into memory once (:meth:`ShardStore.to_csr`) and
        runs the warm-started in-memory λ-path
        (:func:`repro_torch.core.lambda_path.lambda_path_fit`) on one data
        layout. With a validation set the best λ's fit is published,
        without one the last (least regularized); ``cfg.lam`` becomes the
        winning λ for later :meth:`refit` calls. Returns ``(version,
        LambdaPathResult)``.
        """
        X, y = self.store.to_csr()
        w0 = self._active_w(warm)
        path = lambda_path_fit(X, y, lambdas, cfg=self.cfg,
                               group=self.group, device=self.device,
                               warm=warm, X_val=X_val, y_val=y_val, w0=w0)
        idx = (path.best_index if path.best_index is not None
               else len(path.results) - 1)
        best_cfg = dataclasses.replace(self.cfg, lam=path.lambdas[idx])
        version = self._publish(path.results[idx], best_cfg, activate)
        self.cfg = best_cfg
        return version, path

    def newton_iters(self, result: DiscoResult) -> int:
        """Outer (Newton) iterations a fit took, the currency of the
        warm-against-cold comparison."""
        return len(result.history)
