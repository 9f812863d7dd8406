"""Model registry: versioned, atomically published DiSCO fits.

The port of ``repro.glm_serve.registry``, with the same on-disk format, so
a version published by either package loads in the other (``w`` bit for
bit, the :class:`DiscoConfig` and :class:`DiscoResult` field for field):

::

    registry/
      versions/
        v000001/
          model.json     header: format version, DiscoConfig, history,
                         ledger, partition_info, stream_stats, converged
          w.npy          the weight vector, byte-exact
        v000002/ ...
      ACTIVE             text file naming the active version

Two invariants make a hot swap safe under concurrent readers:

* **Atomic publish**: a version is staged under a temporary name, every
  staged file and the staged directory fsync'd, and only then renamed
  into ``versions/`` (the parent fsync'd after), so a reader never sees a
  half-written version, even across power loss. ``ACTIVE`` is replaced
  with ``os.replace`` after its temporary file is fsync'd.
* **Immutability**: a published version is never modified; a refit
  (:mod:`repro_torch.glm_serve.refit`) publishes a new one and flips
  ``ACTIVE``; scoring engines poll :meth:`ModelRegistry.active_version`
  between ticks.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil

import numpy as np

from repro_torch.core.comm import CommLedger
from repro_torch.core.disco import DiscoConfig, DiscoResult
from repro_torch.obs import tracer as obs
from repro_torch.robust.checkpoint import fsync_dir, fsync_file
from repro_torch.robust.faults import crashpoint

REGISTRY_VERSION = 1
_VERSIONS = "versions"
_ACTIVE = "ACTIVE"
_MODEL = "model.json"
_WEIGHTS = "w.npy"


@dataclasses.dataclass(frozen=True)
class PublishedModel:
    """One registry version, loaded: the fitted weights and provenance."""

    version: int              # registry version id (1-based, monotone)
    w: np.ndarray             # (d,) weights, byte-exact round trip
    cfg: DiscoConfig          # the solve's hyperparameters
    result: DiscoResult       # the whole training outcome

    @property
    def d(self) -> int:
        """Feature dimension of the model."""
        return int(self.w.shape[0])


def _vdir(path: str, version: int) -> str:
    return os.path.join(path, _VERSIONS, f"v{version:06d}")


class ModelRegistry:
    """Directory-backed model registry with atomic publish and hot swap.

    ``ModelRegistry(path)`` opens (creating if absent) a registry;
    ``publish(result, cfg)`` snapshots a fit as the next version and flips
    ``ACTIVE``; ``load()`` reads the active version, ``load(version=v)``
    any published one.

    ``fault_injector`` (tests only, a
    :class:`repro_torch.robust.FaultInjector`) trips the crash windows
    ``"publish:staged"`` (staged and fsync'd, before the rename),
    ``"publish:renamed"`` (after the rename, before the flip) and
    ``"activate:staged"`` (the pointer's temporary file written, before
    ``os.replace``).
    """

    def __init__(self, path: str, fault_injector=None):
        self.path = path
        self._faults = fault_injector
        os.makedirs(os.path.join(path, _VERSIONS), exist_ok=True)

    def versions(self) -> list[int]:
        """Sorted ids of all published versions."""
        out = []
        for name in os.listdir(os.path.join(self.path, _VERSIONS)):
            if name.startswith("v") and name[1:].isdigit():
                out.append(int(name[1:]))
        return sorted(out)

    def active_version(self) -> int | None:
        """Id of the active version, or None before the first publish."""
        try:
            with open(os.path.join(self.path, _ACTIVE)) as f:
                return int(f.read().strip())
        except FileNotFoundError:
            return None

    def publish(self, result: DiscoResult, cfg: DiscoConfig,
                activate: bool = True) -> int:
        """Snapshot a fit as the next version; optionally flip ACTIVE.
        Returns the new version id (a ``registry.publish`` span)."""
        with obs.span("registry.publish", activate=activate) as sp:
            return self._publish(result, cfg, activate, sp)

    def _publish(self, result: DiscoResult, cfg: DiscoConfig,
                 activate: bool, sp) -> int:
        vs = self.versions()
        version = (vs[-1] + 1) if vs else 1
        sp.set(version=version)
        final = _vdir(self.path, version)
        versions_dir = os.path.join(self.path, _VERSIONS)
        tmp = os.path.join(versions_dir, f".tmp-{version:06d}")
        if os.path.isdir(tmp):            # a stage left by a crash
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.save(os.path.join(tmp, _WEIGHTS), np.asarray(result.w))
        header = dict(
            format_version=REGISTRY_VERSION,
            version=version,
            cfg=dataclasses.asdict(cfg),
            converged=bool(result.converged),
            history=result.history,
            ledger=dict(rounds=result.ledger.rounds,
                        floats=result.ledger.floats,
                        spmd_collectives=result.ledger.spmd_collectives),
            partition_info=result.partition_info,
            stream_stats=result.stream_stats,
            replan_events=list(result.replan_events),
        )
        with open(os.path.join(tmp, _MODEL), "w") as f:
            json.dump(header, f, indent=1, default=float)
            f.flush()
            os.fsync(f.fileno())
        fsync_file(os.path.join(tmp, _WEIGHTS))
        fsync_dir(tmp)
        crashpoint(self._faults, "publish:staged")
        os.rename(tmp, final)
        fsync_dir(versions_dir)
        crashpoint(self._faults, "publish:renamed")
        if activate:
            self.activate(version)
        return version

    def activate(self, version: int):
        """Atomically point ACTIVE at a published version (hot swap); the
        flip is durable: a crash leaves ACTIVE naming the old or the new
        version, never a torn pointer."""
        if not os.path.isdir(_vdir(self.path, version)):
            raise ValueError(f"no published version {version} in "
                             f"{self.path!r}")
        tmp = os.path.join(self.path, f".{_ACTIVE}.tmp")
        with open(tmp, "w") as f:
            f.write(f"{version}\n")
            f.flush()
            os.fsync(f.fileno())
        crashpoint(self._faults, "activate:staged")
        os.replace(tmp, os.path.join(self.path, _ACTIVE))
        fsync_dir(self.path)

    def load(self, version: int | None = None) -> PublishedModel:
        """Load a version (default: the active one): the weights bit for
        bit as published, the :class:`DiscoConfig` and a
        :class:`DiscoResult` equal to the published one field for field."""
        if version is None:
            version = self.active_version()
            if version is None:
                raise ValueError(f"registry {self.path!r} has no active "
                                 "version (nothing published yet)")
        vdir = _vdir(self.path, version)
        with open(os.path.join(vdir, _MODEL)) as f:
            header = json.load(f)
        if header.get("format_version") != REGISTRY_VERSION:
            raise ValueError(
                f"version {version} has format "
                f"{header.get('format_version')!r}; this reader supports "
                f"format {REGISTRY_VERSION}")
        w = np.load(os.path.join(vdir, _WEIGHTS))
        cfg = DiscoConfig(**header["cfg"])
        led = header["ledger"]
        result = DiscoResult(
            w=w,
            history=header["history"],
            ledger=CommLedger(rounds=int(led["rounds"]),
                              floats=int(led["floats"]),
                              spmd_collectives=int(led["spmd_collectives"])),
            converged=bool(header["converged"]),
            partition_info=header["partition_info"],
            stream_stats=header["stream_stats"],
            replan_events=list(header.get("replan_events", [])))
        return PublishedModel(version=int(version), w=w, cfg=cfg,
                              result=result)
