"""State carried across from the JAX package's solver.

A JAX ``repro.core.DiscoSolver`` holds its sharded state as device arrays;
read as numpy (``np.asarray``), they become a port
:class:`repro_torch.core.disco.DiscoSolver` here, without re-running the
port's own partitioner and tiling. One Newton step of each can then be
compared on identical inputs.

Arrays, by the JAX solver's attribute names:

* both partitions: ``ell_data``, ``ell_cols``, ``ell_dataT``,
  ``ell_colsT`` (stacked ``(m, ...)``), ``X_tau``, ``y``, ``y_tau``, and
  ``perm`` (its partition's ``_part.perm``);
* ``partition='samples'``: ``weights``; ``partition='features'``:
  ``smask``.

An iterate crosses over in the solver's internal layout (padded, in
partition order) with :func:`w_to_port`.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.disco import DiscoConfig, DiscoSolver
from repro_torch.parallel.collectives import InProcessGroup

_COMMON = ("ell_data", "ell_cols", "ell_dataT", "ell_colsT", "X_tau", "y",
           "y_tau")
STATE_KEYS = {"samples": _COMMON + ("weights",),
              "features": _COMMON + ("smask",)}


def solver_from_arrays(arrays: Mapping[str, np.ndarray],
                       shape: tuple[int, int], cfg: DiscoConfig, *,
                       device=None) -> DiscoSolver:
    """A port solver holding the given state. ``shape`` is the original
    ``(d, n)``; the shard count is the leading axis of ``ell_data``."""
    keys = STATE_KEYS[cfg.partition]
    missing = [k for k in keys + ("perm",) if k not in arrays]
    if missing:
        raise KeyError(f"missing solver arrays: {missing}")
    solver = DiscoSolver.__new__(DiscoSolver)
    group = InProcessGroup(np.shape(arrays["ell_data"])[0])
    solver._setup(cfg, tuple(shape), group, device)
    solver._load_state({k: np.asarray(arrays[k]) for k in keys},
                       np.asarray(arrays["perm"]))
    return solver


def w_to_port(solver: DiscoSolver, w: np.ndarray) -> torch.Tensor:
    """A reference iterate (flat, padded, partition order) as the port
    solver's iterate."""
    w = np.asarray(w, np.float32).reshape(solver._w_shape)
    return torch.from_numpy(w.copy()).to(solver.device)
