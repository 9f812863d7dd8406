"""State carried across from the JAX package's solver.

A JAX ``repro.core.DiscoSolver`` holds its sharded state as device arrays;
read as numpy (``np.asarray``), they become a port
:class:`repro_torch.core.disco.DiscoSolver` here, without re-running the
port's own partitioner, padding or tiling. One Newton step of each can
then be compared on identical inputs.

Arrays, by the JAX solver's attribute names (:data:`STATE_KEYS` for
sparse input, :data:`DENSE_STATE_KEYS` for dense):

* sparse, both partitions: ``ell_data``, ``ell_cols``, ``ell_dataT``,
  ``ell_colsT`` (stacked ``(m, ...)``), ``X_tau``, ``y``, ``y_tau``, and
  ``perm`` (its partition's ``_part.perm``); ``partition='samples'`` adds
  ``weights``, ``partition='features'`` adds ``smask``;
* dense, both partitions: ``X`` (the whole padded matrix), ``X_tau``,
  ``y``, ``y_tau``; ``partition='samples'`` adds ``weights``. The shard
  count is the JAX mesh's, passed as ``m``.

An iterate crosses over in the solver's internal layout (padded, in
partition order) with :func:`w_to_port`.

A JAX ``repro.core.softmax.SoftmaxSolver`` crosses over the same way
(:func:`softmax_solver_from_arrays`, :data:`SOFTMAX_STATE_KEYS`): ``X``
(the whole padded matrix), ``Y1`` (one-hot labels), ``X_tau``,
``Y1_tau``, and for ``partition='samples'`` the sample weights ``wts``.

A JAX model-zoo parameter dict (``repro.models.init_params``), read as
numpy, becomes the port's :class:`~repro_torch.models.DecoderLM` with
:func:`lm_params_from_jax`.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.disco import DiscoConfig, DiscoSolver, resolve_device
from repro_torch.core.softmax import SoftmaxConfig, SoftmaxSolver
from repro_torch.models.model import DecoderLM, check_ported
from repro_torch.parallel.collectives import InProcessGroup

_COMMON = ("ell_data", "ell_cols", "ell_dataT", "ell_colsT", "X_tau", "y",
           "y_tau")
STATE_KEYS = {"samples": _COMMON + ("weights",),
              "features": _COMMON + ("smask",)}
_DENSE = ("X", "X_tau", "y", "y_tau")
DENSE_STATE_KEYS = {"samples": _DENSE + ("weights",), "features": _DENSE}
_SOFTMAX = ("X", "Y1", "X_tau", "Y1_tau")
SOFTMAX_STATE_KEYS = {"samples": _SOFTMAX + ("wts",), "features": _SOFTMAX}


def solver_from_arrays(arrays: Mapping[str, np.ndarray],
                       shape: tuple[int, int], cfg: DiscoConfig, *,
                       m: int | None = None, device=None) -> DiscoSolver:
    """A port solver holding the given state. ``shape`` is the original
    ``(d, n)``. Dense state (an ``X`` array) is split into ``m`` shards
    (default 1); for sparse state the shard count is the leading axis of
    ``ell_data``."""
    dense = "X" in arrays
    keys = (DENSE_STATE_KEYS if dense else STATE_KEYS)[cfg.partition]
    keys_needed = keys if dense else keys + ("perm",)
    missing = [k for k in keys_needed if k not in arrays]
    if missing:
        raise KeyError(f"missing solver arrays: {missing}")
    if not dense:
        m = np.shape(arrays["ell_data"])[0]
    solver = DiscoSolver.__new__(DiscoSolver)
    solver._setup(cfg, tuple(shape), InProcessGroup(m or 1), device,
                  sparse=not dense)
    state = {k: np.asarray(arrays[k]) for k in keys}
    if dense:
        solver._load_dense_state(state)
    else:
        solver._load_state(state, np.asarray(arrays["perm"]))
    return solver


def softmax_solver_from_arrays(arrays: Mapping[str, np.ndarray],
                               shape: tuple[int, int], cfg: SoftmaxConfig,
                               *, m: int = 1, device=None) -> SoftmaxSolver:
    """A port softmax solver holding the given state (the JAX solver's
    arrays, :data:`SOFTMAX_STATE_KEYS`), split into ``m`` shards.
    ``shape`` is the original ``(d, n)``; K is ``Y1``'s width."""
    keys = SOFTMAX_STATE_KEYS[cfg.partition]
    missing = [k for k in keys if k not in arrays]
    if missing:
        raise KeyError(f"missing softmax solver arrays: {missing}")
    state = {k: np.asarray(arrays[k]) for k in keys}
    solver = SoftmaxSolver.__new__(SoftmaxSolver)
    solver._setup(cfg, tuple(shape), state["Y1"].shape[1],
                  InProcessGroup(m), device)
    solver._load_state(state)
    return solver


def w_to_port(solver: DiscoSolver, w: np.ndarray) -> torch.Tensor:
    """A reference iterate (flat, padded, partition order) as the port
    solver's iterate."""
    w = np.asarray(w, np.float32).reshape(solver._w_shape)
    return torch.from_numpy(w.copy()).to(solver.device)


def _flatten(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _to_tensor(a) -> torch.Tensor:
    """A numpy array as a tensor; bf16 (``ml_dtypes``, which
    ``torch.from_numpy`` rejects) crosses as its uint16 bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def lm_params_from_jax(cfg, params: Mapping, *, device=None) -> DecoderLM:
    """The port's model holding a JAX parameter dict's weights.

    ``params`` is the nested dict of ``repro.models.init_params`` (numpy
    or anything ``np.asarray`` reads). Its stacked arrays are split along
    their leading axis: ``params["layers"]["attn"]["wq"][i]`` becomes
    ``layers.i.attn.wq`` (``num_layers`` stacked), and a hybrid's
    ``params["shared"]["attn"]["wq"][j]`` becomes ``shared.j.attn.wq``
    (``n_shared_blocks`` stacked); ``shared_proj`` crosses whole. Every
    weight keeps the JAX ``(in, out)`` orientation, which the port's layers
    use as it is (``y = x @ w``). The model's dtype is the embedding's; an
    MoE router, a Mamba block's ``A_log`` and ``D`` and a Mamba2 block's
    ``dt_bias`` are f32 in any model. Raises on a missing, extra,
    misshapen or differently typed array (a cast would hide a bf16 router
    or ``A_log``).
    """
    check_ported(cfg)
    dev = resolve_device(device)
    stacks = {"layers": cfg.num_layers}
    if cfg.arch_type == "hybrid":
        stacks["shared"] = cfg.n_shared_blocks
    state = {}
    for path, arr in _flatten(params):
        t = _to_tensor(arr)
        n = stacks.get(path[0])
        if n is not None and len(path) > 1:
            if t.shape[0] != n:
                raise ValueError(f"{'/'.join(path)}: {t.shape[0]} stacked "
                                 f"{path[0]}, expected {n}")
            for i in range(n):
                state[".".join((path[0], str(i)) + path[1:])] = t[i]
        else:
            state[".".join(path)] = t
    emb = state.get("embed.embedding")
    model = DecoderLM(cfg, None, cfg.torch_dtype if emb is None else emb.dtype,
                      dev)
    expected = dict(model.named_parameters())
    missing = sorted(set(expected) - set(state))
    extra = sorted(set(state) - set(expected))
    if missing or extra:
        raise KeyError(f"parameter names differ: missing {missing}, "
                       f"unexpected {extra}")
    with torch.no_grad():
        for name, p in expected.items():
            if tuple(state[name].shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(state[name].shape)}, "
                                 f"expected {tuple(p.shape)}")
            if state[name].dtype != p.dtype:
                raise ValueError(f"{name}: dtype {state[name].dtype}, "
                                 f"expected {p.dtype}")
            p.copy_(state[name])
    return model
