"""Start the ranks of a multi-process solve on one host.

:func:`spawn` runs ``fn(group, *args)`` in ``nproc`` new processes, each
holding a :class:`repro_torch.parallel.DistributedGroup` of rank ``r``,
and returns their results in rank order. Across hosts, start one process
a rank with ``torchrun`` and build the group with
:meth:`DistributedGroup.from_env` instead.
"""
from __future__ import annotations

import os
import pickle
import tempfile

import torch

from repro_torch.parallel.collectives import (DEFAULT_TIMEOUT_S,
                                              DistributedGroup)


class RankError(RuntimeError):
    """A rank of :func:`spawn` raised; the message holds its traceback."""


def _rank_main(rank, fn, nproc, backend, init_file, device, args, out_dir,
               timeout_s):
    # the ranks share this host: gloo talks over loopback unless told
    # otherwise
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    group = DistributedGroup(backend=backend, rank=rank, size=nproc,
                             init_method=f"file://{init_file}",
                             timeout_s=timeout_s, device=device)
    try:
        out = fn(group, *args)
    finally:
        group.close()
    path = os.path.join(out_dir, f"rank{rank}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(out, f)
    os.replace(path + ".tmp", path)


def _rank_errors(ctx, exc, nproc: int) -> str:
    """Every rank's traceback that its error file holds (the rank that
    raised first, and any peer whose collective then failed), else the
    exit that stopped the join."""
    out = []
    for r, path in enumerate(ctx.error_files):
        if os.access(path, os.R_OK):
            with open(path, "rb") as f:
                out.append(f"rank {r} of {nproc} raised:\n{pickle.load(f)}")
            os.unlink(path)
    return "\n".join(out) or f"rank {exc.error_index} of {nproc}: {exc}"


def spawn(fn, nproc: int, *, backend: str = "gloo", init_file=None,
          device=None, args=(), timeout_s: float = DEFAULT_TIMEOUT_S
          ) -> list:
    """Run ``fn(group, *args)`` on ``nproc`` ranks; their return values
    (picklable) in rank order.

    The ranks are new interpreters (``torch.multiprocessing``'s *spawn*
    start method, never fork: the caller may hold a CUDA context), so
    ``fn`` must be importable by name and ``args`` picklable. They meet at
    a ``file://`` rendezvous, ``init_file`` (a path that must not exist
    yet; default a new temporary file), which needs no TCP port. ``device``
    is each rank's device for gloo (``'cpu'``, or a card the ranks share);
    an nccl rank runs on ``cuda:rank``. When the ranks run on a card, the
    kernels are built here, once, before any rank starts. If a rank
    raises, the others are stopped and :class:`RankError` is raised here
    with the tracebacks of every rank that raised; ``timeout_s`` bounds
    every collective.
    """
    if int(nproc) < 1:
        raise ValueError(f"nproc must be >= 1, got {nproc}")
    on_card = backend == "nccl" or (
        device is not None and torch.device(device).type == "cuda")
    if on_card:
        from repro_torch.kernels import build
        build.build_kernels()
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="repro_torch_spawn_") as tmp:
        init = init_file or os.path.join(tmp, "rendezvous")
        if os.path.exists(init):
            raise ValueError(f"rendezvous file {init} exists already")
        ctx = mp.start_processes(
            _rank_main, nprocs=int(nproc), start_method="spawn", join=False,
            args=(fn, int(nproc), backend, init, device, tuple(args), tmp,
                  timeout_s))
        try:
            while not ctx.join():
                pass
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as exc:
            raise RankError(_rank_errors(ctx, exc, int(nproc))) from None
        finally:
            if init_file is not None and os.path.exists(init_file):
                os.unlink(init_file)
        out = []
        for r in range(int(nproc)):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
