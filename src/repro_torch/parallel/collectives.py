"""Collectives over the shards of one solve.

The counterpart of the JAX package's one-axis mesh (``launch/mesh.py``)
and of ``shard_map`` + ``lax.psum``. Two groups share one interface:

* :class:`InProcessGroup` holds all ``m`` shards as tensors in this
  process on one device; its collectives are Python loops.
* :class:`DistributedGroup` is one process a shard over
  ``torch.distributed`` (gloo on the CPU, NCCL on cards), the PyTorch
  idiom for the reference's one-device-per-shard mesh.

The interface:

* ``size``: ``m``, the shards of the solve; ``rank``: this process's
  index (0 in process);
* ``local``: the global indices of the shards this process holds, in
  order: ``range(size)`` in process, ``(rank,)`` in a distributed group;
* ``all_reduce(parts)``: ``parts`` has one entry per *local* shard; the
  result is the ordered sum ``shard 0 + shard 1 + ...`` on the caller's
  device, so a given ``m`` gives the same bits in either group;
* ``all_gather(parts)``: every shard's part, stacked in shard order
  (DiSCO-F's sharded iterate at the end of a fit);
* ``barrier()``: every process reaches it before any leaves (after rank
  0 alone writes a checkpoint, a store or a registry version);
* ``broadcast_object(obj, src=0)``: rank ``src``'s picklable ``obj`` on
  every process (a checkpoint rank 0 read); in process, ``obj`` itself.

Each group counts what it moves in plain attributes (:class:`CommCounts`):
calls and floats of vector payloads and of scalar ones separately, the
all-gathers, and for a distributed group the bytes staged through host
memory and the host seconds spent inside its collectives.
"""
from __future__ import annotations

import datetime
import os
import time
from typing import Sequence

import torch

# seconds a distributed collective (and the rendezvous) waits for a peer
# before it raises: a dead or stuck rank makes the others fail, not hang
DEFAULT_TIMEOUT_S = 120.0


class CommCounts:
    """Counters of a group's collectives, plain attributes:

    ``vector_calls`` / ``vector_floats``: all-reduces of more than one
    float (floats: one part's size, as :class:`repro_torch.core.comm
    .CommLedger` counts a payload); ``scalar_calls`` / ``scalar_floats``:
    those of one; ``gather_calls`` / ``gather_floats``: all-gathers;
    ``barrier_calls``; ``broadcast_calls``: object broadcasts;
    ``staged_bytes``: bytes copied between a card and pinned host buffers
    for a gloo collective; ``seconds``: host seconds inside the transport
    (distributed groups only)."""

    FIELDS = ("vector_calls", "vector_floats", "scalar_calls",
              "scalar_floats", "gather_calls", "gather_floats",
              "barrier_calls", "broadcast_calls", "staged_bytes", "seconds")

    def reset_counts(self) -> None:
        for name in self.FIELDS:
            setattr(self, name, 0.0 if name == "seconds" else 0)

    def counts(self) -> dict:
        """The counters as a dict."""
        return {name: getattr(self, name) for name in self.FIELDS}

    def _count_reduce(self, part: torch.Tensor) -> None:
        k = part.numel()
        if k == 1:
            self.scalar_calls += 1
            self.scalar_floats += 1
        else:
            self.vector_calls += 1
            self.vector_floats += k

    def _check_parts(self, parts, what: str) -> None:
        if len(parts) != len(self.local):
            raise ValueError(
                f"{what} got {len(parts)} parts; this process holds "
                f"{len(self.local)} of the group's {self.size} shards")


class InProcessGroup(CommCounts):
    """``size`` shards living in this process on one device."""

    def __init__(self, size: int = 1):
        if int(size) < 1:
            raise ValueError(f"group size must be >= 1, got {size}")
        self.size = int(size)
        self.rank = 0
        self.local = range(self.size)
        self.reset_counts()

    def all_reduce(self, parts: Sequence[torch.Tensor] | torch.Tensor
                   ) -> torch.Tensor:
        """Sum of the per-shard ``parts`` in shard order (the identity on
        a group of one)."""
        self._check_parts(parts, "all_reduce")
        self._count_reduce(parts[0])
        out = parts[0]
        for s in range(1, self.size):
            out = out + parts[s]
        return out

    def all_gather(self, parts: Sequence[torch.Tensor] | torch.Tensor
                   ) -> torch.Tensor:
        """Every shard's part stacked in shard order: ``parts`` itself
        when it is a stacked tensor."""
        self._check_parts(parts, "all_gather")
        self.gather_calls += 1
        self.gather_floats += parts[0].numel()
        return parts if isinstance(parts, torch.Tensor) else torch.stack(
            list(parts))

    def barrier(self) -> None:
        """Nothing to wait for: one process holds every shard."""
        self.barrier_calls += 1

    def broadcast_object(self, obj, src: int = 0):
        """``obj`` itself (this process is every rank)."""
        self.broadcast_calls += 1
        return obj


class DistributedGroup(CommCounts):
    """One shard a process over ``torch.distributed``.

    ``all_reduce`` all-gathers each rank's partial and sums the ``m``
    parts on the caller's device in shard order: the same bits as
    :class:`InProcessGroup` at the same ``m`` on the same device type. It
    moves ``m`` times the bytes of a ring all-reduce to buy that
    determinism; the paper's rounds do not change.

    Backends:

    * ``'nccl'``: CUDA tensors on ``cuda:local_rank`` (the group sets that
      device current). Without a card it raises; it never carries on on
      the CPU.
    * ``'gloo'``: CPU tensors. The PyTorch documentation lists no gloo
      all-gather of CUDA tensors, so a payload on a card is copied into a
      pinned host buffer (a synchronous copy, which waits for the rank's
      queued work), gathered into one pinned ``(m, k)`` buffer and copied
      back in one asynchronous copy on the same stream (the next call's
      synchronous copy orders the buffer's reuse after it); those bytes
      are counted in ``staged_bytes``.

    ``device`` is where this rank's solve runs (for gloo: ``'cpu'`` or a
    card several ranks may share; for nccl ``cuda:local_rank``, the
    default). ``timeout_s`` bounds the rendezvous and every collective: a
    dead or stuck peer makes the others raise instead of hang.
    :meth:`close` destroys the process group.
    """

    def __init__(self, *, backend: str, rank: int, size: int,
                 init_method: str, timeout_s: float = DEFAULT_TIMEOUT_S,
                 local_rank: int | None = None, device=None):
        import torch.distributed as dist
        if backend not in ("gloo", "nccl"):
            raise ValueError(f"backend must be 'gloo' or 'nccl', got "
                             f"{backend!r}")
        if not 0 <= int(rank) < int(size):
            raise ValueError(f"rank {rank} is outside a group of {size}")
        self.backend = backend
        self.size, self.rank = int(size), int(rank)
        self.local = (self.rank,)
        self.local_rank = self.rank if local_rank is None else int(local_rank)
        if backend == "nccl":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "DistributedGroup(backend='nccl') needs a CUDA device "
                    "and none is available; use backend='gloo' for ranks "
                    "on the CPU")
            if not dist.is_nccl_available():
                raise RuntimeError("this PyTorch has no NCCL backend")
            want = torch.device("cuda", self.local_rank)
            if device is not None and torch.device(device) != want:
                raise ValueError(f"an nccl rank runs on {want}, not "
                                 f"{device}")
            torch.cuda.set_device(want)
            self.device = want
        else:
            self.device = None if device is None else torch.device(device)
        if dist.is_initialized():
            raise RuntimeError("a default process group already exists in "
                               "this process")
        dist.init_process_group(
            backend, init_method=init_method, rank=self.rank,
            world_size=self.size,
            timeout=datetime.timedelta(seconds=float(timeout_s)))
        self._staging: dict = {}
        self.reset_counts()

    @classmethod
    def from_env(cls, backend: str = "nccl",
                 timeout_s: float = DEFAULT_TIMEOUT_S,
                 device=None) -> "DistributedGroup":
        """The group of a ``torchrun`` launch: ``RANK``, ``WORLD_SIZE``
        and ``LOCAL_RANK`` name this process, ``MASTER_ADDR`` /
        ``MASTER_PORT`` the rendezvous (``env://``)."""
        env = os.environ
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                               "MASTER_PORT") if k not in env]
        if missing:
            raise RuntimeError(f"DistributedGroup.from_env needs the "
                               f"torchrun variables; {missing} unset")
        return cls(backend=backend, rank=int(env["RANK"]),
                   size=int(env["WORLD_SIZE"]), init_method="env://",
                   timeout_s=timeout_s,
                   local_rank=int(env.get("LOCAL_RANK", env["RANK"])),
                   device=device)

    def close(self) -> None:
        """Destroy the process group (the group cannot be used after)."""
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
        self._staging.clear()

    # -- transport ------------------------------------------------------
    def _pinned(self, numel: int, dtype):
        """The reused pinned host buffers of a payload shape: one to send,
        one ``(size, numel)`` to receive."""
        key = (numel, dtype)
        if key not in self._staging:
            self._staging[key] = tuple(
                torch.empty(shape, dtype=dtype, pin_memory=True)
                for shape in (numel, (self.size, numel)))
        return self._staging[key]

    def _gather(self, part: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's ``part`` (same shape on all), in rank order, on
        ``part``'s device."""
        import torch.distributed as dist
        t0 = time.perf_counter()
        flat = part.detach().reshape(-1).contiguous()
        if self.backend == "nccl" and flat.device != self.device:
            raise ValueError(f"an nccl collective takes tensors on "
                             f"{self.device}, got {flat.device}")
        if self.backend == "nccl" or flat.device.type == "cpu":
            bufs = [torch.empty_like(flat) for _ in range(self.size)]
            dist.all_gather(bufs, flat)
        else:
            send, recv = self._pinned(flat.numel(), flat.dtype)
            send.copy_(flat)      # card -> pinned host, waits for the card
            dist.all_gather(list(recv.unbind(0)), send)
            # one copy back, queued: the next call's copy above waits for
            # it before gloo writes into ``recv`` again
            bufs = list(recv.to(flat.device, non_blocking=True).unbind(0))
            self.staged_bytes += (1 + self.size) * flat.numel() \
                * flat.element_size()
        self.seconds += time.perf_counter() - t0
        return [b.reshape(part.shape) for b in bufs]

    # -- the interface -------------------------------------------------
    def all_reduce(self, parts: Sequence[torch.Tensor] | torch.Tensor
                   ) -> torch.Tensor:
        """Sum over all ranks of this rank's one part, in shard order:
        an all-gather of the partials, then ``shard 0 + shard 1 + ...``
        on the caller's device."""
        self._check_parts(parts, "all_reduce")
        self._count_reduce(parts[0])
        got = self._gather(parts[0])
        out = got[0]
        for s in range(1, self.size):
            out = out + got[s]
        return out

    def all_gather(self, parts: Sequence[torch.Tensor] | torch.Tensor
                   ) -> torch.Tensor:
        """Every rank's part stacked in shard order, ``(size, ...)``."""
        self._check_parts(parts, "all_gather")
        self.gather_calls += 1
        self.gather_floats += parts[0].numel()
        return torch.stack(self._gather(parts[0]))

    def barrier(self) -> None:
        """Wait until every rank has called it (gloo's barrier, or
        NCCL's on this rank's card)."""
        import torch.distributed as dist
        t0 = time.perf_counter()
        self.barrier_calls += 1
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.local_rank])
        else:
            dist.barrier()
        self.seconds += time.perf_counter() - t0

    def broadcast_object(self, obj, src: int = 0):
        """Rank ``src``'s ``obj`` (picklable) on every rank, through
        ``torch.distributed.broadcast_object_list``; the other ranks'
        ``obj`` is ignored."""
        import torch.distributed as dist
        t0 = time.perf_counter()
        self.broadcast_calls += 1
        box = [obj if self.rank == src else None]
        dist.broadcast_object_list(
            box, src=src,
            device=self.device if self.backend == "nccl" else None)
        self.seconds += time.perf_counter() - t0
        return box[0]


def local_slice(group) -> slice:
    """The shards ``group.local`` as one slice of the shard axis (a
    process holds a run of consecutive shards)."""
    local = list(group.local)
    if local != list(range(local[0], local[-1] + 1)):
        raise ValueError(f"local shards {local} are not consecutive")
    return slice(local[0], local[-1] + 1)

