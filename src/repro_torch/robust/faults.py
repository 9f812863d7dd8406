"""Deterministic, seedable fault injection (the JAX package's
``repro.robust.faults``).

A :class:`FaultPlan` *describes* the failures of one experiment (which
chunks fail transiently and how often, which chunks are slow, when to
kill the process, which named crash windows to trip) and a
:class:`FaultInjector` *executes* it: thread-safe, replayable, identical
across runs for a given plan. The hooks thread into the real code paths:

* ``on_chunk_read(cid)``: before a chunk read; injects per-chunk latency,
  raises :class:`ChunkReadError` (transient, the retry policy's food)
  and counts reads toward ``kill_after_reads``.
* ``on_outer_step(k)``: called by ``DiscoSolver.fit`` at the top of outer
  iteration ``k`` when ``solver._faults`` holds an injector; raises
  :class:`SimulatedKill` at ``kill_at_step``.
* ``crashpoint(name)``: named crash windows; raises
  :class:`SimulatedCrash` when the plan lists the name.

On-disk corruption is injected by damaging the bytes
(:func:`corrupt_chunk_file`, :func:`truncate_chunk_file`), so the shard
store's checksums are tested against real torn files. The draws are
numpy's, as in the reference, so one plan picks the same chunks in both
packages. Standard library and numpy only.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Callable, Mapping

import numpy as np


class TransientIOError(IOError):
    """Base of injected *retryable* I/O failures."""


class ChunkReadError(TransientIOError):
    """An injected transient chunk-read failure (retries recover it)."""


class ChunkCorruptionError(ValueError):
    """A chunk's stored bytes do not match its header checksum.

    Raised by :meth:`repro_torch.data.store.ShardStore.chunk_csr` on v2
    stores, naming the chunk index and field. Not a
    :class:`TransientIOError`: on-disk corruption does not heal on retry.
    """


class SimulatedKill(RuntimeError):
    """The fault plan's axe: the process is considered dead here
    (``kill_at_step`` / ``kill_after_reads``)."""


class SimulatedCrash(RuntimeError):
    """A named crash window fired (process death between two fs ops)."""


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Declarative description of one deterministic failure scenario.

    Attributes:
        seed: draws the rate-based fault assignments; two injectors
            built from equal plans behave identically.
        read_error_rate: probability (per chunk id, decided once from
            the seed, not per read) that a chunk is transient-faulty.
        read_error_attempts: how many consecutive reads of a faulty
            chunk fail before one succeeds; the counter re-arms after
            each success, so every pass exercises the retry path.
        fail_chunks: explicit faulty chunk ids (joined with the drawn
            set).
        slow_chunks: chunk id -> extra seconds before its read.
        kill_at_step: raise :class:`SimulatedKill` at the top of this
            outer iteration (0-based).
        kill_after_reads: raise :class:`SimulatedKill` once this many
            chunk reads have completed.
        crash_at: named crash windows to trip.
    """

    seed: int = 0
    read_error_rate: float = 0.0
    read_error_attempts: int = 1
    fail_chunks: frozenset[int] = frozenset()
    slow_chunks: Mapping[int, float] = dataclasses.field(
        default_factory=dict)
    kill_at_step: int | None = None
    kill_after_reads: int | None = None
    crash_at: frozenset[str] = frozenset()

    def chunk_is_faulty(self, cid: int) -> bool:
        """Whether chunk ``cid`` fails its first read(s): decided from
        ``(seed, cid)``, never from call order."""
        if cid in self.fail_chunks:
            return True
        if self.read_error_rate <= 0.0:
            return False
        u = np.random.default_rng((self.seed, int(cid))).random()
        return bool(u < self.read_error_rate)

    def chunk_delay_s(self, cid: int) -> float:
        """Injected extra latency (seconds) for chunk ``cid``."""
        return float(self.slow_chunks.get(int(cid), 0.0))


class FaultInjector:
    """Thread-safe executor of a :class:`FaultPlan`.

    One injector carries the runtime state of a plan (per-chunk failure
    counters, the global read count), so one instance is shared by
    everything taking part in one experiment. ``sleep`` is injectable so
    tests can check the latency schedule without waiting.
    """

    def __init__(self, plan: FaultPlan,
                 sleep: Callable[[float], None] = time.sleep):
        self.plan = plan
        self._sleep = sleep
        self._lock = threading.Lock()
        self._fail_counts: dict[int, int] = {}
        self.reads = 0            # completed chunk reads (all chunks)
        self.faults_injected = 0  # transient errors actually raised

    def on_chunk_read(self, cid: int):
        """Hook before reading chunk ``cid``: latency, transient failure,
        and the ``kill_after_reads`` axe, in that order."""
        plan = self.plan
        delay = plan.chunk_delay_s(cid)
        if delay > 0:
            self._sleep(delay)
        if plan.chunk_is_faulty(cid):
            with self._lock:
                n = self._fail_counts.get(cid, 0)
                if n < plan.read_error_attempts:
                    self._fail_counts[cid] = n + 1
                    self.faults_injected += 1
                    raise ChunkReadError(
                        f"injected transient read error on chunk {cid} "
                        f"(attempt {n + 1}/{plan.read_error_attempts})")
                self._fail_counts[cid] = 0       # re-arm for next pass
        with self._lock:
            self.reads += 1
            if (plan.kill_after_reads is not None
                    and self.reads >= plan.kill_after_reads):
                raise SimulatedKill(
                    f"killed after {self.reads} chunk reads")

    def on_outer_step(self, k: int):
        """Hook at the top of outer iteration ``k`` (the ``kill_at_step``
        axe)."""
        if self.plan.kill_at_step is not None \
                and k >= self.plan.kill_at_step:
            raise SimulatedKill(f"killed at outer step {k}")

    def crashpoint(self, name: str):
        """Raise :class:`SimulatedCrash` iff ``name`` is in the plan's
        ``crash_at``."""
        if name in self.plan.crash_at:
            raise SimulatedCrash(f"simulated crash at {name!r}")


def crashpoint(injector: "FaultInjector | None", name: str):
    """Trip the named crash window when an injector is present (a no-op
    without one)."""
    if injector is not None:
        injector.crashpoint(name)


# ---------------------------------------------------------------------------
# real on-disk damage (tests the checksum layer against actual bytes)
# ---------------------------------------------------------------------------

def corrupt_chunk_file(store, cid: int, field: str = "data",
                       seed: int = 0) -> int:
    """Flip one bit of one byte drawn from the back half of a stored chunk
    array's file (so the npy header stays intact and the checksum, not a
    parse error, must catch it). ``store`` exposes
    ``chunk_file_path(cid, field)``. Returns the flipped offset."""
    path = store.chunk_file_path(cid, field)
    size = os.path.getsize(path)
    off = int(np.random.default_rng(seed).integers(size // 2, size))
    with open(path, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0x40]))
    return off


def truncate_chunk_file(store, cid: int, field: str = "data",
                        drop_bytes: int = 1) -> int:
    """Chop ``drop_bytes`` off the end of a stored chunk array (a torn
    write). Returns the new size."""
    path = store.chunk_file_path(cid, field)
    size = os.path.getsize(path)
    new = max(size - int(drop_bytes), 0)
    os.truncate(path, new)
    return new
