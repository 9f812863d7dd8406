"""Runtime straggler detection and elastic re-planning (the JAX package's
``repro.robust.straggler``, the same arithmetic in numpy).

The planner (:func:`repro_torch.data.stream.plan_streams`) balances shards on
the store's *nnz header* — a proxy for per-chunk cost that is exact
when every byte costs the same. At runtime it often doesn't: a degraded
volume, a contended NIC, or a slow worker stretches some chunks by
multiples, and because every collective is a barrier the whole mesh
pays the slowest shard's time (the paper's straggler argument, now
about *observed* seconds instead of modeled nnz).

This module closes the loop:

* :class:`ChunkTimingLedger` — thread-safe per-chunk observed seconds,
  fed by the streaming pipeline as it loads (an EWMA per chunk, so the
  estimate tracks drifting conditions).
* :func:`barrier_seconds` — the modeled parallel wall-clock of one pass
  of a schedule: per step the *max* over shards (the barrier), summed
  over steps. This is what a straggler actually costs.
* :class:`ElasticReplanner` — when the observed shard imbalance of the
  current schedule exceeds ``threshold``, re-run the chunk-granular LPT
  (:func:`repro_torch.data.partition.chunk_partition`) on the *measured*
  per-chunk seconds and emit a new :class:`repro_torch.data.stream.StreamPlan`
  plus a :class:`ReplanEvent`. Chunks are movable without touching data
  (they live in the store; only the schedule and the index permutation
  change), and DiSCO's replicated PCG state makes the hand-off mid-solve
  cheap — the solver applies the swap between rounds.
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np

from repro_torch.obs import tracer as obs


def barrier_seconds(schedule: np.ndarray,
                    chunk_seconds: np.ndarray) -> float:
    """Modeled parallel wall-clock of ONE pass over ``schedule``.

    ``schedule`` is the ``(m, T)`` chunk-id grid (``-1`` = empty pad
    chunk, costing 0); ``chunk_seconds`` the per-chunk cost estimates.
    Shards work their step-``t`` chunks concurrently and the barrier
    waits for the slowest, so the pass costs ``sum_t max_s cost``.
    """
    sched = np.asarray(schedule)
    cs = np.asarray(chunk_seconds, np.float64)
    costs = np.where(sched >= 0, cs[np.clip(sched, 0, None)], 0.0)
    return float(costs.max(axis=0).sum())


class ChunkTimingLedger:
    """Thread-safe per-chunk observed-cost ledger (EWMA seconds).

    The streaming pipeline calls :meth:`observe` with each chunk's
    measured read+build seconds; the replanner reads the estimates
    back. ``alpha`` is the EWMA weight of the newest observation (1.0
    keeps only the latest sample).
    """

    def __init__(self, n_chunks: int, alpha: float = 0.5):
        self.n_chunks = int(n_chunks)
        self.alpha = float(alpha)
        self._lock = threading.Lock()
        self._ewma = np.zeros(self.n_chunks, np.float64)
        self._count = np.zeros(self.n_chunks, np.int64)

    def observe(self, cid: int, seconds: float):
        """Record one measured load of chunk ``cid``."""
        if not 0 <= cid < self.n_chunks:
            return
        with self._lock:
            if self._count[cid] == 0:
                self._ewma[cid] = seconds
            else:
                self._ewma[cid] += self.alpha * (seconds
                                                 - self._ewma[cid])
            self._count[cid] += 1

    @property
    def n_observed(self) -> int:
        """Number of distinct chunks observed at least once."""
        with self._lock:
            return int((self._count > 0).sum())

    def complete(self) -> bool:
        """True once every chunk has at least one observation."""
        return self.n_observed == self.n_chunks

    def chunk_seconds(self) -> np.ndarray:
        """(n_chunks,) per-chunk cost estimates. Chunks never observed
        are filled with the median of the observed ones (0 if none)."""
        with self._lock:
            est = self._ewma.copy()
            seen = self._count > 0
        if seen.any() and not seen.all():
            est[~seen] = float(np.median(est[seen]))
        return est

    def shard_seconds(self, schedule: np.ndarray) -> np.ndarray:
        """(m,) estimated seconds per shard for one pass of
        ``schedule`` (empty pad chunks cost 0)."""
        sched = np.asarray(schedule)
        cs = self.chunk_seconds()
        costs = np.where(sched >= 0, cs[np.clip(sched, 0, None)], 0.0)
        return costs.sum(axis=1)

    def observed_straggler(self, schedule: np.ndarray) -> float:
        """max/mean of per-shard estimated seconds — the *measured*
        twin of :func:`repro_torch.core.comm.straggler_factor` (1.0 = perfect)."""
        loads = self.shard_seconds(schedule)
        mean = loads.mean()
        return float(loads.max() / mean) if mean > 0 else 1.0

    def snapshot(self, chunks) -> np.ndarray:
        """``(2, n_chunks)`` f64: the EWMA seconds (row 0) and the
        observation counts (row 1) of ``chunks``, zeros elsewhere. The
        processes of a multi-process solve each time only the chunks they
        stream; the sum of their snapshots of their own chunks is the
        ledger one process streaming every chunk would hold, which
        :meth:`restore` then loads on every process."""
        out = np.zeros((2, self.n_chunks), np.float64)
        idx = np.asarray(chunks, np.int64)
        with self._lock:
            out[0, idx] = self._ewma[idx]
            out[1, idx] = self._count[idx]
        return out

    def restore(self, state: np.ndarray) -> None:
        """Load a :meth:`snapshot`-shaped ``(2, n_chunks)`` state."""
        with self._lock:
            self._ewma[:] = state[0]
            self._count[:] = np.rint(state[1]).astype(np.int64)

    def reset(self):
        """Forget all observations (e.g. after conditions change)."""
        with self._lock:
            self._ewma[:] = 0.0
            self._count[:] = 0


@dataclasses.dataclass(frozen=True)
class ReplanEvent:
    """Record of one elastic re-plan (kept in
    ``DiscoResult.replan_events``)."""

    outer_iter: int           # Newton iteration during which it fired
    trigger: str              # 'pcg' (between rounds) | 'outer'
    observed_straggler: float  # measured max/mean before the re-plan
    planned_straggler: float   # estimated max/mean of the new schedule
    moved_chunks: int          # chunks whose owning shard changed
    barrier_s_before: float    # modeled pass wall-clock, old schedule
    barrier_s_after: float     # modeled pass wall-clock, new schedule

    def to_dict(self) -> dict:
        """Plain-dict view (what history/registry serialization uses)."""
        return dataclasses.asdict(self)


def _chunk_owner(schedule: np.ndarray) -> dict[int, int]:
    """chunk id -> owning shard (row) of an ``(m, T)`` schedule."""
    owner = {}
    for s in range(schedule.shape[0]):
        for cid in schedule[s]:
            if cid >= 0:
                owner[int(cid)] = s
    return owner


class ElasticReplanner:
    """Watches a ledger; re-plans the stream schedule when it pays.

    Args:
        ledger: the :class:`ChunkTimingLedger` the pipeline feeds.
        threshold: fire only when the observed shard imbalance
            (max/mean seconds) of the current schedule reaches this.
        min_gain: keep the new plan only if it improves the modeled
            pass barrier time by at least this factor (guards against
            churning on noise).
        cooldown_observations: after a re-plan, wait until every chunk
            has been re-observed this many further times before firing
            again (lets the EWMA re-converge under the new schedule).
    """

    def __init__(self, ledger: ChunkTimingLedger, threshold: float = 1.5,
                 min_gain: float = 1.05, cooldown_observations: int = 1):
        self.ledger = ledger
        self.threshold = float(threshold)
        self.min_gain = float(min_gain)
        self.cooldown = int(cooldown_observations)
        self.events: list[ReplanEvent] = []
        self._obs_floor = 0

    def maybe_replan(self, plan, outer_iter: int = -1,
                     trigger: str = "pcg"):
        """Return ``(new_plan, event)`` when a re-plan pays, else None.

        ``plan`` is the current :class:`repro_torch.data.stream.StreamPlan`;
        the returned plan (built via
        :func:`repro_torch.data.stream.replan_streams`) shares the store,
        ledgers, faults and staging config — only the chunk->shard
        assignment moved. Requires a fully-observed ledger.
        """
        from repro_torch.data.stream import replan_streams

        ledger = self.ledger
        if not ledger.complete():
            return None
        with ledger._lock:
            min_count = int(ledger._count.min())
        if min_count < self._obs_floor:
            return None                      # cooling down after a swap
        observed = ledger.observed_straggler(plan.schedule)
        if observed < self.threshold:
            return None

        cs = ledger.chunk_seconds()
        # LPT balances integer cost; nanosecond resolution is plenty
        cost = np.maximum((cs * 1e9).astype(np.int64), 1)
        new_plan = replan_streams(plan, chunk_cost=cost)
        before = barrier_seconds(plan.schedule, cs)
        after = barrier_seconds(new_plan.schedule, cs)
        if after <= 0 or before / after < self.min_gain:
            return None

        old_owner = _chunk_owner(plan.schedule)
        new_owner = _chunk_owner(new_plan.schedule)
        moved = sum(1 for c, s in new_owner.items()
                    if old_owner.get(c) != s)
        loads = cost[np.clip(new_plan.schedule, 0, None)] \
            * (new_plan.schedule >= 0)
        shard = loads.sum(axis=1).astype(np.float64)
        planned = float(shard.max() / shard.mean()) \
            if shard.mean() > 0 else 1.0
        event = ReplanEvent(outer_iter=int(outer_iter), trigger=trigger,
                            observed_straggler=float(observed),
                            planned_straggler=planned,
                            moved_chunks=int(moved),
                            barrier_s_before=before,
                            barrier_s_after=after)
        self.events.append(event)
        self._obs_floor = min_count + self.cooldown
        obs.instant("robust.replan", trigger=trigger,
                    outer_iter=int(outer_iter), moved_chunks=int(moved),
                    observed_straggler=float(observed))
        return new_plan, event
