"""Micro-batching scheduler: slot-based continuous batching for scoring.

The port of ``repro.glm_serve.scheduler``. A "slot" is a row of the
packed request batch; a tick

1. **admits** up to ``engine.batch`` waiting requests, in submission
   order, after ``engine.maybe_reload()`` has swapped in a freshly
   published registry version (between ticks, so every slot of a batch
   scores against one ``w``); a request whose deadline has passed is
   rejected instead of taking a slot;
2. **scores** the admitted batch with one K1 launch (short batches ride
   as padding rows);
3. **completes** every admitted request, recording its end-to-end latency
   in the :class:`ServeStats` ledger (p50 / p99 and throughput).

Scoring is one-shot, so there is no state across ticks beyond the queue,
the deadline policy and the latency ledger.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Optional

import numpy as np

from repro_torch.glm_serve.scoring import ScoreRequest, ScoringEngine
from repro_torch.obs import tracer as obs


@dataclasses.dataclass
class ScoredCompletion:
    """Outcome of one request: margin and timing (or a deadline miss)."""

    margin: float | None        # None iff rejected
    latency_s: float            # submit -> completion (or rejection)
    tick: int                   # tick the request completed on
    rejected: bool = False      # True = deadline passed before scoring


@dataclasses.dataclass
class ServeStats:
    """Latency / throughput ledger of a scheduler run.

    ``latencies_s`` holds one entry per *scored* request (rejections are
    counted apart), the most recent ``LATENCY_WINDOW`` of them.
    """

    LATENCY_WINDOW = 100_000

    completed: int = 0
    rejected: int = 0
    ticks: int = 0
    busy_s: float = 0.0                     # time spent inside score()
    latencies_s: deque = dataclasses.field(
        default_factory=lambda: deque(maxlen=ServeStats.LATENCY_WINDOW))

    def percentile(self, q: float) -> float:
        """Latency percentile in seconds (q in [0, 100]); 0.0 if empty."""
        if not self.latencies_s:
            return 0.0
        return float(np.percentile(np.asarray(self.latencies_s), q))

    @property
    def p50_s(self) -> float:
        """Median end-to-end request latency in seconds."""
        return self.percentile(50.0)

    @property
    def p99_s(self) -> float:
        """99th-percentile end-to-end request latency in seconds."""
        return self.percentile(99.0)

    def throughput_rps(self, elapsed_s: float) -> float:
        """Scored requests per second over a measured wall-clock span."""
        return self.completed / elapsed_s if elapsed_s > 0 else 0.0


@dataclasses.dataclass
class _Waiting:
    rid: int
    req: ScoreRequest
    t_submit: float
    deadline: Optional[float]   # absolute clock time, None = no deadline


class MicroBatchScheduler:
    """Deadline-aware continuous micro-batching over a scoring engine.

    Args:
        engine: the :class:`ScoringEngine` whose ``batch`` is the slot
            count a tick.
        clock: the time source (tests pass a fake clock).
    """

    def __init__(self, engine: ScoringEngine,
                 clock: Callable[[], float] = time.perf_counter):
        self.engine = engine
        self.clock = clock
        self.waiting: deque[_Waiting] = deque()
        self.finished: dict[int, ScoredCompletion] = {}
        self.stats = ServeStats()
        self._next_id = 0

    def submit(self, req: ScoreRequest,
               deadline_s: float | None = None) -> int:
        """Enqueue a request; ``deadline_s`` is relative to now.

        A malformed request (feature ids out of range, duplicated, or not
        as many as values) raises here, back to its submitter, so it never
        fails a tick's batch. Returns the request id, the key into
        ``finished``.
        """
        self.engine.packer.validate(req)
        rid = self._next_id
        self._next_id += 1
        now = self.clock()
        self.waiting.append(_Waiting(
            rid=rid, req=req, t_submit=now,
            deadline=None if deadline_s is None else now + deadline_s))
        return rid

    def tick(self) -> int:
        """One scheduling step; returns the number of requests scored.

        Traced as a ``serve.tick`` span (``scored=`` set after scoring),
        with the ``serve.scored`` counter and the ``serve.queue_depth`` /
        ``serve.ticks`` gauges.
        """
        obs.gauge("serve.queue_depth", len(self.waiting))
        with obs.span("serve.tick", tick=self.stats.ticks) as sp:
            scored = self._tick()
            sp.set(scored=scored)
        if scored:
            obs.count("serve.scored", scored)
        obs.gauge("serve.ticks", self.stats.ticks)
        return scored

    def _tick(self) -> int:
        self.engine.maybe_reload()
        now = self.clock()
        batch: list[_Waiting] = []
        while self.waiting and len(batch) < self.engine.batch:
            item = self.waiting.popleft()
            if item.deadline is not None and now > item.deadline:
                self.finished[item.rid] = ScoredCompletion(
                    margin=None, latency_s=now - item.t_submit,
                    tick=self.stats.ticks, rejected=True)
                self.stats.rejected += 1
                continue
            batch.append(item)
        if not batch:
            return 0
        t0 = self.clock()
        margins = self.engine.score([b.req for b in batch])
        t1 = self.clock()
        self.stats.busy_s += t1 - t0
        for b, a in zip(batch, margins):
            self.finished[b.rid] = ScoredCompletion(
                margin=float(a), latency_s=t1 - b.t_submit,
                tick=self.stats.ticks)
            self.stats.completed += 1
            self.stats.latencies_s.append(t1 - b.t_submit)
        self.stats.ticks += 1
        return len(batch)

    def take_finished(self) -> dict[int, ScoredCompletion]:
        """Drain and return the completion map (a long-running loop must
        collect completions, which are kept until taken)."""
        out = self.finished
        self.finished = {}
        return out

    def run_until_done(self, max_ticks: int = 10_000
                       ) -> dict[int, ScoredCompletion]:
        """Tick until the queue drains (or ``max_ticks``); returns the
        completion map keyed by request id."""
        while self.waiting and self.stats.ticks < max_ticks:
            self.tick()
        return self.finished
