"""In-process tracing and metrics plane of the port.

One process-wide tracer records **spans** (named, nestable, monotonic-
clock timed, thread-attributed), **instants** (zero-duration marks),
**counters** (monotonic sums) and **gauges** (last-value samples). The
vocabulary is the JAX package's (``repro.obs.tracer``): the same kind
names, layers and event types, so a trace from either package reads the
same. A description is the port's own where the port differs.

Contract:

* **Near-zero overhead when disabled.** The module-level ``span`` /
  ``instant`` / ``count`` / ``gauge`` functions delegate to a process
  global that defaults to :class:`NoopTracer`, whose ``span`` returns a
  cached do-nothing context manager: a disabled site costs two attribute
  lookups and a no-op call. No site touches the device: with tracing on
  or off, no host sync, launch or device allocation is added.
* **Host clocks only.** Spans read ``time.perf_counter_ns``. On the card
  a span that ends before a sync would time only the enqueue of its
  kernels, so no span wraps a kernel launch; ``newton.outer`` ends after
  the step's ``float()`` reads, which wait for the step's device work.
* **Thread safety.** Events are appended under a lock with the emitting
  thread's id and name.
* **A closed vocabulary.** Every span/instant kind must be registered in
  :data:`SPAN_KINDS` (counters in :data:`COUNTER_KINDS`, gauges in
  :data:`GAUGE_KINDS`); an unknown name raises when tracing is on.

Enable with ``REPRO_TRACE=1`` in the environment (read at import), with
``DiscoConfig(trace=True)`` (the solver calls :func:`enable` at
construction), or with :func:`enable`. Enabling is global and sticky:
call :func:`disable` to stop.
"""
from __future__ import annotations

import os
import threading
import time
from typing import NamedTuple

# ---------------------------------------------------------------------------
# the registry: every kind an instrumentation site may emit
# ---------------------------------------------------------------------------

#: span / instant registry: kind -> (layer, event type, description).
#: ``span`` kinds carry a duration; ``instant`` kinds are zero-duration
#: marks.
SPAN_KINDS: dict[str, tuple[str, str, str]] = {
    "newton.outer": (
        "core", "span",
        "one damped-Newton outer iteration (the step's launches + the "
        "float() reads that wait for them)"),
    "pcg.round": (
        "core", "span",
        "one host-driven streamed PCG round (classic iteration or "
        "s-step block), synced to completion"),
    "comm.allreduce": (
        "core", "instant",
        "one paper-style communication round, emitted at the call site "
        "of the streamed path (outer margins/gradient + per PCG round)"),
    "hvp.apply": (
        "core", "span",
        "one streamed Hessian-vector product (a full prefetched pass "
        "over the store; `multi` marks the batched s-step form)"),
    "hvp.dispatch": (
        "core", "instant",
        "HVP operator registry cell resolved at solver setup "
        "(core/hvp.py cell id in `cell`)"),
    "kernel.dispatch": (
        "kernels", "instant",
        "kernel dispatch resolved by the tensors' device (`mode`: "
        "'cuda' = the hand-written kernels, 'plain' = their plain "
        "PyTorch versions on the CPU), once per distinct mode a tracer "
        "sees"),
    "stream.pass": (
        "data", "span",
        "one prefetched pass of the chunk schedule (label = stream "
        "kind, `+hvp` for mixed-precision HVP staging)"),
    "stream.chunk_load": (
        "data", "span",
        "one chunk read + ELL tile build in the prefetch producer "
        "thread (args: cid, shard, layouts)"),
    "store.chunk_read": (
        "data", "span",
        "one ShardStore CSR chunk materialized (memmap open + optional "
        "CRC32 verification)"),
    "io.retry": (
        "robust", "instant",
        "a transient I/O failure caught by the retry policy (args: "
        "attempt index, error type)"),
    "ckpt.write": (
        "robust", "span",
        "one atomic checkpoint snapshot write (stage + fsync + rename "
        "protocol of robust/checkpoint.py)"),
    "robust.replan": (
        "robust", "instant",
        "an elastic re-plan fired: the chunk->shard schedule was "
        "swapped on measured seconds"),
    "registry.publish": (
        "serve", "span",
        "one model registry version staged, fsync'd, renamed and "
        "(optionally) activated"),
    "serve.hot_swap": (
        "serve", "span",
        "the scoring engine swapped in a newly activated registry "
        "version between ticks"),
    "serve.tick": (
        "serve", "span",
        "one scheduler tick: admit -> score -> complete (args: tick "
        "index, scored count)"),
}

#: counter registry: name -> description. Counters are monotone sums.
COUNTER_KINDS: dict[str, str] = {
    "comm.rounds": (
        "paper-style communication rounds. In-memory solves tally the "
        "analytic per-iteration cost, which must equal "
        "CommLedger.rounds"),
    "comm.floats": "floats communicated (analytic tally)",
    "comm.spmd_collectives": "collective launches (analytic tally)",
    "io.retries": "transient I/O failures retried by the retry policy",
    "serve.scored": "requests scored by the micro-batch scheduler",
}

#: gauge registry: name -> description. Gauges record last-value samples.
GAUGE_KINDS: dict[str, str] = {
    "serve.queue_depth": (
        "scheduler waiting-queue depth, sampled at the top of each "
        "tick"),
    "serve.ticks": "scheduler ticks completed so far",
}

_REGISTRY_NAMES = {"span kind": "SPAN_KINDS", "counter": "COUNTER_KINDS",
                   "gauge": "GAUGE_KINDS"}


class TraceEvent(NamedTuple):
    """One recorded trace event.

    ``ph`` is ``'X'`` (complete span) or ``'i'`` (instant), the Chrome
    trace-event phases the exporter emits; times are
    ``time.perf_counter_ns()`` values (monotonic).
    """

    kind: str
    ph: str            # 'X' span | 'i' instant
    t0_ns: int         # span start (or instant time), perf_counter_ns
    dur_ns: int        # span duration (0 for instants)
    tid: int           # emitting thread id
    thread: str        # emitting thread name
    args: dict


def _check(kind: str, registry: dict, what: str) -> None:
    if kind not in registry:
        raise ValueError(
            f"unregistered {what} {kind!r}: add it to "
            f"repro_torch.obs.tracer.{_REGISTRY_NAMES[what]}")


class _NoopSpan:
    """The cached do-nothing context manager of the disabled fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args):
        """No-op twin of :meth:`Span.set`."""


_NOOP_SPAN = _NoopSpan()


class NoopTracer:
    """Disabled tracer: every operation is a no-op.

    ``span`` returns one cached :class:`_NoopSpan` instance, so an
    instrumented ``with`` block costs only the context-manager protocol.
    """

    enabled = False

    def span(self, kind: str, **args) -> "_NoopSpan":
        """Return the cached no-op span."""
        return _NOOP_SPAN

    def instant(self, kind: str, **args) -> None:
        """Drop an instant event."""

    def complete(self, kind: str, t0_ns: int, **args) -> None:
        """Drop an explicit-start span."""

    def count(self, name: str, value: float = 1) -> None:
        """Drop a counter increment."""

    def gauge(self, name: str, value: float) -> None:
        """Drop a gauge sample."""


class Span:
    """A live span: records one ``'X'`` event when its ``with`` exits.

    Spans nest (enter/exit order is the nesting); :meth:`set` attaches
    args that are only known inside the block.
    """

    __slots__ = ("_tracer", "_kind", "_args", "_t0")

    def __init__(self, tracer: "Tracer", kind: str, args: dict):
        self._tracer = tracer
        self._kind = kind
        self._args = args
        self._t0 = 0

    def __enter__(self) -> "Span":
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        self._tracer._record(self._kind, "X", self._t0, t1 - self._t0,
                             self._args)
        return False

    def set(self, **args) -> None:
        """Merge ``args`` into the span's args."""
        self._args.update(args)


class Tracer:
    """Thread-safe in-process tracer (the enabled implementation).

    Events accumulate in :attr:`events` (a list of :class:`TraceEvent`),
    counters in :attr:`counters` and gauges in :attr:`gauges`; read them
    directly, through :meth:`snapshot`, or through
    :mod:`repro_torch.obs.export` / :mod:`repro_torch.obs.report`. All
    mutation happens under one lock.
    """

    enabled = True

    def __init__(self):
        self._lock = threading.Lock()
        self.events: list[TraceEvent] = []
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self.epoch_ns = time.perf_counter_ns()

    def _record(self, kind: str, ph: str, t0_ns: int, dur_ns: int,
                args: dict) -> None:
        th = threading.current_thread()
        ev = TraceEvent(kind=kind, ph=ph, t0_ns=t0_ns, dur_ns=dur_ns,
                        tid=th.ident or 0, thread=th.name,
                        args=dict(args))
        with self._lock:
            self.events.append(ev)

    def span(self, kind: str, **args) -> Span:
        """Open a span of a registered kind; use as a context manager."""
        _check(kind, SPAN_KINDS, "span kind")
        return Span(self, kind, args)

    def instant(self, kind: str, **args) -> None:
        """Record a zero-duration mark of a registered kind."""
        _check(kind, SPAN_KINDS, "span kind")
        self._record(kind, "i", time.perf_counter_ns(), 0, args)

    def complete(self, kind: str, t0_ns: int, **args) -> None:
        """Record a span whose start ``t0_ns`` (``perf_counter_ns``) the
        caller captured, for spans that cannot be a ``with`` block."""
        _check(kind, SPAN_KINDS, "span kind")
        t1 = time.perf_counter_ns()
        self._record(kind, "X", t0_ns, t1 - t0_ns, args)

    def count(self, name: str, value: float = 1) -> None:
        """Add ``value`` to a registered counter."""
        _check(name, COUNTER_KINDS, "counter")
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + value

    def gauge(self, name: str, value: float) -> None:
        """Sample a registered gauge (last value wins)."""
        _check(name, GAUGE_KINDS, "gauge")
        with self._lock:
            self.gauges[name] = value

    def span_count(self, kind: str) -> int:
        """Number of recorded events (spans + instants) of ``kind``."""
        with self._lock:
            return sum(1 for e in self.events if e.kind == kind)

    def snapshot(self) -> tuple[list[TraceEvent], dict, dict]:
        """Consistent copy of (events, counters, gauges)."""
        with self._lock:
            return (list(self.events), dict(self.counters),
                    dict(self.gauges))


# ---------------------------------------------------------------------------
# process-global tracer + module-level emission API
# ---------------------------------------------------------------------------

_NOOP = NoopTracer()
_TRACER: Tracer | NoopTracer = _NOOP
if os.environ.get("REPRO_TRACE", "") not in ("", "0"):
    _TRACER = Tracer()


def enable(reset: bool = False) -> Tracer:
    """Install (or return) the process-global :class:`Tracer`.

    ``reset=True`` discards any accumulated events and starts fresh.
    Returns the active tracer so callers can read it back.
    """
    global _TRACER
    if reset or not isinstance(_TRACER, Tracer):
        _TRACER = Tracer()
    return _TRACER


def disable() -> None:
    """Swap the no-op tracer back in (recorded events are dropped)."""
    global _TRACER
    _TRACER = _NOOP


def enabled() -> bool:
    """True iff tracing is currently enabled."""
    return _TRACER.enabled


def get_tracer() -> Tracer | NoopTracer:
    """The process-global tracer (Noop when disabled)."""
    return _TRACER


def span(kind: str, **args):
    """Open a span on the global tracer (no-op context when disabled)."""
    return _TRACER.span(kind, **args)


def instant(kind: str, **args) -> None:
    """Record an instant on the global tracer."""
    _TRACER.instant(kind, **args)


def complete(kind: str, t0_ns: int, **args) -> None:
    """Record an explicit-start span on the global tracer."""
    _TRACER.complete(kind, t0_ns, **args)


def count(name: str, value: float = 1) -> None:
    """Increment a counter on the global tracer."""
    _TRACER.count(name, value)


def gauge(name: str, value: float) -> None:
    """Sample a gauge on the global tracer."""
    _TRACER.gauge(name, value)


def snapshot() -> tuple[list[TraceEvent], dict, dict]:
    """(events, counters, gauges) of the global tracer; empty when
    tracing is off."""
    tracer = _TRACER
    return tracer.snapshot() if tracer.enabled else ([], {}, {})


def span_count(kind: str) -> int:
    """Recorded events of ``kind`` on the global tracer (0 when off)."""
    tracer = _TRACER
    return tracer.span_count(kind) if tracer.enabled else 0


def render_span_kinds() -> str:
    """The vocabulary as Markdown tables, generated from the registries."""
    lines = ["| kind | layer | event | description |",
             "|---|---|---|---|"]
    for kind, (layer, event, desc) in SPAN_KINDS.items():
        lines.append(f"| `{kind}` | {layer} | {event} | {desc} |")
    lines.append("")
    lines.append("| counter | description |")
    lines.append("|---|---|")
    for name, desc in COUNTER_KINDS.items():
        lines.append(f"| `{name}` | {desc} |")
    lines.append("")
    lines.append("| gauge | description |")
    lines.append("|---|---|")
    for name, desc in GAUGE_KINDS.items():
        lines.append(f"| `{name}` | {desc} |")
    return "\n".join(lines)
