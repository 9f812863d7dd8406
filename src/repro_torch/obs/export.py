"""Exporters for the in-process tracer (the JAX package's
``repro.obs.export``).

* :func:`chrome_trace` / :func:`write_chrome_trace`: Chrome trace-event
  JSON (the JSON-array flavour). Load the written file into
  https://ui.perfetto.dev or ``chrome://tracing``: one track per thread.
* :func:`summary_rows`: flat rows of JSON scalars, one per span kind and
  one per counter and gauge.
"""
from __future__ import annotations

import json

from repro_torch.obs.tracer import Tracer


def chrome_trace(tracer: Tracer) -> list[dict]:
    """A tracer's events as Chrome trace-event dicts.

    One ``M`` (metadata) event names each thread, then one ``X``
    (complete, with ``dur``) or ``i`` (instant, thread-scoped) event per
    recorded span or instant; counters and gauges ride on a final
    ``process_labels`` metadata event. Timestamps are microseconds from
    the tracer's epoch.
    """
    events, counters, gauges = tracer.snapshot()
    out: list[dict] = []
    named: set[int] = set()
    for ev in events:
        if ev.tid not in named:
            named.add(ev.tid)
            out.append({"ph": "M", "name": "thread_name", "pid": 1,
                        "tid": ev.tid, "args": {"name": ev.thread}})
        rec = {"name": ev.kind, "ph": ev.ph, "pid": 1, "tid": ev.tid,
               "ts": (ev.t0_ns - tracer.epoch_ns) / 1e3,
               "args": ev.args}
        if ev.ph == "X":
            rec["dur"] = ev.dur_ns / 1e3
        else:
            rec["s"] = "t"              # thread-scoped instant
        out.append(rec)
    if counters or gauges:
        out.append({"ph": "M", "name": "process_labels", "pid": 1,
                    "tid": 0,
                    "args": {"labels": json.dumps(
                        {"counters": counters, "gauges": gauges})}})
    return out


def write_chrome_trace(tracer: Tracer, path: str) -> str:
    """Write :func:`chrome_trace` output as a JSON file; returns
    ``path``."""
    with open(path, "w") as f:
        json.dump(chrome_trace(tracer), f)
    return path


def summary_rows(tracer: Tracer) -> list[dict]:
    """The trace aggregated into flat rows (one per span kind, then one
    per counter and gauge) of JSON scalars only."""
    events, counters, gauges = tracer.snapshot()
    agg: dict[str, dict] = {}
    for ev in events:
        a = agg.setdefault(ev.kind, {"events": 0, "total_s": 0.0,
                                     "max_ms": 0.0})
        a["events"] += 1
        dur_s = ev.dur_ns / 1e9
        a["total_s"] += dur_s
        a["max_ms"] = max(a["max_ms"], dur_s * 1e3)
    rows = [{"kind": kind, "events": int(a["events"]),
             "total_s": float(a["total_s"]), "max_ms": float(a["max_ms"])}
            for kind, a in sorted(agg.items())]
    for prefix, values in (("counter", counters), ("gauge", gauges)):
        for name in sorted(values):
            rows.append({"kind": f"{prefix}:{name}", "events": 1,
                         "total_s": 0.0, "value": float(values[name]),
                         "max_ms": 0.0})
    return rows
