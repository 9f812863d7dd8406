"""Trace aggregation and measured-vs-analytic comparison (the JAX
package's ``repro.obs.report``).

:func:`span_rows` turns a trace into a per-(shard, kind) table with the
straggler of each kind flagged; :func:`measured_vs_predicted` diffs each
Newton step's measured ``iter_s`` against the analytic prediction of
:func:`repro_torch.core.comm.disco_sparse_iter_time` (or, for a streamed
solve, :func:`repro_torch.core.comm.disco_streaming_iter_time`). The
models' rates are the reference's constants, not the card's.
"""
from __future__ import annotations

from repro_torch.obs.tracer import Tracer


def span_rows(tracer: Tracer) -> list[dict]:
    """Spans aggregated per (shard, kind).

    The shard key is a span's ``shard`` arg (``"-"`` for solver-wide
    spans). Each row carries the event count, total / mean / max
    duration, and ``critical=True`` on the shard with the largest total
    of its kind (the straggler that gates that phase's barrier).
    """
    events, _, _ = tracer.snapshot()
    agg: dict[tuple[str, str], dict] = {}
    for ev in events:
        if ev.ph != "X":
            continue
        shard = str(ev.args.get("shard", "-"))
        a = agg.setdefault((shard, ev.kind), {"events": 0, "total_s": 0.0,
                                              "max_ms": 0.0})
        a["events"] += 1
        dur_s = ev.dur_ns / 1e9
        a["total_s"] += dur_s
        a["max_ms"] = max(a["max_ms"], dur_s * 1e3)
    rows = []
    for (shard, kind), a in sorted(agg.items()):
        rows.append({"shard": shard, "kind": kind,
                     "events": int(a["events"]),
                     "total_s": float(a["total_s"]),
                     "mean_ms": float(a["total_s"] / a["events"] * 1e3),
                     "max_ms": float(a["max_ms"]),
                     "critical": False})
    by_kind: dict[str, dict] = {}
    for r in rows:
        best = by_kind.get(r["kind"])
        if best is None or r["total_s"] > best["total_s"]:
            by_kind[r["kind"]] = r
    for r in by_kind.values():
        r["critical"] = True
    return rows


def measured_vs_predicted(history: list[dict], shard_nnz, partition: str,
                          n: int, d: int, m: int, s: int = 1, *,
                          hvp_fused: bool = False,
                          hvp_dtype: str = "float32",
                          streaming: bool = False,
                          chunk_nnz_max: int | None = None,
                          prefetch_depth: int = 2) -> list[dict]:
    """Per-outer-iteration rows of measured against modeled time.

    For each history entry with an ``iter_s``, evaluates the matching
    :mod:`repro_torch.core.comm` iteration-time model at that step's
    ``pcg_iters`` and reports measured, predicted and their ratio. The
    first step is flagged ``compile=True``: it carries one-time costs
    (the kernels' first launches, on the card their loading) that the
    steady-state model leaves out.
    """
    from repro_torch.core import comm

    dtype_bytes = comm.hvp_dtype_bytes(hvp_dtype)
    rows = []
    for i, h in enumerate(history):
        if "iter_s" not in h:
            continue
        iters = max(1, int(h.get("pcg_iters", 1)))
        if streaming:
            pred = comm.disco_streaming_iter_time(
                shard_nnz, iters, partition, n=n, d=d, m=m, s=s,
                chunk_nnz_max=int(chunk_nnz_max or 1),
                prefetch_depth=prefetch_depth, hvp_fused=hvp_fused,
                hvp_dtype_bytes=dtype_bytes)
        else:
            pred = comm.disco_sparse_iter_time(
                shard_nnz, iters, partition, n=n, d=d, m=m, s=s,
                hvp_fused=hvp_fused, hvp_dtype_bytes=dtype_bytes)
        measured = float(h["iter_s"])
        predicted = float(pred["total_s"])
        rows.append({
            "outer_iter": int(h.get("outer_iter", i)),
            "pcg_iters": iters,
            "measured_s": measured,
            "predicted_s": predicted,
            "ratio": measured / predicted if predicted > 0 else 0.0,
            "compile": i == 0,
        })
    return rows
