"""``repro_torch.obs``: the tracing and metrics plane of the port.

One process-global tracer that the port's layers emit into: Newton outer
iterations and the analytic communication tally (``core``), the HVP cell
and kernel dispatch (``core``/``kernels``), chunk reads of the shard
store (``data``), and retries and checkpoint writes (``robust``). The
vocabulary (:data:`SPAN_KINDS` et al.) is the JAX package's. Disabled by
default with a no-op fast path; enable with ``DiscoConfig(trace=True)``,
``REPRO_TRACE=1``, or :func:`enable`.

Typical use::

    from repro_torch import obs

    tracer = obs.enable(reset=True)
    solver.fit()
    obs.export.write_chrome_trace(tracer, "trace.json")   # -> Perfetto
    obs.disable()
"""
from repro_torch.obs import export, report
from repro_torch.obs.tracer import (COUNTER_KINDS, GAUGE_KINDS, SPAN_KINDS,
                                    NoopTracer, Span, TraceEvent, Tracer,
                                    complete, count, disable, enable,
                                    enabled, gauge, get_tracer, instant,
                                    render_span_kinds, snapshot, span,
                                    span_count)

__all__ = [
    "SPAN_KINDS", "COUNTER_KINDS", "GAUGE_KINDS",
    "Tracer", "NoopTracer", "Span", "TraceEvent",
    "enable", "disable", "enabled", "get_tracer",
    "span", "instant", "complete", "count", "gauge",
    "snapshot", "span_count", "render_span_kinds",
    "export", "report",
]
