"""Telemetry, ported: hierarchical spans, metrics, trace export.

Disabled by default -- ``active_tracer()`` is ``None`` until a caller
installs a :class:`Tracer` (``set_tracer`` / ``trace_session`` / the
benchmark CLIs' ``--trace``), and every instrumentation site in the
execution layer no-ops on a single global read in that state.
"""
from repro_torch.obs.export import (chrome_trace, summarize_trace, to_jsonl,
                                    write_trace)
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, metrics)
from repro_torch.obs.spans import (NULL_SPAN, Span, Tracer, active_tracer,
                                   maybe_span, set_tracer, trace_session,
                                   traced)

__all__ = [
    "Tracer", "Span", "NULL_SPAN", "active_tracer", "set_tracer",
    "maybe_span", "trace_session", "traced",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "metrics",
    "chrome_trace", "to_jsonl", "write_trace", "summarize_trace",
]
