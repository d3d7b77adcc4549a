"""Telemetry, ported: hierarchical spans and the metrics registry.

Disabled by default -- ``active_tracer()`` is ``None`` until a caller
installs a :class:`Tracer` (``set_tracer`` / ``trace_session``), and
every instrumentation site in the execution layer no-ops on a single
global read in that state.  Trace export is not part of this package
yet.
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, metrics)
from repro_torch.obs.spans import (NULL_SPAN, Span, Tracer, active_tracer,
                                   maybe_span, set_tracer, trace_session,
                                   traced)

__all__ = [
    "Tracer", "Span", "NULL_SPAN", "active_tracer", "set_tracer",
    "maybe_span", "trace_session", "traced",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "metrics",
]
