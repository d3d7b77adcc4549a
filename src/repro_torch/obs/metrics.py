"""Process-wide metrics registry: counters, gauges, histograms.

Naming scheme (see DESIGN.md "Telemetry contract"): dotted component
prefix, ``/``-separated label suffix --

    kernel.seam_seconds/<seam>/<backend>     histogram (seam latency)
    kernel.downgrade/<action>                counter   (retry/downgrade/
                                                        demote/unavailable)
    guards.violation/<check>                 counter
    vector.stage_seconds/<stage>             counter   (float seconds)
    dse.point/<status>                       counter   (ok/restored/...)
    dse.point_attempts                       counter
    dse.plan_cache/{hit,miss}                counter
    dse.result_cache/{hit,miss}              counter   (served without
                                                        the backend)
    dse.service/{requests,batches,           counter   (sweep-service
                 coalesced,rejected}                    front-end)
    dse.service/batch_size                   histogram (requests per
                                                        micro-batch)

Counters accept float increments (stage seconds accumulate into a
counter rather than a histogram: the per-stage distribution is already
on the trace as spans).  Histograms use fixed bucket upper bounds so
merging snapshots never re-bins.

The registry is cheap but not free; rare-event sites (downgrades,
guard violations, sweep points) update it unconditionally, while
per-seam latency observation only happens when a tracer is active --
that keeps the disabled hot path allocation-free.
"""
from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "metrics",
    "DEFAULT_LATENCY_BUCKETS",
]

#: seconds; spans ~1us .. ~1s, the range of a guarded seam call
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = (
    1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0,
)


class Counter:
    """Monotonically increasing value (float increments allowed)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed-bucket histogram: counts per upper bound + overflow.

    ``buckets`` are inclusive upper bounds; an observation greater
    than the last bound lands in the overflow bucket (reported as
    ``+Inf`` in snapshots).
    """

    __slots__ = ("name", "buckets", "counts", "total", "sum", "_lock")

    def __init__(self, name: str,
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS):
        self.name = name
        self.buckets: Tuple[float, ...] = tuple(buckets)
        self.counts: List[int] = [0] * (len(self.buckets) + 1)
        self.total = 0
        self.sum = 0.0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        idx = bisect_left(self.buckets, v)
        with self._lock:
            self.counts[idx] += 1
            self.total += 1
            self.sum += v

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "buckets": list(self.buckets) + ["+Inf"],
                "counts": list(self.counts),
                "count": self.total,
                "sum": round(self.sum, 9),
            }


class MetricsRegistry:
    """Named metric store; instruments are created on first use."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    # -- accessors -----------------------------------------------------
    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter(name))
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge(name))
        return g

    def histogram(self, name: str,
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(
                    name,
                    Histogram(name, buckets or DEFAULT_LATENCY_BUCKETS))
        return h

    # -- export --------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """JSON-serializable view of every instrument."""
        with self._lock:
            counters = {n: c.value for n, c in self._counters.items()}
            gauges = {n: g.value for n, g in self._gauges.items()}
            hists = dict(self._histograms)
        return {
            "counters": {n: counters[n] for n in sorted(counters)},
            "gauges": {n: gauges[n] for n in sorted(gauges)},
            "histograms": {n: hists[n].snapshot() for n in sorted(hists)},
        }

    def summary_table(self) -> str:
        """Human-readable fixed-width table of the registry state."""
        snap = self.snapshot()
        lines: List[str] = []
        if snap["counters"]:
            lines.append(f"{'counter':<44} {'value':>14}")
            for name, v in snap["counters"].items():
                sval = f"{v:.6f}".rstrip("0").rstrip(".") \
                    if v != int(v) else str(int(v))
                lines.append(f"{name:<44} {sval:>14}")
        if snap["gauges"]:
            lines.append(f"{'gauge':<44} {'value':>14}")
            for name, v in snap["gauges"].items():
                lines.append(f"{name:<44} {v:>14.6g}")
        if snap["histograms"]:
            lines.append(
                f"{'histogram':<44} {'count':>8} {'sum':>12} "
                f"{'mean':>12}")
            for name, h in snap["histograms"].items():
                mean = h["sum"] / h["count"] if h["count"] else 0.0
                lines.append(f"{name:<44} {h['count']:>8} "
                             f"{h['sum']:>12.6f} {mean:>12.3e}")
        return "\n".join(lines) if lines else "(no metrics recorded)"

    def reset(self) -> None:
        """Drop every instrument (test isolation hook)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


#: the process-wide registry every instrumentation site writes to
_REGISTRY = MetricsRegistry()


def metrics() -> MetricsRegistry:
    """The process-wide :class:`MetricsRegistry`."""
    return _REGISTRY
