"""Trace/metrics exporters: Chrome trace JSON, JSONL, text summary.

``chrome_trace`` produces the Chrome-trace-event JSON object format
(https://ui.perfetto.dev loads it directly): spans are ``ph == "X"``
complete events with microsecond ``ts``/``dur``, downgrades / guard
trips / injected faults are ``ph == "i"`` instant events, and a
metadata event names the process.  The active metrics snapshot rides
along under ``otherData`` so one file carries the whole telemetry
story of a run.

``write_trace`` picks the format from the filename: ``*.jsonl`` gets
one event per line (streaming-friendly structured log), anything else
gets the Chrome JSON object.
"""
from __future__ import annotations

import json
import sys
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

from repro_torch.obs.metrics import MetricsRegistry, metrics
from repro_torch.obs.spans import Tracer, trace_session

__all__ = [
    "chrome_trace", "to_jsonl", "write_trace", "summarize_trace",
    "cli_trace",
]


def _sorted_events(tracer: Tracer) -> List[Dict[str, Any]]:
    with tracer._lock:
        evs = list(tracer.events)
    return sorted(evs, key=lambda e: (e["ts"], e["ph"] != "X"))


def chrome_trace(tracer: Tracer,
                 registry: Optional[MetricsRegistry] = None,
                 process_name: str = "repro_torch") -> Dict[str, Any]:
    """Chrome-trace-event JSON object (Perfetto-loadable)."""
    reg = registry if registry is not None else metrics()
    events: List[Dict[str, Any]] = [{
        "name": "process_name", "ph": "M", "pid": tracer._pid, "tid": 0,
        "ts": 0, "args": {"name": process_name},
    }]
    events.extend(_sorted_events(tracer))
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"metrics": reg.snapshot()},
    }


def to_jsonl(tracer: Tracer,
             registry: Optional[MetricsRegistry] = None) -> str:
    """One JSON event per line, time-ordered; final line is the
    metrics snapshot (``{"kind": "metrics", ...}``)."""
    reg = registry if registry is not None else metrics()
    lines = [json.dumps(ev, sort_keys=True)
             for ev in _sorted_events(tracer)]
    lines.append(json.dumps({"kind": "metrics", **reg.snapshot()},
                            sort_keys=True))
    return "\n".join(lines) + "\n"


def write_trace(path: Union[str, Path], tracer: Tracer,
                registry: Optional[MetricsRegistry] = None) -> Path:
    """Write the trace to ``path``; ``*.jsonl`` selects the JSONL
    structured log, anything else the Chrome JSON object."""
    p = Path(path)
    if p.suffix == ".jsonl":
        p.write_text(to_jsonl(tracer, registry))
    else:
        p.write_text(json.dumps(chrome_trace(tracer, registry),
                                indent=1) + "\n")
    return p


@contextmanager
def cli_trace(path: Optional[Union[str, Path]]):
    """``--trace PATH`` plumbing shared by the benchmark drivers:
    installs a fresh process-wide tracer for the block, writes the
    trace file on exit (even on error), and prints the text summary
    to stderr.  A ``None`` path makes the whole thing a no-op, so
    drivers can wrap their body unconditionally."""
    if path is None:
        yield None
        return
    with trace_session() as tr:
        try:
            yield tr
        finally:
            p = write_trace(path, tr)
            print(f"# wrote trace {p} "
                  f"({len(tr.events)} events; load in "
                  f"https://ui.perfetto.dev)", file=sys.stderr)
            print(summarize_trace(tr), file=sys.stderr)


def summarize_trace(tracer: Tracer,
                    registry: Optional[MetricsRegistry] = None) -> str:
    """Text summary: span wall time by category/name, instant-event
    tallies, then the metrics table."""
    reg = registry if registry is not None else metrics()
    by_name: Dict[tuple, List[float]] = {}
    inst: Dict[tuple, int] = {}
    for ev in _sorted_events(tracer):
        if ev["ph"] == "X":
            # stage/seam spans repeat per einsum -- aggregate on the
            # name up to the first ':' plus the label after it
            by_name.setdefault((ev["cat"], ev["name"]), []).append(
                ev.get("dur", 0.0))
        elif ev["ph"] == "i":
            key = (ev["cat"], ev["name"])
            inst[key] = inst.get(key, 0) + 1
    lines = [f"{'span (cat:name)':<52} {'count':>6} {'total_ms':>10} "
             f"{'mean_us':>10}"]
    for (cat, name), durs in sorted(
            by_name.items(), key=lambda kv: -sum(kv[1])):
        total_ms = sum(durs) / 1e3
        mean_us = sum(durs) / len(durs)
        lines.append(f"{cat + ':' + name:<52} {len(durs):>6} "
                     f"{total_ms:>10.3f} {mean_us:>10.1f}")
    if inst:
        lines.append("")
        lines.append(f"{'instant (cat:name)':<52} {'count':>6}")
        for (cat, name), n in sorted(inst.items()):
            lines.append(f"{cat + ':' + name:<52} {n:>6}")
    lines.append("")
    lines.append(reg.summary_table())
    return "\n".join(lines)
