"""Hierarchical spans with a process-wide no-op default.

The execution layer is instrumented at four nesting levels::

    cascade:<spec>                  CascadeSimulator.run
      einsum:<output>               one mapped Einsum on a backend
        stage:<name>                vector-pipeline stage (materialize,
                                    pair-merge, lookup, finalize,
                                    reduce, output-build)
          seam:<name>               one guarded kernel-dispatch call

Tracing is **off by default**: ``active_tracer()`` returns ``None``
and every instrumentation site is a single cached-global read plus a
``None`` check (the same pattern the fault injector and guard knob
use in ``kernels/backends.py``), so the hot path stays at the
committed ``vector_rate`` when disabled.  ``maybe_span`` returns the
shared :data:`NULL_SPAN` singleton in that case -- no allocation on
the disabled path (asserted by ``tests/test_obs.py`` with
``tracemalloc``).

A :class:`Tracer` collects finished spans as Chrome-trace-event
dictionaries (``ph == "X"`` complete events, microsecond ``ts`` /
``dur`` relative to tracer start) plus instant events (``ph == "i"``)
for downgrades, guard trips, and injected faults.  Nesting is tracked
per-thread: each span records its parent span's name in
``args["parent"]`` so tests (and humans) can assert the hierarchy
without reconstructing it from time windows.  All mutation of the
shared event list is lock-protected -- the DSE engine traces from
worker threads.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

__all__ = [
    "Tracer", "Span", "NULL_SPAN", "active_tracer", "set_tracer",
    "maybe_span", "trace_session", "traced",
]

#: process-wide active tracer; ``None`` = telemetry disabled
_TRACER: Optional["Tracer"] = None


def active_tracer() -> Optional["Tracer"]:
    """The installed :class:`Tracer`, or ``None`` when disabled."""
    return _TRACER


def set_tracer(tracer: Optional["Tracer"]) -> Optional["Tracer"]:
    """Install (or, with ``None``, remove) the process-wide tracer.

    Returns the previously installed tracer so callers can restore it.
    """
    global _TRACER
    prev = _TRACER
    _TRACER = tracer
    return prev


class _NullSpan:
    """Reusable no-op span: one shared instance, allocation-free."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False

    def set(self, key: str, value: Any) -> None:
        pass


#: the shared disabled-path span (identity-tested by the overhead test)
NULL_SPAN = _NullSpan()


def maybe_span(name: str, cat: str = "",
               args: Optional[Dict[str, Any]] = None):
    """A span on the active tracer, or :data:`NULL_SPAN` when tracing
    is disabled.  The disabled path allocates nothing."""
    tr = _TRACER
    if tr is None:
        return NULL_SPAN
    return tr.span(name, cat, args)


class Span:
    """An open span; close via context-manager exit.

    ``set(key, value)`` attaches an arg visible in the exported trace
    (usable both while open and from the ``with`` body).
    """

    __slots__ = ("tracer", "name", "cat", "args", "_start_us", "parent")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Optional[Dict[str, Any]]):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.args: Dict[str, Any] = dict(args) if args else {}
        self._start_us = 0.0
        self.parent: Optional[str] = None

    def set(self, key: str, value: Any) -> None:
        self.args[key] = value

    def __enter__(self) -> "Span":
        tr = self.tracer
        stack = tr._stack()
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self._start_us = tr.now_us()
        return self

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> bool:
        tr = self.tracer
        end = tr.now_us()
        stack = tr._stack()
        if stack and stack[-1] == self.name:
            stack.pop()
        if exc_type is not None:
            self.args.setdefault("error", exc_type.__name__)
        if self.parent is not None:
            self.args.setdefault("parent", self.parent)
        tr.add_span(self.name, self.cat, self._start_us,
                    end - self._start_us, self.args or None)
        return False


class Tracer:
    """Collects Chrome-trace events; thread-safe, microsecond clock.

    ``events`` is a list of finished trace-event dicts (``ph`` in
    ``{"X", "i"}``).  Timestamps are relative to tracer creation so a
    trace always starts near ``ts == 0``.
    """

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self._clock = clock
        self._t0 = clock()
        self._lock = threading.Lock()
        self._local = threading.local()
        self._pid = os.getpid()
        self.events: List[Dict[str, Any]] = []

    # -- clock ---------------------------------------------------------
    def now_us(self) -> float:
        """Microseconds since tracer creation (monotonic)."""
        return (self._clock() - self._t0) * 1e6

    # -- per-thread nesting stack --------------------------------------
    def _stack(self) -> List[str]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = []
            self._local.stack = stack
        return stack

    def current_span_name(self) -> Optional[str]:
        stack = self._stack()
        return stack[-1] if stack else None

    # -- span / event emission -----------------------------------------
    def span(self, name: str, cat: str = "",
             args: Optional[Dict[str, Any]] = None) -> Span:
        """An open :class:`Span`; use as a context manager."""
        return Span(self, name, cat, args)

    def add_span(self, name: str, cat: str, ts_us: float, dur_us: float,
                 args: Optional[Dict[str, Any]] = None,
                 tid: Optional[int] = None) -> None:
        """Record a finished span directly (used both by :class:`Span`
        and to synthesize stage spans from accumulated stage timers)."""
        ev: Dict[str, Any] = {
            "name": name, "cat": cat or "span", "ph": "X",
            "ts": round(ts_us, 3), "dur": round(max(dur_us, 0.0), 3),
            "pid": self._pid,
            "tid": tid if tid is not None else threading.get_ident(),
        }
        if args:
            ev["args"] = args
        with self._lock:
            self.events.append(ev)

    def instant(self, name: str, cat: str = "",
                args: Optional[Dict[str, Any]] = None,
                ts_us: Optional[float] = None) -> None:
        """Record an instant event (downgrade, guard trip, fault)."""
        ev: Dict[str, Any] = {
            "name": name, "cat": cat or "event", "ph": "i",
            "ts": round(self.now_us() if ts_us is None else ts_us, 3),
            "pid": self._pid, "tid": threading.get_ident(),
            "s": "t",
        }
        if args:
            ev["args"] = args
        with self._lock:
            self.events.append(ev)

    # -- queries (tests / summaries) -----------------------------------
    def spans(self, cat: Optional[str] = None) -> List[Dict[str, Any]]:
        with self._lock:
            evs = list(self.events)
        return [e for e in evs if e["ph"] == "X"
                and (cat is None or e["cat"] == cat)]

    def instants(self, cat: Optional[str] = None) -> List[Dict[str, Any]]:
        with self._lock:
            evs = list(self.events)
        return [e for e in evs if e["ph"] == "i"
                and (cat is None or e["cat"] == cat)]


class trace_session:
    """``with trace_session() as tr: ...`` -- install a fresh tracer
    for the block and restore the previous one after (used by the CLI
    ``--trace`` flags and by tests)."""

    def __init__(self, tracer: Optional[Tracer] = None):
        self.tracer = tracer if tracer is not None else Tracer()
        self._prev: Optional[Tracer] = None

    def __enter__(self) -> Tracer:
        self._prev = set_tracer(self.tracer)
        return self.tracer

    def __exit__(self, *exc: Any) -> bool:
        set_tracer(self._prev)
        return False


def traced(name: Optional[str] = None, cat: str = ""):
    """Decorator form: span around each call of the wrapped function
    (no-op when tracing is disabled)."""
    def deco(fn):
        span_name = name if name is not None else fn.__qualname__

        def wrapper(*a, **k):
            tr = _TRACER
            if tr is None:
                return fn(*a, **k)
            with tr.span(span_name, cat):
                return fn(*a, **k)
        wrapper.__name__ = fn.__name__
        wrapper.__qualname__ = fn.__qualname__
        wrapper.__doc__ = fn.__doc__
        wrapper.__wrapped__ = fn
        return wrapper
    return deco
