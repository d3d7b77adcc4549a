"""Instrumentation interface: the simulator generator emits access/compute
events; performance-model components consume them online (TeAAL Sec. 4.3
"trace generation" / "trace consumption" -- we stream rather than
materialize giant trace files, with an optional collector for tests).
"""
from __future__ import annotations

from collections import Counter, defaultdict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


class Instrumentation:
    """Event sink. All methods are no-ops; subclasses override.

    Every count-like method takes ``n`` so a vectorized backend can
    report the same actions in aggregate (one call for n events) that
    the Python interpreter reports element-by-element; per-element
    ``path`` context is then unavailable (empty tuple).
    """

    def begin_einsum(self, einsum: str) -> None: ...

    def end_einsum(self, einsum: str) -> None: ...

    # storage: element touch. path = coords root->here, kind 'coord'|'payload'
    # ``unique`` (aggregate emitters only) hints how many *distinct*
    # elements underlie the n accesses, so storage models can estimate
    # residency statistically: None = unknown (legacy aggregate
    # handling), 0 = data already on chip (no cold fills)
    def touch(self, einsum: str, tensor: str, rank: str,
              path: Tuple, kind: str, rw: str, n: int = 1,
              unique: "int | None" = None) -> None: ...

    # loop rank advanced to a new coordinate (epoch marker for buffets)
    def advance(self, einsum: str, rank: str, n: int = 1) -> None: ...

    # sequencer: one coordinate enumerated at this loop rank
    def iterate(self, einsum: str, rank: str, n: int = 1,
                coord=None) -> None: ...

    # compute op executed ('mul'|'add')
    def compute(self, einsum: str, op: str, n: int = 1) -> None: ...

    # intersection: one pointer advance on `tensor` at `rank`
    def isect_step(self, einsum: str, rank: str, tensor: str,
                   n: int = 1) -> None: ...

    def isect_match(self, einsum: str, rank: str, n: int = 1) -> None: ...

    # online rank swizzle: merge `elements` leaves from `lists` sorted runs
    def merge(self, einsum: str, tensor: str, elements: int,
              lists: int) -> None: ...


class NullInstr(Instrumentation):
    pass


@dataclass
class CollectingInstr(Instrumentation):
    """Counts everything; optionally records full touch traces."""
    record_touches: bool = False
    touches: List[Tuple] = field(default_factory=list)
    touch_counts: Counter = field(default_factory=Counter)
    iter_counts: Counter = field(default_factory=Counter)
    compute_counts: Counter = field(default_factory=Counter)
    isect_steps: Counter = field(default_factory=Counter)
    isect_matches: Counter = field(default_factory=Counter)
    advances: Counter = field(default_factory=Counter)
    merges: List[Tuple[str, str, int, int]] = field(default_factory=list)

    def touch(self, einsum, tensor, rank, path, kind, rw, n=1, unique=None):
        self.touch_counts[(einsum, tensor, rank, kind, rw)] += n
        if self.record_touches:
            self.touches.append((einsum, tensor, rank, path, kind, rw))

    def advance(self, einsum, rank, n=1):
        self.advances[(einsum, rank)] += n

    def iterate(self, einsum, rank, n=1, coord=None):
        self.iter_counts[(einsum, rank)] += n

    def compute(self, einsum, op, n=1):
        self.compute_counts[(einsum, op)] += n

    def isect_step(self, einsum, rank, tensor, n=1):
        self.isect_steps[(einsum, rank, tensor)] += n

    def isect_match(self, einsum, rank, n=1):
        self.isect_matches[(einsum, rank)] += n

    def merge(self, einsum, tensor, elements, lists):
        self.merges.append((einsum, tensor, elements, lists))


class RecordingInstr(Instrumentation):
    """Records the event stream verbatim for later replay.

    The basis of the DSE engine's batched evaluation: for design points
    that share a mapping signature (and intersection config), the
    backend's instrumentation stream is a pure function of the workload
    and the lowered plans -- architecture attributes (capacities,
    bandwidths, radices) enter only when the stream is *consumed* by a
    ``PerformanceModel``.  Recording the stream once and replaying it
    into each point's own model therefore reproduces per-point results
    bit-identically while paying the backend walk once per group.

    ``max_events`` bounds memory: past it the recorder stops appending
    and flags ``overflowed`` -- callers must then fall back to
    per-point evaluation (per-element streams from the Python oracle
    can be arbitrarily long; aggregate analytic streams are tiny).
    """

    def __init__(self, max_events: int = 250_000):
        self.max_events = max_events
        self.events: List[Tuple] = []
        self.overflowed = False

    def _rec(self, method: str, *args) -> None:
        if len(self.events) >= self.max_events:
            self.overflowed = True
            return
        self.events.append((method, args))

    def begin_einsum(self, einsum):
        self._rec("begin_einsum", einsum)

    def end_einsum(self, einsum):
        self._rec("end_einsum", einsum)

    def touch(self, einsum, tensor, rank, path, kind, rw, n=1, unique=None):
        self._rec("touch", einsum, tensor, rank, path, kind, rw, n, unique)

    def advance(self, einsum, rank, n=1):
        self._rec("advance", einsum, rank, n)

    def iterate(self, einsum, rank, n=1, coord=None):
        self._rec("iterate", einsum, rank, n, coord)

    def compute(self, einsum, op, n=1):
        self._rec("compute", einsum, op, n)

    def isect_step(self, einsum, rank, tensor, n=1):
        self._rec("isect_step", einsum, rank, tensor, n)

    def isect_match(self, einsum, rank, n=1):
        self._rec("isect_match", einsum, rank, n)

    def merge(self, einsum, tensor, elements, lists):
        self._rec("merge", einsum, tensor, elements, lists)

    def __len__(self) -> int:
        return len(self.events)

    def replay(self, sink: Instrumentation) -> None:
        """Re-emit the recorded stream, in order, into ``sink``."""
        for method, args in self.events:
            getattr(sink, method)(*args)


class TeeInstr(Instrumentation):
    """Fan out events to several sinks."""

    def __init__(self, *sinks: Instrumentation):
        self.sinks = [s for s in sinks if s is not None]

    def begin_einsum(self, einsum):
        for s in self.sinks:
            s.begin_einsum(einsum)

    def end_einsum(self, einsum):
        for s in self.sinks:
            s.end_einsum(einsum)

    def touch(self, *a, **k):
        for s in self.sinks:
            s.touch(*a, **k)

    def advance(self, *a, **k):
        for s in self.sinks:
            s.advance(*a, **k)

    def iterate(self, *a, **k):
        for s in self.sinks:
            s.iterate(*a, **k)

    def compute(self, *a, **k):
        for s in self.sinks:
            s.compute(*a, **k)

    def isect_step(self, *a, **k):
        for s in self.sinks:
            s.isect_step(*a, **k)

    def isect_match(self, *a, **k):
        for s in self.sinks:
            s.isect_match(*a, **k)

    def merge(self, *a):
        for s in self.sinks:
            s.merge(*a)
