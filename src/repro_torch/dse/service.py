"""Persistent sweep service: concurrent what-if queries, micro-batched.

A long-lived design-space exploration session -- an interactive
notebook, an optimizer population, several engineers poking the same
workload -- issues many small queries instead of one big sweep.  Served
naively, each query pays the full per-point cost and the batched
evaluation path (one probe amortized over a group) never engages.

:class:`SweepService` fixes that with a classic serving loop:

  * **request queue** -- ``submit(point)`` enqueues and returns a
    ``concurrent.futures.Future`` immediately; a bounded queue
    (``max_queue``) provides backpressure, rejecting work instead of
    buffering without limit;
  * **micro-batching** -- the single worker thread takes the first
    pending request, then drains whatever else arrives within
    ``batch_window_s`` (up to ``max_batch``): concurrent queries are
    coalesced into ONE ``SweepEngine.sweep`` call, so points sharing a
    mapping signature share one probe and the result cache is checked
    once per distinct point;
  * **request coalescing** -- duplicate in-flight points (same label)
    are evaluated once and fanned out to every waiting future;
  * **fault isolation** -- the engine already converts per-point
    failures into structured ``PointResult``s; anything that still
    escapes a batch fails only that batch's futures and the loop keeps
    serving.

Telemetry: ``dse.service/{requests,batches,coalesced,rejected}``
counters, a ``dse.service/batch_size`` histogram, and one
``service:batch`` span per drained batch.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .engine import PointResult, SweepEngine
from .space import DesignPoint


class ServiceClosed(RuntimeError):
    """Raised by ``submit`` after ``stop()`` (or before ``start()``)."""


class ServiceOverloaded(RuntimeError):
    """Raised by ``submit`` when the request queue is full."""


class SweepService:
    """Single-worker micro-batching front-end over a
    :class:`SweepEngine`.

    One worker thread keeps the engine's internal caches (plans,
    calibration, converted operands, result cache) on a single timeline
    -- no cross-thread engine locking -- while still letting any number
    of client threads (or an asyncio loop, via :meth:`asubmit`) issue
    queries concurrently.
    """

    def __init__(self, engine: SweepEngine, *, max_batch: int = 64,
                 batch_window_s: float = 0.002, max_queue: int = 1024):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.engine = engine
        self.max_batch = max_batch
        self.batch_window_s = batch_window_s
        self._queue: "queue.Queue[Optional[Tuple[DesignPoint, Future]]]" = \
            queue.Queue(maxsize=max_queue)
        self._thread: Optional[threading.Thread] = None
        self._open = False
        self.requests = 0
        self.batches = 0
        self.coalesced = 0
        self.rejected = 0

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #
    def start(self) -> "SweepService":
        if self._thread is not None:
            return self
        self._open = True
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name="sweep-service")
        self._thread.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Shut the service down.  With ``drain`` (default) queued
        requests are still served; without, they fail with
        :class:`ServiceClosed`."""
        if self._thread is None:
            return
        self._open = False
        if not drain:
            while True:
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    break
                if item is not None:
                    item[1].set_exception(ServiceClosed("service stopped"))
        self._queue.put(None)                       # wake the worker
        self._thread.join()
        self._thread = None

    def __enter__(self) -> "SweepService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------------ #
    # client API
    # ------------------------------------------------------------------ #
    def submit(self, point: DesignPoint) -> "Future[PointResult]":
        """Enqueue one query; resolves to the point's
        :class:`PointResult`.  Raises :class:`ServiceClosed` when the
        service is not running and :class:`ServiceOverloaded` when the
        queue is full (backpressure -- callers should slow down, not
        buffer)."""
        from repro_torch.obs.metrics import metrics
        if not self._open:
            raise ServiceClosed("service is not running")
        fut: "Future[PointResult]" = Future()
        try:
            self._queue.put_nowait((point, fut))
        except queue.Full:
            self.rejected += 1
            metrics().counter("dse.service/rejected").inc()
            raise ServiceOverloaded(
                f"request queue full ({self._queue.maxsize})") from None
        self.requests += 1
        metrics().counter("dse.service/requests").inc()
        return fut

    def what_if(self, point: DesignPoint,
                timeout: Optional[float] = None) -> PointResult:
        """Blocking convenience wrapper: submit and wait."""
        return self.submit(point).result(timeout=timeout)

    def asubmit(self, point: DesignPoint):
        """``await``-able form of :meth:`submit` for asyncio callers."""
        import asyncio
        return asyncio.wrap_future(self.submit(point))

    def stats(self) -> Dict[str, int]:
        return {"requests": self.requests, "batches": self.batches,
                "coalesced": self.coalesced, "rejected": self.rejected,
                "queued": self._queue.qsize()}

    # ------------------------------------------------------------------ #
    # worker loop
    # ------------------------------------------------------------------ #
    def _serve(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                if self._open:                       # spurious wake
                    continue
                return
            batch = [item]
            deadline = time.monotonic() + self.batch_window_s
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    # propagate the shutdown wake after this batch
                    self._queue.put(None)
                    break
                batch.append(nxt)
            self._run_batch(batch)

    def _run_batch(self,
                   batch: List[Tuple[DesignPoint, Future]]) -> None:
        from repro_torch.obs.metrics import metrics
        from repro_torch.obs.spans import active_tracer

        reg = metrics()
        self.batches += 1
        reg.counter("dse.service/batches").inc()
        reg.histogram("dse.service/batch_size",
                      buckets=(1, 2, 4, 8, 16, 32, 64, 128)) \
            .observe(len(batch))

        # coalesce duplicate in-flight points: first occurrence wins
        # the evaluation, every future gets the shared result
        unique: "Dict[str, DesignPoint]" = {}
        waiting: "Dict[str, List[Future]]" = {}
        for point, fut in batch:
            if point.label in unique:
                self.coalesced += 1
                reg.counter("dse.service/coalesced").inc()
            else:
                unique[point.label] = point
            waiting.setdefault(point.label, []).append(fut)

        tr = active_tracer()
        sp = tr.span("service:batch", "dse") if tr is not None else None
        if sp is not None:
            sp.__enter__()
            sp.set("requests", len(batch))
            sp.set("points", len(unique))
        try:
            results = self.engine.sweep(list(unique.values()))
            by_label = {r.label: r for r in results}
            for label, futs in waiting.items():
                res = by_label.get(label)
                for fut in futs:
                    if res is not None:
                        fut.set_result(res)
                    else:
                        fut.set_exception(RuntimeError(
                            f"sweep returned no result for {label!r}"))
        except BaseException as exc:               # noqa: BLE001
            # fail this batch's futures, keep serving the next one
            for futs in waiting.values():
                for fut in futs:
                    if not fut.done():
                        fut.set_exception(exc)
            if sp is not None:
                sp.set("error", f"{type(exc).__name__}: {exc}")
        finally:
            if sp is not None:
                sp.__exit__(None, None, None)
