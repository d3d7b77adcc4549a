"""The sweep engine: evaluate design points through any backend.

One engine instance owns one workload (the input tensors + var shapes)
and amortizes everything that is shared across sweep points:

  * **plan lowering** -- memoized on ``cascade.mapping_signature``, so
    points that only change architecture attributes (cache capacity,
    merger radix, bandwidth) reuse the lowered ``EinsumPlan``s;
  * **density calibration** (analytic backend) -- the one-pass tensor
    scans are cached per (workload, mapping-signature, tensor, exec
    order) and shared across points *and* threads, so an
    arch-attribute sweep transforms + scans the workload exactly once
    and every later point is closed-form evaluation only;
  * **input conversion** (analytic backend) -- the dense->fibertree
    transform of the workload operands is cached per stored rank
    order and shared read-only across every point;
  * **batched group evaluation** (analytic backend, ``batch=True``) --
    points are partitioned on ``(mapping_signature, isect_configs)``;
    within a group the backend's instrumentation event stream is a
    pure function of the workload and the lowered plans (architecture
    attributes enter only at stream *consumption* time), so the first
    point of a group (the probe) records its stream once
    (``trace.RecordingInstr``) and every other member replays it into
    its own ``PerformanceModel`` -- bit-identical per-point results at
    a fraction of the per-point cost.  The capacity-dependent
    statistical-residency closed form is precomputed across the whole
    point axis in one numpy pass (``density.batched_stat_misses``) and
    served to each replay through ``components.stat_miss_feed``;
  * **result cache** (optional ``result_cache``) -- previously
    evaluated (workload x point x backend x mode) queries are served
    from ``dse.cache.ResultCache`` without touching the backend.

Evaluation defaults to the analytic backend (host numpy: it touches no
device); pass ``backend='vector'`` or ``'python'`` for execution-based
fidelity at sweep cost.  A 'vector' engine runs its seams on the CUDA
device -- the hand kernels, and on a kernel fault the point fails --
unless ``device`` names another ('cpu': the plain versions).

Sweeps run serially (batched), threaded (``executor='thread'``,
execution backends) or sharded over a process pool
(``executor='process'``): point chunks are shipped to worker processes
that each run their own batched engine, sidestepping the GIL.  The
fault-tolerance contract survives the worker boundary: per-point
timeouts / retries apply inside the worker, fault injectors are
re-installed in every worker, a ``SimulatedCrash`` in a worker still
tears the sweep down after a final checkpoint save, and crash->resume
stays bit-identical.  The pool forks where it can, except for a
'vector' engine, whose workers run torch: a forked child of a process
that has initialised CUDA cannot use it, and one of a process that has
run torch's CPU thread pool can hang in its first parallel op, so such a
pool spawns.
"""
from __future__ import annotations

import itertools
import math
import time
import traceback as _tb
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FutTimeout
from concurrent.futures import wait as _fut_wait
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple)

import numpy as np

from repro_torch.core.cascade import mapping_signature
from repro_torch.core.components import PerformanceModel, stat_miss_feed
from repro_torch.core.density import batched_stat_misses
from repro_torch.core.generator import CascadeSimulator, isect_configs
from repro_torch.core.mapping import EinsumPlan
from repro_torch.core.metrics import Report
from repro_torch.core.metrics import evaluate as _evaluate_report
from repro_torch.core.trace import RecordingInstr

from .space import DesignPoint

_token_counter = itertools.count()

#: objective fields checkpointed per point (alphabetical: pytrees flatten
#: dicts in sorted-key order, so save and restore agree)
_CKPT_FIELDS = ("dram_bytes", "energy_pj", "seconds", "wall_seconds")


def _active_injector():
    try:
        from repro_torch.testing.faults import active_injector
    except ImportError:
        return None
    return active_injector()


def _trim_traceback(exc: BaseException, limit: int = 600) -> str:
    """The exception line plus the innermost two frames -- enough to
    locate a sweep failure without shipping whole tracebacks around."""
    lines = _tb.format_exception(type(exc), exc, exc.__traceback__)
    return "".join(lines[:1] + lines[-3:])[-limit:]


@dataclass
class PointResult:
    """Modeled objectives of one evaluated design point."""
    point: DesignPoint
    seconds: float = float("nan")
    energy_pj: float = float("nan")
    dram_bytes: float = float("nan")
    wall_seconds: float = 0.0
    fallback_reasons: Dict[str, str] = field(default_factory=dict)
    report: Optional[Report] = None
    #: "ExcType: message" on failure (None when the point evaluated)
    error: Optional[str] = None
    #: the exception class name alone (machine-matchable)
    error_type: Optional[str] = None
    #: trimmed traceback (exception line + innermost frames)
    traceback: Optional[str] = None
    #: the point exceeded the engine's per-point wall-clock budget
    timed_out: bool = False
    #: evaluation attempts consumed (> 1 after retries)
    attempts: int = 1
    #: objectives restored from a sweep checkpoint, not re-evaluated
    restored: bool = False
    #: objectives served from the result cache, not re-evaluated
    cached: bool = False

    @property
    def ok(self) -> bool:
        return self.error is None

    @property
    def status(self) -> str:
        if self.ok:
            if self.restored:
                return "restored"
            return "cached" if self.cached else "ok"
        return "timeout" if self.timed_out else "failed"

    @property
    def label(self) -> str:
        return self.point.label

    def row(self) -> str:
        if not self.ok:
            tag = "TIMEOUT" if self.timed_out else "FAILED"
            tries = f" attempts={self.attempts}" if self.attempts > 1 \
                else ""
            return f"{self.label}: {tag} ({self.error}){tries}"
        return (f"{self.label}: time={self.seconds:.3e}s "
                f"traffic={self.dram_bytes / 1e3:.1f}KB "
                f"energy={self.energy_pj / 1e6:.2f}uJ")


# ---------------------------------------------------------------------- #
# batched-evaluation plumbing
# ---------------------------------------------------------------------- #
@dataclass
class _Prep:
    """Per-point lowering shared by the batched paths: everything a
    point needs before any backend work."""
    point: DesignPoint
    spec: Any
    params: Optional[Dict[str, int]]
    sig: str
    group_key: Tuple


class _CaptureFeed:
    """Probe-side feed: records the ``touch_stat`` consumption sequence
    (level, nbytes, n, unique) and always stands down (returns None),
    so the probe computes its misses through the scalar closed form --
    probe results are untouched by capturing."""

    def __init__(self):
        self.calls: List[Tuple[Any, float, int, int]] = []

    def take(self, level, nbytes, n, unique):
        self.calls.append((level, float(nbytes), int(n), int(unique)))
        return None


class _ReplayFeed:
    """Replay-side feed: serves one point's lane of the pre-vectorized
    miss values, validating every call against the recorded occurrence
    (args + this point's capacity for the same level key).  Any
    mismatch permanently stands the feed down -- the scalar closed form
    takes over, so feeding can reroute work but never change results
    (``batched_stat_misses`` is bit-identical to ``stat_misses``
    elementwise)."""

    def __init__(self, occurrences, values, caps):
        self.occurrences = occurrences    # [(lvl_key, nbytes, n, unique)]
        self.values = values              # this point's lane, same length
        self.caps = caps                  # lvl_key -> this point's capacity
        self.i = 0
        self.dead = False

    def reset(self) -> None:
        self.i = 0
        self.dead = False

    def take(self, level, nbytes, n, unique):
        if self.dead or self.i >= len(self.occurrences):
            self.dead = True
            return None
        key, e_nbytes, e_n, e_unique = self.occurrences[self.i]
        cap = self.caps.get(key)
        if (cap is None or cap != level.capacity_bytes
                or e_nbytes != float(nbytes) or e_n != int(n)
                or e_unique != int(unique)):
            self.dead = True
            return None
        v = self.values[self.i]
        self.i += 1
        return v


# ---------------------------------------------------------------------- #
# process-pool worker plumbing (module level: must be picklable)
# ---------------------------------------------------------------------- #
_WORKER_ENGINE: Optional["SweepEngine"] = None


def _pool_init(inputs, var_shapes, engine_kw, fault_payload) -> None:
    """Per-process initializer: one engine singleton per worker, and
    the parent's fault injector re-installed so the fault contract
    survives the process boundary under fork AND spawn."""
    global _WORKER_ENGINE
    if fault_payload is not None:
        from repro_torch.testing.faults import FaultInjector, install_injector
        specs, seed = fault_payload
        install_injector(FaultInjector(list(specs), seed=seed))
    _WORKER_ENGINE = SweepEngine(inputs, var_shapes, **engine_kw)


def _pool_run(points: List[DesignPoint]) -> List[Dict[str, Any]]:
    """Evaluate one chunk in the worker's engine (batched, serial,
    full per-point fault policy).  A ``SimulatedCrash`` propagates to
    the parent -- the chunk's partial results are dropped, preserving
    the either-completed-or-pending contract."""
    assert _WORKER_ENGINE is not None
    results = _WORKER_ENGINE.sweep(points)
    return [_pack_result(r) for r in results]


def _pack_result(r: PointResult) -> Dict[str, Any]:
    return {
        "label": r.label, "seconds": r.seconds, "energy_pj": r.energy_pj,
        "dram_bytes": r.dram_bytes, "wall_seconds": r.wall_seconds,
        "fallback_reasons": dict(r.fallback_reasons), "error": r.error,
        "error_type": r.error_type, "traceback": r.traceback,
        "timed_out": r.timed_out, "attempts": r.attempts,
    }


def _unpack_result(row: Dict[str, Any], point: DesignPoint) -> PointResult:
    return PointResult(
        point=point, seconds=row["seconds"], energy_pj=row["energy_pj"],
        dram_bytes=row["dram_bytes"], wall_seconds=row["wall_seconds"],
        fallback_reasons=dict(row["fallback_reasons"]),
        error=row["error"], error_type=row["error_type"],
        traceback=row["traceback"], timed_out=row["timed_out"],
        attempts=row["attempts"])


class SweepEngine:
    """Evaluates ``DesignPoint``s on one fixed workload."""

    def __init__(self, inputs: Dict[str, Any],
                 var_shapes: Dict[str, int],
                 backend: str = "analytic",
                 mode: str = "calibrated",
                 keep_reports: bool = False,
                 max_workers: Optional[int] = None,
                 point_timeout_s: Optional[float] = None,
                 point_retries: int = 0,
                 retry_backoff_s: float = 0.0,
                 batch: bool = True,
                 executor: str = "thread",
                 result_cache: Optional[Any] = None,
                 multi_host: bool = False,
                 device=None):
        self.inputs = dict(inputs)
        self.var_shapes = dict(var_shapes)
        self.backend = backend
        self.mode = mode
        self.keep_reports = keep_reports
        self.max_workers = max_workers
        #: per-point wall-clock budget; a point past it is recorded as
        #: timed out and the sweep proceeds (None = unbounded)
        self.point_timeout_s = point_timeout_s
        #: bounded re-evaluations of a failed / timed-out point
        self.point_retries = point_retries
        self.retry_backoff_s = retry_backoff_s
        #: group points by (mapping signature, intersection config) and
        #: evaluate each group probe-then-replay (analytic backend only)
        self.batch = batch
        if executor not in ("thread", "process"):
            raise ValueError(f"executor must be 'thread' or 'process', "
                             f"got {executor!r}")
        #: 'thread' (shared caches, GIL-bound) or 'process' (sharded
        #: chunks over a process pool, true parallelism)
        self.executor = executor
        #: optional dse.cache.ResultCache serving repeat queries
        self.result_cache = result_cache
        #: shard sweeps across hosts (each host evaluates its
        #: contiguous slice of the points; see launch.mesh.host_shard)
        self.multi_host = multi_host
        #: the device of a 'vector' engine's seams (the CUDA device
        #: unless named; raises without one); None for other backends
        self.device = None
        if backend == "vector":
            from repro_torch.kernels.backends import resolve_device
            self.device = resolve_device(device)
        # shared caches (see module docstring)
        self._plan_cache: Dict[str, Dict[str, EinsumPlan]] = {}
        self._calib_cache: Dict[Tuple, Any] = {}
        self._conv_cache: Dict[Tuple, Any] = {}
        self._sig_cache: Dict[DesignPoint, str] = {}
        self._workload_token = f"wl{next(_token_counter)}"
        self._workload_id: Optional[str] = None
        # simple stats for tests / benchmarks
        self.plan_cache_hits = 0
        self.points_evaluated = 0
        #: coverage tallies of the most recent sweep() call
        self.last_coverage: Dict[str, int] = {}

    # ------------------------------------------------------------------ #
    @property
    def workload_id(self) -> str:
        """Content hash of the workload (cache-key component)."""
        if self._workload_id is None:
            from .cache import workload_hash
            self._workload_id = workload_hash(self.inputs, self.var_shapes)
        return self._workload_id

    def _backend_for(self, token: str):
        if self.backend == "vector":
            from repro_torch.core.vectorized import VectorBackend
            return VectorBackend(device=self.device)
        if self.backend != "analytic":
            return self.backend
        from repro_torch.core.analytic import AnalyticBackend
        # one instance per evaluation (per-cascade predicted-stats are
        # stateful) sharing the engine-wide calibration cache
        return AnalyticBackend(mode=self.mode,
                               calib_cache=self._calib_cache,
                               cache_token=token)

    def _sim_inputs(self, sim: CascadeSimulator) -> Dict[str, Any]:
        """The workload operands, pre-converted to fibertrees and
        cached per stored rank order (analytic backend: the transform
        dominates single-point cost).  Shared read-only across points;
        execution backends keep per-run conversion."""
        if self.backend != "analytic":
            return dict(self.inputs)
        out: Dict[str, Any] = {}
        for name, val in self.inputs.items():
            try:
                ranks = tuple(
                    sim.spec.mapping.rank_order.get(name)
                    or sim.spec.einsum.declaration[name])
            except Exception:               # noqa: BLE001 - let sim cope
                return dict(self.inputs)
            key = (name, ranks)
            ft = self._conv_cache.get(key)
            if ft is None:
                ft = sim._to_ftensor(name, val)
                self._conv_cache[key] = ft
            out[name] = ft
        return out

    def prime(self, point: DesignPoint, calibrate: bool = True) -> None:
        """Pre-pay ``point``'s one-time setup costs (idempotent): the
        dense->fibertree operand conversion and -- for the analytic
        backend, when ``calibrate`` -- the plan lowering and the
        workload-calibration scan, via one throwaway evaluation.
        Benchmarks and long-lived services call this at setup so the
        first timed evaluation runs at steady-state cost.  The
        throwaway run does not touch result caches, point counters, or
        sweep coverage."""
        spec = point.build_spec()
        params = point.default_params()
        sim = CascadeSimulator(spec, params=params, model=False,
                               backend=None)
        self._sim_inputs(sim)
        if not calibrate or self.backend != "analytic":
            return
        sig = mapping_signature(spec, params)
        self._sig_cache[point] = sig
        plans = self._plan_cache.get(sig)
        token = f"{self._workload_token}|{hash(sig):x}"
        sim = CascadeSimulator(spec, params=params,
                               backend=self._backend_for(token),
                               plans=plans)
        if plans is None:
            self._plan_cache[sig] = sim.plans
        sim.run(self._sim_inputs(sim), self.var_shapes)

    # ------------------------------------------------------------------ #
    # result cache
    # ------------------------------------------------------------------ #
    def _cache_key(self, point: DesignPoint) -> Optional[str]:
        if self.result_cache is None:
            return None
        sig = self._sig_cache.get(point)
        if sig is None:
            try:
                sig = mapping_signature(point.build_spec(),
                                        point.default_params())
            except Exception:               # noqa: BLE001
                return None                  # broken point: evaluate it
            self._sig_cache[point] = sig
        from .cache import result_key
        backend = self.backend if isinstance(self.backend, str) else \
            getattr(self.backend, "name", type(self.backend).__name__)
        return result_key(self.workload_id, sig, point, backend, self.mode)

    def _cache_get(self, point: DesignPoint) -> Optional[PointResult]:
        key = self._cache_key(point)
        if key is None:
            return None
        t0 = time.perf_counter()
        hit = self.result_cache.get(key)
        if hit is None:
            return None
        return PointResult(point=point, cached=True,
                           wall_seconds=time.perf_counter() - t0, **hit)

    def _cache_put(self, point: DesignPoint, res: PointResult) -> None:
        if self.result_cache is None or not res.ok \
                or res.cached or res.restored:
            return
        key = self._cache_key(point)
        if key is not None:
            self.result_cache.put(key, res.seconds, res.energy_pj,
                                  res.dram_bytes)

    # ------------------------------------------------------------------ #
    def evaluate(self, point: DesignPoint) -> PointResult:
        """Evaluate one point: result-cache lookup first, then the
        engine's full fault policy (see :meth:`_guarded`)."""
        hit = self._cache_get(point)
        if hit is not None:
            return hit
        res = self._guarded(point, lambda: self._evaluate_once(point))
        self._cache_put(point, res)
        return res

    def _guarded(self, point: DesignPoint,
                 once: Callable[[], PointResult]) -> PointResult:
        """One point under the engine's fault policy: per-point
        wall-clock timeout, then up to ``point_retries`` bounded
        re-attempts with backoff.  Never raises for a point failure --
        the error lands structured on the result (class name, message,
        trimmed traceback).  ``SimulatedCrash`` (a BaseException) is
        deliberately not absorbed: it models the whole process dying.

        Telemetry: one ``point:<label>`` span per evaluation (status /
        attempts / error in the span args) and unconditional
        ``dse.point/<status>`` + ``dse.point_attempts`` counters, so
        sweep health is visible with or without a trace attached."""
        from repro_torch.obs.metrics import metrics
        from repro_torch.obs.spans import active_tracer

        tr = active_tracer()
        sp = tr.span("point:" + point.label, "dse") if tr is not None \
            else None
        if sp is not None:
            sp.__enter__()
        attempts = 0
        res: Optional[PointResult] = None
        try:
            while True:
                attempts += 1
                res = self._evaluate_attempt(point, once)
                res.attempts = attempts
                if res.ok or attempts > self.point_retries:
                    break
                if self.retry_backoff_s > 0.0:
                    time.sleep(min(
                        self.retry_backoff_s * (2 ** (attempts - 1)),
                        5.0))
        finally:
            # res is None only when a SimulatedCrash (BaseException)
            # escaped the attempt -- tally it as a failure
            status = res.status if res is not None else "failed"
            reg = metrics()
            reg.counter("dse.point/" + status).inc()
            reg.counter("dse.point_attempts").inc(attempts)
            if sp is not None:
                sp.set("status", status)
                sp.set("attempts", attempts)
                if res is not None and res.error:
                    sp.set("error", res.error)
                sp.__exit__(None, None, None)
        return res

    def _evaluate_attempt(self, point: DesignPoint,
                          once: Callable[[], PointResult]) -> PointResult:
        if self.point_timeout_s is None:
            return once()
        # a disposable single-use worker so one pathological point
        # cannot stall the sweep; on timeout the worker thread is
        # abandoned (daemonic futures cannot be killed) and the point
        # is recorded as timed out
        ex = ThreadPoolExecutor(max_workers=1)
        fut: Future = ex.submit(once)
        try:
            return fut.result(timeout=self.point_timeout_s)
        except _FutTimeout:
            fut.cancel()
            return PointResult(
                point=point, wall_seconds=self.point_timeout_s,
                error=f"TimeoutError: point exceeded "
                      f"{self.point_timeout_s}s wall-clock budget",
                error_type="TimeoutError", timed_out=True)
        finally:
            ex.shutdown(wait=False, cancel_futures=True)

    def _evaluate_once(self, point: DesignPoint) -> PointResult:
        t0 = time.perf_counter()
        try:
            inj = _active_injector()
            if inj is not None:
                inj.before_point(point.label)
            spec = point.build_spec()
            params = point.default_params()
            sig = mapping_signature(spec, params)
            self._sig_cache[point] = sig
            plans = self._plan_cache.get(sig)
            from repro_torch.obs.metrics import metrics
            if plans is not None:
                self.plan_cache_hits += 1
                metrics().counter("dse.plan_cache/hit").inc()
            else:
                metrics().counter("dse.plan_cache/miss").inc()
            token = f"{self._workload_token}|{hash(sig):x}"
            sim = CascadeSimulator(spec, params=params,
                                   backend=self._backend_for(token),
                                   plans=plans)
            if plans is None:
                self._plan_cache[sig] = sim.plans
            res = sim.run(self._sim_inputs(sim), self.var_shapes)
            rep = res.report
            self.points_evaluated += 1
            return PointResult(
                point=point,
                seconds=rep.seconds,
                energy_pj=rep.energy_pj,
                dram_bytes=rep.dram_bytes,
                wall_seconds=time.perf_counter() - t0,
                fallback_reasons=dict(res.fallback_reasons),
                report=rep if self.keep_reports else None)
        except Exception as exc:                      # noqa: BLE001
            return PointResult(point=point,
                               wall_seconds=time.perf_counter() - t0,
                               error=f"{type(exc).__name__}: {exc}",
                               error_type=type(exc).__name__,
                               traceback=_trim_traceback(exc))

    # ------------------------------------------------------------------ #
    # batched group evaluation (probe + replay)
    # ------------------------------------------------------------------ #
    def _prep(self, point: DesignPoint) -> _Prep:
        spec = point.build_spec()
        params = point.default_params()
        sig = mapping_signature(spec, params)
        self._sig_cache[point] = sig
        return _Prep(point=point, spec=spec, params=params, sig=sig,
                     group_key=(sig, isect_configs(spec)))

    def _probe_once(self, prep: _Prep, ctx: Dict[str, Any]) -> PointResult:
        """Evaluate the first point of a group through the full
        backend, recording the instrumentation stream and the
        ``touch_stat`` consumption sequence for the group's replays."""
        t0 = time.perf_counter()
        try:
            inj = _active_injector()
            if inj is not None:
                inj.before_point(prep.point.label)
            plans = self._plan_cache.get(prep.sig)
            from repro_torch.obs.metrics import metrics
            if plans is not None:
                self.plan_cache_hits += 1
                metrics().counter("dse.plan_cache/hit").inc()
            else:
                metrics().counter("dse.plan_cache/miss").inc()
            token = f"{self._workload_token}|{hash(prep.sig):x}"
            rec = RecordingInstr()
            sim = CascadeSimulator(prep.spec, params=prep.params,
                                   backend=self._backend_for(token),
                                   extra_instr=rec, plans=plans)
            if plans is None:
                self._plan_cache[prep.sig] = sim.plans
            capture = _CaptureFeed()
            with stat_miss_feed(capture):
                res = sim.run(self._sim_inputs(sim), self.var_shapes)
            rep = res.report
            self.points_evaluated += 1
            ctx["rec"] = rec
            ctx["plans"] = sim.plans
            ctx["fallbacks"] = dict(res.fallback_reasons)
            ctx["exec_tensors"] = {
                name: dict(m.tensors)
                for name, m in sim.model.models.items() if m.tensors}
            ctx["capture"] = capture
            ctx["level_keys"] = {id(lvl): key for key, lvl
                                 in sim.model.shared_levels.items()}
            return PointResult(
                point=prep.point,
                seconds=rep.seconds,
                energy_pj=rep.energy_pj,
                dram_bytes=rep.dram_bytes,
                wall_seconds=time.perf_counter() - t0,
                fallback_reasons=dict(res.fallback_reasons),
                report=rep if self.keep_reports else None)
        except Exception as exc:                      # noqa: BLE001
            return PointResult(point=prep.point,
                               wall_seconds=time.perf_counter() - t0,
                               error=f"{type(exc).__name__}: {exc}",
                               error_type=type(exc).__name__,
                               traceback=_trim_traceback(exc))

    def _replay_once(self, prep: _Prep, plans: Dict[str, EinsumPlan],
                     rec: RecordingInstr,
                     exec_tensors: Dict[str, Dict[str, Any]],
                     fallbacks: Dict[str, str],
                     feed: Optional[_ReplayFeed],
                     premodel: Optional[List[Any]] = None) -> PointResult:
        """Re-consume the group's recorded stream through this point's
        own ``PerformanceModel``: same events, this point's component
        attributes -- bit-identical to a full evaluation by
        construction.  ``premodel`` is a one-shot container holding a
        model prebuilt by :meth:`_replay_feeds`; the first attempt pops
        it, retries and abandoned timeout threads always build fresh so
        no attempt can observe another's partial state."""
        t0 = time.perf_counter()
        try:
            inj = _active_injector()
            if inj is not None:
                inj.before_point(prep.point.label)
            from repro_torch.obs.metrics import metrics
            self.plan_cache_hits += 1
            metrics().counter("dse.plan_cache/hit").inc()
            model = premodel.pop() if premodel else \
                PerformanceModel(prep.spec, plans)
            for name, tensors in exec_tensors.items():
                model.register_exec_tensors(name, tensors)
            if feed is not None:
                feed.reset()
                with stat_miss_feed(feed):
                    rec.replay(model)
            else:
                rec.replay(model)
            rep = _evaluate_report(prep.spec, plans, model)
            rep.fallback_reasons = dict(fallbacks)
            self.points_evaluated += 1
            return PointResult(
                point=prep.point,
                seconds=rep.seconds,
                energy_pj=rep.energy_pj,
                dram_bytes=rep.dram_bytes,
                wall_seconds=time.perf_counter() - t0,
                fallback_reasons=dict(fallbacks),
                report=rep if self.keep_reports else None)
        except Exception as exc:                      # noqa: BLE001
            return PointResult(point=prep.point,
                               wall_seconds=time.perf_counter() - t0,
                               error=f"{type(exc).__name__}: {exc}",
                               error_type=type(exc).__name__,
                               traceback=_trim_traceback(exc))

    def _replay_feeds(self, ctx: Dict[str, Any], rest: Sequence[_Prep],
                      plans: Dict[str, EinsumPlan]
                      ) -> Tuple[List[Optional[_ReplayFeed]],
                                 List[Optional[Any]]]:
        """Vectorize the capacity-dependent miss closed form across the
        group's point axis: one ``batched_stat_misses`` call per
        recorded ``touch_stat`` occurrence covers every point.

        Returns ``(feeds, models)``: the per-point replay feeds (all
        None when the scalar path must be used) and the per-point
        ``PerformanceModel`` built to read the capacities off -- handed
        to :meth:`_replay_once` so the first replay attempt reuses it
        instead of building a second identical model."""
        none: List[Optional[_ReplayFeed]] = [None] * len(rest)
        models: List[Optional[Any]] = []
        for prep in rest:
            try:
                models.append(PerformanceModel(prep.spec, plans))
            except Exception:               # noqa: BLE001 - scalar path
                models.append(None)
        capture: _CaptureFeed = ctx.get("capture")
        level_keys: Dict[int, Tuple] = ctx.get("level_keys", {})
        if capture is None or not capture.calls or None in models:
            return none, models
        occurrences = []
        for level, nbytes, n, unique in capture.calls:
            key = level_keys.get(id(level))
            if key is None:
                return none, models
            occurrences.append((key, nbytes, n, unique))
        caps_list = [{k: lvl.capacity_bytes
                      for k, lvl in m.shared_levels.items()}
                     for m in models]
        values = np.empty((len(occurrences), len(rest)), dtype=np.float64)
        for i, (key, nbytes, n, unique) in enumerate(occurrences):
            caps = np.array([c.get(key, np.nan) for c in caps_list],
                            dtype=np.float64)
            values[i] = batched_stat_misses(n, unique, nbytes, caps)
        feeds = [_ReplayFeed(occurrences, values[:, j].tolist(),
                             caps_list[j])
                 for j in range(len(rest))]
        return feeds, models

    def _sweep_batched(self, todo: Sequence[DesignPoint],
                       done: Dict[str, PointResult],
                       maybe_save: Callable[[], None]) -> None:
        """Group -> probe -> replay evaluation of every pending point
        (analytic backend).  Each point still passes through the full
        per-point fault policy; a probe failure or an overflowed
        recorder degrades the group to per-point evaluation."""
        groups: "Dict[Tuple, List[_Prep]]" = {}
        order: List[Tuple] = []
        for p in todo:
            try:
                prep = self._prep(p)
            except Exception:               # noqa: BLE001
                # a point whose spec will not even build: route through
                # the per-point path for the structured error + counters
                done[p.label] = self.evaluate(p)
                maybe_save()
                continue
            if prep.group_key not in groups:
                groups[prep.group_key] = []
                order.append(prep.group_key)
            groups[prep.group_key].append(prep)

        for key in order:
            members = groups[key]
            ctx: Dict[str, Any] = {}
            probe = members[0]
            res0 = self._guarded(probe.point,
                                 lambda: self._probe_once(probe, ctx))
            done[probe.point.label] = res0
            self._cache_put(probe.point, res0)
            maybe_save()
            rest = members[1:]
            if not rest:
                continue
            rec: Optional[RecordingInstr] = ctx.get("rec")
            if not res0.ok or rec is None or rec.overflowed:
                for prep in rest:
                    done[prep.point.label] = self.evaluate(prep.point)
                    maybe_save()
                continue
            plans = ctx["plans"]
            exec_tensors = ctx.get("exec_tensors", {})
            fallbacks = ctx.get("fallbacks", {})
            feeds, models = self._replay_feeds(ctx, rest, plans)
            for prep, feed, model in zip(rest, feeds, models):
                pre = [model] if model is not None else []
                res = self._guarded(
                    prep.point,
                    lambda p=prep, f=feed, pm=pre: self._replay_once(
                        p, plans, rec, exec_tensors, fallbacks, f, pm))
                done[prep.point.label] = res
                self._cache_put(prep.point, res)
                maybe_save()

    # ------------------------------------------------------------------ #
    # process-pool sharded sweep
    # ------------------------------------------------------------------ #
    def _start_method(self) -> str:
        """The process pool's start method: ``fork`` where the platform
        has it, but ``spawn`` when the engine runs seams through torch
        (a 'vector' engine, on any device): a forked child of a process
        that has initialised CUDA cannot use it, and one of a process
        that has run torch's CPU thread pool can hang in its first
        parallel op."""
        import multiprocessing as mp
        torch_seams = self.device is not None
        return "fork" if "fork" in mp.get_all_start_methods() \
            and not torch_seams else "spawn"

    def _sweep_process(self, todo: Sequence[DesignPoint],
                       done: Dict[str, PointResult],
                       maybe_save: Callable[[], None],
                       workers: int, checkpoint_every: int) -> None:
        """Shard ``todo`` into contiguous chunks over a process pool;
        each worker runs its own batched engine.  Chunk size is bounded
        by ``checkpoint_every`` so the parent checkpoints at a
        comparable cadence to the serial path."""
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        chunk = max(1, math.ceil(len(todo) / workers))
        if checkpoint_every > 0:
            chunk = min(chunk, max(checkpoint_every, 1))
        chunks = [list(todo[i:i + chunk])
                  for i in range(0, len(todo), chunk)]
        by_label = {p.label: p for p in todo}

        engine_kw = dict(backend=self.backend, mode=self.mode,
                         max_workers=1, point_timeout_s=self.point_timeout_s,
                         point_retries=self.point_retries,
                         retry_backoff_s=self.retry_backoff_s,
                         batch=self.batch, device=self.device)
        inj = _active_injector()
        fault_payload = None
        if inj is not None:
            from dataclasses import replace
            fault_payload = ([replace(sp, calls=0, fired=0)
                              for sp in inj.specs], inj.seed)

        ctx = mp.get_context(self._start_method())
        with ProcessPoolExecutor(
                max_workers=min(workers, len(chunks)), mp_context=ctx,
                initializer=_pool_init,
                initargs=(self.inputs, self.var_shapes, engine_kw,
                          fault_payload)) as pool:
            futs = {pool.submit(_pool_run, c): c for c in chunks}
            pending = set(futs)
            while pending:
                finished, pending = _fut_wait(
                    pending, return_when=FIRST_COMPLETED)
                for f in finished:
                    # a SimulatedCrash (or a genuinely dead worker:
                    # BrokenProcessPool) re-raises here; sweep()'s
                    # BaseException handler runs the final save
                    rows = f.result()
                    for row in rows:
                        p = by_label[row["label"]]
                        res = _unpack_result(row, p)
                        done[res.label] = res
                        self._cache_put(p, res)
                maybe_save()

    # ------------------------------------------------------------------ #
    def sweep(self, points: Sequence[DesignPoint],
              warm: bool = True,
              checkpoint_dir: Optional[str] = None,
              checkpoint_every: int = 16,
              resume: bool = False) -> List[PointResult]:
        """Evaluate every point, preserving input order.

        Evaluation strategy, in precedence order: checkpoint-restored
        and result-cached points are served without the backend; with
        ``executor='process'`` and ``max_workers > 1`` the rest are
        sharded over a process pool; the analytic backend with
        ``batch=True`` (the default) evaluates grouped points
        probe-then-replay; execution backends fall back to the
        threaded pool (``max_workers > 1``, ``warm`` evaluates the
        first point up front to populate the shared caches) or the
        serial loop.

        With ``checkpoint_dir`` the sweep saves its completed results
        (objectives + structured errors) atomically every
        ``checkpoint_every`` completions and once at the end -- on an
        interruption (including a :class:`SimulatedCrash`) a final
        best-effort save still runs, so ``resume=True`` on a later
        call restores every checkpointed point by label instead of
        re-evaluating it.  A point never finishes silently in neither
        state: it is either in the results or still pending.

        With ``multi_host=True`` each host evaluates only its
        contiguous shard of the points (``launch.mesh.host_shard``)
        and returns results for that shard; give each host its own
        ``checkpoint_dir``.

        Coverage tallies of the call land on ``self.last_coverage``
        (total / evaluated / ok / failed / timed_out / skipped /
        cached, where skipped counts checkpoint-restored points)."""
        points = list(points)
        self.last_coverage = {}
        if not points:
            return []
        if self.multi_host:
            from repro_torch.launch.mesh import host_shard
            points = host_shard(points)
            if not points:
                return []

        done: Dict[str, PointResult] = {}
        store = None
        saved_count = 0
        if checkpoint_dir is not None:
            from repro_torch.dse.sweep_ckpt import SweepCheckpointStore
            store = SweepCheckpointStore(checkpoint_dir)
            if resume:
                for r in store.load(points):
                    done[r.label] = r
                saved_count = len(done)

        todo = [p for p in points if p.label not in done]
        if self.result_cache is not None:
            still: List[DesignPoint] = []
            for p in todo:
                hit = self._cache_get(p)
                if hit is not None:
                    done[p.label] = hit
                else:
                    still.append(p)
            todo = still

        def maybe_save(final: bool = False) -> None:
            nonlocal saved_count
            if store is None:
                return
            if final or (len(done) - saved_count) >= checkpoint_every:
                store.save(list(done.values()), n_total=len(points))
                saved_count = len(done)

        try:
            workers = self.max_workers or 1
            if self.executor == "process" and workers > 1 \
                    and len(todo) > 1 and isinstance(self.backend, str) \
                    and not self.keep_reports:
                self._sweep_process(todo, done, maybe_save, workers,
                                    checkpoint_every
                                    if store is not None else 0)
            elif self.batch and self.backend == "analytic" and todo:
                self._sweep_batched(todo, done, maybe_save)
            elif workers <= 1 or len(todo) <= 1:
                for p in todo:
                    done[p.label] = self.evaluate(p)
                    maybe_save()
            else:
                head = todo[:1] if warm else []
                for p in head:
                    done[p.label] = self.evaluate(p)
                    maybe_save()
                rest = todo[1:] if warm else todo
                with ThreadPoolExecutor(max_workers=workers) as pool:
                    futs = {pool.submit(self.evaluate, p): p
                            for p in rest}
                    pending = set(futs)
                    while pending:
                        finished, pending = _fut_wait(
                            pending, return_when=FIRST_COMPLETED)
                        for f in finished:
                            done[futs[f].label] = f.result()
                        maybe_save()
        except BaseException:
            # a crash mid-sweep (SimulatedCrash, KeyboardInterrupt)
            # still publishes what completed, so --resume works
            maybe_save(final=True)
            if self.result_cache is not None:
                try:
                    self.result_cache.flush()
                except Exception:           # noqa: BLE001 - best effort
                    pass
            raise
        maybe_save(final=True)
        if self.result_cache is not None:
            self.result_cache.flush()

        results = [done[p.label] for p in points]
        self.last_coverage = self.coverage(results)
        return results

    # ------------------------------------------------------------------ #
    @staticmethod
    def coverage(results: Sequence[PointResult]) -> Dict[str, int]:
        """Tally results by outcome (``skipped`` = restored from a
        checkpoint, ``cached`` = served from the result cache -- both
        excluded from ``evaluated``)."""
        cov = {"total": len(results), "evaluated": 0, "ok": 0,
               "failed": 0, "timed_out": 0, "skipped": 0, "cached": 0}
        for r in results:
            if r.restored:
                cov["skipped"] += 1
            elif r.cached:
                cov["cached"] += 1
            else:
                cov["evaluated"] += 1
            if r.ok:
                cov["ok"] += 1
            elif r.timed_out:
                cov["timed_out"] += 1
            else:
                cov["failed"] += 1
        return cov

    @staticmethod
    def summarize(results: Sequence[PointResult]) -> str:
        """One-line sweep coverage summary for logs / CLI output."""
        cov = SweepEngine.coverage(results)
        extra = f", {cov['cached']} cached" if cov["cached"] else ""
        return (f"{cov['ok']}/{cov['total']} ok "
                f"({cov['evaluated']} evaluated, "
                f"{cov['skipped']} restored{extra}, "
                f"{cov['failed']} failed, "
                f"{cov['timed_out']} timed out)")
