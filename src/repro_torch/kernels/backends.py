"""Seam lowerings of the vector engine on a torch device.

The columnar ``VectorBackend`` funnels its data-parallel primitives
through five seams -- ``intersect_keys`` / ``union_keys`` /
``union_k_keys`` / ``lookup_keys`` / ``segmented_reduce`` -- each taking
and returning numpy arrays (the reference ``NumpyKernels`` signatures).
Two lowerings, chosen by the device:

  * ``cuda``   ``CudaKernels``: the hand-written CUDA kernels (``search``,
               ``merge_path``, ``multi_merge_ranks``).  Each call moves
               its inputs to the card, launches, and brings back only
               the result.
  * ``torch``  ``TorchKernels``: the kernels' plain PyTorch versions on
               any device (the CPU tests; on the card, the yardstick the
               kernels are held to).

Keys and positions are int64 end to end and lengths are explicit: no
key value is reserved as a pad, and packed offset keys up to 2^62 stay
on the kernel path.  ``segmented_reduce`` runs in host numpy in both
lowerings (its in-order fold is the reference's; a device kernel for it
is later work).

Parity contract: for any admissible input every seam returns arrays
bit-identical to the reference numpy lowering -- positions, union
orders and float accumulation order included.

Every seam call goes through ``GuardedKernels``: the fault injector's
hooks (``repro_torch.testing.faults``), seam postconditions and a
``DowngradeEvent`` for every fault.  Its chain holds the one lowering
the device selects; when that fails, ``KernelChainExhausted``
propagates.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.core import guards
from repro_torch.obs.metrics import metrics as _obs_metrics
from repro_torch.obs.spans import active_tracer as _obs_tracer
from repro_torch.testing.faults import active_injector as _active_injector

from .merge import merge_path, merge_path_plain
from .multi_merge import multi_merge_ranks, multi_merge_ranks_plain
from .search import search, search_plain


def resolve_device(device=None) -> torch.device:
    """The device a simulation runs on: the CUDA device unless the
    caller names another.  Never falls back to the CPU by itself."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on the CUDA device by default, and no "
                "CUDA device is available; pass device='cpu' to run the "
                "kernels' plain versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


# ---------------------------------------------------------------------- #
# the lowerings
# ---------------------------------------------------------------------- #
class TorchKernels:
    """The seams over the kernels' plain PyTorch versions on
    ``device``."""

    name = "torch"
    _search = staticmethod(search_plain)
    _merge = staticmethod(merge_path_plain)
    _multi_merge = staticmethod(multi_merge_ranks_plain)

    def __init__(self, device="cpu"):
        self.device = torch.device(device)

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)) \
            .to(self.device)

    @staticmethod
    def _to_host(t: torch.Tensor) -> np.ndarray:
        return t.cpu().numpy()

    # -------------------------------------------------------------- #
    def intersect_keys(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """Positions in ``b`` of every element of ``a`` (both sorted
        int64 key arrays; keys unique per array), -1 where absent."""
        a = np.asarray(a, dtype=np.int64)
        b = np.asarray(b, dtype=np.int64)
        if len(a) == 0 or len(b) == 0:
            return np.full(len(a), -1, dtype=np.int64)
        return self._to_host(self._search(self._to_dev(b), self._to_dev(a)))

    def lookup_keys(self, hay: np.ndarray, probes: np.ndarray
                    ) -> np.ndarray:
        """Positions in ``hay`` (sorted int64, unique) of every
        ``probes`` element (arbitrary order, duplicates fine), -1 where
        absent.  The search takes unsorted probes as they are."""
        hay = np.asarray(hay, dtype=np.int64)
        probes = np.asarray(probes, dtype=np.int64)
        if len(probes) == 0 or len(hay) == 0:
            return np.full(len(probes), -1, dtype=np.int64)
        return self._to_host(self._search(self._to_dev(hay),
                                          self._to_dev(probes)))

    # -------------------------------------------------------------- #
    @staticmethod
    def _dedup(merged: torch.Tensor) -> torch.Tensor:
        keep = torch.ones(len(merged), dtype=torch.bool,
                          device=merged.device)
        keep[1:] = merged[1:] != merged[:-1]
        return merged[keep]

    def _merged_union(self, rows: List[torch.Tensor]) -> torch.Tensor:
        """Sorted union of non-empty sorted rows on the device: the
        2-way merge for two rows, the k-way merge ranks plus a scatter
        for more; then dedup of adjacent equal keys."""
        if len(rows) == 1:
            return rows[0]
        if len(rows) == 2:
            merged = self._merge(rows[0], rows[1])[0]
        else:
            keys = torch.cat(rows)
            offs = np.zeros(len(rows) + 1, dtype=np.int64)
            np.cumsum([len(r) for r in rows], out=offs[1:])
            ranks = self._multi_merge(keys, self._to_dev(offs))
            # the ranks are a permutation: the scatter is deterministic
            merged = torch.empty_like(keys)
            merged[ranks] = keys
        return self._dedup(merged)

    def union_keys(self, a: np.ndarray, b: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Sorted union of two sorted int64 key arrays (keys unique per
        array).  Returns (union, pos_a, pos_b): for every union element
        its position in ``a`` / ``b`` or -1."""
        a = np.asarray(a, dtype=np.int64)
        b = np.asarray(b, dtype=np.int64)
        if len(a) == 0:
            return (b.copy(), np.full(len(b), -1, dtype=np.int64),
                    np.arange(len(b), dtype=np.int64))
        if len(b) == 0:
            return (a.copy(), np.arange(len(a), dtype=np.int64),
                    np.full(len(a), -1, dtype=np.int64))
        ta, tb = self._to_dev(a), self._to_dev(b)
        u = self._merged_union([ta, tb])
        return (self._to_host(u), self._to_host(self._search(ta, u)),
                self._to_host(self._search(tb, u)))

    def union_k_keys(self, arrays) -> Tuple[np.ndarray, list]:
        """Sorted union of k sorted int64 key arrays (keys unique per
        array).  Returns (union, [pos_i]): for every union element its
        position in array i, or -1 where absent."""
        arrays = [np.asarray(a, dtype=np.int64) for a in arrays]
        if len(arrays) == 1:
            a = arrays[0]
            return a.copy(), [np.arange(len(a), dtype=np.int64)]
        if len(arrays) == 2:
            u, pa, pb = self.union_keys(arrays[0], arrays[1])
            return u, [pa, pb]
        rows = [self._to_dev(a) if len(a) else None for a in arrays]
        nonempty = [r for r in rows if r is not None]
        if not nonempty:
            z = np.zeros(0, dtype=np.int64)
            return z, [z.copy() for _ in arrays]
        u = self._merged_union(nonempty)
        out = [np.full(len(u), -1, dtype=np.int64) if r is None
               else self._to_host(self._search(r, u)) for r in rows]
        return self._to_host(u), out

    # -------------------------------------------------------------- #
    def segmented_reduce(self, vals: np.ndarray, starts: np.ndarray,
                         semiring=None,
                         group_ids: Optional[np.ndarray] = None
                         ) -> np.ndarray:
        """Semiring-parameterized segmented reduction over a
        fused-key-sorted value stream, in host numpy: ``starts[g]`` is
        the first index of group ``g`` (ascending, ``starts[0] == 0``);
        returns one reduced value per group.

        Values fold strictly left-to-right within each group,
        bit-identical to the interpreter's sequential ``semiring.add``
        chain.  Three lowerings, fastest admissible wins:

        * float addition (the arithmetic semiring) -- one weighted
          ``np.bincount`` pass, a plain C loop in input order (NOT
          ``np.add.reduceat``, which sums pairwise);
        * a declared ``add_ufunc`` (min-plus: min is exact under any
          association) -- one ``ufunc.reduceat``;
        * otherwise -- a step-loop over ``add_vec`` bounded by the
          largest group.

        ``group_ids`` (optional, 0-based group index per element) lets
        a caller that already materialized the group boundaries skip
        their reconstruction on the bincount path."""
        vals = np.asarray(vals)
        starts = np.asarray(starts, dtype=np.int64)
        n = len(vals)
        if len(starts) == 0:
            return vals[:0].copy()
        if (semiring is None or semiring.add_vec is np.add) and \
                vals.dtype == np.float64:
            gids = group_ids
            if gids is None:
                gids = np.zeros(n, dtype=np.int64)
                gids[starts[1:]] = 1
                np.cumsum(gids, out=gids)
            return np.bincount(gids, weights=vals, minlength=len(starts))
        ufunc = None if semiring is None else semiring.add_ufunc
        if ufunc is not None:
            return ufunc.reduceat(vals, starts)
        add_vec = np.add if semiring is None else semiring.add_vec
        counts = np.diff(np.append(starts, n))
        sums = vals[starts].copy()
        step = 1
        max_c = int(counts.max())
        while step < max_c:
            act = np.flatnonzero(counts > step)
            sums[act] = add_vec(sums[act], vals[starts[act] + step])
            step += 1
        return sums


class CudaKernels(TorchKernels):
    """The seams over the hand-written CUDA kernels.  Their wrappers
    launch on a CUDA tensor or raise; nothing falls back to the plain
    versions."""

    name = "cuda"
    _search = staticmethod(search)
    _merge = staticmethod(merge_path)
    _multi_merge = staticmethod(multi_merge_ranks)

    def __init__(self, device="cuda"):
        super().__init__(device)
        if self.device.type != "cuda":
            raise ValueError(f"CudaKernels needs a CUDA device, got "
                             f"{self.device}")


def kernels_for(device: torch.device) -> TorchKernels:
    """The lowering a device selects: the hand kernels on ``cuda``, the
    plain versions elsewhere."""
    return CudaKernels(device) if device.type == "cuda" \
        else TorchKernels(device)


# ---------------------------------------------------------------------- #
# guarded dispatch
# ---------------------------------------------------------------------- #
#: failures of one seam x backend pair after which the pair is demoted
DEMOTE_AFTER = 3


@dataclass(frozen=True)
class DowngradeEvent:
    """One structured record of the guard acting on a seam fault.

    ``action`` is one of:

    * ``downgrade``   the seam call failed on its backend; ``fallback``
                      names the next backend tried ("": none, the call
                      raises),
    * ``demote``      the seam x backend pair crossed the failure
                      threshold and is skipped for the rest of the
                      process.

    Every caught seam fault produces at least one event -- the guard
    never swallows silently.  ``ts_us`` is a monotonic microsecond
    timestamp and ``einsum`` the Einsum active on the owning executor,
    both stamped at record time."""
    seam: str
    backend: str
    fallback: str
    action: str              # downgrade | demote
    reason: str
    exc_type: str
    attempts: int = 1
    ts_us: float = 0.0       # monotonic; stamped by _record
    einsum: str = ""         # active Einsum at record time

    def as_dict(self) -> Dict[str, object]:
        return {"seam": self.seam, "backend": self.backend,
                "fallback": self.fallback, "action": self.action,
                "reason": self.reason, "exc_type": self.exc_type,
                "attempts": self.attempts, "ts_us": self.ts_us,
                "einsum": self.einsum}


class KernelChainExhausted(RuntimeError):
    """Every backend in the chain failed for a seam call."""


class SeamPostconditionError(RuntimeError):
    """A seam lowering returned an output violating the seam's
    contract (wrong length, out-of-range positions, unsorted union,
    non-finite reduction under an arithmetic semiring)."""


# process-wide guard state: demotions are permanent for the process (a
# backend that failed N times is not coming back), and the event
# counter is what chaos runs compare against injected-fault counts
_GUARD_LOCK = threading.Lock()
_DEMOTED: Set[Tuple[str, str]] = set()
_FAIL_COUNTS: Dict[Tuple[str, str], int] = {}
_EVENTS_RECORDED = 0


def events_recorded() -> int:
    """Total DowngradeEvents recorded process-wide (chaos accounting:
    must cover every injected seam fault, else the run was silent)."""
    return _EVENTS_RECORDED


def reset_guard_state() -> None:
    """Test hook: forget demotions, failure tallies and the event
    counter."""
    global _EVENTS_RECORDED
    with _GUARD_LOCK:
        _DEMOTED.clear()
        _FAIL_COUNTS.clear()
        _EVENTS_RECORDED = 0


def _postcheck(seam: str, args, kwargs, out) -> None:
    """Cheap seam-contract postconditions (O(n) vectorized compares).
    A violation fails the call like any other fault of the lowering."""
    if seam == "intersect_keys":
        a, b = args[0], args[1]
        arr = np.asarray(out)
        if len(arr) != len(a):
            raise SeamPostconditionError(
                f"intersect_keys returned {len(arr)} positions for "
                f"{len(a)} keys")
        if len(arr) and (int(arr.max()) >= len(b) or int(arr.min()) < -1):
            raise SeamPostconditionError(
                "intersect_keys position out of range")
    elif seam == "lookup_keys":
        hay, probes = args[0], args[1]
        arr = np.asarray(out)
        if len(arr) != len(probes):
            raise SeamPostconditionError(
                f"lookup_keys returned {len(arr)} positions for "
                f"{len(probes)} probes")
        if len(arr) and (int(arr.max()) >= len(hay) or int(arr.min()) < -1):
            raise SeamPostconditionError("lookup_keys position out of range")
    elif seam == "union_keys":
        u, pa, pb = out
        u = np.asarray(u)
        if len(u) > 1 and bool((np.diff(u) <= 0).any()):
            raise SeamPostconditionError("union_keys output not "
                                         "strictly sorted")
        if len(pa) != len(u) or len(pb) != len(u):
            raise SeamPostconditionError("union_keys position length "
                                         "mismatch")
    elif seam == "union_k_keys":
        u, pos_list = out
        u = np.asarray(u)
        if len(u) > 1 and bool((np.diff(u) <= 0).any()):
            raise SeamPostconditionError("union_k_keys output not "
                                         "strictly sorted")
        if any(len(p) != len(u) for p in pos_list):
            raise SeamPostconditionError("union_k_keys position length "
                                         "mismatch")
    elif seam == "segmented_reduce":
        starts = args[1]
        arr = np.asarray(out)
        if len(arr) != len(starts):
            raise SeamPostconditionError(
                f"segmented_reduce returned {len(arr)} groups for "
                f"{len(starts)} starts")
        semiring = kwargs.get("semiring",
                              args[2] if len(args) > 2 else None)
        arithmetic = semiring is None or semiring.add_vec is np.add
        if arr.dtype.kind == "f" and len(arr):
            with np.errstate(invalid="ignore"):
                if arithmetic:
                    # inf is as illegal as NaN under plain addition
                    bad = not bool(np.isfinite(arr).all())
                else:
                    # tropical semirings use inf legitimately (the
                    # additive identity of min-plus) -- but NaN never is
                    bad = bool(np.isnan(arr).any())
            if bad:
                raise SeamPostconditionError(
                    "segmented_reduce produced "
                    + ("non-finite values under an arithmetic semiring"
                       if arithmetic else "NaN values"))


class GuardedKernels:
    """Guarded dispatch around one seam lowering -- the whole chain: on
    the card nothing stands behind the hand kernels.

    Exposes the same five seam methods as the raw lowerings; each call

    * calls the active fault injector's ``before_seam`` and
      ``after_seam`` hooks around the lowering,
    * runs the seam postconditions (when ``REPRO_GUARDS`` != off),
      turning a *corrupted* output into a failure,
    * records every failure as a :class:`DowngradeEvent` -- drained by
      the executor via :meth:`pop_events` onto ``SimResult`` -- and
      raises :class:`KernelChainExhausted`,
    * demotes a seam x backend pair for the rest of the process after
      ``DEMOTE_AFTER`` failures (its later calls raise at once).

    On the card the executor lets the error through to the caller; on
    the CPU its per-Einsum isolation reruns on the interpreter."""

    def __init__(self, primary):
        self.backend = primary
        self.name = getattr(primary, "name", type(primary).__name__)
        self.device = getattr(primary, "device", None)
        self._events: List[DowngradeEvent] = []
        self._lock = threading.Lock()
        #: the Einsum currently executing on the owning backend; set by
        #: ``VectorBackend`` around ``_run`` so DowngradeEvents and seam
        #: spans carry their Einsum attribution
        self.current_einsum = ""

    # -------------------------------------------------------------- #
    def pop_events(self) -> List[DowngradeEvent]:
        """Drain the events recorded since the last drain."""
        with self._lock:
            out, self._events = self._events, []
        return out

    def _record(self, ev: DowngradeEvent) -> None:
        global _EVENTS_RECORDED
        ev = replace(ev, ts_us=time.perf_counter() * 1e6,
                     einsum=ev.einsum or self.current_einsum)
        with self._lock:
            self._events.append(ev)
        with _GUARD_LOCK:
            _EVENTS_RECORDED += 1
        # rare-event telemetry: counters always, trace instant only
        # when a tracer is installed
        _obs_metrics().counter("kernel.downgrade/" + ev.action).inc()
        tr = _obs_tracer()
        if tr is not None:
            tr.instant("downgrade:" + ev.action, cat="downgrade",
                       args=ev.as_dict())

    # -------------------------------------------------------------- #
    def _call(self, seam: str, *args, **kwargs):
        tr = _obs_tracer()
        if tr is None:
            return self._dispatch(seam, args, kwargs, None)
        with tr.span("seam:" + seam, cat="seam",
                     args={"einsum": self.current_einsum}
                     if self.current_einsum else None) as sp:
            return self._dispatch(seam, args, kwargs, sp)

    def _dispatch(self, seam: str, args, kwargs, span):
        key = (seam, self.name)
        # lock-free read: set membership is atomic under the GIL and
        # demotions only ever grow the set
        if key in _DEMOTED:
            raise KernelChainExhausted(
                f"seam {seam!r} is demoted on backend {self.name!r}")
        inj = _active_injector()
        try:
            if inj is not None:
                inj.before_seam(seam, self.name)
            if span is not None:
                t0 = time.perf_counter()
            out = getattr(self.backend, seam)(*args, **kwargs)
            if span is not None:
                _obs_metrics().histogram(
                    f"kernel.seam_seconds/{seam}/{self.name}"
                ).observe(time.perf_counter() - t0)
                span.set("backend", self.name)
            if inj is not None:
                out = inj.after_seam(seam, self.name, out)
            if guards.enabled():
                _postcheck(seam, args, kwargs, out)
            return out
        except Exception as exc:
            self._note_failure(seam, exc)
            raise KernelChainExhausted(
                f"kernel backend {self.name!r} failed for seam {seam!r}: "
                f"{type(exc).__name__}: {exc}") from exc

    def _note_failure(self, seam: str, exc: BaseException) -> None:
        self._record(DowngradeEvent(
            seam=seam, backend=self.name, fallback="", action="downgrade",
            reason=str(exc), exc_type=type(exc).__name__))
        key = (seam, self.name)
        with _GUARD_LOCK:
            _FAIL_COUNTS[key] = _FAIL_COUNTS.get(key, 0) + 1
            demote = (_FAIL_COUNTS[key] >= DEMOTE_AFTER
                      and key not in _DEMOTED)
            if demote:
                _DEMOTED.add(key)
        if demote:
            self._record(DowngradeEvent(
                seam=seam, backend=self.name, fallback="", action="demote",
                reason=f"{_FAIL_COUNTS[key]} failures "
                       f"(threshold {DEMOTE_AFTER})",
                exc_type=type(exc).__name__))

    # -------------------------------------------------------------- #
    # the seam surface (mirrors TorchKernels)
    # -------------------------------------------------------------- #
    def intersect_keys(self, a, b):
        return self._call("intersect_keys", a, b)

    def union_keys(self, a, b):
        return self._call("union_keys", a, b)

    def union_k_keys(self, arrays):
        return self._call("union_k_keys", arrays)

    def lookup_keys(self, hay, probes):
        return self._call("lookup_keys", hay, probes)

    def segmented_reduce(self, vals, starts, semiring=None,
                         group_ids=None):
        return self._call("segmented_reduce", vals, starts,
                          semiring=semiring, group_ids=group_ids)


def resolve_guarded_kernels(which=None, device=None) -> GuardedKernels:
    """The guarded dispatch for a lowering instance, or for the one
    ``device`` selects (see :func:`resolve_device`) when ``which`` is
    None."""
    if isinstance(which, GuardedKernels):
        return which
    if which is None:
        which = kernels_for(resolve_device(device))
    return GuardedKernels(which)
