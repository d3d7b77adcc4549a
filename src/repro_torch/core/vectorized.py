"""VectorBackend: columnar per-rank co-iteration over CSF arrays.

Execution is a three-stage pipeline (DESIGN.md):

  1. ``core/vplan.py`` lowers the ``EinsumPlan`` into the **VectorPlan
     IR** -- a per-loop-rank list of typed ops (``Drive`` /
     ``Intersect`` / ``UnionK`` / ``DenseEnumerate`` / ``Lookup``) plus
     a ``Reduce``; every unsupported-plan decision happens there, so
     once lowering succeeds execution cannot bail mid-flight (the one
     data-dependent exception, ``_CapacityExceeded`` on int64 key
     overflow, also routes to the interpreter fallback).
  2. For the columnar entry point (``execute_csf``) a **pre-pass**
     applies the Einsum's Section-3.2 transform recipe (flatten /
     uniform partitioning / swizzle) directly on the CSF arrays.
  3. This module **executes** the IR one rank at a time: the set of
     live iteration points at each loop level (the frontier) is a
     struct-of-arrays, and each IR op maps onto a batched kernel
     primitive via ``_DISPATCH`` -- segment expansion, offset-keyed
     sorted intersection / k-ary union / probe gathers
     (``repro_torch.kernels.backends``: hand-written CUDA kernels on
     the card, their plain PyTorch versions on the CPU), and a
     segmented in-order reduction.

Instrumentation counts are emitted in aggregate (one ``n``-weighted
call per action kind) and match the interpreter's per-element counts
exactly -- including the lazy-pull semantics of nested two-finger
intersections, leader-follower probing, and catch-up lookups; output
fibertrees are bit-identical, including float accumulation order.
Semirings with vectorized forms (min-plus, or-and) parameterize leaf
compute and the segmented reduction; affine / constant access indices
translate coordinates on the ``Lookup`` probe stream; update-in-place
outputs seed the reduction groups from the existing tensor's points.
Plans still outside the IR -- bare copies, sums of non-atomic or
rank-unaligned terms, affine output indices, interpreter-only
semirings -- fall back to ``PythonBackend`` on the CPU.  On the CUDA
device nothing falls back: such a plan, or a kernel fault, raises.
"""
from __future__ import annotations

import time
from collections import Counter
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs.metrics import metrics as _obs_metrics
from repro_torch.obs.spans import active_tracer

from .csf import CSF, _from_sorted_points
from .einsum import BinOp, Semiring, Take, TensorAccess
from .fibertree import FTensor
from .guards import check_conservation, check_finite
from .iteration import ExecutorBackend, PythonBackend
from .mapping import EinsumPlan
from .trace import Instrumentation, NullInstr
from .vplan import (DenseEnumerate, Drive, Intersect, LevelIR, Lookup,
                    UnionK, VectorPlan, _Unsupported, lower,
                    prepare_csf_inputs)

#: level-0 frontier slice size used to bound peak expansion memory when
#: the outermost loop rank is an output rank (slices are independent).
#: 512 measures ~15% faster than 1024 on 10k x 10k @ 1% SpMSpM: the
#: per-chunk working set stays closer to cache and large allocations
#: churn less
DEFAULT_CHUNK_ITEMS = 512

#: widest dense group-accumulator the fused leaf reduction will
#: allocate (slots; float64 sums + int64 counts ~= 16 B/slot)
DENSE_GROUP_CAP = 1 << 25

_I32_N = 1 << 31

#: pipeline-stage order used when synthesizing stage spans from the
#: accumulated profile timers (matches the stage_times key set)
STAGE_ORDER = ("materialize", "pair-merge", "lookup", "finalize",
               "reduce", "output-build")


# ---------------------------------------------------------------------- #
# batched helpers
# ---------------------------------------------------------------------- #
def _expand(lo: np.ndarray, hi: np.ndarray
            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Flatten per-item [lo, hi) ranges: (item_of, elem, counts, offs).

    ``item_of`` / ``elem`` come out int32 whenever they fit -- the
    expansion dominates peak bandwidth on the hot path, and every
    downstream consumer that multiplies them into packed int64 keys
    upcasts explicitly (NumPy 2 no longer value-promotes)."""
    counts = (hi - lo).astype(np.int64)
    total = int(counts.sum())
    idt = np.int32 if total < _I32_N and len(counts) < _I32_N else np.int64
    item_of = np.repeat(np.arange(len(counts), dtype=idt), counts)
    offs = np.zeros(len(counts) + 1, dtype=np.int64)
    np.cumsum(counts, out=offs[1:])
    elem = np.repeat((lo - offs[:-1]).astype(idt), counts)
    elem += np.arange(total, dtype=idt)
    return item_of, elem, counts, offs


class _Workspace:
    """Persistent per-backend scratch: named flat buffers grown
    geometrically and reused across chunks, levels, and Einsums of a
    batch, so the widest allocations of the hot loop stop cycling
    through the allocator."""

    __slots__ = ("_bufs",)

    def __init__(self):
        self._bufs: Dict[str, np.ndarray] = {}

    def buf(self, tag: str, n: int, dtype) -> np.ndarray:
        b = self._bufs.get(tag)
        if b is None or len(b) < n or b.dtype != np.dtype(dtype):
            cap = max(n, 1024, 0 if b is None else 2 * len(b))
            b = np.empty(cap, dtype=dtype)
            self._bufs[tag] = b
        return b[:n]

    def clear(self) -> None:
        self._bufs.clear()


class _CapacityExceeded(Exception):
    """Packed int64 sort keys would overflow for this data (frontier
    size x coordinate domain beyond 2^62).  The one data-dependent
    limit of the vector path: ``execute()`` falls back to the
    interpreter, which has no such bound."""


def _pack_factors(width: int, coord_arrays, n_groups: int
                  ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Shared coordinate-key packing: per-column domain sizes over all
    ``coord_arrays`` ([n, width] each), mixed-radix factors, and the
    per-group multiplier.  Packed keys
    (group * group_mult + coord . factors) must stay below 2^62."""
    mults = np.ones(width, dtype=np.int64)
    for c in coord_arrays:
        if len(c):
            mults = np.maximum(mults, c.max(axis=0).astype(np.int64) + 1)
    factors = np.ones(width, dtype=np.int64)
    for j in range(width - 2, -1, -1):
        factors[j] = factors[j + 1] * mults[j + 1]
    group_mult = int(factors[0] * mults[0])
    if max(n_groups, 1) * max(group_mult, 1) >= (1 << 62):
        raise _CapacityExceeded("coordinate key overflow")
    return mults, factors, group_mult


def _prefix_present(present: np.ndarray, offs: np.ndarray,
                    k: np.ndarray) -> np.ndarray:
    """Per item: how many of its first ``k`` stream elements satisfy
    ``present`` (consumption happens in stream order)."""
    cp = np.zeros(len(present) + 1, dtype=np.int64)
    np.cumsum(present, out=cp[1:])
    idx = np.minimum(offs[:-1] + k, offs[1:])
    return cp[idx] - cp[offs[:-1]]


def _gather_at(arr: np.ndarray, offs: np.ndarray, k: np.ndarray,
               mask: np.ndarray) -> np.ndarray:
    """arr[offs[i] + k[i] - 1] per masked item (0 elsewhere)."""
    out = np.zeros(len(k), dtype=np.int64)
    if mask.any() and len(arr):
        idx = np.minimum(offs[:-1] + np.maximum(k, 1) - 1, len(arr) - 1)
        vals = arr[idx]
        out[mask] = vals[mask]
    return out


class _Frontier:
    """Live iteration points: per-tensor element positions, captured
    output coordinate columns, and captured index-var value columns.
    ``pos`` semantics: >= 0 element index at the tensor's current
    depth, -1 absent (union miss / failed lookup), -2 not yet
    descended (root)."""

    __slots__ = ("n", "pos", "out_cols", "var_cols")

    def __init__(self, n: int, pos: Dict[str, np.ndarray],
                 out_cols: List[np.ndarray],
                 var_cols: Dict[str, np.ndarray]):
        self.n = n
        self.pos = pos
        self.out_cols = out_cols
        self.var_cols = var_cols

    def take(self, idx: np.ndarray, extra_col: Optional[np.ndarray] = None,
             skip_pos=()) -> "_Frontier":
        """Gather rows ``idx``; tensors in ``skip_pos`` get a dropped
        (unset) position -- callers that overwrite those entries from a
        stream right after skip the wasted full-frontier gather."""
        cols = [c[idx] for c in self.out_cols]
        if extra_col is not None:
            cols.append(extra_col)
        return _Frontier(len(idx),
                         {t: p[idx] for t, p in self.pos.items()
                          if t not in skip_pos},
                         cols, {v: c[idx] for v, c in self.var_cols.items()})

    def slice(self, i0: int, i1: int) -> "_Frontier":
        return _Frontier(i1 - i0,
                         {t: p[i0:i1] for t, p in self.pos.items()},
                         [c[i0:i1] for c in self.out_cols],
                         {v: c[i0:i1] for v, c in self.var_cols.items()})

    def filter(self, keep: np.ndarray) -> "_Frontier":
        idx = np.flatnonzero(keep)
        return self.take(idx)


class _Stream:
    """Per-item sorted element stream of one co-iteration node: keys
    embed the item index (``item * item_mult + packed coord``), so all
    per-item merges collapse into single sorted-array kernel calls.
    Keys are built lazily -- a level with a single driver never packs
    them (the hot single-tensor expansion stays int32)."""

    __slots__ = ("keys", "item_of", "counts", "offs", "coord", "pos")

    def __init__(self, keys, item_of, counts, offs, coord, pos):
        self.keys = keys                     # [n] int64 sorted (or None)
        self.item_of = item_of
        self.counts = counts
        self.offs = offs
        self.coord = coord                   # [n, width] int
        self.pos = pos                       # tensor -> element index / -1

    @property
    def n(self) -> int:
        return len(self.item_of)


# ---------------------------------------------------------------------- #
# runtime co-iteration nodes: materialized stream + exact lazy-pull
# accounting.  account(y, d) receives, per frontier item, how many
# elements the parent pulled from this node (y) and whether the parent
# drained it to completion (d); it emits this node's instrumentation
# counts and propagates consumption to its children.
# ---------------------------------------------------------------------- #
class _RtDrive:
    all_present = True

    def __init__(self, node: Drive, stream: _Stream):
        self.node = node
        self.stream = stream

    def account(self, counts: Counter, rank: str, y: np.ndarray,
                d: np.ndarray) -> None:
        n = int(y.sum())
        if n:
            counts[("touch", self.node.tensor, rank, "coord", "r")] += n


class _RtPair:
    """Two-finger pairwise intersection (the interpreter's
    ``_intersect2`` generator, vectorized with its exact pull
    accounting)."""

    all_present = True

    def __init__(self, left, right, stream: _Stream,
                 sel: np.ndarray, idx_sel: np.ndarray,
                 std_adv_l: np.ndarray, std_adv_r: np.ndarray):
        self.left = left
        self.right = right
        self.stream = stream
        self.sel = sel                       # match positions in left
        self.idx_sel = idx_sel               # match positions in right
        self.std_adv_l = std_adv_l
        self.std_adv_r = std_adv_r

    def account(self, counts, rank, y, d):
        counts[("isect_match", rank)] += int(y.sum())
        st = self.stream
        part = (~d) & (y > 0)
        any_part = bool(part.any())
        for side, within_src, std_adv in (
                (self.left, self.sel, self.std_adv_l),
                (self.right, self.idx_sel, self.std_adv_r)):
            ns = side.stream.counts
            if any_part:
                # match position within the item's side stream: only
                # needed when a parent paused mid-item (nested chains)
                within = within_src - side.stream.offs[st.item_of]
                w = _gather_at(within, st.offs, y, part)
            else:
                w = 0
            steps = np.where(d, std_adv, np.where(part, w, 0))
            ys = np.where(d, np.minimum(std_adv + 1, ns),
                          np.where(part, w + 1, 0))
            ds = d & (std_adv >= ns)
            _attr_steps(side, steps, counts, rank)
            side.account(counts, rank, ys, ds)


class _RtLF:
    """Leader-follower intersection of two Drive fibers: the leader
    enumerates, the follower is probed by coordinate (its non-matching
    elements are never touched)."""

    all_present = True

    def __init__(self, left, right, stream: _Stream,
                 sel: np.ndarray, idx_sel: np.ndarray,
                 lead_is_left: np.ndarray):
        self.left = left
        self.right = right
        self.stream = stream
        self.sel = sel
        self.idx_sel = idx_sel
        self.lead_is_left = lead_is_left         # per item

    def account(self, counts, rank, y, d):
        counts[("isect_match", rank)] += int(y.sum())
        st = self.stream
        part = (~d) & (y > 0)
        n_lead = np.where(self.lead_is_left, self.left.stream.counts,
                          self.right.stream.counts)
        if part.any():
            l_within = self.sel - self.left.stream.offs[st.item_of]
            r_within = self.idx_sel - self.right.stream.offs[st.item_of]
            lead_within = np.where(self.lead_is_left[st.item_of],
                                   l_within, r_within)
            w = _gather_at(lead_within, st.offs, y, part)
        else:
            w = 0
        pulls = np.where(d, n_lead, np.where(part, w + 1, 0))
        for is_left, lead, foll in ((True, self.left, self.right),
                                    (False, self.right, self.left)):
            m = self.lead_is_left == is_left
            p = np.where(m, pulls, 0)
            n = int(p.sum())
            if n:
                counts[("isect_step", rank, lead.node.tensor)] += n
                counts[("touch", foll.node.tensor, rank, "coord", "r")] += n
            lead.account(counts, rank, p, d & m)
        # the follower's own enumeration never runs: no leaf() touches


class _RtUnion:
    all_present = False

    def __init__(self, children, stream: _Stream, members):
        self.children = children
        self.stream = stream
        self.members = members                   # per child: bool [n]

    def account(self, counts, rank, y, d):
        st = self.stream
        some = y > 0
        for child, member in zip(self.children, self.members):
            nc = child.stream.counts
            # a suspended union has re-pulled the sources of its first
            # y-1 yields only (the y-th element's pull happens after
            # resume), plus the initial pull of every member stream
            c = _prefix_present(member, st.offs, np.maximum(y - 1, 0))
            pulls = np.where(d, nc,
                             np.where(some, np.minimum(c + 1, nc), 0))
            # a union cannot pull more from a source than it yielded
            check_conservation(int(nc.sum()), int(pulls.sum()),
                               f"union:{rank}")
            dc = d | (some & (c >= nc))
            child.account(counts, rank, pulls, dc)


def _attr_steps(child, k: np.ndarray, counts: Counter, rank: str) -> None:
    """Charge one ``isect_step`` per consumed child element to every
    tensor present in that element's payload (the interpreter's
    ``_isect_count``)."""
    total = int(k.sum())
    if total == 0:
        return
    st = child.stream
    if child.all_present:
        for t in st.pos:
            counts[("isect_step", rank, t)] += total
        return
    for t, p in st.pos.items():
        n = int(_prefix_present(p >= 0, st.offs, k).sum())
        if n:
            counts[("isect_step", rank, t)] += n


class VectorBackend(ExecutorBackend):
    name = "vector"

    def __init__(self, chunk_items: int = DEFAULT_CHUNK_ITEMS,
                 kernel_backend=None, profile: bool = False, device=None):
        from repro_torch.kernels.backends import (resolve_device,
                                                  resolve_guarded_kernels)
        self.chunk_items = chunk_items
        if device is None and kernel_backend is not None:
            device = getattr(kernel_backend, "device", None)
        #: the device of the seams: 'cuda' (the default; the hand
        #: kernels) or one the caller names ('cpu': the plain versions)
        self.device = resolve_device(device)
        #: per-Einsum rerun on the interpreter oracle: on the CPU only.
        #: On the card an inadmissible plan or a kernel fault raises.
        self.fallback = self.device.type != "cuda"
        self._oracle = PythonBackend()
        #: the seam lowering: an instance, or None for the one the
        #: device selects.  Always wrapped in the guarded dispatch:
        #: every fault is recorded as a DowngradeEvent on
        #: last_downgrades.
        self.kernels = resolve_guarded_kernels(kernel_backend, self.device)
        #: 'vector' or 'fallback' for the most recent execute() call
        self.last_path: Optional[str] = None
        #: why the most recent execute() fell back (None on the fast path)
        self.last_fallback_reason: Optional[str] = None
        #: kernel-dispatch DowngradeEvents drained after the most recent
        #: execute() (guarded chain retries / downgrades / demotions)
        self.last_downgrades: List = []
        #: per-execution path of each request in the last execute_batch
        self.last_batch_paths: List[str] = []
        #: per-execution downgrade events for the last execute_batch
        self.last_batch_downgrades: List[List] = []
        #: per-execution stage_seconds for the last execute_batch
        #: (empty dicts unless profiling or tracing was active)
        self.last_batch_stage_seconds: List[Dict[str, float]] = []
        self._ws = _Workspace()
        #: when True, per-stage wall time accumulates in stage_times
        #: ('materialize' / 'pair-merge' / 'lookup' / 'finalize' /
        #: 'reduce' / 'output-build'), reset per execute()/execute_csf()
        self.profile = profile
        self.stage_times: Counter = Counter()

    # ------------------------------------------------------------------ #
    @property
    def stage_seconds(self) -> Dict[str, float]:
        """Per-stage wall seconds of the most recent execution -- the
        public accessor for the profile timers (``SimResult`` /
        ``Report`` surface the same dict as ``stage_seconds``)."""
        return {k: float(v) for k, v in self.stage_times.items()}

    @contextmanager
    def _einsum_telemetry(self, name: str):
        """``einsum:<name>`` span plus synthetic stage sub-spans
        around one execution; yields ``None`` (and does nothing) when
        no tracer is installed.

        While active it forces stage profiling on so the existing
        profile timers feed the trace, and tags the guarded kernel
        dispatch with the Einsum name so seam spans and
        ``DowngradeEvent``\\ s carry their attribution.  On exit the
        accumulated per-stage seconds become one ``stage:<stage>``
        span each, laid consecutively inside the einsum span's window
        (aggregates, not real intervals -- marked ``synthetic``) and
        added to the ``vector.stage_seconds/*`` counters.

        The Einsum tag on the kernel dispatch is set regardless of
        tracing (one attribute write): a ``DowngradeEvent`` recorded
        on an untraced run still names the Einsum it struck."""
        prev_einsum = getattr(self.kernels, "current_einsum", "")
        tag = hasattr(self.kernels, "current_einsum")
        if tag:
            self.kernels.current_einsum = name
        tr = active_tracer()
        if tr is None:
            try:
                yield None
            finally:
                if tag:
                    self.kernels.current_einsum = prev_einsum
            return
        prev_profile = self.profile
        self.profile = True
        snap = Counter(self.stage_times)
        sp = tr.span(f"einsum:{name}", cat="einsum",
                     args={"backend": self.name})
        try:
            with sp:
                yield sp
        finally:
            self.profile = prev_profile
            if tag:
                self.kernels.current_einsum = prev_einsum
            reg = _obs_metrics()
            cursor = sp._start_us
            for stage in STAGE_ORDER:
                secs = float(self.stage_times[stage]) - float(snap[stage])
                if secs <= 0.0:
                    continue
                reg.counter(f"vector.stage_seconds/{stage}").inc(secs)
                dur_us = secs * 1e6
                tr.add_span(f"stage:{stage}", "stage", cursor, dur_us,
                            {"einsum": name, "parent": f"einsum:{name}",
                             "synthetic": True})
                cursor += dur_us

    # ------------------------------------------------------------------ #
    def execute(self, plan, tensors, var_shapes, semiring=None, instr=None,
                out_initial=None, isect_strategy="two_finger",
                isect_leader=None) -> FTensor:
        instr = instr or NullInstr()
        semiring = semiring or Semiring.arithmetic()
        self.stage_times = Counter()
        with self._einsum_telemetry(plan.output) as sp:
            try:
                vp = lower(plan, var_shapes, semiring, out_initial,
                           isect_strategy, isect_leader)
                csf = {}
                for a in vp.accs:
                    v = tensors[a.tensor]
                    csf[a.tensor] = v if isinstance(v, CSF) else \
                        CSF.from_ftensor(v)
                init_csf = None
                if out_initial is not None:
                    init_csf = out_initial if isinstance(out_initial, CSF) \
                        else CSF.from_ftensor(out_initial)
                csf_out, _ = self._run(vp, plan, csf, instr,
                                       out_initial=init_csf)
                self.last_path = "vector"
                self.last_fallback_reason = None
                self.last_downgrades = self._drain_downgrades()
                if sp is not None:
                    sp.set("path", "vector")
                return csf_out.to_ftensor()
            except Exception as exc:
                if not (self.fallback and self._isolates(exc)):
                    self.last_downgrades = self._drain_downgrades()
                    raise
                # the vector pipeline is poisoned for this Einsum only
                # (inadmissible plan, exhausted kernel chain, violated
                # runtime invariant): fall back to the interpreter oracle.
                # _run emits instrumentation only on completion, so the
                # oracle's counts are the run's counts -- parity preserved.
                self.last_path = "fallback"
                self.last_fallback_reason = f"{type(exc).__name__}: {exc}" \
                    if not isinstance(exc,
                                      (_Unsupported, _CapacityExceeded)) \
                    else str(exc)
                self.last_downgrades = self._drain_downgrades()
                if sp is not None:
                    sp.set("path", "fallback")
                    sp.set("fallback", self.last_fallback_reason)
                ften = {t: (v.to_ftensor() if isinstance(v, CSF) else v)
                        for t, v in tensors.items()}
                return self._oracle.execute(
                    plan, ften, var_shapes, semiring=semiring, instr=instr,
                    out_initial=out_initial, isect_strategy=isect_strategy,
                    isect_leader=isect_leader)

    @staticmethod
    def _isolates(exc: BaseException) -> bool:
        """Faults the oracle fallback absorbs: plan inadmissibility (the
        historical pair), an exhausted kernel degradation chain, and
        strict-mode guard violations.  Anything else (a genuine bug, a
        bad input the oracle would also choke on) propagates."""
        if isinstance(exc, (_Unsupported, _CapacityExceeded)):
            return True
        from repro_torch.core.guards import GuardViolation
        from repro_torch.kernels.backends import KernelChainExhausted
        return isinstance(exc, (KernelChainExhausted, GuardViolation))

    def _drain_downgrades(self) -> List:
        pop = getattr(self.kernels, "pop_events", None)
        return pop() if pop is not None else []

    def execute_batch(self, requests) -> List[FTensor]:
        """Batched frontier execution across independent Einsums: the
        requests share this backend's resolved kernel dispatch and the
        persistent workspace, so scratch allocations amortize across
        the whole batch instead of cycling per Einsum.  Per-request
        outputs, counts, and fallback behavior are identical to the
        sequential loop (the grouping seam in ``generator.run`` only
        batches Einsums with no data dependencies between them)."""
        outs: List[FTensor] = []
        paths: List[str] = []
        reasons: List[Optional[str]] = []
        downgrades: List[List] = []
        stages: List[Dict[str, float]] = []
        for req in requests:
            try:
                outs.append(self.execute(**req))
                paths.append(self.last_path or "vector")
                reasons.append(self.last_fallback_reason)
            except Exception as exc:
                # per-Einsum isolation: a fault that escaped execute()'s
                # own fallback (or struck its oracle re-run) poisons
                # this Einsum only -- the rest of the batch proceeds on
                # the unaffected backend.  Never silent: the reason
                # lands on the batch record exactly like a planned
                # fallback, and the oracle replays instrumentation so
                # count parity holds for the isolated Einsum too.
                if not self.fallback:
                    self.last_batch_paths = paths
                    self.last_batch_fallbacks = reasons
                    self.last_batch_downgrades = downgrades
                    self.last_batch_stage_seconds = stages
                    raise
                outs.append(self._isolate_request(req, exc))
                paths.append("fallback")
                reasons.append(self.last_fallback_reason)
            downgrades.append(list(self.last_downgrades))
            # execute() resets stage_times on entry, so this snapshot
            # is this request's times alone (empty on fallback paths
            # that never reached the pipeline)
            stages.append(self.stage_seconds)
        self.last_batch_paths = paths
        self.last_batch_fallbacks = reasons
        self.last_batch_downgrades = downgrades
        self.last_batch_stage_seconds = stages
        return outs

    def _isolate_request(self, req, exc: BaseException) -> FTensor:
        """Oracle re-run of one poisoned batch request."""
        self.last_path = "fallback"
        self.last_fallback_reason = \
            f"einsum-isolated {type(exc).__name__}: {exc}"
        kw = dict(req)
        tensors = {t: (v.to_ftensor() if isinstance(v, CSF) else v)
                   for t, v in kw.pop("tensors").items()}
        plan = kw.pop("plan")
        var_shapes = kw.pop("var_shapes")
        return self._oracle.execute(plan, tensors, var_shapes, **kw)

    def execute_csf(self, plan, tensors, semiring=None, instr=None,
                    isect_strategy="two_finger",
                    var_shapes: Optional[Dict[str, int]] = None,
                    isect_leader=None) -> Tuple[CSF, Dict]:
        """Vector path only (no fallback): raw CSFs in, CSF out, never
        materializing per-element Python objects.  Runs the Section-3.2
        transform pre-pass (``vplan.prepare_csf_inputs``) so
        partitioned / flattened mappings work straight from storage
        form.  This is the large-scale entry point used by the
        throughput benchmark."""
        instr = instr or NullInstr()
        semiring = semiring or Semiring.arithmetic()
        self.stage_times = Counter()
        with self._einsum_telemetry(plan.output):
            shapes = dict(var_shapes or {})
            for c in tensors.values():
                for r, s in getattr(c, "rank_shapes", {}).items():
                    if isinstance(s, int):
                        v = r.lower()
                        shapes[v] = max(shapes.get(v, 0), s)
            vp = lower(plan, shapes, semiring, None, isect_strategy,
                       isect_leader)
            exec_csf = prepare_csf_inputs(plan, tensors)
            return self._run(vp, plan, exec_csf, instr)

    # ------------------------------------------------------------------ #
    # the vector loop nest
    # ------------------------------------------------------------------ #
    def _run(self, vp: VectorPlan, plan: EinsumPlan,
             csf: Dict[str, CSF], instr: Instrumentation,
             out_initial: Optional[CSF] = None) -> Tuple[CSF, Dict]:
        counts: Counter = Counter()
        name = vp.name
        red = vp.reduce

        # update-in-place: the existing output's leaf points seed the
        # reduction groups (they sort ahead of same-coordinate
        # contributions, so the sequential fold starts from them exactly
        # like the interpreter's lookup-then-add)
        init: Optional[Tuple[np.ndarray, np.ndarray]] = None
        if out_initial is not None and out_initial.nnz:
            ipaths = out_initial.point_matrix().astype(np.int64)
            if ipaths.shape[1] != sum(red.widths):
                raise _Unsupported(
                    "update-in-place output coordinate width mismatch")
            init = (ipaths, out_initial.values.astype(np.float64))

        frontier = _Frontier(1, {a.tensor: np.full(1, -2, dtype=np.int64)
                                 for a in vp.accs}, [], {})
        # constant-index descents that resolve before the first level
        if vp.pre_lookups:
            dead = np.zeros(frontier.n, dtype=bool)
            for lk in vp.pre_lookups:
                dead |= self._lookup(lk, csf, frontier, counts)
            if dead.any():
                frontier = frontier.filter(~dead)

        # level 0 first, then (optionally chunked) deeper levels; a
        # seeded reduction needs all contributions in one part, so
        # update-in-place disables chunking
        frontier = self._level(0, vp, csf, frontier, counts)
        chunked = (vp.levels[0].out_depth is not None
                   and frontier.n > self.chunk_items and len(vp.levels) > 1
                   and init is None)
        fuse = vp.leaf_fuse
        nz_cache: Dict = {}
        paths_parts: List[List[np.ndarray]] = []
        vals_parts: List[np.ndarray] = []
        n_levels = len(vp.levels)
        step = self.chunk_items if chunked else max(frontier.n, 1)
        for i0 in range(0, max(frontier.n, 1), step):
            part = frontier.slice(i0, min(i0 + step, frontier.n))
            inner = n_levels - 1 if fuse is not None else n_levels
            for li in range(1, inner):
                part = self._level(li, vp, csf, part, counts)
            tf = time.perf_counter() if self.profile else 0.0
            # other stage counters can also advance inside this window
            # (reduce always; a declined fuse re-enters _level, charging
            # materialize/pair-merge/lookup) -- net their deltas out so
            # the per-stage breakdown stays non-overlapping
            inner_keys = ("reduce", "materialize", "pair-merge", "lookup")
            s0 = sum(float(self.stage_times[k]) for k in inner_keys) \
                if self.profile else 0.0
            pv = None
            if fuse is not None:
                # batched innermost level: one wide expand-multiply-
                # accumulate pass over the whole chunk frontier; None
                # means the dense group domain was inadmissible here
                pv = self._finalize_fused(part, vp, csf, counts, nz_cache)
            if pv is None:
                if fuse is not None:
                    part = self._level(n_levels - 1, vp, csf, part, counts)
                pv = self._finalize(part, vp, csf, counts, init)
            if self.profile:
                s1 = sum(float(self.stage_times[k]) for k in inner_keys)
                self.stage_times["finalize"] += \
                    (time.perf_counter() - tf) - (s1 - s0)
            p, v = pv
            if len(v):
                paths_parts.append(p)
                vals_parts.append(v)

        tb = time.perf_counter() if self.profile else 0.0
        if vals_parts:
            cols = [np.concatenate([p[d] for p in paths_parts], axis=0)
                    for d in range(len(red.out_ranks))]
            vals = np.concatenate(vals_parts)
        else:
            cols = [np.zeros((0, w), dtype=np.int64) for w in red.widths]
            vals = np.zeros(0, dtype=np.float64)
        # arithmetic semirings promise finite leaf values (min-plus
        # legitimately folds infinities, so the scan gates on add)
        if vp.semiring.add_vec is np.add:
            check_finite(vals, f"vector-out:{name}")
        # every reduced group is a distinct output point, so the CSF
        # build can skip the leaf boundary scan (leaf_unique)
        out_csf = _from_sorted_points(
            name, red.out_ranks, cols, vals,
            {r: None for r in red.out_ranks}, 0, set(red.upper_ranks),
            leaf_unique=True)
        if self.profile:
            self.stage_times["output-build"] += time.perf_counter() - tb

        self._emit(instr, name, counts)
        stats = {"leaf_points": int(counts.get(("leaf",), 0)),
                 "muls": int(counts.get(("compute", "mul"), 0)),
                 "out_nnz": int(len(vals))}
        return out_csf, stats

    # ------------------------------------------------------------------ #
    # stream materialization (the kernel dispatch table lives here:
    # Drive -> segment expansion; Intersect -> the intersect_keys seam
    # (or the probe path for leader-follower); UnionK -> the
    # union_k_keys seam; Lookup -> the lookup_keys seam)
    # ------------------------------------------------------------------ #
    def _ranges(self, c: CSF, d: int, pos: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
        n = len(pos)
        if d == 0:
            n0 = len(c.coords[0])
            return (np.zeros(n, dtype=np.int64),
                    np.full(n, n0, dtype=np.int64))
        seg = c.segments[d]
        valid = pos >= 0
        # clamp also covers the all-absent / empty-tensor case, where
        # seg has a single entry and no position is valid
        safe = np.clip(pos, 0, max(len(seg) - 2, 0))
        lo = np.where(valid, seg[safe], 0)
        hi = np.where(valid, seg[np.minimum(safe + 1, len(seg) - 1)], 0)
        return lo, hi

    def _drive_raw(self, node: Drive, csf, fr, width: int):
        c = csf[node.tensor]
        lo, hi = self._ranges(c, node.depth, fr.pos[node.tensor])
        item_of, elem, cnts, offs = _expand(lo, hi)
        coord = c.coords[node.depth][elem]
        if coord.shape[1] != width:
            assert len(coord) == 0, \
                f"{node.tensor}: coordinate width {coord.shape[1]} != " \
                f"plan width {width}"
            coord = coord.reshape(0, width)
        return item_of, elem, cnts, offs, coord

    @staticmethod
    def _collect_drives(op, out: List[Drive]) -> None:
        if isinstance(op, Drive):
            out.append(op)
        else:
            for ch in getattr(op, "children", ()):
                VectorBackend._collect_drives(ch, out)

    def _materialize_level(self, lvl: LevelIR, csf, fr: _Frontier):
        """Build all Drive streams with a shared coordinate packing,
        then compose the op tree."""
        drives: List[Drive] = []
        self._collect_drives(lvl.op, drives)
        raw = {id(n): self._drive_raw(n, csf, fr, lvl.width)
               for n in drives}
        packing: List = []

        def ensure_keys(st: _Stream) -> np.ndarray:
            # lazy: only co-iterating nodes pack sort keys; a level with
            # a single driver never pays the domain scan at all
            if st.keys is None:
                if not packing:
                    packing.append(_pack_factors(
                        lvl.width, [r[4] for r in raw.values()], fr.n))
                _, factors, item_mult = packing[0]
                # item_of may be int32 (hot expansion): upcast before
                # the mult, NumPy 2 no longer value-promotes
                keys = st.item_of.astype(np.int64) * item_mult
                for j in range(st.coord.shape[1]):
                    keys = keys + st.coord[:, j].astype(np.int64) \
                        * factors[j]
                st.keys = keys
            return st.keys

        def item_mult_of() -> int:
            assert packing, "union children must have packed keys"
            return packing[0][2]

        def build(op):
            if isinstance(op, Drive):
                item_of, elem, cnts, offs, coord = raw[id(op)]
                return _RtDrive(op, _Stream(None, item_of, cnts, offs,
                                            coord, {op.tensor: elem}))
            if isinstance(op, Intersect):
                rt = build(op.children[0])
                for ch in op.children[1:]:
                    rt = self._pair(rt, build(ch), op, fr.n, ensure_keys)
                return rt
            assert isinstance(op, UnionK)
            return self._union([build(ch) for ch in op.children], fr.n,
                               item_mult_of, ensure_keys)
        return build(lvl.op)

    def _pair(self, left, right, op: Intersect, n_items: int, ensure_keys):
        kops = self.kernels
        ls, rs = left.stream, right.stream
        lkeys, rkeys = ensure_keys(ls), ensure_keys(rs)
        lf = (op.strategy == "leader_follower"
              and isinstance(left, _RtDrive) and isinstance(right, _RtDrive))
        if lf:
            if left.node.tensor == op.leader:
                lead_is_left = np.ones(n_items, dtype=bool)
            elif right.node.tensor == op.leader:
                lead_is_left = np.zeros(n_items, dtype=bool)
            else:
                # no explicit leader among the pair: lead with the
                # smaller fiber (the dynamic choice real units make)
                lead_is_left = ls.counts <= rs.counts
        tk = time.perf_counter() if self.profile else 0.0
        idx = kops.intersect_keys(lkeys, rkeys)
        if self.profile:
            self.stage_times["pair-merge"] += time.perf_counter() - tk
        hit = idx >= 0
        sel = np.flatnonzero(hit)
        item_of = ls.item_of[sel]
        cnts = np.bincount(item_of, minlength=n_items).astype(np.int64)
        offs = np.zeros(n_items + 1, dtype=np.int64)
        np.cumsum(cnts, out=offs[1:])
        pos = {t: p[sel] for t, p in ls.pos.items()}
        idx_sel = idx[sel]
        for t, p in rs.pos.items():
            pos[t] = p[idx_sel]
        st = _Stream(lkeys[sel], item_of, cnts, offs, ls.coord[sel], pos)
        if lf:
            return _RtLF(left, right, st, sel, idx_sel, lead_is_left)
        both = (ls.counts > 0) & (rs.counts > 0)
        lmax = lkeys[np.maximum(ls.offs[1:] - 1, 0)] if ls.n else \
            np.zeros(n_items, dtype=np.int64)
        rmax = rkeys[np.maximum(rs.offs[1:] - 1, 0)] if rs.n else \
            np.zeros(n_items, dtype=np.int64)
        adv_l = np.where(both, np.searchsorted(lkeys, rmax, side="right")
                         - ls.offs[:-1], 0)
        adv_r = np.where(both, np.searchsorted(rkeys, lmax, side="right")
                         - rs.offs[:-1], 0)
        return _RtPair(left, right, st, sel, idx_sel, adv_l, adv_r)

    def _union(self, children, n_items: int, item_mult_of, ensure_keys):
        kops = self.kernels
        streams = [c.stream for c in children]
        tk = time.perf_counter() if self.profile else 0.0
        u, pos_list = kops.union_k_keys([ensure_keys(s) for s in streams])
        if self.profile:
            self.stage_times["pair-merge"] += time.perf_counter() - tk
        item_of = u // max(item_mult_of(), 1)
        cnts = np.bincount(item_of, minlength=n_items).astype(np.int64)
        offs = np.zeros(n_items + 1, dtype=np.int64)
        np.cumsum(cnts, out=offs[1:])
        width = streams[0].coord.shape[1]
        coord = np.zeros((len(u), width), dtype=streams[0].coord.dtype)
        pos: Dict[str, np.ndarray] = {}
        members = []
        for s, cpos in zip(streams, pos_list):
            m = cpos >= 0
            members.append(m)
            if m.any():
                coord[m] = s.coord[cpos[m]]
            for t, p in s.pos.items():
                col = np.full(len(u), -1, dtype=np.int64)
                if m.any():
                    col[m] = p[cpos[m]]
                pos[t] = col
        st = _Stream(u, item_of, cnts, offs, coord, pos)
        return _RtUnion(children, st, members)

    # ------------------------------------------------------------------ #
    def _level(self, li: int, vp: VectorPlan, csf, fr: _Frontier,
               counts: Counter) -> _Frontier:
        tm = time.perf_counter() if self.profile else 0.0
        s0 = (float(self.stage_times["pair-merge"])
              + float(self.stage_times["lookup"])) if self.profile else 0.0
        lvl = vp.levels[li]
        rank = lvl.rank
        out_here = lvl.out_depth is not None

        if isinstance(lvl.op, DenseEnumerate):
            shape = lvl.op.shape
            n = fr.n * shape
            idt = np.int32 if n < _I32_N else np.int64
            item_of = np.repeat(np.arange(fr.n, dtype=idt), shape)
            coord = np.tile(np.arange(shape, dtype=idt), fr.n)[:, None]
            counts[("iterate", rank)] += n
            counts[("advance", rank)] += n
            nf = fr.take(item_of, coord if out_here else None)
        else:
            rt = self._materialize_level(lvl, csf, fr)
            st = rt.stream
            n = st.n
            counts[("iterate", rank)] += n
            counts[("advance", rank)] += n
            rt.account(counts, rank, st.counts.copy(),
                       np.ones(fr.n, dtype=bool))
            # matched elements descend: deepest levels touch payloads
            drives: List[Drive] = []
            self._collect_drives(lvl.op, drives)
            for node in drives:
                if node.leaf:
                    present = int((st.pos[node.tensor] >= 0).sum())
                    if present:
                        counts[("touch", node.tensor, rank,
                                "payload", "r")] += present
            coord = st.coord
            nf = fr.take(st.item_of, coord if out_here else None,
                         skip_pos=st.pos.keys())
            for t, p in st.pos.items():
                nf.pos[t] = p

        if lvl.binds:
            for v, (lv, col) in vp.capture_vars.items():
                if lv == li:
                    nf.var_cols[v] = coord[:, col].copy() if len(coord) \
                        else np.zeros(0, dtype=np.int64)

        if lvl.lookups:
            dead = np.zeros(nf.n, dtype=bool)
            for lk in lvl.lookups:
                dead |= self._lookup(lk, csf, nf, counts)
            if dead.any():
                nf = nf.filter(~dead)
        # stream conservation: a level cannot drain more frontier items
        # than its streams yielded (filters only ever shrink)
        check_conservation(n, nf.n, f"level:{vp.name}:{rank}")
        if self.profile:
            s1 = float(self.stage_times["pair-merge"]) \
                + float(self.stage_times["lookup"])
            self.stage_times["materialize"] += \
                (time.perf_counter() - tm) - (s1 - s0)
        return nf

    # ------------------------------------------------------------------ #
    def _lookup(self, lk: Lookup, csf, fr: _Frontier,
                counts: Counter) -> np.ndarray:
        """Catch-up descent of one tensor level by bound coordinate.
        Returns the per-item dead mask (essential misses)."""
        kops = self.kernels
        c = csf[lk.tensor]
        d = lk.depth
        n = fr.n
        if d == 0:
            parent = np.zeros(n, dtype=np.int64)
            pvalid = np.ones(n, dtype=bool)
        else:
            parent = fr.pos[lk.tensor]
            pvalid = parent >= 0
        level_coord = c.coords[d].astype(np.int64)
        neg: Optional[np.ndarray] = None
        if lk.index is not None:
            # affine / constant probe: const + sum(coeff * var column)
            # (im2col windowing for conv's I[b, c, p+r, q+s]).  Negative
            # coordinates are definite misses and must be masked before
            # key packing -- folded into an offset key they would alias
            # into the preceding fiber's range.
            w = 1
            pb = np.full(n, int(lk.index.const), dtype=np.int64)
            for v, cf in lk.index.terms:
                pb = pb + int(cf) * fr.var_cols[v]
            neg = pb < 0
            probe = np.where(neg, 0, pb)[:, None] if n \
                else np.zeros((0, 1), dtype=np.int64)
        else:
            w = len(lk.vars)
            probe = np.stack([fr.var_cols[v] for v in lk.vars], axis=1) \
                if n else np.zeros((0, w), dtype=np.int64)
        if level_coord.shape[1] != w:
            assert len(level_coord) == 0
            level_coord = level_coord.reshape(0, w)
        par_of = c.expand_level(d)
        # probe coordinates can exceed the stored domain: the packing
        # must cover both, or a too-large probe would alias into the
        # next parent's key range
        _, factors, seg_mult = _pack_factors(
            w, [level_coord, probe], max(int(par_of.max(initial=0)) + 1, 1))
        hay = par_of * seg_mult + level_coord @ factors
        probe_keys = np.where(pvalid, parent, 0) * seg_mult \
            + (probe @ factors)

        if lk.partition_start:
            # position by range: largest coordinate <= target within the
            # parent fiber (missing -> absent, without a coordinate read)
            ins = np.searchsorted(hay, probe_keys, side="right") - 1
            safe = np.maximum(ins, 0)
            found = pvalid & (ins >= 0)
            if len(hay):
                found &= (hay[safe] // max(seg_mult, 1)) == \
                    np.where(pvalid, parent, 0)
            else:
                found[:] = False
            pos = np.where(found, safe, -1)
            n_touch = int(found.sum())
        else:
            tk = time.perf_counter() if self.profile else 0.0
            idx = kops.lookup_keys(hay, probe_keys)
            if self.profile:
                self.stage_times["lookup"] += time.perf_counter() - tk
            pos = np.where(pvalid, idx, -1)
            if neg is not None:
                # the clamped stand-in probe may have matched; a negative
                # coordinate is always a miss (still touched: the
                # interpreter reads the coordinate before missing)
                pos = np.where(neg, -1, pos)
            found = pos >= 0
            n_touch = int(pvalid.sum())
        if n_touch:
            counts[("touch", lk.tensor, lk.rank, "coord", "r")] += n_touch
        n_hit = int(found.sum())
        if lk.leaf and n_hit:
            counts[("touch", lk.tensor, lk.rank, "payload", "r")] += n_hit
        fr.pos[lk.tensor] = pos
        if lk.essential:
            return ~found
        return np.zeros(n, dtype=bool)

    # ------------------------------------------------------------------ #
    def _finalize(self, fr: _Frontier, vp: VectorPlan, csf,
                  counts: Counter,
                  init: Optional[Tuple[np.ndarray, np.ndarray]] = None
                  ) -> Tuple[List[np.ndarray], np.ndarray]:
        """Leaf evaluation + segmented in-order reduction (Reduce),
        both parameterized by the plan's semiring; ``init`` carries the
        update-in-place output's existing (paths, values)."""
        kops = self.kernels
        name = vp.name
        red = vp.reduce
        sr = vp.semiring
        counts[("leaf",)] += fr.n
        leafvals: Dict[str, np.ndarray] = {}
        for a in vp.accs:
            t = a.tensor
            c = csf[t]
            pos = fr.pos[t]
            present = pos >= 0
            if len(c.values) and c.values.dtype == np.float64 \
                    and present.all():
                # intersection-driven leaves: every point present, one
                # straight gather instead of zeros + masked scatter
                v = c.values[pos]
            else:
                v = np.zeros(fr.n, dtype=np.float64)
                if len(c.values):
                    v[present] = c.values[pos[present]]
            leafvals[t] = v

        def ev(e) -> np.ndarray:
            if isinstance(e, TensorAccess):
                return leafvals[e.tensor]
            if isinstance(e, Take):
                vals = [ev(a) for a in e.args]
                mask = np.ones(fr.n, dtype=bool)
                for v in vals:
                    mask &= v != 0
                return np.where(mask, vals[e.which], 0.0)
            assert isinstance(e, BinOp)
            lv, rv = ev(e.lhs), ev(e.rhs)
            if e.op == "*":
                # annihilator (empty payload) short-circuits without a
                # counted op, exactly like the interpreter's _eval
                mask = (lv != 0) & (rv != 0)
                counts[("compute", "mul")] += int(np.count_nonzero(mask))
                if sr.mul_vec is np.multiply:
                    # float product is exactly 0 whenever an operand is
                    # (up to sign, and the nz filter drops -0.0 too)
                    return lv * rv
                return np.where(mask, sr.mul_vec(lv, rv), 0.0)
            if e.op == "+":
                both = (lv != 0) & (rv != 0)
                counts[("compute", "add")] += int(both.sum())
                return np.where(lv == 0, rv,
                                np.where(rv == 0, lv, sr.add_vec(lv, rv)))
            counts[("compute", "add")] += lv.size
            return sr.sub_vec(lv, rv)

        vals = ev(vp.expr)
        # output coordinates as flat width-1 columns in exec-rank
        # order: the fused sort key is built straight from them, so the
        # full [n, ncol] path matrix is never materialized and only the
        # group-head rows are gathered after the sort -- on a 10k x 10k
        # SpMSpM chunk that drops three full-width matrix copies from
        # the hot loop
        flat: List[np.ndarray] = []
        lvl_cols = iter(fr.out_cols)
        for src, wdt in zip(red.sources, red.widths):
            if src[0] == "level":
                c = next(lvl_cols)
                flat.extend(c[:, j] for j in range(c.shape[1]))
            else:
                # native dtype (often int32 from CSF coords) flows
                # through to the output build's fast path
                flat.extend(np.asarray(fr.var_cols[v]) for v in src[1])
        widths = red.widths
        nzmask = vals != 0
        if nzmask.all():
            cols = list(flat)
        else:
            nz = np.flatnonzero(nzmask)
            vals = vals[nz]
            cols = [c[nz] for c in flat]

        # prepend the update-in-place seed points: placed first, the
        # stable sort keeps each seed at its group's head, so the
        # in-order fold starts from the existing value
        n_init = 0
        if init is not None:
            ipaths, ivals = init
            n_init = len(ivals)
            cols = [np.concatenate([ipaths[:, j], c])
                    for j, c in enumerate(cols)]
            vals = np.concatenate([ivals, vals])

        def assemble(rows: List[np.ndarray]) -> List[np.ndarray]:
            n_rows = len(rows[0]) if rows else 0
            out, j = [], 0
            for w in widths:
                if w == 1:               # reshape view, no copy
                    out.append(rows[j].reshape(-1, 1))
                elif w:
                    out.append(np.stack(rows[j:j + w], axis=1))
                else:
                    out.append(np.zeros((n_rows, 0), dtype=np.int64))
                j += w
            return out

        if len(vals) == 0:
            return [np.zeros((0, w), dtype=np.int64) for w in widths], vals
        # one fused-key stable sort beats a column-wise lexsort; fall
        # back to lexsort when the packed coordinate domain overflows
        mults = [int(c.max()) + 1 for c in cols]
        total_mult = 1.0
        for m in mults:
            total_mult *= m
        boundary = np.ones(len(vals), dtype=bool)
        if total_mult < float(1 << 62):
            # int32 keys when the packed domain fits: numpy's stable
            # argsort is measurably faster and every key gather moves
            # half the bytes
            kdt = np.int32 if total_mult < float(1 << 31) else np.int64
            key = np.zeros(len(vals), dtype=kdt)
            for c, m in zip(cols, mults):
                key *= m
                key += c
            order = np.argsort(key, kind="stable")
            key = key[order]
            if len(vals) > 1:
                boundary[1:] = key[1:] != key[:-1]
        else:
            order = np.lexsort(tuple(cols[::-1]))
            if len(vals) > 1:
                boundary[1:] = False
                for c in cols:
                    cs = c[order]
                    boundary[1:] |= cs[1:] != cs[:-1]
        vals = vals[order]
        starts = np.flatnonzero(boundary)
        gids = np.cumsum(boundary, dtype=np.int64)
        np.subtract(gids, 1, out=gids)
        # accumulate strictly in iteration order (matches the
        # interpreter's sequential semiring.add, bit for bit; arith
        # rides one bincount pass, min-plus ufunc.reduceat, see
        # kernels.backends.TorchKernels.segmented_reduce)
        tr = time.perf_counter() if self.profile else 0.0
        sums = kops.segmented_reduce(vals, starts, sr, group_ids=gids)
        if self.profile:
            self.stage_times["reduce"] += time.perf_counter() - tr
        head = order[starts]             # pre-sort row of each group head
        out_rank = red.out_ranks[-1]
        # accounting: the first contribution of a group inserts (w);
        # every later one reads the accumulator, adds, and writes back.
        # A group headed by an update-in-place seed point already has an
        # accumulator, so all its contributions read+add+write; a group
        # holding only its seed costs nothing (untouched existing value).
        n_contrib = len(vals) - n_init
        n_plain = int((head >= n_init).sum()) if n_init else len(starts)
        counts[("touch", name, out_rank, "payload", "w")] += n_contrib
        counts[("touch", name, out_rank, "payload", "r")] += \
            n_contrib - n_plain
        counts[("compute", "add")] += n_contrib - n_plain
        return assemble([c[head] for c in cols]), sums

    # ------------------------------------------------------------------ #
    def _finalize_fused(self, fr: _Frontier, vp: VectorPlan, csf,
                        counts: Counter, cache: Dict
                        ) -> Optional[Tuple[List[np.ndarray], np.ndarray]]:
        """Batched innermost level: expand every frontier item's leaf
        fiber of the driven factor, multiply by the co-factor's leaf
        value, and reduce into a dense per-group accumulator in one
        ``bincount`` pass -- replacing stream build + sort + segmented
        fold for the dominant two-factor contraction shape
        (``vplan.LeafFuse``).  Bit-exact with the generic path: groups
        come out in the same lexicographic order, and the weighted
        bincount accumulates contributions in input order, which is
        exactly the order the stable sort presents them to the
        sequential fold.  Returns None when the dense group domain is
        inadmissible here (caller runs the generic innermost level)."""
        red = vp.reduce
        fz = vp.leaf_fuse
        last = len(vp.levels) - 1
        rank = vp.levels[last].rank
        c = csf[fz.driven]
        oc = csf[fz.other]
        dd = vp.leaf_depth[fz.driven]
        if fr.n == 0:
            return ([np.zeros((0, w), dtype=np.int64) for w in red.widths],
                    np.zeros(0, dtype=np.float64))
        opos = fr.pos.get(fz.other)
        dpos = fr.pos.get(fz.driven)
        if (opos is None or (opos < 0).any()
                or (dd > 0 and (dpos is None or (dpos < 0).any()))
                or oc.values.dtype != np.float64
                or c.values.dtype != np.float64):
            return None
        lo, hi = self._ranges(c, dd, dpos if dpos is not None
                              else np.full(fr.n, -2, dtype=np.int64))
        total = int((hi - lo).sum())
        lc = c.coords[dd]
        if total == 0 or len(lc) == 0:
            return ([np.zeros((0, w), dtype=np.int64) for w in red.widths],
                    np.zeros(0, dtype=np.float64))

        # flat output columns in exec-rank order, tagged by where the
        # value lives: 'p' sorted-prefix item column, 'i' other per-item
        # column, 'e' leaf coordinate column (index into lc)
        flat: List[Tuple[str, object]] = []
        n_prefix_cols = 0
        lvl_cols = iter(fr.out_cols)
        for si, (src, wdt) in enumerate(zip(red.sources, red.widths)):
            if src[0] == "level":
                if src[1] == last:
                    flat.extend(("e", j) for j in range(wdt))
                else:
                    cc = next(lvl_cols)
                    kind = "p" if si < red.prefix_sources else "i"
                    flat.extend((kind, cc[:, j])
                                for j in range(cc.shape[1]))
                    if kind == "p":
                        n_prefix_cols += cc.shape[1]
            else:
                for v in src[1]:
                    lv, colj = vp.capture_vars[v]
                    if lv == last:
                        flat.append(("e", colj))
                    else:
                        flat.append(("i", np.asarray(fr.var_cols[v])))

        mults = []
        for kind, x in flat:
            if kind == "e":
                mults.append(int(lc[:, x].max()) + 1)
            else:
                mults.append(int(x.max()) + 1)

        # the frontier is lexicographically sorted by level coords, so
        # the leading prefix columns group with one boundary scan
        if n_prefix_cols:
            b = np.zeros(fr.n, dtype=bool)
            b[0] = True
            for _, x in flat[:n_prefix_cols]:
                b[1:] |= x[1:] != x[:-1]
            head_items = np.flatnonzero(b)
            gid = np.cumsum(b, dtype=np.int64) - 1
            n_local = len(head_items)
        else:
            head_items = np.zeros(1, dtype=np.int64)
            gid = np.zeros(fr.n, dtype=np.int64)
            n_local = 1

        rest = flat[n_prefix_cols:]
        rest_factors = [0] * len(rest)
        rm = 1
        for j in range(len(rest) - 1, -1, -1):
            rest_factors[j] = rm
            rm *= mults[n_prefix_cols + j]
        size = n_local * rm
        # three admissibility gates: bounded footprint, bounded
        # oversubscription (slots vs contributions), and a cache-sized
        # per-prefix-group span -- the scatter sweeps forward through
        # prefix groups, so rm bounds its working set; without the
        # bound (e.g. the flattened mapping, whose frontier is ordered
        # by position, not output coordinate) the dense accumulate
        # loses to the generic sort
        if size > DENSE_GROUP_CAP or size > max(8 * total, 1 << 16) \
                or rm > (1 << 20):
            return None

        # ---- commit point: counts may be mutated from here on ----
        counts[("iterate", rank)] += total
        counts[("advance", rank)] += total
        counts[("touch", fz.driven, rank, "coord", "r")] += total
        counts[("touch", fz.driven, rank, "payload", "r")] += total
        counts[("leaf",)] += total

        # per-item slot base and per-leaf-element slot offset (both fit
        # int32: size <= DENSE_GROUP_CAP)
        ik = gid * rm
        for (kind, x), f in zip(rest, rest_factors):
            if kind != "e":
                ik = ik + x.astype(np.int64) * f
        item_key = ik.astype(np.int32)
        ecols = [(x, f) for (kind, x), f in zip(rest, rest_factors)
                 if kind == "e"]
        ekey = ("ep", id(c)) + tuple(ecols)
        epart = cache.get(ekey)
        if epart is None and ecols:
            ep = np.zeros(len(lc), dtype=np.int64)
            for x, f in ecols:
                ep += lc[:, x].astype(np.int64) * f
            epart = ep.astype(np.int32)
            cache[ekey] = epart

        ws = self._ws
        item_of, elem, _, _ = _expand(lo, hi)
        key = ws.buf("fk1", total, np.int32)
        np.take(item_key, item_of, out=key)
        if epart is not None:
            ek = ws.buf("fk2", total, np.int32)
            np.take(epart, elem, out=ek)
            key += ek
        v_o = oc.values[opos]
        vals = ws.buf("fv1", total, np.float64)
        np.take(v_o, item_of, out=vals)
        v2 = ws.buf("fv2", total, np.float64)
        np.take(c.values, elem, out=v2)
        np.multiply(vals, v2, out=vals)

        # multiplies counted on operand nonzeros (the annihilator
        # short-circuit), exactly like the generic leaf eval
        nzd = cache.get(("nz", id(c)))
        if nzd is None:
            nzd = c.values != 0
            cache[("nz", id(c))] = nzd
        m1 = ws.buf("fm1", total, np.bool_)
        np.take(v_o != 0, item_of, out=m1)
        m2 = ws.buf("fm2", total, np.bool_)
        np.take(nzd, elem, out=m2)
        m1 &= m2
        counts[("compute", "mul")] += int(np.count_nonzero(m1))

        # dense accumulate: weighted bincount == sequential in-order
        # fold, bit for bit (stable sort preserves input order within a
        # group, and a 0.0-seeded sum of its nonzero contributions
        # reproduces the fold exactly); group existence comes from the
        # nonzero-contribution count, matching the generic nz filter
        nzv = ws.buf("fm3", total, np.bool_)
        np.not_equal(vals, 0.0, out=nzv)
        all_nz = bool(nzv.all())
        tr = time.perf_counter() if self.profile else 0.0
        sums = np.bincount(key, weights=vals, minlength=size)
        exists = np.zeros(size, dtype=bool)
        exists[key if all_nz else key[nzv]] = True
        if self.profile:
            self.stage_times["reduce"] += time.perf_counter() - tr
        idx = np.flatnonzero(exists)
        n_groups = len(idx)
        n_contrib = total if all_nz else int(np.count_nonzero(nzv))
        out_rank = red.out_ranks[-1]
        counts[("touch", vp.name, out_rank, "payload", "w")] += n_contrib
        counts[("touch", vp.name, out_rank, "payload", "r")] += \
            n_contrib - n_groups
        counts[("compute", "add")] += n_contrib - n_groups
        if n_groups == 0:
            return ([np.zeros((0, w), dtype=np.int64) for w in red.widths],
                    np.zeros(0, dtype=np.float64))
        gvals = sums[idx]

        # decode slot -> output columns (ascending slot order is the
        # generic path's lexicographic group order)
        g_head = idx // rm
        rem = idx - g_head * rm
        out_flat: List[np.ndarray] = []
        ri = 0
        for j, (kind, x) in enumerate(flat):
            if j < n_prefix_cols:
                heads = np.asarray(x)[head_items]
                out_flat.append(heads[g_head])
            else:
                f = rest_factors[ri]
                ri += 1
                q = rem // f
                rem = rem - q * f
                out_flat.append(q.astype(np.int32))

        out, j = [], 0
        for w in red.widths:
            if w == 1:
                out.append(out_flat[j].reshape(-1, 1))
            elif w:
                out.append(np.stack(out_flat[j:j + w], axis=1))
            else:
                out.append(np.zeros((n_groups, 0), dtype=np.int64))
            j += w
        return out, gvals

    # ------------------------------------------------------------------ #
    def _emit(self, instr: Instrumentation, name: str,
              counts: Counter) -> None:
        instr.begin_einsum(name)
        for key in sorted(counts, key=repr):
            n = int(counts[key])
            if n <= 0 or key == ("leaf",):
                continue
            tag = key[0]
            if tag == "touch":
                _, tensor, rank, kindk, rw = key
                instr.touch(name, tensor, rank, (), kindk, rw, n=n)
            elif tag == "iterate":
                instr.iterate(name, key[1], n=n)
            elif tag == "advance":
                instr.advance(name, key[1], n=n)
            elif tag == "compute":
                instr.compute(name, key[1], n=n)
            elif tag == "isect_step":
                instr.isect_step(name, key[1], key[2], n=n)
            elif tag == "isect_match":
                instr.isect_match(name, key[1], n=n)
        instr.end_einsum(name)
