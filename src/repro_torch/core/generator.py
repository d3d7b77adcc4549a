"""The TeAAL simulator generator (Sec. 4.3, Fig. 6).

Combines the einsum + mapping specs into executable mapped loop nests
(``EinsumExecutor``), runs them on real tensors represented as
fibertrees, streams the resulting access/compute traces into the
``PerformanceModel`` (format/architecture/binding-aware component
models), and finally produces summary statistics (execution time,
memory traffic, energy) via ``metrics.evaluate``.

Online rank swizzles of intermediate tensors (OuterSPACE's sort,
Gamma's hardware merge) are detected automatically by comparing each
intermediate input tensor's stored rank order to the consuming Einsum's
concordant execution order; the required merge work (elements, sorted
runs) is emitted to the bound Merger component.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .cascade import CascadeDAG
from .components import PerformanceModel
from .einsum import Semiring
from .fibertree import Fiber, FTensor
from .iteration import EinsumExecutor, ExecutorBackend, get_backend
from .mapping import EinsumPlan, MappingResolver
from .metrics import Report, evaluate
from .spec import AcceleratorSpec
from .trace import Instrumentation, NullInstr, TeeInstr


# ---------------------------------------------------------------------- #
# declared-form reconstruction
# ---------------------------------------------------------------------- #
def restore_declared(out_exec: FTensor, plan: EinsumPlan,
                     declared_order: Sequence[str],
                     rank_shapes: Optional[Dict[str, int]] = None) -> FTensor:
    """Rebuild the executor's exec-form output (possibly partitioned /
    flattened / loop-ordered) into its declared storage form with
    original coordinates."""
    var_of_rank: Dict[str, Tuple[str, ...]] = {}
    for r in out_exec.ranks:
        var_of_rank[r] = plan.var_map.get(r, (r.lower(),))

    declared = list(declared_order)
    decl_vars = [plan.var_map.get(r, (r.lower(),))[0] for r in declared]

    out = FTensor(out_exec.name, declared,
                  rank_shapes={r: (rank_shapes or {}).get(r)
                               for r in declared},
                  default=out_exec.default)
    uppers = out_exec.upper_ranks
    for path, val in out_exec.iter_leaves():
        bind: Dict[str, Any] = {}
        for rank, c in zip(out_exec.ranks, path):
            if rank in uppers:
                continue
            vs = var_of_rank[rank]
            if isinstance(c, tuple):
                for v, cv in zip(vs, c):
                    bind[v] = cv
            else:
                bind[vs[0]] = c
        coords = [bind[v] for v in decl_vars]
        node = out.root
        for c in coords[:-1]:
            node = node.get_or_create(c, Fiber)
        node.insert(coords[-1], val)
    return out


# ---------------------------------------------------------------------- #
# online-swizzle (merge) detection
# ---------------------------------------------------------------------- #
def _innermost_var_order(plan: EinsumPlan, tensor: str) -> List[str]:
    """Per-var traversal order of a tensor in execution form: the order
    in which each var's *binding* level appears."""
    tp = plan.tensors[tensor]
    seen: List[str] = []
    for r in reversed(tp.exec_order):
        for v in reversed(plan.var_map.get(r, (r.lower(),))):
            if v not in seen:
                seen.append(v)
    seen.reverse()
    return seen


def merge_prefix(stored_vars: Sequence[str],
                 exec_var_order: Sequence[str]) -> Optional[int]:
    """First discordant level between a stored rank order and the
    consuming Einsum's execution var order, or None when concordant
    (no online swizzle / merger work needed)."""
    p = 0
    while (p < len(stored_vars) and p < len(exec_var_order)
           and stored_vars[p] == exec_var_order[p]):
        p += 1
    if p >= len(stored_vars) - 1:
        return None
    return p


def merge_events(stored: FTensor, exec_var_order: Sequence[str]
                 ) -> List[Tuple[int, int]]:
    """(elements, lists) merge work needed to swizzle ``stored`` (in its
    declared form) into an order consistent with ``exec_var_order``."""
    stored_vars = [r.lower() for r in stored.ranks]
    p = merge_prefix(stored_vars, exec_var_order)
    if p is None:
        return []                             # concordant (or trivial)

    events: List[Tuple[int, int]] = []

    def n_leaves(node: Any) -> int:
        if not isinstance(node, Fiber):
            return 1
        return sum(n_leaves(c) for _, c in node)

    def walk(fiber: Fiber, depth: int) -> None:
        if depth == p:
            elements = n_leaves(fiber)
            lists = len(fiber)
            if elements and lists:
                events.append((elements, lists))
            return
        for _, child in fiber:
            walk(child, depth + 1)

    walk(stored.root, 0)
    return events


def isect_configs(spec: AcceleratorSpec) -> Tuple[Tuple[str, str, Any], ...]:
    """Per-einsum intersection config (strategy, leader) read from each
    Einsum's bound topology.  These arch attributes shape the *event
    stream itself* (unlike capacities/bandwidths, which only shape its
    consumption), so the DSE engine folds them into its batched-replay
    group key alongside ``mapping_signature`` -- two points may only
    share a recorded stream when both agree."""
    out = []
    for e in spec.einsum.expressions:
        name = e.output.tensor
        topo_name = spec.binding.get(name).topology
        topo = spec.arch.topologies.get(topo_name)
        if topo is None and spec.arch.topologies:
            topo = next(iter(spec.arch.topologies.values()))
        strategy, leader = "two_finger", None
        if topo is not None:
            for comp, _ in topo.all_components():
                if comp.klass == "Intersection":
                    strategy = comp.attrs.get("type", "two_finger")
                    leader = comp.attrs.get("leader")
                    break
        out.append((name, strategy, leader))
    return tuple(out)


# ---------------------------------------------------------------------- #
# the cascade simulator
# ---------------------------------------------------------------------- #
@dataclass
class SimResult:
    tensors: Dict[str, FTensor]              # all tensors, declared form
    report: Optional[Report]                 # None when model disabled
    #: einsum -> reason, for Einsums the selected backend executed
    #: through the Python oracle instead of its fast path (empty when
    #: every Einsum ran native)
    fallback_reasons: Dict[str, str] = field(default_factory=dict)
    #: einsum -> kernel-dispatch DowngradeEvents recorded while that
    #: Einsum executed (guarded-chain retries / downgrades / demotions;
    #: empty when every seam call succeeded on its primary backend)
    downgrade_events: Dict[str, list] = field(default_factory=dict)
    #: einsum -> {stage: wall seconds} from a profiling backend
    #: (VectorBackend pipeline stages; empty unless the backend
    #: profiled -- `profile=True` or an active tracer)
    stage_seconds: Dict[str, Dict[str, float]] = field(default_factory=dict)

    def __getitem__(self, name: str) -> FTensor:
        return self.tensors[name]


class CascadeSimulator:
    """spec + real input tensors -> outputs + performance report.

    ``backend`` selects the execution engine per Einsum: 'python' (the
    object-interpreter oracle), 'vector' (columnar CSF co-iteration,
    with transparent per-Einsum fallback to the oracle for unsupported
    plans), or any ExecutorBackend instance."""

    def __init__(self, spec: AcceleratorSpec,
                 params: Optional[Dict[str, int]] = None,
                 semiring: Optional[Semiring] = None,
                 extra_instr: Optional[Instrumentation] = None,
                 model: bool = True,
                 backend: "str | ExecutorBackend | None" = None,
                 plans: Optional[Dict[str, EinsumPlan]] = None):
        self.spec = spec
        self.backend: ExecutorBackend = get_backend(backend)
        self.resolver = MappingResolver(spec, params)
        self.semiring = semiring or spec.einsum.semiring
        self.dag = CascadeDAG.from_spec(spec)
        # `plans` lets a sweep engine reuse memoized lowering across
        # points whose mapping signature is identical (cascade.py)
        self.plans: Dict[str, EinsumPlan] = plans if plans is not None else {
            e.output.tensor: self.resolver.plan(e.output.tensor)
            for e in spec.einsum.expressions
        }
        self.model: Optional[PerformanceModel] = (
            PerformanceModel(spec, self.plans) if model else None)
        sinks = [s for s in (self.model, extra_instr) if s is not None]
        self.instr: Instrumentation = (
            sinks[0] if len(sinks) == 1 else
            TeeInstr(*sinks) if sinks else NullInstr())

    # ------------------------------------------------------------------ #
    def _to_ftensor(self, name: str, value: Any) -> FTensor:
        if isinstance(value, FTensor):
            return value
        ranks = (self.spec.mapping.rank_order.get(name)
                 or self.spec.einsum.declaration[name])
        arr = np.asarray(value)
        decl = self.spec.einsum.declaration[name]
        if list(ranks) != list(decl):
            # provided dense arrays follow the declaration order
            ft = FTensor.from_dense(name, decl, arr)
            return ft.swizzle(ranks)
        return FTensor.from_dense(name, ranks, arr)

    def _var_shapes(self, store: Dict[str, FTensor],
                    overrides: Optional[Dict[str, int]]) -> Dict[str, int]:
        shapes: Dict[str, int] = dict(overrides or {})
        for ft in store.values():
            for r in ft.ranks:
                s = ft.rank_shapes.get(r)
                if isinstance(s, int):
                    v = r.lower()
                    shapes[v] = max(shapes.get(v, 0), s)
        return shapes

    def _isect_config(self, out_name: str):
        """Intersection strategy for this Einsum from its bound topology's
        Intersection component (type, leader attrs)."""
        for name, strategy, leader in isect_configs(self.spec):
            if name == out_name:
                return (strategy, leader)
        return ("two_finger", None)

    # ------------------------------------------------------------------ #
    def run(self, inputs: Dict[str, Any],
            var_shapes: Optional[Dict[str, int]] = None) -> SimResult:
        from repro_torch.obs.spans import maybe_span

        with maybe_span("cascade:" + (self.spec.name or "cascade"),
                        "cascade",
                        {"backend": getattr(self.backend, "name", "?")}):
            return self._run_cascade(inputs, var_shapes)

    def _run_cascade(self, inputs: Dict[str, Any],
                     var_shapes: Optional[Dict[str, int]] = None
                     ) -> SimResult:
        from .einsum import TensorAccess as _TA

        store: Dict[str, FTensor] = {
            name: self._to_ftensor(name, v) for name, v in inputs.items()}
        shapes = self._var_shapes(store, var_shapes)
        fallbacks: Dict[str, str] = {}
        downgrades: Dict[str, list] = {}
        stage_secs: Dict[str, Dict[str, float]] = {}

        # consecutive independent Einsums (no member reads or rewrites
        # another member's output) batch into one execute_batch call;
        # outputs land in the store at flush time.  Results, counts, and
        # fallback recording are identical to the sequential loop: a
        # batched member's inputs and shapes cannot be affected by the
        # other members (shape maxima never grow from adding outputs,
        # since output rank shapes derive from the same shapes dict).
        pending: List[Dict[str, Any]] = []
        pending_out: List[str] = []

        def flush() -> None:
            nonlocal shapes
            if not pending:
                return
            outs = self.backend.execute_batch(list(pending))
            paths = getattr(self.backend, "last_batch_paths", []) or []
            reasons = getattr(self.backend, "last_batch_fallbacks", []) \
                or []
            events = getattr(self.backend, "last_batch_downgrades", []) \
                or []
            stages = getattr(self.backend, "last_batch_stage_seconds",
                             []) or []
            for i, (o_name, out_exec) in enumerate(zip(pending_out, outs)):
                if i < len(paths) and paths[i] == "fallback":
                    fallbacks[o_name] = (reasons[i]
                                         if i < len(reasons) else "") or ""
                if i < len(events) and events[i]:
                    downgrades[o_name] = list(events[i])
                if i < len(stages) and stages[i]:
                    stage_secs[o_name] = dict(stages[i])
                declared_order = (self.spec.mapping.rank_order.get(o_name)
                                  or self.spec.einsum.declaration[o_name])
                decl_shapes = {}
                for r in declared_order:
                    v = r.lower()
                    if v in shapes:
                        decl_shapes[r] = shapes[v]
                store[o_name] = restore_declared(
                    out_exec, self.plans[o_name], declared_order,
                    decl_shapes)
            pending.clear()
            pending_out.clear()
            shapes = self._var_shapes(store, var_shapes)

        for e in self.spec.einsum.expressions:
            out_name = e.output.tensor
            plan = self.plans[out_name]

            # bare whole-tensor copy (e.g. "P1 = P0"): a rename, not data
            # movement -- alias with zero hardware cost.
            if (not e.output.indices and isinstance(e.expr, _TA)
                    and not e.expr.indices):
                flush()
                store[out_name] = store[e.expr.tensor].copy(out_name)
                notify = getattr(self.backend, "notify_copy", None)
                if notify is not None:
                    notify(out_name, e.expr.tensor)
                continue

            if out_name in pending_out \
                    or any(t in pending_out for t in e.input_names):
                flush()

            missing = [t for t in e.input_names if t not in store]
            if missing:
                raise KeyError(f"einsum {out_name}: missing inputs {missing}")

            # stats-only backends (analytic) can skip the data transform
            # entirely once their calibration cache covers this Einsum
            prepare = getattr(self.backend, "prepare_inputs", None)
            need_data = True
            if prepare is not None and out_name not in store:
                need_data = prepare(plan,
                                    {t: store[t] for t in e.input_names},
                                    shapes)
            exec_forms = (self.resolver.transform_all(
                out_name, {t: store[t] for t in e.input_names})
                if need_data else {})

            # online rank swizzles of intermediates -> merger work
            estimate = getattr(self.backend, "merge_estimate", None)
            for t in e.input_names:
                if not self.dag.is_intermediate(t):
                    continue
                order = _innermost_var_order(plan, t)
                stored_ranks = list(store[t].ranks)
                p = merge_prefix([r.lower() for r in stored_ranks], order)
                if p is None:
                    continue
                events = merge_events(store[t], order)
                if not events and estimate is not None:
                    events = estimate(t, stored_ranks, p, shapes) or []
                for elements, lists in events:
                    self.instr.merge(out_name, t, elements, lists)

            out_initial = None
            if out_name in store:
                # update-in-place semantics (e.g. GraphDynS filtered write)
                out_initial = self.resolver.transform_tensor(
                    out_name, store[out_name])

            if self.model is not None and exec_forms:
                self.model.register_exec_tensors(out_name, exec_forms)

            strategy, leader = self._isect_config(out_name)
            pending.append(dict(
                plan=plan, tensors=exec_forms, var_shapes=shapes,
                semiring=self.semiring, instr=self.instr,
                out_initial=out_initial, isect_strategy=strategy,
                isect_leader=leader))
            pending_out.append(out_name)
        flush()

        report = (evaluate(self.spec, self.plans, self.model)
                  if self.model is not None else None)
        if report is not None:
            report.fallback_reasons = dict(fallbacks)
            report.downgrade_events = dict(downgrades)
            # per-Einsum stage seconds aggregate into one dict on the
            # report (the cross-cascade pipeline profile)
            agg: Dict[str, float] = {}
            for per in stage_secs.values():
                for k, v in per.items():
                    agg[k] = agg.get(k, 0.0) + float(v)
            report.stage_seconds = agg
        return SimResult(tensors=store, report=report,
                         fallback_reasons=dict(fallbacks),
                         downgrade_events=dict(downgrades),
                         stage_seconds=dict(stage_secs))

    # ------------------------------------------------------------------ #
    def run_iterative(self, inputs: Dict[str, Any],
                      carry: Dict[str, str],
                      max_iters: int = 64,
                      done_when_empty: Optional[str] = None,
                      var_shapes: Optional[Dict[str, int]] = None
                      ) -> Tuple[SimResult, int]:
        """Run the cascade repeatedly (vertex-centric iterations).

        ``carry`` maps next-iteration input names to this iteration's
        tensor names (e.g. {'A0': 'A1', 'P0': 'P1'}); iteration stops
        when tensor ``done_when_empty`` has no nonzeros or after
        ``max_iters``."""
        if not getattr(self.backend, "materializes", True):
            raise ValueError(
                f"backend {self.backend.name!r} materializes no output "
                "data: carried tensors and the done_when_empty test "
                "would read empty results -- use an execution backend "
                "('python' or 'vector') for iterative cascades")
        state = dict(inputs)
        result: Optional[SimResult] = None
        iters = 0
        for it in range(max_iters):
            result = self.run(state, var_shapes)
            iters = it + 1
            if done_when_empty is not None:
                flag = result.tensors.get(done_when_empty)
                if flag is None or flag.nnz == 0:
                    break
            for dst, src in carry.items():
                ft = result.tensors[src]
                dst_ranks = (self.spec.mapping.rank_order.get(dst)
                             or self.spec.einsum.declaration.get(dst))
                if dst_ranks and list(ft.ranks) != list(dst_ranks):
                    # positional rank rename (e.g. A1[D] -> A0[S])
                    ft = ft.rename_ranks(dict(zip(ft.ranks, dst_ranks)))
                state[dst] = ft.copy(dst)
            # non-carried inputs persist
            for name, v in inputs.items():
                if name not in carry:
                    state.setdefault(name, v)
        assert result is not None
        return result, iters


# ---------------------------------------------------------------------- #
# convenience: functional check against the dense oracle
# ---------------------------------------------------------------------- #
def check_against_dense(spec: AcceleratorSpec, inputs: Dict[str, np.ndarray],
                        var_shapes: Dict[str, int],
                        params: Optional[Dict[str, int]] = None,
                        semiring: Optional[Semiring] = None,
                        atol: float = 1e-8,
                        backend: "str | ExecutorBackend | None" = None
                        ) -> bool:
    """Run the fibertree path and the brute-force dense oracle; compare
    every cascade output."""
    from .einsum import dense_reference

    sim = CascadeSimulator(spec, params=params, semiring=semiring,
                           model=False, backend=backend)
    res = sim.run(dict(inputs), var_shapes)

    dense: Dict[str, np.ndarray] = {k: np.asarray(v)
                                    for k, v in inputs.items()}
    sr = semiring or spec.einsum.semiring
    for e in spec.einsum.expressions:
        dense[e.output.tensor] = dense_reference(e, dense, {
            k.upper(): v for k, v in var_shapes.items()}, sr)

    for e in spec.einsum.expressions:
        name = e.output.tensor
        got = res.tensors[name]
        decl = spec.einsum.declaration[name]
        stored_order = (spec.mapping.rank_order.get(name) or decl)
        ref = dense[name]
        # got is in stored order; bring ref into the same order
        perm = [decl.index(r) for r in stored_order]
        ref_swz = np.transpose(ref, perm) if ref.ndim == len(perm) else ref
        shape = [var_shapes[r.lower()] for r in stored_order]
        got_dense = np.zeros(shape)
        for path, val in got.iter_leaves():
            got_dense[tuple(path)] = val
        if not np.allclose(got_dense, ref_swz, atol=atol):
            return False
    return True
