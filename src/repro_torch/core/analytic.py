"""AnalyticBackend: closed-form evaluation of mapped loop nests.

The third execution engine (after ``PythonBackend`` and
``VectorBackend``): it never materializes output data.  Instead it
propagates per-rank occupancy expectations (``core/density.py``)
through the lowered loop nest -- the Sparseloop-style statistical
model, applied at the per-rank stream granularity the Sparse Abstract
Machine advocates -- and emits the same ``(einsum, tensor, rank,
kind)`` aggregate instrumentation keys the other backends emit, so
``metrics.evaluate``, the energy table, and ``Report`` work unchanged.

Modes (see DESIGN.md for the exactness contract):

  * ``calibrated`` (default) -- per-rank stats from a one-pass scan of
    the real exec-form tensors.  Aggregate action counts are **exact**
    on plans whose frontier covers every fiber of each tensor (dense /
    single-driver levels) and unbiased estimates under co-iteration.
  * ``hypergeometric`` / ``uniform`` -- pure statistical models from
    (shape, nnz) / (shape, density); no tensor scan at all.

Cascade intermediates are never materialized: their predicted output
stats are kept on the backend and re-projected (mean field) into the
consuming Einsum's execution order.  Semirings with vectorized forms
(arith, min-plus, or-and) and affine / constant index maps are modeled
natively: affine lookups apply the halo / boundary-occupancy hit
fraction from ``density.affine_hit_fraction``, and the output-collision
model is shared across semirings because the interpreter folds every
collision sequentially (idempotence licenses the vectorized reduceat
execution but does not change the count contract).  Plans outside the
supported class (flattened ranks, update-in-place outputs,
interpreter-only semirings, ...) fall back to ``PythonBackend`` per
Einsum, recording the reason in ``last_fallback_reason``.
"""
from __future__ import annotations

from collections import Counter
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .density import (TensorDensity, affine_hit_fraction, expected_distinct,
                      occupancy_overlap, union_size)
from .einsum import BinOp, Literal, Semiring, Take, TensorAccess
from .fibertree import FTensor
from .iteration import EinsumExecutor, ExecutorBackend, PythonBackend
from .mapping import EinsumPlan
from .trace import Instrumentation, NullInstr


class _Unsupported(Exception):
    """Plan shape the analytic path does not cover (-> fallback)."""


def _bump(uniq: Dict[Tuple, float], key: Tuple, distinct: float) -> None:
    """Accumulate the distinct-element footprint behind an aggregate
    touch key (capped against the emitted n at emit time)."""
    uniq[key] = uniq.get(key, 0.0) + max(distinct, 0.0)


# ---------------------------------------------------------------------- #
# expression analysis
# ---------------------------------------------------------------------- #
def _classify_expr(expr) -> Tuple[str, List[TensorAccess]]:
    """('product', accesses) for pure multiplicative / take chains,
    ('sum', [lhs, rhs]) for two-term additions; raises otherwise."""
    accs: List[TensorAccess] = []

    def rec(e) -> bool:
        if isinstance(e, TensorAccess):
            accs.append(e)
            return True
        if isinstance(e, Literal):
            return True
        if isinstance(e, Take):
            return all(rec(a) for a in e.args)
        if isinstance(e, BinOp) and e.op == "*":
            return rec(e.lhs) and rec(e.rhs)
        return False

    if rec(expr) and accs:
        return "product", accs
    if (isinstance(expr, BinOp) and expr.op in "+-"
            and isinstance(expr.lhs, TensorAccess)
            and isinstance(expr.rhs, TensorAccess)):
        return "sum", [expr.lhs, expr.rhs]
    raise _Unsupported(f"expression shape {expr}")


def _index_kind(idx) -> str:
    """'bare' | 'const' | 'affine' for one access index."""
    if idx is None or idx.is_bare:
        return "bare"
    if not idx.terms:
        return "const"
    return "affine"


# ---------------------------------------------------------------------- #
# the backend
# ---------------------------------------------------------------------- #
class AnalyticBackend(ExecutorBackend):
    """Statistical / calibrated analytic execution engine."""

    name = "analytic"
    materializes = False

    def __init__(self, mode: str = "calibrated",
                 densities: Optional[Dict[str, float]] = None,
                 fallback: bool = True,
                 calib_cache: Optional[Dict] = None,
                 cache_token: Optional[str] = None):
        assert mode in ("calibrated", "uniform", "hypergeometric"), mode
        self.mode = mode
        self.densities = dict(densities or {})
        self.fallback = fallback
        self._oracle = PythonBackend()
        #: predicted stats of analytically-executed outputs, by name
        self._predicted: Dict[str, TensorDensity] = {}
        #: calibration cache: (token, tensor, exec_order) -> TensorDensity.
        #: Shared across backend instances by the DSE engine.
        self._calib: Dict[Tuple, TensorDensity] = (
            calib_cache if calib_cache is not None else {})
        #: set by the DSE engine to a per-(workload, mapping) token;
        #: caching is disabled when None (safe standalone default).
        self.cache_token = cache_token
        self.last_path: Optional[str] = None       # 'analytic' | 'fallback'
        self.last_fallback_reason: Optional[str] = None

    # ------------------------------------------------------------------ #
    # generator hooks
    # ------------------------------------------------------------------ #
    def prepare_inputs(self, plan: EinsumPlan,
                       tensors: Dict[str, FTensor],
                       var_shapes: Dict[str, int]) -> bool:
        """Return True when this Einsum needs exec-form tensor data
        (uncached calibration, or an unsupported plan that will fall
        back to the oracle).  False lets the generator skip
        ``transform_all`` entirely -- the memoized-calibration fast
        path the DSE engine relies on."""
        try:
            ex = self._executor(plan)
            self._analyze(ex, plan)
        except (_Unsupported, ValueError):
            # ValueError from EinsumExecutor mirrors _run_analytic's
            # conversion to a fallback: the oracle will need real data
            return True
        if self.cache_token is None:
            return True
        for t in plan.einsum.input_names:
            if t not in plan.tensors:
                return True
            ft = tensors.get(t)
            if ft is not None and ft.is_empty and t in self._predicted:
                continue                    # unmaterialized intermediate
            key = (self.cache_token, t, tuple(plan.tensors[t].exec_order))
            if key not in self._calib:
                return True
        return False

    def notify_copy(self, dst: str, src: str) -> None:
        """Follow whole-tensor aliases the generator short-circuits so
        predicted stats survive renames (e.g. 'P1 = P0')."""
        pred = self._predicted.get(src)
        if pred is not None:
            self._predicted[dst] = pred.renamed(dst, extra_source=src)

    def merge_estimate(self, tensor: str, stored_ranks: Sequence[str],
                       prefix_depth: int,
                       var_shapes: Dict[str, int]
                       ) -> Optional[List[Tuple[int, int]]]:
        """Analytic estimate of the online rank-swizzle (merger) work
        for an unmaterialized intermediate: one aggregate event with
        the total element count and the mean sorted-run count per merge
        (the fiber occupancy at the first discordant level)."""
        pred = self._predicted.get(tensor)
        if pred is None or pred.nnz <= 0:
            return None
        var_map = {r: (r.lower(),) for r in stored_ranks}
        shapes = {v: float(s) for v, s in var_shapes.items()}
        td = pred.project(list(stored_ranks), var_map, shapes)
        p = max(0, min(prefix_depth, len(td.levels) - 1))
        lists = max(1, int(round(td.levels[p].occupancy)))
        return [(int(round(td.nnz)), lists)]

    # ------------------------------------------------------------------ #
    def execute(self, plan, tensors, var_shapes, semiring=None, instr=None,
                out_initial=None, isect_strategy="two_finger",
                isect_leader=None) -> FTensor:
        instr = instr or NullInstr()
        semiring = semiring or Semiring.arithmetic()
        try:
            out = self._run_analytic(plan, tensors, var_shapes, semiring,
                                     instr, out_initial, isect_strategy,
                                     isect_leader)
            self.last_path = "analytic"
            self.last_fallback_reason = None
            return out
        except _Unsupported as exc:
            if not self.fallback:
                raise
            self.last_path = "fallback"
            self.last_fallback_reason = str(exc)
            return self._oracle.execute(
                plan, tensors, var_shapes, semiring=semiring, instr=instr,
                out_initial=out_initial, isect_strategy=isect_strategy,
                isect_leader=isect_leader)

    # ------------------------------------------------------------------ #
    # supported-plan analysis
    # ------------------------------------------------------------------ #
    @staticmethod
    def _executor(plan: EinsumPlan,
                  tensors: Optional[Dict[str, FTensor]] = None
                  ) -> EinsumExecutor:
        return EinsumExecutor(plan, tensors or {}, {}, instr=NullInstr())

    def _analyze(self, ex: EinsumExecutor, plan: EinsumPlan):
        einsum = ex.einsum
        if not einsum.output.indices and isinstance(einsum.expr,
                                                    TensorAccess):
            return "copy", [einsum.expr], []
        if any(not ix.is_bare for ix in einsum.output.indices):
            raise _Unsupported("non-bare output indices")
        if ex.unmatched_out:
            raise _Unsupported("output ranks bound at the leaf")
        if any(ri.flattened for ri in plan.loop_order):
            raise _Unsupported("flattened loop ranks")
        kind, accs = _classify_expr(einsum.expr)
        # affine / constant index maps are supported: they lower onto
        # catch-up lookups (see _lookup_schedule) with a halo-occupancy
        # hit fraction, mirroring the vector pipeline's Lookup.index
        order = [a.tensor for a in accs]
        levels: List[Tuple[str, List[Tuple[str, int]]]] = []
        for li, ri in enumerate(plan.loop_order):
            drv = [(t, ex.drive[t][li]) for t in order if li in ex.drive[t]]
            levels.append((ri.name, drv))
        if kind == "sum":
            all_levels = frozenset(range(len(plan.loop_order)))
            for t in order:
                if frozenset(ex.drive[t]) != all_levels:
                    raise _Unsupported("summands with unaligned ranks")
        return kind, accs, levels

    # ------------------------------------------------------------------ #
    # tensor stats acquisition
    # ------------------------------------------------------------------ #
    def _stats_for(self, t: str, plan: EinsumPlan,
                   tensors: Dict[str, Any],
                   var_shapes: Dict[str, int]) -> TensorDensity:
        exec_order = plan.tensors[t].exec_order
        key = ((self.cache_token, t, tuple(exec_order))
               if self.cache_token is not None else None)
        if key is not None and key in self._calib:
            return self._calib[key]
        shapes = {v: float(s) for v, s in (var_shapes or {}).items()}
        ft = tensors.get(t)
        nnz = ft.nnz if ft is not None else 0
        if ft is not None and nnz > 0:
            if self.mode == "calibrated":
                td = TensorDensity.calibrated(ft, var_map=plan.var_map,
                                              var_shapes=shapes)
            else:
                doms = [self._rank_domain(r, plan, shapes, ft)
                        for r in exec_order]
                if self.mode == "uniform":
                    total = 1.0
                    for d in doms:
                        total *= max(d, 1.0)
                    td = TensorDensity.uniform(t, exec_order, doms,
                                               nnz / max(total, 1.0),
                                               var_map=plan.var_map)
                else:
                    td = TensorDensity.hypergeometric(
                        t, exec_order, doms, nnz, var_map=plan.var_map)
            if key is not None:
                self._calib[key] = td
            return td
        pred = self._predicted.get(t)
        if pred is not None:
            return pred.project(exec_order, plan.var_map, shapes)
        dens = self.densities.get(t)
        if dens is not None:
            # declared density: pure-statistical evaluation, no data
            doms = [self._rank_domain(r, plan, shapes, ft)
                    for r in exec_order]
            return TensorDensity.uniform(t, exec_order, doms, dens,
                                         var_map=plan.var_map)
        # genuinely empty input: zero stats
        from .density import LevelStats
        lv = [LevelStats(r, 1.0 if d == 0 else 0.0, 0.0,
                         self._rank_domain(r, plan, shapes, ft))
              for d, r in enumerate(exec_order)]
        return TensorDensity(t, list(exec_order), lv, 0.0)

    @staticmethod
    def _rank_domain(rank: str, plan: EinsumPlan,
                     var_shapes: Dict[str, float],
                     ft: Optional[FTensor]) -> float:
        if ft is not None:
            s = ft.rank_shapes.get(rank)
            if isinstance(s, (int, float)) and s:
                return float(s)
        dom = 1.0
        known = False
        for v in plan.var_map.get(rank, (rank.lower(),)):
            s = var_shapes.get(v)
            if s:
                dom *= float(s)
                known = True
        return dom if known else 0.0

    # ------------------------------------------------------------------ #
    # the analytic walk
    # ------------------------------------------------------------------ #
    def _run_analytic(self, plan, tensors, var_shapes, semiring, instr,
                      out_initial, isect_strategy, isect_leader) -> FTensor:
        if out_initial is not None:
            raise _Unsupported("update-in-place output")
        if not semiring.has_vector_forms:
            raise _Unsupported(
                f"semiring {semiring.name} has no vectorized forms")
        try:
            ex = self._executor(plan, {t: v for t, v in tensors.items()
                                       if isinstance(v, FTensor)})
        except ValueError as e:
            raise _Unsupported(str(e))
        kind, accs, levels = self._analyze(ex, plan)
        name = plan.output
        shapes = {v: float(s) for v, s in (var_shapes or {}).items()}

        stats = {a.tensor: self._stats_for(a.tensor, plan, tensors,
                                           var_shapes)
                 for a in accs}
        counts: Counter = Counter()

        uniq: Dict[Tuple, float] = {}

        if kind == "copy":
            src = accs[0].tensor
            n = stats[src].nnz
            rank = plan.tensors[src].exec_order[-1] \
                if plan.tensors.get(src) else ""
            counts[("touch", src, rank, "payload", "r")] += n
            counts[("touch", name, rank, "payload", "w")] += n
            uniq[("touch", src, rank, "payload", "r")] = n
            uniq[("touch", name, rank, "payload", "w")] = n
            self._emit(instr, name, counts, uniq)
            self._predicted[name] = stats[src].renamed(name,
                                                       extra_source=src)
            return FTensor(name, list(plan.tensors[src].exec_order)
                           if plan.tensors.get(src) else [])

        leaf_depth = {t: len(plan.tensors[t].exec_order) - 1
                      for t in stats}
        lookups = self._lookup_schedule(ex, plan, accs)
        essential = ex._essential
        present: Dict[str, float] = {t: 1.0 for t in stats}
        points = 1.0
        pts_after: List[float] = []

        # depth-(-1) lookups: constant indices resolvable before the loop
        points = self._apply_lookups(lookups.get(-1, []), points, present,
                                     stats, leaf_depth, essential, counts,
                                     uniq, plan, shapes)

        for li, (rank, drv) in enumerate(levels):
            ri = plan.loop_order[li]
            dom = self._level_domain(ri, plan, shapes, drv, stats)
            if kind == "sum":
                points = self._union_level(rank, drv, dom, points, present,
                                           stats, leaf_depth, counts, uniq)
            elif not drv:
                # driverless: dense range over the rank's var
                if ri.flattened:
                    raise _Unsupported(f"driverless flattened rank {rank}")
                shape = shapes.get(ri.vars[0])
                if not shape:
                    raise _Unsupported(f"unknown shape for var "
                                       f"{ri.vars[0]!r}")
                counts[("iterate", rank)] += points * shape
                counts[("advance", rank)] += points * shape
                points *= shape
            elif len(drv) == 1:
                t, d = drv[0]
                occ = stats[t].occ(d)
                enum = points * occ
                counts[("touch", t, rank, "coord", "r")] += enum
                _bump(uniq, ("touch", t, rank, "coord", "r"),
                      stats[t].levels[d].elems)
                counts[("iterate", rank)] += enum
                counts[("advance", rank)] += enum
                if d == leaf_depth[t]:
                    counts[("touch", t, rank, "payload", "r")] += enum
                    _bump(uniq, ("touch", t, rank, "payload", "r"),
                          stats[t].nnz)
                points = enum
            else:
                aligned = plan.created_ranks.get(rank) == "upper"
                points = self._isect_level(rank, drv, dom, points, stats,
                                           leaf_depth, counts, uniq,
                                           isect_strategy, isect_leader,
                                           aligned=aligned)
            if ri.binds:
                points = self._apply_lookups(
                    lookups.get(li, []), points, present, stats,
                    leaf_depth, essential, counts, uniq, plan, shapes)
            pts_after.append(points)

        # ---- leaf evaluation + output accumulation
        p_nz, muls, adds_expr = self._eval_model(ex.einsum.expr, present)
        counts[("compute", "mul")] += points * muls
        counts[("compute", "add")] += points * adds_expr
        C = points * p_nz
        D = self._distinct_outputs(ex, plan, shapes, pts_after, C)
        out_rank = plan.tensors[name].exec_order[-1]
        counts[("touch", name, out_rank, "payload", "w")] += C
        counts[("touch", name, out_rank, "payload", "r")] += max(C - D, 0.0)
        counts[("compute", "add")] += max(C - D, 0.0)
        _bump(uniq, ("touch", name, out_rank, "payload", "w"), D)
        # accumulation reads hit data produced on chip: no cold fills
        uniq[("touch", name, out_rank, "payload", "r")] = 0.0

        self._emit(instr, name, counts, uniq)
        self._predicted[name] = self._predict_output(
            ex, plan, shapes, pts_after, D,
            sources=[a.tensor for a in accs], stats=stats)
        out_ranks = plan.tensors[name].exec_order
        return FTensor(name, list(out_ranks),
                       rank_shapes={r: None for r in out_ranks},
                       upper_ranks={r for r in out_ranks
                                    if plan.created_ranks.get(r) == "upper"})

    # ------------------------------------------------------------------ #
    def _level_domain(self, ri, plan, shapes, drv, stats) -> float:
        dom = 1.0
        known = False
        for v in ri.vars:
            s = shapes.get(v)
            if s:
                dom *= s
                known = True
        if known:
            return dom
        for t, d in drv:
            got = stats[t].domain(d)
            if got:
                return got
        return 0.0

    def _lookup_schedule(self, ex: EinsumExecutor, plan: EinsumPlan,
                         accs) -> Dict[int, List[Tuple[str, int, str, Any]]]:
        """loop level -> [(tensor, depth, rank, affine_index)] catch-up
        descents, mirroring ``EinsumExecutor._catch_up`` timing: a
        non-driving level descends at the first binding loop level where
        its index vars are all bound (level -1 for constant indices).
        ``affine_index`` is the declared non-bare ``AffineIndex`` at
        that level, or None for bare variable lookups."""
        var_bound_at: Dict[str, int] = {}
        for lj, rj in enumerate(plan.loop_order):
            if rj.binds:
                for v in rj.vars:
                    var_bound_at[v] = lj
        out: Dict[int, List[Tuple[str, int, str, Any]]] = {}
        for acc in accs:
            t = acc.tensor
            tp = plan.tensors[t]
            drive = ex.drive[t]
            inv = {d: l for l, d in drive.items()}
            prev = -1
            for d, rank in enumerate(tp.exec_order):
                if d in inv:
                    prev = max(prev, inv[d])
                    continue
                idx = ex._level_index(acc, tp, d)
                if idx is not None and idx.is_bare:
                    idx = None
                vars_ = (idx.vars if idx is not None
                         else ex._level_vars(acc, tp, d, rank))
                lv = max((var_bound_at.get(v, len(plan.loop_order))
                          for v in vars_), default=-1)
                if lv >= len(plan.loop_order):
                    raise _Unsupported(f"{t}: unbound lookup level {rank}")
                lv = max(lv, prev)
                out.setdefault(lv, []).append((t, d, rank, idx))
                prev = lv
        return out

    def _apply_lookups(self, items, points, present, stats, leaf_depth,
                       essential, counts, uniq, plan, shapes) -> float:
        for t, d, rank, idx in items:
            td = stats[t]
            counts[("touch", t, rank, "coord", "r")] += points * present[t]
            _bump(uniq, ("touch", t, rank, "coord", "r"),
                  td.levels[d].elems)
            if plan.created_ranks.get(rank) == "upper":
                p_hit = 1.0          # range positioning (bisect) hits
            else:
                dom = td.domain(d)
                p_hit = min(td.occ(d) / dom, 1.0) if dom > 0 else 1.0
                if idx is not None:
                    # affine / constant probe: only the in-range part of
                    # the probe span can hit (conv halo / boundary crop)
                    p_hit *= affine_hit_fraction(idx.terms, idx.const,
                                                 shapes, dom)
            if t in essential:
                points *= p_hit
            else:
                present[t] *= p_hit
            if d == leaf_depth[t]:
                counts[("touch", t, rank, "payload", "r")] += \
                    points * present[t]
                _bump(uniq, ("touch", t, rank, "payload", "r"), td.nnz)
        return points

    def _isect_level(self, rank, drv, dom, points, stats, leaf_depth,
                     counts, uniq, strategy, leader,
                     aligned: bool = False) -> float:
        """Fold >= 2 drivers at one loop rank through pairwise
        intersection, emitting the two-finger / leader-follower count
        model (see DESIGN.md for the formulas).  ``aligned`` marks
        partition-created upper ranks: both tensors tile the same
        coordinate grid, so their tile fibers intersect (nearly)
        completely rather than hypergeometrically."""
        (ta, da) = drv[0]
        occ_a = stats[ta].occ(da)
        merged = [ta]
        first = True
        for (tb, db) in [x for x in drv[1:]]:
            occ_b = stats[tb].occ(db)
            # correlated pair: an intermediate intersecting a tensor its
            # own structure was computed from (Gamma's T against A) --
            # the independence model would miss nearly every match
            corr = (tb in stats[ta].derived_from
                    or ta in stats[tb].derived_from)
            if aligned or corr:
                m_per = min(occ_a, occ_b)
            else:
                m_per = occupancy_overlap(occ_a, occ_b, dom or
                                          max(occ_a, occ_b, 1.0))
            if strategy == "leader_follower" and first:
                if ta == leader:
                    lead, lo, foll, fo = ta, occ_a, tb, occ_b
                elif tb == leader:
                    lead, lo, foll, fo = tb, occ_b, ta, occ_a
                elif occ_a <= occ_b:
                    lead, lo, foll, fo = ta, occ_a, tb, occ_b
                else:
                    lead, lo, foll, fo = tb, occ_b, ta, occ_a
                counts[("touch", lead, rank, "coord", "r")] += points * lo
                counts[("touch", foll, rank, "coord", "r")] += points * lo
                ld = dict(drv)
                _bump(uniq, ("touch", lead, rank, "coord", "r"),
                      stats[lead].levels[ld[lead]].elems)
                _bump(uniq, ("touch", foll, rank, "coord", "r"),
                      stats[foll].levels[ld[foll]].elems)
                counts[("isect_step", rank, lead)] += points * lo
            else:
                fa = occ_b / (occ_b + 1.0) if occ_b > 0 else 0.0
                fb = occ_a / (occ_a + 1.0) if occ_a > 0 else 0.0
                adv_a, adv_b = occ_a * fa, occ_b * fb
                if occ_a > 0 and occ_b > 0:
                    touched_a = min(adv_a + 1.0, occ_a)
                    touched_b = min(adv_b + 1.0, occ_b)
                else:
                    touched_a = touched_b = 0.0
                if first:
                    counts[("touch", ta, rank, "coord", "r")] += \
                        points * touched_a
                    _bump(uniq, ("touch", ta, rank, "coord", "r"),
                          stats[ta].levels[da].elems)
                counts[("touch", tb, rank, "coord", "r")] += \
                    points * touched_b
                _bump(uniq, ("touch", tb, rank, "coord", "r"),
                      stats[tb].levels[db].elems)
                for t in merged:
                    counts[("isect_step", rank, t)] += points * adv_a
                counts[("isect_step", rank, tb)] += points * adv_b
            counts[("isect_match", rank)] += points * m_per
            occ_a = m_per
            merged.append(tb)
            first = False
        matches = points * occ_a
        counts[("iterate", rank)] += matches
        counts[("advance", rank)] += matches
        for (t, d) in drv:
            if d == leaf_depth[t]:
                counts[("touch", t, rank, "payload", "r")] += matches
                _bump(uniq, ("touch", t, rank, "payload", "r"),
                      stats[t].nnz)
        return matches

    def _union_level(self, rank, drv, dom, points, present, stats,
                     leaf_depth, counts, uniq) -> float:
        if len(drv) != 2:
            raise _Unsupported(f"union with {len(drv)} drivers at {rank}")
        (ta, da), (tb, db) = drv
        occ_a, occ_b = stats[ta].occ(da), stats[tb].occ(db)
        pa, pb = present[ta], present[tb]
        u_both = union_size(occ_a, occ_b, dom or max(occ_a + occ_b, 1.0))
        # per-point union size, conditioned on which sides are present
        u = (pa * pb * u_both + pa * (1.0 - pb) * occ_a
             + (1.0 - pa) * pb * occ_b)
        counts[("touch", ta, rank, "coord", "r")] += points * pa * occ_a
        counts[("touch", tb, rank, "coord", "r")] += points * pb * occ_b
        _bump(uniq, ("touch", ta, rank, "coord", "r"),
              stats[ta].levels[da].elems)
        _bump(uniq, ("touch", tb, rank, "coord", "r"),
              stats[tb].levels[db].elems)
        counts[("iterate", rank)] += points * u
        counts[("advance", rank)] += points * u
        if da == leaf_depth[ta]:
            counts[("touch", ta, rank, "payload", "r")] += \
                points * pa * occ_a
            _bump(uniq, ("touch", ta, rank, "payload", "r"),
                  stats[ta].nnz)
        if db == leaf_depth[tb]:
            counts[("touch", tb, rank, "payload", "r")] += \
                points * pb * occ_b
            _bump(uniq, ("touch", tb, rank, "payload", "r"),
                  stats[tb].nnz)
        if u > 0:
            present[ta] = pa * occ_a / u
            present[tb] = pb * occ_b / u
        return points * u

    # ------------------------------------------------------------------ #
    def _eval_model(self, expr, present: Dict[str, float]
                    ) -> Tuple[float, float, float]:
        """(P(value nonzero), expected muls, expected adds) per leaf
        iteration point, mirroring ``EinsumExecutor._eval``'s
        zero-short-circuit count semantics."""
        if isinstance(expr, Literal):
            return (1.0 if expr.value else 0.0), 0.0, 0.0
        if isinstance(expr, TensorAccess):
            return present.get(expr.tensor, 1.0), 0.0, 0.0
        if isinstance(expr, Take):
            p, m, a = 1.0, 0.0, 0.0
            for arg in expr.args:
                pp, mm, aa = self._eval_model(arg, present)
                p *= pp
                m += mm
                a += aa
            return p, m, a
        if isinstance(expr, BinOp):
            pl, ml, al = self._eval_model(expr.lhs, present)
            pr, mr, ar = self._eval_model(expr.rhs, present)
            if expr.op == "*":
                return pl * pr, ml + mr + pl * pr, al + ar
            if expr.op == "+":
                return (pl + pr - pl * pr, ml + mr, al + ar + pl * pr)
            # '-': the interpreter always counts one add
            return (pl + pr - pl * pr, ml + mr, al + ar + 1.0)
        raise _Unsupported(f"bad expr {expr!r}")

    def _distinct_outputs(self, ex, plan, shapes, pts_after, C) -> float:
        out_levels = sorted(ex.out_descend)
        if not out_levels or C <= 0:
            return 0.0
        last = out_levels[-1]
        if set(out_levels) == set(range(last + 1)):
            # loop prefix descends output ranks only: every frontier
            # path at the last output level is a distinct output (exact)
            return min(pts_after[last], C)
        # reduction ranks interleave before the innermost output rank:
        # group by the clean output prefix, then a collision model over
        # the remaining output-coordinate space
        j = -1
        while j + 1 in ex.out_descend:
            j += 1
        G = pts_after[j] if j >= 0 else 1.0
        if G <= 0:
            return 0.0
        # total output-coordinate space: partitioned copies of one var
        # jointly bind it, so the product runs over distinct vars; each
        # clean-prefix group then owns a 1/G share of that space
        out_vars = set()
        for li in out_levels:
            out_vars.update(plan.loop_order[li].vars)
        total = 1.0
        for v in out_vars:
            total *= max(shapes.get(v, 1.0), 1.0)
        S = max(total / G, 1.0)
        return min(G * expected_distinct(S, C / G), C)

    def _predict_output(self, ex, plan, shapes, pts_after, D,
                        sources: Sequence[str] = (),
                        stats: Optional[Dict[str, TensorDensity]] = None
                        ) -> TensorDensity:
        """Per-level stats of the just-evaluated output, in its exec
        order: exact frontier ratios along the clean output prefix,
        then the remaining distinct coordinates distributed across the
        post-prefix output ranks in proportion to each level's frontier
        growth."""
        import math

        from .density import LevelStats

        name = plan.output
        out_ranks = plan.tensors[name].exec_order
        lv_of_depth = {d: l for l, d in ex.out_descend.items()}
        n_out = len(out_ranks)

        occs: List[Optional[float]] = []
        G = 1.0
        clean = True
        for depth in range(n_out):
            li = lv_of_depth.get(depth)
            if clean and li == depth and li < len(pts_after):
                prev = pts_after[li - 1] if li > 0 else 1.0
                occ = pts_after[li] / prev if prev > 0 else 0.0
                G *= max(occ, 0.0)
                occs.append(max(occ, 0.0))
            else:
                clean = False
                occs.append(None)
        R = D / G if G > 0 else 0.0
        open_idx = [i for i, o in enumerate(occs) if o is None]
        if open_idx:
            weights = []
            for i in open_idx:
                li = lv_of_depth[i]
                prev = pts_after[li - 1] if li > 0 else 1.0
                growth = pts_after[li] / prev if prev > 0 else 1.0
                weights.append(math.log(max(growth, 1.0 + 1e-9)))
            W = sum(weights)
            for i, w in zip(open_idx, weights):
                share = (w / W) if W > 0 else 1.0 / len(open_idx)
                occs[i] = max(R ** share, 1.0) if R >= 1.0 else \
                    max(R, 0.0) ** (1.0 / len(open_idx))

        levels: List[LevelStats] = []
        fibers = 1.0
        rank_marginals: Dict[str, float] = {}
        marginals: Dict[str, float] = {}
        domains: Dict[str, float] = {}
        for r, occ in zip(out_ranks, occs):
            dom = 1.0
            for v in plan.var_map.get(r, (r.lower(),)):
                s = shapes.get(v)
                if s:
                    dom *= s
                    domains[v] = s
                marginals[v] = min(marginals.get(v, 1.0) * max(occ, 1.0),
                                   s or float("inf")) if occ else \
                    marginals.get(v, 1.0)
            elems = fibers * (occ or 0.0)
            levels.append(LevelStats(r, fibers, elems, dom))
            rank_marginals[r] = occ or 0.0
            fibers = elems
        derived = frozenset(sources) | frozenset(
            x for s in (stats or {}).values() for x in s.derived_from)
        return TensorDensity(name, list(out_ranks), levels, D,
                             marginals=marginals, domains=domains,
                             rank_marginals=rank_marginals,
                             derived_from=derived)

    # ------------------------------------------------------------------ #
    def _emit(self, instr: Instrumentation, name: str,
              counts: Counter,
              uniq: Optional[Dict[Tuple, float]] = None) -> None:
        instr.begin_einsum(name)
        for key in sorted(counts, key=repr):
            n = int(round(counts[key]))
            if n <= 0:
                continue
            tag = key[0]
            if tag == "touch":
                _, tensor, rank, kindk, rw = key
                u = None
                if uniq is not None and key in uniq:
                    uv = uniq[key]
                    u = int(round(min(uv, n)))
                    if uv > 0:
                        u = max(u, 1)       # 0 is reserved for on-chip
                instr.touch(name, tensor, rank, (), kindk, rw, n=n,
                            unique=u)
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
