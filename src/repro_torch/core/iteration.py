"""Loop-nest interpreter: executes one mapped Einsum on fibertrees.

This is the imperative-style IR the TeAAL simulator generator produces
(Section 4.3): a loop nest whose levels follow the mapping's loop order,
with per-rank fiber co-iteration (intersection for products / take,
union for sums), catch-up descents for tensors accessed by lookup
(affine indices, partially-bound flattened ranks), and reduction into
the output fibertree.  Every data access and compute op is reported to
an Instrumentation sink, from which the performance model derives
per-component action counts.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

from .einsum import (AffineIndex, BinOp, Einsum, Literal, Semiring, Take,
                     TensorAccess, expr_accesses)
from .fibertree import Fiber, FTensor
from .mapping import EinsumPlan, RankInfo
from .trace import Instrumentation, NullInstr

ABSENT = None


@dataclass
class _Cursor:
    """Traversal state of one tensor."""
    tensor: FTensor
    access: TensorAccess
    depth: int = 0                       # levels descended
    stack: Tuple = ()                    # fibers root->current
    path: Tuple = ()                     # coords root->current
    payload: Any = ABSENT                # scalar once fully descended
    absent: bool = False

    def current_fiber(self) -> Optional[Fiber]:
        if self.absent:
            return None
        return self.stack[-1] if self.stack else self.tensor.root


class _LeafIter:
    """A driving fiber's iterator, tagged with its tensor and fiber so
    intersection strategies can probe instead of enumerate."""

    __slots__ = ("tensor", "fiber", "path", "_it")

    def __init__(self, tensor, fiber, path, it):
        self.tensor = tensor
        self.fiber = fiber
        self.path = path
        self._it = it

    def __iter__(self):
        return self._it

    def __next__(self):
        return next(self._it)


class EinsumExecutor:
    """Executes one Einsum per its plan; returns the output FTensor in
    loop-concordant rank order (the generator swizzles it back)."""

    def __init__(self, plan: EinsumPlan, tensors: Dict[str, FTensor],
                 var_shapes: Dict[str, int],
                 semiring: Optional[Semiring] = None,
                 instr: Optional[Instrumentation] = None,
                 out_initial: Optional[FTensor] = None,
                 isect_strategy: str = "two_finger",
                 isect_leader: Optional[str] = None):
        self.plan = plan
        self.isect_strategy = isect_strategy
        self.isect_leader = isect_leader
        self.einsum = plan.einsum
        self.name = plan.output
        self.semiring = semiring or Semiring.arithmetic()
        self.instr = instr or NullInstr()
        self.var_shapes = var_shapes
        self.tensors = tensors

        self.accesses: List[TensorAccess] = []
        seen: Set[str] = set()
        for a in self.einsum.inputs:
            assert a.tensor not in seen, \
                f"tensor {a.tensor} accessed twice in one Einsum"
            seen.add(a.tensor)
            self.accesses.append(a)

        # output execution-form fibertree (loop-order-concordant)
        out_plan = plan.tensors[self.name]
        out_ranks = out_plan.exec_order
        self.out = FTensor(self.name, out_ranks,
                           rank_shapes={r: None for r in out_ranks},
                           upper_ranks={r for r in out_ranks
                                        if plan.created_ranks.get(r) == "upper"})
        self.out_initial = out_initial

        # per-level driver assignment
        self._assign_drive_levels()
        self._essential = self._essential_tensors(self.einsum.expr)

        # output descent schedule: loop level -> (out depth)
        self.out_descend: Dict[int, int] = {}
        depth = 0
        for li, ri in enumerate(plan.loop_order):
            if depth < len(out_ranks) and out_ranks[depth] == ri.name:
                self.out_descend[li] = depth
                depth += 1
        # output ranks not reached by loop-name matching: their coordinates
        # are computed from index-var bindings at the leaf (e.g. SIGMA's Z
        # has rank M whose var m binds at the flattened MK00 loop rank).
        self.n_matched = depth
        self.unmatched_out: List[str] = list(out_ranks[depth:])
        for r in self.unmatched_out:
            for ri in plan.loop_order:
                if set(self._rank_vars(r)) <= set(v for v in ri.vars):
                    break
            else:
                raise ValueError(
                    f"output rank {r} of {self.name} binds no loop rank")

    # ------------------------------------------------------------------ #
    def _assign_drive_levels(self) -> None:
        """For each input tensor level, decide the loop level at which it
        co-iterates (drives), or None => catch-up lookup."""
        loop = self.plan.loop_order
        # loop level at which each index var becomes bound
        var_bound_at: Dict[str, int] = {}
        for lj, rj in enumerate(loop):
            if rj.binds:
                for v in rj.vars:
                    var_bound_at[v] = lj
        self.drive: Dict[str, Dict[int, int]] = {}   # tensor -> {loop: depth}
        for acc in self.accesses:
            t = acc.tensor
            tp = self.plan.tensors[t]
            ranks = tp.exec_order
            mapping: Dict[int, int] = {}
            li = 0
            for d, r in enumerate(ranks):
                # access index for this level (original rank position)
                idx = self._level_index(acc, tp, d)
                bare = idx is None or idx.is_bare
                assigned = None
                for lj in range(li, len(loop)):
                    rj = loop[lj]
                    if rj.name == r and bare:
                        assigned = lj
                        break
                    # vars-exact match at a binding rank (e.g. tensor rank K
                    # co-iterating at loop rank K0)
                    if (bare and rj.binds and
                            tuple(sorted(rj.vars)) ==
                            tuple(sorted(self._level_vars(acc, tp, d, r)))):
                        assigned = lj
                        break
                if assigned is None:
                    # lookup level: coordinate computed from bindings during
                    # catch-up.  Deeper levels may still drive, but only at
                    # loop levels after this level's vars are all bound.
                    vars_ = (idx.vars if idx is not None
                             else self._level_vars(acc, tp, d, r))
                    # constant index (e.g. P[0, k0]): resolvable immediately
                    lv = max((var_bound_at.get(v, len(loop)) for v in vars_),
                             default=-1)
                    li = max(li, lv + 1)
                    continue
                mapping[assigned] = d
                li = assigned + 1
            self.drive[t] = mapping

    def _rank_vars(self, rank: str) -> Tuple[str, ...]:
        """Index vars spanned by a rank name (loop registry or fallback)."""
        for ri in self.plan.loop_order:
            if ri.name == rank:
                return ri.vars
        vm = self.plan.var_map.get(rank)
        if vm:
            return vm
        base = rank.rstrip("0123456789")
        return (base.lower(),) if len(base) == 1 \
            else tuple(ch.lower() for ch in base)

    def _level_vars(self, acc: TensorAccess, tp, depth: int, rank: str
                    ) -> Tuple[str, ...]:
        # vars spanned by this tensor level: from the rank-name registry
        # implied by the plan (rank names carry vars via loop RankInfos)
        for ri in self.plan.loop_order:
            if ri.name == rank:
                return ri.vars
        # fallback: strip partition suffix, lowercase
        base = rank.rstrip("0123456789")
        if len(base) > 1 and not base.isupper():
            return (base.lower(),)
        return tuple(ch.lower() for ch in base) if len(base) > 1 \
            else (base.lower(),)

    def _level_index(self, acc: TensorAccess, tp, depth: int
                     ) -> Optional[AffineIndex]:
        """The access AffineIndex corresponding to tensor level `depth`,
        or None when not recoverable (partitioned/flattened levels: bare)."""
        # map exec rank at this depth to a declared rank if it is one
        rank = tp.exec_order[depth]
        decl = list(acc.indices)
        # declared ranks of the access follow the tensor's declaration order
        from_decl = self.tensors.get(acc.tensor)
        decl_ranks = tp.declared_order
        if rank in decl_ranks and len(decl) == len(decl_ranks):
            return decl[decl_ranks.index(rank)]
        return None                     # partitioned/flattened: treat bare

    @staticmethod
    def _essential_tensors(expr) -> Set[str]:
        """Tensors appearing as a factor in *every* additive term: their
        absence annihilates the whole expression."""
        def terms(e) -> List[Set[str]]:
            if isinstance(e, BinOp) and e.op in "+-":
                return terms(e.lhs) + terms(e.rhs)
            return [ {a.tensor for a in expr_accesses(e)} ]
        ts = terms(expr)
        if not ts:
            return set()
        out = set(ts[0])
        for t in ts[1:]:
            out &= t
        return out

    # ------------------------------------------------------------------ #
    def run(self) -> FTensor:
        self.instr.begin_einsum(self.name)
        if not self.einsum.output.indices and isinstance(self.einsum.expr,
                                                         TensorAccess):
            # bare copy: P1 = P0
            src = self.tensors[self.einsum.expr.tensor]
            self.out = src.copy(self.name)
            for path, _ in self.out.iter_leaves():
                self.instr.touch(self.name, src.name, src.ranks[-1], path,
                                 "payload", "r")
                self.instr.touch(self.name, self.name, src.ranks[-1], path,
                                 "payload", "w")
            self.instr.end_einsum(self.name)
            return self.out

        cursors = {a.tensor: _Cursor(self.tensors[a.tensor], a)
                   for a in self.accesses}
        if self.out_initial is not None:
            # update-in-place semantics (e.g. GraphDynS filtered writes)
            self.out = self.out_initial.copy(self.name)
        bindings: Dict[str, int] = {}
        for c in cursors.values():
            self._catch_up(c, bindings, 0)
        self._loop(0, cursors, bindings, [self.out.root], ())
        self.instr.end_einsum(self.name)
        return self.out

    # ------------------------------------------------------------------ #
    def _catch_up(self, cur: _Cursor, bindings: Dict[str, int],
                  next_loop_level: int) -> None:
        """Descend `cur` through levels whose coordinates are computable
        from current bindings and that are not scheduled to drive at a
        later loop level."""
        if cur.absent:
            return
        tp = self.plan.tensors[cur.access.tensor]
        ranks = tp.exec_order
        drive = self.drive[cur.access.tensor]
        future_drive_depths = {d for l, d in drive.items()
                               if l >= next_loop_level}
        while cur.depth < len(ranks):
            d = cur.depth
            if d in future_drive_depths:
                return
            idx = self._level_index(cur.access, tp, d)
            rank = ranks[d]
            if idx is not None:
                if not all(v in bindings for v in idx.vars):
                    return
                coord = idx.evaluate(bindings)
            else:
                # partitioned/flattened level: coordinate derived from vars
                vars_ = self._level_vars(cur.access, tp, d, rank)
                if not all(v in bindings for v in vars_):
                    return
                vals = tuple(bindings[v] for v in vars_)
                coord = vals if len(vals) > 1 else vals[0]
                if self.plan.created_ranks.get(rank) == "upper":
                    # upper partition level: position by range (bisect)
                    coord = self._partition_start(cur, coord)
                    if coord is None:
                        self._mark_absent(cur)
                        return
            fiber = cur.current_fiber()
            self.instr.touch(self.name, cur.access.tensor, rank,
                             cur.path + (coord,), "coord", "r")
            payload = fiber.lookup(coord) if fiber is not None else None
            if payload is None:
                self._mark_absent(cur)
                return
            self._descend(cur, rank, coord, payload)

    def _partition_start(self, cur: _Cursor, coord) -> Optional[Any]:
        fiber = cur.current_fiber()
        if fiber is None or not fiber.coords:
            return None
        i = bisect.bisect_right(fiber.coords, coord) - 1
        if i < 0:
            return None
        return fiber.coords[i]

    def _mark_absent(self, cur: _Cursor) -> None:
        cur.absent = True
        cur.payload = ABSENT

    def _descend(self, cur: _Cursor, rank: str, coord, payload) -> None:
        if isinstance(payload, Fiber):
            cur.stack = cur.stack + (payload,)
            cur.payload = ABSENT
        else:
            cur.stack = cur.stack + (payload,)
            cur.payload = payload
            self.instr.touch(self.name, cur.access.tensor, rank,
                             cur.path + (coord,), "payload", "r")
        cur.path = cur.path + (coord,)
        cur.depth += 1

    # ------------------------------------------------------------------ #
    def _loop(self, level: int, cursors: Dict[str, _Cursor],
              bindings: Dict[str, int], out_stack: List,
              out_path: Tuple = ()) -> None:
        loop = self.plan.loop_order
        if level == len(loop):
            self._leaf(cursors, bindings, out_stack, out_path)
            return
        ri = loop[level]
        drivers = [t for t, m in self.drive.items() if level in m
                   and not cursors[t].absent]
        out_depth = self.out_descend.get(level)

        def body(coord, payloads: Dict[str, Any]):
            self.instr.iterate(self.name, ri.name, coord=coord)
            new_bind = bindings
            if ri.binds:
                new_bind = dict(bindings)
                vals = coord if isinstance(coord, tuple) else (coord,)
                for v, val in zip(ri.vars, vals):
                    new_bind[v] = val
            # clone cursors, descend drivers
            new_cursors: Dict[str, _Cursor] = {}
            for t, c in cursors.items():
                if t in payloads and not c.absent:
                    nc = _Cursor(c.tensor, c.access, c.depth, c.stack,
                                 c.path, c.payload, c.absent)
                    self._descend(nc, ri.name, coord, payloads[t])
                    new_cursors[t] = nc
                elif t in self._essential and t in drivers:
                    return            # unreachable (intersection semantics)
                else:
                    nc = _Cursor(c.tensor, c.access, c.depth, c.stack,
                                 c.path, c.payload, c.absent)
                    if t in drivers and t not in payloads:
                        # union semantics: this driver lacks the coordinate
                        nc.absent = True
                    new_cursors[t] = nc
            new_out = out_stack
            new_out_path = out_path
            if out_depth is not None:
                parent = out_stack[-1]
                is_insertion = (not self.unmatched_out
                                and out_depth == len(self.out.ranks) - 1)
                if is_insertion:
                    new_out = out_stack + [(parent, coord)]
                else:
                    new_out = out_stack + [parent.get_or_create(coord, Fiber)]
                new_out_path = out_path + (coord,)
            if ri.binds:
                for nc in new_cursors.values():
                    self._catch_up(nc, new_bind, level + 1)
                # essential tensor turned absent -> dead branch
                for t in self._essential:
                    if t in new_cursors and new_cursors[t].absent:
                        self.instr.advance(self.name, ri.name)
                        return
            self._loop(level + 1, new_cursors, new_bind, new_out, new_out_path)
            self.instr.advance(self.name, ri.name)

        if drivers:
            for coord, payloads in self._coiterate(self.einsum.expr, drivers,
                                                   cursors, ri):
                body(coord, payloads)
        else:
            # dense range over the rank's vars (e.g. conv output rank)
            assert not ri.flattened, \
                f"no driver for flattened rank {ri.name}"
            var = ri.vars[0]
            shape = self.var_shapes.get(var)
            assert shape is not None, f"unknown shape for var {var!r}"
            for coord in range(shape):
                body(coord, {})

    # ------------------------------------------------------------------ #
    def _coiterate(self, expr, drivers: List[str],
                   cursors: Dict[str, _Cursor], ri: RankInfo):
        """Iterator of (coord, {tensor: payload}) per the expression
        structure: intersection across product/take factors, union across
        additive terms."""
        it = self._build_coiter(expr, set(drivers), cursors, ri)
        if it is None:
            return iter(())
        return it

    def _build_coiter(self, expr, active: Set[str],
                      cursors: Dict[str, _Cursor], ri: RankInfo):
        if isinstance(expr, TensorAccess):
            if expr.tensor not in active:
                return None
            fiber = cursors[expr.tensor].current_fiber()
            if fiber is None:
                return None
            t = expr.tensor

            def leaf():
                for c, p in fiber:
                    self.instr.touch(self.name, t, ri.name,
                                     cursors[t].path + (c,), "coord", "r")
                    yield c, {t: p}
            return _LeafIter(t, fiber, cursors[t].path, leaf())
        if isinstance(expr, Take):
            children = [self._build_coiter(a, active, cursors, ri)
                        for a in expr.args]
            children = [c for c in children if c is not None]
            return self._intersect_many(children, ri)
        if isinstance(expr, BinOp):
            lhs = self._build_coiter(expr.lhs, active, cursors, ri)
            rhs = self._build_coiter(expr.rhs, active, cursors, ri)
            if expr.op == "*":
                children = [c for c in (lhs, rhs) if c is not None]
                return self._intersect_many(children, ri)
            return self._union2(lhs, rhs, ri)
        return None

    def _intersect_many(self, children: List, ri: RankInfo):
        if not children:
            return None
        if len(children) == 1:
            return children[0]
        it = children[0]
        for other in children[1:]:
            it = self._intersect2(it, other, ri)
        return it

    def _intersect2(self, a, b, ri: RankInfo):
        # leader-follower hardware (Gamma, vertex-centric apply): the
        # leader enumerates; the follower is *probed* by coordinate, so
        # its non-matching elements are never touched.
        if (self.isect_strategy == "leader_follower"
                and isinstance(a, _LeafIter) and isinstance(b, _LeafIter)):
            lead, foll = None, None
            if a.tensor == self.isect_leader:
                lead, foll = a, b
            elif b.tensor == self.isect_leader:
                lead, foll = b, a
            else:
                # no explicit leader among the pair: lead with the
                # smaller fiber (the dynamic choice real units make)
                lead, foll = (a, b) if len(a.fiber) <= len(b.fiber) \
                    else (b, a)
            return self._intersect_lookup(lead, foll, ri)

        def gen():
            ai = iter(a)
            bi = iter(b)
            av = next(ai, None)
            bv = next(bi, None)
            while av is not None and bv is not None:
                ca, pa = av
                cb, pb = bv
                for t in pa:
                    pass
                if ca == cb:
                    self.instr.isect_match(self.name, ri.name)
                    merged = dict(pa)
                    merged.update(pb)
                    yield ca, merged
                    av = next(ai, None)
                    bv = next(bi, None)
                    self._isect_count(pa, ri)
                    self._isect_count(pb, ri)
                elif ca < cb:
                    self._isect_count(pa, ri)
                    av = next(ai, None)
                else:
                    self._isect_count(pb, ri)
                    bv = next(bi, None)
            # drain counts for the remaining side are not incurred by
            # skip-ahead intersection; two-finger cost is modeled from
            # per-tensor step counts already recorded.
        return gen()

    def _isect_count(self, payload_dict: Dict[str, Any], ri: RankInfo):
        for t in payload_dict:
            self.instr.isect_step(self.name, ri.name, t)

    def _intersect_lookup(self, lead: "_LeafIter", foll: "_LeafIter",
                          ri: RankInfo):
        def gen():
            for c, pay in lead:
                self.instr.isect_step(self.name, ri.name, lead.tensor)
                self.instr.touch(self.name, foll.tensor, ri.name,
                                 foll.path + (c,), "coord", "r")
                p = foll.fiber.lookup(c)
                if p is None:
                    continue
                self.instr.isect_match(self.name, ri.name)
                merged = dict(pay)
                merged[foll.tensor] = p
                yield c, merged
        return gen()

    def _union2(self, a, b, ri: RankInfo):
        if a is None:
            return b
        if b is None:
            return a

        def gen():
            ai, bi = iter(a), iter(b)
            av = next(ai, None)
            bv = next(bi, None)
            while av is not None or bv is not None:
                if bv is None or (av is not None and av[0] < bv[0]):
                    yield av
                    av = next(ai, None)
                elif av is None or bv[0] < av[0]:
                    yield bv
                    bv = next(bi, None)
                else:
                    merged = dict(av[1])
                    merged.update(bv[1])
                    yield av[0], merged
                    av = next(ai, None)
                    bv = next(bi, None)
        return gen()

    # ------------------------------------------------------------------ #
    def _leaf(self, cursors: Dict[str, _Cursor], bindings: Dict[str, int],
              out_stack: List, out_path: Tuple = ()) -> None:
        val = self._eval(self.einsum.expr, cursors, bindings)
        if val == 0 or val is ABSENT:
            return
        # resolve output position
        tail = out_stack[-1]
        if self.unmatched_out:
            # descend remaining output ranks using coords from bindings
            fiber = tail
            assert isinstance(fiber, Fiber), "bad output stack state"
            for r in self.unmatched_out[:-1]:
                vars_ = self._rank_vars(r)
                c = (tuple(bindings[v] for v in vars_) if len(vars_) > 1
                     else bindings[vars_[0]])
                fiber = fiber.get_or_create(c, Fiber)
                out_path = out_path + (c,)
            vars_ = self._rank_vars(self.unmatched_out[-1])
            coord = (tuple(bindings[v] for v in vars_) if len(vars_) > 1
                     else bindings[vars_[0]])
        elif isinstance(tail, tuple):
            fiber, coord = tail
            out_path = out_path[:-1]
        else:
            # output has no rank at the innermost loops (fully reduced) --
            # the last descend left a (fiber, coord) pair; if out has rank 0
            # this cannot happen in our specs.
            raise AssertionError("output position not resolved")
        old = fiber.lookup(coord)
        ranks = self.out.ranks
        wpath = out_path + (coord,)
        if old is None:
            fiber.insert(coord, val)
            self.instr.touch(self.name, self.name, ranks[-1],
                             wpath, "payload", "w")
        else:
            self.instr.compute(self.name, "add")
            self.instr.touch(self.name, self.name, ranks[-1],
                             wpath, "payload", "r")
            fiber.insert(coord, self.semiring.add(old, val))
            self.instr.touch(self.name, self.name, ranks[-1],
                             wpath, "payload", "w")

    def _eval(self, expr, cursors: Dict[str, _Cursor],
              bindings: Dict[str, int]):
        if isinstance(expr, Literal):
            return expr.value
        if isinstance(expr, TensorAccess):
            cur = cursors[expr.tensor]
            if cur.absent:
                return 0
            if cur.depth < len(self.plan.tensors[expr.tensor].exec_order):
                # not fully descended (shouldn't happen after catch-up)
                return 0
            return cur.payload
        if isinstance(expr, Take):
            vals = [self._eval(a, cursors, bindings) for a in expr.args]
            if any(v == 0 or v is ABSENT for v in vals):
                return 0
            return vals[expr.which]
        if isinstance(expr, BinOp):
            lv = self._eval(expr.lhs, cursors, bindings)
            rv = self._eval(expr.rhs, cursors, bindings)
            if expr.op == "*":
                if lv == 0 or rv == 0:
                    return 0
                self.instr.compute(self.name, "mul")
                return self.semiring.mul(lv, rv)
            if expr.op == "+":
                if lv == 0:
                    return rv
                if rv == 0:
                    return lv
                self.instr.compute(self.name, "add")
                return self.semiring.add(lv, rv)
            if expr.op == "-":
                self.instr.compute(self.name, "add")
                return self.semiring.sub(lv, rv)
        raise TypeError(f"bad expr {expr!r}")


# ---------------------------------------------------------------------- #
# pluggable execution backends
# ---------------------------------------------------------------------- #
class ExecutorBackend:
    """Strategy interface: executes one mapped Einsum on execution-form
    tensors and returns the output fibertree in loop-concordant order.

    Implementations must be interchangeable: identical output tensors
    and identical aggregate Instrumentation action counts for the same
    (plan, tensors) inputs.  ``PythonBackend`` is the per-element
    correctness oracle; ``VectorBackend`` (core/vectorized.py) runs
    per-rank co-iteration over columnar CSF arrays and reports the same
    action counts in aggregate.

    Optional protocol extensions the generator probes with getattr:

      * ``last_path`` / ``last_fallback_reason`` -- set after each
        ``execute`` when the backend transparently fell back to the
        oracle, so the run result can surface silent fallbacks;
      * ``last_downgrades`` / ``last_batch_downgrades`` -- structured
        ``DowngradeEvent`` lists (kernels/backends.py) drained after
        each ``execute`` / ``execute_batch`` when the backend routes
        seam calls through a guarded degradation chain; the generator
        copies them onto ``SimResult.downgrade_events`` so no kernel
        downgrade is ever silent;
      * ``stage_seconds`` / ``last_batch_stage_seconds`` -- per-stage
        wall-second dicts from a profiling backend (VectorBackend's
        pipeline stages); the generator aggregates them onto
        ``SimResult.stage_seconds`` / ``Report.stage_seconds`` so
        benchmarks read the public result instead of backend
        internals;
      * ``prepare_inputs(plan, tensors, var_shapes) -> bool`` -- False
        lets the generator skip ``transform_all`` (analytic
        calibration-cache fast path);
      * ``merge_estimate(tensor, stored_ranks, prefix_depth,
        var_shapes)`` -- analytic merger-work events for
        unmaterialized intermediates;
      * ``notify_copy(dst, src)`` -- whole-tensor aliases the generator
        short-circuits, so stats-tracking backends can follow them.

    ``materializes`` is False for backends whose outputs carry no data
    (analytic): convergence-driven flows (``run_iterative``) must
    reject them rather than mistake empty outputs for convergence.
    """

    name = "abstract"
    materializes = True

    def execute(self, plan: EinsumPlan, tensors: Dict[str, FTensor],
                var_shapes: Dict[str, int],
                semiring: Optional[Semiring] = None,
                instr: Optional[Instrumentation] = None,
                out_initial: Optional[FTensor] = None,
                isect_strategy: str = "two_finger",
                isect_leader: Optional[str] = None) -> FTensor:
        raise NotImplementedError

    def execute_batch(self, requests: "List[Dict]") -> "List[FTensor]":
        """Execute a batch of *independent* Einsums (no request reads
        another's output).  Each request is an ``execute`` kwargs dict;
        results come back in request order with instrumentation and
        per-request fallback state identical to sequential execution.

        The default lowering is the sequential loop; backends override
        to share work across the batch (``VectorBackend`` reuses its
        kernel dispatch and workspace buffers and records the per-
        request paths on ``last_batch_paths``).  When a tracer is
        installed each request runs inside an ``einsum:<output>`` span
        so the batch seam carries the active trace (``VectorBackend``
        opens its own richer span in ``execute`` instead)."""
        from repro_torch.obs.spans import maybe_span
        outs, paths, reasons, events = [], [], [], []
        for req in requests:
            with maybe_span("einsum:" + req["plan"].output, "einsum",
                            {"backend": getattr(self, "name", "?")}):
                outs.append(self.execute(**req))
            paths.append(getattr(self, "last_path", None))
            reasons.append(getattr(self, "last_fallback_reason", None))
            events.append(list(getattr(self, "last_downgrades", ()) or ()))
        self.last_batch_paths = paths
        self.last_batch_fallbacks = reasons
        self.last_batch_downgrades = events
        return outs


class PythonBackend(ExecutorBackend):
    """The original object-interpreter path, kept as the oracle."""

    name = "python"

    def execute(self, plan, tensors, var_shapes, semiring=None, instr=None,
                out_initial=None, isect_strategy="two_finger",
                isect_leader=None) -> FTensor:
        return EinsumExecutor(
            plan, tensors, var_shapes, semiring=semiring, instr=instr,
            out_initial=out_initial, isect_strategy=isect_strategy,
            isect_leader=isect_leader).run()


def get_backend(backend: "str | ExecutorBackend | None") -> ExecutorBackend:
    """Resolve a backend selection
    ('python' | 'vector' | instance).  A bare 'vector' runs its seams
    on the CUDA device; pass a ``VectorBackend(device=...)`` instance to
    choose another."""
    if backend is None:
        return PythonBackend()
    if isinstance(backend, ExecutorBackend):
        return backend
    if backend == "python":
        return PythonBackend()
    if backend == "vector":
        from .vectorized import VectorBackend
        return VectorBackend()
    raise ValueError(f"unknown execution backend {backend!r} "
                     f"(expected 'python' or 'vector')")
