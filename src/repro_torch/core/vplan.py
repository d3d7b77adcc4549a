"""VectorPlan: the typed per-rank IR the columnar ``VectorBackend`` runs.

``lower(plan, ...)`` turns an ``EinsumPlan`` into a ``VectorPlan`` -- a
per-loop-rank list of typed co-iteration ops plus a ``Reduce`` describing
output construction:

  * ``Drive``           enumerate one tensor level's fibers
  * ``Intersect``       co-iterate factors of a product / ``take()``
                        (two-finger or leader-follower, any arity,
                        left-nested pairwise exactly like the
                        interpreter's ``_intersect_many``)
  * ``UnionK``          k-ary sorted merge across additive terms
  * ``DenseEnumerate``  driverless (dense) rank: iterate the index
                        var's full coordinate range
  * ``Lookup``          catch-up descent of a non-driving tensor level
                        by bound coordinate (exact match, or
                        partition-upper range positioning)
  * ``Reduce``          leaf evaluation + segmented reduction into the
                        output, with per-rank coordinate sources
                        (loop-captured or recovered from index-var
                        bindings for leaf-bound output ranks)

``_Unsupported`` is raised **only here**, never mid-execution: if
``lower`` returns, the vector path can run the plan.  Affine and
constant index maps lower onto ``Lookup`` (coordinate translation on
the probe stream), any semiring with vectorized forms parameterizes
``Reduce`` and leaf compute, and update-in-place outputs seed the
reduction from the existing tensor's points.  What remains outside the
IR -- bare copies, sums of non-atomic or rank-unaligned terms, affine
*output* indices, interpreter-only semirings -- falls back to the
interpreter per Einsum.

``prepare_csf_inputs`` is the pre-pass for the columnar entry point
(``VectorBackend.execute_csf``): it applies the Einsum's Section-3.2
transform recipe (swizzle / flatten / uniform partitioning, recorded on
``EinsumPlan.transform_recipe``) directly on CSF arrays, so
SIGMA-style flattened and OuterSPACE-style partitioned workloads run
at scale without ever materializing per-element fibertrees.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from .einsum import AffineIndex, BinOp, Semiring, Take, TensorAccess
from .iteration import EinsumExecutor
from .mapping import EinsumPlan
from .trace import NullInstr


class _Unsupported(Exception):
    """Plan shape the vector path does not cover (-> fallback).

    ``einsum`` (when known) names the output tensor whose plan failed
    to lower, so batched runs and sweep errors can say *which* Einsum
    forced the oracle rather than just why."""

    def __init__(self, reason: str, einsum: Optional[str] = None):
        self.reason = reason
        self.einsum = einsum
        super().__init__(
            f"{einsum}: {reason}" if einsum else reason)


# ---------------------------------------------------------------------- #
# IR node types
# ---------------------------------------------------------------------- #
@dataclass(frozen=True)
class Drive:
    """Enumerate the fibers of one tensor level."""
    tensor: str
    depth: int
    leaf: bool                       # deepest level: matches touch payloads


@dataclass(frozen=True)
class Intersect:
    """Product / take() co-iteration; executed as a left-nested chain of
    pairwise merges (``((c0 ^ c1) ^ c2) ...``), mirroring the
    interpreter.  ``leader_follower`` applies to Drive/Drive pairs only
    (deeper pairs two-finger), again mirroring the interpreter."""
    children: Tuple = ()
    strategy: str = "two_finger"
    leader: Optional[str] = None


@dataclass(frozen=True)
class UnionK:
    """k-ary sorted union across additive terms."""
    children: Tuple = ()


@dataclass(frozen=True)
class DenseEnumerate:
    """Driverless rank: iterate ``range(shape)`` of the index var."""
    var: str
    shape: int


@dataclass(frozen=True)
class Lookup:
    """Catch-up descent of one non-driving tensor level, probed by the
    coordinate computed from index-var bindings.

    ``index`` carries the affine map (coordinate shift/scale) for
    non-bare accesses -- the probe is ``const + sum(coeff * var_col)``
    over captured frontier columns (im2col-style windowing for conv's
    ``I[b, c, p+r, q+s]``).  ``index is None`` means a bare/derived
    probe built by stacking the level's var columns."""
    tensor: str
    depth: int
    rank: str
    vars: Tuple[str, ...]
    partition_start: bool            # position-by-range (upper partition)
    leaf: bool
    essential: bool                  # miss kills the branch
    index: Optional[AffineIndex] = None


@dataclass
class LevelIR:
    """One loop rank: its co-iteration op, binding info, the output
    descend depth (if an output rank sits here), and the catch-up
    lookups scheduled right after its bindings land."""
    rank: str
    width: int
    binds: bool
    vars: Tuple[str, ...]
    out_depth: Optional[int]
    op: object                       # Drive | Intersect | UnionK | DenseEnumerate
    lookups: List[Lookup] = field(default_factory=list)


@dataclass
class Reduce:
    """Output construction: per exec-order output rank, where its
    coordinates come from -- ("level", li) for loop-matched ranks,
    ("vars", vars) for leaf-bound ranks recovered from bindings.

    The segmented reduction over the fused-key sort folds contributions
    with ``semiring.add`` (sequential order, bit-exact against the
    interpreter); ``has_initial`` seeds the groups from the existing
    output tensor's points (update-in-place)."""
    out_ranks: List[str]
    sources: List[Tuple]
    widths: List[int]
    upper_ranks: Set[str]
    semiring: Semiring = field(default_factory=Semiring.arithmetic)
    has_initial: bool = False
    #: leading sources that are loop levels 0, 1, 2, ... in order (and
    #: all above the innermost level).  The frontier is lexicographically
    #: sorted by level coordinates, so these columns arrive
    #: non-decreasing and batched execution can group them with one
    #: boundary scan instead of a sort (``vectorized._finalize_fused``).
    prefix_sources: int = 0


@dataclass(frozen=True)
class LeafFuse:
    """Innermost-level fusion descriptor: the last loop level is a
    single-tensor ``Drive`` of ``driven``'s leaf with no lookups, the
    expression is a two-factor arithmetic product, and ``other``'s leaf
    value is already positioned on the frontier.  Execution can then
    batch the whole frontier x leaf-fiber expansion into one wide
    gather-multiply-bincount pass (``vectorized._finalize_fused``)
    instead of materializing the innermost frontier and sorting it --
    runtime still falls back to the generic path when the dense group
    domain is inadmissible for the chunk at hand."""
    driven: str                      # tensor enumerated at the last level
    other: str                       # the co-factor, at its leaf already


@dataclass
class VectorPlan:
    name: str
    expr: object
    accs: List[TensorAccess]
    levels: List[LevelIR]
    reduce: Reduce
    essential: Set[str]
    leaf_depth: Dict[str, int]
    #: index vars whose bound values must be captured as frontier
    #: columns (lookup probes + leaf-bound output coordinates):
    #: var -> (loop level, coordinate column at that level)
    capture_vars: Dict[str, Tuple[int, int]]
    semiring: Semiring = field(default_factory=Semiring.arithmetic)
    #: constant-index descents resolvable before the first loop level
    #: (e.g. the FFT cascade's P[0, k0, ...] root coordinate)
    pre_lookups: List[Lookup] = field(default_factory=list)
    #: set when the innermost level admits batched leaf fusion
    leaf_fuse: Optional[LeafFuse] = None


# ---------------------------------------------------------------------- #
# expression shape validation
# ---------------------------------------------------------------------- #
def _walk_expr(expr, accs: List[TensorAccess], has_sum: List[bool]) -> None:
    if isinstance(expr, TensorAccess):
        # affine / constant indices lower onto Lookup probes; nothing to
        # reject here (unschedulable maps raise during lookup placement)
        accs.append(expr)
        return
    if isinstance(expr, Take):
        for a in expr.args:
            _walk_expr(a, accs, has_sum)
        return
    if isinstance(expr, BinOp):
        if expr.op in "+-":
            has_sum[0] = True
        elif expr.op != "*":
            raise _Unsupported(f"operator {expr.op!r}")
        _walk_expr(expr.lhs, accs, has_sum)
        _walk_expr(expr.rhs, accs, has_sum)
        return
    raise _Unsupported(f"expression node {expr!r}")


def _sum_terms(expr) -> List:
    """Flatten an additive expression into its terms (each term must be
    a plain access for the vector path)."""
    if isinstance(expr, BinOp) and expr.op in "+-":
        return _sum_terms(expr.lhs) + _sum_terms(expr.rhs)
    return [expr]


# ---------------------------------------------------------------------- #
# lowering
# ---------------------------------------------------------------------- #
def _build_op(expr, active: Set[str], leaf_depth: Dict[str, int],
              depth_at: Dict[str, int], essential: Set[str],
              strategy: str, leader: Optional[str]):
    """Co-iteration op tree for one level, mirroring the interpreter's
    ``_build_coiter``: intersection across product/take factors, union
    across additive terms; inactive operands drop out."""
    if isinstance(expr, TensorAccess):
        t = expr.tensor
        if t not in active:
            return None
        d = depth_at[t]
        return Drive(t, d, d == leaf_depth[t])
    if isinstance(expr, Take):
        children = [_build_op(a, active, leaf_depth, depth_at, essential,
                              strategy, leader) for a in expr.args]
        children = [c for c in children if c is not None]
        return _isect_many(children, essential, strategy, leader)
    if isinstance(expr, BinOp):
        lhs = _build_op(expr.lhs, active, leaf_depth, depth_at, essential,
                        strategy, leader)
        rhs = _build_op(expr.rhs, active, leaf_depth, depth_at, essential,
                        strategy, leader)
        if expr.op == "*":
            children = [c for c in (lhs, rhs) if c is not None]
            return _isect_many(children, essential, strategy, leader)
        if lhs is None:
            return rhs
        if rhs is None:
            return lhs
        lparts = lhs.children if isinstance(lhs, UnionK) else (lhs,)
        rparts = rhs.children if isinstance(rhs, UnionK) else (rhs,)
        return UnionK(lparts + rparts)
    return None


def _op_tensors(op) -> Set[str]:
    if isinstance(op, Drive):
        return {op.tensor}
    out: Set[str] = set()
    for c in getattr(op, "children", ()):
        out |= _op_tensors(c)
    return out


def _isect_many(children: List, essential: Set[str], strategy: str,
                leader: Optional[str]):
    if not children:
        return None
    if len(children) == 1:
        return children[0]
    # an absent operand under an intersection would degrade it to the
    # remaining factors (interpreter semantics); that cannot happen when
    # every factor annihilates the expression (essential), which the
    # plain product / take() cascades all satisfy
    for c in children:
        if not _op_tensors(c) <= essential:
            raise _Unsupported("intersection over possibly-absent operands")
    return Intersect(tuple(children), strategy, leader)


def lower(plan: EinsumPlan, var_shapes: Dict[str, int],
          semiring: Optional[Semiring] = None,
          out_initial=None, isect_strategy: str = "two_finger",
          isect_leader: Optional[str] = None) -> VectorPlan:
    """EinsumPlan -> VectorPlan, or raise ``_Unsupported`` (tagged with
    the Einsum's output name, so multi-Einsum runs report which plan
    declined the vector path)."""
    try:
        return _lower(plan, var_shapes, semiring, out_initial,
                      isect_strategy, isect_leader)
    except _Unsupported as exc:
        if exc.einsum is None:
            raise _Unsupported(exc.reason, plan.output) from None
        raise


def _lower(plan: EinsumPlan, var_shapes: Dict[str, int],
           semiring: Optional[Semiring] = None,
           out_initial=None, isect_strategy: str = "two_finger",
           isect_leader: Optional[str] = None) -> VectorPlan:
    semiring = semiring or Semiring.arithmetic()
    if not semiring.has_vector_forms:
        raise _Unsupported(
            f"semiring {semiring.name} has no vectorized forms")
    einsum = plan.einsum
    if not einsum.output.indices:
        raise _Unsupported("bare copy")
    # constant output indices (E[0, k0]) ride the loop-rank name match
    # exactly like the interpreter; true affine output maps do not
    if any(ix.terms and not ix.is_bare for ix in einsum.output.indices):
        raise _Unsupported("affine output indices")

    accs: List[TensorAccess] = []
    has_sum = [False]
    _walk_expr(einsum.expr, accs, has_sum)
    if not accs:
        raise _Unsupported("no tensor operands")
    if has_sum[0]:
        for term in _sum_terms(einsum.expr):
            if not isinstance(term, TensorAccess):
                raise _Unsupported("sum of non-atomic terms")

    # the interpreter's own analysis is the single source of truth for
    # drive/lookup level assignment and output descent
    try:
        ex = EinsumExecutor(plan, {}, var_shapes, semiring=semiring,
                            instr=NullInstr(),
                            isect_strategy=isect_strategy,
                            isect_leader=isect_leader)
    except (ValueError, AssertionError) as e:
        raise _Unsupported(str(e))

    loop = plan.loop_order
    leaf_depth = {a.tensor: len(plan.tensors[a.tensor].exec_order) - 1
                  for a in accs}
    order = [a.tensor for a in accs]

    if has_sum[0]:
        all_levels = frozenset(range(len(loop)))
        for t in order:
            if frozenset(ex.drive[t]) != all_levels:
                raise _Unsupported("summands with unaligned ranks")

    # loop level at which each var binds
    var_bound_at: Dict[str, int] = {}
    for li, ri in enumerate(loop):
        if ri.binds:
            for v in ri.vars:
                var_bound_at[v] = li

    # ---- per-level ops
    levels: List[LevelIR] = []
    for li, ri in enumerate(loop):
        active = {t for t in order if li in ex.drive[t]}
        depth_at = {t: ex.drive[t][li] for t in active}
        op = _build_op(einsum.expr, active, leaf_depth, depth_at,
                       ex._essential, isect_strategy, isect_leader)
        if op is None:
            if ri.flattened:
                raise _Unsupported(f"driverless flattened rank {ri.name}")
            var = ri.vars[0]
            shape = var_shapes.get(var)
            if shape is None:
                raise _Unsupported(f"unknown shape for dense rank {ri.name}")
            op = DenseEnumerate(var, int(shape))
        levels.append(LevelIR(rank=ri.name, width=len(ri.vars),
                              binds=ri.binds, vars=ri.vars,
                              out_depth=ex.out_descend.get(li), op=op))

    # ---- catch-up lookups: schedule every non-driving tensor level at
    # the first binding loop level where its coordinate is computable
    # and its parent level has been descended.  Affine/constant access
    # indices carry their map onto the Lookup (probe translation);
    # constant-only levels whose parents are all pre-descended resolve
    # before the loop entirely (pre_lookups).
    acc_of = {a.tensor: a for a in accs}
    pre_lookups: List[Lookup] = []
    for t in order:
        tp = plan.tensors[t]
        drive = ex.drive[t]
        depth_level: Dict[int, int] = {}     # depth -> loop level available
        drive_depths = set(drive.values())
        next_drive_after = sorted(drive.items())
        for d in range(len(tp.exec_order)):
            if d in drive_depths:
                lv = next(l for l, dd in drive.items() if dd == d)
                depth_level[d] = lv
                continue
            rank = tp.exec_order[d]
            idx = ex._level_index(acc_of[t], tp, d)
            if idx is not None and not idx.is_bare:
                vars_ = idx.vars
            else:
                idx = None             # bare/derived level: stack var cols
                vars_ = ex._level_vars(None, tp, d, rank)
                if not vars_:
                    raise _Unsupported(
                        f"{t}: lookup level {rank} binds no vars")
            if any(v not in var_bound_at for v in vars_):
                raise _Unsupported(f"{t}: unbound lookup level {rank}")
            need = max((var_bound_at[v] for v in vars_), default=-1)
            prior = depth_level.get(d - 1, -1) if d > 0 else -1
            lv = max(need, prior)
            # catch-up runs only after binding levels (lv == -1: all
            # probe inputs constant, descend before the first level)
            while 0 <= lv < len(loop) and not loop[lv].binds:
                lv += 1
            if lv >= len(loop):
                raise _Unsupported(f"{t}: no binding level for {rank}")
            nxt = next((l for l, dd in next_drive_after if dd > d), None)
            if nxt is not None and lv >= nxt:
                raise _Unsupported(
                    f"{t}: lookup level {rank} resolves after its next "
                    f"driving level")
            depth_level[d] = lv
            # partition-created upper levels position by range; the
            # plan's created_ranks map is authoritative (a *declared*
            # rank whose name happens to end in a digit is exact-match)
            part = plan.created_ranks.get(rank) == "upper"
            if part and idx is not None:
                raise _Unsupported(
                    f"{t}: affine index on partition rank {rank}")
            lk = Lookup(
                tensor=t, depth=d, rank=rank, vars=tuple(vars_),
                partition_start=part, leaf=(d == leaf_depth[t]),
                essential=(t in ex._essential), index=idx)
            if lv < 0:
                pre_lookups.append(lk)
            else:
                levels[lv].lookups.append(lk)

    # every lookup var and leaf-bound output var must be capturable
    out_ranks = list(plan.tensors[plan.output].exec_order)
    matched = {}
    for li, lvl in enumerate(levels):
        if lvl.out_depth is not None:
            matched[lvl.out_depth] = li
    sources: List[Tuple] = []
    widths: List[int] = []
    needed_vars: Set[str] = set()
    for d, r in enumerate(out_ranks):
        if d in matched:
            sources.append(("level", matched[d]))
            widths.append(levels[matched[d]].width)
        else:
            vars_ = ex._rank_vars(r)
            sources.append(("vars", tuple(vars_)))
            widths.append(len(vars_))
            needed_vars.update(vars_)
    for lvl in levels:
        for lk in lvl.lookups:
            needed_vars.update(lk.vars)

    capture_vars: Dict[str, Tuple[int, int]] = {}
    for li, ri in enumerate(loop):
        if ri.binds:
            for col, v in enumerate(ri.vars):
                if v in needed_vars and v not in capture_vars:
                    capture_vars[v] = (li, col)
    missing = needed_vars - set(capture_vars)
    if missing:
        raise _Unsupported(f"uncapturable index vars {sorted(missing)}")

    if out_initial is not None and list(out_initial.ranks) != out_ranks:
        raise _Unsupported(
            f"update-in-place output not in execution form "
            f"({list(out_initial.ranks)} vs {out_ranks})")

    # sorted-prefix run length: leading output sources that are loop
    # levels 0, 1, 2, ... in order arrive lexicographically sorted on
    # the frontier (levels above the innermost one only -- the
    # innermost level's columns are per-element, not per-item)
    last_li = len(levels) - 1
    prefix_sources = 0
    for src in sources:
        if src[0] == "level" and src[1] == prefix_sources \
                and src[1] < last_li:
            prefix_sources += 1
        else:
            break

    # innermost-level fusion: a lone leaf Drive under a two-factor
    # arithmetic product lets execution batch the frontier x leaf-fiber
    # expansion into one wide gather-multiply-bincount pass
    leaf_fuse = None
    lvl_last = levels[-1]
    if (len(levels) >= 2 and isinstance(lvl_last.op, Drive)
            and lvl_last.op.leaf and not lvl_last.lookups
            and semiring.mul_vec is np.multiply
            and semiring.add_vec is np.add
            and out_initial is None
            and isinstance(einsum.expr, BinOp) and einsum.expr.op == "*"
            and isinstance(einsum.expr.lhs, TensorAccess)
            and isinstance(einsum.expr.rhs, TensorAccess)):
        factors = {einsum.expr.lhs.tensor, einsum.expr.rhs.tensor}
        drv = lvl_last.op.tensor
        if drv in factors and len(factors) == 2:
            leaf_fuse = LeafFuse(driven=drv, other=(factors - {drv}).pop())

    red = Reduce(out_ranks=out_ranks, sources=sources, widths=widths,
                 upper_ranks={r for r in out_ranks
                              if plan.created_ranks.get(r) == "upper"},
                 semiring=semiring,
                 has_initial=out_initial is not None,
                 prefix_sources=prefix_sources)
    return VectorPlan(name=plan.output, expr=einsum.expr, accs=accs,
                      levels=levels, reduce=red, essential=set(ex._essential),
                      leaf_depth=leaf_depth, capture_vars=capture_vars,
                      semiring=semiring, pre_lookups=pre_lookups,
                      leaf_fuse=leaf_fuse)


# ---------------------------------------------------------------------- #
# pre-pass: Section-3.2 transforms on CSF arrays
# ---------------------------------------------------------------------- #
def prepare_csf_inputs(plan: EinsumPlan, tensors: Dict) -> Dict:
    """Apply the Einsum's recorded transform recipe (flatten / uniform
    partitioning / concordant swizzle) to raw CSF inputs, returning
    execution-form CSFs.  Mirrors ``MappingResolver.transform_tensor``
    but stays columnar end-to-end; leader-follower occupancy adoption
    (dynamic per-fiber boundaries) is not expressible on arrays and
    raises ``_Unsupported``."""
    out: Dict = {}
    for name, cur in tensors.items():
        tp = plan.tensors.get(name)
        if tp is None:
            out[name] = cur
            continue
        for step in plan.transform_recipe.get(name, ()):
            if step[0] == "flatten":
                key = step[1]
                if not all(r in cur.ranks for r in key):
                    continue
                others = [r for r in cur.ranks if r not in key]
                idx = min(cur.ranks.index(r) for r in key)
                new_order = others[:idx] + list(key) + others[idx:]
                if new_order != cur.ranks:
                    cur = cur.swizzle(new_order)
                acc = key[0]
                for r in key[1:]:
                    cur = cur.flatten_ranks(acc, r)
                    acc = acc + r
            else:
                _, key, dirs = step
                if key not in cur.ranks:
                    continue
                seg = key
                produced: List[str] = []
                for kind, size, leader in dirs:
                    if kind == "occupancy" and leader not in (None, name):
                        raise _Unsupported(
                            f"{name}: leader-follower occupancy adoption "
                            f"(leader {leader}) needs the fibertree path")
                    cur = (cur.partition_uniform_shape(seg, size)
                           if kind == "shape"
                           else cur.partition_uniform_occupancy(seg, size))
                    produced.append(seg + "1")
                    seg = seg + "0"
                final = [f"{key}{i}" for i in range(len(dirs), 0, -1)] \
                    + [f"{key}0"]
                cur = cur.rename_ranks(dict(zip(produced + [seg], final)))
        if list(cur.ranks) != list(tp.exec_order):
            cur = cur.swizzle(tp.exec_order)
        out[name] = cur
    return out
