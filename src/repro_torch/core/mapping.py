"""Mapping resolution (TeAAL Sections 2.3, 3.2).

Turns the declarative mapping spec into an executable plan per Einsum:

  * applies partitioning directives (uniform_shape / uniform_occupancy /
    flatten) to every participating tensor, with leader-follower
    boundary adoption;
  * establishes the partitioned rank-name registry (K split twice ->
    K2, K1, K0; flatten (M, K0) -> MK0; ...) and the rank -> index-var
    correspondence;
  * resolves the loop order (default: output ranks then reduced ranks);
  * infers rank swizzles for concordant traversal (Sec. 3.2.2): inputs
    are swizzled to the loop order restricted to their ranks; outputs
    are built concordant with the loop order and swizzled back to their
    declared rank-order afterwards.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

from .einsum import Einsum, TensorAccess
from .fibertree import FTensor
from .spec import (AcceleratorSpec, Directive, EinsumMapping, Flatten,
                   MappingSpec, UniformOccupancy, UniformShape)


@dataclass
class RankInfo:
    """One loop rank: its name and the index vars it binds (if innermost)."""
    name: str
    vars: Tuple[str, ...]          # original index vars this rank spans
    binds: bool                    # True if this rank binds its vars
    #                                (innermost partition level)
    flattened: bool = False        # coordinates are tuples


@dataclass
class TensorPlan:
    """Per-tensor, per-Einsum transformation plan."""
    name: str
    declared_order: List[str]       # storage rank-order (mapping spec)
    exec_order: List[str]           # concordant order used in the loop nest
    partitioned: bool = False
    swizzled_online: bool = False   # intermediate swizzle (merger work)


@dataclass
class EinsumPlan:
    einsum: Einsum
    loop_order: List[RankInfo]
    tensors: Dict[str, TensorPlan]
    space_ranks: List[str]
    time_ranks: List[str]
    output: str
    # partition-created rank names: name -> 'upper' | 'innermost' | 'flat'
    created_ranks: Dict[str, str] = field(default_factory=dict)
    # rank name -> index vars it spans
    var_map: Dict[str, Tuple[str, ...]] = field(default_factory=dict)
    # tensor -> partitioning keys that apply to it (leader-follower aware)
    applied: Dict[str, List] = field(default_factory=dict)
    # tensor -> ordered transform steps with sizes resolved, so backends
    # that hold tensors in columnar (CSF) form can run the Sec. 3.2
    # pre-pass themselves without the spec/resolver in hand.  Steps:
    #   ("flatten", (rank, ...))                 flatten a rank group
    #   ("split", rank, ((kind, size, leader), ...))  top-down splits,
    #        kind in {"shape", "occupancy"}; leader None for shape
    transform_recipe: Dict[str, List[Tuple]] = field(default_factory=dict)

    @property
    def spatial_fanout_ranks(self) -> List[str]:
        return self.space_ranks


class MappingResolver:
    """Resolves a full AcceleratorSpec into per-Einsum plans and
    transformed fibertrees."""

    def __init__(self, spec: AcceleratorSpec,
                 params: Optional[Dict[str, int]] = None):
        self.spec = spec
        self.params = params or {}
        # registry: rank name -> tuple of original index vars
        self.var_map: Dict[str, Tuple[str, ...]] = {}
        for tensor, ranks in spec.einsum.declaration.items():
            for r in ranks:
                self.var_map.setdefault(r, (r.lower(),))

    # ------------------------------------------------------------------ #
    def _resolve_size(self, size: Union[int, str]) -> int:
        if isinstance(size, int):
            return size
        if size in self.params:
            return int(self.params[size])
        raise KeyError(f"unresolved symbolic partition size {size!r} "
                       f"(params: {sorted(self.params)})")

    # ------------------------------------------------------------------ #
    def plan(self, out_name: str) -> EinsumPlan:
        """Build the EinsumPlan (no tensor data needed)."""
        einsum = self.spec.einsum.einsum_for(out_name)
        em = self.spec.mapping.einsum_mapping(out_name)
        decl = self.spec.einsum.declaration

        # ---- simulate partitioning on rank *names* to build the registry
        # tensor -> current rank list (names)
        cur: Dict[str, List[str]] = {}
        for t in set([out_name] + einsum.input_names):
            order = self.spec.mapping.rank_order.get(t) or decl.get(t) or []
            cur[t] = list(order)

        partitioned_tensors: Dict[str, bool] = {t: False for t in cur}
        created: Dict[str, str] = {}
        applied: Dict[str, List] = {t: [] for t in cur}
        recipe: Dict[str, List[Tuple]] = {t: [] for t in cur}
        for key, directives in em.partitioning.items():
            if isinstance(key, tuple):
                # flatten group
                assert any(isinstance(dv, Flatten) for dv in directives)
                new_name = "".join(key)
                self.var_map[new_name] = tuple(
                    v for r in key for v in self.var_map[r])
                created[new_name] = "flat"
                for t, ranks in cur.items():
                    if all(r in ranks for r in key):
                        i = min(ranks.index(r) for r in key)
                        # ranks must be adjacent in-order after swizzle;
                        # we reorder names here (swizzle applied on data)
                        for r in key:
                            ranks.remove(r)
                        ranks[i:i] = [new_name]
                        partitioned_tensors[t] = True
                        applied[t].append(key)
                        recipe[t].append(("flatten", tuple(key)))
            else:
                n = len([dv for dv in directives
                         if not isinstance(dv, Flatten)])
                if n == 0:
                    continue
                new_names = [f"{key}{i}" for i in range(n, -1, -1)]
                for nm in new_names:
                    self.var_map[nm] = self.var_map[key]
                    created[nm] = "innermost" if nm.endswith("0") \
                        and nm == new_names[-1] else "upper"
                # snapshot: applicability must be judged against the state
                # before *any* tensor is split at this key (the leader may
                # come first in dict order and be renamed mid-pass)
                pre = {t: list(r) for t, r in cur.items()}
                split_steps = tuple(
                    ("shape", self._resolve_size(d.size), None)
                    if isinstance(d, UniformShape)
                    else ("occupancy", d.size, d.leader)
                    for d in directives if not isinstance(d, Flatten))
                for t, ranks in cur.items():
                    if key in ranks and self._partition_applies(
                            t, key, directives, pre):
                        i = ranks.index(key)
                        ranks[i:i + 1] = new_names
                        partitioned_tensors[t] = True
                        applied[t].append(key)
                        recipe[t].append(("split", key, split_steps))

        # ---- loop order
        if em.loop_order:
            loop_names = list(em.loop_order)
        else:
            # default: the output's ranks, then one rank per reduced index
            # var.  The iteration space is over the Einsum's index vars --
            # ranks that bind no einsum var (e.g. I's W in T[q,s]=I[q+s])
            # are accessed by affine lookup, never looped.
            out_ranks = list(cur[out_name])
            covered = {v for r in out_ranks
                       for v in self.var_map.get(r, (r.lower(),))}
            red_vars = [v for v in einsum.all_vars if v not in covered]
            red: List[str] = []
            for t in einsum.input_names:
                for r in cur[t]:
                    vars_ = self.var_map.get(r, (r.lower(),))
                    if (r not in red and r not in out_ranks
                            and vars_ and all(v in red_vars for v in vars_)):
                        red.append(r)
                        covered.update(vars_)
            for v in red_vars:
                if v not in covered:           # purely-affine var: synthesize
                    name = v.upper()
                    self.var_map.setdefault(name, (v,))
                    red.append(name)
                    covered.add(v)
            loop_names = out_ranks + red

        # strip annotations such as 'N.coord' (SIGMA spacetime syntax)
        def strip(r: str) -> str:
            return r.split(".")[0]

        loop_names = [strip(r) for r in loop_names]

        # which loop rank binds each var: the *last* rank in loop order
        # whose var-set covers the var
        binds_at: Dict[str, int] = {}
        for i, r in enumerate(loop_names):
            for v in self.var_map.get(r, ()):
                binds_at[v] = i
        loop: List[RankInfo] = []
        for i, r in enumerate(loop_names):
            vars_ = self.var_map.get(r, (r.lower(),))
            loop.append(RankInfo(
                name=r, vars=vars_,
                binds=all(binds_at.get(v) == i for v in vars_),
                flattened=len(vars_) > 1))

        # ---- per-tensor execution orders (concordant with loop order)
        # A rank that matches a loop name sits at that loop level; a rank
        # accessed by lookup sits just after the loop level where its index
        # vars are all bound (so catch-up descents stay concordant).
        def _level_key(rank: str):
            if rank in loop_names:
                return (loop_names.index(rank), 0)
            vars_ = self.var_map.get(rank, (rank.lower(),))
            lvl = max((binds_at.get(v, len(loop_names)) for v in vars_),
                      default=len(loop_names))
            return (lvl, 1)

        tensors: Dict[str, TensorPlan] = {}
        for t, ranks in cur.items():
            exec_order = sorted(ranks, key=_level_key)  # stable
            declared = self.spec.mapping.rank_order.get(t) or decl.get(t) or []
            tensors[t] = TensorPlan(
                name=t, declared_order=list(declared),
                exec_order=exec_order,
                partitioned=partitioned_tensors[t],
                swizzled_online=(t in self.spec.einsum.cascade_outputs
                                 and t != out_name))

        st = em.spacetime
        space = [strip(r) for r in (st.space if st else [])]
        time = [strip(r) for r in (st.time if st else loop_names)]
        return EinsumPlan(einsum=einsum, loop_order=loop, tensors=tensors,
                          space_ranks=space, time_ranks=time,
                          output=out_name, created_ranks=created,
                          var_map=dict(self.var_map), applied=applied,
                          transform_recipe=recipe)

    def _partition_applies(self, t: str, key: str, directives,
                           cur: Dict[str, List[str]]) -> bool:
        """A partitioning of ``key`` applies to tensor ``t`` unless an
        occupancy directive's leader has parent ranks (above ``key``) that
        ``t`` does not share.  In that case the leader's boundaries are
        per-parent-fiber and cannot be adopted statically by ``t``; the
        tensor stays unpartitioned and is accessed by coordinate lookup
        (e.g. Gamma's B, fetched row-by-row at bound k)."""
        for d in directives:
            if not isinstance(d, UniformOccupancy):
                continue
            if d.leader == t or d.leader not in cur:
                continue
            lranks = cur[d.leader]
            base = key if key in lranks else key + "0"
            if base not in lranks:
                continue
            above_leader = lranks[: lranks.index(base)]
            t_ranks = cur[t]
            tbase = key if key in t_ranks else key + "0"
            above_t = t_ranks[: t_ranks.index(tbase)] if tbase in t_ranks \
                else t_ranks
            for lr in above_leader:
                # strip partition suffixes when comparing base ranks
                lr_base = lr.rstrip("0123456789")
                if not any(r.rstrip("0123456789") == lr_base
                           for r in above_t):
                    return False
        return True

    # ------------------------------------------------------------------ #
    def transform_tensor(self, out_name: str, ft: FTensor) -> FTensor:
        """Apply this Einsum's partitioning + swizzle to one input tensor,
        returning the concordant execution-form fibertree."""
        em = self.spec.mapping.einsum_mapping(out_name)
        plan = self.plan(out_name)
        t = ft.name
        if t not in plan.tensors:
            return ft
        cur = ft

        applied_keys = plan.applied.get(t, [])
        for key, directives in em.partitioning.items():
            if key not in applied_keys:
                continue
            if isinstance(key, tuple):
                if not all(r in cur.ranks for r in key):
                    continue
                # make the group adjacent & ordered, then flatten pairwise
                others = [r for r in cur.ranks if r not in key]
                idx = min(cur.ranks.index(r) for r in key)
                new_order = others[:idx] + list(key) + others[idx:]
                cur = cur.swizzle(new_order)
                name_acc = key[0]
                for r in key[1:]:
                    cur = cur.flatten_ranks(name_acc, r)
                    name_acc = name_acc + r
            else:
                if key not in cur.ranks:
                    continue
                dirs = [d for d in directives if not isinstance(d, Flatten)]
                n = len(dirs)
                if n == 0:
                    continue
                # apply top-down: each directive splits the innermost segment
                seg = key
                produced: List[str] = []  # upper ranks created so far
                for d in dirs:
                    cur = self._apply_directive(cur, seg, d, out_name)
                    upper, lower = seg + "1", seg + "0"
                    produced.append(upper)
                    seg = lower
                # rename produced + final segment to K{n}..K0
                final_names = [f"{key}{i}" for i in range(n, 0, -1)] + [f"{key}0"]
                rename = dict(zip(produced + [seg], final_names))
                cur = cur.rename_ranks(rename)

        exec_order = plan.tensors[t].exec_order
        if cur.ranks != exec_order:
            cur = cur.swizzle(exec_order)
        return cur

    def _apply_directive(self, ft: FTensor, rank: str, d: Directive,
                         out_name: str) -> FTensor:
        if isinstance(d, UniformShape):
            return ft.partition_uniform_shape(rank, self._resolve_size(d.size))
        if isinstance(d, UniformOccupancy):
            leader = self._leaders.get((out_name, d.leader)) \
                if hasattr(self, "_leaders") else None
            if leader is not None and leader.name != ft.name:
                lrank = self._leader_rank(leader, rank)
                return ft.partition_uniform_occupancy(
                    rank, d.size, leader=leader, leader_rank=lrank)
            return ft.partition_uniform_occupancy(rank, d.size)
        raise TypeError(d)

    @staticmethod
    def _leader_rank(leader: FTensor, rank: str) -> str:
        # the leader may have already been partitioned; boundaries for the
        # follower's rank R come from the leader's R (pre-partitioned form)
        return rank

    # ------------------------------------------------------------------ #
    def transform_all(self, out_name: str,
                      tensors: Dict[str, FTensor]) -> Dict[str, FTensor]:
        """Transform every input tensor of an Einsum, honoring
        leader-follower occupancy adoption (leaders transformed first,
        and their *pre-swizzle* partitioned forms provide boundaries)."""
        em = self.spec.mapping.einsum_mapping(out_name)
        plan = self.plan(out_name)
        # leaders referenced by occupancy directives
        leader_names = {d.leader for dirs in em.partitioning.values()
                        for d in dirs if isinstance(d, UniformOccupancy)}
        self._leaders: Dict[Tuple[str, str], FTensor] = {}
        out: Dict[str, FTensor] = {}
        order = ([t for t in plan.tensors if t in leader_names]
                 + [t for t in plan.tensors if t not in leader_names])
        for t in order:
            if t not in tensors:
                continue
            ft = tensors[t]
            # leaders partition by their own occupancy; register the raw
            # (unpartitioned) form so followers can adopt boundaries
            if t in leader_names:
                self._leaders[(out_name, t)] = ft
            out[t] = self.transform_tensor(out_name, ft)
        self._leaders = {}
        return out
