"""Hardware component action-count models (TeAAL Sec. 4.1.2 / Table 3).

The ``PerformanceModel`` is an Instrumentation sink: the executing loop
nest streams data-access / iteration / compute events into it, and each
event is routed to the hardware component bound to it (Sec. 4.1.3).
Storage components simulate residency online (buffets with explicit
evict-on epochs, caches with LRU), so DRAM traffic is derived from real
misses on real data rather than an analytic distribution -- the fidelity
claim of the paper.

Components and their attributes (Table 3):
  DRAM          bandwidth (GB/s)
  Buffer        type (buffet | cache), width (bytes/line), depth (lines),
                bandwidth (GB/s, optional)
  Intersection  type (two_finger | leader_follower | skip_ahead), leader
  Merger        inputs, comparator_radix, outputs, order, reduce
  Sequencer     num_ranks
  Compute       type (mul | add)

Cycle attribution honors spatial work scheduling: events are keyed by
the coordinates of the mapping's ``space`` ranks, and a spatially
fanned-out component's cycle count is the *maximum* over its spatial
instances (real load imbalance, not an average).
"""
from __future__ import annotations

import math
import threading
from collections import Counter, OrderedDict, defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from .density import stat_misses
from .fibertree import Fiber, FTensor
from .formats import fiber_header_bytes, subtree_bytes, touch_bytes
from .mapping import EinsumPlan
from .spec import (AcceleratorSpec, Component, EinsumBinding, RankFormat,
                   StorageBinding, TensorFormat)
from .trace import Instrumentation

SpatialKey = Tuple

# ---------------------------------------------------------------------- #
# point-axis vectorized statistical residency (DSE batched replay)
# ---------------------------------------------------------------------- #
#: thread-local feed of pre-vectorized ``stat_misses`` values.  The DSE
#: engine computes the capacity-dependent miss closed form for a whole
#: group of design points in one numpy pass (``density.
#: batched_stat_misses`` over the point axis) and replays the recorded
#: event stream per point under ``stat_miss_feed`` -- each touch_stat
#: then consumes its precomputed value instead of recomputing it.  A
#: feed entry that does not match the live call (routing drift) makes
#: the feed stand down and the scalar closed form take over, so feeding
#: is an optimization that can never change results.
_STAT_FEED = threading.local()


@contextmanager
def stat_miss_feed(feed):
    prev = getattr(_STAT_FEED, "feed", None)
    _STAT_FEED.feed = feed
    try:
        yield
    finally:
        _STAT_FEED.feed = prev



# ---------------------------------------------------------------------- #
# storage levels
# ---------------------------------------------------------------------- #
class DRAM:
    """Backing store: accumulates bytes; time = bytes / bandwidth."""

    def __init__(self, name: str, bandwidth_gbs: float):
        self.name = name
        self.bandwidth_gbs = bandwidth_gbs
        self.read_bytes = 0.0
        self.write_bytes = 0.0

    def access(self, nbytes: float, rw: str, key: Any = None) -> None:
        if rw == "r":
            self.read_bytes += nbytes
        else:
            self.write_bytes += nbytes

    @property
    def total_bytes(self) -> float:
        return self.read_bytes + self.write_bytes

    def seconds(self) -> float:
        return self.total_bytes / (self.bandwidth_gbs * 1e9)


class StorageLevel:
    """One buffer level for one binding.  ``buffet`` has an explicit
    fill/drain policy (evict_on rank epochs); ``cache`` is LRU.  Capacity
    is tracked in *bytes* (width x depth), so occupancy-sized residency
    granules (eager subtrees) displace proportionally."""

    def __init__(self, comp: Component, binding: StorageBinding,
                 instances: int, backing: "StorageLevel | DRAM"):
        self.comp = comp
        self.binding = binding
        self.instances = instances
        self.backing = backing
        self.kind = comp.attrs.get("type", "buffet")
        self.width = float(comp.attrs.get("width", 8))      # bytes / line
        self.depth = int(comp.attrs.get("depth", 1 << 30))  # lines
        self.capacity_bytes = self.width * self.depth * instances
        self.bandwidth_gbs = comp.attrs.get("bandwidth")
        # residency state: key -> [bytes, dirty]
        self.resident: "OrderedDict[Any, list]" = OrderedDict()
        self.resident_bytes = 0.0
        # stats
        self.reads = 0
        self.writes = 0
        self.fills = 0
        self.drains = 0
        self.fill_bytes = 0.0
        self.drain_bytes = 0.0
        self.access_bytes = 0.0

    # -------------------------------------------------------------- #
    def touch(self, key: Any, nbytes: float, rw: str,
              fill_bytes: Optional[float] = None, n: int = 1) -> None:
        """``n`` accesses of ``nbytes`` each; ``fill_bytes`` is the
        transfer size on a miss (subtree for eager bindings, line for
        caches).  Aggregate touches (n > 1, from the vector backend)
        count every access but model residency as a single fill."""
        self.access_bytes += nbytes * n
        if rw == "r":
            self.reads += n
        else:
            self.writes += n
        got = self.resident.get(key)
        if got is not None:
            self.resident.move_to_end(key)
            if rw == "w":
                got[1] = True
            return
        # miss -> fill from backing (outputs fill empty: no read for 'w')
        size = fill_bytes if fill_bytes is not None else \
            (self.width if self.kind == "cache" else max(nbytes, 1e-9))
        self.fills += 1
        self.fill_bytes += size
        if rw == "r":
            self._backing_access(size, "r", key)
        self.resident[key] = [size, rw == "w"]
        self.resident_bytes += size
        while self.resident_bytes > self.capacity_bytes \
                and len(self.resident) > 1:
            old_key, (osize, dirty) = self.resident.popitem(last=False)
            self.resident_bytes -= osize
            if dirty:
                self._drain_one(osize, old_key)

    def touch_stat(self, key: Any, nbytes: float, rw: str, n: int,
                   unique: int) -> None:
        """Statistical residency for aggregate touches that carry a
        distinct-element hint (the analytic backend): ``unique`` cold
        misses, plus capacity misses on the reuse accesses when the
        touched footprint exceeds this level's capacity -- the
        Sparseloop-style closed-form a path-exact LRU cannot provide
        from aggregate events.  ``unique == 0`` means the data is
        produced on chip (read-modify of freshly written output): pure
        bandwidth accesses, no backing traffic."""
        self.access_bytes += nbytes * n
        if rw == "r":
            self.reads += n
        else:
            self.writes += n
        unique = max(0, min(int(unique), n))
        if unique == 0 or nbytes <= 0:
            return
        footprint = unique * nbytes
        misses = None
        feed = getattr(_STAT_FEED, "feed", None)
        if feed is not None:
            misses = feed.take(self, nbytes, n, unique)
        if misses is None:
            misses = stat_misses(n, unique, nbytes, self.capacity_bytes)
        self.fills += int(round(misses))
        self.fill_bytes += misses * nbytes
        if rw == "r":
            self._backing_access(misses * nbytes, "r", key)
        else:
            # written data eventually drains through the backing store
            self.drains += unique
            self.drain_bytes += footprint
            self._backing_access(footprint, "w", key)

    def access(self, nbytes: float, rw: str, key: Any = None) -> None:
        """Entry point when a *child* level fills/drains through us."""
        self.touch(key if key is not None else object(), nbytes, rw,
                   fill_bytes=nbytes)

    def _backing_access(self, nbytes: float, rw: str, key: Any) -> None:
        self.backing.access(nbytes, rw, key)

    def _drain_one(self, size: float, key: Any) -> None:
        self.drains += 1
        self.drain_bytes += size
        self._backing_access(size, "w", key)

    def evict_all(self, size_fn=None) -> None:
        """Buffet drain at an evict-on epoch boundary."""
        for key, (size, dirty) in self.resident.items():
            if dirty:
                self._drain_one(size, key)
        self.resident.clear()
        self.resident_bytes = 0.0

    def seconds(self, clock_ghz: float) -> float:
        if self.bandwidth_gbs:
            return self.access_bytes / (self.bandwidth_gbs * 1e9)
        # default: one access per cycle per instance
        return (self.reads + self.writes) / self.instances / (clock_ghz * 1e9)


# ---------------------------------------------------------------------- #
# functional units
# ---------------------------------------------------------------------- #
@dataclass
class FunctionalUnit:
    comp: Component
    instances: int
    # per-spatial-instance counts (load imbalance!)
    per_key: Counter = field(default_factory=Counter)
    total: float = 0.0

    def add(self, key: SpatialKey, n: float = 1.0) -> None:
        self.per_key[key] += n
        self.total += n

    def cycles(self) -> float:
        if not self.per_key:
            return 0.0
        if len(self.per_key) <= 1:
            # no spatial attribution: spread over instances
            return self.total / self.instances
        # each spatial slot is one hardware instance; the slowest wins.
        # if there are more slots than instances, slots time-multiplex.
        mx = max(self.per_key.values())
        waves = math.ceil(len(self.per_key) / self.instances)
        return max(mx * waves, self.total / self.instances)


class Merger:
    """Hardware merger: rank-swizzles E elements arriving as L sorted
    runs.  A radix-R comparator tree needs ceil(log_R L) passes over the
    data; ``outputs`` elements emerge per cycle."""

    def __init__(self, comp: Component, instances: int):
        self.comp = comp
        self.instances = instances
        self.radix = int(comp.attrs.get("comparator_radix", 64))
        self.outputs = int(comp.attrs.get("outputs", 1))
        self.elements = 0.0
        self.events = 0
        self._cycles = 0.0

    def merge(self, elements: int, lists: int) -> None:
        self.events += 1
        self.elements += elements
        if lists <= 1:
            return
        passes = max(1, math.ceil(math.log(max(lists, 2), self.radix)))
        self._cycles += elements * passes / self.outputs

    def cycles(self) -> float:
        return self._cycles / self.instances


class Intersector:
    """Intersection unit (two_finger | leader_follower | skip_ahead)."""

    def __init__(self, comp: Component, instances: int):
        self.comp = comp
        self.instances = instances
        self.kind = comp.attrs.get("type", "two_finger")
        self.leader = comp.attrs.get("leader")
        self.steps: Counter = Counter()          # tensor -> pointer advances
        self.matches = 0
        self.per_key: Counter = Counter()

    def step(self, tensor: str, key: SpatialKey, n: int = 1) -> None:
        self.steps[tensor] += n
        self.per_key[key] += n

    def match(self, key: SpatialKey, n: int = 1) -> None:
        self.matches += n

    def cycles(self) -> float:
        total_steps = sum(self.steps.values())
        if self.kind == "two_finger":
            total = total_steps                  # one finger moves per cycle
        elif self.kind == "leader_follower":
            total = self.steps.get(self.leader, 0) or total_steps / 2
        else:                                    # skip_ahead (ExTensor)
            # matched coordinates cost a cycle; skipped runs are jumped in
            # ~one cycle each: approximate skips by the smaller side's
            # non-matching steps.
            smaller = min(self.steps.values()) if self.steps else 0
            total = self.matches + max(smaller - self.matches, 0)
        if len(self.per_key) > 1:
            frac = max(self.per_key.values()) / max(sum(self.per_key.values()),
                                                    1)
            waves = math.ceil(len(self.per_key) / self.instances)
            return max(total * frac * waves, total / self.instances)
        return total / self.instances


# ---------------------------------------------------------------------- #
# the per-Einsum performance model
# ---------------------------------------------------------------------- #
class EinsumModel:
    """Routes one Einsum's event stream into bound components."""

    def __init__(self, spec: AcceleratorSpec, plan: EinsumPlan,
                 binding: EinsumBinding, dram: DRAM,
                 shared: Dict[str, Any]):
        self.spec = spec
        self.plan = plan
        self.binding = binding
        self.dram = dram
        self.name = plan.output
        topo = binding.topology if binding.topology in spec.arch.topologies \
            else next(iter(spec.arch.topologies), None)
        self.topology = topo

        # ---- storage chains: (tensor, kind) -> [innermost..outermost]
        self.chains: Dict[Tuple[str, str], List[StorageLevel]] = {}
        self.eager_depth: Dict[int, int] = {}
        self.evict_map: Dict[str, List[StorageLevel]] = defaultdict(list)
        by_key: Dict[Tuple[str, str], List[StorageBinding]] = defaultdict(list)
        for sb in binding.storage:
            kinds = ("coord", "payload") if sb.type == "elem" else (sb.type,)
            for k in kinds:
                by_key[(sb.tensor, k)].append(sb)
        # (component, tensor, kind) -> StorageLevel, SHARED across the
        # whole cascade so on-chip intermediates persist between Einsums
        self._levels: Dict[Tuple[str, str, str], StorageLevel] = shared
        for key, sbs in by_key.items():
            chain: List[StorageLevel] = []
            # order: binding list order = innermost first
            backing: Any = self.dram
            for sb in reversed(sbs):
                comp, inst = self._find(sb.component)
                lvl_key = (sb.component, sb.tensor, key[1])
                lvl = self._levels.get(lvl_key)
                if lvl is None:
                    lvl = StorageLevel(comp, sb, inst, backing)
                    self._levels[lvl_key] = lvl
                if sb.evict_on:
                    if lvl not in self.evict_map[sb.evict_on]:
                        self.evict_map[sb.evict_on].append(lvl)
                chain.append(lvl)
                backing = lvl
            chain.reverse()
            self.chains[key] = chain

        # ---- functional units
        self.units: Dict[str, FunctionalUnit] = {}
        self.compute_map: Dict[str, FunctionalUnit] = {}
        for cb in binding.compute:
            comp, inst = self._find(cb.component)
            fu = self.units.setdefault(cb.component,
                                       FunctionalUnit(comp, inst))
            self.compute_map[cb.op] = fu

        self.isect: Optional[Intersector] = None
        self.merger: Optional[Merger] = None
        self.seq: Optional[FunctionalUnit] = None
        for comp, inst in self._all_components():
            if comp.klass == "Intersection" and self.isect is None:
                self.isect = Intersector(comp, inst)
            elif comp.klass == "Merger" and self.merger is None:
                self.merger = Merger(comp, inst)
            elif comp.klass == "Sequencer" and self.seq is None:
                self.seq = FunctionalUnit(comp, inst)

        # spatial context
        self.space_ranks = plan.space_ranks
        self._space_ctx: Dict[str, Any] = {}
        # exec-form tensors for subtree footprints (set by the generator)
        self.tensors: Dict[str, FTensor] = {}
        self._subtree_cache: Dict[Tuple[str, Tuple], float] = {}
        # fused intermediates (set by PerformanceModel)
        self.stream_tensors: Set[str] = set()
        # concrete-layout position caches for line-granular cache keys
        self._offset_cache: Dict[Tuple[str, int], Dict] = {}
        self._dyn_pos: Dict[Tuple, Dict] = {}

    # -------------------------------------------------------------- #
    def _find(self, comp_name: str) -> Tuple[Component, int]:
        if self.topology is None:
            return Component(comp_name, "Compute"), 1
        return self.spec.arch.find(self.topology, comp_name)

    def _all_components(self) -> List[Tuple[Component, int]]:
        if self.topology is None:
            return []
        return self.spec.arch.topologies[self.topology].all_components()

    def _fmt(self, tensor: str, config: str = "default") -> TensorFormat:
        cfgs = self.spec.format.tensors.get(tensor)
        if cfgs and config in cfgs:
            return cfgs[config]
        return self.spec.format.default(tensor)

    def spatial_key(self) -> SpatialKey:
        return tuple(self._space_ctx.get(r) for r in self.space_ranks)

    # -------------------------------------------------------------- #
    # event entry points (called by PerformanceModel)
    # -------------------------------------------------------------- #
    def on_iterate(self, rank: str, coord: Any, n: int = 1) -> None:
        if rank in self.space_ranks:
            self._space_ctx[rank] = coord
        if self.seq is not None:
            self.seq.add(self.spatial_key(), n)

    def on_touch(self, tensor: str, rank: str, path: Tuple, kind: str,
                 rw: str, n: int = 1,
                 unique: Optional[int] = None) -> None:
        fmt = self._fmt(tensor)
        nbytes = touch_bytes(fmt, rank, kind)
        chain = self.chains.get((tensor, kind))
        if not chain:
            # fused intermediates stream on-chip between the Einsums of
            # one fusion block (Gamma's T through the merger, Sec. 4.3)
            # and never touch DRAM; everything else unbound streams
            # to/from DRAM.
            if tensor in self.stream_tensors:
                return
            if nbytes:
                self.dram.access(nbytes * n, rw)
            return
        lvl = chain[0]
        sb = lvl.binding
        if n > 1 or not path:
            # aggregate touch: no per-element path.  With a
            # distinct-element hint (analytic backend) residency is
            # estimated statistically; without one (vector backend)
            # it degrades to (rank, kind)-granular keys -- counts are
            # exact, locality is approximate either way.
            if unique is not None:
                lvl.touch_stat((tensor, rank, kind), nbytes, rw, n, unique)
            else:
                lvl.touch((tensor, rank, kind), nbytes, rw,
                          fill_bytes=nbytes, n=n)
            return
        if sb.style == "eager":
            # residency granule: the subtree under the binding rank
            ft = self.tensors.get(tensor)
            depth = self._rank_depth(tensor, sb.rank)
            key = path[:depth + 1]
            fill = self._subtree_fill(tensor, key, depth, fmt)
            lvl.touch(key, nbytes, rw, fill_bytes=fill)
        elif lvl.kind == "cache":
            # line-granular residency: a compressed (C-format) tensor is
            # laid out POSITIONALLY -- one contiguous array per rank in
            # lexicographic fiber order (CSR-style), and partitioning /
            # flattening preserve that order (Sec. 3.2.1: the concrete
            # representation may remain unchanged).  Keying lines by the
            # element's GLOBAL position credits spatial locality across
            # fiber boundaries; keying by element or coordinate would
            # charge a full line per element and inflate traffic by
            # width/elem_bytes.
            epl = max(1, int(lvl.width // max(nbytes, 1.0)))
            pos, proj = self._line_position(tensor, path)
            key = (rank, kind) + proj + (pos // epl,)
            lvl.touch(key, nbytes, rw, fill_bytes=lvl.width)
        else:
            lvl.touch((rank,) + tuple(path), nbytes, rw,
                      fill_bytes=nbytes)

    def _project_prefix(self, tensor: str, path: Tuple) -> Tuple:
        """Path prefix with partition-upper coords dropped (the stored
        layout addresses content coordinates only)."""
        tp = self.plan.tensors.get(tensor)
        ranks = tp.exec_order if tp is not None else \
            (self.tensors[tensor].ranks if tensor in self.tensors else [])
        if len(ranks) < len(path):
            return tuple(path[:-1])
        out = []
        for r, c in zip(ranks[:len(path) - 1], path[:-1]):
            if self.plan.created_ranks.get(r) == "upper":
                continue
            out.append(c)
        return tuple(out)

    def _line_position(self, tensor: str, path: Tuple
                       ) -> Tuple[int, Tuple]:
        """(global positional index of path[-1] in its rank's concrete
        array, projected key prefix)."""
        import bisect
        if not path:
            return 0, ()
        ft = self.tensors.get(tensor)
        if ft is not None:
            d = len(path) - 1
            ck = (tensor, d)
            offs = self._offset_cache.get(ck)
            if offs is None:
                offs = {}
                total = 0

                def rec(fiber: Fiber, depth: int, prefix: Tuple) -> int:
                    nonlocal total
                    if depth == d:
                        offs[prefix] = (total, fiber)
                        total += len(fiber)
                        return 0
                    for c, p in fiber:
                        if isinstance(p, Fiber):
                            rec(p, depth + 1, prefix + (c,))
                    return 0

                rec(ft.root, 0, ())
                self._offset_cache[ck] = offs
            got = offs.get(tuple(path[:-1]))
            if got is not None:
                start, fiber = got
                return (start + bisect.bisect_left(fiber.coords,
                                                   path[-1]), ())
        # dynamic (output) tensors: first-touch order approximates the
        # concordant build order of the concrete array
        proj = self._project_prefix(tensor, path)
        dp = self._dyn_pos.setdefault((tensor, proj), {})
        pos = dp.get(path[-1])
        if pos is None:
            pos = len(dp)
            dp[path[-1]] = pos
        return pos, proj

    def _rank_depth(self, tensor: str, rank: str) -> int:
        tp = self.plan.tensors.get(tensor)
        if tp and rank in tp.exec_order:
            return tp.exec_order.index(rank)
        ft = self.tensors.get(tensor)
        if ft and rank in ft.ranks:
            return ft.ranks.index(rank)
        return 0

    def _subtree_fill(self, tensor: str, key: Tuple, depth: int,
                      fmt: TensorFormat) -> float:
        ck = (tensor, key)
        got = self._subtree_cache.get(ck)
        if got is not None:
            return got
        ft = self.tensors.get(tensor)
        size = 8.0
        if ft is not None:
            node: Any = ft.root
            ok = True
            for c in key:
                if not isinstance(node, Fiber):
                    ok = False
                    break
                node = node.lookup(c)
                if node is None:
                    ok = False
                    break
            if ok:
                size = subtree_bytes(ft, fmt, node, min(depth + 1,
                                                        len(ft.ranks) - 1)) \
                    if isinstance(node, Fiber) else \
                    touch_bytes(fmt, ft.ranks[-1], "payload")
        self._subtree_cache[ck] = size
        return size

    def on_advance(self, rank: str) -> None:
        for lvl in self.evict_map.get(rank, ()):
            lvl.evict_all()

    def on_compute(self, op: str, n: int = 1) -> None:
        fu = self.compute_map.get(op)
        if fu is None:
            fu = self.compute_map.get("mul") or self.compute_map.get("add")
        if fu is not None:
            fu.add(self.spatial_key(), n)

    def on_isect_step(self, rank: str, tensor: str, n: int = 1) -> None:
        if self.isect is not None:
            self.isect.step(tensor, self.spatial_key(), n)

    def on_isect_match(self, rank: str, n: int = 1) -> None:
        if self.isect is not None:
            self.isect.match(self.spatial_key(), n)

    def on_merge(self, tensor: str, elements: int, lists: int) -> None:
        if self.merger is not None:
            self.merger.merge(elements, lists)

    def finish(self) -> None:
        """Einsum end: buffet epochs close (caches persist on-chip)."""
        for lvls in self.evict_map.values():
            for lvl in lvls:
                lvl.evict_all()

    # -------------------------------------------------------------- #
    def component_seconds(self, clock_ghz: float) -> Dict[str, float]:
        """Per-component busy time for this Einsum (excl. DRAM)."""
        out: Dict[str, float] = {}
        hz = clock_ghz * 1e9
        seen = set()
        for chain in self.chains.values():
            for lvl in chain:
                if id(lvl) in seen:
                    continue
                seen.add(id(lvl))
                cname = lvl.comp.name
                out[cname] = out.get(cname, 0.0) + lvl.seconds(clock_ghz)
        for name, fu in self.units.items():
            out[name] = out.get(name, 0.0) + fu.cycles() / hz
        if self.isect is not None:
            out[self.isect.comp.name] = self.isect.cycles() / hz
        if self.merger is not None:
            out[self.merger.comp.name] = self.merger.cycles() / hz
        if self.seq is not None:
            out[self.seq.comp.name] = self.seq.cycles() / hz
        return out

    def action_counts(self) -> Dict[str, float]:
        """Flat action counts for the energy model."""
        acts: Dict[str, float] = Counter()
        seen = set()
        for chain in self.chains.values():
            for lvl in chain:
                if id(lvl) in seen:
                    continue
                seen.add(id(lvl))
                acts["sram_read"] += lvl.reads
                acts["sram_write"] += lvl.writes
                acts["sram_fill_bytes"] += lvl.fill_bytes
                acts["sram_drain_bytes"] += lvl.drain_bytes
        for op, fu in self.compute_map.items():
            acts[op] += fu.per_key.total() if hasattr(fu.per_key, "total") \
                else sum(fu.per_key.values())
        if self.isect is not None:
            acts["isect_step"] += sum(self.isect.steps.values())
        if self.merger is not None:
            acts["merge_elem"] += self.merger.elements
        return dict(acts)


class PerformanceModel(Instrumentation):
    """Top-level sink: demuxes events to per-Einsum models, owns DRAM."""

    def __init__(self, spec: AcceleratorSpec,
                 plans: Dict[str, EinsumPlan],
                 dram_bandwidth_gbs: float = 68.256):
        self.spec = spec
        # one DRAM per design
        dname, bw = "DRAM", dram_bandwidth_gbs
        for topo in spec.arch.topologies.values():
            for comp, _ in topo.all_components():
                if comp.klass == "DRAM":
                    dname = comp.name
                    bw = float(comp.attrs.get("bandwidth", bw))
        self.dram = DRAM(dname, bw)
        shared: Dict[Tuple[str, str, str], StorageLevel] = {}
        self.shared_levels = shared
        self.models: Dict[str, EinsumModel] = {
            name: EinsumModel(spec, plan, spec.binding.get(name), self.dram,
                              shared)
            for name, plan in plans.items()
        }
        # intermediates produced AND consumed inside one fusion block
        # stream on-chip (Sec. 4.3): no DRAM traffic for them
        from .cascade import CascadeDAG, fusion_blocks
        dag = CascadeDAG.from_spec(spec)
        fused: Set[str] = set()
        for block in fusion_blocks(spec, plans):
            names = set(block)
            if len(names) < 2:
                continue
            for name in block:
                e = spec.einsum.einsum_for(name)
                for t in e.input_names:
                    if t in names and dag.is_intermediate(t):
                        fused.add(t)
        for m in self.models.values():
            m.stream_tensors = fused
        self._cur: Optional[EinsumModel] = None
        # DRAM bytes attributed per einsum (for fusion-block accounting)
        self.dram_bytes_per_einsum: Counter = Counter()
        self._dram_mark = 0.0

    # ------------------------------------------------------------------ #
    def begin_einsum(self, einsum: str) -> None:
        self._cur = self.models.get(einsum)
        self._dram_mark = self.dram.total_bytes

    def end_einsum(self, einsum: str) -> None:
        if self._cur is not None:
            self._cur.finish()
        self.dram_bytes_per_einsum[einsum] += \
            self.dram.total_bytes - self._dram_mark
        self._cur = None

    def touch(self, einsum, tensor, rank, path, kind, rw, n=1, unique=None):
        if self._cur is not None:
            self._cur.on_touch(tensor, rank, path, kind, rw, n, unique)

    def advance(self, einsum, rank, n=1):
        # n > 1 (aggregate) epochs with no interleaved touches collapse
        # to one effective eviction; evict_all is idempotent
        if self._cur is not None:
            self._cur.on_advance(rank)

    def iterate(self, einsum, rank, n=1, coord=None):
        if self._cur is not None:
            self._cur.on_iterate(rank, coord, n)

    def compute(self, einsum, op, n=1):
        if self._cur is not None:
            self._cur.on_compute(op, n)

    def isect_step(self, einsum, rank, tensor, n=1):
        if self._cur is not None:
            self._cur.on_isect_step(rank, tensor, n)

    def isect_match(self, einsum, rank, n=1):
        if self._cur is not None:
            self._cur.on_isect_match(rank, n)

    def merge(self, einsum, tensor, elements, lists):
        m = self.models.get(einsum)
        if m is not None:
            m.on_merge(tensor, elements, lists)

    # ------------------------------------------------------------------ #
    def register_exec_tensors(self, einsum: str,
                              tensors: Dict[str, FTensor]) -> None:
        m = self.models.get(einsum)
        if m is not None:
            m.tensors.update(tensors)

    def finalize(self) -> None:
        """End of cascade: write back all dirty on-chip state."""
        if getattr(self, "_finalized", False):
            return
        self._finalized = True
        mark = self.dram.total_bytes
        for lvl in self.shared_levels.values():
            lvl.evict_all()
        # attribute final drains to the last einsum
        if self.models:
            last = list(self.models)[-1]
            self.dram_bytes_per_einsum[last] += self.dram.total_bytes - mark
