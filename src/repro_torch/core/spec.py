"""TeAAL declarative specification (Sections 3-4).

Five sub-specifications:
  * einsum      -- declaration (tensor ranks) + expressions (the cascade)
  * mapping     -- rank-order, partitioning, loop-order, spacetime
  * format      -- per-tensor, per-config concrete fiber formats (Sec. 4.1.1)
  * architecture-- topology tree of hardware components (Sec. 4.1.2)
  * binding     -- data/compute placement onto components (Sec. 4.1.3)

Specs are plain dataclasses, loadable from YAML-shaped dicts that mirror
the paper's Figures 3, 5 and 8 syntax.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from .einsum import Einsum, Semiring, parse_einsum


class SpecError(ValueError):
    """A malformed or inconsistent accelerator spec.

    Carries the offending ``accelerator`` name, spec ``section``
    (einsum / mapping / format / architecture / binding), ``field``
    (the rank, tensor, component, or einsum the error anchors to) and,
    for parse failures, the raw ``directive`` text -- so a zoo-wide
    sweep reports *which* spec broke, not just that one did."""

    def __init__(self, message: str, *,
                 accelerator: Optional[str] = None,
                 section: Optional[str] = None,
                 field: Optional[str] = None,
                 directive: Optional[str] = None):
        self.accelerator = accelerator
        self.section = section
        self.field = field
        self.directive = directive
        ctx = [p for p in (accelerator, section, field) if p]
        super().__init__(
            f"[{'/'.join(ctx)}] {message}" if ctx else message)

    def with_accelerator(self, name: str) -> "SpecError":
        return SpecError(self.args[0].split("] ", 1)[-1],
                         accelerator=name, section=self.section,
                         field=self.field, directive=self.directive)


# ---------------------------------------------------------------------- #
# partitioning directives
# ---------------------------------------------------------------------- #


@dataclass(frozen=True)
class UniformShape:
    size: Union[int, str]          # int or symbolic (e.g. 'K0' in ExTensor)

    def __str__(self) -> str:
        return f"uniform_shape({self.size})"


@dataclass(frozen=True)
class UniformOccupancy:
    leader: str                    # leader tensor name
    size: int

    def __str__(self) -> str:
        return f"uniform_occupancy({self.leader}.{self.size})"


@dataclass(frozen=True)
class Flatten:
    def __str__(self) -> str:
        return "flatten()"


Directive = Union[UniformShape, UniformOccupancy, Flatten]

_DIR_RE = re.compile(
    r"(?:uniform_shape\((?P<shape>[A-Za-z_0-9]+)\)"
    r"|uniform_occupancy\((?P<lead>[A-Za-z_0-9]+)\.(?P<occ>\d+)\)"
    r"|(?P<flat>flatten\(\)))")


def parse_directive(text: str, *, field: Optional[str] = None,
                    accelerator: Optional[str] = None) -> Directive:
    m = _DIR_RE.fullmatch(text.strip())
    if not m:
        raise SpecError(f"bad partitioning directive: {text!r}",
                        accelerator=accelerator, section="mapping",
                        field=field, directive=text)
    if m.group("flat"):
        return Flatten()
    if m.group("shape") is not None:
        s = m.group("shape")
        return UniformShape(int(s) if s.isdigit() else s)
    return UniformOccupancy(m.group("lead"), int(m.group("occ")))


# ---------------------------------------------------------------------- #
# mapping spec
# ---------------------------------------------------------------------- #
@dataclass
class SpaceTime:
    space: List[str] = field(default_factory=list)
    time: List[str] = field(default_factory=list)


@dataclass
class EinsumMapping:
    """Mapping attributes of a single Einsum in the cascade."""
    loop_order: Optional[List[str]] = None
    spacetime: Optional[SpaceTime] = None
    # rank -> directive list, applied top-down.  Keys may be tuples of
    # ranks, e.g. ('K', 'M') for flatten, or partitioned names ('KM').
    partitioning: Dict[Union[str, Tuple[str, ...]], List[Directive]] = \
        field(default_factory=dict)


@dataclass
class MappingSpec:
    rank_order: Dict[str, List[str]] = field(default_factory=dict)
    per_einsum: Dict[str, EinsumMapping] = field(default_factory=dict)

    def einsum_mapping(self, out_name: str) -> EinsumMapping:
        return self.per_einsum.get(out_name, EinsumMapping())


# ---------------------------------------------------------------------- #
# einsum spec
# ---------------------------------------------------------------------- #
@dataclass
class EinsumSpec:
    declaration: Dict[str, List[str]]
    expressions: List[Einsum]
    semiring: Semiring = field(default_factory=Semiring.arithmetic)

    @property
    def cascade_outputs(self) -> List[str]:
        return [e.output.tensor for e in self.expressions]

    def einsum_for(self, out_name: str) -> Einsum:
        for e in self.expressions:
            if e.output.tensor == out_name:
                return e
        raise SpecError(
            f"no Einsum produces {out_name!r} "
            f"(cascade outputs: {self.cascade_outputs})",
            section="einsum", field=out_name)


# ---------------------------------------------------------------------- #
# format spec (Sec. 4.1.1)
# ---------------------------------------------------------------------- #
@dataclass
class RankFormat:
    """U (uncompressed), C (compressed), or B (coords U / payloads C)."""
    format: str = "C"                # 'U' | 'C' | 'B'
    layout: str = "separate"         # 'separate' (SoA) | 'interleaved' (AoS)
    cbits: int = 32
    pbits: int = 32
    fhbits: int = 0                  # fiber-header bits (e.g. list pointers)

    def coord_bytes(self) -> float:
        return self.cbits / 8.0

    def payload_bytes(self) -> float:
        return self.pbits / 8.0


@dataclass
class TensorFormat:
    """One named concrete configuration of a tensor (e.g. 'LinkedLists')."""
    config: str
    ranks: Dict[str, RankFormat]

    def fiber_bytes(self, rank: str, occupancy: int, shape: int) -> float:
        """Footprint of one fiber at ``rank``."""
        f = self.ranks[rank]
        n_coords = 0 if f.format == "U" else occupancy
        n_pay = shape if f.format in ("U", "B") else occupancy
        if f.format == "B":
            n_coords = 0
        return (n_coords * f.cbits + n_pay * f.pbits + f.fhbits) / 8.0


@dataclass
class FormatSpec:
    # tensor -> config name -> TensorFormat
    tensors: Dict[str, Dict[str, TensorFormat]] = field(default_factory=dict)

    def get(self, tensor: str, config: str) -> TensorFormat:
        return self.tensors[tensor][config]

    def default(self, tensor: str) -> TensorFormat:
        cfgs = self.tensors.get(tensor)
        if not cfgs:
            return TensorFormat("default", {})
        return next(iter(cfgs.values()))


# ---------------------------------------------------------------------- #
# architecture spec (Sec. 4.1.2, Table 3)
# ---------------------------------------------------------------------- #
@dataclass
class Component:
    name: str
    klass: str                      # DRAM | Buffer | Intersection | Merger
    #                               | Sequencer | Compute
    attrs: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ArchLevel:
    name: str
    num: int = 1                    # instances of this level (spatial fanout)
    local: List[Component] = field(default_factory=list)
    subtree: List["ArchLevel"] = field(default_factory=list)

    def find(self, comp_name: str, multiplier: int = 1
             ) -> Optional[Tuple[Component, int]]:
        """Return (component, total instance count across the fanout)."""
        m = multiplier * self.num
        for c in self.local:
            if c.name == comp_name:
                return c, m
        for sub in self.subtree:
            r = sub.find(comp_name, m)
            if r:
                return r
        return None

    def all_components(self, multiplier: int = 1
                       ) -> List[Tuple[Component, int]]:
        m = multiplier * self.num
        out = [(c, m) for c in self.local]
        for sub in self.subtree:
            out.extend(sub.all_components(m))
        return out


@dataclass
class ArchSpec:
    # topology name -> root level; designs can reconfigure per Einsum
    topologies: Dict[str, ArchLevel] = field(default_factory=dict)
    clock_ghz: float = 1.0

    def find(self, topology: str, comp: str) -> Tuple[Component, int]:
        root = self.topologies.get(topology)
        if root is None:
            raise SpecError(
                f"unknown topology {topology!r} "
                f"(have: {sorted(self.topologies)})",
                section="architecture", field=topology)
        r = root.find(comp)
        if not r:
            raise SpecError(
                f"component {comp!r} not in topology {topology!r}",
                section="architecture", field=comp)
        return r


# ---------------------------------------------------------------------- #
# binding spec (Sec. 4.1.3)
# ---------------------------------------------------------------------- #
@dataclass
class StorageBinding:
    component: str
    tensor: str
    rank: str
    type: str = "elem"              # 'coord' | 'payload' | 'elem'
    config: str = "default"
    style: str = "lazy"             # 'lazy' | 'eager' (whole subtree)
    evict_on: Optional[str] = None  # required for buffets


@dataclass
class ComputeBinding:
    component: str
    op: str                          # 'mul' | 'add'


@dataclass
class EinsumBinding:
    topology: str = "main"
    storage: List[StorageBinding] = field(default_factory=list)
    compute: List[ComputeBinding] = field(default_factory=list)


@dataclass
class BindingSpec:
    per_einsum: Dict[str, EinsumBinding] = field(default_factory=dict)

    def get(self, out_name: str) -> EinsumBinding:
        return self.per_einsum.get(out_name, EinsumBinding())


# ---------------------------------------------------------------------- #
# the full accelerator spec
# ---------------------------------------------------------------------- #
@dataclass
class AcceleratorSpec:
    name: str
    einsum: EinsumSpec
    mapping: MappingSpec
    format: FormatSpec = field(default_factory=FormatSpec)
    arch: ArchSpec = field(default_factory=ArchSpec)
    binding: BindingSpec = field(default_factory=BindingSpec)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "AcceleratorSpec":
        return load_spec(d)


# ---------------------------------------------------------------------- #
# YAML-shaped dict loader (mirrors the paper's Figure 3 syntax)
# ---------------------------------------------------------------------- #
def _parse_partitioning(d: Dict[str, Any]
                        ) -> Dict[Union[str, Tuple[str, ...]], List[Directive]]:
    out: Dict[Union[str, Tuple[str, ...]], List[Directive]] = {}
    for key, dirs in (d or {}).items():
        if isinstance(key, str) and key.startswith("("):
            ranks = tuple(r.strip() for r in key.strip("()").split(","))
            key2: Union[str, Tuple[str, ...]] = ranks
        elif isinstance(key, tuple):
            key2 = key
        else:
            key2 = key
        out[key2] = [parse_directive(t, field=str(key))
                     if isinstance(t, str) else t
                     for t in dirs]
    return out


def load_spec(d: Dict[str, Any], name: str = "design") -> AcceleratorSpec:
    """Build an AcceleratorSpec from a dict shaped like the paper's
    YAML.  Spec errors surface as :class:`SpecError` tagged with the
    accelerator's name."""
    try:
        return _load_spec(d, name)
    except SpecError as exc:
        if exc.accelerator is None:
            raise exc.with_accelerator(d.get("name", name)) from None
        raise


def _load_spec(d: Dict[str, Any], name: str) -> AcceleratorSpec:
    es = d["einsum"]
    einsum_spec = EinsumSpec(
        declaration={t: list(r) for t, r in es["declaration"].items()},
        expressions=[parse_einsum(x) for x in es["expressions"]],
        semiring=es.get("semiring", Semiring.arithmetic()),
    )

    mp = d.get("mapping", {})
    per_einsum: Dict[str, EinsumMapping] = {}
    names = set(einsum_spec.cascade_outputs)
    part = mp.get("partitioning", {}) or {}
    loops = mp.get("loop-order", {}) or {}
    st = mp.get("spacetime", {}) or {}
    for out_name in names:
        em = EinsumMapping()
        if out_name in loops:
            em.loop_order = list(loops[out_name])
        if out_name in st:
            em.spacetime = SpaceTime(space=list(st[out_name].get("space", [])),
                                     time=list(st[out_name].get("time", [])))
        p = part.get(out_name)
        if p is None and len(names) == 1:
            p = part if any(not isinstance(v, dict) for v in part.values()) \
                else None
        if p:
            em.partitioning = _parse_partitioning(p)
        per_einsum[out_name] = em
    # top-level partitioning applying to every einsum (single-einsum style)
    if part and not (set(part) & names):
        shared = _parse_partitioning(part)
        for em in per_einsum.values():
            if not em.partitioning:
                em.partitioning = dict(shared)

    mapping = MappingSpec(
        rank_order={t: list(r) for t, r in (mp.get("rank-order") or {}).items()},
        per_einsum=per_einsum,
    )

    fmt = FormatSpec()
    for tensor, cfgs in (d.get("format") or {}).items():
        fmt.tensors[tensor] = {}
        for cfg_name, ranks in cfgs.items():
            fmt.tensors[tensor][cfg_name] = TensorFormat(
                cfg_name,
                {r: RankFormat(**attrs) for r, attrs in ranks.items()})

    arch = ArchSpec()
    ad = d.get("architecture") or {}
    arch.clock_ghz = ad.get("clock_ghz", 1.0)

    def _level(ld: Dict[str, Any]) -> ArchLevel:
        return ArchLevel(
            name=ld["name"], num=ld.get("num", 1),
            local=[Component(c["name"], c["class"],
                             {k: v for k, v in c.items()
                              if k not in ("name", "class")})
                   for c in ld.get("local", [])],
            subtree=[_level(s) for s in ld.get("subtree", [])])

    for topo_name, root in (ad.get("topologies") or {}).items():
        arch.topologies[topo_name] = _level(root)

    binding = BindingSpec()
    for out_name, bd in (d.get("binding") or {}).items():
        eb = EinsumBinding(topology=bd.get("topology", "main"))
        for sb in bd.get("storage", []):
            eb.storage.append(StorageBinding(
                component=sb["component"], tensor=sb["tensor"],
                rank=sb["rank"], type=sb.get("type", "elem"),
                config=sb.get("config", "default"),
                style=sb.get("style", "lazy"),
                evict_on=sb.get("evict-on", sb.get("evict_on"))))
        for cb in bd.get("compute", []):
            eb.compute.append(ComputeBinding(component=cb["component"],
                                             op=cb["op"]))
        binding.per_einsum[out_name] = eb

    return AcceleratorSpec(name=d.get("name", name), einsum=einsum_spec,
                           mapping=mapping, format=fmt, arch=arch,
                           binding=binding)
