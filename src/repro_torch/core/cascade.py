"""Einsum-cascade DAG and fusion-block inference (TeAAL Sec. 3.1 / 4.3).

A cascade is a DAG of Einsums connected through intermediate tensors.
Fusion blocks group Einsums that execute as one pipelined phase; TeAAL
infers fusion when (Sec. 4.3):

  1. the Einsums use the same accelerator topology,
  2. the temporal ranks in all loop orders *before the first spatial
     rank* are the same, and
  3. disjoint subsets of the non-storage components are each exclusively
     used by only one Einsum.

Blocks are formed greedily from the first Einsum.  The block structure
feeds the bottleneck analysis in ``metrics``: block time = max over
components; cascade time = sum over blocks.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .mapping import EinsumPlan
from .spec import AcceleratorSpec


@dataclass
class CascadeDAG:
    """Producer/consumer structure of the cascade."""
    order: List[str]                          # einsum outputs, program order
    produces: Dict[str, str]                  # tensor -> producing einsum
    consumers: Dict[str, List[str]]           # tensor -> consuming einsums
    intermediates: Set[str]                   # tensors produced & consumed

    @staticmethod
    def from_spec(spec: AcceleratorSpec) -> "CascadeDAG":
        order = [e.output.tensor for e in spec.einsum.expressions]
        produces = {t: t for t in order}
        consumers: Dict[str, List[str]] = {}
        for e in spec.einsum.expressions:
            for t in e.input_names:
                consumers.setdefault(t, []).append(e.output.tensor)
        inter = {t for t in order if t in consumers}
        return CascadeDAG(order, produces, consumers, inter)

    def is_intermediate(self, tensor: str) -> bool:
        return tensor in self.intermediates


def mapping_signature(spec: AcceleratorSpec,
                      params: Optional[Dict[str, int]] = None) -> str:
    """Canonical signature of everything that determines the lowered
    plans and exec-form tensor structure: the einsum cascade, rank
    orders, and per-Einsum mapping directives (with partition sizes),
    plus any symbolic-size params.

    Format / architecture / binding sections are deliberately excluded:
    sweeping them (FiberCache capacity, merger radix as a pure arch
    attribute, DRAM bandwidth, ...) must share plan memoization and
    density-calibration cache entries in the DSE engine.
    """
    parts: List[str] = []
    parts.append("decl:" + repr(sorted(
        (t, tuple(r)) for t, r in spec.einsum.declaration.items())))
    parts.append("expr:" + repr([str(e) for e in spec.einsum.expressions]))
    parts.append("sr:" + spec.einsum.semiring.name)
    parts.append("order:" + repr(sorted(
        (t, tuple(r)) for t, r in spec.mapping.rank_order.items())))
    for name in sorted(spec.mapping.per_einsum):
        em = spec.mapping.per_einsum[name]
        st = em.spacetime
        parts.append(f"{name}:loop={em.loop_order!r}"
                     f":space={st.space if st else None!r}"
                     f":time={st.time if st else None!r}"
                     f":part={sorted((repr(k), [str(d) for d in v]) for k, v in em.partitioning.items())!r}")
    parts.append("params:" + repr(sorted((params or {}).items())))
    return "|".join(parts)


def _temporal_prefix(plan: EinsumPlan) -> Tuple[str, ...]:
    """Loop ranks before the first spatial rank."""
    prefix: List[str] = []
    space = set(plan.space_ranks)
    for ri in plan.loop_order:
        if ri.name in space:
            break
        prefix.append(ri.name)
    return tuple(prefix)


def _nonstorage_components(spec: AcceleratorSpec, name: str) -> Set[str]:
    """Components (other than buffers/DRAM) bound to einsum ``name``."""
    b = spec.binding.get(name)
    used: Set[str] = {cb.component for cb in b.compute}
    return used


def fusion_blocks(spec: AcceleratorSpec,
                  plans: Dict[str, EinsumPlan]) -> List[List[str]]:
    """Greedy block formation per the three criteria."""
    order = [e.output.tensor for e in spec.einsum.expressions]
    blocks: List[List[str]] = []
    cur: List[str] = []

    def fusable(a: str, b: str) -> bool:
        ba, bb = spec.binding.get(a), spec.binding.get(b)
        if ba.topology != bb.topology:
            return False                                   # criterion 1
        if _temporal_prefix(plans[a]) != _temporal_prefix(plans[b]):
            return False                                   # criterion 2
        if _nonstorage_components(spec, a) & _nonstorage_components(spec, b):
            return False                                   # criterion 3
        return True

    for name in order:
        if not cur:
            cur = [name]
            continue
        if all(fusable(prev, name) for prev in cur):
            cur.append(name)
        else:
            blocks.append(cur)
            cur = [name]
    if cur:
        blocks.append(cur)
    return blocks
