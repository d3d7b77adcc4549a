"""Action counts -> execution time and energy (TeAAL Sec. 4.3).

Execution time uses the paper's bottleneck analysis: per fusion block,
sum each component's busy time across the block's Einsums, take the
maximum component (the bottleneck), and sum block times across the
cascade.  DRAM is a component (bytes / bandwidth).

Energy uses an Accelergy-style per-action table (45 nm-class constants,
same structure Accelergy would emit; Accelergy itself is not available
offline -- noted in DESIGN.md).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .cascade import fusion_blocks
from .components import PerformanceModel
from .mapping import EinsumPlan
from .spec import AcceleratorSpec

# ---------------------------------------------------------------------- #
# energy table (pJ) -- 45nm-class, Accelergy-style
# ---------------------------------------------------------------------- #
ENERGY_TABLE_PJ: Dict[str, float] = {
    "dram_per_byte": 32.0,        # HBM-class ~4 pJ/bit
    "sram_small_per_byte": 0.6,   # <= 64 KiB scratchpads
    "sram_large_per_byte": 1.2,   # MB-class caches / LLC
    "mul": 2.0,                   # 32-bit multiply
    "add": 0.5,                   # 32-bit add
    "isect_step": 0.3,            # comparator + pointer bump
    "merge_elem": 0.8,            # one element through one merger pass
    "seq_step": 0.1,              # sequencer coordinate enumeration
}

SMALL_BUFFER_BYTES = 64 * 1024


@dataclass
class ComponentTime:
    name: str
    seconds: float


@dataclass
class BlockReport:
    einsums: List[str]
    component_seconds: Dict[str, float]
    bottleneck: str
    seconds: float


@dataclass
class Report:
    """Summary statistics for one cascade execution on one design."""
    design: str
    blocks: List[BlockReport]
    seconds: float
    dram_read_bytes: float
    dram_write_bytes: float
    dram_bytes_per_einsum: Dict[str, float]
    energy_pj: float
    energy_breakdown_pj: Dict[str, float]
    action_counts: Dict[str, float]
    #: einsum -> reason, for Einsums the selected backend silently
    #: executed through the Python oracle instead of its fast path
    #: (filled by the generator; empty for PythonBackend runs)
    fallback_reasons: Dict[str, str] = field(default_factory=dict)
    #: einsum -> structured kernel-dispatch DowngradeEvents (guarded
    #: chain retries / downgrades / demotions recorded during that
    #: Einsum's execution; empty when all seams ran on their primary)
    downgrade_events: Dict[str, list] = field(default_factory=dict)
    #: {stage: host wall seconds} aggregated across the cascade from a
    #: profiling backend (VectorBackend pipeline stages: materialize /
    #: pair-merge / lookup / finalize / reduce / output-build); empty
    #: unless the backend profiled
    stage_seconds: Dict[str, float] = field(default_factory=dict)

    @property
    def dram_bytes(self) -> float:
        return self.dram_read_bytes + self.dram_write_bytes

    def summary(self) -> str:
        lines = [f"design={self.design} time={self.seconds:.6e}s "
                 f"dram={self.dram_bytes / 1e6:.3f}MB "
                 f"energy={self.energy_pj / 1e6:.3f}uJ"]
        for b in self.blocks:
            lines.append(f"  block {'+'.join(b.einsums)}: "
                         f"{b.seconds:.3e}s bottleneck={b.bottleneck}")
        return "\n".join(lines)


def evaluate(spec: AcceleratorSpec, plans: Dict[str, EinsumPlan],
             model: PerformanceModel) -> Report:
    """Produce the Report after the cascade has been executed through
    ``model`` (the PerformanceModel must already contain the counts)."""
    clock = spec.arch.clock_ghz
    model.finalize()
    blocks = fusion_blocks(spec, plans)

    block_reports: List[BlockReport] = []
    total = 0.0
    for block in blocks:
        comp_secs: Dict[str, float] = {}
        dram_bytes = 0.0
        for name in block:
            em = model.models[name]
            for cname, secs in em.component_seconds(clock).items():
                comp_secs[cname] = comp_secs.get(cname, 0.0) + secs
            dram_bytes += model.dram_bytes_per_einsum.get(name, 0.0)
        comp_secs[model.dram.name] = dram_bytes / (model.dram.bandwidth_gbs
                                                   * 1e9)
        bottleneck = max(comp_secs, key=comp_secs.get) if comp_secs else "-"
        secs = comp_secs.get(bottleneck, 0.0)
        block_reports.append(BlockReport(block, comp_secs, bottleneck, secs))
        total += secs

    # ---- energy
    acts: Dict[str, float] = {}
    for name, em in model.models.items():
        for k, v in em.action_counts().items():
            acts[k] = acts.get(k, 0.0) + v
    acts["dram_bytes"] = model.dram.total_bytes

    breakdown: Dict[str, float] = {}
    breakdown["dram"] = acts.get("dram_bytes", 0.0) \
        * ENERGY_TABLE_PJ["dram_per_byte"]
    # SRAM: approximate per-access bytes by fill/drain + access volume
    sram_bytes = 0.0
    for name, em in model.models.items():
        for (cname, tensor, kind), lvl in em._levels.items():
            per = ENERGY_TABLE_PJ["sram_small_per_byte"] \
                if lvl.width * lvl.depth <= SMALL_BUFFER_BYTES \
                else ENERGY_TABLE_PJ["sram_large_per_byte"]
            breakdown["sram"] = breakdown.get("sram", 0.0) + \
                (lvl.access_bytes + lvl.fill_bytes + lvl.drain_bytes) * per
    breakdown["mul"] = acts.get("mul", 0.0) * ENERGY_TABLE_PJ["mul"]
    breakdown["add"] = acts.get("add", 0.0) * ENERGY_TABLE_PJ["add"]
    breakdown["isect"] = acts.get("isect_step", 0.0) \
        * ENERGY_TABLE_PJ["isect_step"]
    breakdown["merge"] = acts.get("merge_elem", 0.0) \
        * ENERGY_TABLE_PJ["merge_elem"]
    energy = sum(breakdown.values())

    return Report(
        design=spec.name,
        blocks=block_reports,
        seconds=total,
        dram_read_bytes=model.dram.read_bytes,
        dram_write_bytes=model.dram.write_bytes,
        dram_bytes_per_einsum=dict(model.dram_bytes_per_einsum),
        energy_pj=energy,
        energy_breakdown_pj=breakdown,
        action_counts=acts,
    )


# ---------------------------------------------------------------------- #
# shared three-term bottleneck roofline (also used by launch/roofline)
# ---------------------------------------------------------------------- #
@dataclass
class RooflineTerms:
    """The same bottleneck-analysis structure applied to a device:
    compute / memory / collective, seconds each; max dominates."""
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def seconds(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)


def roofline(flops: float, bytes_hbm: float, bytes_collective: float,
             chips: int, *, peak_flops: float, hbm_gbs: float,
             link_gbs: float) -> RooflineTerms:
    """The three terms on ``chips`` devices of the given peaks (FLOP/s,
    memory and link bytes/s a device): no default device, so a caller
    names the card it means (``launch/roofline.peaks_for``)."""
    return RooflineTerms(
        compute_s=flops / (chips * peak_flops),
        memory_s=bytes_hbm / (chips * hbm_gbs),
        collective_s=bytes_collective / (chips * link_gbs),
    )
