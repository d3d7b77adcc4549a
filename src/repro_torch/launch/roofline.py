"""Roofline analysis over the dry-run records (the reference's
``launch/roofline.py``), against the peaks of the card a record names.

Reads experiments/dryrun_torch/*.json (``launch/dryrun.py``) and
derives, per (arch x shape x mesh), on the card's peaks
(``peaks_for``):

    compute term    = counted FLOPs / bf16 dense peak
    memory term     = counted bytes / memory bytes a second
    collective term = collective wire bytes / link bytes a second

using the probe-extrapolated totals.  The records hold per-device
numbers, so the terms divide by one device.  Also reports MODEL_FLOPS =
6*N*D (dense) or 6*N_active*D (MoE) and the usefulness ratio
MODEL_FLOPS / counted FLOPs.

The counted FLOPs are aten's products and the hand-written kernels' own
counts, not XLA's HLO FLOPs, and the counted bytes are the unfused eager
step's (``launch/cost_analysis.py``).  No TPU figure is used.

    python -m repro_torch.launch.roofline [--dir DIR]
"""
from __future__ import annotations

import argparse
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import repro_torch.configs as C
from repro_torch.configs.base import SHAPES, ModelConfig, active_param_count
from repro_torch.core.metrics import roofline

DRYRUN_DIR = Path(__file__).resolve().parents[3] / "experiments" \
    / "dryrun_torch"
#: the meshes the port's dry run walks
MESHES = ("h100_1x1",)


@dataclass(frozen=True)
class CardPeaks:
    """One card's dense peaks (NVIDIA's data sheet, no sparsity)."""
    bf16_flops: float          # tensor cores, bf16 / fp16
    tf32_flops: float          # tensor cores, TF32
    fp32_flops: float          # CUDA cores, fp32
    hbm_bytes_per_s: float     # device memory
    link_bytes_per_s: float    # NVLink, one direction
    memory_bytes: float        # device memory


#: keyed by ``torch.cuda.get_device_name()``
PEAKS: Dict[str, CardPeaks] = {
    # H100 SXM5 at its 700 W limit: NVLink 4, 900 GB/s both directions
    "NVIDIA H100 80GB HBM3": CardPeaks(989e12, 495e12, 67e12, 3.35e12,
                                       450e9, 80e9),
    # H100 PCIe at 350 W: HBM2e, NVLink bridge 600 GB/s both directions
    "NVIDIA H100 PCIe": CardPeaks(756e12, 378e12, 51e12, 2.0e12, 300e9,
                                  80e9),
}


def peaks_for(name: str) -> CardPeaks:
    """The peaks of the card ``torch.cuda.get_device_name()`` calls
    ``name`` (the leading "NVIDIA " may be left out).  A card the table
    lacks raises."""
    key = name if name.startswith("NVIDIA ") else f"NVIDIA {name}"
    if key not in PEAKS:
        raise KeyError(f"no peaks for card {name!r}; the table has "
                       f"{sorted(PEAKS)}")
    return PEAKS[key]


@dataclass
class CellRoofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    #: counted FLOPs over all chips (the reference's hlo_flops_global)
    counted_flops_global: float
    flops_ratio: float           # MODEL_FLOPS / counted FLOPs (global)
    status: str = "ok"
    note: str = ""

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_seconds(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """compute term / bottleneck term: 1.0 = compute-bound at peak."""
        t = self.step_seconds
        return self.compute_s / t if t > 0 else 0.0


def model_flops(cfg: ModelConfig, shape_name: str) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE); decode D = global_batch
    tokens; train/prefill D = batch x seq tokens.  Train includes
    fwd+bwd (the 6 covers it); prefill/decode are fwd-only (2*N*D)."""
    shape = SHAPES[shape_name]
    n = active_param_count(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch          # one token per request


def load_cell(arch: str, shape: str, mesh: str,
              directory: Path = DRYRUN_DIR) -> Optional[Dict]:
    p = Path(directory) / f"{arch}__{shape}__{mesh}.json"
    if not p.exists():
        return None
    return json.loads(p.read_text())


def _total(rec: Dict, key: str) -> float:
    """The probe-extrapolated total of ``key``, else the walked one."""
    return rec[key + "_corrected"] if key + "_corrected" in rec \
        else rec[key]


def cell_roofline(arch: str, shape: str, mesh: str,
                  peaks: Optional[CardPeaks] = None,
                  directory: Path = DRYRUN_DIR) -> Optional[CellRoofline]:
    """The cell's terms on ``peaks`` (by default the card its record
    names)."""
    rec = load_cell(arch, shape, mesh, directory)
    if rec is None:
        return None
    cfg = C.get(arch)
    if rec["status"] == "skipped":
        return CellRoofline(arch, shape, mesh, 0, 0, 0, 0, 0, 0, 0,
                            status="skipped",
                            note=rec.get("reason", ""))
    if rec["status"] != "ok":
        return CellRoofline(arch, shape, mesh, 0, 0, 0, 0, 0, 0, 0,
                            status="error", note=rec.get("error", ""))
    peaks = peaks or peaks_for(rec["card"])
    chips = rec["chips"]
    flops = _total(rec, "flops")                      # per device
    terms = roofline(flops, _total(rec, "hbm_bytes"),
                     _total(rec, "collective_wire_bytes"), 1,
                     peak_flops=peaks.bf16_flops,
                     hbm_gbs=peaks.hbm_bytes_per_s,
                     link_gbs=peaks.link_bytes_per_s)
    mf = model_flops(cfg, shape)
    counted_global = flops * chips
    return CellRoofline(
        arch=arch, shape=shape, mesh=mesh, chips=chips,
        compute_s=terms.compute_s, memory_s=terms.memory_s,
        collective_s=terms.collective_s,
        model_flops=mf,
        counted_flops_global=counted_global,
        flops_ratio=mf / counted_global if counted_global else 0.0,
    )


def full_table(mesh: str = "h100_1x1",
               directory: Path = DRYRUN_DIR) -> List[CellRoofline]:
    out = []
    for arch in C.ARCH_IDS:
        for shape in SHAPES:
            cell = cell_roofline(arch, shape, mesh, directory=directory)
            if cell is not None:
                out.append(cell)
    return out


def format_table(cells: List[CellRoofline]) -> str:
    hdr = (f"{'arch':<22} {'shape':<12} {'compute_s':>10} {'memory_s':>10} "
           f"{'collect_s':>10} {'bound':>10} {'MODEL/CNT':>10} "
           f"{'roofline%':>10}")
    lines = [hdr, "-" * len(hdr)]
    for c in cells:
        if c.status == "skipped":
            lines.append(f"{c.arch:<22} {c.shape:<12} "
                         f"{'skip: ' + c.note[:58]}")
            continue
        if c.status == "error":
            lines.append(f"{c.arch:<22} {c.shape:<12} ERROR {c.note[:50]}")
            continue
        lines.append(
            f"{c.arch:<22} {c.shape:<12} {c.compute_s:>10.3e} "
            f"{c.memory_s:>10.3e} {c.collective_s:>10.3e} "
            f"{c.dominant:>10} {c.flops_ratio:>10.3f} "
            f"{100 * c.roofline_fraction:>9.1f}%")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        description="The roofline table of the dry-run records (host "
                    "only; no card needed).")
    ap.add_argument("--dir", type=Path, default=DRYRUN_DIR,
                    help=f"the records' directory (default {DRYRUN_DIR})")
    args = ap.parse_args(argv)
    for mesh in MESHES:
        cells = full_table(mesh, args.dir)
        if not cells:
            print(f"no records for mesh {mesh} under {args.dir}")
            continue
        print(f"\n=== roofline ({mesh}) ===")
        print(format_table(cells))


if __name__ == "__main__":
    main()
