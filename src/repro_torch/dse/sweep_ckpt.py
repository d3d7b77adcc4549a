"""Sweep checkpointing: periodic, atomic, resumable partial results.

Bridges the sweep engine to ``repro_torch.checkpoint.store``: completed
``PointResult``s become one checkpoint step whose pytree leaves are the
numeric objective arrays (label-sorted for determinism) and whose
manifest ``meta`` carries everything non-numeric -- point labels,
structured error strings, timeout flags, attempt counts.  Saves ride
the store's atomic tmp+rename publish, so a sweep killed mid-write
(the fault harness's ``SimulatedCrash``, a real OOM, ctrl-C) never
leaves a half-visible checkpoint, and ``--resume`` restores exactly
the points that completed: the resumed sweep's Pareto front is
bit-identical to an uninterrupted run over the same points.
"""
from __future__ import annotations

from pathlib import Path
from typing import List, Sequence

import numpy as np

from .engine import _CKPT_FIELDS, PointResult
from .space import DesignPoint


class SweepCheckpointStore:
    """Directory-backed store of one sweep's completed results."""

    def __init__(self, directory: "str | Path", keep: int = 3):
        self.directory = Path(directory)
        self.keep = keep

    # ------------------------------------------------------------------ #
    def save(self, results: Sequence[PointResult], n_total: int) -> None:
        from repro_torch.checkpoint.store import CheckpointManager
        results = sorted(results, key=lambda r: r.label)
        tree = {f: np.array([getattr(r, f) for r in results],
                            dtype=np.float64)
                for f in _CKPT_FIELDS}
        meta = {
            "kind": "dse-sweep",
            "n_total": int(n_total),
            "labels": [r.label for r in results],
            "errors": [r.error or "" for r in results],
            "error_types": [r.error_type or "" for r in results],
            "timed_out": [bool(r.timed_out) for r in results],
            "attempts": [int(r.attempts) for r in results],
        }
        mgr = CheckpointManager(self.directory, keep=self.keep)
        # step = completed count: monotone as the sweep progresses, and
        # re-saving the same count just overwrites that step atomically
        mgr.save(len(results), tree, extra_meta=meta)

    # ------------------------------------------------------------------ #
    def load(self, points: Sequence[DesignPoint]) -> List[PointResult]:
        """Restore checkpointed results for the given points (matched
        by label; checkpointed labels not in ``points`` are ignored).
        Returns [] when no checkpoint exists."""
        if not (self.directory / "LATEST").exists():
            return []
        from repro_torch.checkpoint.store import load_checkpoint, load_manifest
        manifest = load_manifest(self.directory)
        meta = manifest.get("meta", {})
        if meta.get("kind") != "dse-sweep":
            raise ValueError(
                f"checkpoint at {self.directory} is not a sweep "
                f"checkpoint (kind={meta.get('kind')!r})")
        labels = meta["labels"]
        like = {f: np.zeros(len(labels)) for f in _CKPT_FIELDS}
        tree, _ = load_checkpoint(self.directory, like=like)
        by_label = {p.label: p for p in points}
        out: List[PointResult] = []
        for i, lbl in enumerate(labels):
            p = by_label.get(lbl)
            if p is None:
                continue
            out.append(PointResult(
                point=p,
                seconds=float(tree["seconds"][i]),
                energy_pj=float(tree["energy_pj"][i]),
                dram_bytes=float(tree["dram_bytes"][i]),
                wall_seconds=float(tree["wall_seconds"][i]),
                error=meta["errors"][i] or None,
                error_type=meta["error_types"][i] or None,
                timed_out=bool(meta["timed_out"][i]),
                attempts=int(meta["attempts"][i]),
                restored=True))
        return out
