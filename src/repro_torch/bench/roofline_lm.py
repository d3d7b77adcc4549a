"""LM-fleet roofline rows for the benchmark CSV (the reference's
``benchmarks/roofline_lm.py``): read from the dry-run records
(``launch/dryrun.py``); the full table is ``python -m
repro_torch.launch.roofline``."""
from __future__ import annotations

from typing import List, Tuple

from repro_torch.launch.roofline import MESHES, full_table


def run() -> List[Tuple[str, float, float]]:
    rows = []
    for mesh in MESHES:
        cells = full_table(mesh)
        n_ok = sum(c.status == "ok" for c in cells)
        n_skip = sum(c.status == "skipped" for c in cells)
        n_err = sum(c.status == "error" for c in cells)
        rows.append((f"roofline/{mesh}/cells_ok", 0.0, float(n_ok)))
        rows.append((f"roofline/{mesh}/cells_skipped", 0.0,
                     float(n_skip)))
        rows.append((f"roofline/{mesh}/cells_error", 0.0, float(n_err)))
        for c in cells:
            if c.status != "ok":
                continue
            rows.append((
                f"roofline/{mesh}/{c.arch}/{c.shape}/"
                f"{c.dominant}-bound", c.step_seconds * 1e6,
                round(c.roofline_fraction, 4)))
    return rows
