"""Fig. 11: ExTensor energy model across the five matrices.

Validates: energy is dominated by DRAM + SRAM traffic (the paper's
breakdown), and total energy is monotone in memory traffic (the
mechanism behind TeAAL's 7.8%-error energy validation).

Runs on the interpreter (``CascadeSimulator`` with no backend), as the
reference's study does, and so on the host only: it needs no device.
The storage components' residency model (LRU / buffet keyed by element
paths) is path-exact only there; the vector backend feeds it aggregate
keys, so its modeled locality is approximate (DESIGN.md:55-59: "Use the
Python backend when you need path-exact cache fidelity").
"""
from __future__ import annotations

import time
from typing import List, Tuple

import numpy as np

from repro_torch.bench.workloads import PAPER_MATRICES, synth_matrix
from repro_torch.accelerators import extensor
from repro_torch.core.generator import CascadeSimulator


def run() -> List[Tuple[str, float, float]]:
    rows = []
    traffics, energies = [], []
    for mat in PAPER_MATRICES:
        a = synth_matrix(mat)
        k, n = a.shape[1], a.shape[1]
        rng = np.random.default_rng(1)
        b = (rng.random((k, n)) < 0.02) * rng.random((k, n))
        t0 = time.time()
        sim = CascadeSimulator(extensor.spec(),
                               params=extensor.DEFAULT_PARAMS)
        rep = sim.run({"A": a, "B": b},
                      {"m": a.shape[0], "k": k, "n": n}).report
        us = (time.time() - t0) * 1e6
        rows.append((f"fig11/energy_uJ/{mat}", us,
                     round(rep.energy_pj / 1e6, 4)))
        mem_share = (rep.energy_breakdown_pj.get("dram", 0)
                     + rep.energy_breakdown_pj.get("sram", 0)) \
            / rep.energy_pj
        rows.append((f"fig11/mem_share/{mat}", 0.0, round(mem_share, 3)))
        traffics.append(rep.dram_bytes)
        energies.append(rep.energy_pj)

    corr = float(np.corrcoef(traffics, energies)[0, 1])
    rows.append(("fig11/claim/energy_tracks_traffic_corr", 0.0,
                 round(corr, 3)))
    return rows
