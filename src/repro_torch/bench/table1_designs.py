"""Table 1: the five SpMSpM accelerators on one workload -- the
'apples-to-apples comparison' the paper's formalism enables (Sec. 2.4:
'we present a formalism to resolve this imprecision').

Every design runs the same A^T B on the same matrices; the derived
column is modeled seconds.  The claim row checks that all five produce
the identical functional result (same cascade semantics, different
mappings/bindings).

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

from repro_torch.bench.workloads import uniform_pair
from repro_torch.accelerators import (extensor, gamma, matraptor,
                                      outerspace, sigma)
from repro_torch.core.generator import CascadeSimulator


def run() -> List[Tuple[str, float, float]]:
    rows = []
    a, b = uniform_pair(m=192, k=192, n=192, da=0.08, db=0.08, seed=3)
    shapes = {"m": 192, "k": 192, "n": 192}
    designs = [("OuterSPACE", outerspace.spec(), None),
               ("ExTensor", extensor.spec(), extensor.DEFAULT_PARAMS),
               ("Gamma", gamma.spec(), None),
               ("SIGMA", sigma.spec(), None),
               ("MatRaptor", matraptor.spec(), None)]
    outputs = []
    for name, spec, params in designs:
        t0 = time.time()
        sim = CascadeSimulator(spec, params=params)
        res = sim.run({"A": a, "B": b}, shapes)
        us = (time.time() - t0) * 1e6
        rows.append((f"table1/{name}/seconds", us, res.report.seconds))
        rows.append((f"table1/{name}/dram_MB", 0.0,
                     round(res.report.dram_bytes / 1e6, 3)))
        outputs.append(res.tensors["Z"].to_dense())
    agree = all(np.allclose(outputs[0], z) for z in outputs[1:])
    rows.append(("table1/claim/all_designs_agree_functionally", 0.0,
                 float(agree)))
    return rows
