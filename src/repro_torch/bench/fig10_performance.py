"""Fig. 10: performance validation + the Sparseloop-style analytical
ablation.

The paper's Fig. 10a shows Sparseloop (an analytical model using
probability distributions) erring by 187% on average while TeAAL's
data-driven traces stay within ~9%.  We reproduce the MECHANISM: for
each design, compare the modeled time on a SKEWED (power-law) matrix
against the 'analytical expectation' -- the same model run on a
degree-uniformized matrix with identical shape/nnz (exactly what a
hypergeometric sparsity model assumes).  The uniformized estimate
diverges on skewed data; on uniform data it agrees (control).

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

from repro_torch.bench.workloads import synth_matrix, uniform_pair
from repro_torch.accelerators import extensor, gamma, outerspace, sigma
from repro_torch.core.generator import CascadeSimulator


def _uniformize(a: np.ndarray, seed: int = 9) -> np.ndarray:
    """Same shape + nnz, uniform placement (the analytical assumption)."""
    rng = np.random.default_rng(seed)
    nnz = int(np.count_nonzero(a))
    out = np.zeros_like(a)
    idx = rng.choice(a.size, size=nnz, replace=False)
    out.flat[idx] = rng.random(nnz) + 0.1
    return out


def _model_time(mod, params, a, b) -> float:
    sim = CascadeSimulator(mod.spec(), params=params)
    shapes = {"m": a.shape[0], "k": a.shape[1], "n": b.shape[1]}
    return sim.run({"A": a, "B": b}, shapes).report.seconds


def run() -> List[Tuple[str, float, float]]:
    rows = []
    designs = [("ExTensor", extensor, extensor.DEFAULT_PARAMS),
               ("Gamma", gamma, None),
               ("OuterSPACE", outerspace, None),
               ("SIGMA", sigma, None)]

    # -- absolute modeled times on the uniform-random workload the
    #    paper uses for OuterSPACE/SIGMA validation
    a_u, b_u = uniform_pair(m=256, k=256, n=256, da=0.05, db=0.05)
    for name, mod, params in designs:
        t0 = time.time()
        secs = _model_time(mod, params, a_u, b_u)
        us = (time.time() - t0) * 1e6
        rows.append((f"fig10/time/{name}/uniform", us, secs))

    # -- analytical-vs-data-driven ablation on skewed data
    a_p = synth_matrix("wi")                    # power-law rows
    rng = np.random.default_rng(2)
    kdim, n = a_p.shape[1], 256
    b = (rng.random((kdim, n)) < 0.05) * rng.random((kdim, n))
    errs_skew, errs_unif = [], []
    for name, mod, params in designs[:3]:
        t_real = _model_time(mod, params, a_p, b)
        t_analytic = _model_time(mod, params, _uniformize(a_p), b)
        err = abs(t_analytic - t_real) / t_real * 100
        errs_skew.append(err)
        rows.append((f"fig10/analytical_err%/{name}/powerlaw", 0.0,
                     round(err, 1)))
        # control: uniform data, analytical assumption holds
        t_real_u = _model_time(mod, params, a_u, b_u)
        t_analytic_u = _model_time(mod, params, _uniformize(a_u), b_u)
        err_u = abs(t_analytic_u - t_real_u) / t_real_u * 100
        errs_unif.append(err_u)
        rows.append((f"fig10/analytical_err%/{name}/uniform", 0.0,
                     round(err_u, 1)))

    rows.append(("fig10/claim/analytical_worse_on_skew", 0.0,
                 float(np.mean(errs_skew) > np.mean(errs_unif))))
    return rows
