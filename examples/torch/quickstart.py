"""Quickstart: specify a sparse accelerator in TeAAL, simulate it on a
real sparse matrix, and read the performance report -- on the PyTorch
port, whose vector backend runs its seams on the card's kernels.

    PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]

Runs on the CUDA device unless ``--device`` names another.
"""
import argparse

import numpy as np

from repro_torch.core.generator import CascadeSimulator, check_against_dense
from repro_torch.core.spec import load_spec
from repro_torch.core.vectorized import VectorBackend
from repro_torch.kernels.backends import resolve_device

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device (default: the CUDA device)")
args = ap.parse_args()
backend = VectorBackend(device=resolve_device(args.device))

# ---------------------------------------------------------------------- #
# 1. declare the computation (a cascade of Einsums) and its mapping
#    -- this is the paper's Figure-3 language, inline
# ---------------------------------------------------------------------- #
SPEC = load_spec({
    "name": "quickstart-spmspm",
    "einsum": {
        "declaration": {
            "A": ["K", "M"],          # stationary operand, [k, m] indexed
            "B": ["K", "N"],
            "Z": ["M", "N"],
        },
        "expressions": ["Z[m, n] = A[k, m] * B[k, n]"],
    },
    "mapping": {
        "rank-order": {"A": ["M", "K"], "B": ["K", "N"], "Z": ["M", "N"]},
        "partitioning": {"Z": {"M": ["uniform_occupancy(A.8)"]}},
        "loop-order": {"Z": ["M1", "M0", "K", "N"]},
        "spacetime": {"Z": {"space": ["M1"], "time": ["M0", "K", "N"]}},
    },
    "format": {
        "A": {"default": {"M": {"format": "C", "cbits": 32, "pbits": 32},
                          "K": {"format": "C", "cbits": 32, "pbits": 64}}},
        "B": {"default": {"K": {"format": "C", "cbits": 32, "pbits": 32},
                          "N": {"format": "C", "cbits": 32, "pbits": 64}}},
    },
    "architecture": {
        "clock_ghz": 1.0,
        "topologies": {"main": {
            "name": "chip", "num": 1,
            "local": [
                {"name": "DRAM", "class": "DRAM", "bandwidth": 68.0},
                {"name": "Buf", "class": "Buffer", "type": "cache",
                 "width": 64, "depth": 4096},
            ],
            "subtree": [{
                "name": "PE", "num": 8,
                "local": [
                    {"name": "ALU", "class": "Compute", "type": "mul"},
                ],
            }],
        }},
    },
    "binding": {
        "Z": {"topology": "main",
              "storage": [{"component": "Buf", "tensor": "B", "rank": "N",
                           "type": "elem", "style": "lazy"}],
              "compute": [{"component": "ALU", "op": "mul"}]},
    },
})

# ---------------------------------------------------------------------- #
# 2. run it on real data
# ---------------------------------------------------------------------- #
rng = np.random.default_rng(0)
K = M = N = 64
A = rng.random((K, M)) * (rng.random((K, M)) < 0.15)   # [k, m] indexed
B = rng.random((K, N)) * (rng.random((K, N)) < 0.15)

sim = CascadeSimulator(SPEC, backend=backend)
result = sim.run({"A": A, "B": B}, {"m": M, "k": K, "n": N})

print(result.report.summary())
print("\naction counts:", {k: int(v) for k, v in
                           result.report.action_counts.items()})

# ---------------------------------------------------------------------- #
# 3. the functional result is always cross-checked against a dense oracle
# ---------------------------------------------------------------------- #
ok = check_against_dense(SPEC, {"A": A, "B": B},
                         {"m": M, "k": K, "n": N}, backend=backend)
print("\nmatches dense einsum oracle:", ok)
assert ok
