"""ExTensor [Hegde et al., MICRO'19] as a TeAAL spec (paper Fig. 8b).

Hybrid dataflow, inner-product at the innermost level, with uniform
shape-based partitioning at two levels (LLC tiles, PE tiles) and
hierarchical skip-ahead intersection (implicit in fibertree co-iteration
semantics; the skip-ahead unit's cost model is in components.py).

  Z[m,n] = A[k,m] * B[k,n]

Partition sizes are symbolic (K1/K0/M1/M0/N1/N0) per the figure and
resolved through ``params`` -- the original evaluation tunes them per
matrix; defaults here target the LLC (30 MB) / PE buffer (64 kB) sizes
of Table 5 for ~10K-row matrices.

Hardware (Table 5): 1 GHz, 128 PEs, 64 kB PE buffer, 30 MB LLC,
68.256 GB/s memory bandwidth.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from repro_torch.core.spec import AcceleratorSpec, load_spec

CLOCK_GHZ = 1.0
N_PES = 128
PE_BUF_KB = 64.0
LLC_MB = 30.0
DRAM_GBS = 68.256

#: default symbolic partition sizes (overridable per matrix)
DEFAULT_PARAMS = {"K1": 1024, "K0": 128, "M1": 1024, "M0": 128,
                  "N1": 1024, "N0": 128}


def spec(dram_gbs: float = DRAM_GBS, llc_mb: float = LLC_MB,
         pe_buf_kb: float = PE_BUF_KB) -> AcceleratorSpec:
    d: Dict[str, Any] = {
        "name": "ExTensor",
        "einsum": {
            "declaration": {
                "A": ["K", "M"],
                "B": ["K", "N"],
                "Z": ["M", "N"],
            },
            "expressions": ["Z[m, n] = A[k, m] * B[k, n]"],
        },
        "mapping": {
            "rank-order": {
                "A": ["K", "M"],
                "B": ["K", "N"],
                "Z": ["M", "N"],
            },
            "partitioning": {
                "Z": {
                    "K": ["uniform_shape(K1)", "uniform_shape(K0)"],
                    "M": ["uniform_shape(M1)", "uniform_shape(M0)"],
                    "N": ["uniform_shape(N1)", "uniform_shape(N0)"],
                },
            },
            "loop-order": {
                "Z": ["N2", "K2", "M2", "M1", "N1", "K1",
                      "M0", "N0", "K0"],
            },
            "spacetime": {
                "Z": {"space": ["K1"],
                      "time": ["N2", "K2", "M2", "M1", "N1",
                               "M0", "N0", "K0"]},
            },
        },
        "format": {
            "A": {"HCSR": {
                "K2": {"format": "C", "cbits": 32, "pbits": 32},
                "K1": {"format": "C", "cbits": 32, "pbits": 32},
                "K0": {"format": "C", "cbits": 32, "pbits": 32},
                "K": {"format": "C", "cbits": 32, "pbits": 32},
                "M2": {"format": "C", "cbits": 32, "pbits": 32},
                "M1": {"format": "C", "cbits": 32, "pbits": 32},
                "M0": {"format": "C", "cbits": 32, "pbits": 32},
                "M": {"format": "C", "cbits": 32, "pbits": 64}}},
            "B": {"HCSR": {
                "K2": {"format": "C", "cbits": 32, "pbits": 32},
                "K1": {"format": "C", "cbits": 32, "pbits": 32},
                "K0": {"format": "C", "cbits": 32, "pbits": 32},
                "K": {"format": "C", "cbits": 32, "pbits": 32},
                "N2": {"format": "C", "cbits": 32, "pbits": 32},
                "N1": {"format": "C", "cbits": 32, "pbits": 32},
                "N0": {"format": "C", "cbits": 32, "pbits": 32},
                "N": {"format": "C", "cbits": 32, "pbits": 64}}},
            "Z": {"CSR": {
                "M2": {"format": "C", "cbits": 32, "pbits": 32},
                "M1": {"format": "C", "cbits": 32, "pbits": 32},
                "M0": {"format": "C", "cbits": 32, "pbits": 32},
                "M": {"format": "C", "cbits": 32, "pbits": 32},
                "N2": {"format": "C", "cbits": 32, "pbits": 32},
                "N1": {"format": "C", "cbits": 32, "pbits": 32},
                "N0": {"format": "C", "cbits": 32, "pbits": 32},
                "N": {"format": "C", "cbits": 32, "pbits": 64}}},
        },
        "architecture": {
            "clock_ghz": CLOCK_GHZ,
            "topologies": {
                "main": {
                    "name": "chip", "num": 1,
                    "local": [
                        {"name": "DRAM", "class": "DRAM",
                         "bandwidth": dram_gbs},
                        {"name": "LLC", "class": "Buffer",
                         "type": "cache", "width": 64,
                         "depth": int(llc_mb * 1024 * 1024 / 64)},
                        {"name": "TopIsect", "class": "Intersection",
                         "type": "skip_ahead"},
                    ],
                    "subtree": [{
                        "name": "PE", "num": N_PES,
                        "local": [
                            {"name": "PEBuf", "class": "Buffer",
                             "type": "buffet", "width": 8,
                             "depth": int(pe_buf_kb * 1024 / 8)},
                            {"name": "PEIsect", "class": "Intersection",
                             "type": "skip_ahead"},
                            {"name": "MulALU", "class": "Compute",
                             "type": "mul"},
                            {"name": "AddALU", "class": "Compute",
                             "type": "add"},
                        ],
                    }],
                },
            },
        },
        "binding": {
            "Z": {
                "topology": "main",
                "storage": [
                    # LLC tiles (eager: whole K1/N1 tile subtree on touch)
                    {"component": "LLC", "tensor": "A", "rank": "M1",
                     "type": "elem", "config": "HCSR", "style": "eager"},
                    {"component": "LLC", "tensor": "B", "rank": "N1",
                     "type": "elem", "config": "HCSR", "style": "eager"},
                    {"component": "LLC", "tensor": "Z", "rank": "N1",
                     "type": "elem", "config": "CSR", "style": "lazy"},
                    # PE tiles
                    {"component": "PEBuf", "tensor": "A", "rank": "M0",
                     "type": "elem", "config": "HCSR", "style": "eager",
                     "evict-on": "N1"},
                    {"component": "PEBuf", "tensor": "B", "rank": "N0",
                     "type": "elem", "config": "HCSR", "style": "eager",
                     "evict-on": "M0"},
                ],
                "compute": [
                    {"component": "MulALU", "op": "mul"},
                    {"component": "AddALU", "op": "add"},
                ],
            },
        },
    }
    return load_spec(d)

def simulate(inputs, var_shapes, params=None, backend="vector",
             device=None, model=True, semiring=None, **spec_kw):
    """Run this design on real tensors; delegates to
    repro_torch.accelerators.simulate (``backend`` selects the execution
    engine: 'python' oracle | 'vector' columnar CSF; ``device`` selects
    the seam kernels: 'cuda' hand kernels, 'cpu' plain versions)."""
    from repro_torch.accelerators import simulate as _simulate

    return _simulate("extensor", inputs, var_shapes, params=params,
                     backend=backend, device=device, model=model,
                     semiring=semiring, **spec_kw)
