"""Gamma [Zhang et al., ASPLOS'21] as a TeAAL spec (paper Fig. 8a).

Row-wise (Gustavson) SpMSpM with a tightly-pipelined multiply-merge:
  T[k,m,n] = take(A[k,m], B[k,n], 1)    -- fetch rows of B selected by A
  Z[m,n]   = T[k,m,n] * A[k,m]          -- scale + merge-reduce over K

Each PE processes rows of A (M0 spatial over 32 PEs); the per-PE
64-way hardware merger sorts the fetched B rows ([K,N] -> [N within K])
so reduction over K is concordant -- expressed as the rank swizzle of T
between the two (fused) Einsums.  B is *not* statically partitioned:
its rows are fetched by coordinate through the FiberCache (the
leader-follower occupancy split of K follows A, whose boundaries are
per-row and therefore dynamic -- see MappingResolver._partition_applies).

Hardware (Table 5): 1 GHz, 32 PEs, 64-way merger per PE, 3 MB
FiberCache, 16 64-bit HBM channels @ 8 GB/s.
"""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.core.spec import AcceleratorSpec, load_spec

CLOCK_GHZ = 1.0
N_PES = 32
MERGER_RADIX = 64
FIBERCACHE_MB = 3.0
DRAM_GBS = 16 * 8.0


def spec(rows_per_round: int = 32, merge_radix: int = MERGER_RADIX,
         fibercache_mb: float = FIBERCACHE_MB,
         dram_gbs: float = DRAM_GBS) -> AcceleratorSpec:
    d: Dict[str, Any] = {
        "name": "Gamma",
        "einsum": {
            "declaration": {
                "A": ["K", "M"],
                "B": ["K", "N"],
                "T": ["K", "M", "N"],
                "Z": ["M", "N"],
            },
            "expressions": [
                "T[k, m, n] = take(A[k, m], B[k, n], 1)",
                "Z[m, n] = T[k, m, n] * A[k, m]",
            ],
        },
        "mapping": {
            "rank-order": {
                "A": ["M", "K"],
                "B": ["K", "N"],
                "T": ["M", "K", "N"],
                "Z": ["M", "N"],
            },
            "partitioning": {
                "T": {
                    "M": [f"uniform_occupancy(A.{rows_per_round})"],
                    "K": [f"uniform_occupancy(A.{merge_radix})"],
                },
                "Z": {
                    "M": [f"uniform_occupancy(A.{rows_per_round})"],
                    "K": [f"uniform_occupancy(A.{merge_radix})"],
                },
            },
            "loop-order": {
                "T": ["M1", "M0", "K1", "K0", "N"],
                "Z": ["M1", "M0", "K1", "N", "K0"],
            },
            "spacetime": {
                "T": {"space": ["M0", "K1"], "time": ["M1", "K0", "N"]},
                "Z": {"space": ["M0", "K1"], "time": ["M1", "N", "K0"]},
            },
        },
        "format": {
            "A": {"CSR": {"M": {"format": "C", "cbits": 32, "pbits": 32},
                          "K": {"format": "C", "cbits": 32, "pbits": 64}}},
            "B": {"CSR": {"K": {"format": "C", "cbits": 32, "pbits": 32},
                          "N": {"format": "C", "cbits": 32, "pbits": 64}}},
            "T": {"Stream": {"M": {"format": "C", "cbits": 32, "pbits": 32},
                             "K": {"format": "C", "cbits": 32, "pbits": 32},
                             "N": {"format": "C", "cbits": 32,
                                   "pbits": 64}}},
            "Z": {"CSR": {"M": {"format": "C", "cbits": 32, "pbits": 32},
                          "N": {"format": "C", "cbits": 32, "pbits": 64}}},
        },
        "architecture": {
            "clock_ghz": CLOCK_GHZ,
            "topologies": {
                "main": {
                    "name": "chip", "num": 1,
                    "local": [
                        {"name": "HBM", "class": "DRAM",
                         "bandwidth": dram_gbs},
                        # FiberCache: shared, banked, 3 MB
                        {"name": "FiberCache", "class": "Buffer",
                         "type": "cache", "width": 64,
                         "depth": int(fibercache_mb * 1024 * 1024 / 64),
                         "bandwidth": 512.0},
                    ],
                    "subtree": [{
                        "name": "PE", "num": N_PES,
                        "local": [
                            {"name": "Merger", "class": "Merger",
                             "inputs": merge_radix,
                             "comparator_radix": merge_radix,
                             "outputs": 1, "order": "fifo",
                             "reduce": True},
                            {"name": "MulALU", "class": "Compute",
                             "type": "mul"},
                            {"name": "AddALU", "class": "Compute",
                             "type": "add"},
                            {"name": "Isect", "class": "Intersection",
                             "type": "leader_follower", "leader": "A"},
                        ],
                    }],
                },
            },
        },
        "binding": {
            "T": {
                "topology": "main",
                "storage": [
                    # rows of B stream through the shared FiberCache
                    {"component": "FiberCache", "tensor": "B", "rank": "N",
                     "type": "elem", "config": "CSR", "style": "lazy"},
                    {"component": "FiberCache", "tensor": "A", "rank": "K0",
                     "type": "elem", "config": "CSR", "style": "lazy"},
                ],
                "compute": [],
            },
            "Z": {
                "topology": "main",
                "storage": [
                    # scaled partial rows live in the merger's buffers;
                    # Z accumulates through the FiberCache before drain
                    {"component": "FiberCache", "tensor": "Z", "rank": "N",
                     "type": "elem", "config": "CSR", "style": "lazy"},
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

    return _simulate("gamma", inputs, var_shapes, params=params,
                     backend=backend, device=device, model=model,
                     semiring=semiring, **spec_kw)
