"""OuterSPACE [Pal et al., HPCA'18] as a TeAAL spec (paper Figs. 3, 5).

Outer-product SpMSpM in two phases:
  multiply: T[k,m,n] = A[k,m] * B[k,n]   (col of A x row of B)
  merge:    Z[m,n]   = T[k,m,n]          (sort + reduce linked lists)

Mapping (Fig. 3): the multiply phase flattens (K, M) and partitions the
nonzeros of A 256-at-a-time across 16 Processing Tiles x 16 PEs; the
merge phase partitions rows of T across 16 PTs x 8 PEs (half the PEs
are enabled during merge -- paper footnote 2).

Hardware (Table 5): 1.5 GHz, 16 PEs/PT, 16 PTs, 16 kB L0 cache per PT,
4 kB L1 cache per 4 PTs, 16 64-bit HBM channels @ 8000 MB/s.

Format: A is CSC, B is CSR (32-bit coords/values); T is the custom
array-of-linked-lists (Fig. 5c): an uncompressed array of list pointers
on M, coordinate/value nodes with next-pointers on (K,)N.
"""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.core.spec import AcceleratorSpec, load_spec

# Table 5
CLOCK_GHZ = 1.5
N_PT = 16
PES_PER_PT = 16
MULTIPLY_PES = N_PT * PES_PER_PT          # 256
MERGE_PES = N_PT * (PES_PER_PT // 2)      # 128
DRAM_GBS = 16 * 8.0                       # 16 channels x 8000 MB/s


def spec(mult_batch: int = 256, mult_grp: int = 16,
         merge_batch: int = 128, merge_grp: int = 8,
         l0_kb: float = 16.0, l1_kb: float = 4.0,
         dram_gbs: float = DRAM_GBS) -> AcceleratorSpec:
    d: Dict[str, Any] = {
        "name": "OuterSPACE",
        "einsum": {
            "declaration": {
                "A": ["K", "M"],
                "B": ["K", "N"],
                "T": ["K", "M", "N"],
                "Z": ["M", "N"],
            },
            "expressions": [
                "T[k, m, n] = A[k, m] * B[k, n]",
                "Z[m, n] = T[k, m, n]",
            ],
        },
        "mapping": {
            "rank-order": {
                "A": ["K", "M"],          # CSC: offline swizzle of CSR A
                "B": ["K", "N"],
                "T": ["M", "K", "N"],
                "Z": ["M", "N"],
            },
            "partitioning": {
                "T": {
                    "(K, M)": ["flatten()"],
                    "KM": [f"uniform_occupancy(A.{mult_batch})",
                           f"uniform_occupancy(A.{mult_grp})"],
                },
                "Z": {
                    "M": [f"uniform_occupancy(T.{merge_batch})",
                          f"uniform_occupancy(T.{merge_grp})"],
                },
            },
            "loop-order": {
                "T": ["KM2", "KM1", "KM0", "N"],
                "Z": ["M2", "M1", "M0", "N", "K"],
            },
            "spacetime": {
                "T": {"space": ["KM1", "KM0"], "time": ["KM2", "N"]},
                "Z": {"space": ["M1", "M0"], "time": ["M2", "N", "K"]},
            },
        },
        "format": {
            "A": {"CSC": {"K": {"format": "C", "cbits": 32, "pbits": 32},
                          "M": {"format": "C", "cbits": 32, "pbits": 32}}},
            "B": {"CSR": {"K": {"format": "C", "cbits": 32, "pbits": 32},
                          "N": {"format": "C", "cbits": 32, "pbits": 32}}},
            "T": {"LinkedLists": {
                "M": {"format": "U", "cbits": 0, "pbits": 64},
                "K": {"format": "C", "cbits": 32, "pbits": 32},
                "N": {"format": "C", "cbits": 32, "pbits": 32,
                      "fhbits": 64, "layout": "interleaved"}}},
            "Z": {"CSR": {"M": {"format": "C", "cbits": 32, "pbits": 32},
                          "N": {"format": "C", "cbits": 32, "pbits": 32}}},
        },
        "architecture": {
            "clock_ghz": CLOCK_GHZ,
            "topologies": {
                "multiply": {
                    "name": "chip", "num": 1,
                    "local": [
                        {"name": "HBM", "class": "DRAM",
                         "bandwidth": dram_gbs},
                        {"name": "Seq", "class": "Sequencer",
                         "num_ranks": 4},
                    ],
                    "subtree": [{
                        "name": "PT", "num": N_PT,
                        "local": [
                            {"name": "L0", "class": "Buffer",
                             "type": "cache", "width": 64,
                             "depth": int(l0_kb * 1024 / 64)},
                        ],
                        "subtree": [{
                            "name": "PE", "num": PES_PER_PT,
                            "local": [
                                {"name": "MulALU", "class": "Compute",
                                 "type": "mul"},
                            ],
                        }],
                    }],
                },
                "merge": {
                    "name": "chip", "num": 1,
                    "local": [
                        {"name": "HBM", "class": "DRAM",
                         "bandwidth": dram_gbs},
                    ],
                    "subtree": [{
                        "name": "PT", "num": N_PT,
                        "local": [
                            {"name": "L0", "class": "Buffer",
                             "type": "buffet", "width": 8,
                             "depth": int(l0_kb * 1024 / 8)},
                            {"name": "SortNet", "class": "Merger",
                             "inputs": 64, "comparator_radix": 2,
                             "outputs": 1, "order": "opt",
                             "reduce": False},
                        ],
                        "subtree": [{
                            "name": "PE", "num": PES_PER_PT // 2,
                            "local": [
                                {"name": "AddALU", "class": "Compute",
                                 "type": "add"},
                            ],
                        }],
                    }],
                },
            },
        },
        "binding": {
            "T": {
                "topology": "multiply",
                "storage": [
                    # A nonzeros staged per 16-element group in the PT L0
                    {"component": "L0", "tensor": "A", "rank": "KM0",
                     "type": "elem", "config": "CSC", "style": "lazy"},
                    # B rows cached in L0 (reused across the 16 PEs of a PT)
                    {"component": "L0", "tensor": "B", "rank": "N",
                     "type": "elem", "config": "CSR", "style": "lazy"},
                ],
                "compute": [{"component": "MulALU", "op": "mul"}],
            },
            "Z": {
                "topology": "merge",
                "storage": [
                    # whole row of partial products loaded for the sort
                    {"component": "L0", "tensor": "T", "rank": "M0",
                     "type": "elem", "config": "LinkedLists",
                     "style": "eager", "evict-on": "M0"},
                ],
                "compute": [{"component": "AddALU", "op": "add"}],
            },
        },
    }
    return load_spec(d)

def simulate(inputs, var_shapes, params=None, backend="vector",
             device=None, model=True, semiring=None, **spec_kw):
    """Run this design on real tensors; delegates to
    repro_torch.accelerators.simulate (``backend`` selects the execution
    engine: 'python' oracle | 'vector' columnar CSF; ``device`` selects
    the seam kernels: 'cuda' hand kernels, 'cpu' plain versions).

    Both phases -- the (K, M)-flattened, occupancy-distributed multiply
    and the M-partitioned merge -- lower to the VectorPlan IR, so
    ``backend='vector'`` executes natively (``SimResult.fallback_reasons
    == {}``) instead of silently routing through the interpreter."""
    from repro_torch.accelerators import simulate as _simulate

    return _simulate("outerspace", inputs, var_shapes, params=params,
                     backend=backend, device=device, model=model,
                     semiring=semiring, **spec_kw)
