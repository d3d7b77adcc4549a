"""MatRaptor [Srivastava et al., MICRO'20] as a TeAAL spec (Table 1).

Row-wise product (Gustavson) SpMSpM with parallel summation: rows of A
are distributed round-robin across PEs (the C^2SR channel-cyclic
format); each PE scales the selected rows of B and merge-sums partial
rows through its sorting-queue array.

Cascade-wise MatRaptor is Gamma's row-wise form without the shared
FiberCache: the same take()/multiply cascade, mapped with M0 spatial
over 8 PEs and the queue array modeled as the per-PE merger (radix =
number of queues).  This is exactly the paper's point: closely-related
designs differ by mapping/binding point changes, not new simulators.

Hardware (MatRaptor paper): 2 GHz, 8 PEs, 12 sorting queues per PE,
16 GB/s/channel x 8 channels HBM.
"""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.core.spec import AcceleratorSpec, load_spec

CLOCK_GHZ = 2.0
N_PES = 8
N_QUEUES = 12
DRAM_GBS = 128.0


def spec(rows_per_round: int = N_PES,
         n_queues: int = N_QUEUES) -> AcceleratorSpec:
    d: Dict[str, Any] = {
        "name": "MatRaptor",
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
                # C^2SR: rows cycled across PEs -> occupancy split of M
                "T": {"M": [f"uniform_occupancy(A.{rows_per_round})"],
                      "K": [f"uniform_occupancy(A.{n_queues})"]},
                "Z": {"M": [f"uniform_occupancy(A.{rows_per_round})"],
                      "K": [f"uniform_occupancy(A.{n_queues})"]},
            },
            "loop-order": {
                "T": ["M1", "M0", "K1", "K0", "N"],
                "Z": ["M1", "M0", "K1", "N", "K0"],
            },
            "spacetime": {
                "T": {"space": ["M0"], "time": ["M1", "K1", "K0", "N"]},
                "Z": {"space": ["M0"], "time": ["M1", "K1", "N", "K0"]},
            },
        },
        "format": {
            # C^2SR: per-channel row headers (fhbits on the K rank)
            "A": {"C2SR": {"M": {"format": "C", "cbits": 32, "pbits": 32},
                           "K": {"format": "C", "cbits": 32, "pbits": 64,
                                 "fhbits": 64}}},
            "B": {"C2SR": {"K": {"format": "C", "cbits": 32, "pbits": 32},
                           "N": {"format": "C", "cbits": 32, "pbits": 64,
                                 "fhbits": 64}}},
            "Z": {"C2SR": {"M": {"format": "C", "cbits": 32, "pbits": 32},
                           "N": {"format": "C", "cbits": 32,
                                 "pbits": 64}}},
        },
        "architecture": {
            "clock_ghz": CLOCK_GHZ,
            "topologies": {
                "main": {
                    "name": "chip", "num": 1,
                    "local": [
                        {"name": "HBM", "class": "DRAM",
                         "bandwidth": DRAM_GBS},
                    ],
                    "subtree": [{
                        "name": "PE", "num": N_PES,
                        "local": [
                            # the sorting-queue array: a radix-Q merger
                            {"name": "Queues", "class": "Merger",
                             "inputs": n_queues,
                             "comparator_radix": n_queues,
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
            "T": {"topology": "main", "storage": [], "compute": []},
            "Z": {"topology": "main", "storage": [],
                  "compute": [{"component": "MulALU", "op": "mul"},
                              {"component": "AddALU", "op": "add"}]},
        },
    }
    return load_spec(d)

def simulate(inputs, var_shapes, params=None, backend="vector",
             device=None, model=True, semiring=None, **spec_kw):
    """Run this design on real tensors; delegates to
    repro_torch.accelerators.simulate (``backend`` selects the execution
    engine: 'python' oracle | 'vector' columnar CSF; ``device`` selects
    the seam kernels: 'cuda' hand kernels, 'cpu' plain versions).

    The take() cascade with its C^2SR occupancy splits and
    leader-follower (A-led) intersection lowers to the VectorPlan IR,
    so ``backend='vector'`` executes natively
    (``SimResult.fallback_reasons == {}``) instead of silently routing
    through the interpreter."""
    from repro_torch.accelerators import simulate as _simulate

    return _simulate("matraptor", inputs, var_shapes, params=params,
                     backend=backend, device=device, model=model,
                     semiring=semiring, **spec_kw)
