"""SIGMA [Qin et al., HPCA'20] as a TeAAL spec (paper Fig. 8c).

Deep-learning GEMM accelerator; A-stationary dataflow.  The cascade
pre-filters the stationary matrix: rows (K-fibers) of A whose matching
row of B is empty are removed before PEs are filled, so only useful
nonzeros occupy the (flexible, Benes-interconnected) PE array:

  S[k,m] = take(A[k,m], B[k,n], 0)   -- A where B's row k is non-empty
  T[k,m] = take(A[k,m], S[k,m], 0)   -- filtered stationary matrix
  Z[m,n] = T[k,m] * B[k,n]

Mapping (Fig. 8c): K split by shape 128 (the FlexDPE granularity),
(M, K0) flattened, and the flattened nonzeros distributed
16384-at-a-time (128 FlexDPEs x 128 PEs) by occupancy -- every PE gets
exactly one useful nonzero (SIGMA's headline feature).  MK00 is the
spatial rank; time is [K1, MK01, N.coord].

Hardware (Table 5): 500 MHz, 128 PEs per FlexDPE, 128 FlexDPEs, 32 MB
Data SRAM, 4 MB Bitmap SRAM, 960 GB/s SRAM bw, 1024 GB/s HBM bw.
"""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.core.spec import AcceleratorSpec, load_spec

CLOCK_GHZ = 0.5
N_FLEXDPE = 128
PES_PER_DPE = 128
N_PES = N_FLEXDPE * PES_PER_DPE           # 16384
DRAM_GBS = 1024.0
SRAM_GBS = 960.0


def spec(k_tile: int = 128, stationary: int = N_PES,
         data_sram_mb: float = 32.0, bitmap_sram_mb: float = 4.0,
         dram_gbs: float = DRAM_GBS) -> AcceleratorSpec:
    d: Dict[str, Any] = {
        "name": "SIGMA",
        "einsum": {
            "declaration": {
                "A": ["K", "M"],
                "B": ["K", "N"],
                "S": ["K", "M"],
                "T": ["K", "M"],
                "Z": ["M", "N"],
            },
            "expressions": [
                "S[k, m] = take(A[k, m], B[k, n], 0)",
                "T[k, m] = take(A[k, m], S[k, m], 0)",
                "Z[m, n] = T[k, m] * B[k, n]",
            ],
        },
        "mapping": {
            "rank-order": {
                "A": ["K", "M"],
                "B": ["K", "N"],
                "S": ["K", "M"],
                "T": ["K", "M"],
                "Z": ["M", "N"],
            },
            "partitioning": {
                "Z": {
                    "K": [f"uniform_shape({k_tile})"],
                    "(M, K0)": ["flatten()"],
                    "MK0": [f"uniform_occupancy(T.{stationary})"],
                },
            },
            "loop-order": {
                "S": ["K", "M", "N"],
                "T": ["K", "M"],
                "Z": ["K1", "MK01", "MK00", "N"],
            },
            "spacetime": {
                "S": {"space": [], "time": ["K", "M", "N"]},
                "T": {"space": [], "time": ["K", "M"]},
                "Z": {"space": ["MK00"], "time": ["K1", "MK01", "N.coord"]},
            },
        },
        "format": {
            # SIGMA's bitmap format: B-type (uncompressed bitmap coords,
            # compressed payloads)
            "A": {"Bitmap": {"K": {"format": "B", "cbits": 1, "pbits": 32},
                             "M": {"format": "B", "cbits": 1, "pbits": 32}}},
            "B": {"Bitmap": {"K": {"format": "B", "cbits": 1, "pbits": 32},
                             "N": {"format": "B", "cbits": 1, "pbits": 32}}},
            "T": {"Bitmap": {"K1": {"format": "C", "cbits": 16, "pbits": 32},
                             "MK0": {"format": "B", "cbits": 1, "pbits": 32},
                             "K": {"format": "B", "cbits": 1, "pbits": 32},
                             "M": {"format": "B", "cbits": 1, "pbits": 32}}},
            "Z": {"Dense": {"M": {"format": "U", "cbits": 0, "pbits": 32},
                            "N": {"format": "U", "cbits": 0, "pbits": 32}}},
        },
        "architecture": {
            "clock_ghz": CLOCK_GHZ,
            "topologies": {
                "main": {
                    "name": "chip", "num": 1,
                    "local": [
                        {"name": "HBM", "class": "DRAM",
                         "bandwidth": dram_gbs},
                        {"name": "DataSRAM", "class": "Buffer",
                         "type": "buffet", "width": 64,
                         "depth": int(data_sram_mb * 1024 * 1024 / 64),
                         "bandwidth": SRAM_GBS},
                        {"name": "BitmapSRAM", "class": "Buffer",
                         "type": "buffet", "width": 64,
                         "depth": int(bitmap_sram_mb * 1024 * 1024 / 64),
                         "bandwidth": SRAM_GBS},
                        {"name": "FilterIsect", "class": "Intersection",
                         "type": "two_finger"},
                    ],
                    "subtree": [{
                        "name": "FlexDPE", "num": N_FLEXDPE,
                        "local": [],
                        "subtree": [{
                            "name": "PE", "num": PES_PER_DPE,
                            "local": [
                                {"name": "MulALU", "class": "Compute",
                                 "type": "mul"},
                                {"name": "AddTree", "class": "Compute",
                                 "type": "add"},
                            ],
                        }],
                    }],
                },
            },
        },
        "binding": {
            "S": {
                "topology": "main",
                "storage": [
                    {"component": "BitmapSRAM", "tensor": "A", "rank": "M",
                     "type": "coord", "config": "Bitmap", "style": "lazy"},
                    {"component": "BitmapSRAM", "tensor": "B", "rank": "N",
                     "type": "coord", "config": "Bitmap", "style": "lazy"},
                ],
                "compute": [],
            },
            "T": {
                "topology": "main",
                "storage": [],
                "compute": [],
            },
            "Z": {
                "topology": "main",
                "storage": [
                    # stationary nonzeros resident across the N stream
                    {"component": "DataSRAM", "tensor": "T", "rank": "MK00",
                     "type": "elem", "config": "Bitmap", "style": "lazy",
                     "evict-on": "MK01"},
                    {"component": "DataSRAM", "tensor": "B", "rank": "N",
                     "type": "elem", "config": "Bitmap", "style": "lazy"},
                ],
                "compute": [
                    {"component": "MulALU", "op": "mul"},
                    {"component": "AddTree", "op": "add"},
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
    the seam kernels: 'cuda' hand kernels, 'cpu' plain versions).

    The full cascade -- the take() filter pipeline, the K-tiled /
    (M, K0)-flattened / occupancy-distributed stationary matrix, and
    the leaf-bound output ranks -- lowers to the VectorPlan IR, so
    ``backend='vector'`` executes natively (``SimResult.fallback_reasons
    == {}``) instead of silently routing through the interpreter."""
    from repro_torch.accelerators import simulate as _simulate

    return _simulate("sigma", inputs, var_shapes, params=params,
                     backend=backend, device=device, model=model,
                     semiring=semiring, **spec_kw)
