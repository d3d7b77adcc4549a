"""Vertex-centric programming accelerators (paper Sec. 8, Fig. 12).

Three designs over the same processing phase, differing in the apply
phase's data orchestration:

  * Graphicionado [Ham et al., MICRO'16]: applies *every* vertex each
    iteration (P1 = R + P0 unions the full property vector), edge-list
    graph format.
  * GraphDynS [Yan et al., MICRO'19]: builds MP = take(R, P0, 1) so only
    *touched* property partitions are loaded (a 256-partition bitmap ->
    uniform_shape partitioning with eager loads), filters write-back
    through the changed-mask M, CSR graph format.
  * Ours (Sec. 8 proposal): drops the partitioning -- properties are
    loaded and applied lazily only for vertices actually modified.

A specific algorithm manifests by redefining (+, x): SSSP uses
(min, +); BFS is SSSP on unit weights.  Properties are stored as
distance+1 so the additive identity (empty payload = 0) never collides
with a real distance.

Hardware (Table 5, used for all three): 1 GHz, 8 streams, 64 MB eDRAM,
68 GB/s memory bandwidth.
"""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.core.spec import AcceleratorSpec, load_spec

CLOCK_GHZ = 1.0
N_STREAMS = 8
EDRAM_MB = 64.0
DRAM_GBS = 68.0

# processing phase shared by all three designs (Fig. 12, lines 1-3)
_PROCESS = [
    "SO[d, s] = take(G[d, s], A0[s], 0)",
    "R[d] = SO[d, s] * A0[s]",
]

def _arch(edram_mb: float = EDRAM_MB) -> Dict[str, Any]:
    """Table-5 hardware.  ``edram_mb`` is scalable so test/benchmark
    graphs (10^2-10^3 vertices vs the paper's 10^6-10^7) exercise the
    same capacity regime: the paper's graphs exceed the 64 MB eDRAM, so
    scaled-down graphs must exceed a scaled-down eDRAM (methodology
    note in EXPERIMENTS.md)."""
    return {
        "clock_ghz": CLOCK_GHZ,
        "topologies": {
            "main": {
                "name": "chip", "num": 1,
                "local": [
                    {"name": "DRAM", "class": "DRAM",
                     "bandwidth": DRAM_GBS},
                    {"name": "eDRAM", "class": "Buffer", "type": "cache",
                     "width": 64,
                     "depth": max(1, int(edram_mb * 1024 * 1024 / 64))},
                    # sparse-active-set probes: the smaller side leads
                    {"name": "Isect", "class": "Intersection",
                     "type": "leader_follower", "leader": "R"},
                ],
                "subtree": [{
                    "name": "Stream", "num": N_STREAMS,
                    "local": [
                        {"name": "ProcALU", "class": "Compute",
                         "type": "mul"},
                        {"name": "ApplyALU", "class": "Compute",
                         "type": "add"},
                    ],
                }],
            },
        },
    }


_ARCH = _arch()


def _format(edge_list: bool, weighted: bool) -> Dict[str, Any]:
    """Graph format: edge list re-stores the source ID per edge (64-bit
    coordinate on D); CSR stores each source once and can omit the
    weight payload for unweighted algorithms (BFS)."""
    pbits = 32 if weighted else 0
    if edge_list:
        g = {"S": {"format": "C", "cbits": 0, "pbits": 0},
             "D": {"format": "C", "cbits": 64, "pbits": 32}}
    else:
        g = {"S": {"format": "C", "cbits": 32, "pbits": 32},
             "D": {"format": "C", "cbits": 32, "pbits": pbits}}
    vec = {"format": "C", "cbits": 32, "pbits": 32}
    return {
        "G": {"default": g},
        "A0": {"default": {"S": dict(vec)}},
        "A1": {"default": {"D": dict(vec)}},
        "R": {"default": {"D": dict(vec)}},
        "P0": {"default": {"D": dict(vec), "D1": dict(vec),
                           "D0": dict(vec)}},
        "P1": {"default": {"D": dict(vec)}},
        "MP": {"default": {"D": dict(vec)}},
        "NP": {"default": {"D": dict(vec)}},
        "M": {"default": {"D": dict(vec)}},
        "SO": {"default": {"S": dict(vec), "D": dict(vec)}},
    }


def graphicionado_spec(weighted: bool = True,
                       edram_mb: float = EDRAM_MB) -> AcceleratorSpec:
    d: Dict[str, Any] = {
        "name": "Graphicionado",
        "einsum": {
            "declaration": {
                "G": ["D", "S"], "A0": ["S"], "SO": ["D", "S"],
                "R": ["D"], "P0": ["D"], "P1": ["D"], "M": ["D"],
                "A1": ["D"],
            },
            "expressions": _PROCESS + [
                "P1[d] = R[d] + P0[d]",
                "M[d] = P1[d] - P0[d]",
                "A1[d] = take(M[d], P1[d], 1)",
            ],
        },
        "mapping": {
            "rank-order": {
                "G": ["S", "D"], "SO": ["S", "D"],
            },
            "loop-order": {
                "SO": ["S", "D"],
                "R": ["S", "D"],
                "P1": ["D"],
                "M": ["D"],
                "A1": ["D"],
            },
        },
        "format": _format(edge_list=True, weighted=weighted),
        "architecture": _arch(edram_mb),
        "binding": {
            "SO": {"topology": "main",
                   "storage": [
                       {"component": "eDRAM", "tensor": "A0", "rank": "S",
                        "type": "elem", "style": "lazy"}],
                   "compute": []},
            "R": {"topology": "main",
                  "storage": [
                      {"component": "eDRAM", "tensor": "R", "rank": "D",
                       "type": "elem", "style": "lazy"}],
                  "compute": [{"component": "ProcALU", "op": "mul"}]},
            "P1": {"topology": "main", "storage": [],
                   "compute": [{"component": "ApplyALU", "op": "add"}]},
            "M": {"topology": "main", "storage": [], "compute": []},
            "A1": {"topology": "main", "storage": [], "compute": []},
        },
    }
    return load_spec(d)


def graphdyns_spec(weighted: bool = True,
                   n_partitions: int = 256,
                   n_vertices: int = 1 << 20,
                   edram_mb: float = EDRAM_MB) -> AcceleratorSpec:
    part = max(1, n_vertices // n_partitions)
    d: Dict[str, Any] = {
        "name": "GraphDynS",
        "einsum": {
            "declaration": {
                "G": ["D", "S"], "A0": ["S"], "SO": ["D", "S"],
                "R": ["D"], "P0": ["D"], "MP": ["D"], "NP": ["D"],
                "M": ["D"], "P1": ["D"], "A1": ["D"],
            },
            "expressions": _PROCESS + [
                "MP[d] = take(R[d], P0[d], 1)",
                "NP[d] = R[d] + MP[d]",
                "M[d] = NP[d] - MP[d]",
                "P0[d] = take(M[d], NP[d], 1)",
                "A1[d] = take(M[d], NP[d], 1)",
                "P1 = P0",
            ],
        },
        "mapping": {
            "rank-order": {
                "G": ["S", "D"], "SO": ["S", "D"],
            },
            "partitioning": {
                # the 256-entry presence bitmap over vertex properties
                "MP": {"D": [f"uniform_shape({part})"]},
            },
            "loop-order": {
                "SO": ["S", "D"],
                "R": ["S", "D"],
                "MP": ["D1", "D0"],
                "NP": ["D"],
                "M": ["D"],
                "P0": ["D"],
                "A1": ["D"],
            },
        },
        "format": _format(edge_list=False, weighted=weighted),
        "architecture": _arch(edram_mb),
        "binding": {
            "SO": {"topology": "main",
                   "storage": [
                       {"component": "eDRAM", "tensor": "A0", "rank": "S",
                        "type": "elem", "style": "lazy"}],
                   "compute": []},
            "R": {"topology": "main",
                  "storage": [
                      {"component": "eDRAM", "tensor": "R", "rank": "D",
                       "type": "elem", "style": "lazy"}],
                  "compute": [{"component": "ProcALU", "op": "mul"}]},
            "MP": {"topology": "main",
                   "storage": [
                       # bitmap-gated eager load of whole property blocks
                       {"component": "eDRAM", "tensor": "P0", "rank": "D1",
                        "type": "elem", "style": "eager"}],
                   "compute": []},
            "NP": {"topology": "main", "storage": [],
                   "compute": [{"component": "ApplyALU", "op": "add"}]},
            "M": {"topology": "main", "storage": [], "compute": []},
            "P0": {"topology": "main", "storage": [], "compute": []},
            "A1": {"topology": "main", "storage": [], "compute": []},
        },
    }
    return load_spec(d)


def improved_spec(weighted: bool = True,
                  edram_mb: float = EDRAM_MB) -> AcceleratorSpec:
    """Our Sec. 8 proposal: GraphDynS minus the partitioning -- only the
    properties of vertices actually modified are loaded / applied."""
    d: Dict[str, Any] = {
        "name": "Ours-VCP",
        "einsum": {
            "declaration": {
                "G": ["D", "S"], "A0": ["S"], "SO": ["D", "S"],
                "R": ["D"], "P0": ["D"], "MP": ["D"], "NP": ["D"],
                "M": ["D"], "P1": ["D"], "A1": ["D"],
            },
            "expressions": _PROCESS + [
                "MP[d] = take(R[d], P0[d], 1)",
                "NP[d] = R[d] + MP[d]",
                "M[d] = NP[d] - MP[d]",
                "P0[d] = take(M[d], NP[d], 1)",
                "A1[d] = take(M[d], NP[d], 1)",
                "P1 = P0",
            ],
        },
        "mapping": {
            "rank-order": {
                "G": ["S", "D"], "SO": ["S", "D"],
            },
            "loop-order": {
                "SO": ["S", "D"],
                "R": ["S", "D"],
                "MP": ["D"],
                "NP": ["D"],
                "M": ["D"],
                "P0": ["D"],
                "A1": ["D"],
            },
        },
        "format": _format(edge_list=False, weighted=weighted),
        "architecture": _arch(edram_mb),
        "binding": {
            "SO": {"topology": "main",
                   "storage": [
                       {"component": "eDRAM", "tensor": "A0", "rank": "S",
                        "type": "elem", "style": "lazy"}],
                   "compute": []},
            "R": {"topology": "main",
                  "storage": [
                      {"component": "eDRAM", "tensor": "R", "rank": "D",
                       "type": "elem", "style": "lazy"}],
                  "compute": [{"component": "ProcALU", "op": "mul"}]},
            "MP": {"topology": "main",
                   "storage": [
                       {"component": "eDRAM", "tensor": "P0", "rank": "D",
                        "type": "elem", "style": "lazy"}],
                   "compute": []},
            "NP": {"topology": "main", "storage": [],
                   "compute": [{"component": "ApplyALU", "op": "add"}]},
            "M": {"topology": "main", "storage": [], "compute": []},
            "P0": {"topology": "main", "storage": [], "compute": []},
            "A1": {"topology": "main", "storage": [], "compute": []},
        },
    }
    return load_spec(d)

def simulate(inputs, var_shapes, variant: str = "graphicionado",
             params=None, backend="vector", device=None, model=True,
             semiring=None, **spec_kw):
    """Run one of the graph-accelerator variants; delegates to
    repro_torch.accelerators.simulate (``backend`` selects the execution
    engine: 'python' oracle | 'vector' columnar CSF; ``device`` selects
    the seam kernels: None or 'cuda' the hand kernels on the card,
    'cpu' their plain versions)."""
    from repro_torch.accelerators import simulate as _simulate

    return _simulate(variant, inputs, var_shapes, params=params,
                     backend=backend, device=device, model=model,
                     semiring=semiring, **spec_kw)
