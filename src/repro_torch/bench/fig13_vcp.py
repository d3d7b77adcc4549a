"""Fig. 13: the Sec.-8 design study -- Graphicionado vs GraphDynS vs
our proposal on BFS and SSSP (sparse active-vertex-set algorithms), on
the port (``benchmarks/fig13_vcp.py``, the reference's study, copied).

    python -m repro_torch.bench.fig13_vcp [--smoke | --side N]
                                          [--device cpu] [--check]
                                          [--record]

Paper claims validated (direction, at simulator scale):
  * GraphDynS speeds up Graphicionado,
  * our proposal speeds up GraphDynS on BFS (paper: 1.9x) and SSSP
    (paper: 1.2x), with BFS > SSSP gains (BFS drops the weight loads).

All three designs run natively on the vector path under ``min_plus``;
its seams run on the CUDA device unless ``device`` names another.  Each
run records its host wall seconds (the device synchronised before the
clock stops) and the launches of every seam kernel.  ``--check``
compares with the reference's record, ``BENCH_graph.json``, read as a
data file: at its size the modeled seconds, reached vertices and
iteration counts of every run and the claims must equal it.
``--record`` writes the summary under the ``fig13`` key of
``BENCH_torch.json``, from a run on the card only.  Every run exits
non-zero when a gated direction claim fails or a run fell back.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.accelerators import graphicionado as G
from repro_torch.bench.workloads import sparse_grid_graph
from repro_torch.core.einsum import Semiring
from repro_torch.core.generator import CascadeSimulator, SimResult
from repro_torch.core.vectorized import VectorBackend
from repro_torch.kernels import KERNELS
from repro_torch.kernels.backends import resolve_device
from repro_torch.obs.spans import trace_session

ROOT = Path(__file__).resolve().parents[3]
#: the reference's record of this study (a CPU run of its vector backend)
REFERENCE_JSON = ROOT / "BENCH_graph.json"
#: the port's record, written from card runs only
BENCH_JSON = ROOT / "BENCH_torch.json"
FULL_SIDE = 362                      # 362^2 = 131044 vertices (>= 10^5)
SMOKE_SIDE = 48
MAX_ITERS = 64                       # BFS wavefront cap: every design
                                     # sees the identical frontier schedule

#: paper Sec.-8 direction claims the benchmark gates on
GATED_CLAIMS = ("graphdyns_beats_graphicionado", "ours_beats_graphdyns_bfs")
#: per-run fields that are simulated results (not host measurements)
SIMULATED = ("modeled_seconds", "iters", "fallback_reasons", "reached")


def designs(weighted: bool, v: int):
    return {
        "graphicionado": G.graphicionado_spec(weighted=weighted),
        "graphdyns": G.graphdyns_spec(weighted=weighted, n_vertices=v),
        "ours": G.improved_spec(weighted=weighted),
    }


def graphs(side: int, seed: int = 0):
    """(algorithm, weighted, graph) of the study at ``side``^2 vertices
    with ``v // 16`` small-world shortcuts."""
    v = side * side
    return [(algo, weighted,
             sparse_grid_graph(side, extra=v // 16, weighted=weighted,
                               seed=seed))
            for algo, weighted in (("bfs", False), ("sssp", True))]


def run_vcp(spec, g_ft, v: int, backend, extra_instr=None,
            max_iters: int = MAX_ITERS) -> Tuple[SimResult, int]:
    """One BFS / SSSP run from vertex 0 under ``min_plus``, as the
    reference runs it: properties stored as distance + 1, the active set
    and properties carried until the active set is empty or
    ``max_iters``."""
    a0 = np.zeros(v)
    a0[0] = 1.0
    p0 = np.zeros(v)
    p0[0] = 1.0                      # properties stored as distance+1
    sim = CascadeSimulator(spec, semiring=Semiring.min_plus(),
                           extra_instr=extra_instr, backend=backend)
    return sim.run_iterative(
        {"G": g_ft, "A0": a0, "P0": p0},
        carry={"A0": "A1", "P0": "P1"}, done_when_empty="A1",
        max_iters=max_iters, var_shapes={"d": v, "s": v})


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run(spec, g_ft, v: int, backend, device: torch.device,
         max_iters: int, trace: bool) -> Dict:
    for k in KERNELS:
        k.launches = 0
    with trace_session() if trace else contextlib.nullcontext() as tr:
        t0 = time.perf_counter()
        res, iters = run_vcp(spec, g_ft, v, backend, max_iters=max_iters)
        _sync(device)
        wall = time.perf_counter() - t0
    rec = {
        "modeled_seconds": res.report.seconds,
        "wall_seconds": wall,
        "iters": iters,
        "fallback_reasons": dict(res.fallback_reasons),
        "reached": int(res.tensors["P1"].nnz),
        "launches": {k.__name__: k.launches for k in KERNELS},
    }
    if trace:
        # span seconds summed by name over every iteration: the engine's
        # stages and the seam calls (transfers, launches, host work)
        for cat, key in (("stage", "stage_seconds"),
                         ("seam", "seam_seconds")):
            secs: Dict[str, float] = {}
            for sp in tr.spans(cat=cat):
                name = sp["name"].split(":", 1)[1]
                secs[name] = secs.get(name, 0.0) + sp["dur"] / 1e6
            rec[key] = secs
    return rec


def bench(side: int = FULL_SIDE, backend: str = "vector", device=None,
          seed: int = 0, max_iters: int = MAX_ITERS,
          trace: bool = False) -> Dict:
    """The study at ``side``^2 vertices.  ``backend`` 'vector' builds
    ``VectorBackend(device=device)`` (None: the CUDA device, raising
    without one); 'python' runs the interpreter.  ``trace`` adds each
    run's stage and seam-call seconds (``stage_seconds``,
    ``seam_seconds``) from a tracer around it."""
    device = resolve_device(device)
    v = side * side
    summary: Dict = {"vertices": v, "grid_side": side, "extra": v // 16,
                     "max_iters": max_iters, "backend": backend,
                     "device": str(device), "runs": {}, "speedups": {},
                     "claims": {}}
    times: Dict[str, Dict[str, float]] = {}
    for algo, weighted, g in graphs(side, seed):
        summary.setdefault("edges", g.nnz)
        times[algo] = {}
        for name, spec in designs(weighted, v).items():
            be = VectorBackend(device=device) if backend == "vector" \
                else backend
            r = _run(spec, g, v, be, device, max_iters, trace)
            summary["runs"][f"{algo}/{name}"] = r
            times[algo][name] = r["modeled_seconds"]
    for algo in ("bfs", "sssp"):
        t = times[algo]
        summary["speedups"][f"{algo}/graphdyns_over_graphicionado"] = \
            round(t["graphicionado"] / t["graphdyns"], 3)
        summary["speedups"][f"{algo}/ours_over_graphdyns"] = \
            round(t["graphdyns"] / t["ours"], 3)
    sp = summary["speedups"]
    summary["claims"] = {
        "graphdyns_beats_graphicionado":
            sp["bfs/graphdyns_over_graphicionado"] > 1.0
            and sp["sssp/graphdyns_over_graphicionado"] > 1.0,
        "ours_beats_graphdyns_bfs": sp["bfs/ours_over_graphdyns"] > 1.0,
        "ours_beats_graphdyns_sssp": sp["sssp/ours_over_graphdyns"] > 1.0,
        "bfs_gain_exceeds_sssp_gain":
            sp["bfs/ours_over_graphdyns"] > sp["sssp/ours_over_graphdyns"],
        "all_native": all(not r["fallback_reasons"]
                          for r in summary["runs"].values()),
    }
    return summary


def gate(summary: Dict) -> List[str]:
    """The gated direction claims that fail, and ``all_native`` if a run
    fell back."""
    failed = [c for c in GATED_CLAIMS if not summary["claims"][c]]
    if not summary["claims"]["all_native"]:
        failed.append("all_native")
    return failed


def compare(summary: Dict, base: Dict) -> List[str]:
    """Where ``summary`` differs from the reference's record ``base``:
    every run's simulated fields (exact, as JSON keeps them) when both
    ran at one size and iteration cap, the speedups and the claims;
    a gated claim that ``base`` holds and ``summary`` lost."""
    diffs = [f"regressed:{c}" for c in GATED_CLAIMS
             if base["claims"].get(c) and not summary["claims"][c]]
    if (summary["grid_side"], summary["max_iters"]) != \
            (base["grid_side"], base["max_iters"]):
        return diffs
    for key in ("vertices", "edges", "extra"):
        if summary[key] != base[key]:
            diffs.append(f"{key}: {summary[key]} != {base[key]}")
    for key, want in base["runs"].items():
        got = summary["runs"].get(key, {})
        for field in SIMULATED:
            if got.get(field) != want[field]:
                diffs.append(f"{key}.{field}: {got.get(field)!r} != "
                             f"{want[field]!r}")
    for part in ("speedups", "claims"):
        if summary[part] != base[part]:
            diffs.append(f"{part}: {summary[part]} != {base[part]}")
    return diffs


def run(smoke: bool = False, backend: str = "vector", device=None
        ) -> List[Tuple[str, float, float]]:
    """``repro_torch.bench.run`` entry point: CSV rows (name, us,
    derived)."""
    summary = bench(side=SMOKE_SIDE if smoke else FULL_SIDE,
                    backend=backend, device=device)
    rows: List[Tuple[str, float, float]] = []
    for key, r in summary["runs"].items():
        rows.append((f"fig13/{key}", r["wall_seconds"] * 1e6,
                     r["modeled_seconds"]))
    for key, s in summary["speedups"].items():
        rows.append((f"fig13/speedup/{key}", 0.0, s))
    for key, ok in summary["claims"].items():
        rows.append((f"fig13/claim/{key}", 0.0, float(ok)))
    return rows


def record(summary: Dict, path: Path = BENCH_JSON) -> None:
    """Write ``summary`` under the ``fig13`` key of ``path``, keeping
    its other keys; only a run on the card is recorded."""
    if not summary["device"].startswith("cuda"):
        raise ValueError(f"{path.name} records card runs only, not a run "
                         f"on {summary['device']}")
    data = json.loads(path.read_text()) if path.exists() else {}
    data["fig13"] = dict(summary, card=torch.cuda.get_device_name(0))
    path.write_text(json.dumps(data, indent=2) + "\n")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--record", action="store_true",
                    help=f"write the summary into {BENCH_JSON.name} "
                    "(card runs only)")
    ap.add_argument("--check", action="store_true",
                    help=f"compare with the reference's "
                    f"{REFERENCE_JSON.name}")
    ap.add_argument("--smoke", action="store_true",
                    help=f"{SMOKE_SIDE}^2 vertices instead of "
                    f"{FULL_SIDE}^2")
    ap.add_argument("--side", type=int, default=None,
                    help="grid side override (vertices = side^2)")
    ap.add_argument("--backend", default="vector",
                    choices=["python", "vector"])
    ap.add_argument("--device", default=None,
                    help="torch device of the seams (default: the CUDA "
                    "device)")
    args = ap.parse_args(argv)
    side = args.side or (SMOKE_SIDE if args.smoke else FULL_SIDE)
    summary = bench(side=side, backend=args.backend, device=args.device)
    print(json.dumps(summary, indent=2))
    failed = gate(summary)
    if args.check:
        failed += compare(summary,
                          json.loads(REFERENCE_JSON.read_text()))
    if args.record and not failed:
        record(summary)
        print(f"wrote {BENCH_JSON}")
    if failed:
        print(f"FAILED: {failed}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
