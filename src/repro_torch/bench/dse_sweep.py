"""DSE throughput benchmark of the port: sweep points evaluated per second.

    python -m repro_torch.bench.dse_sweep
        [--backend analytic|vector|python|all] [--smoke] [--device cpu]
        [--checkpoint DIR [--resume]] [--trace OUT] [--scale] [--record]

Runs the Gamma FiberCache-capacity sweep (the paper's Sec.-8 workflow)
through ``repro_torch.dse.SweepEngine`` with each execution backend and
reports **points/sec** -- the metric that decides whether a real
design-space exploration (thousands of configurations) is feasible.
The reference's ``benchmarks/dse_sweep.py``, on the port.

The analytic backend (host numpy; it touches no device) evaluates the
full sweep, timed over ``ANALYTIC_REPEATS`` sweeps (the median rate and
the range are reported: one sweep takes milliseconds, within the host's
noise); the execution backends are measured on a prefix of it and
reported at their per-point rate.  The port's 'vector' backend runs
Gamma's default plan natively -- every Einsum on the vector engine, no
``fallback_reasons`` -- with its ``intersect_keys`` seam on the card's
``search`` kernel, unless ``--device`` names another device ('cpu': the
plain versions).  A vector point that falls back, or any point that
fails outside fault injection, makes the run exit 1.

By default the workload is the reference's 96^3 Gamma (the size its
``BENCH_dse.json`` was taken at, and a CPU-sized one).  ``--record``
measures the paper-sized workload instead, ``RECORD_SIZE``: Gamma at
8,192^2 with 100,000 nonzeros per operand (the low end of the paper's
Table 4 range), the analytic backend over all 16 capacities and the
vector backend over ``RECORD_VECTOR_CAPS``; the Python interpreter is
not run at that size.  It writes the summary under the ``dse`` key of
``BENCH_torch.json``, from a run on the card only; ``BENCH_dse.json``
stays the reference's record.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.accelerators import REGISTRY
from repro_torch.core.csf import CSF
from repro_torch.dse import DesignSpace, SweepEngine, pareto_front
from repro_torch.kernels import KERNELS, build
from repro_torch.kernels.backends import resolve_device
from repro_torch.testing.faults import active_injector

CAPACITIES_MB = [0.001, 0.002, 0.003, 0.005, 0.008, 0.013, 0.02, 0.05,
                 0.1, 0.25, 0.5, 1.0, 2.0, 3.0, 4.0, 6.0]
SMOKE_CAPACITIES_MB = [0.002, 3.0]
EXEC_MAX_POINTS = 2          # execution-backend prefix
ANALYTIC_REPEATS = 5         # timed analytic sweeps (median and range)
BACKENDS = ("analytic", "vector", "python")
#: the card record's workload (rows = cols, nonzeros per operand) and
#: the capacities (MB) its vector sweep runs
RECORD_SIZE = (8192, 100_000)
RECORD_VECTOR_CAPS = [0.002, 0.05, 1.0, 6.0]
ROOT = Path(__file__).resolve().parents[3]
#: the port's record, written from card runs only
BENCH_JSON = ROOT / "BENCH_torch.json"

Rows = List[Tuple[str, float, float]]


def workload(seed: int = 0, m: int = 96, k: int = 96, n: int = 96,
             da: float = 0.12, db: float = 0.12):
    """The reference's seeded workload: A [K, M] and B [K, N], i.i.d.
    nonzeros at densities ``da`` / ``db``."""
    rng = np.random.default_rng(seed)
    a = rng.random((k, m)) * (rng.random((k, m)) < da)
    b = rng.random((k, n)) * (rng.random((k, n)) < db)
    return {"A": a, "B": b}, {"m": m, "k": k, "n": n}


def sparse_workload(n: int, nnz: int, seed: int = 2):
    """Gamma's operands at ``n`` x ``n`` with ``nnz`` seeded nonzeros
    each (uniform positions, values in [0.5, 1.5)), as fibertrees in
    Gamma's stored rank order: a paper-sized workload built without its
    dense arrays."""
    spec = REGISTRY["gamma"]()
    rng = np.random.default_rng(seed)
    inputs = {}
    for name, decl in spec.einsum.declaration.items():
        if name in spec.einsum.cascade_outputs:
            continue
        order = spec.mapping.rank_order.get(name) or decl
        idx = rng.choice(n * n, size=nnz, replace=False)
        pts = np.stack([idx // n, idx % n], axis=1)
        perm = [decl.index(r) for r in order]
        vals = rng.random(nnz) + 0.5
        inputs[name] = CSF.from_coo(name, order, pts[:, perm], vals,
                                    {r: n for r in order}).to_ftensor()
    return inputs, {v: n for v in "mkn"}


def timed_sweeps(eng: SweepEngine, points, repeats: int,
                 **sweep_kw) -> Tuple[List, List[float]]:
    """``repeats`` sweeps of ``points`` on ``eng``: the last sweep's
    results and each sweep's seconds."""
    seconds = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        results = eng.sweep(points, **sweep_kw)
        seconds.append(time.perf_counter() - t0)
    return results, seconds


def fibercache_space(capacities: Sequence[float]) -> DesignSpace:
    return DesignSpace("gamma", axes={"fibercache_mb": list(capacities)})


def _measure(backend: str, capacities: Sequence[float], inputs, shapes,
             device: Optional[torch.device] = None,
             engine_kw: Optional[Dict] = None,
             sweep_kw: Optional[Dict] = None) -> Dict:
    points = fibercache_space(capacities).grid()
    eng = SweepEngine(inputs, shapes, backend=backend,
                      device=device if backend == "vector" else None,
                      **(engine_kw or {}))
    # pay one-time setup (operand conversion, plan lowering,
    # calibration, kernel builds) outside the timed region: the record
    # measures the steady-state sweep rate a service would observe
    if points:
        eng.prime(points[0])
        # not under fault injection: a warmup sweep must not consume
        # the chaos schedule the timed sweep is meant to exercise
        if backend == "analytic" and active_injector() is None:
            eng.sweep(points[:2])
    if backend == "vector" and device is not None and device.type == "cuda":
        build.build(("search", "merge_path", "multi_merge"))
    # a chaos or checkpointed sweep runs once: a repeat would restore
    # its points or replay its fault schedule
    repeats = ANALYTIC_REPEATS if backend == "analytic" and not sweep_kw \
        and active_injector() is None else 1
    for k in KERNELS:
        k.launches = 0
    results, seconds = timed_sweeps(eng, points, repeats,
                                    **(sweep_kw or {}))
    dt = statistics.median(seconds)
    launches = {k.__name__: k.launches for k in KERNELS}
    ok = [r for r in results if r.ok]
    if len(ok) != len(points) and active_injector() is None:
        # a chaos run legitimately reports a partial front + coverage
        raise AssertionError([r.error for r in results if not r.ok])
    front = pareto_front(ok)
    rec = {
        "backend": backend,
        "points": len(points),
        "seconds": round(dt, 4),
        "points_per_sec": round(len(points) / dt, 3) if dt else 0.0,
        "sweeps": repeats,
        "points_per_sec_range": [round(len(points) / max(seconds), 3),
                                 round(len(points) / min(seconds), 3)],
        "pareto_points": [r.label for r in front],
        "traffic_range_kb": [round(min(r.dram_bytes for r in ok) / 1e3, 1),
                             round(max(r.dram_bytes for r in ok) / 1e3, 1)]
        if ok else [0.0, 0.0],
        "fallbacks": sum(1 for r in ok if r.fallback_reasons),
        "coverage": dict(eng.last_coverage),
        "summary": SweepEngine.summarize(results),
    }
    if backend == "vector":
        rec["device"] = str(eng.device)
        rec["launches"] = launches
        if rec["fallbacks"]:
            raise AssertionError(f"vector points fell back: "
                                 f"{[r.fallback_reasons for r in ok]}")
    return rec


def bench(capacities: Optional[Sequence[float]] = None,
          backends: Sequence[str] = BACKENDS,
          exec_capacities: Optional[Sequence[float]] = None, device=None,
          engine_kw: Optional[Dict] = None,
          sweep_kw: Optional[Dict] = None,
          size: Optional[Tuple[int, int]] = None) -> Dict:
    """The sweep on each of ``backends``: the analytic one over every
    capacity, the execution ones over ``exec_capacities`` (the first
    ``EXEC_MAX_POINTS`` capacities unless given).  ``device`` is where a
    'vector' sweep runs its seams (the CUDA device unless named).  The
    workload is the reference's 96^3 one, or ``sparse_workload(*size)``
    when ``size`` (rows = cols, nonzeros per operand) is given."""
    capacities = list(capacities or CAPACITIES_MB)
    if exec_capacities is None:
        exec_capacities = capacities[:EXEC_MAX_POINTS]
    inputs, shapes = workload() if size is None else sparse_workload(*size)
    dev = resolve_device(device) if "vector" in backends else None
    out: Dict = {"workload": "gamma-fibercache-sweep",
                 "size": ({"m": 96, "k": 96, "n": 96, "density": 0.12}
                          if size is None else
                          {"m": size[0], "k": size[0], "n": size[0],
                           "nnz_per_operand": size[1]}),
                 "sweep_axis": {"fibercache_mb": capacities},
                 "metric": "sweep points per second",
                 "device": str(dev) if dev is not None else "host",
                 "records": []}
    for bk in backends:
        caps = capacities if bk == "analytic" else list(exec_capacities)
        out["records"].append(_measure(bk, caps, inputs, shapes, dev,
                                       engine_kw=engine_kw,
                                       sweep_kw=sweep_kw))
    by = {r["backend"]: r for r in out["records"]}
    if "analytic" in by:
        out["analytic_rate"] = by["analytic"]["points_per_sec"]
    for bk in ("vector", "python"):
        if "analytic" in by and bk in by:
            rate = by[bk]["points_per_sec"]
            out[f"{bk}_rate"] = rate
            out[f"speedup_analytic_over_{bk}"] = round(
                by["analytic"]["points_per_sec"] / rate, 1) if rate else 0.0
    return out


SCALE_POINTS = 256


def scale_capacities(n: int = SCALE_POINTS) -> List[float]:
    """A dense ``n``-point FiberCache capacity axis (geometric, same
    0.001..6 MB range as ``CAPACITIES_MB``)."""
    return [round(float(c), 6) for c in np.geomspace(0.001, 6.0, n)]


def scale_bench(n_points: int = SCALE_POINTS,
                workers: Tuple[int, ...] = (1, 2, 4),
                size: Optional[Tuple[int, int]] = None) -> Dict:
    """Production-scale records of the analytic backend: a >=256-point
    axis through the batched evaluator, repeat-query serving from the
    result cache, and the process-pool worker-count series (each worker
    pays its own setup -- the series reports end-to-end sharded rates,
    not marginal ones).  ``size`` picks the workload as in ``bench``."""
    from repro_torch.dse import ResultCache

    inputs, shapes = workload() if size is None else sparse_workload(*size)
    points = fibercache_space(scale_capacities(n_points)).grid()
    out: Dict = {"points": len(points)}

    cache = ResultCache(capacity=2 * n_points)
    eng = SweepEngine(inputs, shapes, backend="analytic",
                      result_cache=cache)
    eng.prime(points[0])
    eng.sweep(points[:2])
    t0 = time.perf_counter()
    first = eng.sweep(points)
    dt = time.perf_counter() - t0
    if not all(r.ok for r in first):
        raise AssertionError([r.error for r in first if not r.ok])
    out["batched_rate"] = round(len(points) / dt, 1)

    t0 = time.perf_counter()
    again = eng.sweep(points)
    dt = time.perf_counter() - t0
    if not all(r.cached for r in again):
        raise AssertionError("repeat sweep missed the result cache")
    out["cache_hit_rate"] = round(len(points) / dt, 1)
    out["cache"] = cache.stats()

    out["worker_scaling"] = []
    for w in workers:
        eng_w = SweepEngine(inputs, shapes, backend="analytic",
                            executor="process", max_workers=w)
        eng_w.prime(points[0])
        if w == 1:
            eng_w.sweep(points[:2])       # in-process baseline, warmed
        t0 = time.perf_counter()
        res = eng_w.sweep(points)
        dt = time.perf_counter() - t0
        if not all(r.ok for r in res):
            raise AssertionError([r.error for r in res if not r.ok])
        out["worker_scaling"].append(
            {"workers": w, "points_per_sec": round(len(points) / dt, 1)})
    return out


def run(backend: str = "vector", smoke: bool = False, device=None) -> Rows:
    """``bench.run``'s entry point: the analytic sweep and ``backend``'s
    prefix (one point with ``smoke``), as CSV rows (name, us, derived:
    points/sec, or the analytic speedup)."""
    caps = SMOKE_CAPACITIES_MB if smoke else CAPACITIES_MB
    backends = ("analytic",) if backend == "analytic" \
        else ("analytic", backend)
    summary = bench(capacities=caps, backends=backends,
                    exec_capacities=caps[:1 if smoke else EXEC_MAX_POINTS],
                    device=device)
    rows = [(f"dse/{r['backend']}/points{r['points']}",
             r["seconds"] * 1e6, r["points_per_sec"])
            for r in summary["records"]]
    if f"speedup_analytic_over_{backend}" in summary:
        rows.append((f"dse/speedup_analytic_over_{backend}", 0.0,
                     summary[f"speedup_analytic_over_{backend}"]))
    return rows


def record(summary: Dict, path: Path = BENCH_JSON) -> None:
    """Write ``summary`` under the ``dse`` key of ``path``, keeping its
    other keys; only a run whose vector sweep ran on the card is
    recorded."""
    if not summary["device"].startswith("cuda"):
        raise ValueError(f"{path.name} records card runs only, not a run "
                         f"on {summary['device']}")
    data = json.loads(path.read_text()) if path.exists() else {}
    data["dse"] = dict(summary, card=torch.cuda.get_device_name(0))
    path.write_text(json.dumps(data, indent=2) + "\n")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--record", action="store_true",
                    help=f"measure the paper-sized workload (Gamma "
                    f"{RECORD_SIZE[0]}^2, {RECORD_SIZE[1]} nonzeros per "
                    f"operand; analytic and vector backends) and write "
                    f"the summary into {BENCH_JSON.name} (card runs only)")
    ap.add_argument("--backend", default="all",
                    choices=list(BACKENDS) + ["all"])
    ap.add_argument("--device", default=None,
                    help="torch device of the vector sweep's seams "
                    "(default: the CUDA device)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--checkpoint", type=str, default=None,
                    metavar="DIR",
                    help="checkpoint completed sweep points to DIR "
                    "(atomic, periodic); an interrupted sweep can be "
                    "finished with --resume")
    ap.add_argument("--checkpoint-every", type=int, default=4,
                    help="save every N completed points")
    ap.add_argument("--resume", action="store_true",
                    help="restore completed points from --checkpoint "
                    "instead of re-evaluating them")
    ap.add_argument("--point-timeout-s", type=float, default=None,
                    help="per-point wall-clock budget; a point past it "
                    "is recorded as timed out and the sweep proceeds")
    ap.add_argument("--point-retries", type=int, default=0,
                    help="bounded re-evaluations of a failed point")
    ap.add_argument("--scale", action="store_true",
                    help=f"also run the production-scale records "
                    f"({SCALE_POINTS}-point analytic axis, cache-hit "
                    f"serving, worker scaling); implied by --record")
    ap.add_argument("--trace", type=str, default=None, metavar="OUT",
                    help="write a Perfetto-loadable Chrome trace "
                         "(*.jsonl for the structured event log) of "
                         "the sweep (one span per point)")
    args = ap.parse_args(argv)
    if args.resume and not args.checkpoint:
        ap.error("--resume requires --checkpoint DIR")
    if args.record and (args.smoke or args.backend != "all"):
        ap.error("--record measures its own workload and backends: "
                 "give it neither --smoke nor --backend")
    caps = SMOKE_CAPACITIES_MB if args.smoke else CAPACITIES_MB
    backends = BACKENDS if args.backend == "all" else (args.backend,)
    size = exec_caps = None
    if args.record:
        backends, size, exec_caps = (("analytic", "vector"), RECORD_SIZE,
                                     RECORD_VECTOR_CAPS)
    engine_kw = {"point_timeout_s": args.point_timeout_s,
                 "point_retries": args.point_retries}
    sweep_kw = {}
    if args.checkpoint:
        sweep_kw = {"checkpoint_dir": args.checkpoint,
                    "checkpoint_every": args.checkpoint_every,
                    "resume": args.resume}
    from repro_torch.obs.export import cli_trace
    with cli_trace(args.trace):
        summary = bench(capacities=caps, backends=backends,
                        exec_capacities=exec_caps, device=args.device,
                        engine_kw=engine_kw, sweep_kw=sweep_kw, size=size)
        if (args.scale or args.record) and not args.smoke:
            summary["scale"] = scale_bench(size=size)
    print(json.dumps(summary, indent=2))
    if args.record:
        record(summary)
        print(f"wrote {BENCH_JSON}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
