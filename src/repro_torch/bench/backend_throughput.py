"""Simulator-throughput benchmark of the port: elements/sec per execution
backend (``benchmarks/backend_throughput.py``, copied, with the vector
path's seams on a torch device).

    python -m repro_torch.bench.backend_throughput [--device cpu]
        [--backend python|vector|analytic|both] [--smoke] [--sizes N,..]
        [--profile] [--trace OUT] [--record]

Runs three SpMSpM mappings on synthetic uniform sparse matrices
through the execution backends and reports throughput as *leaf
multiply operations per second* -- the loop-nest work unit both
backends count identically (``compute mul`` actions):

  * ``rowwise``      unpartitioned Gustavson (zoo), up to 10k x 10k at
                     1% -- the legacy baseline series;
  * ``flattened``    SIGMA-style mapping: K shape-split, (M, K0)
                     flattened, MK0 occupancy-split, output ranks bound
                     at the leaf -- runs through the vector path's CSF
                     transform pre-pass;
  * ``partitioned``  OuterSPACE/Gamma-style double occupancy split of
                     M and K.

The Python interpreter is capped at ``PY_MAX_SIZE`` (its rate is flat
in problem size, so the cap does not flatter it); the vector backend
runs every size through ``VectorBackend.execute_csf`` -- columnar in,
columnar out, no per-element Python objects on the hot path.

The vector runs put their seams on the CUDA device unless ``device``
(``--device``) names another, and raise without one; the interpreter
and the analytic backend are host work.  On a CUDA device the clock
stops after ``torch.cuda.synchronize()``.  Beside the reference's keys a
vector record carries its device, the seam lowering that ran
(``cuda``: the hand kernels; ``torch``: their plain versions), the
kernel launches of one run and ``out_sha256``, a digest of the output
CSF's arrays (equal digests: equal outputs).

``--record`` writes the summary under the ``backend`` key of
``BENCH_torch.json`` with the card's name, from a card run only; the
file's other keys (``kernel_rates`` among them, see ``kernels_bench``)
stay.  ``BENCH_backend.json`` stays the reference's CPU record.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import gc
import hashlib
import json
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.accelerators.zoo import rowwise_spmspm
from repro_torch.core.csf import CSF
from repro_torch.core.iteration import PythonBackend
from repro_torch.core.mapping import MappingResolver
from repro_torch.core.spec import AcceleratorSpec, load_spec
from repro_torch.core.trace import CollectingInstr
from repro_torch.core.vectorized import VectorBackend
from repro_torch.kernels import KERNELS
from repro_torch.kernels.backends import resolve_device
from repro_torch.obs.spans import trace_session

SIZES = [1024, 4096, 10000]
MAPPED_SIZES = [1024, 4096]          # flattened/partitioned series
SMOKE_SIZES = [256]
DENSITY = 0.01
PY_MAX_SIZE = 1024
ROOT = Path(__file__).resolve().parents[3]
#: the port's record, written from card runs only
BENCH_JSON = ROOT / "BENCH_torch.json"


def flattened_spmspm(k_tile: int = 128,
                     stationary: int = 4096) -> AcceleratorSpec:
    """SIGMA-style flattened mapping of plain SpMSpM: K shape-split at
    the FlexDPE granularity, (M, K0) flattened, the flattened nonzeros
    occupancy-distributed; Z's coordinates are recovered from index-var
    bindings at the leaf (no loop rank matches an output rank)."""
    return load_spec({
        "name": "Flattened-SpMSpM",
        "einsum": {
            "declaration": {
                "A": ["K", "M"],
                "B": ["K", "N"],
                "Z": ["M", "N"],
            },
            "expressions": ["Z[m, n] = A[k, m] * B[k, n]"],
        },
        "mapping": {
            "rank-order": {"A": ["K", "M"], "B": ["K", "N"],
                           "Z": ["M", "N"]},
            "partitioning": {
                "Z": {
                    "K": [f"uniform_shape({k_tile})"],
                    "(M, K0)": ["flatten()"],
                    "MK0": [f"uniform_occupancy(A.{stationary})"],
                },
            },
            "loop-order": {"Z": ["K1", "MK01", "MK00", "N"]},
        },
    })


def partitioned_spmspm(rows: int = 128,
                       k_tile: int = 256) -> AcceleratorSpec:
    """OuterSPACE/Gamma-style partitioned mapping of plain SpMSpM:
    rows of A occupancy-cycled, K occupancy-split per row batch; B is
    fetched by coordinate (leader-follower boundaries are per-fiber, so
    B stays unpartitioned and co-iterates at K0)."""
    return load_spec({
        "name": "Partitioned-SpMSpM",
        "einsum": {
            "declaration": {
                "A": ["M", "K"],
                "B": ["K", "N"],
                "Z": ["M", "N"],
            },
            "expressions": ["Z[m, n] = A[m, k] * B[k, n]"],
        },
        "mapping": {
            "partitioning": {
                "Z": {
                    "M": [f"uniform_occupancy(A.{rows})"],
                    "K": [f"uniform_occupancy(A.{k_tile})"],
                },
            },
            "loop-order": {"Z": ["M1", "M0", "K1", "K0", "N"]},
        },
    })


MAPPED_WORKLOADS = {
    "flattened": (flattened_spmspm, ["K", "M"]),
    "partitioned": (partitioned_spmspm, ["M", "K"]),
}


def synth_csf(n: int, density: float, seed: int, name: str,
              ranks: List[str]) -> CSF:
    """Uniform random n x n sparse matrix, built columnar (no dense
    intermediate, so 10k x 10k stays cheap)."""
    rng = np.random.default_rng(seed)
    nnz = int(n * n * density)
    flat = np.unique(rng.integers(0, n * n, size=int(nnz * 1.03)))
    rng.shuffle(flat)
    flat = np.sort(flat[:nnz])
    pts = np.stack([flat // n, flat % n], axis=1)
    vals = rng.random(len(pts)) + 0.1
    return CSF.from_coo(name, ranks, pts, vals, {r: n for r in ranks})


def csf_digest(c: CSF) -> str:
    """sha256 of a CSF's ranks and arrays (dtype, shape and bytes of
    every coordinate, segment and value array)."""
    h = hashlib.sha256(repr(c.ranks).encode())
    for arr in [*c.coords, *(s for s in c.segments if s is not None),
                c.values]:
        arr = np.ascontiguousarray(arr)
        h.update(f"{arr.dtype.str}{arr.shape}".encode())
        h.update(arr.data)
    return h.hexdigest()


def _trim_allocator() -> None:
    """Return freed arenas to the OS between reps.  A fragmented glibc
    heap makes large fresh allocations fault in 4k pages instead of
    huge pages, which can triple the wall time of the same columnar
    run -- measured 8s -> 21s on the 4096 rowwise workload."""
    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except Exception:
        pass


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _span_seconds(tr, cat: str) -> Dict[str, float]:
    secs: Dict[str, float] = {}
    for sp in tr.spans(cat=cat):
        name = sp["name"].split(":", 1)[1]
        secs[name] = secs.get(name, 0.0) + sp["dur"] / 1e6
    return secs


def _measure_vector(plan, a: CSF, b: CSF, device: torch.device,
                    reps: int = 3, kernel_backend=None,
                    trace: bool = False) -> Dict:
    """Best-of-``reps`` wall time: the work is deterministic, so the
    minimum is the least allocator- and page-fault-contaminated sample.
    Returns that run's seconds, multiplies, output nonzeros, launches,
    seam lowering and output digest; with ``trace``, also its engine
    stages' and seam calls' seconds (a tracer switches the stage timers
    on)."""
    best: Optional[Dict] = None
    for _ in range(reps):
        _trim_allocator()
        vb = VectorBackend(device=device, kernel_backend=kernel_backend)
        for k in KERNELS:
            k.launches = 0
        with trace_session() if trace else contextlib.nullcontext() as tr:
            t0 = time.perf_counter()
            out, stats = vb.execute_csf(plan, {"A": a, "B": b})
            _sync(device)
            dt = time.perf_counter() - t0
        if best is None or dt < best["seconds"]:
            best = {"seconds": dt, "elements": stats["muls"],
                    "out_nnz": stats["out_nnz"], "out": out,
                    "lowering": vb.kernels.name,
                    "launches": {k.__name__: k.launches for k in KERNELS}}
            if trace:
                best["stage_seconds"] = _span_seconds(tr, "stage")
                best["seam_seconds"] = _span_seconds(tr, "seam")
        del vb, out
    best["out_sha256"] = csf_digest(best.pop("out"))
    return best


def _measure_python(plan, a: CSF, b: CSF, n: int) -> Dict:
    fa, fb = a.to_ftensor(), b.to_ftensor()
    ci = CollectingInstr()
    t0 = time.perf_counter()
    out = PythonBackend().execute(plan, {"A": fa, "B": fb},
                                  {"m": n, "k": n, "n": n}, instr=ci)
    dt = time.perf_counter() - t0
    return {"seconds": dt, "elements": int(ci.compute_counts[("Z", "mul")]),
            "out_nnz": out.nnz}


def _measure_analytic(plan, a: CSF, b: CSF, n: int) -> Dict:
    """Modeled (not executed) multiplies per second of wall time: the
    calibration scan dominates, the propagation itself is closed-form."""
    from repro_torch.core.analytic import AnalyticBackend

    fa, fb = a.to_ftensor(), b.to_ftensor()
    ci = CollectingInstr()
    t0 = time.perf_counter()
    AnalyticBackend(fallback=False).execute(
        plan, {"A": fa, "B": fb}, {"m": n, "k": n, "n": n}, instr=ci)
    dt = time.perf_counter() - t0
    return {"seconds": dt, "elements": int(ci.compute_counts[("Z", "mul")]),
            "out_nnz": 0}


def _record(workload: str, backend: str, n: int, density: float, a: CSF,
            b: CSF, m: Dict, device: Optional[torch.device]) -> Dict:
    """The reference's record keys, then the port's (device, lowering,
    launches, digest, and traced seconds where measured)."""
    dt, muls = m.pop("seconds"), m.pop("elements")
    rec = {"workload": workload, "backend": backend, "size": n,
           "density": density, "nnz_a": a.nnz, "nnz_b": b.nnz,
           "out_nnz": m.pop("out_nnz"), "elements": muls,
           "seconds": round(dt, 4),
           "elements_per_sec": round(muls / dt, 1) if dt else 0.0}
    if backend == "vector":
        rec["device"] = str(device)
    rec.update(m)
    return rec


def bench(sizes: Optional[List[int]] = None, backend: str = "both",
          py_max_size: int = PY_MAX_SIZE, density: float = DENSITY,
          mapped_sizes: Optional[List[int]] = None, device=None,
          reps: int = 3, kernel_backend=None,
          trace: bool = False) -> List[Dict]:
    """Records of every (workload, backend, size).  The vector runs take
    ``VectorBackend(device=device, kernel_backend=kernel_backend)``
    (default: the CUDA device and its hand kernels; raises without a
    card unless ``device`` names another), each the best of ``reps``;
    ``trace`` adds their stage and seam seconds."""
    vector = backend in ("vector", "both")
    dev = resolve_device(device) if vector else None
    spec = rowwise_spmspm()
    plan = MappingResolver(spec).plan("Z")
    if vector:
        # kernel builds and first launches outside the timed region
        tiny = synth_csf(64, 0.05, 0, "A", ["M", "K"])
        tinyb = synth_csf(64, 0.05, 1, "B", ["K", "N"])
        VectorBackend(device=dev, kernel_backend=kernel_backend
                      ).execute_csf(plan, {"A": tiny, "B": tinyb})

    records: List[Dict] = []
    for n in (SIZES if sizes is None else sizes):
        a = synth_csf(n, density, 1, "A", ["M", "K"])
        b = synth_csf(n, density, 2, "B", ["K", "N"])
        runs = []
        if vector:
            runs.append(("vector", _measure_vector(
                plan, a, b, dev, reps, kernel_backend, trace)))
        if backend in ("python", "both") and n <= py_max_size:
            runs.append(("python", _measure_python(plan, a, b, n)))
        if backend == "analytic":
            runs.append(("analytic", _measure_analytic(plan, a, b, n)))
        for bname, m in runs:
            records.append(_record("rowwise", bname, n, density, a, b, m,
                                   dev))

    # flattened / partitioned mappings: vector path only (raw CSFs in,
    # the Section-3.2 transform pre-pass runs inside execute_csf)
    if vector:
        for wname, (factory, a_ranks) in MAPPED_WORKLOADS.items():
            mplan = MappingResolver(factory()).plan("Z")
            for n in (mapped_sizes if mapped_sizes is not None
                      else MAPPED_SIZES):
                a = synth_csf(n, density, 1, "A", a_ranks)
                b = synth_csf(n, density, 2, "B", ["K", "N"])
                m = _measure_vector(mplan, a, b, dev, reps, kernel_backend,
                                    trace)
                records.append(_record(wname, "vector", n, density, a, b, m,
                                       dev))
    return records


def summarize(records: List[Dict]) -> Dict:
    by = {}
    for r in records:
        if r.get("workload", "rowwise") == "rowwise":
            by.setdefault(r["backend"], []).append(r)
    workloads = sorted({r.get("workload", "rowwise") for r in records})
    out: Dict = {"workload": "spmspm",
                 "mappings": workloads,
                 "metric": "leaf multiplies per second",
                 "records": records}
    for wname in MAPPED_WORKLOADS:
        ws = [r for r in records
              if r.get("workload") == wname and r["backend"] == "vector"]
        if ws:
            best = max(ws, key=lambda r: r["size"])
            out[f"vector_rate_{wname}"] = best["elements_per_sec"]
            out[f"vector_rate_{wname}_measured_at"] = best["size"]
    if "python" in by and "vector" in by:
        py_best = max(by["python"], key=lambda r: r["size"])
        vec_best = max(by["vector"], key=lambda r: r["size"])
        out["python_rate"] = py_best["elements_per_sec"]
        out["python_measured_at"] = py_best["size"]
        out["vector_rate"] = vec_best["elements_per_sec"]
        out["vector_measured_at"] = vec_best["size"]
        # cross-size rate ratio: the interpreter is rate-capped (its
        # per-element cost is flat in problem size) and measured at its
        # feasible cap; same-size ratio below is the apples-to-apples one
        out["speedup"] = round(vec_best["elements_per_sec"]
                               / py_best["elements_per_sec"], 2)
        common = set(r["size"] for r in by["python"]) \
            & set(r["size"] for r in by["vector"])
        if common:
            n = max(common)
            pr = next(r for r in by["python"] if r["size"] == n)
            vr = next(r for r in by["vector"] if r["size"] == n)
            out["speedup_same_size"] = round(
                vr["elements_per_sec"] / pr["elements_per_sec"], 2)
            if pr["elements"] != vr["elements"]:
                raise AssertionError("backends disagree on work performed")
    return out


def run(backend: str = "both", smoke: bool = False, device=None
        ) -> List[Tuple[str, float, float]]:
    """``repro_torch.bench.run`` entry point: CSV rows (name, us,
    derived)."""
    sizes = SMOKE_SIZES if smoke else SIZES
    py_max = max(sizes) if smoke else PY_MAX_SIZE
    records = bench(sizes=sizes, backend=backend, py_max_size=py_max,
                    mapped_sizes=SMOKE_SIZES if smoke else None,
                    device=device)
    rows = []
    for r in records:
        rows.append((f"backend/{r['workload']}/{r['backend']}/n{r['size']}",
                     r["seconds"] * 1e6, r["elements_per_sec"]))
    summary = summarize(records)
    if "speedup" in summary:
        rows.append(("backend/speedup_vector_over_python", 0.0,
                     summary["speedup"]))
    return rows


def profile_stages(sizes: Optional[List[int]] = None, device=None) -> None:
    """Per-stage wall-time breakdown of the vector path (materialize /
    pair-merge / lookup / finalize / reduce / output-build) for each
    workload, from the backend's public ``stage_seconds`` accessor
    (the same dict ``SimResult.stage_seconds`` surfaces)."""
    dev = resolve_device(device)
    jobs: List[Tuple[str, object, List[str], int]] = []
    plan = MappingResolver(rowwise_spmspm()).plan("Z")
    for n in (sizes or [SIZES[-1]]):
        jobs.append(("rowwise", plan, ["M", "K"], n))
    for wname, (factory, a_ranks) in MAPPED_WORKLOADS.items():
        mplan = MappingResolver(factory()).plan("Z")
        for n in (sizes or [MAPPED_SIZES[-1]]):
            jobs.append((wname, mplan, a_ranks, n))
    for wname, plan_, a_ranks, n in jobs:
        a = synth_csf(n, DENSITY, 1, "A", a_ranks)
        b = synth_csf(n, DENSITY, 2, "B", ["K", "N"])
        vb = VectorBackend(profile=True, device=dev)
        vb.execute_csf(plan_, {"A": a, "B": b})      # warm
        _trim_allocator()
        t0 = time.perf_counter()
        _, stats = vb.execute_csf(plan_, {"A": a, "B": b})
        _sync(dev)
        wall = time.perf_counter() - t0
        stage_seconds = vb.stage_seconds
        staged = sum(stage_seconds.values())
        print(f"{wname} n={n} on {dev}: {wall:.3f}s wall, "
              f"{stats['muls'] / max(wall, 1e-9) / 1e6:.2f} M muls/s")
        for stage, dt in sorted(stage_seconds.items(),
                                key=lambda kv: -kv[1]):
            print(f"  {stage:<14} {dt:7.3f}s  {dt / wall * 100:5.1f}%")
        print(f"  {'(untracked)':<14} {wall - staged:7.3f}s  "
              f"{(wall - staged) / wall * 100:5.1f}%")


def record(summary: Dict, device: torch.device,
           path: Path = BENCH_JSON) -> None:
    """Write ``summary`` under the ``backend`` key of ``path``, keeping
    its other keys; only a run whose vector path ran on the card is
    recorded."""
    if device is None or device.type != "cuda":
        raise ValueError(f"{path.name} records card runs only, not a run "
                         f"on {device or 'the host'}")
    data = json.loads(path.read_text()) if path.exists() else {}
    data["backend"] = dict(summary, device=str(device),
                           card=torch.cuda.get_device_name(device))
    path.write_text(json.dumps(data, indent=2) + "\n")


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--record", action="store_true",
                    help=f"write the summary under the backend key of "
                         f"{BENCH_JSON.name} (card runs only)")
    ap.add_argument("--backend", default="both",
                    choices=["python", "vector", "analytic", "both"])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--sizes", type=str, default=None,
                    help="comma-separated sizes override")
    ap.add_argument("--profile", action="store_true",
                    help="print per-stage vector-path wall-time "
                         "breakdown instead of recording rates")
    ap.add_argument("--trace", type=str, default=None, metavar="OUT",
                    help="write a Perfetto-loadable Chrome trace "
                         "(*.jsonl for the structured event log) of "
                         "the benchmark run")
    ap.add_argument("--device", default=None,
                    help="torch device of the vector path's seams "
                         "(default: the CUDA device)")
    args = ap.parse_args(argv)
    sizes = ([int(s) for s in args.sizes.split(",")] if args.sizes
             else (SMOKE_SIZES if args.smoke else SIZES))
    if args.profile:
        profile_stages(sizes if args.sizes or args.smoke else None,
                       args.device)
        return
    dev = resolve_device(args.device) \
        if args.backend in ("vector", "both") else None
    if args.record and (dev is None or dev.type != "cuda"):
        ap.error(f"--record writes {BENCH_JSON.name} from a card run of "
                 f"the vector path only")
    from repro_torch.obs.export import cli_trace
    with cli_trace(args.trace):
        records = bench(sizes=sizes, backend=args.backend,
                        py_max_size=max(sizes) if args.smoke
                        else PY_MAX_SIZE,
                        mapped_sizes=SMOKE_SIZES if args.smoke else None,
                        device=dev)
    summary = summarize(records)
    print(json.dumps(summary, indent=2))
    if args.record:
        record(summary, dev)
        print(f"wrote {BENCH_JSON}")


if __name__ == "__main__":
    main()
