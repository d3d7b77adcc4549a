"""Benchmark harness of the port -- one module per paper table/figure
(``benchmarks/run.py``, the reference's harness).

    python -m repro_torch.bench.run [--only table1,fig9,fig10,fig11,fig13,
                                            table2,kernels,roofline,
                                            backend,dse]
                                    [--backend python|vector|analytic|both]
                                    [--smoke] [--device cpu]
                                    [--explain-fallbacks] [--trace OUT]

Prints ``name,us_per_call,derived`` CSV rows (us_per_call is the host
wall time of the modeled run where meaningful; ``derived`` is the
figure's metric: normalized traffic, modeled seconds, error %, speedup,
leaf multiplies per second, a 1.0/0.0 claim check, or a kernel's largest
error against its oracle).

What runs where: the paper's validation studies (table1, fig9, fig10,
fig11) run on the interpreter, on the host, as the reference's do (the
path-exact residency model needs it; see ``fig9_memory_traffic``);
fig13, table2, dse and backend run the vector path with its seams on the
CUDA device unless ``--device`` names another, and kernels runs the hand
kernels there; roofline reads the dry run's records (``launch/dryrun.py``)
on the host.  The run needs a card unless ``--device`` is given.

``--backend`` selects the execution engine of the benchmarks that thread
it through: backend (vector by default; python, analytic and both, which
runs the vector path and the interpreter, are for this entry only),
fig13, table2 and dse (python or vector; dse also analytic); the four
studies take none.  ``--smoke`` runs fig13, backend and dse at their
smoke sizes; ``--trace OUT`` writes a Perfetto-loadable Chrome trace
(``*.jsonl``: the structured event log) of every benchmark in the run;
``--explain-fallbacks`` runs every accelerator design (the graph designs
under BFS and SSSP) and zoo cascade on small inputs through the selected
backend (default vector) and prints the per-Einsum ``fallback_reasons``.
On the card a plan the vector path cannot run raises rather than falls
back; such an error counts as a fallback, and any fallback makes the run
exit 1.  A benchmark that raises, a failed claim row of a study
(``STUDY_CLAIMS``), a kernel row past its oracle limit, a failed gated
Fig-13 claim or fallback (``fig13_vcp.GATED_CLAIMS``, ``all_native``) and
a Table-2 cascade that does not validate make the run exit 1 as well.
"""
from __future__ import annotations

import argparse
import importlib
import sys
import time
import traceback
from typing import Callable, Dict, List, Tuple

Rows = List[Tuple[str, float, float]]


def explain_fallbacks(backend: str, device=None) -> int:
    """Print ``cascade,einsum,reason`` for every Einsum the selected
    backend routed through the interpreter, and an ``ERROR`` row for
    every run that raised; returns the number of both across accelerator
    designs, graph designs and zoo cascades (0 = full native
    coverage)."""
    import numpy as np

    from repro_torch.accelerators import DEFAULT_PARAMS, REGISTRY, simulate
    from repro_torch.accelerators.zoo import ZOO
    from repro_torch.bench.table2_zoo import _inputs
    from repro_torch.bench.workloads import grid_graph
    from repro_torch.core.einsum import Semiring
    from repro_torch.core.generator import CascadeSimulator
    from repro_torch.core.vectorized import VectorBackend
    from repro_torch.kernels.backends import resolve_device

    device = resolve_device(device)

    def engine():
        return VectorBackend(device=device) if backend == "vector" \
            else backend

    rng = np.random.default_rng(0)
    a = rng.random((24, 24)) * (rng.random((24, 24)) < 0.2)
    b = rng.random((24, 24)) * (rng.random((24, 24)) < 0.2)
    shapes = {"m": 24, "k": 24, "n": 24}
    print("cascade,einsum,reason")
    n_fallbacks = 0

    def report(name, run: Callable):
        nonlocal n_fallbacks
        try:
            res = run()
        except Exception as e:
            # on the card an inadmissible plan or a kernel fault raises:
            # counted, never passed
            print(f"{name},-,ERROR: {type(e).__name__}: {e}")
            n_fallbacks += 1
            return
        # seam faults the guarded dispatch recorded; on the card each
        # also raised above
        for einsum, evs in sorted(res.downgrade_events.items()):
            for ev in evs:
                arrow = f"->{ev.fallback}" if ev.fallback else ""
                print(f"{name},{einsum},DOWNGRADE {ev.action} "
                      f"{ev.seam}@{ev.backend}{arrow}: {ev.exc_type}")
        if not res.fallback_reasons:
            print(f"{name},-,native")
            return
        for einsum, reason in sorted(res.fallback_reasons.items()):
            n_fallbacks += 1
            print(f"{name},{einsum},{reason}")

    graph_designs = [n for n in REGISTRY
                     if n.startswith("graph") or n == "ours-vcp"]
    for name in sorted(REGISTRY):
        if name in graph_designs:
            continue                 # graph designs need graph inputs
        report(name, lambda: simulate(
            name, {"A": a, "B": b}, shapes,
            params=DEFAULT_PARAMS.get(name), backend=engine(),
            model=False))

    # graph designs: one BFS (unweighted) + one SSSP (weighted) pass
    # under the min-plus semiring on a small grid frontier
    adj_w = grid_graph(6, extra=6, weighted=True)
    adj_u = grid_graph(6, extra=6, weighted=False)
    v = adj_w.shape[0]
    a0 = np.zeros(v)
    a0[0] = 1.0
    p0 = np.zeros(v)
    p0[0] = 1.0
    for name in sorted(graph_designs):
        for algo, adj in (("bfs", adj_u), ("sssp", adj_w)):
            kw = {"n_vertices": v} if name == "graphdyns" else {}
            report(f"{name}/{algo}", lambda: simulate(
                name, {"G": adj, "A0": a0, "P0": p0}, {"d": v, "s": v},
                backend=engine(), model=False,
                semiring=Semiring.min_plus(), weighted=(algo == "sssp"),
                **kw))

    for name in sorted(ZOO):
        inputs, shp = _inputs(name, np.random.default_rng(0))
        report(name, lambda: CascadeSimulator(
            ZOO[name](), model=False, backend=engine()).run(dict(inputs),
                                                              shp))
    if n_fallbacks == 0:
        print("# full native coverage", file=sys.stderr)
    return n_fallbacks


def _failed_claims(rows: Rows, claims: Dict[str, float]) -> None:
    """Raise when a claim row reads below its least value in ``claims``
    (a 1.0/0.0 check: reads 0.0), so that the run counts a failed claim
    as a failed benchmark."""
    failed = [(name, value) for name, _, value in rows
              if name in claims and not value >= claims[name]]
    if failed:
        raise AssertionError(f"claims failed: {failed}")


#: Fig. 11's claim row is a correlation, not a 1.0/0.0 check: energy
#: tracks DRAM traffic when their correlation over the five matrices is
#: at least this (the paper validates energy within 7.8%; the port and
#: the reference read 0.999 at full size)
FIG11_MIN_CORR = 0.9

#: the paper's validation studies: module, and each claim row with the
#: least value it must read
STUDY_CLAIMS: Dict[str, Tuple[str, Dict[str, float]]] = {
    "table1": ("table1_designs",
               {"table1/claim/all_designs_agree_functionally": 1.0}),
    "fig9": ("fig9_memory_traffic", {"fig9/claim/traffic>=algmin": 1.0,
                                     "fig9/claim/gamma<=outerspace": 1.0}),
    "fig10": ("fig10_performance",
              {"fig10/claim/analytical_worse_on_skew": 1.0}),
    "fig11": ("fig11_energy",
              {"fig11/claim/energy_tracks_traffic_corr": FIG11_MIN_CORR}),
}


def _study(name: str) -> Callable[[bool, str, object], Rows]:
    """The runner entry of a study: the interpreter on the host, so it
    takes neither ``--backend`` nor a device; a claim row below its
    least value fails it."""
    module, claims = STUDY_CLAIMS[name]

    def entry(smoke: bool, backend: str, device) -> Rows:
        rows = importlib.import_module(f"repro_torch.bench.{module}").run()
        _failed_claims(rows, claims)
        return rows
    return entry


def _vector_or_python(backend: str) -> str:
    """fig13 and table2 take python or vector; 'analytic' and 'both'
    leave them on vector, their default."""
    return backend if backend in ("python", "vector") else "vector"


def _fig13(smoke: bool, backend: str, device) -> Rows:
    from repro_torch.bench import fig13_vcp
    rows = fig13_vcp.run(smoke=smoke, backend=_vector_or_python(backend),
                         device=device)
    _failed_claims(rows, dict.fromkeys(
        [f"fig13/claim/{c}" for c in fig13_vcp.GATED_CLAIMS + ("all_native",)],
        1.0))
    return rows


def _table2(smoke: bool, backend: str, device) -> Rows:
    from repro_torch.bench import table2_zoo
    rows = table2_zoo.run(backend=_vector_or_python(backend), device=device)
    _failed_claims(rows, {"table2/claim/all_cascades_validate": 1.0})
    return rows


def _dse(smoke: bool, backend: str, device) -> Rows:
    from repro_torch.bench import dse_sweep
    return dse_sweep.run(backend="vector" if backend == "both" else backend,
                         smoke=smoke, device=device)


def _backend(smoke: bool, backend: str, device) -> Rows:
    from repro_torch.bench import backend_throughput
    return backend_throughput.run(backend=backend, smoke=smoke,
                                  device=device)


def _kernels(smoke: bool, backend: str, device) -> Rows:
    from repro_torch.bench import kernels_bench
    rows = kernels_bench.run(device)
    bad = [(r.name, r.err, r.limit) for r in rows if not r.err <= r.limit]
    if bad:
        raise AssertionError(f"kernel rows past their oracle limit "
                             f"(name, err, limit): {bad}")
    return [(r.name, r.us_per_call, r.err) for r in rows]


def _roofline(smoke: bool, backend: str, device) -> Rows:
    from repro_torch.bench import roofline_lm
    return roofline_lm.run()


#: the benchmarks the port has, in the reference's order
BENCHES: Dict[str, Callable[[bool, str, object], Rows]] = {
    **{name: _study(name) for name in STUDY_CLAIMS},
    "fig13": _fig13,
    "table2": _table2,
    "kernels": _kernels,
    "roofline": _roofline,
    "backend": _backend,
    "dse": _dse,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Benchmark harness of the port.")
    ap.add_argument("--only", type=str, default=None,
                    help="comma-separated subset of: " + ",".join(BENCHES))
    ap.add_argument("--backend", type=str, default="vector",
                    choices=["python", "vector", "analytic", "both"],
                    help="execution backend for backend, fig13, table2 "
                    "and dse (analytic and both: backend and dse only)")
    ap.add_argument("--smoke", action="store_true",
                    help="fig13, backend and dse at their smoke sizes")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--explain-fallbacks", action="store_true",
                    help="print per-Einsum fallback_reasons for every "
                    "accelerator and zoo cascade, then exit (1 on any "
                    "fallback or error)")
    ap.add_argument("--trace", type=str, default=None, metavar="OUT",
                    help="write a Perfetto-loadable Chrome trace "
                    "(*.jsonl for the structured event log) covering "
                    "every benchmark in the run")
    args = ap.parse_args(argv)
    from repro_torch.kernels.backends import resolve_device
    device = resolve_device(args.device)
    if args.explain_fallbacks:
        return 1 if explain_fallbacks(_vector_or_python(args.backend),
                                      device) else 0
    names = args.only.split(",") if args.only else list(BENCHES)
    unknown = [n for n in names if n not in BENCHES]
    if unknown:
        ap.error(f"unknown benchmarks {unknown}; the port has "
                 f"{list(BENCHES)}")
    from repro_torch.obs.export import cli_trace
    print("name,us_per_call,derived")
    failures = 0
    with cli_trace(args.trace):
        for name in names:
            t0 = time.time()
            try:
                for rname, us, derived in BENCHES[name](
                        args.smoke, args.backend, device):
                    print(f"{rname},{us:.1f},{derived}")
                print(f"# {name} done in {time.time() - t0:.1f}s",
                      file=sys.stderr)
            except Exception:
                failures += 1
                traceback.print_exc()
                print(f"{name}/FAILED,0.0,0.0")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
