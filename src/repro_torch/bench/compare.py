"""Regression gate of the port: a fresh run against its committed record,
``BENCH_torch.json`` (``benchmarks/bench_compare.py``, copied, with every
leg against the port's record).

    python -m repro_torch.bench.compare [--device cpu] [--tolerance T]
                                        [--skip backend|dse|graph]
                                        [--trace OUT]

Three legs:

* **backend** -- re-runs ``backend_throughput.bench`` at the comparison
  size (1024, a committed full-run size, so fresh records diff directly
  against the ``backend`` records) and checks, per (workload, backend,
  size) record: work invariants (``elements`` / ``out_nnz`` / ``nnz_a``
  / ``nnz_b``, and the output digest ``out_sha256`` where both have one)
  **exactly**, and ``elements_per_sec`` one-sided -- a fresh rate below
  ``committed * (1 - tolerance)`` is a regression, a faster rate passes.
* **dse** -- re-runs the analytic capacity sweep at the committed
  record's size (it is closed-form and fast at full size) and checks
  ``points`` / ``pareto_points`` / ``traffic_range_kb`` exactly and
  ``analytic_rate`` one-sided.
* **graph** -- checks the committed ``fig13`` direction claims
  structurally (GraphDynS beats Graphicionado, ours beats GraphDynS on
  BFS) without re-running the multi-minute workload.

Rates depend on the machine: a rate is compared only with a record
whose ``card`` is the card this run measures on
(``torch.cuda.get_device_name``; ``cpu`` for a run on the CPU), and
otherwise prints ``skipped (card differs)``.  The vector runs take the
CUDA device unless ``--device`` names another.  Exit status is nonzero
on any regression; every comparison prints a ``key, committed, fresh,
verdict`` row.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels.backends import resolve_device

ROOT = Path(__file__).resolve().parents[3]
BENCH_JSON = ROOT / "BENCH_torch.json"

#: the size whose committed records the fresh run compares against --
#: large enough that rates are stable, small enough for CI
COMPARE_SIZE = 1024

#: work-count keys that must match bit-for-bit (the workload is seeded)
EXACT_KEYS = ("elements", "out_nnz", "nnz_a", "nnz_b", "out_sha256")


class Gate:
    """Collects comparison rows and the overall verdict."""

    def __init__(self) -> None:
        self.rows: List[Tuple[str, str, str, str]] = []
        self.failures = 0

    def check(self, key: str, committed, fresh, ok: bool) -> None:
        verdict = "ok" if ok else "REGRESSION"
        if not ok:
            self.failures += 1
        self.rows.append((key, str(committed), str(fresh), verdict))

    def rate(self, key: str, committed: float, fresh: float,
             tolerance: float) -> None:
        """One-sided: fresh below committed*(1-tol) fails."""
        self.check(key, round(committed, 1), round(fresh, 1),
                   fresh >= committed * (1.0 - tolerance))

    def exact(self, key: str, committed, fresh) -> None:
        self.check(key, committed, fresh, committed == fresh)

    def skip(self, key: str, why: str) -> None:
        self.rows.append((key, "-", "-", f"skipped ({why})"))

    def report(self) -> str:
        w = max((len(r[0]) for r in self.rows), default=10) + 2
        lines = [f"{'key':<{w}} {'committed':>14} {'fresh':>14} verdict"]
        for key, c, f, v in self.rows:
            lines.append(f"{key:<{w}} {c:>14} {f:>14} {v}")
        lines.append(f"# {self.failures} regression(s)"
                     if self.failures else "# all comparisons passed")
        return "\n".join(lines)


def card_name(device: torch.device) -> str:
    """The card a run on ``device`` measures on: its CUDA name, or
    ``cpu``."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"


# ---------------------------------------------------------------------- #
def compare_backend(gate: Gate, tolerance: float, committed: Dict,
                    card: str, device=None,
                    fresh_records: Optional[List[Dict]] = None) -> None:
    base_doc = committed.get("backend")
    if base_doc is None:
        gate.skip("backend", "no backend record")
        return
    base = {(r.get("workload", "rowwise"), r["backend"], r["size"]): r
            for r in base_doc.get("records", [])}
    wanted = [k for k in base if k[2] == COMPARE_SIZE]
    if not wanted:
        gate.skip("backend", f"no committed records at n={COMPARE_SIZE}")
        return
    if fresh_records is None:
        from repro_torch.bench.backend_throughput import bench
        fresh_records = bench(sizes=[COMPARE_SIZE], backend="both",
                              py_max_size=COMPARE_SIZE,
                              mapped_sizes=[COMPARE_SIZE], device=device)
    fresh = {(r.get("workload", "rowwise"), r["backend"], r["size"]): r
             for r in fresh_records}
    same_card = base_doc.get("card") == card
    for key in sorted(wanted):
        label = f"backend/{key[0]}/{key[1]}/n{key[2]}"
        fr = fresh.get(key)
        if fr is None:
            gate.check(label, "present", "missing", False)
            continue
        for field in EXACT_KEYS:
            if field in base[key] or field in fr:
                gate.exact(f"{label}/{field}", base[key].get(field),
                           fr.get(field))
        if same_card:
            gate.rate(f"{label}/elements_per_sec",
                      base[key]["elements_per_sec"],
                      fr["elements_per_sec"], tolerance)
        else:
            gate.skip(f"{label}/elements_per_sec", "card differs")


def compare_dse(gate: Gate, tolerance: float, committed: Dict, card: str,
                fresh_summary: Optional[Dict] = None) -> None:
    base_doc = committed.get("dse")
    if base_doc is None:
        gate.skip("dse", "no dse record")
        return
    if fresh_summary is None:
        from repro_torch.bench import dse_sweep
        size = base_doc["size"]
        fresh_summary = dse_sweep.bench(
            capacities=base_doc["sweep_axis"]["fibercache_mb"],
            backends=("analytic",),
            size=(size["m"], size["nnz_per_operand"])
            if "nnz_per_operand" in size else None)
    base_rec = next((r for r in base_doc.get("records", [])
                     if r["backend"] == "analytic"), None)
    fresh_rec = next((r for r in fresh_summary.get("records", [])
                      if r["backend"] == "analytic"), None)
    if base_rec is None or fresh_rec is None:
        gate.skip("dse", "no analytic record to compare")
        return
    for field in ("points", "pareto_points", "traffic_range_kb"):
        gate.exact(f"dse/analytic/{field}", base_rec[field],
                   fresh_rec[field])
    if base_doc.get("card") == card:
        gate.rate("dse/analytic_rate", base_doc.get("analytic_rate", 0.0),
                  fresh_summary.get("analytic_rate", 0.0), tolerance)
    else:
        gate.skip("dse/analytic_rate", "card differs")


def compare_graph(gate: Gate, committed: Dict) -> None:
    """Structural Fig-13 direction claims on the committed record (the
    graph workload is minutes-long; re-running it is
    ``fig13_vcp --check``'s job, not this gate's)."""
    base_doc = committed.get("fig13")
    if base_doc is None:
        gate.skip("graph", "no fig13 record")
        return
    runs = base_doc.get("runs", {})

    def seconds(key: str) -> float:
        return runs.get(key, {}).get("modeled_seconds", float("nan"))

    gate.check("graph/bfs/graphdyns_beats_graphicionado",
               round(seconds("bfs/graphicionado"), 6),
               round(seconds("bfs/graphdyns"), 6),
               seconds("bfs/graphdyns") < seconds("bfs/graphicionado"))
    gate.check("graph/bfs/ours_beats_graphdyns",
               round(seconds("bfs/graphdyns"), 6),
               round(seconds("bfs/ours"), 6),
               seconds("bfs/ours") < seconds("bfs/graphdyns"))
    claims = base_doc.get("claims", {})
    for claim in ("graphdyns_beats_graphicionado",
                  "ours_beats_graphdyns_bfs"):
        gate.exact(f"graph/claims/{claim}", True, bool(claims.get(claim)))


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tolerance", type=float, default=0.25,
                    help="allowed one-sided fractional rate drop "
                         "before a comparison fails (default 0.25)")
    ap.add_argument("--skip", action="append", default=[],
                    choices=["backend", "dse", "graph"],
                    help="drop a comparison leg (repeatable)")
    ap.add_argument("--device", default=None,
                    help="torch device of the vector runs (default: the "
                         "CUDA device)")
    ap.add_argument("--trace", type=str, default=None, metavar="OUT",
                    help="write a Perfetto-loadable Chrome trace of "
                         "the fresh comparison runs")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    card = card_name(device)
    committed = json.loads(BENCH_JSON.read_text()) \
        if BENCH_JSON.exists() else {}
    gate = Gate()
    from repro_torch.obs.export import cli_trace
    with cli_trace(args.trace):
        if "backend" not in args.skip:
            compare_backend(gate, args.tolerance, committed, card, device)
        if "dse" not in args.skip:
            compare_dse(gate, args.tolerance, committed, card)
        if "graph" not in args.skip:
            compare_graph(gate, committed)
    print(gate.report())
    return 1 if gate.failures else 0


if __name__ == "__main__":
    sys.exit(main())
