"""The port's graph designs (paper Sec. 8) against the reference.

Graphicionado, GraphDynS and Ours-VCP run BFS and SSSP under the
min-plus semiring through the port on ``device='cpu'`` (the kernels'
plain versions) and through the reference's vector backend, on one graph
built by the reference and carried across with ``repro_torch.carry``:
outputs, instrumentation counters, ``Report`` fields and iteration
counts are identical and nothing falls back.  The port also holds to
scipy's shortest paths, its Fig-13 study gives the reference's runs,
speedups and claims, its runner reports full native coverage, and its
workload copies build the reference's graphs.
"""
import dataclasses
import json

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.csgraph as csgraph
import torch

from benchmarks import fig13_vcp as ref_fig13
from benchmarks import workloads as ref_workloads
from repro.accelerators import REGISTRY as REF_REGISTRY
from repro.accelerators import graphicionado as RG
from repro.core.csf import CSF as RefCSF
from repro.core.einsum import Semiring as RefSemiring
from repro.core.generator import CascadeSimulator as RefSimulator
from repro.core.trace import CollectingInstr as RefInstr
from repro.core.vectorized import VectorBackend as RefVectorBackend
from repro_torch import accelerators as port
from repro_torch.accelerators import graphicionado as G
from repro_torch.bench import fig13_vcp, run as bench_run, workloads
from repro_torch.carry import carry
from repro_torch.core.csf import CSF
from repro_torch.core.einsum import Semiring
from repro_torch.core.generator import CascadeSimulator
from repro_torch.core.trace import CollectingInstr
from repro_torch.core.vectorized import VectorBackend

from test_backends import COUNTERS

DESIGNS = ("graphicionado", "graphdyns", "ours")
SPECS = {"graphicionado": (RG.graphicionado_spec, G.graphicionado_spec),
         "graphdyns": (RG.graphdyns_spec, G.graphdyns_spec),
         "ours": (RG.improved_spec, G.improved_spec)}


def _specs(design, weighted, v):
    kw = {"n_vertices": v} if design == "graphdyns" else {}
    ref, mine = SPECS[design]
    return ref(weighted=weighted, **kw), mine(weighted=weighted, **kw)


def _report_fields(report):
    d = dataclasses.asdict(report)
    d.pop("stage_seconds")                   # host wall clock
    return d


def _graph(kind, weighted):
    """The reference's graph and its vertex count: the dense adjacency of
    ``grid_graph(6, extra=6)`` (tests/test_backends.py's case) or the
    columnar ``sparse_grid_graph(24, extra=36)``."""
    if kind == "dense":
        adj = ref_workloads.grid_graph(6, extra=6, weighted=weighted)
        return adj, adj.shape[0]
    return ref_workloads.sparse_grid_graph(24, extra=36, weighted=weighted,
                                           seed=0), 24 * 24


def _iterate(sim, g, v):
    a0 = np.zeros(v)
    a0[0] = 1.0
    p0 = np.zeros(v)
    p0[0] = 1.0                              # distance+1 encoding
    return sim.run_iterative(
        {"G": g, "A0": a0, "P0": p0}, carry={"A0": "A1", "P0": "P1"},
        done_when_empty="A1", max_iters=64, var_shapes={"d": v, "s": v})


@pytest.mark.parametrize("kind", ["dense", "sparse"])
@pytest.mark.parametrize("algo", ["bfs", "sssp"])
@pytest.mark.parametrize("design", DESIGNS)
def test_graph_design_matches_reference(design, algo, kind):
    weighted = algo == "sssp"
    g, v = _graph(kind, weighted)
    ref_spec, port_spec = _specs(design, weighted, v)
    ref_ci, port_ci = RefInstr(), CollectingInstr()
    ref_res, ref_iters = _iterate(RefSimulator(
        ref_spec, semiring=RefSemiring.min_plus(), extra_instr=ref_ci,
        backend=RefVectorBackend(kernel_backend="numpy")), g, v)
    res, iters = _iterate(CascadeSimulator(
        port_spec, semiring=Semiring.min_plus(), extra_instr=port_ci,
        backend=VectorBackend(device="cpu")), carry(g), v)
    assert ref_res.fallback_reasons == {}
    assert res.fallback_reasons == {} and res.downgrade_events == {}
    assert res.report.fallback_reasons == {}
    assert iters == ref_iters
    assert set(res.tensors) == set(ref_res.tensors)
    for name in ref_res.tensors:
        want, got = ref_res[name], res[name]
        assert got.ranks == want.ranks, name
        assert list(got.iter_leaves()) == list(want.iter_leaves()), name
    for attr in COUNTERS + ("merges",):
        assert getattr(port_ci, attr) == getattr(ref_ci, attr), attr
    assert _report_fields(res.report) == _report_fields(ref_res.report)


def _random_graph(rng, v=40, density=0.08, weighted=True):
    """tests/test_graph_accels.py's random digraph, G[d, s] = s -> d."""
    adj = (rng.random((v, v)) < density).astype(float)
    np.fill_diagonal(adj, 0.0)
    if weighted:
        adj = adj * rng.integers(1, 8, size=(v, v)).astype(float)
    return adj


@pytest.mark.parametrize("algo", ["bfs", "sssp"])
@pytest.mark.parametrize("design", DESIGNS)
def test_graph_design_matches_scipy(design, algo):
    weighted = algo == "sssp"
    adj = _random_graph(np.random.default_rng(0), weighted=weighted)
    v = adj.shape[0]
    variant = "ours-vcp" if design == "ours" else design
    kw = {"n_vertices": v} if design == "graphdyns" else {}
    spec = port.REGISTRY[variant](weighted=weighted, **kw)
    res, _ = fig13_vcp.run_vcp(spec, adj, v, VectorBackend(device="cpu"))
    assert res.fallback_reasons == {}
    dist = np.full(v, np.inf)
    for (d,), val in res.tensors["P1"].iter_leaves():
        dist[d] = val - 1.0                  # undo the +1 encoding
    graph = sp.csr_matrix(adj.T)             # scipy: graph[s, d]
    want = (csgraph.dijkstra(graph, indices=0) if weighted else
            csgraph.shortest_path(graph, indices=0, unweighted=True))
    assert np.array_equal(dist, want)


def test_graphicionado_simulate_entry_point():
    """``graphicionado.simulate`` by variant name runs one pass on the
    CPU as the reference's does."""
    adj = workloads.grid_graph(6, extra=6, weighted=True)
    v = adj.shape[0]
    inputs = {"G": adj, "A0": np.eye(1, v)[0], "P0": np.eye(1, v)[0]}
    want = RG.simulate(dict(inputs), {"d": v, "s": v}, variant="graphdyns",
                       backend="vector", semiring=RefSemiring.min_plus(),
                       n_vertices=v)
    got = G.simulate(dict(inputs), {"d": v, "s": v}, variant="graphdyns",
                     device="cpu", semiring=Semiring.min_plus(),
                     n_vertices=v)
    assert got.fallback_reasons == {}
    for name in want.tensors:
        assert list(got[name].iter_leaves()) == \
            list(want[name].iter_leaves()), name
    assert got.report.seconds == want.report.seconds


def test_registry_matches_reference():
    assert list(port.REGISTRY) == list(REF_REGISTRY)


def test_fig13_study_matches_reference():
    """The study at side 16 in both packages: the same runs (host wall
    time and the port's launch counts aside), speedups and claims."""
    want = ref_fig13.bench(side=16)
    got = fig13_vcp.bench(side=16, device="cpu")
    for key in ("vertices", "grid_side", "extra", "max_iters", "edges"):
        assert got[key] == want[key], key
    assert list(got["runs"]) == list(want["runs"])
    for key, run in want["runs"].items():
        mine = got["runs"][key]
        assert {f: mine[f] for f in fig13_vcp.SIMULATED} == \
            {f: run[f] for f in fig13_vcp.SIMULATED}, key
        # the CPU takes the plain versions: no kernel launches
        assert set(mine["launches"].values()) == {0}
        assert mine["wall_seconds"] > 0
    assert got["speedups"] == want["speedups"]
    assert got["claims"] == want["claims"]
    assert fig13_vcp.compare(got, want) == []
    assert fig13_vcp.gate(got) == []


def test_fig13_trace_splits_stages_and_seams():
    out = fig13_vcp.bench(side=6, device="cpu", max_iters=4, trace=True)
    for run in out["runs"].values():
        assert run["iters"] <= 4
        assert run["seam_seconds"] and run["stage_seconds"]
        assert set(run["seam_seconds"]) <= {
            "intersect_keys", "union_keys", "union_k_keys", "lookup_keys",
            "segmented_reduce"}
        assert sum(run["seam_seconds"].values()) < run["wall_seconds"]


def test_fig13_compare_holds_to_the_reference_record():
    """``compare`` against ``BENCH_graph.json``: its own summary passes;
    a run's modeled seconds one ulp off, a lost vertex or a changed claim
    is named; a summary of another size is held to the gated claims
    only."""
    base = json.loads(fig13_vcp.REFERENCE_JSON.read_text())
    assert base["grid_side"] == fig13_vcp.FULL_SIDE
    assert fig13_vcp.compare(base, base) == []
    off = json.loads(json.dumps(base))
    run = off["runs"]["bfs/graphdyns"]
    run["modeled_seconds"] = np.nextafter(run["modeled_seconds"], 1.0)
    off["runs"]["sssp/ours"]["reached"] -= 1
    off["claims"]["bfs_gain_exceeds_sssp_gain"] = True
    diffs = fig13_vcp.compare(off, base)
    assert len(diffs) == 3
    assert diffs[0].startswith("bfs/graphdyns.modeled_seconds")
    assert diffs[1].startswith("sssp/ours.reached")
    assert diffs[2].startswith("claims")
    small = dict(off, grid_side=16)
    assert fig13_vcp.compare(small, base) == []
    small["claims"] = dict(small["claims"], ours_beats_graphdyns_bfs=False)
    assert fig13_vcp.compare(small, base) == \
        ["regressed:ours_beats_graphdyns_bfs"]


def test_fig13_records_card_runs_only(tmp_path):
    summary = fig13_vcp.bench(side=6, device="cpu", max_iters=2)
    path = tmp_path / "BENCH_torch.json"
    with pytest.raises(ValueError, match="card runs only"):
        fig13_vcp.record(summary, path)
    assert not path.exists()


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    adj = np.eye(4, k=-1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        G.simulate({"G": adj, "A0": np.eye(1, 4)[0], "P0": np.eye(1, 4)[0]},
                   {"d": 4, "s": 4}, semiring=Semiring.min_plus())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fig13_vcp.bench(side=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_run.main(["--explain-fallbacks"])


def test_explain_fallbacks_reports_full_native_coverage(capsys):
    assert bench_run.explain_fallbacks("vector", "cpu") == 0
    rows = capsys.readouterr().out.splitlines()
    assert rows[0] == "cascade,einsum,reason"
    names = [r.split(",")[0] for r in rows[1:]]
    graph = [f"{d}/{a}" for d in ("graphdyns", "graphicionado", "ours-vcp")
             for a in ("bfs", "sssp")]
    assert len(names) == 5 + len(graph) + len(port.zoo.ZOO)
    assert set(graph) <= set(names)
    assert all(r.endswith(",-,native") for r in rows[1:])
    assert bench_run.main(["--explain-fallbacks", "--device", "cpu"]) == 0


def test_explain_fallbacks_counts_an_error(monkeypatch, capsys):
    """A run that raises (on the card: an inadmissible plan or a kernel
    fault) is printed and counted, and the CLI exits 1."""
    from repro_torch.core import generator

    def boom(self, *args, **kwargs):
        raise RuntimeError("kernel fault")
    monkeypatch.setattr(generator.CascadeSimulator, "run", boom)
    assert bench_run.main(["--explain-fallbacks", "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "gamma,-,ERROR: RuntimeError: kernel fault" in out


def test_runner_rows_on_cpu(capsys):
    assert bench_run.main(["--only", "table2,kernels", "--device",
                           "cpu"]) == 0
    rows = capsys.readouterr().out.splitlines()
    assert rows[0] == "name,us_per_call,derived"
    assert "table2/claim/all_cascades_validate,0.0,1.0" in rows
    assert any(r.startswith("kernels/spmspm_coiter/vector,") for r in rows)


@pytest.mark.parametrize("bench,module,claim", [
    ("fig13", "fig13_vcp", "fig13/claim/ours_beats_graphdyns_bfs"),
    ("fig13", "fig13_vcp", "fig13/claim/all_native"),
    ("table2", "table2_zoo", "table2/claim/all_cascades_validate"),
])
def test_runner_exits_1_on_a_failed_claim(monkeypatch, capsys, bench,
                                          module, claim):
    """A gated claim, a fallback or a cascade that does not validate
    reads 0.0 in its row and fails the benchmark: the runner exits 1."""
    import importlib
    mod = importlib.import_module(f"repro_torch.bench.{module}")
    monkeypatch.setattr(mod, "run", lambda **kw: [
        (f"{bench}/x", 1.0, 1.0), (claim, 0.0, 0.0)])
    assert bench_run.main(["--only", bench, "--device", "cpu"]) == 1
    out = capsys.readouterr()
    assert f"{bench}/FAILED,0.0,0.0" in out.out
    assert claim in out.err


@pytest.mark.parametrize("weighted", [False, True])
def test_workload_copies_build_the_reference_graphs(weighted):
    assert np.array_equal(
        workloads.grid_graph(6, extra=6, weighted=weighted, seed=3),
        ref_workloads.grid_graph(6, extra=6, weighted=weighted, seed=3))
    want = RefCSF.from_ftensor(ref_workloads.sparse_grid_graph(
        20, extra=25, weighted=weighted, seed=1))
    got = CSF.from_ftensor(workloads.sparse_grid_graph(
        20, extra=25, weighted=weighted, seed=1))
    assert got.ranks == want.ranks and got.rank_shapes == want.rank_shapes
    for g, w in zip(got.coords, want.coords):
        assert np.array_equal(g, w)
    for g, w in zip(got.segments, want.segments):
        assert (g is None and w is None) or np.array_equal(g, w)
    assert np.array_equal(got.values, want.values)
