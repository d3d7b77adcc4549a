"""The port's simulator-throughput bench, seam-rate bench and regression
gate, held to the reference's on the CPU."""
import json

import numpy as np
import pytest
import torch

import benchmarks.backend_throughput as ref_bt
import benchmarks.kernels_bench as ref_kb
from repro.accelerators.zoo import rowwise_spmspm as ref_rowwise
from repro.core.mapping import MappingResolver as RefResolver
from repro.core.vectorized import VectorBackend as RefVectorBackend
from repro_torch.bench import backend_throughput as bt
from repro_torch.bench import compare
from repro_torch.bench import kernels_bench as kb

WORK = ("workload", "backend", "size", "density", "elements", "out_nnz",
        "nnz_a", "nnz_b")


@pytest.fixture(scope="module")
def records():
    """The port's and the reference's records at 256^2 (every mapping,
    the vector path and the interpreter)."""
    port = bt.bench(sizes=[256], backend="both", mapped_sizes=[256],
                    device="cpu")
    ref = ref_bt.bench(sizes=[256], backend="both", mapped_sizes=[256])
    return port, ref


def test_bench_records_do_the_reference_work(records):
    port, ref = records
    assert [tuple(r[k] for k in WORK) for r in port] == \
        [tuple(r[k] for k in WORK) for r in ref]
    for r in port:
        assert r["elements_per_sec"] > 0 and r["seconds"] > 0
        if r["backend"] == "vector":
            assert r["device"] == "cpu" and r["lowering"] == "torch"
            # the CPU takes the plain versions: nothing launches
            assert set(r["launches"].values()) == {0}
    assert {r["workload"] for r in port} == {"rowwise", "flattened",
                                             "partitioned"}


def test_summary_has_the_reference_keys(records):
    port, ref = records
    got, want = bt.summarize(port), ref_bt.summarize(ref)
    assert set(got) == set(want)
    for key in ("mappings", "metric", "workload", "python_measured_at",
                "vector_measured_at"):
        assert got[key] == want[key]


def test_output_digest_is_the_reference_output(records):
    """``out_sha256`` is a digest of the output CSF: the reference's
    numpy vector path builds the same arrays."""
    port, _ = records
    plan = RefResolver(ref_rowwise()).plan("Z")
    a = ref_bt.synth_csf(256, 0.01, 1, "A", ["M", "K"])
    b = ref_bt.synth_csf(256, 0.01, 2, "B", ["K", "N"])
    out, _ = RefVectorBackend().execute_csf(plan, {"A": a, "B": b})
    rowwise = next(r for r in port if r["workload"] == "rowwise"
                   and r["backend"] == "vector")
    assert bt.csf_digest(out) == rowwise["out_sha256"]


@pytest.mark.parametrize("ranks", [["M", "K"], ["K", "M"]])
def test_synth_csf_equals_the_reference(ranks):
    got = bt.synth_csf(300, 0.02, 7, "A", ranks)
    want = ref_bt.synth_csf(300, 0.02, 7, "A", ranks)
    assert got.ranks == want.ranks
    for g, w in zip(got.coords + [got.values], want.coords + [want.values]):
        assert np.array_equal(g, w)
    for g, w in zip(got.segments[1:], want.segments[1:]):
        assert np.array_equal(g, w)


def test_traced_records_split_stages_and_seams():
    recs = bt.bench(sizes=[128], backend="vector", mapped_sizes=[],
                    device="cpu", reps=2, trace=True)
    assert len(recs) == 1
    r = recs[0]
    assert r["stage_seconds"] and r["seam_seconds"]
    assert set(r["seam_seconds"]) == {"intersect_keys"}
    assert sum(r["stage_seconds"].values()) <= r["seconds"] * 1.5


def test_analytic_and_python_need_no_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    recs = bt.bench(sizes=[64], backend="analytic")
    assert [(r["backend"], r["elements"] > 0) for r in recs] == \
        [("analytic", True)]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bt.bench(sizes=[64], backend="vector")


def test_record_only_from_a_card(tmp_path):
    path = tmp_path / "BENCH_torch.json"
    with pytest.raises(ValueError, match="card runs only"):
        bt.record({"records": []}, torch.device("cpu"), path)
    with pytest.raises(ValueError, match="card runs only"):
        kb.record({"backends": {}}, "cpu", path)
    assert not path.exists()
    with pytest.raises(SystemExit):
        bt.main(["--record", "--device", "cpu", "--sizes", "64"])


def test_cli_smoke_on_the_cpu(capsys):
    bt.main(["--smoke", "--device", "cpu", "--backend", "vector"])
    out = json.loads(capsys.readouterr().out)
    assert out["metric"] == "leaf multiplies per second"
    assert out["vector_rate_flattened_measured_at"] == 256


# ---------------------------------------------------------------------- #
# seam rates
# ---------------------------------------------------------------------- #
def test_seam_inputs_equal_the_reference():
    for n in (1, 100, 4096):
        for g, w in zip(kb._seam_inputs(n), ref_kb._seam_inputs(n)):
            assert g.dtype == w.dtype and np.array_equal(g, w)


def test_seam_rates_on_the_cpu():
    assert kb.lowerings("cpu") == ("torch",)
    rates = kb.seam_rates("torch", "cpu", n=1 << 12, reps=1)
    assert set(rates) == {"intersect", "union_k", "lookup",
                          "segmented_reduce"}
    assert all(v > 0 for v in rates.values())
    with pytest.raises(ValueError, match="CUDA device"):
        kb.seam_rates("cuda", "cpu", n=64)


def test_seam_outputs_equal_the_reference_numpy_lowering():
    from repro.core.einsum import Semiring
    from repro.kernels.backends import NumpyKernels
    n = 1 << 12
    got = kb.seam_outputs("torch", "cpu", n)
    a, b, c, probes, vals, starts, gids = ref_kb._seam_inputs(n)
    ref = NumpyKernels()
    want = {"intersect": ref.intersect_keys(a, b),
            "union_k": ref.union_k_keys([a, b, c]),
            "lookup": ref.lookup_keys(a, probes),
            "segmented_reduce": ref.segmented_reduce(
                vals, starts, Semiring.arithmetic(), group_ids=gids)}

    def same(g, w):
        if isinstance(g, (tuple, list)):
            return len(g) == len(w) and all(map(same, g, w))
        return np.array_equal(np.asarray(g), np.asarray(w))
    for seam in want:
        assert same(got[seam], want[seam]), seam


# ---------------------------------------------------------------------- #
# the regression gate
# ---------------------------------------------------------------------- #
def _rec(workload="rowwise", backend="vector", size=1024, rate=1000.0,
         **kw):
    r = {"workload": workload, "backend": backend, "size": size,
         "elements": 50, "out_nnz": 40, "nnz_a": 10, "nnz_b": 10,
         "out_sha256": "ab", "elements_per_sec": rate}
    r.update(kw)
    return r


def _committed(card="H100", **kw):
    return {"backend": {"card": card, "records": [
        _rec(), _rec(backend="python", rate=10.0, out_sha256=None),
        _rec(size=4096)], **kw}}


def _verdicts(gate):
    return {k: v for k, _, _, v in gate.rows}


def test_gate_exact_miss_and_one_sided_rate():
    gate = compare.Gate()
    fresh = [_rec(rate=2000.0, out_nnz=41),
             _rec(backend="python", rate=5.0, out_sha256=None)]
    compare.compare_backend(gate, 0.25, _committed(), "H100",
                            fresh_records=fresh)
    v = _verdicts(gate)
    # only the committed records at the comparison size are compared
    assert not any("n4096" in k for k in v)
    assert v["backend/rowwise/vector/n1024/out_nnz"] == "REGRESSION"
    assert v["backend/rowwise/vector/n1024/elements"] == "ok"
    assert v["backend/rowwise/vector/n1024/out_sha256"] == "ok"
    # faster passes, slower past the tolerance fails
    assert v["backend/rowwise/vector/n1024/elements_per_sec"] == "ok"
    assert v["backend/rowwise/python/n1024/elements_per_sec"] == \
        "REGRESSION"
    assert gate.failures == 2


def test_gate_skips_rates_of_another_card():
    gate = compare.Gate()
    compare.compare_backend(gate, 0.25, _committed(card="H100"), "cpu",
                            fresh_records=[_rec(rate=1.0),
                                           _rec(backend="python", rate=1.0,
                                                out_sha256=None)])
    v = _verdicts(gate)
    assert v["backend/rowwise/vector/n1024/elements_per_sec"] == \
        "skipped (card differs)"
    assert v["backend/rowwise/vector/n1024/elements"] == "ok"
    assert gate.failures == 0
    assert "skipped (card differs)" in gate.report()


def test_gate_missing_record_and_dse_and_graph():
    gate = compare.Gate()
    compare.compare_backend(gate, 0.25, _committed(), "H100",
                            fresh_records=[])
    assert gate.failures == 2                 # both records missing
    dse = {"dse": {"card": "H100", "analytic_rate": 100.0, "records": [{
        "backend": "analytic", "points": 16, "pareto_points": ["p"],
        "traffic_range_kb": [1.0, 2.0]}]}}
    fresh = {"analytic_rate": 50.0, "records": [{
        "backend": "analytic", "points": 16, "pareto_points": ["p"],
        "traffic_range_kb": [1.0, 2.0]}]}
    gate = compare.Gate()
    compare.compare_dse(gate, 0.25, dse, "H100", fresh_summary=fresh)
    assert _verdicts(gate)["dse/analytic_rate"] == "REGRESSION"
    assert gate.failures == 1
    gate = compare.Gate()
    compare.compare_dse(gate, 0.25, dse, "cpu", fresh_summary=fresh)
    assert gate.failures == 0
    committed = json.loads((compare.ROOT / "BENCH_torch.json").read_text())
    gate = compare.Gate()
    compare.compare_graph(gate, committed)
    assert gate.failures == 0 and len(gate.rows) == 4
    gate = compare.Gate()
    compare.compare_graph(gate, {})
    assert _verdicts(gate) == {"graph": "skipped (no fig13 record)"}


def test_gate_exit_code(tmp_path, monkeypatch, capsys):
    """``main`` exits 1 on a regression and 0 when every comparison
    passes or is skipped."""
    path = tmp_path / "BENCH_torch.json"
    monkeypatch.setattr(compare, "BENCH_JSON", path)
    fresh = [_rec(), _rec(backend="python", rate=10.0, out_sha256=None)]
    monkeypatch.setattr(bt, "bench", lambda **kw: fresh)
    path.write_text(json.dumps(_committed(card="cpu")))
    assert compare.main(["--device", "cpu", "--skip", "dse",
                         "--skip", "graph"]) == 0
    fresh[0] = _rec(elements=51)
    assert compare.main(["--device", "cpu", "--skip", "dse",
                         "--skip", "graph"]) == 1
    out = capsys.readouterr().out
    assert "# 1 regression(s)" in out and "# all comparisons passed" in out
