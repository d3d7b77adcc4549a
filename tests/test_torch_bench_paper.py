"""The port's paper studies (Table 1, Figs. 9-11), its workloads and its
runner, held to the reference's on the CPU."""
import os
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

import benchmarks.fig10_performance as ref_fig10
import benchmarks.fig11_energy as ref_fig11
import benchmarks.fig9_memory_traffic as ref_fig9
import benchmarks.table1_designs as ref_table1
import benchmarks.workloads as ref_workloads
from repro_torch.bench import fig10_performance as fig10
from repro_torch.bench import fig11_energy as fig11
from repro_torch.bench import fig9_memory_traffic as fig9
from repro_torch.bench import run as runner
from repro_torch.bench import table1_designs as table1
from repro_torch.bench import workloads

ROOT = Path(__file__).resolve().parents[1]
#: the largest side a shrunk study matrix may have
SMALL = 96


def small_synth(name, seed=0):
    """``synth_matrix``'s body at a quarter of each side (at most 96
    rows), the same density and row structure, the port's seed."""
    rows, cols, density, dist = workloads.PAPER_MATRICES[name]
    rows, cols = rows // 4, cols // 4
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % 1000)
    nnz_target = max(8, int(rows * cols * density))
    a = np.zeros((rows, cols))
    if dist == "uniform":
        idx = rng.choice(rows * cols, size=nnz_target, replace=False)
        a.flat[idx] = rng.random(nnz_target) + 0.1
    else:
        w = 1.0 / np.arange(1, rows + 1) ** 1.1
        row_nnz = rng.multinomial(nnz_target, w / w.sum())
        order = rng.permutation(rows)
        for r, n in zip(order, row_nnz):
            n = min(n, cols)
            if n:
                c = rng.choice(cols, size=n, replace=False)
                a[r, c] = rng.random(n) + 0.1
    assert a.shape[0] <= SMALL
    return a


def small_pair(m=256, k=256, n=256, da=0.1, db=0.1, seed=0):
    """``uniform_pair`` at sides of at most 96, the same densities."""
    return workloads.uniform_pair(min(m, SMALL), min(k, SMALL),
                                  min(n, SMALL), da, db, seed)


@pytest.mark.parametrize("port,ref", [(table1, ref_table1), (fig9, ref_fig9),
                                      (fig10, ref_fig10), (fig11, ref_fig11)],
                         ids=["table1", "fig9", "fig10", "fig11"])
def test_study_rows_equal_the_reference(monkeypatch, port, ref):
    """On the same (shrunk) matrices the port's study prints the
    reference's rows: the same names and bit-identical ``derived``
    values; every claim holds."""
    for mod in (port, ref):
        for name, fn in (("synth_matrix", small_synth),
                         ("uniform_pair", small_pair)):
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, fn)
    got, want = port.run(), ref.run()
    assert [r[0] for r in got] == [r[0] for r in want]
    assert [r[2] for r in got] == [r[2] for r in want]
    claims = {name: value for name, _, value in got if "/claim/" in name}
    assert claims
    module, least = runner.STUDY_CLAIMS[port.__name__.split(".")[-1]
                                        .split("_")[0]]
    assert set(least) == set(claims)
    assert all(claims[c] >= least[c] for c in claims)


_DIGEST = """
import hashlib
from repro_torch.bench.workloads import PAPER_MATRICES, synth_matrix
h = hashlib.sha256()
for name in PAPER_MATRICES:
    h.update(synth_matrix(name).tobytes())
print(h.hexdigest())
"""


def test_synth_matrix_is_stable_across_hash_seeds():
    """Python salts ``hash`` of a string per process; the port's seed
    (crc32 of the name) builds the same matrices in every process."""
    digests = set()
    for hash_seed in ("1", "2"):
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   PYTHONHASHSEED=hash_seed, OMP_NUM_THREADS="2",
                   MKL_NUM_THREADS="2")
        out = subprocess.run([sys.executable, "-c", _DIGEST], env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        digests.add(out.stdout.strip())
    assert len(digests) == 1


def test_synth_matrix_is_the_reference_body_under_crc32(monkeypatch):
    """With ``hash`` in the reference's module replaced by the crc32
    digest, its ``synth_matrix`` builds the port's matrices."""
    monkeypatch.setattr(ref_workloads, "hash",
                        lambda s: zlib.crc32(s.encode()), raising=False)
    assert workloads.PAPER_MATRICES == ref_workloads.PAPER_MATRICES
    for name in workloads.PAPER_MATRICES:
        for seed in (0, 3):
            assert np.array_equal(workloads.synth_matrix(name, seed),
                                  ref_workloads.synth_matrix(name, seed))


@pytest.mark.parametrize("name,args", [
    ("uniform_pair", dict(m=40, k=30, n=20, da=0.2, db=0.3, seed=5)),
    ("powerlaw_graph", dict(v=64, avg_deg=3.0, weighted=True, seed=2)),
    ("grid_graph", dict(side=6, extra=5, weighted=True, seed=1))])
def test_dense_workloads_equal_the_reference(name, args):
    got = getattr(workloads, name)(**args)
    want = getattr(ref_workloads, name)(**args)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("name,args", [
    ("sparse_graph", dict(v=300, avg_deg=4.0, weighted=True, seed=3)),
    ("sparse_graph", dict(v=200, dist="uniform", seed=1)),
    ("sparse_grid_graph", dict(side=9, extra=7, weighted=True, seed=4))])
def test_sparse_workloads_equal_the_reference(name, args):
    got = getattr(workloads, name)(**args)
    want = getattr(ref_workloads, name)(**args)
    assert got.to_dense().shape == want.to_dense().shape
    assert np.array_equal(got.to_dense(), want.to_dense())


# ---------------------------------------------------------------------- #
# the runner
# ---------------------------------------------------------------------- #
def test_runner_table1_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(table1, "uniform_pair", small_pair)
    assert runner.main(["--only", "table1", "--device", "cpu"]) == 0
    rows = [ln.split(",") for ln in capsys.readouterr().out.splitlines()]
    assert rows[0] == ["name", "us_per_call", "derived"]
    assert ["table1/claim/all_designs_agree_functionally", "0.0",
            "1.0"] in rows
    assert len(rows) == 12


@pytest.mark.parametrize("study,claim,value,rc", [
    ("table1", "table1/claim/all_designs_agree_functionally", 0.0, 1),
    ("fig9", "fig9/claim/gamma<=outerspace", 0.0, 1),
    ("fig10", "fig10/claim/analytical_worse_on_skew", 1.0, 0),
    ("fig11", "fig11/claim/energy_tracks_traffic_corr", 0.85, 1),
    ("fig11", "fig11/claim/energy_tracks_traffic_corr", 0.95, 0)])
def test_runner_fails_a_failed_claim(monkeypatch, capsys, study, claim,
                                     value, rc):
    """A study's claim row below its least value (1.0 for a check, 0.9
    for Fig. 11's correlation) fails the run."""
    module = {"table1": table1, "fig9": fig9, "fig10": fig10,
              "fig11": fig11}[study]
    monkeypatch.setattr(module, "run", lambda: [
        (f"{study}/x", 1.0, 2.0), (claim, 0.0, value)])
    assert runner.main(["--only", study, "--device", "cpu"]) == rc
    out = capsys.readouterr().out
    assert (f"{study}/FAILED" in out) == bool(rc)


def test_runner_backend_reaches_only_its_benches(monkeypatch, capsys):
    """``--backend`` reaches backend as given and no study; fig13 and
    dse take it where they can."""
    from repro_torch.bench import backend_throughput, dse_sweep, fig13_vcp
    seen = {}

    def recorder(name, rows):
        def run(*args, **kwargs):
            seen[name] = (args, kwargs)
            return rows
        return run

    for name, mod in (("table1", table1), ("fig11", fig11)):
        monkeypatch.setattr(mod, "run", recorder(name, [
            (f"{name}/claim/x", 0.0, 1.0)]))
    monkeypatch.setattr(backend_throughput, "run",
                        recorder("backend", [("backend/x", 0.0, 5.0)]))
    monkeypatch.setattr(fig13_vcp, "run", recorder("fig13", []))
    monkeypatch.setattr(dse_sweep, "run", recorder("dse", []))
    assert runner.main(["--only", "table1,fig11,backend,fig13,dse",
                        "--backend", "both", "--device", "cpu",
                        "--smoke"]) == 0
    assert seen["table1"] == ((), {}) and seen["fig11"] == ((), {})
    assert seen["backend"][1]["backend"] == "both"
    assert seen["backend"][1]["smoke"] is True
    assert seen["fig13"][1]["backend"] == "vector"
    assert seen["dse"][1]["backend"] == "vector"
    assert runner.main(["--only", "backend,dse", "--backend", "analytic",
                        "--device", "cpu"]) == 0
    assert seen["backend"][1]["backend"] == "analytic"
    assert seen["dse"][1]["backend"] == "analytic"
    capsys.readouterr()


def test_runner_needs_a_card_without_device(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        runner.main(["--only", "table1"])

