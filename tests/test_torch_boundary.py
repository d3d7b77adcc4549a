"""The port's boundary: no JAX and nothing of the reference package,
no silent CPU fallback, and ``chip_smoke.py``'s phases rehearsed on the
CPU at a tiny size."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), \
            f"{path.relative_to(ROOT)} imports {mod}"


_BLOCKED_RUN = """
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import numpy as np
from repro_torch.accelerators import simulate
rng = np.random.default_rng(0)
a = rng.random((16, 16)) * (rng.random((16, 16)) < 0.3)
b = rng.random((16, 16)) * (rng.random((16, 16)) < 0.3)
res = simulate("gamma", {"A": a, "B": b}, {"m": 16, "k": 16, "n": 16},
               device="cpu")
assert res.fallback_reasons == {} and res.downgrade_events == {}
assert np.allclose(res["Z"].to_dense(), a.T @ b)

from repro_torch.accelerators import REGISTRY
from repro_torch.bench import fig13_vcp
from repro_torch.bench.workloads import sparse_grid_graph
from repro_torch.core.vectorized import VectorBackend
g = sparse_grid_graph(8, extra=4)
res, iters = fig13_vcp.run_vcp(REGISTRY["graphdyns"](weighted=False,
                                                     n_vertices=64),
                               g, 64, VectorBackend(device="cpu"))
assert res.fallback_reasons == {} and iters == 15
assert res["P1"].nnz == 64

import torch
import repro_torch.configs as C
from repro_torch.launch.serve import Request, Server
from repro_torch.launch.steps import make_prefill_step
cfg = C.get_smoke("mamba2-1.3b")
server = Server(cfg, batch=2, max_len=32, device="cpu")
logits = make_prefill_step(cfg, device="cpu")(
    server.params, {"tokens": torch.zeros(1, 32, dtype=torch.long)})
assert logits.shape == (1, 32, 512) and bool(torch.isfinite(logits).all())
reqs = [Request(i, [1, 2, 3 + i], 3) for i in range(3)]
for r in reqs:
    server.submit(r)
server.drain()
assert all(r.done and len(r.out) == 3 for r in reqs)

from repro_torch.bench import kernels_bench
dense = C.get_smoke("qwen2-7b")
server = Server(dense, batch=2, max_len=32, device="cpu")
logits = make_prefill_step(dense, device="cpu")(
    server.params, {"tokens": torch.zeros(1, 32, dtype=torch.long)})
assert logits.shape == (1, 32, 512) and bool(torch.isfinite(logits).all())
assert all(r.err <= r.limit for r in kernels_bench.run("cpu", reps=1))

from repro_torch.dse import DesignSpace, SweepEngine
from repro_torch.bench import dse_sweep
inputs, shapes = dse_sweep.workload(m=24, k=24, n=24)
space = DesignSpace("gamma", axes={"fibercache_mb": [0.002, 3.0]})
swept = SweepEngine(inputs, shapes).sweep(space.grid())
assert all(r.ok and r.fallback_reasons == {} for r in swept)
vec = SweepEngine(inputs, shapes, backend="vector", device="cpu").sweep(
    space.grid()[:1])
assert vec[0].ok and vec[0].fallback_reasons == {} and vec[0].dram_bytes > 0

from repro_torch.bench import (backend_throughput, compare, fig10_performance,
                               fig11_energy, fig9_memory_traffic, run,
                               table1_designs)
recs = backend_throughput.bench(sizes=[64], backend="both",
                                mapped_sizes=[64], device="cpu", reps=1)
assert len(recs) == 4 and all(r["elements"] > 0 for r in recs)
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules if sys.modules[m] is not None)
print("ok")
"""


def test_simulation_runs_where_jax_and_reference_cannot_import():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_simulate_without_a_device_raises(monkeypatch):
    from repro_torch.accelerators import simulate
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = np.eye(4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulate("gamma", {"A": a, "B": a}, {"m": 4, "k": 4, "n": 4})


# ---------------------------------------------------------------------- #
# chip_smoke.py
# ---------------------------------------------------------------------- #
@pytest.fixture
def chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke as mod
        yield mod
    finally:
        sys.path.remove(str(ROOT))


def test_chip_smoke_phases_rehearse_on_cpu(chip_smoke):
    recs = chip_smoke.phase_kernels("cpu", scale=1e-5, reps=1)
    assert [r["name"] for r in recs] == ["search", "merge_path",
                                         "multi_merge_ranks"]
    for r in recs:
        assert r["max_abs_err"] == 0 and r["bound_by"] == "bytes"
        assert r["bound_ms"] > 0
    # the merges' device / host split at the table case (no device time
    # on the CPU)
    for r in recs[1:]:
        assert r["device_us"] is None and r["host_us"]["median"] > 0
    chip_smoke.phase_oracle("cpu", n=16)
    out = chip_smoke.phase_main(
        "cpu", configs=[(d, 48, 150) for d, _, _ in chip_smoke.MAIN_CONFIGS])
    # the CPU takes the plain versions: no kernel launches
    assert out["launches"] == {"search": 0, "merge_path": 0,
                               "multi_merge_ranks": 0}
    assert [w["design"] for w in out["walls"]] == \
        [c[0] for c in chip_smoke.MAIN_CONFIGS]
    # only the CUDA lowering's searches are recorded; the replay times
    # the wrapper's launches (probes present) at their own sizes
    assert out["search_calls"] == []
    slack = chip_smoke.phase_search_slack(
        "cpu", [(100, 50, True)] * 2 + [(80, 30, False), (0, 5, True),
                                        (7, 0, True)], reps=1)["total"]
    assert slack["launches"] == 4 and slack["ms"] > 0
    # keys read once, probes read and positions written once, 8 bytes each
    assert abs(slack["bound_ms"] - 8 * (2 * 200 + 140 + 10)
               / chip_smoke.HBM_BYTES_PER_S * 1e3) < 1e-12


def test_chip_smoke_search_replay_splits_sorted_and_unsorted(chip_smoke):
    """The search replay sums sorted calls (intersections, union
    gathers) and unsorted ones (lookup_keys) apart and together; calls
    without probes launch nothing and are left out."""
    calls = [(100, 50, True)] * 2 + [(80, 30, False)] * 3 + \
        [(0, 5, True), (7, 0, True), (64, 64, False)]
    out = chip_smoke.phase_search_slack("cpu", calls, reps=1)
    assert set(out) == {"sorted", "unsorted", "total"}
    got = {part: (rec["launches"], rec["sizes"]) for part, rec in out.items()}
    assert got == {"sorted": (3, 2), "unsorted": (4, 2), "total": (7, 4)}
    rate = chip_smoke.HBM_BYTES_PER_S / 1e3
    assert abs(out["sorted"]["bound_ms"]
               - 8 * (2 * (100 + 100) + 10) / rate) < 1e-12
    assert abs(out["unsorted"]["bound_ms"]
               - 8 * (3 * (80 + 60) + 64 + 128) / rate) < 1e-12
    for key in ("launches", "ms", "bound_ms", "slack_ms"):
        assert out["total"][key] == pytest.approx(
            out["sorted"][key] + out["unsorted"][key], rel=1e-12)
    for rec in out.values():
        assert rec["ms"] > 0
        assert rec["slack_ms"] == rec["ms"] - rec["bound_ms"]


def test_chip_smoke_merge_replay_rehearses_on_cpu(chip_smoke):
    """The merges replayed at recorded sizes (the CPU lowering records
    none): launches counted per kernel, bounds from the bytes, host time
    a call apart from device time."""
    out = chip_smoke.phase_main(
        "cpu", configs=[("sparse-add", 48, 150), ("sparse-add-3way", 48,
                                                  150)])
    assert out["merge_calls"] == []
    calls = [("merge_path", (100, 125))] * 2 + [("merge_path", (0, 7)),
                                                ("multi_merge_ranks",
                                                 (40, 0, 60))]
    slack = chip_smoke.phase_merge_slack("cpu", calls, reps=1)
    mp, mm = slack["merge_path"], slack["multi_merge_ranks"]
    assert (mp["launches"], mp["sizes"]) == (3, 2)
    assert (mm["launches"], mm["sizes"]) == (1, 1)
    assert mp["ms"] > 0 and mm["ms"] > 0
    rate = chip_smoke.HBM_BYTES_PER_S / 1e3
    assert abs(mp["bound_ms"] - 17 * (2 * 225 + 7) / rate) < 1e-12
    assert abs(mm["bound_ms"] - (16 * 100 + 8 * 4) / rate) < 1e-12
    assert mp["slack_ms"] == mp["ms"] - mp["bound_ms"]
    # the split over the recorded launches: host time a call is measured
    # here too; device time and the empty-kernel floor need a card, so
    # the CPU reports them as None
    for rec in (mp, mm):
        assert set(rec["host_us"]) == {"median", "min", "max"}
        assert 0 < rec["host_us"]["min"] <= rec["host_us"]["median"] <= \
            rec["host_us"]["max"]
        assert rec["device_us"] is None and rec["device_us_by"] is None
        assert rec["floor"] is None
    assert chip_smoke.launch_floor("cpu") is None


def test_chip_smoke_graph_phase_rehearses_on_cpu(chip_smoke):
    """Phase 6 at a tiny size: the check runs at 6^2 vertices and the
    study at 8^2 over 8 iterations; the CPU takes the plain versions, so
    no launches are counted or recorded."""
    out = chip_smoke.phase_graph("cpu", side=8, check_side=6, max_iters=8)
    assert out["launches"] == {"search": 0, "merge_path": 0,
                               "multi_merge_ranks": 0}
    assert out["search_calls"] == [] and out["merge_calls"] == []
    assert out["sizes"] == {}
    runs = out["summary"]["runs"]
    assert list(runs) == [f"{a}/{d}" for a in ("bfs", "sssp")
                          for d in ("graphicionado", "graphdyns", "ours")]
    for r in runs.values():
        assert r["iters"] == 8 and r["fallback_reasons"] == {}
        assert r["seam_seconds"] and r["stage_seconds"]
    assert out["summary"]["claims"]["all_native"]
    # the replays at the path's sizes: nothing recorded on the CPU, so
    # every kernel replays 0 launches, as the path counted
    replays = chip_smoke.phase_replays("cpu", out, path="graph")
    assert set(replays) == {"search", "merge_path", "multi_merge_ranks"}
    assert replays["search"]["total"]["launches"] == 0
    assert replays["merge_path"]["launches"] == 0
    with pytest.raises(AssertionError, match="counted 1"):
        chip_smoke.phase_replays("cpu", dict(
            out, launches=dict(out["launches"], merge_path=1)), path="graph")


def test_chip_smoke_holds_each_launch_to_its_plain_version(chip_smoke,
                                                          monkeypatch):
    """With ``held``, the recording hooks compare every wrapper call
    with its plain version on the same tensors and count the calls that
    launch; a wrong result raises."""
    from repro_torch.kernels.backends import CudaKernels
    hay = torch.tensor([2, 5, 9, 1 << 40])
    probes = torch.tensor([1, 5, 1 << 40])
    held, search_calls, merge_calls = {}, [], []
    with chip_smoke.record_search_calls(search_calls, held), \
            chip_smoke.record_merge_calls(merge_calls, held):
        CudaKernels._search(hay, probes)
        CudaKernels._search(hay, probes[:0])        # launches nothing
        CudaKernels._merge(hay, probes)
        CudaKernels._multi_merge(torch.cat([hay, probes]),
                                 torch.tensor([0, 4, 7]))
    assert {k: held[k] for k in ("search", "merge_path",
                                 "multi_merge_ranks")} == \
        {"search": 1, "merge_path": 1, "multi_merge_ranks": 1}
    assert held["seconds"] >= 0
    # a wrong position and a wrong source flag are caught
    monkeypatch.setattr(CudaKernels, "_search", staticmethod(
        lambda h, p: chip_smoke.search_plain(h, p).flip(0)))
    with pytest.raises(AssertionError, match="search differs"):
        with chip_smoke.record_search_calls([], {}):
            CudaKernels._search(hay, probes)

    def wrong_flag(a, b):
        merged, src = chip_smoke.merge_path_plain(a, b)
        return merged, 1 - src
    monkeypatch.setattr(CudaKernels, "_merge", staticmethod(wrong_flag))
    with pytest.raises(AssertionError, match="merge_path differs"):
        with chip_smoke.record_merge_calls([], {}):
            CudaKernels._merge(hay, probes)


def test_chip_smoke_dse_phase_rehearses_on_cpu(chip_smoke):
    """Phase dse at a tiny size: the analytic axes at full length, two
    vector points equal to their ``simulate`` calls, and the engine's
    threads, crash and resume, seam fault (on the CPU the interpreter
    reruns the faulted Einsum) and process pool."""
    out = chip_smoke.phase_dse("cpu", size=(48, 150),
                               vector_caps=(0.002, 6.0),
                               engine_size=(32, 100))
    assert out["analytic"]["fibercache"]["points"] == 16
    assert out["analytic"]["scale"]["points"] == 256
    # the CPU takes the plain versions: no kernel launches
    assert out["launches"] == {"search": 0, "merge_path": 0,
                               "multi_merge_ranks": 0}
    assert out["vector"]["points"] == 2
    assert [r["label"] for r in out["ratios"]] == [
        "gamma(fibercache_mb=0.002)", "gamma(fibercache_mb=6.0)"]
    assert all(r[f] > 0 for r in out["ratios"]
               for f in ("seconds", "energy_pj", "dram_bytes"))


def test_chip_smoke_throughput_phase_rehearses_on_cpu(chip_smoke):
    """Phase throughput at 256^2 and 2^12 seam keys: every mapping on
    the device's lowering and on the plain versions (the same on the
    CPU), equal work and digests, the interpreter at the smallest size,
    the seam rates of the one lowering the CPU runs."""
    out = chip_smoke.phase_throughput("cpu", sizes=[256], mapped_sizes=[256],
                                      seam_keys=1 << 12)
    assert out["launches"] == {k.__name__: 0 for k in chip_smoke.ALL_KERNELS}
    assert [(r["workload"], r["backend"]) for r in out["records"]] == [
        ("rowwise", "vector"), ("rowwise", "python"),
        ("flattened", "vector"), ("partitioned", "vector")]
    for r in out["records"]:
        if r["backend"] == "vector":
            assert r["check_seconds"] == 0.0 and r["stage_seconds"]
            assert r["held"] == r["launches"]
    assert [r["out_sha256"] for r in out["plain"]] == [
        r["out_sha256"] for r in out["records"] if r["backend"] == "vector"]
    assert out["summary"]["speedup_same_size"] > 0
    assert set(out["seam_rates"]) == {"torch"}
    assert len(out["seam_rates"]["torch"]) == 4


def test_chip_smoke_seam_output_comparison(chip_smoke):
    a = np.arange(5, dtype=np.int64)
    assert chip_smoke._same_outputs((a, [a, a]), (a.copy(), [a, a]))
    assert not chip_smoke._same_outputs((a, [a, a]), (a, [a, a + 1]))
    assert not chip_smoke._same_outputs(a, a.astype(np.int32))
    assert not chip_smoke._same_outputs((a, [a]), (a, [a, a]))


def test_chip_smoke_launch_sizes(chip_smoke):
    sizes = chip_smoke._launch_sizes(
        [(10, 5, True), (3, 0, True), (9, 7, False), (4, 1, True)],
        [("merge_path", (3, 4)), ("merge_path", (0, 0)),
         ("merge_path", (10, 0)), ("multi_merge_ranks", (1, 2, 3))])
    assert sizes == {"search": {"largest": 7, "median": 5},
                     "merge_path": {"largest": 10, "median": 8},
                     "multi_merge_ranks": {"largest": 6, "median": 6}}


def test_chip_smoke_model_phases_rehearse_on_cpu(chip_smoke):
    """Phases 9-12 at the smoke config: the CPU takes the plain version
    of ``ssd_chunk``, so no launches are counted."""
    import repro_torch.configs as C
    # the first large multithreaded torch.exp of a process can come back
    # about 1e-4 off (MKL vector math, seen on an AMX CPU): spend it here
    torch.exp(torch.rand(1 << 22))
    cfg = C.get_smoke("mamba2-1.3b")
    rec = chip_smoke.phase_ssd_kernel(
        "cpu", prefill_shape=chip_smoke.ssd_shape(cfg, 2, 64), reps=1)
    assert set(rec) == {"name", "route", "source", "replaces", "launches",
                        "max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms"}
    assert rec["name"] == "ssd_chunk" and rec["max_abs_err"] == 0.0
    assert rec["bound_ms"] > 0 and rec["library_ms"] is None
    assert (ROOT / rec["source"]).exists()
    out = chip_smoke.phase_prefill("cpu", cfg, 2, 64)
    assert out["launches"] == {"ssd_chunk": 0}
    assert out["max_abs"] == 0.0 and out["greedy"] == 1.0
    err = chip_smoke.phase_consistency("cpu", cfg, seq=48)
    assert err <= chip_smoke.CONSISTENCY_ATOL
    served = chip_smoke.phase_serve("cpu", cfg, n_requests=3, batch=2,
                                    max_new=4)
    assert served["new_tokens"] == 12


def test_ssd_bound_at_the_prefill_shape(chip_smoke):
    """The bound the kernel line reports: about 208 MB at 3.35 TB/s for
    bf16 (bytes); fp32 inputs are bound by the fp32 CUDA-core rate."""
    import repro_torch.configs as C
    shape = chip_smoke.ssd_shape(C.get("mamba2-1.3b"), 4, 2048)
    assert shape == (4, 8, 256, 64, 64, 128)
    ms, by = chip_smoke.ssd_bound(shape, torch.bfloat16)
    assert by == "bytes" and abs(ms - 0.062) < 0.001
    ms32, by32 = chip_smoke.ssd_bound(shape, torch.float32)
    # the causal half of G and of Y: 8.89 GFLOP at the fp32 peak
    assert by32 == "operations" and abs(ms32 - 0.1327) < 0.0001


def test_ssd_kernel_flops_at_the_prefill_shape(chip_smoke):
    """The work the kernels do at the prefill shape: G once per 8-head
    group over the 10 causal 64 x 64 tiles; bf16 Y over 136 16 x 16
    slices a head, three passes; fp32 Y over the 10 whole tiles."""
    import repro_torch.configs as C
    shape = chip_smoke.ssd_shape(C.get("mamba2-1.3b"), 4, 2048)
    g = 4 * 8 * 8 * 10 * 2 * 64 * 64 * 128
    assert chip_smoke.ssd_kernel_flops(shape, torch.bfloat16) == \
        g + 4 * 8 * 64 * 136 * 3 * 2 * 16 * 16 * 64
    assert chip_smoke.ssd_kernel_flops(shape, torch.float32) == \
        g + 4 * 8 * 64 * 10 * 2 * 64 * 64 * 64
    # padding: N 40 -> 48 (bf16) / 64 (fp32), P 24 -> 32 / 64, one tile
    assert chip_smoke.ssd_kernel_flops((1, 1, 16, 3, 24, 40),
                                       torch.bfloat16) == \
        2 * 64 * 64 * 48 + 3 * 10 * 3 * 2 * 16 * 16 * 32
    assert chip_smoke.ssd_kernel_flops((1, 1, 16, 3, 24, 40),
                                       torch.float32) == \
        2 * 64 * 64 * 64 + 3 * 2 * 64 * 64 * 64


def _ptxas(fn, regs, stores=0, loads=0):
    return (f"ptxas info    : Compiling entry function '{fn}' for "
            f"'sm_90a'\n"
            f"ptxas info    : Function properties for {fn}\n"
            f"    {stores} bytes stack frame, {stores} bytes spill stores, "
            f"{loads} bytes spill loads\n"
            f"ptxas info    : Used {regs} registers, used 1 barriers\n")


def test_ssd_build_report_flags_spills(chip_smoke):
    ok = _ptxas("k", 114)
    lines = chip_smoke.build_report({"ssd_chunk": ok})
    assert len(lines) == 3 and "114 registers" in lines[-1]
    assert all(ln.startswith("ssd_chunk: ") for ln in lines)
    assert chip_smoke.build_report({}) == []
    with pytest.raises(AssertionError, match="spills"):
        chip_smoke.build_report({"ssd_chunk": ok.replace(
            "0 bytes spill stores", "8 bytes spill stores")})


# nvcc -Xptxas -v as a library of two kernels prints it: the entry line,
# the function's properties, its registers, per kernel
_CLEAN = _ptxas("_Z6kernelILi64EEvPf", 96) + _ptxas("_Z6kernelILi128EEvPf",
                                                    128)
_SPILLING = _ptxas("_Z6kernelILi64EEvPf", 96) + \
    _ptxas("_Z6kernelILi128EEvPf", 128, stores=24, loads=36)


def test_build_report_checks_every_source(chip_smoke):
    """Every library's lines are reported and checked: a spill in any
    source stops the run, naming the source and the function."""
    logs = {name: _CLEAN for name in chip_smoke.build.SOURCES}
    lines = chip_smoke.build_report(logs)
    assert len(lines) == 6 * len(chip_smoke.build.SOURCES)
    assert {ln.split(":")[0] for ln in lines} == \
        set(chip_smoke.build.SOURCES)
    for name in chip_smoke.build.SOURCES:
        bad = dict(logs, **{name: _SPILLING})
        with pytest.raises(AssertionError,
                           match=f"{name}.cu spills registers in "
                                 f"_Z6kernelILi128EEvPf"):
            chip_smoke.build_report(bad)


def test_build_target_follows_the_shared_headers(tmp_path, monkeypatch):
    """A library is named by a hash of its source and of every
    ``csrc/*.cuh``: an edited or added header rebuilds it."""
    from repro_torch.kernels import build
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build._target("k")
    assert build._target("k") == first
    assert first.parent == build.BUILD_DIR and first.name.startswith("k-")
    (tmp_path / "h.cuh").write_text("// two\n")
    second = build._target("k")
    assert second != first
    (tmp_path / "g.cuh").write_text("// another header\n")
    assert build._target("k") not in (first, second)

def test_chip_smoke_dense_phases_rehearse_on_cpu(chip_smoke):
    """Phases 13-18 at small shapes and the smoke config: the CPU takes
    the plain versions, so no launches are counted."""
    import repro_torch.configs as C
    cfg = C.get_smoke("qwen2-7b")
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    flash = chip_smoke.phase_flash_kernel(
        "cpu", prefill_shape=chip_smoke.attn_shape(cfg, 2, 64),
        shapes=chip_smoke.ATTN_SHAPES[:1], reps=1)
    bsmm = chip_smoke.phase_bsmm_kernel(
        "cpu", card_case=(256, 256, 64, 64, 64, 64, 0.3),
        shapes=chip_smoke.BSMM_SHAPES[-2:], reps=1)
    assert set(flash) == keys
    # the block-sparse row adds its bound's route and its bf16 card case
    assert set(bsmm) == keys | {"bound_route", "bf16"}
    assert bsmm["bound_route"] == "3xTF32 tensor cores"
    assert bsmm["bf16"]["bound_route"] == "bf16 tensor cores"
    assert bsmm["bf16"]["max_abs_err"] == 0.0
    for rec, name in ((flash, "flash_attention"),
                      (bsmm, "block_sparse_matmul")):
        assert rec["name"] == name
        assert rec["max_abs_err"] == 0.0 and rec["bound_ms"] > 0
        assert rec["library_ms"] > 0 and (ROOT / rec["source"]).exists()
    launches = chip_smoke.phase_kernels_bench("cpu")
    assert set(launches.values()) == {0}
    out = chip_smoke.phase_prefill("cpu", cfg, 2, 64)
    assert out["launches"] == {"flash_attention": 0}
    assert out["max_abs"] == 0.0 and out["greedy"] == 1.0
    err = chip_smoke.phase_consistency("cpu", cfg, seq=24)
    assert err <= chip_smoke.CONSISTENCY_ATOL
    served = chip_smoke.phase_serve("cpu", cfg, n_requests=3, batch=2,
                                    max_new=4)
    assert served["new_tokens"] == 12


def test_dense_bounds_at_the_card_shapes(chip_smoke):
    """The bounds the kernel line reports: flash attention at the
    Qwen2-7B prefill shape, about 120 GFLOP at the bf16 peak against
    134 MB; the card-sized block-sparse case, 2 bm bk N a tile by its
    route: three TF32 passes at the TF32 peak in fp32 against about
    147 MB, one pass at the bf16 peak in bf16 against 90.6 MB."""
    import repro_torch.configs as C
    shape = chip_smoke.attn_shape(C.get("qwen2-7b"), 4, 2048)
    assert shape == (4, 28, 4, 2048, 2048, 128)
    ms, by = chip_smoke.flash_bound(shape, torch.bfloat16)
    assert by == "operations" and abs(ms - 0.1217) < 0.0001
    full, _ = chip_smoke.flash_bound(shape, torch.bfloat16, causal=False)
    assert abs(full / ms - 2 * 2048 / 2049) < 1e-9
    ms, by, route = chip_smoke.bsmm_bound(1229, 128, 128, 8192, 1024, 8192,
                                          torch.float32)
    assert by == "operations" and abs(ms - 0.2499) < 0.0001
    assert route == "3xTF32 tensor cores"
    nbytes = 4 * (1229 * 128 * 128 + 8192 * 1024) + 8 * 1229 \
        + 4 * 8192 * 1024
    assert abs(nbytes / 1e6 - 147.7) < 0.1
    ms, by, route = chip_smoke.bsmm_bound(1229, 128, 128, 8192, 1024, 8192,
                                          torch.bfloat16)
    assert by == "operations" and abs(ms - 0.0417) < 0.0001
    assert route == "bf16 tensor cores"
    nbytes = 2 * (1229 * 128 * 128 + 8192 * 1024) + 8 * 1229 \
        + 4 * 8192 * 1024
    assert abs(nbytes / 1e6 - 90.6) < 0.1
    # bf16 is exact in TF32: a mixed pair takes two passes
    for pair in ((torch.bfloat16, torch.float32),
                 (torch.float32, torch.bfloat16)):
        ms, _, route = chip_smoke.bsmm_bound(1229, 128, 128, 8192, 1024,
                                             8192, *pair)
        assert route == "2xTF32 tensor cores" and abs(ms - 0.1666) < 0.0001


def test_chip_smoke_needs_a_card(chip_smoke, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
