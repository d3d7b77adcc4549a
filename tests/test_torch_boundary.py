"""The port's boundary: no JAX and nothing of the reference package,
no silent CPU fallback, and ``chip_smoke.py``'s phases rehearsed on the
CPU at a tiny size."""
import ast
import contextlib
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

from repro_torch.models import api
for arch in ("qwen2-moe-a2.7b", "whisper-small", "jamba-1.5-large-398b"):
    cfg = C.get_smoke(arch)
    params = api.init(cfg, torch.Generator().manual_seed(0))
    batch = api.make_batch(cfg, torch.Generator().manual_seed(1), 1, 32)
    logits = make_prefill_step(cfg, device="cpu")(params, batch)
    assert logits.shape == (1, 32, 512)
    assert bool(torch.isfinite(logits).all()), arch

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
                        "bound_by", "bound_route", "library_ms", "fp32"}
    assert rec["name"] == "ssd_chunk" and rec["max_abs_err"] == 0.0
    # the fp32 record rides inside the bf16 one, with its own route
    assert set(rec["fp32"]) == set(chip_smoke.TIMED_KEYS)
    assert rec["bound_route"] == "bf16 tensor cores"
    assert rec["fp32"]["bound_route"] == "3xTF32 tensor cores"
    assert rec["fp32"]["max_abs_err"] == 0.0
    assert rec["bound_ms"] > 0 and rec["library_ms"] is None
    assert (ROOT / rec["source"]).exists()
    out = chip_smoke.phase_prefill("cpu", cfg, 2, 64)
    assert out["launches"] == {"ssd_chunk": 0}
    assert out["max_abs"] == 0.0 and out["greedy"] == 1.0
    out = chip_smoke.phase_consistency("cpu", cfg, seq=48)
    assert out["max_abs"] <= chip_smoke.CONSISTENCY_ATOL
    assert out["launches"] == out["decode_launches"] == {"ssd_chunk": 0}
    assert out["held"] == {"ssd_chunk": 0.0}
    served = chip_smoke.phase_serve("cpu", cfg, n_requests=3, batch=2,
                                    max_new=4)
    assert served["new_tokens"] == 12


def test_ssd_bound_at_the_prefill_shape(chip_smoke):
    """The bound the kernel line reports: about 208 MB at 3.35 TB/s for
    bf16 (bytes); fp32 inputs on 3xTF32 tensor cores are bound by their
    279 MB too, the operations (three passes of 8.89 GFLOP at the TF32
    peak, 0.0539 ms) under them.  On the fp32 CUDA cores, the first
    port's route, the operations alone took 0.1327 ms."""
    import repro_torch.configs as C
    shape = chip_smoke.ssd_shape(C.get("mamba2-1.3b"), 4, 2048)
    assert shape == (4, 8, 256, 64, 64, 128)
    ms, by, route = chip_smoke.ssd_bound(shape, torch.bfloat16)
    assert by == "bytes" and abs(ms - 0.062) < 0.001
    assert route == "bf16 tensor cores"
    ms32, by32, route32 = chip_smoke.ssd_bound(shape, torch.float32)
    assert by32 == "bytes" and abs(ms32 - 0.0833) < 0.0001
    assert route32 == "3xTF32 tensor cores"
    flops = chip_smoke.ssd_flops(shape)
    assert abs(flops / 1e9 - 8.89) < 0.01
    ops, _ = chip_smoke.route_ms(flops, torch.float32)
    assert abs(ops - 0.0539) < 0.0001
    assert abs(flops / chip_smoke.PEAK_FLOPS[torch.float32] * 1e3
               - 0.1327) < 0.0001


def test_ssd_kernel_flops_at_the_prefill_shape(chip_smoke):
    """The work the kernels do at the prefill shape: G once per 8-head
    group over the 10 causal 64 x 64 tiles, one pass in bf16 and three
    (3xTF32) in fp32; Y over 136 16 x 16 slices a head, three passes in
    both."""
    import repro_torch.configs as C
    shape = chip_smoke.ssd_shape(C.get("mamba2-1.3b"), 4, 2048)
    g = 4 * 8 * 8 * 10 * 2 * 64 * 64 * 128
    y = 4 * 8 * 64 * 136 * 3 * 2 * 16 * 16 * 64
    assert chip_smoke.ssd_kernel_flops(shape, torch.bfloat16) == g + y
    assert chip_smoke.ssd_kernel_flops(shape, torch.float32) == 3 * g + y
    # padding: N 40 -> 48 (bf16 k16 steps) / 40 (TF32 k8 steps), P 24 ->
    # 32, one tile
    assert chip_smoke.ssd_kernel_flops((1, 1, 16, 3, 24, 40),
                                       torch.bfloat16) == \
        2 * 64 * 64 * 48 + 3 * 10 * 3 * 2 * 16 * 16 * 32
    assert chip_smoke.ssd_kernel_flops((1, 1, 16, 3, 24, 40),
                                       torch.float32) == \
        3 * 2 * 64 * 64 * 40 + 3 * 10 * 3 * 2 * 16 * 16 * 32


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

def test_chip_smoke_flash_shapes_time_each_named_call(chip_smoke):
    """Phase 19's flash half at small shapes on the CPU: every call held
    to the plain version, and the calls ``timed`` names (on the card,
    Whisper's encoder and its one-query cross-attention) timed in both
    dtypes beside their route's bound and SDPA."""
    cases = (((1, 2, 2, 40, 40, 32), False), ((1, 2, 2, 24, 24, 32), True),
             ((1, 2, 2, 1, 40, 32), False))
    timed = {"encoder": 0, "cross_decode": 2}
    recs = chip_smoke.phase_flash_shapes("cpu", cases, timed=timed, reps=1)
    assert set(recs) == set(timed)
    for label, i in timed.items():
        assert set(recs[label]) == {"bf16", "fp32"}
        for dtype, r in recs[label].items():
            assert r["shape"] == list(cases[i][0])
            assert r["causal"] == cases[i][1]
            assert r["max_abs_err"] == 0.0 and r["library_ms"] > 0
            assert r["bound_route"] == {"bf16": "bf16 tensor cores",
                                        "fp32": "3xTF32 tensor cores"}[dtype]
    (b, h, hkv, sq, sk, d), causal = chip_smoke.WHISPER_ATTN[
        chip_smoke.WHISPER_TIMED["cross_decode"]]
    assert sq == 1 and sk == 1500 and not causal


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
    # both rows add their bound's route; flash its fp32 prefill record,
    # the block-sparse row its bf16 card case
    assert set(flash) == keys | {"bound_route", "fp32"}
    assert flash["bound_route"] == "bf16 tensor cores"
    assert flash["fp32"]["bound_route"] == "3xTF32 tensor cores"
    assert flash["fp32"]["max_abs_err"] == 0.0
    assert flash["fp32"]["library_ms"] > 0
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
    out = chip_smoke.phase_consistency("cpu", cfg, seq=24)
    assert out["max_abs"] <= chip_smoke.CONSISTENCY_ATOL
    assert out["launches"] == {"flash_attention": 0}
    assert out["held"] == {"flash_attention": 0.0}
    served = chip_smoke.phase_serve("cpu", cfg, n_requests=3, batch=2,
                                    max_new=4)
    assert served["new_tokens"] == 12


def test_dense_bounds_at_the_card_shapes(chip_smoke):
    """The bounds the kernel line reports: flash attention at the
    Qwen2-7B prefill shape, about 120 GFLOP at the bf16 peak against
    134 MB, and in fp32 three TF32 passes at the TF32 peak, there and at
    Whisper's encoder; ``ssd_chunk`` in fp32 at the Mamba2 and Jamba
    prefill shapes, bound by their bytes on 3xTF32; the card-sized
    block-sparse case, 2 bm bk N a tile by its route: three TF32 passes
    at the TF32 peak in fp32 against about 147 MB, one pass at the bf16
    peak in bf16 against 90.6 MB."""
    import repro_torch.configs as C
    shape = chip_smoke.attn_shape(C.get("qwen2-7b"), 4, 2048)
    assert shape == (4, 28, 4, 2048, 2048, 128)
    ms, by, route = chip_smoke.flash_bound(shape, torch.bfloat16)
    assert by == "operations" and abs(ms - 0.1217) < 0.0001
    assert route == "bf16 tensor cores"
    full, _, _ = chip_smoke.flash_bound(shape, torch.bfloat16, causal=False)
    assert abs(full / ms - 2 * 2048 / 2049) < 1e-9
    # fp32 on 3xTF32: the first port's CUDA-core figures were 1.7958 and
    # 0.4127 ms
    ms, by, route = chip_smoke.flash_bound(shape, torch.float32)
    assert by == "operations" and abs(ms - 0.7292) < 0.0001
    assert route == "3xTF32 tensor cores"
    (enc, causal), = [c for c in chip_smoke.WHISPER_ATTN
                      if c[0][3] == c[0][4] == 1500]
    ms, by, _ = chip_smoke.flash_bound(enc, torch.float32, causal)
    assert by == "operations" and abs(ms - 0.1676) < 0.0001
    for cfg, want in ((C.get("mamba2-1.3b"), 0.0833),
                      (chip_smoke.hybrid_config(), 0.1640)):
        ms, by, route = chip_smoke.ssd_bound(
            chip_smoke.ssd_shape(cfg, 4, 2048), torch.float32)
        assert by == "bytes" and abs(ms - want) < 0.0001
        assert route == "3xTF32 tensor cores"
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


@pytest.mark.parametrize("arch,seq", [("qwen2-moe-a2.7b", 64),
                                      ("whisper-small", 24),
                                      ("jamba-1.5-large-398b", 64)])
def test_chip_smoke_family_phases_rehearse_on_cpu(chip_smoke, arch, seq):
    """Phases 20-29 at the smoke configs: the CPU takes the plain
    versions, so every kernel of the family counts 0 launches; the MoE
    families report their dropped share."""
    import repro_torch.configs as C
    torch.exp(torch.rand(1 << 22))       # see the model phases' test
    cfg = C.get_smoke(arch)
    out = chip_smoke.phase_prefill("cpu", cfg, 2, seq)
    want = {"moe": {"flash_attention": 0}, "encdec": {"flash_attention": 0},
            "hybrid": {"flash_attention": 0, "ssd_chunk": 0}}[cfg.family]
    assert out["launches"] == want
    assert out["max_abs"] == 0.0 and out["greedy"] == 1.0
    assert (out["dropped"] is None) == (cfg.family == "encdec")
    cons = chip_smoke.consistency_config(cfg)
    assert (cons.moe is None) == (cfg.family == "encdec")
    out = chip_smoke.phase_consistency("cpu", cons, seq=32)
    assert out["max_abs"] <= chip_smoke.CONSISTENCY_ATOL
    assert out["launches"] == out["decode_launches"] == want
    assert out["held"] == {n: 0.0 for n in want}
    served = chip_smoke.phase_serve("cpu", cfg, n_requests=3, batch=2,
                                    max_new=4)
    assert served["new_tokens"] == 12
    if cfg.family == "moe":
        rec = chip_smoke.phase_moe_dispatch("cpu", cfg, shape=(2, 64),
                                            reps=1)
        assert rec["max_abs_err"] == 0.0 and 0 < rec["dropped"] < 1


def test_chip_smoke_family_driver_rehearses_on_cpu(chip_smoke, capsys):
    """``phase_families`` over the three smoke configs: every phase runs
    and logs its seconds, and each prefill path reports its launches."""
    import repro_torch.configs as C
    torch.exp(torch.rand(1 << 22))
    plan = [(a.split("-")[0], C.get_smoke(a), 32,
             chip_smoke.consistency_config(C.get_smoke(a)), 32)
            for a in ("qwen2-moe-a2.7b", "whisper-small",
                      "jamba-1.5-large-398b")]
    paths, cons = chip_smoke.phase_families("cpu", "cpu", plan, batch=2,
                                            dispatch_shape=(2, 32))
    flash, both = {"flash_attention": 0}, {"flash_attention": 0,
                                           "ssd_chunk": 0}
    assert paths == {"qwen2_prefill": flash, "qwen2_consistency": flash,
                     "whisper_prefill": flash,
                     "whisper_consistency": flash,
                     "whisper_consistency_decode": flash,
                     "jamba_prefill": both, "jamba_consistency": both}
    assert set(cons) == {"qwen2_consistency", "whisper_consistency",
                         "jamba_consistency"}
    assert cons["jamba_consistency"]["held"] == {"flash_attention": 0.0,
                                                 "ssd_chunk": 0.0}
    out = capsys.readouterr().out
    for name in ("qwen2_prefill", "qwen2_prefill_faults",
                 "qwen2_consistency", "qwen2_serve",
                 "qwen2_dispatch", "whisper_serve", "jamba_consistency"):
        assert f"phase {name}: " in out


def test_chip_smoke_prefill_launches_by_family(chip_smoke):
    """The launches the card phases expect: one flash a layer (Qwen2-MoE
    24), Whisper's encoder layers and two a decoder layer (36), and for
    the reduced Jamba 1 flash and 7 ``ssd_chunk``."""
    import repro_torch.configs as C
    got = {a: chip_smoke.prefill_launches(C.get(a)) for a in
           ("qwen2-moe-a2.7b", "whisper-small", "mamba2-1.3b", "qwen2-7b")}
    assert got == {"qwen2-moe-a2.7b": {"flash_attention": 24},
                   "whisper-small": {"flash_attention": 36},
                   "mamba2-1.3b": {"ssd_chunk": 48},
                   "qwen2-7b": {"flash_attention": 28}}
    assert chip_smoke.prefill_launches(chip_smoke.hybrid_config()) == \
        {"flash_attention": 1, "ssd_chunk": 7}


def test_chip_smoke_decode_launches_by_family(chip_smoke):
    """The launches the consistency phases expect of their fp32 decode
    steps: Whisper's cross-attention, one a decoder layer a step (12 x
    128); every other family decodes in plain torch."""
    import repro_torch.configs as C
    got = {a: chip_smoke.decode_launches(C.get(a), 128) for a in
           ("whisper-small", "mamba2-1.3b", "qwen2-7b", "qwen2-moe-a2.7b")}
    assert got == {"whisper-small": {"flash_attention": 1536},
                   "mamba2-1.3b": {"ssd_chunk": 0},
                   "qwen2-7b": {"flash_attention": 0},
                   "qwen2-moe-a2.7b": {"flash_attention": 0}}
    assert chip_smoke.decode_launches(chip_smoke.hybrid_config(), 256) == \
        {"flash_attention": 0, "ssd_chunk": 0}


def test_chip_smoke_consistency_holds_each_kernel_call(chip_smoke):
    """``record_calls`` keeps one call of each kernel signature of an
    fp32 prefill (both kernels of the hybrid), and ``hold_calls`` holds
    each to its plain version on those inputs: sound kernels pass, a
    ``flash_attention`` that drops its last keys fails at its own
    shape."""
    import dataclasses
    import repro_torch.configs as C
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import api
    cfg = dataclasses.replace(C.get_smoke("jamba-1.5-large-398b"),
                              dtype="float32")
    params = api.init(cfg, torch.Generator().manual_seed(0), "cpu")
    data = api.make_batch(cfg, torch.Generator().manual_seed(1), 1, 32)
    data = {k: v if k in ("tokens", "labels") else v.float()
            for k, v in data.items()}
    step = make_prefill_step(cfg, "cpu")
    for fault in (None, chip_smoke._drop_key_tile):
        calls = {}
        with contextlib.ExitStack() as stack:
            if fault is not None:
                stack.enter_context(chip_smoke.planted_fault(fault))
            stack.enter_context(chip_smoke.record_calls(cfg, calls))
            step(params, data)
        assert sorted(c[0] for c in calls.values()) == \
            ["flash_attention", "ssd_chunk"]
        if fault is None:
            assert chip_smoke.hold_calls(calls, "sound") == \
                {"flash_attention": 0.0, "ssd_chunk": 0.0}
        else:
            with pytest.raises(AssertionError,
                               match="flash_attention != plain"):
                chip_smoke.hold_calls(calls, "planted")


def test_chip_smoke_attach_model_paths(chip_smoke):
    """The kernels line's launches: the model paths and the throughput
    path added to each record, the fp32 route's own launches and held
    errors from the consistency paths; a kernel whose fp32 route never
    launched fails the run."""
    def records():
        return [{"name": "search", "launches": 5,
                 "launches_by_path": {"main": 5}},
                {"name": "ssd_chunk", "launches": 48, "fp32": {}},
                {"name": "flash_attention", "launches": 28, "fp32": {}},
                {"name": "block_sparse_matmul", "launches": 4,
                 "bf16": {}}]
    paths = {"jamba_prefill": {"flash_attention": 1, "ssd_chunk": 7},
             "consistency": {"ssd_chunk": 48},
             "dense_consistency": {"flash_attention": 28},
             "whisper_consistency": {"flash_attention": 36},
             "whisper_consistency_decode": {"flash_attention": 1536}}
    cons = {"consistency": {"held": {"ssd_chunk": 3e-6}},
            "dense_consistency": {"held": {"flash_attention": 2e-6}},
            "whisper_consistency": {"held": {"flash_attention": 1e-6}}}
    throughput = {"search": 56, "ssd_chunk": 0, "flash_attention": 0,
                  "block_sparse_matmul": 0}
    kernels = records()
    chip_smoke.attach_model_paths(kernels, paths, cons, throughput)
    search, ssd, flash, bsmm = kernels
    assert search["launches"] == 61
    assert search["launches_by_path"] == {"main": 5, "throughput": 56}
    assert ssd["launches"] == 48 + 7 + 48
    assert ssd["launches_by_path"] == {"prefill": 48, "jamba_prefill": 7,
                                       "consistency": 48, "throughput": 0}
    assert ssd["fp32"] == {"launches": 48,
                           "launches_by_path": {"consistency": 48},
                           "max_abs_err_by_path": {"consistency": 3e-6}}
    assert flash["fp32"]["launches"] == 28 + 36 + 1536
    assert flash["fp32"]["max_abs_err_by_path"] == {
        "dense_consistency": 2e-6, "whisper_consistency": 1e-6}
    assert flash["launches"] == 28 + 1 + 28 + 36 + 1536
    assert bsmm["launches_by_path"] == {"kernels_bench": 4,
                                        "throughput": 0}
    assert "launches" not in bsmm["bf16"]
    paths["consistency"] = {"ssd_chunk": 0}
    with pytest.raises(AssertionError, match="ssd_chunk never launched "
                                             "on the fp32"):
        chip_smoke.attach_model_paths(records(), paths, cons, throughput)


def test_chip_smoke_family_kernel_cases(chip_smoke):
    """Phase 19 holds flash at every attention shape of the family paths:
    Whisper's four, then one causal prefill layer of Qwen2-MoE (16 heads)
    and of the reduced Jamba (32 heads over 8 KV heads)."""
    cases = chip_smoke.family_attn_cases()
    assert cases[:4] == chip_smoke.WHISPER_ATTN
    assert cases[4:] == (((4, 16, 16, 2048, 2048, 128), True),
                         ((4, 32, 8, 2048, 2048, 128), True))


def test_chip_smoke_prefill_faults_rehearse_on_cpu(chip_smoke):
    """Phase moe_prefill_faults at the MoE smoke config: the sound readings
    agree exactly on the CPU; the dropped key tile fails the prefill
    limits; every planted fault fails the kernel hold."""
    import repro_torch.configs as C
    torch.exp(torch.rand(1 << 22))       # see the model phases' test
    cfg = C.get_smoke("qwen2-moe-a2.7b")
    out = chip_smoke.phase_prefill_faults("cpu", cfg, 2, 128, seeds=(0, 1))
    assert set(out) == {"seed 0", "seed 1", *chip_smoke.PREFILL_FAULTS}
    for s in ("seed 0", "seed 1"):
        assert out[s]["max_abs"] == 0.0 and out[s]["fails"] == []
    assert out["drop_key_tile"]["fails"] == ["max_abs", "mean_abs", "greedy"]
    for name in chip_smoke.PREFILL_FAULTS:
        assert out[name]["kernel_err"] > \
            chip_smoke.FLASH_ATOL[torch.bfloat16]
    assert chip_smoke.flash_attention.launches == 0


def test_family_configs_at_their_card_sizes(chip_smoke):
    """Parameters counted on the meta device: Qwen2-MoE-A2.7B 14.32B
    (28.6 GB in bf16), the reduced Jamba 11.56B (23.1 GB in bf16, 46.3
    GB in fp32) with the routing and SSM shapes of the full config."""
    import repro_torch.configs as C
    from repro_torch.models import api
    from repro_torch.models import ssm as S

    def count(cfg):
        return sum(p.numel() for p in api.init(cfg, None, "meta")
                   .parameters())
    assert abs(count(C.get("qwen2-moe-a2.7b")) / 1e9 - 14.32) < 0.01
    hyb, full = chip_smoke.hybrid_config(), C.get("jamba-1.5-large-398b")
    assert abs(count(hyb) / 1e9 - 11.56) < 0.01
    assert (hyb.moe.n_experts, hyb.moe.top_k, hyb.ssm, hyb.hdim) == \
        (full.moe.n_experts, full.moe.top_k, full.ssm, full.hdim)
    assert S.dims(hyb)[1:4] == (128, 64, 128)       # heads, P, N
    assert chip_smoke.ssd_shape(hyb, 4, 2048) == (4, 8, 256, 128, 64, 128)
