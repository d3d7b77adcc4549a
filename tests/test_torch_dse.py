"""The port's design-space exploration layer against the reference, on
the CPU.

The same seeded numpy workloads go through both packages' sweep engines:
per-point objectives, fallback reasons, Pareto fronts, result keys,
workload hashes and search picks are equal -- bit for bit, no tolerance
-- on the analytic backend, the vector backend (the port on
``device='cpu'``: the kernels' plain versions; the reference on numpy)
and the interpreter.  Checkpoints and sweep checkpoints written by
either package load and resume in the other.  Seam faults injected into
the port are recorded, never silent, and on a lowering without the CPU's
interpreter fallback (the card's rule) they fail the point.
"""
import dataclasses
import json
import os
import threading

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.checkpoint.store as RS
import repro.dse as RD
import repro.testing.faults as RF

import repro_torch.checkpoint.store as TS
import repro_torch.dse as TD
import repro_torch.testing.faults as TF
from repro_torch.bench import dse_sweep
from repro_torch.core.fibertree import FTensor as TFT
from repro_torch.core.iteration import PythonBackend
from repro_torch.core.vectorized import VectorBackend
from repro_torch.kernels import backends as kbk
from repro_torch.launch.mesh import host_shard
from repro_torch.obs.export import cli_trace
from repro.core.fibertree import FTensor as RFT

CAPS = (0.002, 0.01, 0.05, 0.25, 1.0, 3.0)


def _workload(n=48, d=0.15, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.random((n, n)) * (rng.random((n, n)) < d)
    b = rng.random((n, n)) * (rng.random((n, n)) < d)
    return {"A": a, "B": b}, {"m": n, "k": n, "n": n}


def _space(pkg, values=CAPS):
    return pkg.DesignSpace("gamma", axes={"fibercache_mb": list(values)})


def _objectives(results):
    return [(r.label, r.seconds, r.energy_pj, r.dram_bytes,
             dict(r.fallback_reasons), r.error) for r in results]


def _port_engine(inputs, shapes, backend, **kw):
    if backend == "vector":
        kw.setdefault("device", "cpu")
    return TD.SweepEngine(inputs, shapes, backend=backend, **kw)


@pytest.fixture(autouse=True)
def _clean_guard_state():
    """Injected seam faults count towards the process-wide demotion of
    a seam; every test starts and ends with none."""
    kbk.reset_guard_state()
    TF.clear_injector()
    yield
    TF.clear_injector()
    kbk.reset_guard_state()


# ---------------------------------------------------------------------- #
# sweeps against the reference
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("backend,n,caps", [
    ("analytic", 48, CAPS), ("vector", 32, CAPS[:3]),
    ("python", 24, CAPS[:2])])
def test_sweep_matches_reference(backend, n, caps):
    inputs, shapes = _workload(n=n)
    ref = RD.SweepEngine(inputs, shapes, backend=backend).sweep(
        _space(RD, caps).grid())
    got = _port_engine(inputs, shapes, backend).sweep(
        _space(TD, caps).grid())
    assert all(r.ok for r in got), [r.error for r in got]
    assert _objectives(got) == _objectives(ref)
    assert [r.label for r in TD.pareto_front(got)] == \
        [r.label for r in RD.pareto_front(ref)]
    if backend != "python":
        # Gamma's default plan runs natively on both engines of the port
        assert all(r.fallback_reasons == {} for r in got)


def test_batched_sweep_equals_per_point():
    inputs, shapes = _workload()
    pts = _space(TD).grid()
    eng = TD.SweepEngine(inputs, shapes, backend="analytic")
    batched = eng.sweep(pts)
    scalar = TD.SweepEngine(inputs, shapes, backend="analytic",
                            batch=False).sweep(pts)
    assert _objectives(batched) == _objectives(scalar)
    # one probe through the backend, every other point replayed
    assert eng.plan_cache_hits == len(pts) - 1


@pytest.mark.parametrize("executor,backend", [
    ("thread", "vector"), ("thread", "python"), ("process", "analytic"),
    ("process", "vector")])
def test_executors_equal_serial(executor, backend):
    n, caps = (48, CAPS) if backend == "analytic" else (24, CAPS[:4])
    inputs, shapes = _workload(n=n)
    pts = _space(TD, caps).grid()
    serial = _port_engine(inputs, shapes, backend).sweep(pts)
    par = _port_engine(inputs, shapes, backend, executor=executor,
                       max_workers=2 if executor == "process" else 4
                       ).sweep(pts)
    assert all(r.ok for r in par), [r.error for r in par]
    assert _objectives(par) == _objectives(serial)


def test_pool_spawns_when_seams_run_through_torch():
    inputs, shapes = _workload(n=8)
    assert TD.SweepEngine(inputs, shapes)._start_method() == "fork"
    assert TD.SweepEngine(inputs, shapes,
                          backend="python")._start_method() == "fork"
    eng = _port_engine(inputs, shapes, "vector")
    assert eng._start_method() == "spawn"
    eng.device = torch.device("cuda")
    assert eng._start_method() == "spawn"


def test_vector_engine_needs_a_card_or_a_named_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    inputs, shapes = _workload(n=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TD.SweepEngine(inputs, shapes, backend="vector")
    # the analytic engine is host numpy and needs neither
    assert TD.SweepEngine(inputs, shapes).sweep(
        _space(TD, CAPS[:1]).grid())[0].ok


def test_result_keys_and_workload_hashes_equal_reference():
    inputs, shapes = _workload(n=16)
    assert TD.workload_hash(inputs, shapes) == \
        RD.workload_hash(inputs, shapes)
    # fibertree operands hash by their dense image in both packages
    tin = {k: TFT.from_dense(k, ["K", "M"], v) for k, v in inputs.items()}
    rin = {k: RFT.from_dense(k, ["K", "M"], v) for k, v in inputs.items()}
    assert TD.workload_hash(tin, shapes) == RD.workload_hash(rin, shapes)
    wl = TD.workload_hash(inputs, shapes)
    for kw, params in (({"fibercache_mb": 1.0}, None),
                       ({"fibercache_mb": 2.0, "merge_radix": 8}, None),
                       ({}, {"K0": 32})):
        tp = TD.DesignPoint.make("gamma", kw, params)
        rp = RD.DesignPoint.make("gamma", kw, params)
        for backend in ("analytic", "vector", "python"):
            for mode in ("calibrated", "uniform"):
                assert TD.result_key(wl, "sig", tp, backend, mode) == \
                    RD.result_key(wl, "sig", rp, backend, mode)
    # the engines' own keys (mapping signature included)
    te = TD.SweepEngine(inputs, shapes, result_cache=TD.ResultCache())
    re_ = RD.SweepEngine(inputs, shapes, result_cache=RD.ResultCache())
    assert te._cache_key(TD.DesignPoint.make("gamma")) == \
        re_._cache_key(RD.DesignPoint.make("gamma"))


def test_result_cache_persists_across_packages(tmp_path):
    inputs, shapes = _workload()
    eng = RD.SweepEngine(inputs, shapes,
                         result_cache=RD.ResultCache(directory=tmp_path))
    first = eng.sweep(_space(RD).grid())
    cache = TD.ResultCache(directory=tmp_path)
    again = TD.SweepEngine(inputs, shapes, result_cache=cache).sweep(
        _space(TD).grid())
    assert all(r.cached for r in again)
    assert _objectives(again) == _objectives(first)


def test_searches_pick_the_reference_points():
    inputs, shapes = _workload()
    space_kw = dict(axes={"fibercache_mb": list(CAPS),
                          "merge_radix": [8, 32, 64]})
    picks = []
    for pkg in (RD, TD):
        space = pkg.DesignSpace("gamma", **space_kw)
        eng = pkg.SweepEngine(inputs, shapes,
                              result_cache=pkg.ResultCache())
        evo = pkg.EvolutionarySearch(space, eng, population=4,
                                     generations=4, elite=1, seed=0,
                                     objective="dram_bytes").run()
        lo = pkg.SweepEngine(inputs, shapes, mode="uniform")
        hi = pkg.SweepEngine(inputs, shapes)
        halving = pkg.HalvingSearch(space, [lo, hi], n=6, eta=3, seed=0,
                                    objective="dram_bytes").run()
        picks.append([(out.best.label, out.best_value, out.evaluations,
                       out.history, out.trajectory)
                      for out in (evo, halving)])
    assert picks[0] == picks[1]


def test_service_round_trip():
    inputs, shapes = _workload()
    pts = _space(TD).grid()
    want = RD.SweepEngine(inputs, shapes).sweep(_space(RD).grid())
    eng = TD.SweepEngine(inputs, shapes, result_cache=TD.ResultCache())
    with TD.SweepService(eng, max_batch=32, batch_window_s=0.01) as svc:
        futs = [svc.submit(p) for p in pts]
        res = [f.result(timeout=60) for f in futs]
        again = [svc.what_if(p, timeout=60) for p in pts]
        stats = svc.stats()
    assert _objectives(res) == _objectives(want)
    assert _objectives(again) == _objectives(want)
    assert all(r.cached for r in again)
    assert stats["requests"] == 2 * len(pts)
    with pytest.raises(TD.ServiceClosed):
        svc.submit(pts[0])


# ---------------------------------------------------------------------- #
# checkpoints
# ---------------------------------------------------------------------- #
def _tree(bf16, f32):
    return {"w": {"b": bf16, "a": f32},
            "steps": [np.arange(3, dtype=np.int32), (np.float64(2.5),)],
            "none": None}


def test_checkpoint_written_by_reference_loads_in_port(tmp_path):
    rng = np.random.default_rng(0)
    bf = rng.standard_normal((4, 3)).astype(ml_dtypes.bfloat16)
    f32 = rng.standard_normal(5).astype(np.float32)
    RS.save_checkpoint(tmp_path, 7, _tree(jnp.asarray(bf), f32),
                       extra_meta={"kind": "test"})
    like = _tree(torch.zeros(4, 3, dtype=torch.bfloat16),
                 torch.zeros(5))
    got, step = TS.load_checkpoint(tmp_path, like=like)
    assert step == 7
    assert got["w"]["b"].dtype == torch.bfloat16
    assert np.array_equal(got["w"]["b"].float().numpy(),
                          bf.astype(np.float32))
    assert np.array_equal(got["w"]["a"], f32)
    assert got["steps"][0].dtype == np.int32 and got["none"] is None
    assert isinstance(got["steps"][1], tuple)
    dev, _ = TS.restore_resharded(tmp_path, like, device="cpu")
    assert dev["w"]["a"].dtype == torch.float32
    assert torch.equal(dev["w"]["b"], got["w"]["b"])
    assert TS.load_manifest(tmp_path)["meta"] == {"kind": "test"}


def test_checkpoint_written_by_port_loads_in_reference(tmp_path):
    gen = torch.Generator().manual_seed(0)
    bf = torch.randn(4, 3, generator=gen).to(torch.bfloat16)
    f32 = torch.randn(5, generator=gen)
    TS.CheckpointManager(tmp_path).save(3, _tree(bf, f32))
    like = _tree(np.zeros((4, 3), ml_dtypes.bfloat16),
                 np.zeros(5, np.float32))
    got, step = RS.load_checkpoint(tmp_path, like=like)
    assert step == 3
    assert got["w"]["b"].dtype == ml_dtypes.bfloat16
    assert np.array_equal(got["w"]["b"].astype(np.float32),
                          bf.float().numpy())
    assert np.array_equal(got["w"]["a"], f32.numpy())
    # the manifests agree on everything but the time stamp
    RS.save_checkpoint(tmp_path / "ref", 3, _tree(
        jnp.asarray(bf.float().numpy()).astype(jnp.bfloat16), f32.numpy()))
    mine = TS.load_manifest(tmp_path)
    theirs = RS.load_manifest(tmp_path / "ref")
    for m in (mine, theirs):
        m.pop("time")
    assert mine == theirs


def test_checkpoint_manager_async_save_and_retention(tmp_path):
    mgr = TS.CheckpointManager(tmp_path, keep=2)
    for step in range(4):
        mgr.save_async(step, {"x": torch.full((2,), float(step))})
    mgr.wait()
    assert mgr.steps() == [2, 3] and mgr.latest_step() == 3
    got, step = mgr.restore({"x": torch.zeros(2)}, device="cpu")
    assert step == 3 and torch.equal(got["x"], torch.full((2,), 3.0))


def _crash_then_resume(writer, reader, backend, inputs, shapes, ckpt):
    """A sweep of ``writer`` crashed at point 3 (an injected
    ``SimulatedCrash``), then resumed by ``reader``'s engine."""
    pts = _space(writer, CAPS).grid()
    inj = writer is TD and TF or RF
    inj.install_injector(inj.FaultInjector(
        [inj.FaultSpec(kind="crash", point=pts[3].label, at=1)]))
    try:
        eng = (_port_engine if writer is TD else RD.SweepEngine)(
            inputs, shapes, backend=backend)
        with pytest.raises(inj.SimulatedCrash):
            eng.sweep(pts, checkpoint_dir=str(ckpt), checkpoint_every=1)
    finally:
        inj.clear_injector()
    eng = (_port_engine if reader is TD else RD.SweepEngine)(
        inputs, shapes, backend=backend)
    return eng.sweep(_space(reader, CAPS).grid(), checkpoint_dir=str(ckpt),
                     resume=True)


@pytest.mark.parametrize("writer,reader", [
    ("port", "port"), ("reference", "port"), ("port", "reference")])
def test_crash_resume_bit_identical_across_packages(writer, reader,
                                                    tmp_path):
    pkgs = {"port": TD, "reference": RD}
    inputs, shapes = _workload()
    truth = TD.SweepEngine(inputs, shapes).sweep(_space(TD).grid())
    got = _crash_then_resume(pkgs[writer], pkgs[reader], "analytic",
                             inputs, shapes, tmp_path / "sweep")
    restored = [r for r in got if r.restored]
    assert len(restored) == 3
    assert _objectives(got) == _objectives(truth)
    assert [r.label for r in TD.pareto_front(got)] == \
        [r.label for r in TD.pareto_front(truth)]


def test_vector_crash_resume_bit_identical(tmp_path):
    inputs, shapes = _workload(n=24)
    truth = _port_engine(inputs, shapes, "vector").sweep(_space(TD).grid())
    got = _crash_then_resume(TD, TD, "vector", inputs, shapes,
                             tmp_path / "sweep")
    assert sum(r.restored for r in got) == 3
    assert _objectives(got) == _objectives(truth)


# ---------------------------------------------------------------------- #
# faults
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("text", [
    "seam=intersect_keys,backend=cuda,kind=raise,at=1",
    "seam=*,kind=raise,every=7;seam=segmented_reduce,kind=nan,at=2",
    "kind=crash,point=gamma(fibercache_mb=1.0),at=3,times=2",
    "kind=point-delay,delay-s=0.5,p=0.25", " ; kind=transient ;"])
def test_parse_faults_matches_reference(text):
    assert [dataclasses.asdict(s) for s in TF.parse_faults(text)] == \
        [dataclasses.asdict(s) for s in RF.parse_faults(text)]


@pytest.mark.parametrize("text", ["kind", "color=red", "kind=melt"])
def test_parse_faults_rejects_what_the_reference_rejects(text):
    with pytest.raises(ValueError):
        RF.parse_faults(text)
    with pytest.raises(ValueError):
        TF.parse_faults(text)


def test_env_faults_reach_the_port(monkeypatch):
    monkeypatch.setenv(TF.ENV_VAR, "seam=lookup_keys,kind=nan,at=2")
    inj = TF.active_injector()
    assert inj is not None and inj.specs[0].seam == "lookup_keys"
    monkeypatch.delenv(TF.ENV_VAR)
    assert TF.active_injector() is None


def test_seam_fault_on_cpu_is_recorded_and_isolated():
    """On the CPU the vector engine reruns a faulted Einsum on the
    interpreter: the point evaluates, with the fault as a recorded
    DowngradeEvent and a fallback reason; the next point is untouched."""
    inputs, shapes = _workload(n=24)
    pts = _space(TD, CAPS[:2]).grid()
    truth = _port_engine(inputs, shapes, "vector").sweep(pts)
    TF.install_injector(TF.FaultInjector([TF.FaultSpec(
        kind="raise", seam="intersect_keys", backend="torch", at=1)]))
    got = _port_engine(inputs, shapes, "vector").sweep(pts)
    inj = TF.active_injector()
    assert inj.seam_faults_fired == 1 and kbk.events_recorded() >= 1
    TF.verify_no_silent_downgrades()
    assert all(r.ok for r in got)
    assert "KernelChainExhausted" in next(iter(
        got[0].fallback_reasons.values()))
    assert _objectives(got[1:]) == _objectives(truth[1:])


def test_seam_fault_without_fallback_fails_the_point(monkeypatch):
    """The card's rule, on the CPU's lowering: with the interpreter
    fallback off (as on a CUDA device) an injected seam fault fails its
    point with a structured error, is recorded, and runs neither the
    interpreter nor anything after the faulted seam."""
    inputs, shapes = _workload(n=24)
    pts = _space(TD, CAPS[:3]).grid()
    oracle_calls = []
    execute = PythonBackend.execute
    monkeypatch.setattr(PythonBackend, "execute", lambda self, *a, **k: (
        oracle_calls.append(1), execute(self, *a, **k))[1])
    vb = VectorBackend(device="cpu")
    vb.fallback = False
    truth = TD.SweepEngine(inputs, shapes, backend=vb).sweep(pts)
    TF.install_injector(TF.FaultInjector([TF.FaultSpec(
        kind="raise", seam="intersect_keys", at=1)]))
    got = TD.SweepEngine(inputs, shapes, backend=vb).sweep(pts)
    assert not oracle_calls
    assert [r.ok for r in got] == [False, True, True]
    bad = got[0]
    assert bad.error_type == "KernelChainExhausted" and bad.traceback
    assert "injected raise fault at intersect_keys/torch" in bad.error
    assert kbk.events_recorded() >= 1
    TF.verify_no_silent_downgrades()
    assert _objectives(got[1:]) == _objectives(truth[1:])
    assert [r.label for r in TD.pareto_front(got)] == \
        [r.label for r in TD.pareto_front(truth[1:])]


def test_silent_seam_fault_fails_the_gate(monkeypatch):
    TF.install_injector(TF.FaultInjector([TF.FaultSpec(
        kind="raise", seam="intersect_keys", at=1)]))
    g = kbk.GuardedKernels(kbk.TorchKernels("cpu"))
    a = np.arange(4, dtype=np.int64)
    with pytest.raises(kbk.KernelChainExhausted):
        g.intersect_keys(a, a)
    assert [e.action for e in g.pop_events()] == ["downgrade"]
    TF.verify_no_silent_downgrades()
    monkeypatch.setattr(kbk, "events_recorded", lambda: 0)
    with pytest.raises(AssertionError, match="silent downgrade"):
        TF.verify_no_silent_downgrades()


def test_corrupted_seam_output_is_caught():
    TF.install_injector(TF.FaultInjector([TF.FaultSpec(
        kind="corrupt-pos", seam="lookup_keys", at=1)]))
    g = kbk.GuardedKernels(kbk.TorchKernels("cpu"))
    hay = np.arange(0, 20, 2, dtype=np.int64)
    with pytest.raises(kbk.KernelChainExhausted, match="out of range"):
        g.lookup_keys(hay, np.array([4, 5], dtype=np.int64))
    assert np.array_equal(g.lookup_keys(hay, np.array([4, 5])), [2, -1])


# ---------------------------------------------------------------------- #
# trace export, host sharding, the benchmark
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("suffix", [".json", ".jsonl"])
def test_cli_trace_has_one_span_per_point(tmp_path, suffix):
    inputs, shapes = _workload(n=16)
    pts = _space(TD).grid()
    path = tmp_path / f"sweep{suffix}"
    with cli_trace(path):
        TD.SweepEngine(inputs, shapes).sweep(pts)
    if suffix == ".json":
        events = json.loads(path.read_text())["traceEvents"]
    else:
        lines = [json.loads(ln) for ln in path.read_text().splitlines()]
        assert lines[-1]["kind"] == "metrics"
        events = lines[:-1]
    spans = [e["name"] for e in events if e.get("ph") == "X"
             and e["name"].startswith("point:")]
    assert sorted(spans) == sorted(f"point:{p.label}" for p in pts)


def test_host_shard_partitions_exactly(monkeypatch):
    items = list(range(10))
    shards = [host_shard(items, process_index=i, process_count=3)
              for i in range(3)]
    assert [len(s) for s in shards] == [4, 3, 3]
    assert sum(shards, []) == items
    assert host_shard(items) == items          # no process group
    with pytest.raises(ValueError):
        host_shard(items, process_index=3, process_count=3)
    import torch.distributed as dist
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 2)
    monkeypatch.setattr(dist, "get_world_size", lambda: 3)
    assert host_shard(items) == shards[2]
    assert host_shard(items, process_index=0) == shards[0]


def test_dse_sweep_bench_on_cpu(tmp_path):
    rows = dse_sweep.run(backend="vector", smoke=True, device="cpu")
    names = [r[0] for r in rows]
    assert names == ["dse/analytic/points2", "dse/vector/points1",
                     "dse/speedup_analytic_over_vector"]
    assert all(r[2] > 0 for r in rows)
    caps = dse_sweep.SMOKE_CAPACITIES_MB
    summary = dse_sweep.bench(capacities=caps,
                              backends=("analytic", "vector"),
                              exec_capacities=caps[:1], device="cpu")
    vec = summary["records"][1]
    assert vec["fallbacks"] == 0 and vec["device"] == "cpu"
    assert vec["coverage"]["ok"] == 1
    # the record takes card runs only
    with pytest.raises(ValueError, match="card runs only"):
        dse_sweep.record(summary, tmp_path / "BENCH_torch.json")
    trace = tmp_path / "t.json"
    assert dse_sweep.main(["--smoke", "--backend", "analytic",
                           "--trace", str(trace)]) == 0
    assert json.loads(trace.read_text())["traceEvents"]


def test_dse_sweep_sized_workload_on_cpu():
    """``bench(size=)`` (the record's path, here at 48^2): seeded
    fibertree operands of exactly ``nnz`` nonzeros, the analytic rate the
    median of its repeated sweeps, the vector points native and equal to
    the same sweep on the reference's 'vector' backend (numpy seams)."""
    inputs, shapes = dse_sweep.sparse_workload(48, 150)
    assert shapes == {"m": 48, "k": 48, "n": 48}
    assert all(np.count_nonzero(t.to_dense()) == 150
               for t in inputs.values())
    again, _ = dse_sweep.sparse_workload(48, 150)
    assert all(np.array_equal(inputs[k].to_dense(), again[k].to_dense())
               for k in inputs)
    caps = [0.002, 6.0]
    summary = dse_sweep.bench(capacities=dse_sweep.SMOKE_CAPACITIES_MB,
                              backends=("analytic", "vector"),
                              exec_capacities=caps, device="cpu",
                              size=(48, 150))
    assert summary["size"] == {"m": 48, "k": 48, "n": 48,
                               "nnz_per_operand": 150}
    ana, vec = summary["records"]
    assert ana["sweeps"] == dse_sweep.ANALYTIC_REPEATS
    lo, hi = ana["points_per_sec_range"]
    assert lo <= ana["points_per_sec"] <= hi
    assert vec["sweeps"] == 1 and vec["points"] == 2 and not vec["fallbacks"]
    # the fibertree operands (stored in Gamma's rank order: A as [M, K])
    # give the reference's numbers for the same matrices as dense arrays
    # in the declared order ([K, M])
    dense = {k: np.transpose(t.to_dense(), [t.ranks.index(r) for r in
                                            ("K", "M" if k == "A" else "N")])
             for k, t in inputs.items()}
    ref = RD.SweepEngine(dense, shapes, backend="vector").sweep(
        _space(RD, caps).grid())
    ours = _port_engine(inputs, shapes, "vector").sweep(
        _space(TD, caps).grid())
    assert all(r.ok for r in ours) and _objectives(ours) == _objectives(ref)
    # the record measures its own workload and backends
    for argv in (["--record", "--smoke"], ["--record", "--backend",
                                            "vector"]):
        with pytest.raises(SystemExit):
            dse_sweep.main(argv)


def test_runner_runs_dse_with_a_trace(tmp_path, capsys):
    from repro_torch.bench import run
    trace = tmp_path / "run.jsonl"
    assert run.main(["--only", "dse", "--smoke", "--device", "cpu",
                     "--trace", str(trace)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,us_per_call,derived"
    assert [ln.split(",")[0] for ln in out[1:]] == [
        "dse/analytic/points2", "dse/vector/points1",
        "dse/speedup_analytic_over_vector"]
    assert trace.read_text().count("point:") >= 3


# ---------------------------------------------------------------------- #
# the kernel build under threads
# ---------------------------------------------------------------------- #
def test_build_is_safe_across_threads(tmp_path, monkeypatch):
    """Two threads that reach an unbuilt kernel at once build it once
    (a stub nvcc that takes a while and counts its runs)."""
    from repro_torch.kernels import build
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// kernel\n")
    runs = tmp_path / "runs"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\necho run >> " + str(runs) + "\n"
                    "sleep 0.3\n"
                    'while [ "$1" != "-o" ]; do shift; done\n'
                    'echo lib > "$2"\n')
    os.chmod(nvcc, 0o755)
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    paths, errors = [], []

    def worker():
        try:
            paths.append(build.build(["k"])["k"])
        except Exception as exc:              # noqa: BLE001 - reported
            errors.append(exc)

    threads = [threading.Thread(target=worker) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert len(paths) == 2 and paths[0] == paths[1]
    assert paths[0].read_text() == "lib\n"
    assert runs.read_text().count("run") == 1
    assert not list((tmp_path / "out").glob("*.tmp"))
