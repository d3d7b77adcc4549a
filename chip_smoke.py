#!/usr/bin/env python3
"""Run the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each a function of a device and a size, so that a CPU test can
rehearse them at a tiny size with the kernels' plain versions:

  1. device   -- the card's name and power limit;
  2. build    -- compile the CUDA kernels from ``src/repro_torch/kernels``
                 and print nvcc's register / shared-memory lines;
  3. kernels  -- each kernel against its plain version (exact) at the main
                 path's shapes and on four adversarial key domains, timed
                 beside its bytes bound and one PyTorch library call;
  4. oracle   -- every design and union cascade at a small size on the
                 card, against the interpreter oracle (bit-exact, with
                 counters) and the dense reference;
  5. main     -- ``simulate`` for the paper's designs at full
                 widths, once with the hand kernels and once with the
                 plain versions on the card: identical outputs, counters
                 and Reports, no fallback, no downgrade, every kernel
                 launched.

The second-to-last line lists the kernels as JSON; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script
exits non-zero before printing any result.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.accelerators import (DEFAULT_PARAMS, REGISTRY,  # noqa: E402
                                      simulate)
from repro_torch.accelerators.zoo import ZOO  # noqa: E402
from repro_torch.core.csf import CSF  # noqa: E402
from repro_torch.core.generator import check_against_dense  # noqa: E402
from repro_torch.core.iteration import PythonBackend  # noqa: E402
from repro_torch.core.trace import CollectingInstr  # noqa: E402
from repro_torch.core.vectorized import VectorBackend  # noqa: E402
from repro_torch.kernels import (KERNELS, build, merge_path,  # noqa: E402
                                 merge_path_plain, multi_merge_ranks,
                                 multi_merge_ranks_plain, search,
                                 search_plain)
from repro_torch.kernels.backends import TorchKernels  # noqa: E402
from repro_torch.obs.spans import trace_session  # noqa: E402

#: H100 SXM device-memory rate (NVIDIA data sheet), bytes per second
HBM_BYTES_PER_S = 3.35e12

COUNTERS = ("touch_counts", "iter_counts", "compute_counts",
            "isect_steps", "isect_matches", "advances", "merges")

#: the main path's configurations: (design, rows = cols, nonzeros per
#: operand).  Gamma at the low end of the paper's Table 4 range; the
#: others at the sizes whose seam calls reach each kernel's main shapes.
MAIN_CONFIGS = (("gamma", 8192, 100_000), ("extensor", 4096, 40_000),
                ("outerspace", 2048, 20_000), ("sigma", 2048, 20_000),
                ("matraptor", 2048, 20_000), ("sparse-add", 8192, 100_000),
                ("sparse-add-3way", 8192, 100_000))

#: the kernels' entries in the result line
KERNEL_INFO = {
    "search": ("src/repro_torch/kernels/csrc/search.cu",
               "src/repro/kernels/intersect.py:31"),
    "merge_path": ("src/repro_torch/kernels/csrc/merge_path.cu",
                   "src/repro/kernels/ops.py:72"),
    "multi_merge_ranks": ("src/repro_torch/kernels/csrc/multi_merge.cu",
                          "src/repro/kernels/ops.py:142"),
}


def log(*args) -> None:
    print(*args, flush=True)


# ---------------------------------------------------------------------- #
# 1-2: device and build
# ---------------------------------------------------------------------- #
def phase_device() -> Tuple[str, str]:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"device: {name}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    return name, smi


def phase_build() -> None:
    t0 = time.perf_counter()
    build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for name, out in build.BUILD_LOGS.items():
        for line in out.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")


# ---------------------------------------------------------------------- #
# 3: kernels against their plain versions
# ---------------------------------------------------------------------- #
def _sorted_unique(rng, lo: int, hi: int, n: int) -> np.ndarray:
    """``n`` distinct sorted int64 keys in [lo, hi)."""
    n = min(n, hi - lo)
    if n <= 0:
        return np.zeros(0, dtype=np.int64)
    if hi - lo <= 4 * n:
        keys = rng.choice(np.arange(lo, hi, dtype=np.int64), size=n,
                          replace=False)
    else:
        keys = np.unique(rng.integers(lo, hi, size=int(n * 1.1) + 16,
                                      dtype=np.int64))
        keys = rng.choice(keys, size=min(n, len(keys)), replace=False)
    return np.sort(keys)


#: adversarial key domains (tests/test_kernels.py's set): duplicate-heavy,
#: empty, hugging INT32_MAX, and packed int64 keys near 2^62
KEY_DOMAINS = (("dense", 0, 500), ("empty", 0, 1),
               ("i32_boundary", (1 << 31) - 1 - 400, (1 << 31) - 1),
               ("i64_packed", (1 << 62) - 2000, (1 << 62) - 1))


def _time_ms(fn: Callable[[], object], device: torch.device,
             reps: int) -> float:
    """Mean milliseconds of ``fn``: CUDA events after one warm-up on the
    card, the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _max_abs_err(got, want) -> int:
    if isinstance(got, tuple):
        return max(_max_abs_err(g, w) for g, w in zip(got, want))
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if got.numel() == 0:
        return 0
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def _kernel_cases(device: torch.device, scale: float, seed: int):
    """(kernel, kernel fn, plain fn, library fn, args, bytes) at the
    main path's shapes: ExTensor's intersection stream for ``search``
    (43M probes into 21.5M keys at scale 1), about 100K keys a row for
    the merges."""
    rng = np.random.default_rng(seed)
    n_hay = max(int(21_500_000 * scale), 8)
    n_probe = max(int(43_000_000 * scale), 8)
    hay = _sorted_unique(rng, 0, 150_000_000_000, n_hay)
    # sorted, as intersect_keys passes them; half hit, half miss
    probes = np.sort(np.where(rng.random(n_probe) < 0.5,
                              rng.choice(hay, size=n_probe),
                              rng.integers(0, 150_000_000_000,
                                           size=n_probe)))
    n_row = max(int(100_000 * scale), 8)
    rows = [_sorted_unique(rng, 0, 1 << 40, n_row) for _ in range(3)]
    rows[1] = np.union1d(rows[1], rows[0][::4])       # shared keys
    rows[2] = np.union1d(rows[2], rows[0][::5])

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    th, tp = dev(hay), dev(probes)
    ta, tb = dev(rows[0]), dev(rows[1])
    cat = dev(np.concatenate(rows))
    offs = dev(np.cumsum([0] + [len(r) for r in rows]))
    n2, nk = len(ta) + len(tb), len(cat)
    return [
        ("search", search, search_plain,
         lambda h, p: torch.searchsorted(h, p), (th, tp),
         8 * (len(th) + 2 * len(tp))),
        ("merge_path", merge_path, merge_path_plain,
         lambda a, b: torch.sort(torch.cat([a, b]), stable=True),
         (ta, tb), 17 * n2),
        ("multi_merge_ranks", multi_merge_ranks, multi_merge_ranks_plain,
         lambda k, o: torch.sort(k, stable=True), (cat, offs),
         16 * nk + 8 * len(offs)),
    ]


def _domain_checks(device: torch.device, seed: int) -> None:
    """Each kernel equals its plain version on the adversarial domains."""
    rng = np.random.default_rng(seed)
    for name, lo, hi in KEY_DOMAINS:
        for trial in range(3):
            rows = [_sorted_unique(rng, lo, hi, int(rng.integers(0, 300)))
                    for _ in range(3)]
            ts = [torch.from_numpy(r).to(device) for r in rows]
            pool = np.concatenate([rows[0], [lo, hi - 1]])
            probes = torch.from_numpy(rng.choice(pool, size=200)).to(device)
            cat = torch.cat(ts)
            offs = torch.tensor(np.cumsum([0] + [len(r) for r in rows]),
                                device=device)
            pairs = [(search(ts[1], probes), search_plain(ts[1], probes)),
                     (search(ts[1], ts[0]), search_plain(ts[1], ts[0])),
                     (merge_path(ts[0], ts[1]),
                      merge_path_plain(ts[0], ts[1])),
                     (multi_merge_ranks(cat, offs),
                      multi_merge_ranks_plain(cat, offs))]
            for got, want in pairs:
                if _max_abs_err(got, want) != 0:
                    raise AssertionError(f"kernel != plain on domain "
                                         f"{name}, trial {trial}")
    log(f"kernels: equal to their plain versions on "
        f"{[d[0] for d in KEY_DOMAINS]}")


def phase_kernels(device, scale: float = 1.0, seed: int = 0,
                  reps: int = 10) -> List[Dict]:
    """Every kernel against its plain version, exact, at the main
    path's shapes (``scale`` shrinks them) and on the key domains; the
    kernel's time beside its bytes bound, the plain version's and one
    library call's.  Returns one record per kernel."""
    device = torch.device(device)
    _domain_checks(device, seed)
    out = []
    for name, kern, plain, lib, args, nbytes in \
            _kernel_cases(device, scale, seed):
        err = _max_abs_err(kern(*args), plain(*args))
        if err != 0:
            raise AssertionError(f"{name}: kernel != plain (max abs err "
                                 f"{err}) at {[tuple(a.shape) for a in args]}")
        rec = {"name": name, "route": "cuda",
               "source": KERNEL_INFO[name][0],
               "replaces": KERNEL_INFO[name][1],
               "launches": 0, "max_abs_err": err,
               "ms": _time_ms(lambda: kern(*args), device, reps),
               "plain_ms": _time_ms(lambda: plain(*args), device, reps),
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
               "bound_by": "bytes",
               "library_ms": _time_ms(lambda: lib(*args), device, reps),
               "shapes": [list(a.shape) for a in args]}
        log(f"kernel {name}: shapes {rec['shapes']} exact; "
            f"{rec['ms']:.4f} ms (plain {rec['plain_ms']:.4f}, library "
            f"{rec['library_ms']:.4f}, bound {rec['bound_ms']:.4f})")
        out.append(rec)
    return out


# ---------------------------------------------------------------------- #
# 4-5: the simulator
# ---------------------------------------------------------------------- #
def _spec(design: str):
    return REGISTRY[design]() if design in REGISTRY else ZOO[design]()


def make_inputs(spec, n: int, nnz: int, seed: int) -> Dict:
    """Seeded n x n operands with ``nnz`` nonzeros each, as fibertrees
    in the spec's stored rank order (what the simulator builds from a
    dense array, without the dense array)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, decl in spec.einsum.declaration.items():
        if name in spec.einsum.cascade_outputs:
            continue
        order = spec.mapping.rank_order.get(name) or decl
        idx = rng.choice(n * n, size=nnz, replace=False)
        pts = np.stack([idx // n, idx % n], axis=1)
        perm = [decl.index(r) for r in order]
        vals = rng.random(nnz) + 0.5
        out[name] = CSF.from_coo(name, order, pts[:, perm], vals,
                                 {r: n for r in order}).to_ftensor()
    return out


def _run(design, inputs, n, backend):
    """One ``simulate`` call, as a user makes it, with a
    ``CollectingInstr`` beside the performance model."""
    ci = CollectingInstr()
    t0 = time.perf_counter()
    res = simulate(_spec(design), inputs, {v: n for v in "mkn"},
                   params=DEFAULT_PARAMS.get(design), backend=backend,
                   extra_instr=ci)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return res, ci, time.perf_counter() - t0


def _traced_run(design, inputs, n, backend):
    """``_run`` under a tracer: its ``seam:*`` spans give the seconds
    spent in each seam (transfers, launches and host work), and it
    turns on the engine's stage timers (``Report.stage_seconds``)."""
    with trace_session() as tr:
        run = _run(design, inputs, n, backend)
    seams: Dict[str, float] = {}
    for sp in tr.spans(cat="seam"):
        seams[sp["name"]] = seams.get(sp["name"], 0.0) + sp["dur"] / 1e6
    return run, seams


def _report_fields(report) -> Dict:
    d = dataclasses.asdict(report)
    d.pop("stage_seconds")                   # host wall clock
    return d


def _assert_same(design, got, want, reports: bool = True) -> None:
    (rg, cg), (rw, cw) = got, want
    if set(rg.tensors) != set(rw.tensors):
        raise AssertionError(f"{design}: tensor sets differ")
    for t in rw.tensors:
        a, b = rg[t], rw[t]
        if a.ranks != b.ranks or list(a.iter_leaves()) != \
                list(b.iter_leaves()):
            raise AssertionError(f"{design}: output {t} not bit-identical")
    for attr in COUNTERS:
        if getattr(cg, attr) != getattr(cw, attr):
            raise AssertionError(f"{design}: {attr} differ")
    if reports and \
            _report_fields(rg.report) != _report_fields(rw.report):
        raise AssertionError(f"{design}: Report fields differ")


def _assert_native(design, res) -> None:
    if res.fallback_reasons or res.downgrade_events:
        raise AssertionError(f"{design}: fallbacks {res.fallback_reasons}, "
                             f"downgrades {res.downgrade_events}")


def phase_oracle(device, n: int = 48, seed: int = 1) -> None:
    """Every design and union cascade at a small size, on ``device``,
    against the interpreter oracle (bit-exact outputs and counters)
    and the dense reference."""
    device = torch.device(device)
    for design in [c[0] for c in MAIN_CONFIGS]:
        inputs = make_inputs(_spec(design), n, max(n * n // 10, 1), seed)
        vec = _run(design, inputs, n, VectorBackend(device=device))
        _assert_native(design, vec[0])
        # the interpreter feeds the performance model per element and
        # the vector path in aggregate, so only outputs and counters
        # are held equal here
        ref = _run(design, inputs, n, PythonBackend())
        _assert_same(design, vec[:2], ref[:2], reports=False)
        dense = {k: v.to_dense() for k, v in inputs.items()}
        if not check_against_dense(_spec(design), _declared(design, dense),
                                   {v: n for v in "mkn"},
                                   DEFAULT_PARAMS.get(design),
                                   backend=VectorBackend(device=device)):
            raise AssertionError(f"{design}: differs from dense reference")
    log(f"oracle: {len(MAIN_CONFIGS)} cascades at {n}x{n} on {device} "
        f"match the interpreter and the dense reference")


def _declared(design, dense_stored):
    """Stored-order dense arrays back in declaration order."""
    spec = _spec(design)
    out = {}
    for name, arr in dense_stored.items():
        decl = spec.einsum.declaration[name]
        order = spec.mapping.rank_order.get(name) or decl
        out[name] = np.transpose(arr, [order.index(r) for r in decl])
    return out


def phase_main(device, configs=MAIN_CONFIGS, seed: int = 2,
               card: str = "") -> Dict:
    """``simulate``'s path per configuration on ``device``: with the
    hand kernels (the device's own lowering; launches counted) and with
    the plain versions on the same device.  Returns the launch counts
    and the wall seconds of both runs per configuration; ``card`` names
    the device in the log."""
    device = torch.device(device)
    launches = {k.__name__: 0 for k in KERNELS}
    walls = []
    for design, n, nnz in configs:
        inputs = make_inputs(_spec(design), n, nnz, seed)
        for k in KERNELS:
            k.launches = 0
        kern, seams = _traced_run(design, inputs, n,
                                  VectorBackend(device=device))
        counts = {k.__name__: k.launches for k in KERNELS}
        for k, c in counts.items():
            launches[k] += c
        plain, plain_seams = _traced_run(design, inputs, n, VectorBackend(
            device=device, kernel_backend=TorchKernels(device)))
        _assert_native(design, kern[0])
        _assert_native(design, plain[0])
        _assert_same(design, kern[:2], plain[:2])
        stages = kern[0].report.stage_seconds
        walls.append({"design": design, "n": n, "nnz": nnz,
                      "kernel_s": kern[2], "plain_s": plain[2],
                      "launches": counts, "stages": stages,
                      "seams": seams, "plain_seams": plain_seams})
        log(f"main {design} {n}x{n} nnz {nnz} on {card or device}: "
            f"kernels {kern[2]:.3f} s, plain {plain[2]:.3f} s, identical; "
            f"launches {counts}")
        log(f"  stages (s, kernel run): "
            + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
            + f"; outside the vector engine "
              f"{kern[2] - sum(stages.values()):.3f}")
        log(f"  seam calls (s, kernel run): "
            + ", ".join(f"{k} {v:.3f}" for k, v in seams.items())
            + f"; {sum(seams.values()) / kern[2]:.1%} of the run; plain "
              f"run's seam calls {sum(plain_seams.values()):.3f}")
    return {"launches": launches, "walls": walls}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    name, smi = phase_device()
    phase_build()
    kernels = phase_kernels("cuda")
    phase_oracle("cuda")
    main_run = phase_main("cuda", card=smi)
    for rec in kernels:
        rec["launches"] = main_run["launches"][rec["name"]]
        rec.pop("shapes")
        if rec["launches"] <= 0:
            raise AssertionError(f"{rec['name']} never launched on the "
                                 f"main path")
    log("segmented_reduce ran in host numpy (no device kernel yet)")
    log(f"total {time.perf_counter() - t0:.1f} s on {smi}")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
