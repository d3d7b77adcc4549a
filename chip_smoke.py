#!/usr/bin/env python3
"""Run the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py

Phases, each a function of a device and a size or config, so that a CPU
test can rehearse them at a tiny size with the kernels' plain versions:

  1. device      -- the card's name and power limit;
  2. build       -- compile the CUDA kernels from ``src/repro_torch/kernels``
                    (one nvcc per source, all at once), print nvcc's
                    register / spill / shared-memory lines and fail if any
                    kernel spills;
  3. kernels     -- each seam kernel against its plain version (exact) at
                    the simulator's shapes and on four adversarial key
                    domains, timed beside its bytes bound and one PyTorch
                    library call;
  4. oracle      -- every design and union cascade at a small size on the
                    card, against the interpreter oracle (bit-exact, with
                    counters) and the dense reference;
  5. main        -- ``simulate`` for the paper's designs at full widths,
                    once with the hand kernels and once with the plain
                    versions on the card: identical outputs, counters and
                    Reports, no fallback, no downgrade, every seam kernel
                    launched; then ``search`` (sorted and unsorted calls
                    apart), ``merge_path`` and ``multi_merge_ranks``
                    replayed at the sizes of their launches there, timed
                    beside their bounds, the merges also split into device
                    time a launch and host time a call beside an empty
                    kernel's launch;
  6. ssd_kernel  -- ``ssd_chunk`` against ``ssd_chunk_plain`` at the
                    Mamba2-1.3B prefill shape (bf16 and fp32) and the
                    reference's test shapes, timed beside its bound
                    (TFLOP/s and share of it);
  7. prefill     -- ``make_prefill_step`` on Mamba2-1.3B at full width,
                    batch 4 x 2048 tokens, with the kernel and with stage
                    (1) on the plain version: logits and greedy tokens
                    agree, one kernel launch per layer;
  8. consistency -- in fp32 at full width, the last-position logits of a
                    512-token prefill against 512 ``serve_step`` decode
                    steps;
  9. serve       -- ``Server`` at full width, 4 slots, 8 requests of 4-12
                    prompt tokens and 16 new tokens each;
 10. flash_kernel -- ``flash_attention`` against ``flash_attention_plain``
                    at the Qwen2-7B prefill shape and the reference's test
                    shapes (fp32 and bf16, causal and not, a ragged KV
                    tail), timed beside its bound (TFLOP/s and share of
                    it) and SDPA;
 11. bsmm_kernel  -- ``block_sparse_matmul`` against its plain version at
                    the reference's test shapes (all four dtype pairs) and
                    an 8192 x 8192 A at 30% tile density (fp32 and bf16),
                    there timed beside its route's bound and a dense
                    ``torch.matmul`` in the same dtype;
 12. kernels_bench -- ``repro_torch.bench.kernels_bench.run``: every kernel
                    at the reference bench's shapes against its oracle (the
                    path that launches ``block_sparse_matmul``);
 13. dense_prefill -- phase 7 for Qwen2-7B at full width: one
                    ``flash_attention`` launch per layer, and the same
                    prefill with ``mha`` on the plain version;
 14. dense_consistency -- phase 8 for Qwen2-7B, 256 tokens;
 15. dense_serve  -- phase 9 for Qwen2-7B.

fp32 checks run with TF32 off for matmuls and cuDNN convolutions
(``main`` sets both flags), so fp32 means fp32.  The second-to-last
line lists the kernels as JSON; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script
exits non-zero before printing any result.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import repro_torch.configs as TC  # noqa: E402
from repro_torch.accelerators import (DEFAULT_PARAMS, REGISTRY,  # noqa: E402
                                      simulate)
from repro_torch.accelerators.zoo import ZOO  # noqa: E402
from repro_torch.core.csf import CSF  # noqa: E402
from repro_torch.core.generator import check_against_dense  # noqa: E402
from repro_torch.core.iteration import PythonBackend  # noqa: E402
from repro_torch.core.trace import CollectingInstr  # noqa: E402
from repro_torch.core.vectorized import VectorBackend  # noqa: E402
from repro_torch.bench import kernels_bench  # noqa: E402
from repro_torch.kernels import (KERNELS, MODEL_KERNELS,  # noqa: E402
                                 block_sparse_matmul,
                                 block_sparse_matmul_plain, build,
                                 compact_tiles, flash_attention,
                                 flash_attention_plain, merge_path,
                                 merge_path_plain, multi_merge_ranks,
                                 multi_merge_ranks_plain, search,
                                 search_plain, ssd_chunk, ssd_chunk_plain)
from repro_torch.kernels.backends import (CudaKernels,  # noqa: E402
                                          TorchKernels)
from repro_torch.launch.serve import Request, Server  # noqa: E402
from repro_torch.launch.steps import (make_prefill_step,  # noqa: E402
                                      make_serve_step)
from repro_torch.models import api  # noqa: E402
from repro_torch.models import layers as layers_mod  # noqa: E402
from repro_torch.models.layers import padded_vocab  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402
from repro_torch.obs.spans import trace_session  # noqa: E402

#: H100 SXM device-memory rate and dense peaks (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12,      # tensor cores, bf16
              torch.float32: 67e12}        # CUDA cores, fp32
#: TF32 tensor cores, dense
TF32_FLOPS = 495e12

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
    "ssd_chunk": ("src/repro_torch/kernels/csrc/ssd_chunk.cu",
                  "src/repro/kernels/ssd_chunk.py:28"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:34"),
    "block_sparse_matmul": (
        "src/repro_torch/kernels/csrc/block_sparse_matmul.cu",
        "src/repro/kernels/block_sparse_matmul.py:44"),
}

#: the model path: Mamba2-1.3B at its published widths
MODEL_ARCH = "mamba2-1.3b"
#: prefill batch x tokens (nc = 8 chunks of 256)
PREFILL_BATCH, PREFILL_SEQ = 4, 2048
#: (B, nc, l, H, P, N), the reference's SSD_SHAPES (tests/test_kernels.py)
SSD_SHAPES = ((1, 2, 64, 2, 32, 16), (2, 3, 128, 4, 64, 32),
              (1, 1, 256, 8, 64, 128))
#: kernel vs plain ssd_chunk: both accumulate in fp32 (from the same bf16
#: inputs on the bf16 runs), so only the summation order differs
SSD_TOL = 2e-4
#: bf16 prefill, kernel vs plain stage (1): the two differ by fp32
#: reassociation, which flips single bf16 roundings (0.4%) that then
#: carry through 48 residual layers.  The limits are twice what the
#: kernel showed in its first full-width run on an H100 (max 0.195, mean
#: 0.0252, 91.2% of greedy tokens equal), where stage (1) by the
#: reference's ``_segsum`` formula, another exact fp32 rewrite, landed
#: as far from the plain run (PERF.md); a stage (1) that is wrong moves
#: logits by their own size.
PREFILL_MAX_ABS, PREFILL_MEAN_ABS, PREFILL_GREEDY_SHARE = 0.4, 0.05, 0.8
#: fp32 prefill vs decode: reassociation only (5.4e-6 on logits of
#: magnitude 1.3 at 48 layers and width 256 on the CPU)
CONSISTENCY_ATOL = 1e-3

#: the dense model path: Qwen2-7B at its published widths
DENSE_ARCH = "qwen2-7b"
#: fp32 prefill vs decode steps for the dense model
DENSE_CONSISTENCY_SEQ = 256
#: (b, h, hkv, sq, sk, d), the reference's ATTN_SHAPES
#: (tests/test_kernels.py), run causal and not
ATTN_SHAPES = ((1, 2, 2, 128, 128, 64), (2, 4, 2, 256, 256, 64),
               (1, 8, 1, 128, 256, 32), (2, 2, 2, 64, 192, 128))
#: the reference's ragged-tail case, non-causal (sk below one key tile)
ATTN_RAGGED = (1, 1, 1, 64, 40, 32)
#: kernel vs plain flash attention: in fp32 both take fp32 scores,
#: softmax and products from the same inputs, so they differ by summation
#: order only (the reference test's 2e-6, with headroom for another
#: order).  In bf16 the kernel rounds the softmax weights to bf16 for the
#: tensor-core PV product (at most about 2^-9 of |v| per weight, as the
#: reference model's attention rounds them) and then the output once; the
#: plain version keeps PV in fp32: the reference test's 2e-2.
FLASH_ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
#: (M, K, N, bm, bk, bn, tile density): the reference's BSMM_SHAPES (the
#: last with an empty A) and its bench's case
BSMM_SHAPES = ((128, 128, 128, 64, 64, 64, 0.5),
               (256, 128, 192, 64, 64, 64, 0.3),
               (256, 256, 64, 128, 128, 64, 0.2),
               (128, 256, 128, 64, 128, 128, 0.0),
               (256, 256, 128, 64, 64, 64, 0.4))
#: the card-sized case: about 1,230 of 4,096 128 x 128 tiles, B fp32
BSMM_CARD = (8192, 8192, 1024, 128, 128, 128, 0.3)
#: kernel vs plain block-sparse matmul: the same fp32 products summed in
#: another order, |err| <= BSMM_RTOL sqrt(K) max |Z|
BSMM_RTOL = 1e-4
#: bf16 Qwen2-7B prefill, kernel vs plain attention: both keep scores
#: and the softmax carry in fp32; the kernel rounds the softmax weights to
#: bf16 for its tensor-core PV product, the plain version keeps PV in
#: fp32.  Either difference flips single bf16 roundings of the attention
#: output that then carry through 28 residual layers, as ``ssd_chunk``'s
#: did through 48.  The limits are twice what the first (fp32 CUDA-core)
#: kernel showed in its first full-width run on an H100 (max 0.125, mean
#: 0.01557 on logits up to 7.2, 4.33% of greedy tokens different;
#: PERF.md); a wrong attention moves logits by their own size.
DENSE_PREFILL_MAX_ABS, DENSE_PREFILL_MEAN_ABS, DENSE_PREFILL_GREEDY_SHARE = \
    0.25, 0.032, 0.91


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


def build_report(logs: Dict[str, str]) -> List[str]:
    """nvcc's ``-Xptxas -v`` lines of every kernel library built (entry,
    registers, spills, shared memory), each prefixed with its source;
    raises if a function spills."""
    lines = []
    for name, out in logs.items():
        function = ""
        for ln in out.splitlines():
            ln = ln.strip()
            if "Function properties for" in ln:
                function = ln.split("Function properties for")[-1].strip()
            if not ("entry function" in ln or "registers" in ln
                    or "spill" in ln or "smem" in ln):
                continue
            lines.append(f"{name}: {ln}")
            if "spill" in ln and ("0 bytes spill stores" not in ln
                                  or "0 bytes spill loads" not in ln):
                raise AssertionError(f"{name}.cu spills registers in "
                                     f"{function or 'a function'}: {ln}")
    return lines


def phase_build() -> None:
    t0 = time.perf_counter()
    build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for line in build_report(build.BUILD_LOGS):
        log(f"  {line}")


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


def _host_us(calls: List[Callable[[], object]], device: torch.device,
             n: int = 1000, runs: int = 5) -> Dict[str, float]:
    """Host microseconds a call: ``runs`` runs of ``n`` calls, taken in
    turn from ``calls``, on ``time.perf_counter`` with no sync inside;
    their median, min and max."""
    for c in calls:
        c()
    _sync(device)
    out = []
    for _ in range(runs):
        t0 = time.perf_counter()
        for i in range(n):
            calls[i % len(calls)]()
        out.append((time.perf_counter() - t0) / n * 1e6)
        _sync(device)
    return {"median": statistics.median(out), "min": min(out),
            "max": max(out)}


def _device_us(calls: List[Callable[[], object]], device: torch.device,
               kernel: str, rounds: int = 3
               ) -> Tuple[Optional[float], Optional[str]]:
    """Device microseconds a launch of the CUDA kernel whose name holds
    ``kernel``, where each of ``calls`` launches it once: its kernel
    time in ``torch.profiler`` over ``rounds`` passes through ``calls``;
    where the profiler shows none, a CUDA graph of whole passes replayed
    ``rounds`` times under CUDA events (the gaps between launches
    included; at least 20 launches a replay, so that the replay's own
    launch does not set the time).  Returns (us, "profiler" or "graph");
    (None, None) on the CPU, which launches nothing."""
    if device.type != "cuda":
        return None, None
    for c in calls:
        c()
    torch.cuda.synchronize()
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    with prof:
        for _ in range(rounds):
            for c in calls:
                c()
        torch.cuda.synchronize()
    total = count = 0
    for ev in prof.key_averages():
        if kernel in ev.key:
            total += ev.device_time_total
            count += ev.count
    if count > 0 and total > 0:           # the mean of those it recorded
        return total / count, "profiler"
    passes = -(-20 // len(calls))
    graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side), torch.cuda.graph(graph, stream=side):
        for _ in range(passes):
            for c in calls:
                c()
    torch.cuda.current_stream(device).wait_stream(side)
    return (_time_ms(graph.replay, device, rounds) * 1e3
            / (passes * len(calls)), "graph")


#: the merges' CUDA kernels by name, as the profiler lists them
DEVICE_KERNELS = {"merge_path": "merge_path_kernel",
                  "multi_merge_ranks": "multi_merge_kernel"}


def launch_floor(device) -> Optional[Dict]:
    """What no launch goes under: an empty kernel (``repro_empty`` of the
    merge_path library) launched through ctypes on the current stream,
    timed as the merges are (device us a launch, host us a call).  None
    on the CPU, which launches nothing."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    empty = build.function("merge_path", "repro_empty", (ctypes.c_void_p,))

    def launch():
        build.check("merge_path",
                    empty(torch.cuda.current_stream(index).cuda_stream))

    dev_us, by = _device_us([launch], device, "empty_kernel", rounds=20)
    return {"device_us": dev_us, "device_us_by": by,
            "host_us": _host_us([launch], device)}


def _split_log(rec: Dict) -> str:
    """The device / host split of a merge record, for the log."""
    h = rec["host_us"]
    dev = "not measured (no card)" if rec["device_us"] is None else \
        f"{rec['device_us']:.3f} us a launch ({rec['device_us_by']})"
    return (f"device {dev}; host {h['median']:.3f} us a call (min "
            f"{h['min']:.3f}, max {h['max']:.3f})")


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
            offs = torch.tensor(np.cumsum([0] + [len(r) for r in rows]),
                                device=device)
            # the same lengths drawn with replacement: runs of equal
            # keys inside every row, for the merges
            dups = [torch.from_numpy(np.sort(rng.choice(r, size=len(r))))
                    .to(device) if len(r) else t for r, t in zip(rows, ts)]
            pairs = [(search(ts[1], probes), search_plain(ts[1], probes)),
                     (search(ts[1], ts[0]), search_plain(ts[1], ts[0]))]
            for rs in (ts, dups):
                cat = torch.cat(rs)
                pairs += [(merge_path(rs[0], rs[1]),
                           merge_path_plain(rs[0], rs[1])),
                          (multi_merge_ranks(cat, offs),
                           multi_merge_ranks_plain(cat, offs))]
            for got, want in pairs:
                if _max_abs_err(got, want) != 0:
                    raise AssertionError(f"kernel != plain on domain "
                                         f"{name}, trial {trial}")
    log(f"kernels: equal to their plain versions on "
        f"{[d[0] for d in KEY_DOMAINS]} (the merges also on rows with "
        f"keys repeated inside them)")


def phase_kernels(device, scale: float = 1.0, seed: int = 0,
                  reps: int = 10) -> List[Dict]:
    """Every kernel against its plain version, exact, at the main
    path's shapes (``scale`` shrinks them) and on the key domains; the
    kernel's time beside its bytes bound, the plain version's and one
    library call's, and for the merges their device time a launch and
    host time a call apart.  Returns one record per kernel."""
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
        if name in DEVICE_KERNELS:
            calls = [lambda: kern(*args)]
            rec["device_us"], rec["device_us_by"] = _device_us(
                calls, device, DEVICE_KERNELS[name])
            rec["host_us"] = _host_us(calls, device)
            log(f"  {name}: {_split_log(rec)}")
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


@contextlib.contextmanager
def record_search_calls(calls: List[Tuple[int, int, bool]]):
    """Appends (keys, probes, probes sorted) for every ``search`` the
    CUDA lowering makes while open: only ``lookup_keys`` passes probes
    unsorted."""
    search_fn, lookup = CudaKernels._search, CudaKernels.lookup_keys
    in_lookup = []

    def recording_search(hay, probes):
        calls.append((len(hay), len(probes), not in_lookup))
        return search_fn(hay, probes)

    def recording_lookup(self, hay, probes):
        in_lookup.append(True)
        try:
            return lookup(self, hay, probes)
        finally:
            in_lookup.pop()

    CudaKernels._search = staticmethod(recording_search)
    CudaKernels.lookup_keys = recording_lookup
    try:
        yield calls
    finally:
        CudaKernels._search = staticmethod(search_fn)
        CudaKernels.lookup_keys = lookup


@contextlib.contextmanager
def record_merge_calls(calls: List[Tuple[str, Tuple[int, ...]]]):
    """Appends ("merge_path", (len a, len b)) and ("multi_merge_ranks",
    row lengths) for every merge the CUDA lowering makes while open."""
    merge, multi = CudaKernels._merge, CudaKernels._multi_merge

    def recording_merge(a, b):
        calls.append(("merge_path", (len(a), len(b))))
        return merge(a, b)

    def recording_multi(keys, offs):
        o = offs.tolist()
        calls.append(("multi_merge_ranks",
                      tuple(hi - lo for lo, hi in zip(o, o[1:]))))
        return multi(keys, offs)

    CudaKernels._merge = staticmethod(recording_merge)
    CudaKernels._multi_merge = staticmethod(recording_multi)
    try:
        yield calls
    finally:
        CudaKernels._merge = staticmethod(merge)
        CudaKernels._multi_merge = staticmethod(multi)


def phase_main(device, configs=MAIN_CONFIGS, seed: int = 2,
               card: str = "") -> Dict:
    """``simulate``'s path per configuration on ``device``: with the
    hand kernels (the device's own lowering; launches counted, and the
    sizes of every ``search`` and merge launch recorded) and with the
    plain versions on the same device.  Returns the launch counts, the
    search and merge sizes and the wall seconds of both runs per
    configuration; ``card`` names the device in the log."""
    device = torch.device(device)
    launches = {k.__name__: 0 for k in KERNELS}
    walls, search_calls, merge_calls = [], [], []
    for design, n, nnz in configs:
        inputs = make_inputs(_spec(design), n, nnz, seed)
        for k in KERNELS:
            k.launches = 0
        with record_search_calls(search_calls), \
                record_merge_calls(merge_calls):
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
    return {"launches": launches, "walls": walls,
            "search_calls": search_calls, "merge_calls": merge_calls}


def phase_search_slack(device, calls, reps: int = 5,
                       seed: int = 3) -> Dict:
    """``search`` at the sizes of the main phase's own launches: each
    (keys, probes, sorted) case replayed on random keys (half the probes
    hit) and timed beside its bytes bound.  Returns, for the sorted
    calls, the unsorted ones (``lookup_keys``) and all of them, the
    launches and the sums over them of time, bound and time - bound
    (ms)."""
    device = torch.device(device)
    gen = torch.Generator(device).manual_seed(seed)
    cases: Dict[Tuple[int, int, bool], int] = {}
    for c in calls:
        if c[1]:                                # the wrapper's launches
            cases[c] = cases.get(c, 0) + 1
    out = {part: {"launches": 0, "sizes": 0, "ms": 0.0, "bound_ms": 0.0}
           for part in ("sorted", "unsorted", "total")}
    sizes = []
    for (m, n, is_sorted), count in sorted(cases.items()):
        span = 4 * max(m, 1)

        def randint(size):
            return torch.randint(0, span, (size,), generator=gen,
                                 device=device)

        hay = torch.unique(randint(2 * m))[:m]
        probes = randint(n)
        if m:
            hits = hay[torch.randint(0, len(hay), (n,), generator=gen,
                                     device=device)]
            probes = torch.where(torch.rand(n, generator=gen, device=device)
                                 < 0.5, hits, probes)
        if is_sorted:
            probes = torch.sort(probes).values
        ms = _time_ms(lambda: search(hay, probes), device, reps)
        bound = 8 * (m + 2 * n) / HBM_BYTES_PER_S * 1e3
        for part in ("sorted" if is_sorted else "unsorted", "total"):
            rec = out[part]
            rec["launches"] += count
            rec["sizes"] += 1
            rec["ms"] += count * ms
            rec["bound_ms"] += count * bound
        sizes.append((count * ms, m, n, count, is_sorted))
    for part, rec in out.items():
        rec["slack_ms"] = rec["ms"] - rec["bound_ms"]
        log(f"search at the main phase's sizes, {part}: {rec['launches']} "
            f"launches ({rec['sizes']} sizes), {rec['ms']:.4f} ms in all, "
            f"bound {rec['bound_ms']:.4f} ms, launches x (time - bound) "
            f"{rec['slack_ms']:.4f} ms")
    log("  the largest (keys, probes, sorted, launches: ms in all): "
        + ", ".join(f"({m}, {n}, {srt}, {c}: {t:.4f})"
                    for t, m, n, c, srt in sorted(sizes, reverse=True)[:5]))
    return out


def merge_bound_ms(name: str, sizes: Tuple[int, ...]) -> float:
    """Bytes bound (ms) of one merge launch: ``merge_path`` reads 8 bytes
    a key and writes 8 + 1 (merged key, source flag); ``multi_merge_ranks``
    reads 8 bytes a key and 8 an offset and writes an 8-byte rank."""
    n = sum(sizes)
    nbytes = 17 * n if name == "merge_path" else 16 * n + 8 * (len(sizes) + 1)
    return nbytes / HBM_BYTES_PER_S * 1e3


def phase_merge_slack(device, calls, reps: int = 5, seed: int = 7) -> Dict:
    """``merge_path`` and ``multi_merge_ranks`` at the sizes of the main
    phase's own launches: each recorded case replayed on random sorted
    rows that share keys, timed beside its bytes bound; then, over the
    recorded launches in turn, each kernel's device time a launch and
    its wrapper's host time a call, beside the launch floor
    (``launch_floor``).  Returns per kernel the launches, the sums over
    them of time, bound and time - bound (ms), and that split."""
    device = torch.device(device)
    rng = np.random.default_rng(seed)
    cases: Dict[Tuple[str, Tuple[int, ...]], int] = {}
    for c in calls:
        cases[c] = cases.get(c, 0) + 1
    out = {name: {"launches": 0, "sizes": 0, "ms": 0.0, "bound_ms": 0.0}
           for name in DEVICE_KERNELS}
    launches: Dict[str, List[Callable[[], object]]] = \
        {name: [] for name in DEVICE_KERNELS}
    for (name, sizes), count in sorted(cases.items()):
        rows = [_sorted_unique(rng, 0, 1 << 40, n) for n in sizes]
        for r in range(1, len(rows)):          # shared keys, sizes kept
            m = min(len(rows[0]), len(rows[r])) // 4
            if m:
                rows[r] = np.sort(np.concatenate(
                    [np.setdiff1d(rows[r], rows[0])[:len(rows[r]) - m],
                     rows[0][:m]]))
        ts = [torch.from_numpy(r).to(device) for r in rows]
        if name == "merge_path":
            def call(ts=ts):
                return merge_path(ts[0], ts[1])
        else:
            def call(keys=torch.cat(ts), offs=torch.tensor(
                    np.cumsum([0] + list(sizes)), device=device)):
                return multi_merge_ranks(keys, offs)
        ms = _time_ms(call, device, reps)
        launches[name] += [call] * count
        rec = out[name]
        rec["launches"] += count
        rec["sizes"] += 1
        rec["ms"] += count * ms
        rec["bound_ms"] += count * merge_bound_ms(name, sizes)
    floor = launch_floor(device)
    for name, rec in out.items():
        rec["slack_ms"] = rec["ms"] - rec["bound_ms"]
        log(f"{name} at the main phase's sizes: {rec['launches']} launches "
            f"({rec['sizes']} sizes), {rec['ms']:.4f} ms in all, bound "
            f"{rec['bound_ms']:.4f} ms, launches x (time - bound) "
            f"{rec['slack_ms']:.4f} ms")
        if launches[name]:
            rec["device_us"], rec["device_us_by"] = _device_us(
                launches[name], device, DEVICE_KERNELS[name])
            rec["host_us"] = _host_us(launches[name], device)
            rec["floor"] = floor
            log(f"  {name}, over its launches in turn: {_split_log(rec)}")
    if floor is not None:
        log(f"  launch floor, an empty kernel through ctypes: "
            f"{_split_log(floor)}")
    return out


# ---------------------------------------------------------------------- #
# 6-9: the Mamba2 model path
# ---------------------------------------------------------------------- #
def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


#: per family, the kernel a prefill launches once per layer: the model
#: module that calls it, the kernel's name there, its plain version, and
#: the limits (max abs, mean abs, greedy-token share) that hold the
#: kernel's bf16 logits to the plain version's
PREFILL_KERNELS = {
    "ssm": (ssm_mod, "ssd_chunk", ssd_chunk_plain,
            (PREFILL_MAX_ABS, PREFILL_MEAN_ABS, PREFILL_GREEDY_SHARE)),
    "dense": (layers_mod, "flash_attention", flash_attention_plain,
              (DENSE_PREFILL_MAX_ABS, DENSE_PREFILL_MEAN_ABS,
               DENSE_PREFILL_GREEDY_SHARE)),
}


@contextlib.contextmanager
def plain_kernel(family: str):
    """The family's prefill kernel replaced by its plain version for the
    duration (the run the kernel's prefill is held to)."""
    module, name, plain, _ = PREFILL_KERNELS[family]
    kernel = getattr(module, name)
    setattr(module, name, plain)
    try:
        yield
    finally:
        setattr(module, name, kernel)


def ssd_shape(cfg, batch: int, seq: int) -> Tuple[int, ...]:
    """(B, nc, l, H, P, N) of the ``ssd_chunk`` call of one layer's
    prefill of ``batch`` x ``seq`` tokens."""
    _, nh, p, n, _ = ssm_mod.dims(cfg)
    return (batch, seq // cfg.ssm.chunk, cfg.ssm.chunk, nh, p, n)


def ssd_bound(shape, dtype) -> Tuple[float, str]:
    """The least time (ms) of one ``ssd_chunk`` call on an H100 and what
    sets it: x, a, b and c read once and y (fp32) written once, against
    the causal half (j <= i) of G once per (b, c) and of Y per head at
    the peak rate of the input dtype."""
    B, nc, l, H, P, N = shape
    es = torch.empty(0, dtype=dtype).element_size()
    nbytes = es * (B * nc * l * H * P + 2 * B * nc * l * N) \
        + 4 * B * H * nc * l + 4 * B * nc * l * H * P
    tri = l * (l + 1) // 2
    flops = 2 * B * nc * tri * N + 2 * B * nc * H * tri * P
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def ssd_kernel_flops(shape, dtype) -> int:
    """Operations one ``ssd_chunk`` launch does on the card, as its tiles
    run (not the function's minimum, ``ssd_bound``'s): G over whole 64 x
    64 tiles j <= i once per (b, c, 8-head group); in bf16 Y over the
    16 x 16 (i, j) slices the tensor-core kernel computes, three passes
    each (the split of S), N and P padded to 16; in fp32 Y over whole 64
    x 64 tiles, N padded to 32 and P to 64."""
    B, nc, l, H, P, N = shape
    rt = -(-l // 64)                          # row tiles of 64
    tiles = rt * (rt + 1) // 2                # (i, j) tiles with j <= i
    cells = B * nc * -(-H // 8)
    if dtype == torch.bfloat16:
        g = cells * tiles * 2 * 64 * 64 * (-(-N // 16) * 16)
        # off the diagonal 4 x 4 slices a tile; on it 1 + 2 + 3 + 4
        slices = 16 * (rt * (rt - 1) // 2) + 10 * rt
        y = B * nc * H * slices * 3 * 2 * 16 * 16 * (-(-P // 16) * 16)
    else:
        g = cells * tiles * 2 * 64 * 64 * (-(-N // 32) * 32)
        y = B * nc * H * tiles * 2 * 64 * 64 * (-(-P // 64) * 64)
    return g + y


def _ssd_inputs(shape, dtype, device: torch.device, seed: int):
    B, nc, l, H, P, N = shape
    gen = torch.Generator(device).manual_seed(seed)

    def randn(*s):
        return torch.randn(s, generator=gen, device=device)

    x = randn(B, nc, l, H, P).to(dtype)
    a = -randn(B, H, nc, l).abs() * 0.1
    return x, a, randn(B, nc, l, N).to(dtype), randn(B, nc, l, N).to(dtype)


def phase_ssd_kernel(device, prefill_shape=None, shapes=SSD_SHAPES,
                     reps: int = 10, seed: int = 3, card: str = "") -> Dict:
    """``ssd_chunk`` against ``ssd_chunk_plain`` (|got - want| <= SSD_TOL
    (1 + |want|)) at the prefill shape and the reference's test shapes,
    in bf16 and fp32; the kernel's time at the prefill shape beside its
    bound (its TFLOP/s, counting the work it does, and its share of the
    bound) and the plain version's; nvcc's register and spill report of
    the kernel when this process built it.  Returns the bf16 prefill
    record."""
    device = torch.device(device)
    if prefill_shape is None:
        prefill_shape = ssd_shape(TC.get(MODEL_ARCH), PREFILL_BATCH,
                                  PREFILL_SEQ)
    recs = {}
    for shape in (prefill_shape,) + tuple(shapes):
        for dtype in (torch.bfloat16, torch.float32):
            args = _ssd_inputs(shape, dtype, device, seed)
            got, want = ssd_chunk(*args), ssd_chunk_plain(*args)
            err = (got - want).abs()
            if got.shape != want.shape or got.dtype != torch.float32 or \
                    not bool((err <= SSD_TOL * (1 + want.abs())).all()):
                raise AssertionError(f"ssd_chunk != plain at {shape} "
                                     f"{dtype}: max abs err {err.max()}")
            err = float(err.max())
            if shape != prefill_shape:
                log(f"ssd_kernel {shape} {dtype}: max abs err {err:.3g}")
                continue
            bound, by = ssd_bound(shape, dtype)
            recs[dtype] = {
                "name": "ssd_chunk", "route": "cuda",
                "source": KERNEL_INFO["ssd_chunk"][0],
                "replaces": KERNEL_INFO["ssd_chunk"][1],
                "launches": 0, "max_abs_err": err,
                "ms": _time_ms(lambda: ssd_chunk(*args), device, reps),
                "plain_ms": _time_ms(lambda: ssd_chunk_plain(*args), device,
                                     reps),
                "bound_ms": bound, "bound_by": by, "library_ms": None}
            r = recs[dtype]
            tflops = ssd_kernel_flops(shape, dtype) / r["ms"] * 1e-9
            log(f"ssd_kernel {shape} {dtype} on {card or device}: max abs "
                f"err {err:.3g}; {r['ms']:.4f} ms, {tflops:.1f} TFLOP/s, "
                f"{bound / r['ms']:.1%} of the bound {bound:.4f} ms by {by} "
                f"(plain {r['plain_ms']:.4f})")
            del args, got, want
    return recs[torch.bfloat16]


def phase_prefill(device, cfg, batch: int, seq: int, seed: int = 0,
                  card: str = "") -> Dict:
    """``make_prefill_step`` on ``cfg`` with seeded weights: once with
    the family's kernel (``PREFILL_KERNELS``; every model kernel's count
    set to 0 just before) and once with that kernel on its plain
    version, each after one warm-up.
    Kernel and plain logits finite, within the stated tolerance of each
    other, the same greedy token at most positions; one kernel launch
    per layer on a CUDA device."""
    device = torch.device(device)
    module, name, _, limits = PREFILL_KERNELS[cfg.family]
    params = api.init(cfg, torch.Generator(device).manual_seed(seed), device)
    data = api.make_batch(cfg, torch.Generator(device).manual_seed(seed + 1),
                          batch, seq)
    step = make_prefill_step(cfg, device)
    step(params, data)                                  # warm-up
    _sync(device)
    for k in MODEL_KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    logits = step(params, data)
    _sync(device)
    kernel_s = time.perf_counter() - t0
    launches = {name: getattr(module, name).launches}
    with plain_kernel(cfg.family):
        step(params, data)                              # warm-up
        _sync(device)
        t0 = time.perf_counter()
        plain = step(params, data)
        _sync(device)
        plain_s = time.perf_counter() - t0
    del params
    want = cfg.n_layers if device.type == "cuda" else 0
    if launches[name] != want:
        raise AssertionError(f"prefill launched {name} {launches[name]} "
                             f"times, want {want}")
    if tuple(logits.shape) != (batch, seq, padded_vocab(cfg)):
        raise AssertionError(f"prefill logits {tuple(logits.shape)}")
    v = cfg.vocab
    lk, lp = logits[..., :v].float(), plain[..., :v].float()
    del logits, plain
    if not bool(torch.isfinite(lk).all() and torch.isfinite(lp).all()):
        raise AssertionError("prefill logits not finite")
    diff = (lk - lp).abs()
    max_abs, mean_abs = float(diff.max()), float(diff.mean())
    greedy = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    del diff
    scale, mean_mag = float(lk.abs().max()), float(lk.abs().mean())
    tokens = batch * seq
    log(f"prefill {cfg.name} {batch}x{seq} {cfg.dtype} on {card or device}: "
        f"kernel {kernel_s:.4f} s ({tokens / kernel_s:.1f} tok/s), plain "
        f"{name} {plain_s:.4f} s ({tokens / plain_s:.1f} tok/s); logits "
        f"|max| {scale:.4g}, mean |logit| {mean_mag:.4g}; kernel vs plain: "
        f"max abs diff {max_abs:.4g}, mean abs diff {mean_abs:.4g}, greedy "
        f"tokens equal {greedy:.2%}; launches {launches}")
    lim_max, lim_mean, lim_greedy = limits
    if max_abs > lim_max or mean_abs > lim_mean or greedy < lim_greedy:
        raise AssertionError(
            f"prefill kernel vs plain: max abs {max_abs:.4g} (limit "
            f"{lim_max}), mean abs {mean_abs:.4g} (limit {lim_mean}), "
            f"greedy share {greedy:.4f} (limit {lim_greedy})")
    return {"launches": launches, "kernel_s": kernel_s, "plain_s": plain_s,
            "max_abs": max_abs, "mean_abs": mean_abs, "greedy": greedy}


def phase_consistency(device, cfg, seq: int = 512, seed: int = 4,
                      card: str = "") -> float:
    """In fp32, the last-position logits of a ``seq``-token prefill
    against ``seq`` ``serve_step`` decode steps (the reference's
    test_ssd_prefill_matches_decode, for the whole model).  Returns the
    max abs difference."""
    device = torch.device(device)
    cfg = dataclasses.replace(cfg, dtype="float32")
    params = api.init(cfg, torch.Generator(device).manual_seed(seed), device)
    toks = api.make_batch(cfg, torch.Generator(device).manual_seed(seed + 1),
                          1, seq)["tokens"]
    full = make_prefill_step(cfg, device)(params, {"tokens": toks})[:, -1]
    step = make_serve_step(cfg, device)
    cache = api.init_cache(cfg, 1, seq, dtype=torch.float32, device=device)
    t0 = time.perf_counter()
    for t in range(seq):
        last, cache = step(params, cache, toks[:, t], torch.full((1,), t))
    _sync(device)
    decode_s = time.perf_counter() - t0
    v = cfg.vocab
    err = float((full[:, :v] - last[:, :v]).abs().max())
    same = int(full[:, :v].argmax()) == int(last[:, :v].argmax())
    if not err <= CONSISTENCY_ATOL or not same:
        raise AssertionError(f"prefill vs decode: max abs {err:.4g} (limit "
                             f"{CONSISTENCY_ATOL}), same greedy token {same}")
    log(f"consistency {cfg.name} fp32 {seq} tokens on {card or device}: "
        f"prefill vs {seq} decode steps max abs {err:.3g} (logits |max| "
        f"{float(full[:, :v].abs().max()):.4g}), same greedy token; decode "
        f"{decode_s:.3f} s ({seq / decode_s:.1f} steps/s, batch 1)")
    return err


def phase_serve(device, cfg, n_requests: int = 8, batch: int = 4,
                max_new: int = 16, seed: int = 0, card: str = "") -> Dict:
    """``Server`` on ``cfg`` (its own seed-0 weights) answers
    ``n_requests`` requests of 4-12 prompt tokens (serve.py's CLI
    defaults); every request ends with ``max_new`` tokens."""
    device = torch.device(device)
    server = Server(cfg, batch=batch, device=device)
    rng = np.random.default_rng(seed)
    reqs = [Request(rid, rng.integers(0, cfg.vocab,
                                      size=rng.integers(4, 12)).tolist(),
                    max_new) for rid in range(n_requests)]
    for r in reqs:
        server.submit(r)
    t0 = time.perf_counter()
    server.drain()
    _sync(device)
    wall = time.perf_counter() - t0
    for r in reqs:
        if not r.done or len(r.out) != max_new or \
                not all(0 <= t < cfg.vocab for t in r.out):
            raise AssertionError(f"request {r.rid}: done {r.done}, "
                                 f"{len(r.out)} tokens {r.out}")
    prompt = sum(len(r.prompt) for r in reqs)
    out = n_requests * max_new
    log(f"serve {cfg.name} {batch} slots on {card or device}: {n_requests} "
        f"requests ({prompt} prompt tokens) done, {out} new tokens in "
        f"{wall:.3f} s ({out / wall:.1f} tok/s)")
    return {"wall_s": wall, "new_tokens": out, "prompt_tokens": prompt}


# ---------------------------------------------------------------------- #
# 10-12: flash attention, block-sparse matmul, the kernel bench
# ---------------------------------------------------------------------- #
def attn_shape(cfg, batch: int, seq: int) -> Tuple[int, ...]:
    """(b, h, hkv, sq, sk, d) of the ``flash_attention`` call of one
    layer's prefill of ``batch`` x ``seq`` tokens."""
    return (batch, cfg.n_heads, cfg.n_kv_heads, seq, seq, cfg.hdim)


def flash_flops(shape, causal: bool = True) -> int:
    """Operations of QK^T and PV over the (query, key) pairs the mask
    keeps."""
    b, h, hkv, sq, sk, d = shape
    if causal:      # query i keeps keys 0..min(i, sk - 1)
        n = min(sq, sk)
        pairs = n * (n + 1) // 2 + max(sq - sk, 0) * sk
    else:
        pairs = sq * sk
    return 4 * b * h * d * pairs


def flash_bound(shape, dtype, causal: bool = True) -> Tuple[float, str]:
    """The least time (ms) of one ``flash_attention`` call on an H100 and
    what sets it: q, k, v read once and o written once, against
    ``flash_flops`` at the peak rate of the input dtype."""
    b, h, hkv, sq, sk, d = shape
    es = torch.empty(0, dtype=dtype).element_size()
    nbytes = es * (2 * b * h * sq * d + 2 * b * hkv * sk * d)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flash_flops(shape, causal) / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _attn_inputs(shape, dtype, device: torch.device, seed: int):
    b, h, hkv, sq, sk, d = shape
    gen = torch.Generator(device).manual_seed(seed)
    return tuple(torch.randn(s, generator=gen, device=device).to(dtype)
                 for s in ((b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))


def phase_flash_kernel(device, prefill_shape=None, shapes=ATTN_SHAPES,
                       reps: int = 10, seed: int = 5, card: str = "") -> Dict:
    """``flash_attention`` against ``flash_attention_plain`` within
    FLASH_ATOL at the Qwen2-7B prefill shape and the reference's test
    shapes, fp32 and bf16, causal and not, and on the ragged-tail case;
    at the prefill shape (causal, both dtypes) the kernel's time beside
    its bound, the plain version's and SDPA's.  Returns the bf16 causal
    prefill record."""
    device = torch.device(device)
    if prefill_shape is None:
        prefill_shape = attn_shape(TC.get(DENSE_ARCH), PREFILL_BATCH,
                                   PREFILL_SEQ)
    cases = [(s, c) for s in (prefill_shape,) + tuple(shapes)
             for c in (True, False)] + [(ATTN_RAGGED, False)]
    rec = None
    for shape, causal in cases:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = _attn_inputs(shape, dtype, device, seed)
            got = flash_attention(q, k, v, causal=causal)
            want = flash_attention_plain(q, k, v, causal=causal)
            err = (got.float() - want.float()).abs()
            if got.shape != want.shape or got.dtype != dtype or \
                    not bool(torch.isfinite(got).all()) or \
                    not float(err.max()) <= FLASH_ATOL[dtype]:
                raise AssertionError(f"flash_attention != plain at {shape} "
                                     f"{dtype} causal={causal}: max abs "
                                     f"err {float(err.max())}")
            err = float(err.max())
            del got, want
            if shape != prefill_shape or not causal:
                log(f"flash_kernel {shape} {dtype} causal={causal}: max abs "
                    f"err {err:.3g}")
                continue
            bound, by = flash_bound(shape, dtype)
            r = {"name": "flash_attention", "route": "cuda",
                 "source": KERNEL_INFO["flash_attention"][0],
                 "replaces": KERNEL_INFO["flash_attention"][1],
                 "launches": 0, "max_abs_err": err,
                 "ms": _time_ms(lambda: flash_attention(q, k, v), device,
                                reps),
                 "plain_ms": _time_ms(lambda: flash_attention_plain(q, k, v),
                                      device, reps),
                 "bound_ms": bound, "bound_by": by,
                 "library_ms": _time_ms(
                     lambda: torch.nn.functional.scaled_dot_product_attention(
                         q, k, v, is_causal=True, enable_gqa=True),
                     device, reps)}
            tflops = flash_flops(shape) / r["ms"] * 1e-9
            log(f"flash_kernel {shape} {dtype} causal on {card or device}: "
                f"max abs err {err:.3g}; {r['ms']:.4f} ms, {tflops:.1f} "
                f"TFLOP/s, {bound / r['ms']:.1%} of the bound {bound:.4f} "
                f"ms by {by} (plain {r['plain_ms']:.4f}, SDPA "
                f"{r['library_ms']:.4f})")
            if dtype == torch.bfloat16:
                rec = r
            del q, k, v
    return rec


def bsmm_bound(n_tiles: int, bm: int, bk: int, K: int, N: int, m: int,
               a_dtype, b_dtype=None) -> Tuple[float, str, str]:
    """The least time (ms) of one ``block_sparse_matmul`` call over
    ``n_tiles`` nonzero tiles at the kernel's accuracy, what sets it and
    the route: the tiles, their int64 coordinates and B read once and Z
    (fp32) written once, against 2 bm bk N operations a tile on tensor
    cores.  bf16 x bf16 products are exact, one pass at the bf16 peak;
    an fp32 operand takes 3xTF32 (two TF32 passes when the other is
    bf16, which TF32 holds exactly) at the TF32 peak."""
    b_dtype = a_dtype if b_dtype is None else b_dtype
    es_a = torch.empty(0, dtype=a_dtype).element_size()
    es_b = torch.empty(0, dtype=b_dtype).element_size()
    nbytes = es_a * n_tiles * bm * bk + es_b * K * N + 8 * n_tiles \
        + 4 * m * N
    flops = 2 * n_tiles * bm * bk * N
    fp32 = (a_dtype == torch.float32) + (b_dtype == torch.float32)
    if fp32 == 0:
        t_ops, route = flops / PEAK_FLOPS[torch.bfloat16], "bf16 tensor cores"
    else:
        passes = 1 + fp32
        t_ops, route = passes * flops / TF32_FLOPS, \
            f"{passes}xTF32 tensor cores"
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops *= 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), route


def _bsmm_inputs(case, device: torch.device, seed: int):
    """Seeded dense A with whole zero tiles (fp32, host) and B on the
    device, and ``compact_tiles``' tile list on the device."""
    M, K, N, bm, bk, _, density = case
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((M, K), dtype=np.float32)
    a *= np.kron(rng.random((M // bm, K // bk)) < density,
                 np.ones((bm, bk), np.float32))
    b = torch.from_numpy(rng.standard_normal((K, N), dtype=np.float32)) \
        .to(device)
    tiles, rows, cols = (torch.from_numpy(x).to(device)
                         for x in compact_tiles(a, bm, bk))
    return a, tiles, rows, cols, b


#: the (A tiles, B) dtype pairs the kernel takes
BSMM_DTYPES = ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
               (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16))


def phase_bsmm_kernel(device, card_case=BSMM_CARD, shapes=BSMM_SHAPES,
                      reps: int = 10, seed: int = 6, card: str = "") -> Dict:
    """``block_sparse_matmul`` against ``block_sparse_matmul_plain``
    (|err| <= BSMM_RTOL sqrt(K) max |Z|) at the reference's shapes (all
    four dtype pairs) and at ``card_case`` (fp32 and bf16), there timed
    beside its route's bound, the plain version's time and a dense
    ``torch.matmul`` of the masked A in the same dtype (fp32 with TF32
    off).  Returns the fp32 card-case record, with the bf16 one under
    ``bf16``."""
    device = torch.device(device)
    recs = {}
    for case in (card_case,) + tuple(shapes):
        M, K, N, bm, bk, bn, _ = case
        a, tiles, rows, cols, b = _bsmm_inputs(case, device, seed)
        pairs = BSMM_DTYPES[:2] if case == card_case else BSMM_DTYPES
        for dta, dtb in pairs:
            t, bb = tiles.to(dta), b.to(dtb)
            got = block_sparse_matmul(t, rows, cols, bb, m=M, bn=bn)
            want = block_sparse_matmul_plain(t, rows, cols, bb, M)
            limit = BSMM_RTOL * K ** 0.5 * max(1.0, float(want.abs().max()))
            err = float((got - want).abs().max()) if got.numel() else 0.0
            if got.shape != want.shape or got.dtype != torch.float32 or \
                    not err <= limit:
                raise AssertionError(f"block_sparse_matmul != plain at "
                                     f"{case} {dta}/{dtb}: max abs err "
                                     f"{err} (limit {limit})")
            del got, want
            if case != card_case:
                log(f"bsmm_kernel {case} {dta}/{dtb}: max abs err {err:.3g}")
                continue
            n_real = int(t.flatten(1).ne(0).any(1).sum())
            bound, by, route = bsmm_bound(n_real, bm, bk, K, N, M, dta, dtb)
            a_dev = torch.from_numpy(a).to(device, dta)
            rec = {"name": "block_sparse_matmul", "route": "cuda",
                   "source": KERNEL_INFO["block_sparse_matmul"][0],
                   "replaces": KERNEL_INFO["block_sparse_matmul"][1],
                   "launches": 0, "max_abs_err": err,
                   "ms": _time_ms(lambda: block_sparse_matmul(
                       t, rows, cols, bb, m=M, bn=bn), device, reps),
                   "plain_ms": _time_ms(lambda: block_sparse_matmul_plain(
                       t, rows, cols, bb, M), device, reps),
                   "bound_ms": bound, "bound_by": by, "bound_route": route,
                   "library_ms": _time_ms(lambda: torch.matmul(a_dev, bb),
                                          device, reps)}
            log(f"bsmm_kernel {case} {dta} on {card or device}: "
                f"{len(t)} tiles ({n_real} nonzero), max abs err {err:.3g} "
                f"(limit {limit:.3g}); {rec['ms']:.4f} ms (plain "
                f"{rec['plain_ms']:.4f}, dense matmul "
                f"{rec['library_ms']:.4f}, bound {bound:.4f} by {by} on "
                f"{route}, {bound / rec['ms']:.1%} of it)")
            recs[dta] = rec
            del a_dev
    rec = recs[torch.float32]
    rec["bf16"] = {k: v for k, v in recs[torch.bfloat16].items()
                   if k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                            "bound_by", "bound_route", "library_ms")}
    return rec


def phase_kernels_bench(device) -> Dict[str, int]:
    """``kernels_bench.run`` as its CLI runs it, every kernel's count set
    to 0 just before: each row within its oracle limit.  Returns the
    launches of every kernel in that run."""
    kernels = KERNELS + MODEL_KERNELS + (block_sparse_matmul,)
    for k in kernels:
        k.launches = 0
    rows = kernels_bench.run(device)
    launches = {k.__name__: k.launches for k in kernels}
    for r in rows:
        log(f"kernels_bench {r.name},{r.us_per_call:.1f},{r.err:.3g} "
            f"(limit {r.limit:.3g})")
        if not r.err <= r.limit:
            raise AssertionError(f"kernels_bench {r.name}: err {r.err} "
                                 f"above its limit {r.limit}")
    log(f"kernels_bench launches {launches}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # fp32 means fp32: no TF32 in matmuls or cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    name, smi = phase_device()
    phase_build()
    kernels = phase_kernels("cuda")
    phase_oracle("cuda")
    main_run = phase_main("cuda", card=smi)
    for rec in kernels:
        rec["launches"] = main_run["launches"][rec["name"]]
        rec.pop("shapes")
    slack = phase_search_slack("cuda", main_run["search_calls"])
    next(r for r in kernels if r["name"] == "search")["replay"] = slack
    if slack["total"]["launches"] != main_run["launches"]["search"]:
        raise AssertionError(f"recorded {slack['total']['launches']} search "
                             f"launches, counted "
                             f"{main_run['launches']['search']}")
    merges = phase_merge_slack("cuda", main_run["merge_calls"])
    for kernel, rec in merges.items():
        if rec["launches"] != main_run["launches"][kernel]:
            raise AssertionError(f"recorded {rec['launches']} {kernel} "
                                 f"launches, counted "
                                 f"{main_run['launches'][kernel]}")
        next(r for r in kernels if r["name"] == kernel)["replay"] = rec
    log("segmented_reduce ran in host numpy (no device kernel yet)")
    cfg = TC.get(MODEL_ARCH)
    ssd_rec = phase_ssd_kernel("cuda", card=smi)
    prefill = phase_prefill("cuda", cfg, PREFILL_BATCH, PREFILL_SEQ, card=smi)
    ssd_rec["launches"] = prefill["launches"]["ssd_chunk"]
    kernels.append(ssd_rec)
    phase_consistency("cuda", cfg, card=smi)
    phase_serve("cuda", cfg, card=smi)
    flash_rec = phase_flash_kernel("cuda", card=smi)
    bsmm_rec = phase_bsmm_kernel("cuda", card=smi)
    torch.cuda.empty_cache()
    bsmm_rec["launches"] = phase_kernels_bench("cuda")["block_sparse_matmul"]
    dense = TC.get(DENSE_ARCH)
    prefill = phase_prefill("cuda", dense, PREFILL_BATCH, PREFILL_SEQ,
                            card=smi)
    flash_rec["launches"] = prefill["launches"]["flash_attention"]
    kernels += [flash_rec, bsmm_rec]
    torch.cuda.empty_cache()
    phase_consistency("cuda", dense, seq=DENSE_CONSISTENCY_SEQ, card=smi)
    torch.cuda.empty_cache()
    phase_serve("cuda", dense, card=smi)
    for rec in kernels:
        if rec["launches"] <= 0:
            raise AssertionError(f"{rec['name']} never launched on its "
                                 f"path")
    log(f"total {time.perf_counter() - t0:.1f} s on {smi}")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
