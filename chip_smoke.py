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
  6. graph       -- the graph designs (Graphicionado, GraphDynS, Ours-VCP)
                    under BFS and SSSP at 48^2 vertices with the hand
                    kernels and with the plain versions: identical; then
                    the Fig-13 study at 362^2 vertices and 64 iterations on
                    the kernels, every launch equal to its plain version on
                    the same inputs, every run equal to the reference's record
                    (``BENCH_graph.json``), its claims the reference's; then
                    ``search`` and the merges replayed at the sizes of
                    their launches there;
  7. dse         -- the design-space exploration layer on Gamma at the main
                    phase's size: the 16-point FiberCache axis and a
                    256-point axis on the analytic backend (points/s, every
                    point analytic), four capacities on the hand kernels
                    (each point equal to its own ``simulate`` call, whose
                    launches are held to the plain versions; ``search``
                    launches counted; analytic/vector ratios), then at
                    2048^2 the thread executor, crash and resume, an
                    injected seam fault (recorded, the point fails, no
                    plain version runs) and the process executor;
  8. throughput  -- the simulator's SpMSpM throughput
                    (``backend_throughput.bench``): rowwise at 1024^2,
                    4096^2 and 10000^2, flattened and partitioned at
                    1024^2 and 4096^2, 1% dense, on the hand kernels
                    (every launch held to its plain version) and on the
                    plain versions: equal work and output digests; leaf
                    multiplies/s, stage and seam seconds, launches; then
                    the seams' keys/s at 2^20 keys on both lowerings,
                    their outputs identical;
  9. ssd_kernel  -- ``ssd_chunk`` against ``ssd_chunk_plain`` at the
                    Mamba2-1.3B prefill shape (bf16 and fp32) and the
                    reference's test shapes, timed beside the bound of
                    each dtype's route (TFLOP/s and share of it; fp32 on
                    3xTF32, the fp32 CUDA-core figure logged beside);
 10. prefill     -- ``make_prefill_step`` on Mamba2-1.3B at full width,
                    batch 4 x 2048 tokens, with the kernel and with stage
                    (1) on the plain version: logits and greedy tokens
                    agree, one kernel launch per layer;
 11. consistency -- in fp32 at full width, the last-position logits of a
                    512-token prefill against 512 ``serve_step`` decode
                    steps; the fp32 kernels' launches counted in each
                    (one ``ssd_chunk`` a layer in the prefill), and each
                    kernel call held to its plain version on its own
                    inputs;
12. serve       -- ``Server`` at full width, 4 slots, 8 requests of 4-12
                    prompt tokens and 16 new tokens each;
13. flash_kernel -- ``flash_attention`` against ``flash_attention_plain``
                    at the Qwen2-7B prefill shape and the reference's test
                    shapes (fp32 and bf16, causal and not, a ragged KV
                    tail), timed beside its bound (TFLOP/s and share of
                    it) and SDPA;
14. bsmm_kernel  -- ``block_sparse_matmul`` against its plain version at
                    the reference's test shapes (all four dtype pairs) and
                    an 8192 x 8192 A at 30% tile density (fp32 and bf16),
                    there timed beside its route's bound and a dense
                    ``torch.matmul`` in the same dtype;
15. kernels_bench -- ``repro_torch.bench.kernels_bench.run``: every kernel
                    at the reference bench's shapes against its oracle (the
                    path that launches ``block_sparse_matmul``);
16. dense_prefill -- phase 10 for Qwen2-7B at full width: one
                    ``flash_attention`` launch per layer, and the same
                    prefill with ``mha`` on the plain version;
17. dense_consistency -- phase 11 for Qwen2-7B, 256 tokens;
18. dense_serve  -- phase 12 for Qwen2-7B;
19. family_kernels -- ``flash_attention`` against its plain version at
                    Whisper-small's four attention shapes (encoder 1500^2
                    and cross 448 x 1500 non-causal, decoder 448^2 causal,
                    one decode query over 1500 frames) and at one layer's
                    prefill of Qwen2-MoE-A2.7B and of the reduced Jamba
                    (causal, 4 x 2048; fp32 and bf16), the encoder and the
                    decode query timed beside their bound, the plain
                    version and SDPA; then ``ssd_chunk`` against its plain
                    version at the reduced Jamba's prefill shape (bf16 and
                    fp32), timed beside its bound;
20. moe_prefill  -- phase 10 for Qwen2-MoE-A2.7B at full width (24
                    ``flash_attention`` launches), the logits held to a
                    plain run that replays the kernel run's expert routes
                    (``MOE_PREFILL_*``); the share of dropped assignments
                    printed; then the limits' evidence: the same held at
                    two more seeds, and with each of two faults planted
                    in ``flash_attention`` (``PREFILL_FAULTS``) the limits
                    or the kernel's own hold at that shape must fail;
21. moe_consistency -- phase 11 for Qwen2-MoE at 4 layers and capacity
                    factor 60 (nothing drops in prefill or decode), 256
                    tokens;
22. moe_serve    -- phase 12 for Qwen2-MoE;
23. moe_dispatch -- one layer's ``moe_ffn`` on the card against the same
                    function on the CPU: routes equal, output within bf16
                    rounding;
24. encdec_prefill -- phase 10 for Whisper-small at full width, 4 x 448
                    decoder tokens over 1,500 seeded frames (36
                    ``flash_attention`` launches);
25. encdec_consistency -- phase 11 for Whisper-small (cross cache primed
                    from the frames), 128 tokens;
26. encdec_serve -- phase 12 for Whisper-small, its cross cache primed;
27. hybrid_prefill -- phase 10 for Jamba-1.5-Large at one superblock and
                    half width (``hybrid_config``): 1 ``flash_attention``
                    and 7 ``ssd_chunk`` launches;
28. hybrid_consistency -- phase 11 for that Jamba at capacity factor 60,
                    256 tokens;
29. hybrid_serve -- phase 12 for that Jamba.

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
import tempfile
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
from repro_torch.bench import (backend_throughput, dse_sweep,  # noqa: E402
                               fig13_vcp, kernels_bench)
from repro_torch.dse import SweepEngine  # noqa: E402
from repro_torch.kernels import (KERNELS, MODEL_KERNELS,  # noqa: E402
                                 block_sparse_matmul,
                                 block_sparse_matmul_plain, build,
                                 compact_tiles, flash_attention,
                                 flash_attention_plain, merge_path,
                                 merge_path_plain, multi_merge_ranks,
                                 multi_merge_ranks_plain, search,
                                 search_plain, ssd_chunk, ssd_chunk_plain)
from repro_torch.kernels import backends as kbk  # noqa: E402
from repro_torch.kernels.backends import (CudaKernels,  # noqa: E402
                                          TorchKernels)
# kernel vs plain flash attention, by dtype (the reasons are the constant's)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    ATOL as FLASH_ATOL)
from repro_torch.launch.serve import Request, Server  # noqa: E402
from repro_torch.launch.steps import (make_prefill_step,  # noqa: E402
                                      make_serve_step)
from repro_torch.models import api  # noqa: E402
from repro_torch.models import encdec as encdec_mod  # noqa: E402
from repro_torch.models import layers as layers_mod  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.layers import padded_vocab  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402
from repro_torch.obs.spans import trace_session  # noqa: E402
from repro_torch.testing import faults  # noqa: E402

#: H100 SXM device-memory rate and dense peaks (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12,      # tensor cores, bf16
              torch.float32: 67e12}        # CUDA cores, fp32
#: TF32 tensor cores, dense
TF32_FLOPS = 495e12


def route_ms(flops: int, dtype, cuda_cores: bool = False
             ) -> Tuple[float, str]:
    """The least time (ms) of ``flops`` useful operations on the route
    the model kernels take for ``dtype``, and the route: bf16 products
    are exact in fp32, one pass at the bf16 peak; fp32 operands go as
    3xTF32 (``csrc/tf32.cuh``), three passes at the TF32 peak.  With
    ``cuda_cores``, fp32 on the fp32 CUDA cores instead, the route of the
    port's first fp32 kernels (logged beside the bound)."""
    if dtype == torch.bfloat16:
        return flops / PEAK_FLOPS[dtype] * 1e3, "bf16 tensor cores"
    if cuda_cores:
        return flops / PEAK_FLOPS[dtype] * 1e3, "fp32 CUDA cores"
    return 3 * flops / TF32_FLOPS * 1e3, "3xTF32 tensor cores"


def _cuda_core_note(bound: Callable[..., Tuple[float, str, str]], *args
                    ) -> str:
    """For an fp32 ``bound(*args)`` (``flash_bound``, ``ssd_bound``; the
    dtype second), the same bound on the fp32 CUDA cores, to log beside
    the 3xTF32 one."""
    if args[1] != torch.float32:
        return ""
    ms, by, route = bound(*args, cuda_cores=True)
    return f"; {ms:.4f} ms by {by} on {route}"


COUNTERS = ("touch_counts", "iter_counts", "compute_counts",
            "isect_steps", "isect_matches", "advances", "merges")

#: the main path's configurations: (design, rows = cols, nonzeros per
#: operand).  Gamma at the low end of the paper's Table 4 range; the
#: others at the sizes whose seam calls reach each kernel's main shapes.
MAIN_CONFIGS = (("gamma", 8192, 100_000), ("extensor", 4096, 40_000),
                ("outerspace", 2048, 20_000), ("sigma", 2048, 20_000),
                ("matraptor", 2048, 20_000), ("sparse-add", 8192, 100_000),
                ("sparse-add-3way", 8192, 100_000))

#: phase dse: Gamma at the main phase's size (the low end of the paper's
#: Table 4 range), its FiberCache capacities (MB) swept on the vector path,
#: and the smaller Gamma that the engine's behaviour is checked on
DSE_SIZE = (8192, 100_000)
DSE_VECTOR_CAPS = (0.002, 0.05, 1.0, 6.0)
DSE_ENGINE_SIZE = (2048, 20_000)

#: every kernel the script counts, in the result line's order
ALL_KERNELS = KERNELS + MODEL_KERNELS + (block_sparse_matmul,)
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

#: bf16 Qwen2-MoE prefill, kernel vs plain attention with the kernel
#: run's expert routes replayed in the plain run (``phase_prefill``): the
#: same bf16 roundings as the dense model's, carried through 24 layers of
#: MoE FFNs.  The limits are twice what the kernel showed in its first
#: full-width run on an H100 (max 0.2617, mean 0.02994 on logits up to
#: 5.4, 9.84% of greedy tokens different; PERF.md), by the rule of the
#: limits above; the dense limits do not hold here.  Phase
#: moe_prefill_faults holds two more seeds within them and shows that a
#: flash that drops the last key tile, or rounds its output to float8,
#: fails them (``PREFILL_FAULTS``; the readings are in PERF.md).
MOE_PREFILL_MAX_ABS, MOE_PREFILL_MEAN_ABS, MOE_PREFILL_GREEDY_SHARE = \
    0.52, 0.06, 0.80

#: the MoE, encoder-decoder and hybrid model paths: Qwen2-MoE-A2.7B and
#: Whisper-small at their published widths, Jamba-1.5-Large reduced
#: (``hybrid_config``)
MOE_ARCH, ENCDEC_ARCH, HYBRID_ARCH = ("qwen2-moe-a2.7b", "whisper-small",
                                      "jamba-1.5-large-398b")
#: Whisper's decoder length: 448 tokens over its 1,500 frames
ENCDEC_PREFILL_SEQ = 448
#: the consistency phases' capacity factor.  With the configs' 1.25 a
#: 256-token prefill has one slot a group per expert (Qwen2-MoE) and
#: drops assignments that batch-1 decode keeps, so the two compute
#: different functions by design; at 60 the prefill has 64 slots a group
#: (Qwen2-MoE; 128 for Jamba) and decode 4 (7), and nothing drops.
CONSISTENCY_CAPACITY = 60.0
#: Qwen2-MoE's consistency phase: layers kept (fp32 at full width) and
#: tokens
MOE_CONSISTENCY_LAYERS, MOE_CONSISTENCY_SEQ = 4, 256
ENCDEC_CONSISTENCY_SEQ = 128
HYBRID_CONSISTENCY_SEQ = 256
#: moe_dispatch: (batch, tokens) of the layer input, small enough for the
#: CPU run it is held to (16 groups of 64 tokens, 5 slots an expert)
MOE_DISPATCH_SHAPE = (4, 256)
#: moe_dispatch, card vs CPU output in bf16: the same products rounded to
#: bf16 at the same places, summed in another order (BF16_ATOL of the CPU
#: tests, on outputs of magnitude about 1)
MOE_DISPATCH_ATOL = 6e-2
#: Whisper-small's attention calls, ((b, h, hkv, sq, sk, d), causal):
#: the encoder, the decoder's self- and cross-attention in a 4 x 448
#: prefill, and decode's cross-attention of one query
WHISPER_ATTN = (((4, 12, 12, 1500, 1500, 64), False),
                ((4, 12, 12, 448, 448, 64), True),
                ((4, 12, 12, 448, 1500, 64), False),
                ((4, 12, 12, 1, 1500, 64), False))
#: the Whisper calls phase 19 times, by their index in WHISPER_ATTN
WHISPER_TIMED = {"encoder": 0, "cross_decode": 3}
#: launches a timing of those calls: one decode query takes about 0.05
#: ms, so ten launches are too short a window for a stable mean
WHISPER_REPS = 100
#: the reduction of ``jamba-1.5-large-398b`` that runs on one card
HYBRID_REDUCTION = ("n_layers 72 -> 8 (one superblock: 1 attention, 7 "
                    "Mamba, MoE at odd positions), d_model 8192 -> 4096, "
                    "n_heads 64 -> 32, d_ff and d_expert 24576 -> 12288; "
                    "unchanged: 8 KV heads of 128, 16 experts top-2, "
                    "vocab 65536, the SSM (d_state 128, head dim 64, "
                    "chunk 256, expand 2)")


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


def _hold(held: Optional[Dict[str, float]], name: str, plain, args, got):
    """With ``held`` given, hold one wrapper call's output ``got`` to the
    plain version's on the same input tensors (``torch.equal``, every
    output); count the calls that launched (``held[name]``) and the host
    seconds the checks took (``held["seconds"]``)."""
    if held is None:
        return
    t0 = time.perf_counter()
    want = plain(*args)
    outs = got if isinstance(got, tuple) else (got,)
    wants = want if isinstance(want, tuple) else (want,)
    if not all(torch.equal(g, w) for g, w in zip(outs, wants)):
        raise AssertionError(f"{name} differs from its plain version at "
                             f"sizes {[len(a) for a in args]}")
    if outs[0].numel():                         # the wrapper launched
        held[name] = held.get(name, 0) + 1
    held["seconds"] = held.get("seconds", 0.0) + time.perf_counter() - t0


@contextlib.contextmanager
def record_search_calls(calls: List[Tuple[int, int, bool]],
                        held: Optional[Dict[str, float]] = None):
    """Appends (keys, probes, probes sorted) for every ``search`` the
    CUDA lowering makes while open: only ``lookup_keys`` passes probes
    unsorted.  With ``held``, each call is also held to ``search_plain``
    on its own tensors (``_hold``)."""
    search_fn, lookup = CudaKernels._search, CudaKernels.lookup_keys
    in_lookup = []

    def recording_search(hay, probes):
        calls.append((len(hay), len(probes), not in_lookup))
        out = search_fn(hay, probes)
        _hold(held, "search", search_plain, (hay, probes), out)
        return out

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
def record_merge_calls(calls: List[Tuple[str, Tuple[int, ...]]],
                       held: Optional[Dict[str, float]] = None):
    """Appends ("merge_path", (len a, len b)) and ("multi_merge_ranks",
    row lengths) for every merge the CUDA lowering makes while open.
    With ``held``, each call is also held to its plain version on its own
    tensors (``_hold``)."""
    merge, multi = CudaKernels._merge, CudaKernels._multi_merge

    def recording_merge(a, b):
        calls.append(("merge_path", (len(a), len(b))))
        out = merge(a, b)
        _hold(held, "merge_path", merge_path_plain, (a, b), out)
        return out

    def recording_multi(keys, offs):
        o = offs.tolist()
        calls.append(("multi_merge_ranks",
                      tuple(hi - lo for lo, hi in zip(o, o[1:]))))
        out = multi(keys, offs)
        _hold(held, "multi_merge_ranks", multi_merge_ranks_plain,
              (keys, offs), out)
        return out

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
                       seed: int = 3, path: str = "main") -> Dict:
    """``search`` at the sizes of a path's own launches (``path`` names
    it in the log; the main phase's by default): each
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
        log(f"search at the {path} phase's sizes, {part}: {rec['launches']} "
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


def phase_merge_slack(device, calls, reps: int = 5, seed: int = 7,
                      path: str = "main") -> Dict:
    """``merge_path`` and ``multi_merge_ranks`` at the sizes of a path's
    own launches (``path`` names it in the log; the main phase's by
    default): each recorded case replayed on random sorted
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
        log(f"{name} at the {path} phase's sizes: {rec['launches']} launches "
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


def phase_replays(device, run: Dict, path: str = "main") -> Dict[str, Dict]:
    """``search`` and the merges replayed at the sizes of a path's
    launches (``run``: what ``phase_main`` or ``phase_graph`` returns),
    by kernel; each replay must hold as many launches as the path
    counted."""
    out = {"search": phase_search_slack(device, run["search_calls"],
                                        path=path),
           **phase_merge_slack(device, run["merge_calls"], path=path)}
    for name, rec in out.items():
        recorded = (rec["total"] if name == "search" else rec)["launches"]
        if recorded != run["launches"][name]:
            raise AssertionError(f"recorded {recorded} {name} launches on "
                                 f"the {path} path, counted "
                                 f"{run['launches'][name]}")
    return out


# ---------------------------------------------------------------------- #
# 6: the graph path (paper Sec. 8, Fig. 13)
# ---------------------------------------------------------------------- #
def _launch_sizes(search_calls, merge_calls) -> Dict[str, Dict[str, int]]:
    """Largest and median size of the recorded launches: probes a
    ``search`` (calls without probes launch nothing), keys a merge."""
    sizes = {"search": [n for _, n, _ in search_calls if n]}
    for name, rows in merge_calls:
        if sum(rows):
            sizes.setdefault(name, []).append(sum(rows))
    return {k: {"largest": max(v), "median": int(statistics.median(v))}
            for k, v in sizes.items() if v}


def phase_graph(device, side: int = fig13_vcp.FULL_SIDE,
                check_side: int = fig13_vcp.SMOKE_SIDE,
                max_iters: int = fig13_vcp.MAX_ITERS, card: str = "") -> Dict:
    """The graph designs' path on ``device``.  First BFS and SSSP on the
    three designs at ``check_side``^2 vertices, with the hand kernels and
    with the plain versions on the same device: identical outputs,
    counters, Reports and iteration counts, no fallback.  Then the Fig-13
    study (``fig13_vcp.bench``) at ``side``^2 vertices on the kernels,
    traced, every launch held to its plain version on its own input
    tensors (``_hold``): per run its wall seconds without those checks,
    iterations, reached vertices,
    modeled seconds, launches, engine stages and seam calls; the
    speedups and claims; no fallback; at the study's full size both
    gated claims, every run at the iteration cap and equal to the
    reference's record (``BENCH_graph.json``).  Returns the launches of
    every seam kernel over the study, its summary, and the sizes of every
    ``search`` and merge launch there."""
    device = torch.device(device)
    v = check_side * check_side
    t0 = time.perf_counter()
    for algo, weighted, g in fig13_vcp.graphs(check_side):
        for design, spec in fig13_vcp.designs(weighted, v).items():
            label = f"graph {algo}/{design} {check_side}^2"
            runs = []
            for backend in (VectorBackend(device=device), VectorBackend(
                    device=device, kernel_backend=TorchKernels(device))):
                ci = CollectingInstr()
                res, iters = fig13_vcp.run_vcp(spec, g, v, backend,
                                               extra_instr=ci,
                                               max_iters=max_iters)
                _assert_native(label, res)
                runs.append((res, ci, iters))
            _assert_same(label, runs[0][:2], runs[1][:2])
            if runs[0][2] != runs[1][2]:
                raise AssertionError(f"{label}: {runs[0][2]} iterations "
                                     f"with the kernels, {runs[1][2]} plain")
    log(f"graph: BFS and SSSP on 3 designs at {check_side}^2 vertices on "
        f"{device}: kernels and plain versions identical (outputs, "
        f"counters, Reports, iterations), no fallback; 12 runs in "
        f"{time.perf_counter() - t0:.1f} s")
    search_calls: List[Tuple[int, int, bool]] = []
    merge_calls: List[Tuple[str, Tuple[int, ...]]] = []
    held: Dict[str, float] = {"seconds": 0.0}
    run_fn = fig13_vcp._run

    def held_run(*args, **kwargs):
        # the seconds of one run's checks, to take out of its wall time
        t = held["seconds"]
        rec = run_fn(*args, **kwargs)
        rec["check_seconds"] = held["seconds"] - t
        return rec

    fig13_vcp._run = held_run
    try:
        with record_search_calls(search_calls, held), \
                record_merge_calls(merge_calls, held):
            out = fig13_vcp.bench(side=side, device=device,
                                  max_iters=max_iters, trace=True)
    finally:
        fig13_vcp._run = run_fn
    launches = {k.__name__: 0 for k in KERNELS}
    for key, r in out["runs"].items():
        for k, c in r["launches"].items():
            launches[k] += c
        # the checks run inside the seam calls, which run inside the
        # engine's stages: wall and seam times are given without them
        check = r.pop("check_seconds")
        outside = r["wall_seconds"] - sum(r["stage_seconds"].values())
        wall = r["wall_seconds"] = r["wall_seconds"] - check
        seams = sum(r["seam_seconds"].values()) - check
        log(f"graph {key} {side}^2 on {card or device}: "
            f"{wall:.3f} s (traced, without {check:.3f} s of per-launch "
            f"checks), {r['iters']} iterations, reached {r['reached']}, "
            f"modeled {r['modeled_seconds']!r} s; launches {r['launches']}")
        log("  stages (s, with the checks): " + ", ".join(
            f"{k} {t:.3f}" for k, t in r["stage_seconds"].items())
            + f"; outside the vector engine {outside:.3f}")
        log("  seam calls (s, with the checks): " + ", ".join(
            f"{k} {t:.3f}" for k, t in r["seam_seconds"].items())
            + f"; without the checks {seams:.3f}, {seams / wall:.1%} of "
              f"the run")
    checked = {k: int(held.get(k, 0)) for k in launches}
    if checked != launches:
        raise AssertionError(f"graph study: held {checked} launches to the "
                             f"plain versions, counted {launches}")
    log(f"graph {side}^2: every launch equal to its plain version on its "
        f"own inputs ({checked}); the checks took {held['seconds']:.3f} s")
    log(f"graph speedups {out['speedups']}")
    log(f"graph claims {out['claims']}")
    # the direction claims hold at the study's size, not at a toy one
    failed = [] if out["claims"]["all_native"] else ["all_native"]
    if side == fig13_vcp.FULL_SIDE:
        failed = fig13_vcp.gate(out)
        failed += [f"{key}: {r['iters']} iterations"
                   for key, r in out["runs"].items()
                   if r["iters"] != max_iters]
        failed += fig13_vcp.compare(
            out, json.loads(fig13_vcp.REFERENCE_JSON.read_text()))
    if failed:
        raise AssertionError(f"graph study {side}^2: {failed}")
    sizes = _launch_sizes(search_calls, merge_calls)
    log(f"graph launches {launches}; launch sizes {sizes}")
    if device.type == "cuda" and not (launches["search"]
                                      and launches["merge_path"]):
        raise AssertionError(f"graph path launched {launches}")
    return {"launches": launches, "summary": out, "sizes": sizes,
            "search_calls": search_calls, "merge_calls": merge_calls}


# ---------------------------------------------------------------------- #
# 7: design-space exploration (paper Sec. 8)
# ---------------------------------------------------------------------- #
def _objectives(results) -> List[Tuple]:
    return [(r.label, r.seconds, r.energy_pj, r.dram_bytes,
             dict(r.fallback_reasons), r.error) for r in results]


def _dse_engine_checks(device, size, seed: int, where) -> None:
    """The sweep engine's behaviour on ``device``'s vector path at
    ``size``, over the capacities ``DSE_VECTOR_CAPS``: the thread
    executor (4 workers) equals the serial sweep; a crash injected at
    point 3 under a checkpoint, then a resumed sweep, equals it bit for
    bit; a seam fault injected into ``intersect_keys`` is recorded as a
    DowngradeEvent, passes
    ``verify_no_silent_downgrades`` and runs no plain version -- on the
    card it fails its point with a structured error, on the CPU the
    interpreter reruns the Einsum; the process executor (2 workers) on
    the analytic backend equals its serial sweep."""
    device = torch.device(device)
    inputs, shapes = dse_sweep.sparse_workload(*size, seed)
    pts = dse_sweep.fibercache_space(DSE_VECTOR_CAPS).grid()

    def engine(**kw):
        return SweepEngine(inputs, shapes, backend="vector", device=device,
                           **kw)

    t0 = time.perf_counter()
    serial = engine().sweep(pts)
    if not all(r.ok and not r.fallback_reasons for r in serial):
        raise AssertionError(f"dse engine: {_objectives(serial)}")
    threaded = engine(max_workers=4).sweep(pts)
    if _objectives(threaded) != _objectives(serial):
        raise AssertionError("dse: the thread executor differs from the "
                             "serial sweep")
    with tempfile.TemporaryDirectory() as ckpt:
        faults.install_injector(faults.FaultInjector(
            [faults.FaultSpec(kind="crash", point=pts[3].label, at=1)]))
        try:
            engine().sweep(pts, checkpoint_dir=ckpt, checkpoint_every=1)
            raise AssertionError("dse: the injected crash did not fire")
        except faults.SimulatedCrash:
            pass
        finally:
            faults.clear_injector()
        resumed = engine().sweep(pts, checkpoint_dir=ckpt, resume=True)
    if sum(r.restored for r in resumed) != 3 or \
            _objectives(resumed) != _objectives(serial):
        raise AssertionError("dse: crash and resume differ from the "
                             "uninterrupted sweep")
    # the seam fault: count every call of a plain version and of the
    # interpreter while it is armed
    plain_calls = []
    plain = {k: getattr(TorchKernels, k)
             for k in ("_search", "_merge", "_multi_merge")}
    execute = PythonBackend.execute

    def counted(fn):
        def call(*args, **kwargs):
            plain_calls.append(fn)
            return fn(*args, **kwargs)
        return call

    kbk.reset_guard_state()
    for k, fn in plain.items():
        setattr(TorchKernels, k, staticmethod(counted(fn)))
    PythonBackend.execute = counted(execute)
    faults.install_injector(faults.FaultInjector([faults.FaultSpec(
        kind="raise", seam="intersect_keys", at=1)]))
    try:
        hit = engine().sweep(pts[:2])
        fired = faults.active_injector().seam_faults_fired
        events = kbk.events_recorded()
        faults.verify_no_silent_downgrades()
    finally:
        faults.clear_injector()
        for k, fn in plain.items():
            setattr(TorchKernels, k, staticmethod(fn))
        PythonBackend.execute = execute
        kbk.reset_guard_state()
    if fired != 1 or events < 1:
        raise AssertionError(f"dse: {fired} seam faults fired, {events} "
                             f"DowngradeEvents recorded")
    if _objectives(hit[1:]) != _objectives(serial[1:2]):
        raise AssertionError("dse: the point after the seam fault differs")
    if device.type == "cuda":
        bad = hit[0]
        if bad.ok or bad.error_type != "KernelChainExhausted" or \
                not bad.traceback or plain_calls:
            raise AssertionError(f"dse: seam fault on the card: {bad.error}; "
                                 f"{len(plain_calls)} plain calls")
        outcome = (f"the point failed ({bad.error_type}: {bad.error[:90]}), "
                   f"no plain version and no interpreter ran")
    else:
        if not hit[0].ok or not hit[0].fallback_reasons:
            raise AssertionError(f"dse: seam fault on the CPU: {hit[0]}")
        outcome = "the CPU's interpreter reran the Einsum"
    aserial = SweepEngine(inputs, shapes).sweep(pts)
    pooled = SweepEngine(inputs, shapes, executor="process",
                         max_workers=2).sweep(pts)
    if _objectives(pooled) != _objectives(aserial):
        raise AssertionError("dse: the process executor differs from the "
                             "serial analytic sweep")
    log(f"dse engine, Gamma {size[0]}^2 nnz {size[1]}, {len(pts)} points on "
        f"{where}: 4 threads equal serial; crash at point 3 then resume "
        f"equal (3 restored); a seam fault recorded ({events} event), "
        f"{outcome}; 2 processes (analytic) equal "
        f"serial; {time.perf_counter() - t0:.1f} s")


def phase_dse(device, size=DSE_SIZE, vector_caps=DSE_VECTOR_CAPS,
              engine_size=DSE_ENGINE_SIZE, seed: int = 2,
              card: str = "") -> Dict:
    """The design-space exploration layer (``repro_torch.dse``) on Gamma
    at ``size`` (rows = cols, nonzeros per operand): the FiberCache axis
    (16 points) and the 256-point scale axis on the analytic backend,
    every point analytic with no fallback, in points/s (the median and
    range of ``dse_sweep.ANALYTIC_REPEATS`` sweeps); then
    ``vector_caps`` on ``device``'s vector path, traced: every point
    native with no downgrade and bit-identical to one ``simulate`` call
    of it (whose launches are each held to their plain version), with
    its analytic/vector ratios; then the engine's behaviour at
    ``engine_size`` (``_dse_engine_checks``).  Returns the kernels'
    launches in the vector sweep and its numbers."""
    device = torch.device(device)
    where = card or device
    n, nnz = size
    inputs, shapes = dse_sweep.sparse_workload(n, nnz, seed)
    eng = SweepEngine(inputs, shapes)
    out: Dict = {"analytic": {}}
    analytic = {}
    for axis, caps in (("fibercache", dse_sweep.CAPACITIES_MB),
                       ("scale", dse_sweep.scale_capacities())):
        pts = dse_sweep.fibercache_space(caps).grid()
        eng.prime(pts[0])
        res, secs = dse_sweep.timed_sweeps(eng, pts,
                                           dse_sweep.ANALYTIC_REPEATS)
        bad = [r.label for r in res if not r.ok or r.fallback_reasons]
        if bad:
            raise AssertionError(f"dse analytic points not analytic: {bad}")
        analytic.update({r.label: r for r in res})
        rates = sorted(len(pts) / dt for dt in secs)
        out["analytic"][axis] = {"points": len(pts), "seconds": secs,
                                 "points_per_s": statistics.median(rates)}
        log(f"dse analytic, {axis} axis, Gamma {n}^2 nnz {nnz}: "
            f"{len(pts)} points, {len(secs)} sweeps of "
            f"{[round(dt, 4) for dt in secs]} s: median "
            f"{statistics.median(rates):.1f} points/s, range "
            f"{rates[0]:.1f}-{rates[-1]:.1f} (host numpy; {where})")
    pts = dse_sweep.fibercache_space(vector_caps).grid()
    veng = SweepEngine(inputs, shapes, backend="vector", device=device,
                       keep_reports=True)
    for k in KERNELS:
        k.launches = 0
    with trace_session() as tr:
        t0 = time.perf_counter()
        vec = veng.sweep(pts)
        _sync(device)
        dt = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in KERNELS}
    seams = sum(sp["dur"] for sp in tr.spans(cat="seam")) / 1e6
    for r in vec:
        if not r.ok or r.fallback_reasons or r.report.downgrade_events:
            raise AssertionError(f"dse vector {r.label}: {r.error} "
                                 f"{r.fallback_reasons}")
    if device.type == "cuda" and not launches["search"]:
        raise AssertionError(f"dse vector sweep launched {launches}")
    out.update(launches=launches, vector={
        "points": len(pts), "seconds": dt, "points_per_s": len(pts) / dt,
        "point_seconds": [r.wall_seconds for r in vec],
        "seam_seconds": seams, "seam_share": seams / dt})
    log(f"dse vector, Gamma {n}^2 nnz {nnz}, {len(pts)} points on {where}: "
        f"{dt:.3f} s traced, {len(pts) / dt:.4f} points/s, host s a point "
        f"{[round(r.wall_seconds, 3) for r in vec]}; seam calls "
        f"{seams:.3f} s ({seams / dt:.2%}); launches {launches}")
    # each point against one simulate call of it; every launch of those
    # calls held to its plain version on its own inputs
    held: Dict[str, float] = {"seconds": 0.0}
    for k in KERNELS:
        k.launches = 0
    with record_search_calls([], held), record_merge_calls([], held):
        for p, r in zip(pts, vec):
            one = simulate("gamma", inputs, shapes, device=device,
                           **p.spec_kwargs).report
            if (one.seconds, one.energy_pj, one.dram_bytes) != \
                    (r.seconds, r.energy_pj, r.dram_bytes):
                raise AssertionError(f"dse {r.label}: the sweep's point "
                                     f"differs from its simulate call")
    checked = {k.__name__: int(held.get(k.__name__, 0)) for k in KERNELS}
    if checked != {k.__name__: k.launches for k in KERNELS}:
        raise AssertionError(f"dse: held {checked} launches, counted "
                             f"{[k.launches for k in KERNELS]}")
    log(f"dse vector points equal their simulate calls; those calls' "
        f"launches {checked} each equal their plain version")
    ratios = []
    for r in vec:
        a = analytic[r.label]
        ratios.append({"label": r.label, **{
            f: getattr(a, f) / getattr(r, f)
            for f in ("seconds", "energy_pj", "dram_bytes")}})
        log(f"  {r.label}: analytic / vector seconds "
            f"{ratios[-1]['seconds']:.4f}, energy "
            f"{ratios[-1]['energy_pj']:.4f}, DRAM bytes "
            f"{ratios[-1]['dram_bytes']:.4f}")
    out["ratios"] = ratios
    _dse_engine_checks(device, engine_size, seed + 1, where)
    return out


# ---------------------------------------------------------------------- #
# 8: the simulator's throughput and the seams' rates
# ---------------------------------------------------------------------- #
#: the seam operands' keys (the reference's ``seam_rates`` default)
SEAM_KEYS = 1 << 20
#: work keys a kernel record must share with its plain record; the
#: digest stands for the output CSF's arrays
SAME_WORK = ("elements", "out_nnz", "nnz_a", "nnz_b", "out_sha256")


def _same_outputs(got, want) -> bool:
    """Seam outputs equal: arrays (dtype, shape, values) and the tuples
    and lists that hold them, element by element."""
    if isinstance(got, (tuple, list)):
        return isinstance(want, (tuple, list)) and len(got) == len(want) \
            and all(_same_outputs(g, w) for g, w in zip(got, want))
    got, want = np.asarray(got), np.asarray(want)
    return got.dtype == want.dtype and np.array_equal(got, want)


def phase_throughput(device, sizes=backend_throughput.SIZES,
                     mapped_sizes=backend_throughput.MAPPED_SIZES,
                     seam_keys: int = SEAM_KEYS, card: str = "") -> Dict:
    """The simulator's SpMSpM throughput (``backend_throughput.bench``,
    one run a record, traced) on ``device``: rowwise at ``sizes``,
    flattened and partitioned at ``mapped_sizes``, 1% dense, on the
    device's own lowering (every ``search`` and merge launch held to its
    plain version on its own tensors, the checks' seconds taken out of
    each run) and on the plain versions on the same device: equal work
    keys and output digests; the interpreter at the smallest size.  Then
    ``kernels_bench.seam_rates`` of every lowering the device runs at
    ``seam_keys`` keys, each seam's outputs equal between them.  Returns
    the launches of every kernel in those runs (not in the checks), the
    records, their summary and the seam rates; ``card`` names the device
    beside every rate."""
    device = torch.device(device)
    where = card or device
    held: Dict[str, float] = {"seconds": 0.0}
    measure = backend_throughput._measure_vector

    def held_measure(*args, **kwargs):
        # the checks run inside the seam calls of the timed run
        before = dict(held)
        rec = measure(*args, **kwargs)
        check = held["seconds"] - before["seconds"]
        rec["seconds"] -= check
        rec["check_seconds"] = check
        rec["held"] = {k.__name__: int(held.get(k.__name__, 0)
                                       - before.get(k.__name__, 0))
                       for k in KERNELS}
        return rec

    t0 = time.perf_counter()
    backend_throughput._measure_vector = held_measure
    try:
        with record_search_calls([], held), record_merge_calls([], held):
            kern = backend_throughput.bench(
                sizes=list(sizes), backend="both", py_max_size=sizes[0],
                mapped_sizes=list(mapped_sizes), device=device, reps=1,
                trace=True)
    finally:
        backend_throughput._measure_vector = measure
    plain = backend_throughput.bench(
        sizes=list(sizes), backend="vector", mapped_sizes=list(mapped_sizes),
        device=device, reps=1, kernel_backend=TorchKernels(device),
        trace=True)
    launches = {k.__name__: 0 for k in ALL_KERNELS}
    by_key = {(r["workload"], r["size"]): r for r in plain}
    for r in kern:
        if r["backend"] != "vector":
            log(f"throughput {r['workload']} {r['size']}^2 interpreter on the "
                f"host of {where}: {r['seconds']:.3f} s, "
                f"{r['elements_per_sec']:.1f} multiplies/s, {r['elements']} "
                f"multiplies")
            continue
        p = by_key[(r["workload"], r["size"])]
        diff = [k for k in SAME_WORK if r[k] != p[k]]
        if diff or r["lowering"] != kbk.kernels_for(device).name or \
                p["lowering"] != "torch":
            raise AssertionError(f"throughput {r['workload']} {r['size']}: "
                                 f"kernels and plain versions differ in "
                                 f"{diff} ({r['lowering']}, "
                                 f"{p['lowering']})")
        if r["held"] != r["launches"]:
            raise AssertionError(f"throughput {r['workload']} {r['size']}: "
                                 f"held {r['held']} launches, counted "
                                 f"{r['launches']}")
        for k, c in r["launches"].items():
            launches[k] += c
        seams = sum(r["seam_seconds"].values()) - r["check_seconds"]
        log(f"throughput {r['workload']} {r['size']}^2 on {where}: kernels "
            f"{r['seconds']:.3f} s (without {r['check_seconds']:.3f} s of "
            f"per-launch checks), {r['elements_per_sec']:.1f} multiplies/s; "
            f"plain {p['seconds']:.3f} s, {p['elements_per_sec']:.1f} "
            f"multiplies/s; {r['elements']} multiplies, {r['out_nnz']} "
            f"output nonzeros, identical; seam calls {seams:.3f} s "
            f"({seams / r['seconds']:.2%}); launches {r['launches']}, each "
            f"equal to its plain version")
    big = max((r for r in kern if r["backend"] == "vector"
               and r["workload"] == "rowwise"), key=lambda r: r["size"])
    log(f"  stages at rowwise {big['size']}^2 (s, kernel run, traced): "
        + ", ".join(f"{k} {v:.3f}" for k, v in big["stage_seconds"].items())
        + f"; outside the stages "
          f"{big['seconds'] - sum(big['stage_seconds'].values()):.3f}")
    summary = backend_throughput.summarize(kern)
    log(f"throughput summary on {where}: " + ", ".join(
        f"{k} {v}" for k, v in summary.items()
        if k not in ("records", "mappings", "metric", "workload")))
    # the seams' own rates: counted launches, then the comparison
    for k in ALL_KERNELS:
        k.launches = 0
    lows = kernels_bench.lowerings(device)
    rates = {name: kernels_bench.seam_rates(name, device, seam_keys)
             for name in lows}
    for k in ALL_KERNELS:
        launches[k.__name__] += k.launches
    seam_launches = {k.__name__: k.launches for k in KERNELS}
    outs = {name: kernels_bench.seam_outputs(name, device, seam_keys)
            for name in lows}
    for name in lows[1:]:
        bad = [seam for seam in outs[name]
               if not _same_outputs(outs[name][seam], outs[lows[0]][seam])]
        if bad:
            raise AssertionError(f"seams {bad}: {name} differs from "
                                 f"{lows[0]}")
    for name, r in rates.items():
        log(f"seam rates at {seam_keys} keys, {name} on {where} (keys/s): "
            + ", ".join(f"{k} {v:.1f}" for k, v in r.items()))
    log(f"  seam outputs identical across {list(lows)}; launches "
        f"{seam_launches}")
    if device.type == "cuda" and not launches["search"]:
        raise AssertionError(f"throughput path launched {launches}")
    log(f"throughput phase: {time.perf_counter() - t0:.1f} s; launches "
        f"{launches}")
    return {"launches": launches, "records": kern, "plain": plain,
            "summary": summary, "seam_rates": rates}


# ---------------------------------------------------------------------- #
# 9-12: the Mamba2 model path
# ---------------------------------------------------------------------- #
def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


#: the model kernels a prefill launches: the module that calls each, and
#: its plain version
PREFILL_KERNELS = {"ssd_chunk": (ssm_mod, ssd_chunk_plain),
                   "flash_attention": (layers_mod, flash_attention_plain)}
#: per family, the limits (max abs, mean abs, greedy-token share) that hold
#: the kernels' bf16 logits to the plain versions'.  Whisper takes the
#: dense family's (one attention kernel, 36 launches deep); the hybrid
#: takes Mamba2's (both kernels swapped at once).
PREFILL_LIMITS = {
    "ssm": (PREFILL_MAX_ABS, PREFILL_MEAN_ABS, PREFILL_GREEDY_SHARE),
    **{f: (DENSE_PREFILL_MAX_ABS, DENSE_PREFILL_MEAN_ABS,
           DENSE_PREFILL_GREEDY_SHARE) for f in ("dense", "encdec")},
    "moe": (MOE_PREFILL_MAX_ABS, MOE_PREFILL_MEAN_ABS,
            MOE_PREFILL_GREEDY_SHARE),
    "hybrid": (PREFILL_MAX_ABS, PREFILL_MEAN_ABS, PREFILL_GREEDY_SHARE),
}


def prefill_launches(cfg) -> Dict[str, int]:
    """Per kernel, its launches in one prefill of ``cfg`` on the card:
    one ``ssd_chunk`` per Mamba layer, one ``flash_attention`` per
    attention (Whisper: each encoder layer, each decoder layer's self-
    and cross-attention)."""
    if cfg.family == "ssm":
        return {"ssd_chunk": cfg.n_layers}
    if cfg.family == "encdec":
        return {"flash_attention": cfg.enc_layers + 2 * cfg.n_layers}
    if cfg.family == "hybrid":
        n = cfg.n_layers // cfg.hybrid_block
        return {"flash_attention": n,
                "ssd_chunk": n * (cfg.hybrid_block - 1)}
    return {"flash_attention": cfg.n_layers}


@contextlib.contextmanager
def plain_kernel(cfg):
    """``cfg``'s prefill kernels replaced by their plain versions for the
    duration (the run the kernels' prefill is held to)."""
    saved = {n: getattr(PREFILL_KERNELS[n][0], n)
             for n in prefill_launches(cfg)}
    for n in saved:
        setattr(PREFILL_KERNELS[n][0], n, PREFILL_KERNELS[n][1])
    try:
        yield
    finally:
        for n, kernel in saved.items():
            setattr(PREFILL_KERNELS[n][0], n, kernel)


@contextlib.contextmanager
def record_routes(routes: List[Tuple[torch.Tensor, ...]]):
    """Every ``moe.route`` call's (eid, slot, keep, gate), appended to
    ``routes`` for the duration."""
    route = moe_mod.route

    def recording(logits, top_k, capacity):
        out = route(logits, top_k, capacity)
        routes.append(out)
        return out
    moe_mod.route = recording
    try:
        yield
    finally:
        moe_mod.route = route


@contextlib.contextmanager
def replay_routes(routes: List[Tuple[torch.Tensor, ...]]):
    """``moe.route`` answering with ``routes`` in order for the duration
    (the plain run taking the kernel run's routing decisions); every
    route must be used."""
    route, it = moe_mod.route, iter(routes)
    moe_mod.route = lambda logits, top_k, capacity: next(it)
    try:
        yield
    finally:
        moe_mod.route = route
    if next(it, None) is not None:
        raise AssertionError("replay_routes: routes left over")


def dropped_share(routes) -> Optional[float]:
    """The share of expert assignments past capacity over ``routes``
    (None without MoE layers)."""
    if not routes:
        return None
    kept = sum(float(r[2].sum()) for r in routes)
    return 1.0 - kept / sum(r[2].numel() for r in routes)


def ssd_shape(cfg, batch: int, seq: int) -> Tuple[int, ...]:
    """(B, nc, l, H, P, N) of the ``ssd_chunk`` call of one layer's
    prefill of ``batch`` x ``seq`` tokens."""
    _, nh, p, n, _ = ssm_mod.dims(cfg)
    return (batch, seq // cfg.ssm.chunk, cfg.ssm.chunk, nh, p, n)


#: the numbers of a timed record that a record of the other dtype carries
TIMED_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
              "bound_route")


def ssd_flops(shape) -> int:
    """Operations of the causal half (j <= i) of G once per (b, c) and of
    Y per head."""
    B, nc, l, H, P, N = shape
    tri = l * (l + 1) // 2
    return 2 * B * nc * tri * N + 2 * B * nc * H * tri * P


def ssd_bound(shape, dtype, cuda_cores: bool = False
              ) -> Tuple[float, str, str]:
    """The least time (ms) of one ``ssd_chunk`` call on an H100, what
    sets it and the route: x, a, b and c read once and y (fp32) written
    once, against ``ssd_flops`` on the route of the input dtype
    (``route_ms``)."""
    B, nc, l, H, P, N = shape
    es = torch.empty(0, dtype=dtype).element_size()
    nbytes = es * (B * nc * l * H * P + 2 * B * nc * l * N) \
        + 4 * B * H * nc * l + 4 * B * nc * l * H * P
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops, route = route_ms(ssd_flops(shape), dtype, cuda_cores)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), route


def ssd_kernel_flops(shape, dtype) -> int:
    """Operations one ``ssd_chunk`` launch does on the card, as its tiles
    run (not the function's minimum, ``ssd_bound``'s): G over whole 64 x
    64 tiles j <= i once per (b, c, 8-head group), N padded to 16 (bf16
    k16 steps) or 8 (TF32 k8 steps), one pass in bf16 and three in fp32
    (3xTF32); Y over the 16 x 16 (i, j) slices the kernels compute, P
    padded to 16, three passes in either dtype (bf16 splits S three
    ways, fp32 takes 3xTF32)."""
    B, nc, l, H, P, N = shape
    rt = -(-l // 64)                          # row tiles of 64
    tiles = rt * (rt + 1) // 2                # (i, j) tiles with j <= i
    cells = B * nc * -(-H // 8)
    k = 16 if dtype == torch.bfloat16 else 8
    g_passes = 1 if dtype == torch.bfloat16 else 3
    g = g_passes * cells * tiles * 2 * 64 * 64 * (-(-N // k) * k)
    # off the diagonal 4 x 4 slices a tile; on it 1 + 2 + 3 + 4
    slices = 16 * (rt * (rt - 1) // 2) + 10 * rt
    y = B * nc * H * slices * 3 * 2 * 16 * 16 * (-(-P // 16) * 16)
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
    record, the fp32 one under ``fp32``."""
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
            bound, by, route = ssd_bound(shape, dtype)
            recs[dtype] = {
                "name": "ssd_chunk", "route": "cuda",
                "source": KERNEL_INFO["ssd_chunk"][0],
                "replaces": KERNEL_INFO["ssd_chunk"][1],
                "launches": 0, "max_abs_err": err,
                "ms": _time_ms(lambda: ssd_chunk(*args), device, reps),
                "plain_ms": _time_ms(lambda: ssd_chunk_plain(*args), device,
                                     reps),
                "bound_ms": bound, "bound_by": by, "bound_route": route,
                "library_ms": None}
            r = recs[dtype]
            tflops = ssd_kernel_flops(shape, dtype) / r["ms"] * 1e-9
            log(f"ssd_kernel {shape} {dtype} on {card or device}: max abs "
                f"err {err:.3g}; {r['ms']:.4f} ms, {tflops:.1f} TFLOP/s, "
                f"{bound / r['ms']:.1%} of the bound {bound:.4f} ms by {by} "
                f"on {route}{_cuda_core_note(ssd_bound, shape, dtype)} "
                f"(plain {r['plain_ms']:.4f})")
            del args, got, want
    rec = recs[torch.bfloat16]
    rec["fp32"] = {k: recs[torch.float32][k] for k in TIMED_KEYS}
    return rec


def phase_prefill(device, cfg, batch: int, seq: int, seed: int = 0,
                  card: str = "", hold: bool = True) -> Dict:
    """``make_prefill_step`` on ``cfg`` with seeded weights (and, for
    Whisper, seeded frames): once with the family's kernels
    (``prefill_launches``; every model kernel's count set to 0 just
    before) and once with those kernels on their plain versions, each
    after one warm-up.  Kernel and plain logits finite, within the
    family's limits (``PREFILL_LIMITS``) of each other, the same greedy
    token at most positions; each kernel launched as often as
    ``prefill_launches`` says on a CUDA device.  With ``hold`` false a
    limit passed is reported in ``fails`` and not raised (the readings of
    ``phase_prefill_faults``).

    MoE routing is discontinuous: a bf16 difference that reorders two
    router probabilities sends a token to another expert and shifts the
    slots behind it, so two runs that route for themselves part by whole
    expert outputs.  The plain run therefore replays the kernel run's
    routes, so that only the kernels differ; its time leaves out the
    routes' own sort (a few small launches a layer)."""
    device = torch.device(device)
    want = prefill_launches(cfg)
    params = api.init(cfg, torch.Generator(device).manual_seed(seed), device)
    data = api.make_batch(cfg, torch.Generator(device).manual_seed(seed + 1),
                          batch, seq)
    step = make_prefill_step(cfg, device)
    step(params, data)                                  # warm-up
    _sync(device)
    routes: List[Tuple[torch.Tensor, ...]] = []
    for k in MODEL_KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    with record_routes(routes):
        logits = step(params, data)
    _sync(device)
    kernel_s = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in MODEL_KERNELS
                if k.__name__ in want}
    with plain_kernel(cfg):
        with replay_routes(routes):
            step(params, data)                          # warm-up
        _sync(device)
        t0 = time.perf_counter()
        with replay_routes(routes):
            plain = step(params, data)
        _sync(device)
        plain_s = time.perf_counter() - t0
    del params
    dropped = dropped_share(routes)
    del routes
    if device.type != "cuda":
        want = {n: 0 for n in want}
    if launches != want:
        raise AssertionError(f"prefill launched {launches}, want {want}")
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
    extra = f" over {cfg.enc_frames} frames" if cfg.family == "encdec" \
        else ""
    drop = "" if dropped is None else (
        f"; expert assignments dropped {dropped:.4%}; plain run with the "
        f"kernel run's routes replayed")
    log(f"prefill {cfg.name} {batch}x{seq}{extra} {cfg.dtype} seed {seed} "
        f"on {card or device}: kernels {kernel_s:.4f} s "
        f"({tokens / kernel_s:.1f} tok/s), plain {'/'.join(want)} "
        f"{plain_s:.4f} s ({tokens / plain_s:.1f} tok/s); logits |max| "
        f"{scale:.4g}, mean |logit| {mean_mag:.4g}; kernels vs plain: max "
        f"abs diff {max_abs:.4g}, mean abs diff {mean_abs:.4g}, greedy "
        f"tokens equal {greedy:.2%}; launches {launches}{drop}")
    lim_max, lim_mean, lim_greedy = PREFILL_LIMITS[cfg.family]
    fails = [n for n, out in (("max_abs", max_abs > lim_max),
                              ("mean_abs", mean_abs > lim_mean),
                              ("greedy", greedy < lim_greedy)) if out]
    if hold and fails:
        raise AssertionError(
            f"prefill kernel vs plain: max abs {max_abs:.4g} (limit "
            f"{lim_max}), mean abs {mean_abs:.4g} (limit {lim_mean}), "
            f"greedy share {greedy:.4f} (limit {lim_greedy})")
    return {"launches": launches, "kernel_s": kernel_s, "plain_s": plain_s,
            "max_abs": max_abs, "mean_abs": mean_abs, "greedy": greedy,
            "dropped": dropped, "fails": fails}


def _drop_key_tile(kernel: Callable) -> Callable:
    """``kernel`` that leaves out the last 64 keys (one key tile; half
    the keys of a shorter sequence)."""
    def faulty(q, k, v, causal=True):
        sk = k.shape[2] - min(64, k.shape[2] // 2)
        return kernel(q, k[:, :, :sk], v[:, :, :sk], causal)
    return faulty


def _round_fp8(kernel: Callable) -> Callable:
    """``kernel`` whose output is rounded to float8 e4m3 (3 mantissa
    bits, 5 fewer than bf16)."""
    def faulty(q, k, v, causal=True):
        return kernel(q, k, v, causal).to(torch.float8_e4m3fn).to(q.dtype)
    return faulty


#: planted faults of ``flash_attention`` that ``MOE_PREFILL_*`` must catch
PREFILL_FAULTS = {"drop_key_tile": _drop_key_tile, "round_fp8": _round_fp8}


@contextlib.contextmanager
def planted_fault(fault: Callable):
    """The models' ``flash_attention`` replaced by ``fault`` of it for
    the duration."""
    kernel = layers_mod.flash_attention
    layers_mod.flash_attention = fault(kernel)
    try:
        yield
    finally:
        layers_mod.flash_attention = kernel


def phase_prefill_faults(device, cfg, batch: int = PREFILL_BATCH,
                         seq: int = PREFILL_SEQ, seeds=(1, 2),
                         card: str = "", seed: int = 5) -> Dict[str, Dict]:
    """The evidence behind ``cfg``'s prefill limits: ``phase_prefill``
    at each of ``seeds`` (sound readings beside the prefill phase's seed
    0, each within every limit) and at the first seed with each of
    ``PREFILL_FAULTS`` planted in the kernel run; each fault also held,
    as ``phase_family_kernels`` holds the kernel, to
    ``flash_attention_plain`` within FLASH_ATOL on seeded bf16 inputs at
    one layer's prefill shape.  Every fault must fail one of the two
    checks; which ones it fails is logged.  All readings are taken and
    logged before either rule is enforced."""
    device = torch.device(device)
    out = {f"seed {s}": phase_prefill(device, cfg, batch, seq, seed=s,
                                      card=card, hold=False) for s in seeds}
    q, k, v = _attn_inputs(attn_shape(cfg, batch, seq), torch.bfloat16,
                           device, seed)
    want = flash_attention_plain(q, k, v, True).float()
    for name, fault in PREFILL_FAULTS.items():
        with planted_fault(fault):
            out[name] = phase_prefill(device, cfg, batch, seq, seed=seeds[0],
                                      card=card, hold=False)
        got = fault(flash_attention)(q, k, v, True).float()
        out[name]["kernel_err"] = float((got - want).abs().max())
        del got
    del q, k, v, want
    for name, r in out.items():
        held = "" if "kernel_err" not in r else (
            f"; kernel vs plain max abs err {r['kernel_err']:.4g} (limit "
            f"{FLASH_ATOL[torch.bfloat16]})")
        log(f"prefill_faults {cfg.name} {name}: max abs {r['max_abs']:.4g},"
            f" mean abs {r['mean_abs']:.4g}, greedy {r['greedy']:.4f}; "
            f"limits {PREFILL_LIMITS[cfg.family]} passed: "
            f"{r['fails'] or 'none'}{held}")
    missed = [n for n in PREFILL_FAULTS if not out[n]["fails"] and
              not out[n]["kernel_err"] > FLASH_ATOL[torch.bfloat16]]
    unsound = [n for n in out if n not in PREFILL_FAULTS and out[n]["fails"]]
    if missed or unsound:
        raise AssertionError(f"prefill_faults: faults missed {missed}, "
                             f"sound readings past a limit {unsound}")
    return out


def consistency_config(cfg, **kw):
    """``cfg`` with ``kw`` replaced and, with MoE layers, the capacity
    factor at ``CONSISTENCY_CAPACITY`` (nothing drops)."""
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(cfg.moe,
                                        capacity_factor=CONSISTENCY_CAPACITY)
    return dataclasses.replace(cfg, **kw)


def decode_launches(cfg, steps: int) -> Dict[str, int]:
    """Per kernel of ``prefill_launches(cfg)``, its launches in ``steps``
    ``serve_step`` decode steps on the card: Whisper's cross-attention,
    one a decoder layer a step; every other decode attention and SSM
    step is plain torch."""
    n = cfg.n_layers * steps if cfg.family == "encdec" else 0
    return {k: n if k == "flash_attention" else 0
            for k in prefill_launches(cfg)}


@contextlib.contextmanager
def record_calls(cfg, calls: Dict[tuple, tuple]):
    """``cfg``'s model kernels (``prefill_launches``) run as before for
    the duration, and the first call of each signature (kernel, shapes,
    strides, dtypes, other arguments) is kept in ``calls`` as (name,
    kernel, copies of its arguments, keywords), to be held to the plain
    version by ``hold_calls`` afterwards."""
    saved = {n: getattr(PREFILL_KERNELS[n][0], n)
             for n in prefill_launches(cfg)}

    def recording(name, kernel):
        def call(*args, **kw):
            key = (name,) + tuple(
                (tuple(a.shape), a.stride(), a.dtype)
                if isinstance(a, torch.Tensor) else a
                for a in args) + tuple(sorted(kw.items()))
            if key not in calls:
                calls[key] = (name, kernel, tuple(
                    a.detach().clone() if isinstance(a, torch.Tensor)
                    else a for a in args), dict(kw))
            return kernel(*args, **kw)
        return call
    for n, kernel in saved.items():
        setattr(PREFILL_KERNELS[n][0], n, recording(n, kernel))
    try:
        yield
    finally:
        for n, kernel in saved.items():
            setattr(PREFILL_KERNELS[n][0], n, kernel)


def hold_calls(calls: Dict[tuple, tuple], label: str) -> Dict[str, float]:
    """Each call ``record_calls`` kept, again on its kernel and on the
    plain version: ``flash_attention`` within FLASH_ATOL of its dtype,
    ``ssd_chunk`` within SSD_TOL (1 + |want|), same shape, finite.
    Returns each kernel's largest max abs error."""
    errs: Dict[str, float] = {}
    with torch.no_grad():
        for name, kernel, args, kw in calls.values():
            got = kernel(*args, **kw)
            want = PREFILL_KERNELS[name][1](*args, **kw)
            diff = (got.float() - want.float()).abs()
            err = float(diff.max())
            limit = FLASH_ATOL[args[0].dtype] if name == "flash_attention" \
                else SSD_TOL
            held = err <= limit if name == "flash_attention" else \
                bool((diff <= SSD_TOL * (1 + want.float().abs())).all())
            shapes = [tuple(a.shape) for a in args
                      if isinstance(a, torch.Tensor)]
            if got.shape != want.shape or got.dtype != want.dtype or \
                    not bool(torch.isfinite(got).all()) or not held:
                raise AssertionError(f"{label}: {name} != plain at {shapes}"
                                     f" {args[0].dtype} {kw}: max abs err "
                                     f"{err}")
            log(f"{label}: {name} at {shapes} {args[0].dtype} {kw} held to "
                f"its plain version: max abs err {err:.3g} (limit {limit})")
            errs[name] = max(errs.get(name, 0.0), err)
            del got, want, diff
    return errs


def phase_consistency(device, cfg, seq: int = 512, seed: int = 4,
                      card: str = "") -> Dict:
    """In fp32, the last-position logits of a ``seq``-token prefill
    against ``seq`` ``serve_step`` decode steps (the reference's
    test_ssd_prefill_matches_decode, for the whole model); Whisper's
    cross cache is primed from the prefill's frames (cast to fp32)
    first.  Every model kernel's count is set to 0 just before the
    prefill and read just after it (``prefill_launches`` on a CUDA
    device), and again around the decode steps (``decode_launches``);
    then each kernel call of both, one a signature, is held to its plain
    version on a copy of its own inputs (``hold_calls``).  Returns the
    max abs difference (``max_abs``), the launches of the prefill and of
    the decode steps and the kernels' largest errors (``held``)."""
    device = torch.device(device)
    cfg = dataclasses.replace(cfg, dtype="float32")
    want = prefill_launches(cfg)
    want_decode = decode_launches(cfg, seq)
    if device.type != "cuda":
        want = want_decode = {n: 0 for n in want}
    params = api.init(cfg, torch.Generator(device).manual_seed(seed), device)
    data = api.make_batch(cfg, torch.Generator(device).manual_seed(seed + 1),
                          1, seq)
    toks = data.pop("tokens")
    data.pop("labels")
    data = {k: v.float() for k, v in data.items()}
    calls: Dict[tuple, tuple] = {}
    for k in MODEL_KERNELS:
        k.launches = 0
    with record_calls(cfg, calls):
        full = make_prefill_step(cfg, device)(
            params, dict(data, tokens=toks))[:, -1]
    _sync(device)
    launches = {k.__name__: k.launches for k in MODEL_KERNELS
                if k.__name__ in want}
    step = make_serve_step(cfg, device)
    cache = api.init_cache(cfg, 1, seq, dtype=torch.float32, device=device)
    if cfg.family == "encdec":
        with torch.inference_mode():
            cache = encdec_mod.prime_cache(cfg, params, cache,
                                           data["frames"])
    _sync(device)
    for k in MODEL_KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    with record_calls(cfg, calls):
        for t in range(seq):
            last, cache = step(params, cache, toks[:, t],
                               torch.full((1,), t))
    _sync(device)
    decode_s = time.perf_counter() - t0
    decoded = {k.__name__: k.launches for k in MODEL_KERNELS
               if k.__name__ in want}
    del params, cache
    if launches != want or decoded != want_decode:
        raise AssertionError(f"consistency {cfg.name}: prefill launched "
                             f"{launches}, want {want}; decode launched "
                             f"{decoded}, want {want_decode}")
    v = cfg.vocab
    err = float((full[:, :v] - last[:, :v]).abs().max())
    same = int(full[:, :v].argmax()) == int(last[:, :v].argmax())
    if not err <= CONSISTENCY_ATOL or not same:
        raise AssertionError(f"prefill vs decode: max abs {err:.4g} (limit "
                             f"{CONSISTENCY_ATOL}), same greedy token {same}")
    cap = "" if cfg.moe is None else \
        f", capacity factor {cfg.moe.capacity_factor} (nothing drops)"
    log(f"consistency {cfg.name} fp32 {cfg.n_layers} layers{cap}, {seq} "
        f"tokens on {card or device}: prefill vs {seq} decode steps max abs "
        f"{err:.3g} (logits |max| {float(full[:, :v].abs().max()):.4g}), "
        f"same greedy token; decode {decode_s:.3f} s ({seq / decode_s:.1f} "
        f"steps/s, batch 1); launches: prefill {launches}, decode "
        f"{decoded}")
    held = hold_calls(calls, f"consistency {cfg.name}")
    return {"max_abs": err, "launches": launches,
            "decode_launches": decoded, "held": held}


def phase_serve(device, cfg, n_requests: int = 8, batch: int = 4,
                max_new: int = 16, seed: int = 0, card: str = "") -> Dict:
    """``Server`` on ``cfg`` (its own seed-0 weights) answers
    ``n_requests`` requests of 4-12 prompt tokens (serve.py's CLI
    defaults); every request ends with ``max_new`` tokens.  Whisper's
    server gets its cross cache primed from seeded frames first (the
    server, as the reference's, never primes it)."""
    device = torch.device(device)
    server = Server(cfg, batch=batch, device=device)
    if cfg.family == "encdec":
        frames = torch.randn((batch, cfg.enc_frames, cfg.d_model),
                             generator=torch.Generator(device).manual_seed(
                                 seed + 1), device=device)
        with torch.inference_mode():
            server.cache = encdec_mod.prime_cache(
                cfg, server.params, server.cache, frames.to(torch.bfloat16))
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


def phase_moe_dispatch(device, cfg, shape=MOE_DISPATCH_SHAPE, seed: int = 8,
                       reps: int = 5, card: str = "") -> Dict:
    """One seeded MoE layer's ``moe_ffn`` on ``device`` against the same
    function with the input and the weights copied to the CPU: every
    route's expert, slot and kept flag equal, the output within
    ``MOE_DISPATCH_ATOL``, the aux loss within 1e-5; the layer's time on
    the device and its dropped share."""
    device = torch.device(device)
    gen = torch.Generator(device).manual_seed(seed)
    layer = moe_mod.MoELayer(cfg, gen, device)
    x = torch.randn((*shape, cfg.d_model), generator=gen, device=device) \
        .to(layers_mod._dtype(cfg))
    host = moe_mod.MoELayer(cfg, None, "cpu")
    host.load_state_dict(layer.state_dict())
    routes: List[Tuple[torch.Tensor, ...]] = []
    with torch.inference_mode(), record_routes(routes):
        got, aux = moe_mod.moe_ffn(cfg, layer, x)
        want, aux_host = moe_mod.moe_ffn(cfg, host, x.cpu())
    for name, a, b in zip(("eid", "slot", "keep"), routes[0], routes[1]):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"moe_dispatch: {name} differs from the "
                                 f"CPU's at {int((a.cpu() != b).sum())} "
                                 f"assignments")
    err = float((got.float().cpu() - want.float()).abs().max())
    aux_err = abs(float(aux) - float(aux_host))
    if not err <= MOE_DISPATCH_ATOL or not aux_err <= 1e-5:
        raise AssertionError(f"moe_dispatch: max abs err {err:.4g} (limit "
                             f"{MOE_DISPATCH_ATOL}), aux err {aux_err:.3g}")
    with torch.inference_mode():
        ms = _time_ms(lambda: moe_mod.moe_ffn(cfg, layer, x), device, reps)
    g, capacity = moe_mod.dispatch_shape(cfg, shape[0] * shape[1])
    dropped = dropped_share(routes[:1])
    log(f"moe_dispatch {cfg.name} {shape[0]}x{shape[1]} {cfg.dtype} on "
        f"{card or device}: {g} groups, capacity {capacity}; routes equal "
        f"to the CPU's, output max abs err {err:.3g}, aux err "
        f"{aux_err:.3g}; dropped {dropped:.4%}; {ms:.4f} ms a layer")
    return {"max_abs_err": err, "dropped": dropped, "ms": ms}


# ---------------------------------------------------------------------- #
# 13-15: flash attention, block-sparse matmul, the kernel bench
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


def flash_bound(shape, dtype, causal: bool = True,
                cuda_cores: bool = False) -> Tuple[float, str, str]:
    """The least time (ms) of one ``flash_attention`` call on an H100,
    what sets it and the route: q, k, v read once and o written once,
    against ``flash_flops`` on the route of the input dtype
    (``route_ms``)."""
    b, h, hkv, sq, sk, d = shape
    es = torch.empty(0, dtype=dtype).element_size()
    nbytes = es * (2 * b * h * sq * d + 2 * b * hkv * sk * d)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops, route = route_ms(flash_flops(shape, causal), dtype,
                            cuda_cores)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), route


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
    prefill record, the fp32 one under ``fp32``."""
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
            r = {"name": "flash_attention", "route": "cuda",
                 "source": KERNEL_INFO["flash_attention"][0],
                 "replaces": KERNEL_INFO["flash_attention"][1],
                 "launches": 0,
                 **_flash_times(q, k, v, causal, err, device, reps, card)}
            if dtype == torch.bfloat16:
                rec = r
            else:
                rec["fp32"] = {k: r[k] for k in TIMED_KEYS + ("library_ms",)}
            del q, k, v
    return rec


def _flash_times(q, k, v, causal: bool, err: float, device, reps: int,
                 card: str) -> Dict:
    """The kernel's time on q, k, v beside its bound, the plain version's
    and SDPA's (top-left causal mask, as the kernel's), logged."""
    shape = (*q.shape[:2], k.shape[1], q.shape[2], k.shape[2], q.shape[3])
    bound, by, route = flash_bound(shape, q.dtype, causal)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    r = {"max_abs_err": err,
         "ms": _time_ms(lambda: flash_attention(q, k, v, causal), device,
                        reps),
         "plain_ms": _time_ms(lambda: flash_attention_plain(q, k, v, causal),
                              device, reps),
         "bound_ms": bound, "bound_by": by, "bound_route": route,
         "library_ms": _time_ms(lambda: sdpa(q, k, v, is_causal=causal,
                                             enable_gqa=True), device, reps)}
    tflops = flash_flops(shape, causal) / r["ms"] * 1e-9
    log(f"flash_kernel {shape} {q.dtype} causal={causal} on {card or device}"
        f": max abs err {err:.3g}; {r['ms']:.4f} ms, {tflops:.1f} TFLOP/s, "
        f"{bound / r['ms']:.1%} of the bound {bound:.4f} ms by {by} on "
        f"{route}{_cuda_core_note(flash_bound, shape, q.dtype, causal)} "
        f"(plain {r['plain_ms']:.4f}, SDPA {r['library_ms']:.4f})")
    return r


def phase_flash_shapes(device, cases=WHISPER_ATTN, timed=WHISPER_TIMED,
                       reps: int = 10, seed: int = 9, card: str = ""
                       ) -> Dict[str, Dict]:
    """``flash_attention`` against ``flash_attention_plain`` within
    FLASH_ATOL at each ((b, h, hkv, sq, sk, d), causal) of ``cases`` in
    bf16 and fp32; the cases ``timed`` names (label -> index) timed
    beside their bound, the plain version's and SDPA's.  Returns their
    records, label -> dtype -> record."""
    device = torch.device(device)
    labels = {i: label for label, i in timed.items()}
    recs = {label: {} for label in timed}
    for i, (shape, causal) in enumerate(cases):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = _attn_inputs(shape, dtype, device, seed)
            got = flash_attention(q, k, v, causal=causal)
            want = flash_attention_plain(q, k, v, causal=causal)
            err = float((got.float() - want.float()).abs().max())
            if got.shape != want.shape or got.dtype != dtype or \
                    not bool(torch.isfinite(got).all()) or \
                    not err <= FLASH_ATOL[dtype]:
                raise AssertionError(f"flash_attention != plain at {shape} "
                                     f"{dtype} causal={causal}: max abs "
                                     f"err {err}")
            del got, want
            if i not in labels:
                log(f"flash_kernel {shape} {dtype} causal={causal}: max abs "
                    f"err {err:.3g}")
                continue
            recs[labels[i]]["bf16" if dtype == torch.bfloat16 else "fp32"] = \
                {"shape": list(shape), "causal": causal,
                 **_flash_times(q, k, v, causal, err, device, reps, card)}
    return recs


def family_attn_cases():
    """The ``flash_attention`` calls of the family paths, ((b, h, hkv,
    sq, sk, d), causal): Whisper's (``WHISPER_ATTN``, the encoder first),
    then one layer's prefill of Qwen2-MoE-A2.7B and of the reduced Jamba
    at ``PREFILL_BATCH`` x ``PREFILL_SEQ``."""
    return WHISPER_ATTN + tuple(
        (attn_shape(c, PREFILL_BATCH, PREFILL_SEQ), True)
        for c in (TC.get(MOE_ARCH), hybrid_config()))


def phase_family_kernels(device, card: str = "", reps: int = 10
                         ) -> Tuple[Dict[str, Dict], Dict]:
    """Phase 19: ``phase_flash_shapes`` on ``family_attn_cases`` (the
    Whisper calls timed over ``WHISPER_REPS`` launches) and
    ``phase_ssd_kernel`` at the reduced Jamba's prefill shape alone
    (``reps`` launches).  Returns the timed Whisper calls' flash
    records (``WHISPER_TIMED``) and Jamba's ``ssd_chunk`` record (bf16,
    its fp32 one inside)."""
    flash = phase_flash_shapes(device, family_attn_cases(),
                               reps=WHISPER_REPS, card=card)
    ssd = phase_ssd_kernel(device, ssd_shape(hybrid_config(), PREFILL_BATCH,
                                             PREFILL_SEQ), shapes=(),
                           reps=reps, card=card)
    return flash, ssd


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
    for k in ALL_KERNELS:
        k.launches = 0
    rows = kernels_bench.run(device)
    launches = {k.__name__: k.launches for k in ALL_KERNELS}
    for r in rows:
        log(f"kernels_bench {r.name},{r.us_per_call:.1f},{r.err:.3g} "
            f"(limit {r.limit:.3g})")
        if not r.err <= r.limit:
            raise AssertionError(f"kernels_bench {r.name}: err {r.err} "
                                 f"above its limit {r.limit}")
    log(f"kernels_bench launches {launches}")
    return launches


# ---------------------------------------------------------------------- #
# 19-29: the MoE, encoder-decoder and hybrid model paths
# ---------------------------------------------------------------------- #
def hybrid_config():
    """``jamba-1.5-large-398b`` as ``HYBRID_REDUCTION`` cuts it to one
    card: 11.56B parameters, 23.1 GB in bf16 and 46.3 GB in fp32 (the
    full model: 796 GB in bf16)."""
    cfg = TC.get(HYBRID_ARCH)
    return dataclasses.replace(
        cfg, name=cfg.name + "-1sb-half", n_layers=cfg.hybrid_block,
        d_model=cfg.d_model // 2, n_heads=cfg.n_heads // 2,
        d_ff=cfg.d_ff // 2,
        moe=dataclasses.replace(cfg.moe, d_expert=cfg.moe.d_expert // 2))


def _timed(name: str, smi: str, fn: Callable, /, *args, **kw):
    """``fn(*args, **kw)``, its seconds logged as phase ``name``'s."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    log(f"phase {name}: {time.perf_counter() - t0:.1f} s on {smi}")
    return out


def family_plan():
    """Phases 20-29, one model each: (path, config, prefill tokens, the
    consistency phase's config and tokens)."""
    moe, enc, hyb = TC.get(MOE_ARCH), TC.get(ENCDEC_ARCH), hybrid_config()
    return (("moe", moe, PREFILL_SEQ, consistency_config(
                moe, n_layers=MOE_CONSISTENCY_LAYERS), MOE_CONSISTENCY_SEQ),
            ("encdec", enc, ENCDEC_PREFILL_SEQ, enc, ENCDEC_CONSISTENCY_SEQ),
            ("hybrid", hyb, PREFILL_SEQ, consistency_config(hyb),
             HYBRID_CONSISTENCY_SEQ))


def phase_families(device, card: str, plan=None, batch: int = PREFILL_BATCH,
                   dispatch_shape=MOE_DISPATCH_SHAPE
                   ) -> Tuple[Dict[str, Dict[str, int]], Dict[str, Dict]]:
    """Phases 20-29 (``family_plan``), one model at a time, the cache
    emptied after each phase: prefill, consistency and serve, and for
    the MoE model one layer's dispatch against the CPU.  Returns each
    path's kernel launches (the bf16 prefill, ``<path>_prefill``; the
    fp32 consistency prefill, ``<path>_consistency``; Whisper's fp32
    decode steps, ``<path>_consistency_decode``) and each consistency
    path's ``phase_consistency`` result."""
    paths, results = {}, {}
    for path, cfg, seq, cons, cons_seq in plan or family_plan():
        phases = [("prefill", phase_prefill, (cfg, batch, seq)),
                  ("consistency", phase_consistency, (cons, cons_seq)),
                  ("serve", phase_serve, (cfg,))]
        if cfg.family == "moe":
            phases.insert(1, ("prefill_faults", phase_prefill_faults,
                              (cfg, batch, seq)))
            phases.append(("dispatch", phase_moe_dispatch,
                           (cfg, dispatch_shape)))
        for name, fn, args in phases:
            out = _timed(f"{path}_{name}", card, fn, device, *args,
                         card=card)
            if name == "prefill":
                paths[f"{path}_prefill"] = out["launches"]
            if name == "consistency":
                results[f"{path}_consistency"] = out
                paths[f"{path}_consistency"] = out["launches"]
                if cfg.family == "encdec":
                    paths[f"{path}_consistency_decode"] = \
                        out["decode_launches"]
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
    return paths, results


def attach_model_paths(kernels: List[Dict], paths: Dict[str, Dict[str, int]],
                       cons: Dict[str, Dict], throughput: Dict[str, int]
                       ) -> None:
    """Adds to each kernel record the launches of the model paths
    (``paths``: path -> kernel -> launches, the consistency paths among
    them) and of the throughput path.  A record with an ``fp32`` record
    gets there the launches of the fp32 consistency paths and, per path,
    the largest error of its kernel calls held to the plain version
    (``cons``: path -> ``phase_consistency`` result).  Fails if a kernel,
    or the fp32 route of one, never launched."""
    first = {"ssd_chunk": "prefill", "flash_attention": "dense_prefill",
             "block_sparse_matmul": "kernels_bench"}
    for rec in kernels:
        name = rec["name"]
        rec.setdefault("launches_by_path", {first.get(name): rec["launches"]})
        for path, launches in paths.items():
            if name in launches:
                rec["launches_by_path"][path] = launches[name]
                rec["launches"] += launches[name]
        rec["launches_by_path"]["throughput"] = throughput[name]
        rec["launches"] += throughput[name]
        if "fp32" in rec:
            fp32 = rec["fp32"]
            fp32["launches_by_path"] = {
                p: n[name] for p, n in paths.items()
                if "consistency" in p and name in n}
            fp32["launches"] = sum(fp32["launches_by_path"].values())
            fp32["max_abs_err_by_path"] = {
                p: c["held"][name] for p, c in cons.items()
                if name in c["held"]}
        for r, where in ((rec, "its paths"),
                         (rec.get("fp32"), "the fp32 consistency paths")):
            if r is not None and r["launches"] <= 0:
                raise AssertionError(f"{name} never launched on {where}")


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
    replays = phase_replays("cuda", main_run)
    for rec in kernels:
        rec["replay"] = replays[rec["name"]]
    graph = phase_graph("cuda", card=smi)
    replays = phase_replays("cuda", graph, path="graph")
    for rec in kernels:
        n = graph["launches"][rec["name"]]
        rec["launches_by_path"] = {"main": rec["launches"], "graph": n}
        rec["launches"] += n
        rec["graph"] = {"replay": replays[rec["name"]],
                        "sizes": graph["sizes"].get(rec["name"])}
    dse = phase_dse("cuda", card=smi)
    for rec in kernels:
        n = dse["launches"][rec["name"]]
        rec["launches_by_path"]["dse"] = n
        rec["launches"] += n
    throughput = phase_throughput("cuda", card=smi)["launches"]
    log("segmented_reduce ran in host numpy (no device kernel yet)")
    cfg = TC.get(MODEL_ARCH)
    ssd_rec = phase_ssd_kernel("cuda", card=smi)
    prefill = phase_prefill("cuda", cfg, PREFILL_BATCH, PREFILL_SEQ, card=smi)
    ssd_rec["launches"] = prefill["launches"]["ssd_chunk"]
    kernels.append(ssd_rec)
    cons = {"consistency": phase_consistency("cuda", cfg, card=smi)}
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
    cons["dense_consistency"] = phase_consistency(
        "cuda", dense, seq=DENSE_CONSISTENCY_SEQ, card=smi)
    torch.cuda.empty_cache()
    phase_serve("cuda", dense, card=smi)
    torch.cuda.empty_cache()
    flash_rec["whisper"], jamba_ssd = _timed(
        "family_kernels", smi, phase_family_kernels, "cuda", card=smi)
    ssd_rec["jamba_prefill_shape"] = {
        k: jamba_ssd[k] for k in TIMED_KEYS + ("fp32",)}
    torch.cuda.empty_cache()
    log(f"hybrid: {hybrid_config().name} = {HYBRID_ARCH} with "
        f"{HYBRID_REDUCTION}")
    paths, family_cons = phase_families("cuda", smi)
    cons.update(family_cons)
    paths.update({p: cons[p]["launches"]
                  for p in ("consistency", "dense_consistency")})
    attach_model_paths(kernels, paths, cons, throughput)
    log(f"total {time.perf_counter() - t0:.1f} s on {smi}")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
