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
                    point analytic), two capacities on the hand kernels
                    (each point equal to its own ``simulate`` call, whose
                    launches are held to the plain versions; ``search``
                    launches counted; analytic/vector ratios), then at
                    2048^2 the thread executor, crash and resume, an
                    injected seam fault (recorded, the point fails, no
                    plain version runs) and the process executor (at
                    1024^2 since the family train steps came);
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
                    256-token prefill against 256 ``serve_step`` decode
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
29. hybrid_serve -- phase 12 for that Jamba;
30. flash_grad   -- the ``flash_attention`` backward kernel against its
                    plain version (the forward kernel's o and lse as
                    inputs) at OLMo-1B's train shape, Qwen2-7B's GQA
                    shape, Whisper's cross shape and the family train
                    steps' shapes (Whisper's encoder and decoder
                    self-attention, the reduced Jamba's), bf16 and fp32, timed
                    beside its bound, the plain version and SDPA's
                    backward; each gradient element's error is taken
                    over the summed magnitude of its terms, and the
                    backward with its last 8 keys or its last key tile
                    dropped must fail the hold;
31. train_step   -- ``make_train_step`` on OLMo-1B at full width (bf16,
                    AdamW with its fp32 master copy, remat), batch 8 x
                    2048 from the ported pipeline: 2 warm-up and 5 timed
                    steps, tokens/s, the model-FLOP share, peak memory;
                    32 flash forward and 16 backward launches a step;
32. train_consistency -- OLMo-1B at full width and 2 layers in fp32: one
                    step's loss and gradients with the kernels against
                    the plain attention's; every forward and backward
                    kernel call held to its plain version;
33. trainer      -- ``launch/train.py`` at full width and 2 layers
                    (``--dp 1 --tp 1``: a 1 x 1 mesh over the card), 6
                    steps with a checkpoint every 3, then a fresh
                    ``Trainer`` on ``make_mesh(1, 1)`` resumed from step
                    3 to the same step-6 loss, every parameter and state
                    tensor whole on the card;
34. ssd_grad     -- the ``ssd_chunk`` backward kernel against its plain
                    version at Mamba2-1.3B's train shape, the reduced
                    Jamba's, two of the reference's test shapes (one
                    under strong decay) and a ragged one, bf16 and fp32,
                    timed beside its bound and the plain version; each
                    gradient element's error (less one bf16 rounding of a
                    bf16 gradient) over the summed magnitude of its terms;
                    three planted faults (a head left out of dB and dC,
                    the last row tile out of da's column sums, the last
                    row tile out of dx) must fail the hold, and two calls
                    must give the same bits;
35. mamba2_train_step -- phase 31 for Mamba2-1.3B at full width, all 48
                    layers: 96 ``ssd_chunk`` and 48 ``ssd_chunk_bwd``
                    launches a step, one step profiled;
36. mamba2_train_consistency -- phase 32 for Mamba2-1.3B at 2 layers,
                    against autograd through ``ssd_chunk_plain``;
37-42. {moe, encdec, hybrid}_train_step and _train_consistency -- phases
                    31 and 32 for Qwen2-MoE-A2.7B at full width and 4
                    layers (4 x 2048; fp32 at 2 layers), Whisper-small in
                    full (8 x 448 tokens over 8 x 1,500 frames in bf16;
                    fp32 at 2 encoder and 2 decoder layers) and Jamba at
                    one superblock, half width and FFNs of 2,048
                    (``hybrid_train_config``, 4 x 2048; fp32 whole, both
                    backward kernels); the model-FLOP share on active
                    parameters (Whisper's encoder over its frames); each
                    kernel call's dtype logged; the MoE's dropped share;
                    the fp32 holds replay the routes of the forward and
                    the recomputation;
43. roofline     -- host only: each train step and bf16 prefill this run
                    timed, dry-run on ``meta`` under ``h100_1x1``
                    (``launch/dryrun.step_costs``): its compute and
                    memory terms on the card's peaks
                    (``launch/roofline.peaks_for``), the dominant one,
                    each term over the measured seconds, the counted
                    operations over the model's; no step may beat its
                    compute term;
44. pod_dryrun   -- host only: OLMo-1B and Qwen2-MoE-A2.7B x train_4k
                    walked on the reference's 16 x 16 and 2 x 16 x 16
                    meshes (``launch/dryrun.run_cell``: DTensor on a
                    fake process group of 256 and 512 ranks, on
                    ``meta``), each device's compute, memory and
                    collective terms on the card's peaks (the collective
                    term on the network between nodes,
                    ``launch/roofline.link_bytes_per_s``), the
                    collectives by op and the walk's seconds; fails if a
                    walk errs or leaves a process group.

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
import math
import re
import statistics
import shutil
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
from repro_torch.configs.base import (ShapeSpec,  # noqa: E402
                                      active_param_count, encdec_weights)
from repro_torch.core.metrics import roofline  # noqa: E402
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
from repro_torch.kernels import (flash_attention_bwd,  # noqa: E402
                                 flash_attention_bwd_plain,
                                 flash_attention_lse_plain)
# kernel vs plain backward, by dtype (the reasons are the constant's)
from repro_torch.kernels.flash_attention_bwd import (  # noqa: E402
    ATOL as BWD_ATOL, bwd_err, flash_attention_bwd_scale)
from repro_torch.kernels import (ssd_chunk_bwd,  # noqa: E402
                                 ssd_chunk_bwd_plain)
# kernel vs plain ssd_chunk backward (the reasons are the constant's)
from repro_torch.kernels.ssd_chunk_bwd import (  # noqa: E402
    ATOL as SSD_BWD_ATOL, LAUNCHES as SSD_BWD_LAUNCHES,
    bwd_err as ssd_bwd_err, ssd_chunk_bwd_launch_ms, ssd_chunk_bwd_scale)
from repro_torch.kernels.backends import (CudaKernels,  # noqa: E402
                                          TorchKernels)
# kernel vs plain flash attention, by dtype (the reasons are the constant's)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    ATOL as FLASH_ATOL)
from repro_torch.launch.serve import Request, Server  # noqa: E402
from repro_torch.data import (DataConfig,  # noqa: E402
                              ShardedSyntheticDataset)
from repro_torch.launch.steps import (make_prefill_step,  # noqa: E402
                                      make_serve_step, make_train_step,
                                      model_batch)
from repro_torch.launch.train import main as train_main  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.roofline import (link_bytes_per_s,  # noqa: E402
                                         peaks_for)
from repro_torch.models import api  # noqa: E402
from repro_torch.models import encdec as encdec_mod  # noqa: E402
from repro_torch.models import layers as layers_mod  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.layers import padded_vocab  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402
from repro_torch.obs.spans import trace_session  # noqa: E402
from repro_torch.optim import optimizers as opt_mod  # noqa: E402
from repro_torch.runtime.trainer import Trainer  # noqa: E402
from repro_torch.testing import faults  # noqa: E402

#: the module of ``flash_attention`` (the package attribute of that name is
#: the function)
FA_MODULE = sys.modules["repro_torch.kernels.flash_attention"]
#: the module whose ``flash_attention_bwd`` ``FlashAttention.backward``
#: calls (the package attribute of that name is the function)
BWD_MODULE = sys.modules["repro_torch.kernels.flash_attention_bwd"]
#: the module whose ``ssd_chunk_bwd`` ``SsdChunk.backward`` calls
SSD_BWD_MODULE = sys.modules["repro_torch.kernels.ssd_chunk_bwd"]
#: the kernels' modules, whose ``flops`` and ``nbytes`` count the work a
#: bound is taken over (the dry run reads the same counts)
SSD_MODULE = sys.modules["repro_torch.kernels.ssd_chunk"]
BSMM_MODULE = sys.modules["repro_torch.kernels.block_sparse_matmul"]
MERGE_MODULES = {"merge_path": sys.modules["repro_torch.kernels.merge"],
                 "multi_merge_ranks":
                     sys.modules["repro_torch.kernels.multi_merge"]}

#: the card every bound is taken against: the H100 SXM's row of the
#: roofline's peaks table (NVIDIA data sheet)
BOUND_CARD = "NVIDIA H100 80GB HBM3"
_H100 = peaks_for(BOUND_CARD)
#: its device-memory rate and dense peaks
HBM_BYTES_PER_S = _H100.hbm_bytes_per_s
PEAK_FLOPS = {torch.bfloat16: _H100.bf16_flops,     # tensor cores, bf16
              torch.float32: _H100.fp32_flops}      # CUDA cores, fp32
#: TF32 tensor cores, dense
TF32_FLOPS = _H100.tf32_flops


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
#: the FiberCache axis's small end on the kernels (each point 50-60 s of
#: host time with its check; two took the script to 1,161 s of its 1,200
#: s limit on a slow host, four within 44 s of it before)
DSE_VECTOR_CAPS = (0.002,)
#: the engine's checks at DSE_ENGINE_SIZE (a crash at the fourth point);
#: 2,048^2 with 20K nonzeros took 72 s of the script on the card, cut to
#: make room for the MoE, encoder-decoder and hybrid train steps (the
#: checks compare the engine with itself, at any size)
DSE_ENGINE_CAPS = (0.002, 0.05, 1.0, 6.0)
DSE_ENGINE_SIZE = (1024, 10_000)

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
    # the backwards replace no TPU kernel (the Pallas kernels have no VJP):
    # the field names the kernel whose gradient each is
    "flash_attention_bwd": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/kernels/flash_attention.py:113"),
    "ssd_chunk_bwd": ("src/repro_torch/kernels/csrc/ssd_chunk_bwd.cu",
                      "src/repro/kernels/ssd_chunk.py:62"),
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
#: the reduction of that hybrid that trains on one card: AdamW with its
#: fp32 master copy costs about 16 bytes a parameter, so the 11.56B of
#: ``hybrid_config`` (185 GB of state) lose their FFN widths
HYBRID_TRAIN_REDUCTION = ("HYBRID_REDUCTION, then d_ff and d_expert 12288 "
                          "-> 2048: 3.01B parameters (1.60B active), about "
                          "48 GB of AdamW state; unchanged: 32 query and 8 "
                          "KV heads of 128, 16 experts top-2, the SSM (128 "
                          "heads of 64, state 128, chunk 256)")


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
    return MERGE_MODULES[name].nbytes(sizes) / HBM_BYTES_PER_S * 1e3


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
    ``size``, over the capacities ``DSE_ENGINE_CAPS``: the thread
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
    pts = dse_sweep.fibercache_space(DSE_ENGINE_CAPS).grid()

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


def _fwd_hold(args, got, want, err: float, limit, held: bool
              ) -> Tuple[float, str, bool]:
    ok = got.shape == want.shape and got.dtype == want.dtype and \
        bool(torch.isfinite(got).all())
    return err, f"limit {limit}", held and ok


def _flash_hold(args, kw, got, want) -> Tuple[float, str, bool]:
    """``flash_attention``: max abs error within FLASH_ATOL of its dtype."""
    err = float((got.float() - want.float()).abs().max())
    limit = FLASH_ATOL[args[0].dtype]
    return _fwd_hold(args, got, want, err, limit, err <= limit)


def _ssd_hold(args, kw, got, want) -> Tuple[float, str, bool]:
    """``ssd_chunk``: each element within SSD_TOL (1 + |want|)."""
    diff = (got.float() - want.float()).abs()
    held = bool((diff <= SSD_TOL * (1 + want.float().abs())).all())
    return _fwd_hold(args, got, want, float(diff.max()), SSD_TOL, held)


def _bwd_hold(err_fn: Callable, scale_fn: Callable, limit_of: Callable
              ) -> Callable[..., Tuple[float, str, bool]]:
    """A backward kernel's hold: ``err_fn`` (each element over its terms'
    magnitude, ``scale_fn``) within ``limit_of(dtype)``."""
    def hold(args, kw, got, want):
        err = err_fn(got, want, scale_fn(*args, **kw))
        abs_err = max((float((g.float() - w.float()).abs().max())
                       for g, w in zip(got, want) if g.numel()), default=0.0)
        limit = limit_of(args[0].dtype)
        return abs_err, f"bwd_err {err:.3g}, limit {limit}", err <= limit
    return hold


@dataclasses.dataclass(frozen=True)
class PathKernel:
    """A kernel of the model path: the module whose attribute of the
    kernel's name the path calls, the plain version, the device kernels'
    entry names as the profiler and nvcc show them, how one call is held
    to the plain version (``hold(args, kw, got, want)`` -> max abs error,
    what it was held to, whether it held), and for a forward kernel its
    backward kernel and the profile's name for it."""
    module: object
    plain: Callable
    entries: Tuple[str, ...]
    hold: Callable[..., Tuple[float, str, bool]]
    backward: str = ""
    label: str = ""


#: the model path's kernels: the forwards a prefill launches and the
#: backwards that ``FlashAttention`` and ``SsdChunk`` call
PATH_KERNELS = {
    "ssd_chunk": PathKernel(ssm_mod, ssd_chunk_plain, ("ssd_chunk_tc",),
                            _ssd_hold, "ssd_chunk_bwd", "ssd"),
    "flash_attention": PathKernel(layers_mod, flash_attention_plain,
                                  ("attn_kernel",), _flash_hold,
                                  "flash_attention_bwd", "flash"),
    "flash_attention_bwd": PathKernel(
        BWD_MODULE, flash_attention_bwd_plain,
        ("dsum_kernel", "split3_kernel", "dkdv_kernel", "dq_kernel"),
        _bwd_hold(bwd_err, flash_attention_bwd_scale,
                  lambda dt: BWD_ATOL[dt])),
    "ssd_chunk_bwd": PathKernel(
        SSD_BWD_MODULE, ssd_chunk_bwd_plain,
        SSD_BWD_LAUNCHES,
        _bwd_hold(ssd_bwd_err, ssd_chunk_bwd_scale,
                  lambda dt: SSD_BWD_ATOL)),
}
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


def train_launches(cfg) -> Dict[str, int]:
    """Per kernel, its launches in one train step of ``cfg`` on the card:
    each forward kernel of ``prefill_launches`` once a layer, twice under
    ``cfg.remat`` (the forward and its recomputation), and its backward
    kernel once."""
    out = {}
    for name, n in prefill_launches(cfg).items():
        out[name] = (2 if cfg.remat else 1) * n
        out[PATH_KERNELS[name].backward] = n
    return out


@contextlib.contextmanager
def wrapped_kernels(names, wrap: Callable[[str, Callable], Callable]):
    """Each model kernel of ``names`` replaced, where the model path
    calls it (``PathKernel.module``), by ``wrap(name, kernel)`` for the
    duration."""
    saved = {n: getattr(PATH_KERNELS[n].module, n) for n in names}
    for n, kernel in saved.items():
        setattr(PATH_KERNELS[n].module, n, wrap(n, kernel))
    try:
        yield
    finally:
        for n, kernel in saved.items():
            setattr(PATH_KERNELS[n].module, n, kernel)


def plain_kernel(cfg):
    """``cfg``'s prefill kernels replaced by their plain versions for the
    duration (the run the kernels' prefill is held to)."""
    return wrapped_kernels(prefill_launches(cfg),
                           lambda n, kernel: PATH_KERNELS[n].plain)


def tally_calls(cfg, tally: Dict[tuple, int]):
    """``cfg``'s forward and backward kernels (``train_launches``)
    counted in ``tally`` for the duration by (kernel, dtype of its first
    tensor, tensor shapes, other arguments)."""
    def counting(name, kernel):
        def call(*args, **kw):
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            key = (name, str(tensors[0].dtype).replace("torch.", ""),
                   [tuple(t.shape) for t in tensors],
                   [a for a in args if not isinstance(a, torch.Tensor)]
                   + sorted(kw.items()))
            key = tuple(map(str, key))
            tally[key] = tally.get(key, 0) + 1
            return kernel(*args, **kw)
        return call
    return wrapped_kernels(train_launches(cfg), counting)


@contextlib.contextmanager
def record_routes(routes: List[Tuple[torch.Tensor, ...]]):
    """Every ``moe.route`` call's (eid, slot, keep, gate), detached,
    appended to ``routes`` for the duration (under remat, a layer's
    forward and its recomputation in the backward each add one)."""
    route = moe_mod.route

    def recording(logits, top_k, capacity):
        out = route(logits, top_k, capacity)
        routes.append(tuple(t.detach() for t in out))
        return out
    moe_mod.route = recording
    try:
        yield
    finally:
        moe_mod.route = route


@contextlib.contextmanager
def replay_routes(routes: List[Tuple[torch.Tensor, ...]],
                  grad: bool = False):
    """``moe.route`` answering with ``routes`` in order for the duration
    (the plain run taking the kernel run's routing decisions); every
    route must be used, and none asked for past the last.  With
    ``grad`` (a run under autograd) only the decisions (eid, slot, keep)
    are replayed and the gates taken anew from the run's own logits
    (``moe.gates``), so the router gets its gradient."""
    route, it = moe_mod.route, iter(routes)

    def replaying(logits, top_k, capacity):
        out = next(it, None)
        if out is None:
            raise AssertionError(f"replay_routes: more than {len(routes)} "
                                 f"routes asked for")
        if grad:
            return out[:3] + (moe_mod.gates(logits, out[0], top_k),)
        return out
    moe_mod.route = replaying
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
    Y per head (``ssd_chunk.flops``)."""
    return SSD_MODULE.flops(shape)


def ssd_bound(shape, dtype, cuda_cores: bool = False
              ) -> Tuple[float, str, str]:
    """The least time (ms) of one ``ssd_chunk`` call on an H100, what
    sets it and the route: x, a, b and c read once and y (fp32) written
    once, against ``ssd_flops`` on the route of the input dtype
    (``route_ms``)."""
    t_bytes = SSD_MODULE.nbytes(shape, dtype) / HBM_BYTES_PER_S * 1e3
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


def record_calls(cfg, calls: Dict[tuple, tuple], backward: bool = False):
    """``cfg``'s model kernels (``prefill_launches``; with ``backward``
    also their backward kernels, ``train_launches``) run as before for
    the duration, and the first call of each signature (kernel, shapes,
    strides, dtypes, other arguments) is kept in ``calls`` as (name,
    kernel, copies of its arguments, keywords), to be held to the plain
    version by ``hold_calls`` afterwards."""
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
    return wrapped_kernels(train_launches(cfg) if backward
                           else prefill_launches(cfg), recording)


def hold_calls(calls: Dict[tuple, tuple], label: str) -> Dict[str, float]:
    """Each call ``record_calls`` kept, again on its kernel and on the
    plain version, held by its ``PathKernel.hold``.  Returns each
    kernel's largest max abs error."""
    errs: Dict[str, float] = {}
    with torch.no_grad():
        for name, kernel, args, kw in calls.values():
            got = kernel(*args, **kw)
            want = PATH_KERNELS[name].plain(*args, **kw)
            err, against, held = PATH_KERNELS[name].hold(args, kw, got, want)
            shapes = [tuple(a.shape) for a in args
                      if isinstance(a, torch.Tensor)]
            if not held:
                raise AssertionError(f"{label}: {name} != plain at {shapes}"
                                     f" {args[0].dtype} {kw}: max abs err "
                                     f"{err} ({against})")
            log(f"{label}: {name} at {shapes} {args[0].dtype} {kw} held to "
                f"its plain version: max abs err {err:.3g} ({against})")
            errs[name] = max(errs.get(name, 0.0), err)
            del got, want
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
    keeps (``flash_attention.flops``)."""
    return FA_MODULE.flops(shape, causal)


def flash_bound(shape, dtype, causal: bool = True,
                cuda_cores: bool = False) -> Tuple[float, str, str]:
    """The least time (ms) of one ``flash_attention`` call on an H100,
    what sets it and the route: q, k, v read once and o written once,
    against ``flash_flops`` on the route of the input dtype
    (``route_ms``)."""
    t_bytes = FA_MODULE.nbytes(shape, dtype) / HBM_BYTES_PER_S * 1e3
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
    nbytes = BSMM_MODULE.nbytes(n_tiles, bm, bk, K, N, m, a_dtype, b_dtype)
    flops = BSMM_MODULE.flops(n_tiles, bm, bk, N)
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


def hybrid_train_config():
    """``hybrid_config`` as ``HYBRID_TRAIN_REDUCTION`` cuts it for a
    train step on one card."""
    cfg = hybrid_config()
    return dataclasses.replace(
        cfg, name=cfg.name + "-ff2k", d_ff=HYBRID_TRAIN_FF,
        moe=dataclasses.replace(cfg.moe, d_expert=HYBRID_TRAIN_FF))


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
                   dispatch_shape=MOE_DISPATCH_SHAPE,
                   measured: Optional[Dict[str, float]] = None
                   ) -> Tuple[Dict[str, Dict[str, int]], Dict[str, Dict]]:
    """Phases 20-29 (``family_plan``), one model at a time, the cache
    emptied after each phase: prefill, consistency and serve, and for
    the MoE model one layer's dispatch against the CPU.  Returns each
    path's kernel launches (the bf16 prefill, ``<path>_prefill``; the
    fp32 consistency prefill, ``<path>_consistency``; Whisper's fp32
    decode steps, ``<path>_consistency_decode``) and each consistency
    path's ``phase_consistency`` result.  ``measured`` gets each bf16
    prefill's seconds with the kernels, as ``<path>_prefill``."""
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
                if measured is not None:
                    measured[f"{path}_prefill"] = out["kernel_s"]
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


# ---------------------------------------------------------------------- #
# 30-33: the training path
# ---------------------------------------------------------------------- #
#: ((b, h, hkv, sq, sk, d), causal) of phase flash_grad: OLMo-1B's train
#: shape, Qwen2-7B's GQA prefill shape, Whisper's cross-attention (a
#: ragged last key tile at 1,500 frames); then the train steps' other
#: shapes: Whisper's encoder (1,500 frames, non-causal, ragged) and
#: decoder self-attention (448 tokens, causal, ragged) at its train
#: batch, and the reduced Jamba's GQA attention at its
FLASH_GRAD_CASES = (((8, 16, 16, 2048, 2048, 128), True),
                    ((4, 28, 4, 2048, 2048, 128), True),
                    ((4, 12, 12, 448, 1500, 64), False),
                    ((8, 12, 12, 1500, 1500, 64), False),
                    ((8, 12, 12, 448, 448, 64), True),
                    ((4, 32, 8, 2048, 2048, 128), True))
#: the training path: OLMo-1B at its published widths, batch x tokens
TRAIN_ARCH = "olmo-1b"
TRAIN_BATCH, TRAIN_SEQ = 8, 2048
TRAIN_WARMUP, TRAIN_STEPS = 2, 5
#: phases train_consistency and trainer: OLMo-1B at full width, its depth
#: cut to this many layers
TRAIN_CUT_LAYERS = 2
#: phase train_consistency: batch x tokens of its one fp32 step
TRAIN_CONSISTENCY_SHAPE = (2, 1024)
#: fp32 train step, kernels vs plain attention: the loss to rel 1e-5 and
#: each parameter's gradient to 1e-4 of its own max |grad| (fp32
#: reassociation and 3xTF32 products in the attention; the CPU tests
#: hold the plain step to the reference at these limits)
TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL = 1e-5, 1e-4
#: phase trainer: steps and checkpoint interval of the launcher's run
TRAINER_STEPS, TRAINER_EVERY = 6, 3
#: a case of phase ssd_grad off the kernel's 64-row tiles, N and P off 16
#: (the card tests' ragged forward case)
SSD_RAGGED = (2, 1, 100, 3, 24, 40)
#: the MoE, encoder-decoder and hybrid train steps: Qwen2-MoE-A2.7B at
#: full width, its depth cut to this many layers (2.90B parameters, 0.97B
#: active: about 46 GB of AdamW state); batch x tokens of its step (8 x
#: 2,048's fp32 logits over 151,936 words would add about 10 GB)
MOE_TRAIN_LAYERS, MOE_TRAIN_SHAPE = 4, (4, 2048)
#: Whisper-small in full: 8 x 448 decoder tokens over 8 x 1,500 frames
ENCDEC_TRAIN_SHAPE = (8, 448)
#: the hybrid (``hybrid_train_config``): its FFN widths and batch
HYBRID_TRAIN_FF, HYBRID_TRAIN_SHAPE = 2048, (4, 2048)
#: the fp32 steps held to the plain kernels: Whisper at full width with
#: this many encoder and decoder layers, over all 448 tokens
ENCDEC_CONSISTENCY_LAYERS, ENCDEC_TRAIN_CONSISTENCY_SHAPE = 2, (2, 448)


def ssd_grad_cases():
    """((B, nc, l, H, P, N), strong decay) of phase ssd_grad: Mamba2-1.3B's
    train shape (TRAIN_BATCH x TRAIN_SEQ), the reduced Jamba's prefill
    shape (128 heads), the reference's first test shape (N 16 and P 32,
    under the kernel's 64-wide tiles), the ragged case, and strong decay
    (a uniform in (-5, 0]) at the reference's production chunk shape."""
    return ((ssd_shape(TC.get(MODEL_ARCH), TRAIN_BATCH, TRAIN_SEQ), False),
            (ssd_shape(hybrid_config(), PREFILL_BATCH, PREFILL_SEQ), False),
            (SSD_SHAPES[0], False), (SSD_RAGGED, False),
            (SSD_SHAPES[2], True))


def ssd_bwd_flops(shape) -> Tuple[int, int]:
    """Operations of the backward's products over the causal halves:
    (those once per (b, c): G = C B^T, dC = dG B, dB = dG^T C; those per
    head: dW = dY X^T, dX = W^T dY) (``ssd_chunk_bwd.flops_by_product``)."""
    return SSD_BWD_MODULE.flops_by_product(shape)


def ssd_bwd_bound(shape, dtype) -> Tuple[float, str, str]:
    """The least time (ms) of one ``ssd_chunk_bwd`` call on an H100, what
    sets it and the route: x, a, b, c and dy (fp32) read once, dx, da, db
    and dc written once, against ``ssd_bwd_flops`` on the fastest
    fp32-accurate route of each product.  fp32: every product 3xTF32.
    bf16: G = C B^T one pass at the bf16 peak (exact in fp32); dW, dC and
    dB (one operand bf16, the other fp32: dY or dG) three passes at the
    bf16 peak, the fp32 operand split three ways into bf16 as
    ``csrc/ssd_chunk.cu`` splits S (330 TFLOP/s, faster than 2xTF32's
    247); dX 3xTF32 (W and dY both fp32)."""
    t_bytes = SSD_BWD_MODULE.nbytes(shape, dtype) / HBM_BYTES_PER_S * 1e3
    per_cell, per_head = ssd_bwd_flops(shape)
    if dtype == torch.bfloat16:
        g = per_cell // 3
        t_ops = ((g + 3 * (2 * g + per_head // 2)) / PEAK_FLOPS[dtype]
                 + 3 * (per_head // 2) / TF32_FLOPS) * 1e3
        route = "bf16 G, bf16x3 dW dC dB, 3xTF32 dX"
    else:
        t_ops = 3 * (per_cell + per_head) / TF32_FLOPS * 1e3
        route = "3xTF32 tensor cores"
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), route


def _ssd_grad_inputs(shape, dtype, device: torch.device, seed: int,
                     strong: bool):
    """x, a, b, c as ``_ssd_inputs`` makes them (a uniform in (-5, 0]
    under strong decay) and dy standard normal fp32."""
    x, a, b, c = _ssd_inputs(shape, dtype, device, seed)
    gen = torch.Generator(device).manual_seed(seed + 1)
    if strong:
        a = -5 * torch.rand(a.shape, generator=gen, device=device)
    dy = torch.randn(x.shape, generator=gen, device=device)
    return x, a, b, c, dy


def _last_rows(l: int) -> int:
    """The first row of the backward kernel's last 64-row tile."""
    return (l - 1) // 64 * 64


def _ssd_drop_head(kernel: Callable) -> Callable:
    """A fault of the backward: db and dc from every head but the last (one
    head left out of dG's sum); dx and da sound."""
    def faulty(x, a, b, c, dy):
        dx, da, db, dc = kernel(x, a, b, c, dy)
        h = x.shape[3] - 1
        _, _, db, dc = kernel(x[..., :h, :].contiguous(),
                              a[:, :h].contiguous(), b, c,
                              dy[..., :h, :].contiguous())
        return dx, da, db, dc
    return faulty


def _ssd_drop_colsum_tile(kernel: Callable) -> Callable:
    """A fault of the backward: the last row tile's rows left out of M's
    column sums, so dcum gains their column sums and da their reverse
    cumsum (computed in torch from the same inputs)."""
    def faulty(x, a, b, c, dy):
        dx, da, db, dc = kernel(x, a, b, c, dy)
        l = x.shape[2]
        r0 = _last_rows(l)
        cum = torch.cumsum(a.double(), dim=-1).float()
        keep = torch.arange(r0, l, device=x.device)[:, None] >= \
            torch.arange(l, device=x.device)[None, :]
        diff = cum[..., r0:, None] - cum[..., None, :]
        L = torch.where(keep, torch.exp(torch.where(keep, diff, 0.0)), 0.0)
        w = L * torch.einsum("bcin,bcjn->bcij", c[:, :, r0:].float(),
                             b.float())[:, None]
        dw = torch.einsum("bcihp,bcjhp->bhcij", dy[:, :, r0:], x.float())
        col = (dw * w).sum(-2)
        del L, w, dw
        return dx, da + col.double().flip(-1).cumsum(-1).flip(-1).float(), \
            db, dc
    return faulty


def _ssd_drop_dx_tile(kernel: Callable) -> Callable:
    """A fault of the backward: dx without the last row tile's rows of dY
    (dx from a call on dY with those rows zero); da, db, dc sound."""
    def faulty(x, a, b, c, dy):
        dx, da, db, dc = kernel(x, a, b, c, dy)
        cut = dy.clone()
        cut[:, :, _last_rows(x.shape[2]):] = 0.0
        return kernel(x, a, b, c, cut)[0], da, db, dc
    return faulty


#: planted faults of ``ssd_chunk_bwd`` that phase ssd_grad's hold must
#: catch at every case (tests/test_torch_ssd_grad.py plants the same in
#: the CPU emulation of the kernel's arithmetic)
SSD_BWD_FAULTS = {"drop_head": _ssd_drop_head,
                  "drop_colsum_tile": _ssd_drop_colsum_tile,
                  "drop_dx_tile": _ssd_drop_dx_tile}


def phase_ssd_grad(device, cases=None, reps: int = 10, seed: int = 12,
                   card: str = "") -> Dict:
    """``ssd_chunk_bwd`` against ``ssd_chunk_bwd_plain`` on the same inputs
    within SSD_BWD_ATOL by ``ssd_bwd_err`` (each gradient element's error,
    less one bf16 rounding of a bf16 gradient, over the summed magnitude
    of its terms), in bf16 and fp32, at each of ``ssd_grad_cases``; each
    timed beside ``ssd_bwd_bound`` and the plain version's time, with its
    TFLOP/s and the device ms of each of its launches in one call (CUDA
    events around each).  At every case each of ``SSD_BWD_FAULTS`` must
    fail that hold, and a second call on the same inputs must give the
    same bits.
    All readings are logged before the rules are enforced.  Returns the
    bf16 record of the first case (the result line's), the fp32 one under
    ``fp32`` and every case under ``cases``."""
    device = torch.device(device)
    recs, failed = [], []
    for i, (shape, strong) in enumerate(cases or ssd_grad_cases()):
        for dtype in (torch.bfloat16, torch.float32):
            args = _ssd_grad_inputs(shape, dtype, device, seed + i, strong)
            got = ssd_chunk_bwd(*args)
            same = all(torch.equal(g, w) for g, w in
                       zip(got, ssd_chunk_bwd(*args)))
            want = ssd_chunk_bwd_plain(*args)
            scale = ssd_chunk_bwd_scale(*args)
            err = ssd_bwd_err(got, want, scale)
            errs = [ssd_bwd_err([g], [w], [s])
                    for g, w, s in zip(got, want, scale)]
            abs_errs = [float((g.float() - w.float()).abs().max())
                        for g, w in zip(got, want)]
            del got
            planted = {name: ssd_bwd_err(fault(ssd_chunk_bwd)(*args), want,
                                         scale)
                       for name, fault in SSD_BWD_FAULTS.items()}
            del want, scale
            if not err <= SSD_BWD_ATOL:
                failed.append(f"{shape} {dtype} strong={strong}: {err}")
            if not same:
                failed.append(f"{shape} {dtype}: two calls differ")
            failed += [f"{name} passed at {shape} {dtype}: {e}"
                       for name, e in planted.items()
                       if not e > SSD_BWD_ATOL]
            bound, by, route = ssd_bwd_bound(shape, dtype)
            r = {"shape": list(shape), "strong_decay": strong,
                 "dtype": str(dtype).replace("torch.", ""),
                 "max_abs_err": max(abs_errs), "scaled_err": err,
                 "scaled_err_dx_da_db_dc": errs,
                 "max_abs_err_dx_da_db_dc": abs_errs, "planted_err": planted,
                 "bit_equal": same,
                 "ms": _time_ms(lambda: ssd_chunk_bwd(*args), device, reps),
                 "plain_ms": _time_ms(lambda: ssd_chunk_bwd_plain(*args),
                                      device, reps),
                 "bound_ms": bound, "bound_by": by, "bound_route": route,
                 "library_ms": None}
            # device ms of each launch in one call, from CUDA events around
            # each (none on the CPU)
            r["launch_ms"] = ssd_chunk_bwd_launch_ms(*args) \
                if device.type == "cuda" else {}
            tflops = sum(ssd_bwd_flops(shape)) / r["ms"] * 1e-9
            log(f"ssd_grad {shape} strong={strong} {dtype} on "
                f"{card or device}: bwd_err {err:.4g} (limit "
                f"{SSD_BWD_ATOL}; dx / da / db / dc "
                + " / ".join(f"{e:.3g}" for e in errs)
                + "; max abs err " + " / ".join(f"{e:.3g}" for e in abs_errs)
                + "); planted faults: "
                + ", ".join(f"{n} {e:.4g}" for n, e in planted.items())
                + f"; two calls bit-equal: {same}; {r['ms']:.4f} ms, "
                f"{tflops:.1f} TFLOP/s, {bound / r['ms']:.1%} of the bound "
                f"{bound:.4f} ms by {by} on {route} (plain "
                f"{r['plain_ms']:.4f}); device ms by launch "
                + (", ".join(f"{n} {v:.4f}"
                             for n, v in r["launch_ms"].items())
                   or "not measured"))
            recs.append(r)
            del args
            if device.type == "cuda":
                torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"ssd_grad: {failed}")
    for line in bwd_registers("ssd_chunk_bwd"):
        log(f"ssd_grad registers: {line}")
    return {"name": "ssd_chunk_bwd", "route": "cuda",
            "source": KERNEL_INFO["ssd_chunk_bwd"][0],
            "replaces": KERNEL_INFO["ssd_chunk_bwd"][1],
            "replaces_note": "the gradient of that kernel, which has no VJP",
            "launches": 0,
            **{k: recs[0][k] for k in TIMED_KEYS + ("library_ms",)},
            "fp32": {k: recs[1][k] for k in TIMED_KEYS + ("library_ms",)},
            "cases": recs}


def flash_bwd_flops(shape, causal: bool = True) -> int:
    """Operations of the backward's five products (S, dP, dV, dK, dQ;
    the forward has two) over the pairs the mask keeps
    (``flash_attention_bwd.flops``)."""
    return BWD_MODULE.flops(shape, causal)


def flash_bwd_bound(shape, dtype, causal: bool = True
                    ) -> Tuple[float, str, str]:
    """The least time (ms) of one ``flash_attention_bwd`` call on an
    H100: q, k, v, o, do and lse read once, dq, dk, dv written once,
    against ``flash_bwd_flops`` on the route of the dtype."""
    t_bytes = BWD_MODULE.nbytes(shape, dtype) / HBM_BYTES_PER_S * 1e3
    t_ops, route = route_ms(flash_bwd_flops(shape, causal), dtype)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), route


def _forward_lse(q, k, v, causal: bool):
    """The forward's output and row log-sum-exp: the kernel's on the
    card, the plain versions' on the CPU."""
    if q.device.type == "cuda":
        o, lse, _ = FA_MODULE._launch(q, k, v, causal, with_lse=True)
        return o, lse
    return (flash_attention_plain(q, k, v, causal),
            flash_attention_lse_plain(q, k, v, causal))


def _drop_last_keys(n) -> Callable:
    """A fault of the backward kernel: it stops ``n`` keys early (all of
    them where there are fewer; ``n`` an int or a function of the head
    dim), so the last keys' rows of dk and dv come back zero and their
    terms are missing from dq."""
    def fault(kernel: Callable) -> Callable:
        def faulty(q, k, v, o, lse, do, causal=True):
            m = min(n(q.shape[-1]) if callable(n) else n, k.shape[2])
            sk = k.shape[2] - m
            dq, dk, dv = kernel(q, k[:, :, :sk], v[:, :, :sk], o, lse, do,
                                causal)
            pad = (0, 0, 0, m)
            return (dq, torch.nn.functional.pad(dk, pad),
                    torch.nn.functional.pad(dv, pad))
        return faulty
    return fault


#: planted faults of ``flash_attention_bwd`` that phase flash_grad's hold
#: must catch at every case: the last key block of the bf16 route (128
#: keys), the last key tile of the fp32 route's dQ pass (``fp32_tile``: 32
#: keys at d 128, 64 below; its dK/dV items are 64 keys), and the last 8
#: keys (at a causal sq = sk, keys seen by one to eight queries: the
#: smallest gradients)
BWD_FAULTS = {"drop_last_128_keys": _drop_last_keys(128),
              "drop_key_tile": _drop_last_keys(BWD_MODULE.fp32_tile),
              "drop_last_8_keys": _drop_last_keys(8)}


def _sdpa_bwd_ms(q, k, v, do, causal: bool, device, reps: int) -> float:
    """SDPA's backward under autograd on the same inputs (its forward
    taken once, outside the timing): the yardstick, never a path."""
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(
        qs, ks, vs, is_causal=causal, enable_gqa=True)
    ms = _time_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), do,
                                              retain_graph=True),
                  device, reps)
    del out, qs, ks, vs
    return ms


def bwd_registers(lib: str = "flash_attention_bwd") -> List[str]:
    """nvcc's register and spill lines of a backward kernel's launches
    (``PATH_KERNELS[lib].entries``), each named by its entry (from this
    process's build): the pass, the route (the flash backward's bf16
    wgmma in namespace ``hopper``, its fp32 wgmma on three bf16 parts in
    ``bf16x3``; otherwise by its element type) and the head dim where
    templated."""
    out, entry = [], ""
    for ln in build.BUILD_LOGS.get(lib, "").splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1] if "'" in ln else ln
            for part in PATH_KERNELS[lib].entries:
                if part in entry:
                    route = ("bf16 wgmma" if "hopper" in entry else
                             "fp32 bf16x3 wgmma" if "bf16x3" in entry else
                             "bf16" if "bfloat16" in entry else
                             "fp32" if re.search(r"I(f|Lb0E)", entry)
                             else "")
                    dim = re.search(r"Li(\d+)E", entry)
                    tags = ([route] if route else []) + \
                        ([f"d {dim.group(1)}"] if dim else [])
                    entry = part + (f"<{', '.join(tags)}>" if tags else "")
        elif "registers" in ln or "spill" in ln:
            out.append(f"{entry}: {ln.strip()}")
    return out


def phase_flash_grad(device, cases=FLASH_GRAD_CASES, reps: int = 10,
                     seed: int = 11, card: str = "") -> Dict:
    """``flash_attention_bwd`` against ``flash_attention_bwd_plain`` on
    the same inputs (the forward kernel's o and lse) within BWD_ATOL by
    ``bwd_err`` (each gradient element's error over the summed magnitude
    of its terms), in bf16 and fp32, at each case; each timed beside its
    bound, the plain version's time and SDPA's backward.  At every case
    each of ``BWD_FAULTS`` must fail that hold, and a second call on the
    same inputs must give the same bits (no atomics: the trainer's resume
    is bit-equal).  All readings are logged before the rules are
    enforced.  Returns the bf16 record of the first case (the result
    line's), the fp32 one under ``fp32`` and every case under
    ``cases``."""
    device = torch.device(device)
    recs, failed = [], []
    for i, (shape, causal) in enumerate(cases):
        for dtype in (torch.bfloat16, torch.float32):
            b, h, hkv, sq, sk, d = shape
            gen = torch.Generator(device).manual_seed(seed + i)
            q, k, v, do = (torch.randn(s, generator=gen, device=device)
                           .to(dtype) for s in
                           ((b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, d),
                            (b, h, sq, d)))
            o, lse = _forward_lse(q, k, v, causal)
            args = (q, k, v, o, lse, do, causal)
            got = flash_attention_bwd(*args)
            same = all(torch.equal(a, b) for a, b in
                       zip(got, flash_attention_bwd(*args)))
            want = flash_attention_bwd_plain(*args)
            scale = flash_attention_bwd_scale(*args)
            err = bwd_err(got, want, scale)
            errs = [float((g.float() - w.float()).abs().max())
                    for g, w in zip(got, want)]
            del got
            planted = {}
            for name, fault in BWD_FAULTS.items():
                planted[name] = bwd_err(fault(flash_attention_bwd)(*args),
                                        want, scale)
            del want, scale
            limit = BWD_ATOL[dtype]
            if not err <= limit:
                failed.append(f"{shape} {dtype} causal={causal}: {err}")
            if not same:
                failed.append(f"{shape} {dtype}: two calls differ")
            failed += [f"{name} passed at {shape} {dtype}: {e}"
                       for name, e in planted.items() if not e > limit]
            bound, by, route = flash_bwd_bound(shape, dtype, causal)
            r = {"shape": list(shape), "causal": causal,
                 "dtype": str(dtype).replace("torch.", ""),
                 "max_abs_err": max(errs), "scaled_err": err,
                 "max_abs_err_dq_dk_dv": errs, "planted_err": planted,
                 "bit_equal": same,
                 "ms": _time_ms(lambda: flash_attention_bwd(*args), device,
                                reps),
                 "plain_ms": _time_ms(lambda: flash_attention_bwd_plain(
                     *args), device, reps),
                 "bound_ms": bound, "bound_by": by, "bound_route": route,
                 "library_ms": _sdpa_bwd_ms(q, k, v, do, causal, device,
                                            reps)}
            # device ms of each pass in one call, from CUDA events around
            # each launch (the dtype's route's passes: pass 1b runs in fp32
            # only; a profile of the call here listed none of its
            # kernels); none on the CPU
            r["pass_ms"] = BWD_MODULE.flash_attention_bwd_launch_ms(*args) \
                if device.type == "cuda" else {}
            tflops = flash_bwd_flops(shape, causal) / r["ms"] * 1e-9
            log(f"flash_grad {shape} {dtype} causal={causal} on "
                f"{card or device}: max abs err dq / dk / dv "
                f"{errs[0]:.3g} / {errs[1]:.3g} / {errs[2]:.3g}; bwd_err "
                f"{err:.4g} (limit {limit}); planted faults: "
                + ", ".join(f"{n} {e:.4g}" for n, e in planted.items())
                + f"; two calls bit-equal: {same}"
                + f"; {r['ms']:.4f} ms, {tflops:.1f} TFLOP/s, "
                f"{bound / r['ms']:.1%} of the bound {bound:.4f} ms by {by} "
                f"on {route} (plain {r['plain_ms']:.4f}, SDPA backward "
                f"{r['library_ms']:.4f}); device ms by pass "
                + (", ".join(f"{n} {v:.4f}" for n, v in r["pass_ms"].items())
                   or "not measured"))
            recs.append(r)
            del q, k, v, do, o, lse, args
            if device.type == "cuda":
                torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"flash_grad: {failed}")
    for line in bwd_registers():
        log(f"flash_grad registers: {line}")
    rec = {"name": "flash_attention_bwd", "route": "cuda",
           "source": KERNEL_INFO["flash_attention_bwd"][0],
           "replaces": KERNEL_INFO["flash_attention_bwd"][1],
           "replaces_note": "the gradient of that kernel, which has no VJP",
           "launches": 0,
           **{k: recs[0][k] for k in TIMED_KEYS + ("library_ms",)},
           "fp32": {k: recs[1][k] for k in TIMED_KEYS + ("library_ms",)},
           "cases": recs}
    return rec


def weight_tokens(cfg, batch: int, seq: int) -> float:
    """The sum over the model's weights of the active parameters times
    the positions each multiplies in a batch of ``batch`` x ``seq``
    tokens: ``active_param_count`` (a MoE's routed top-k and shared
    experts, the reference's N of 6 N D) times the tokens; for an
    encoder-decoder ``encdec_weights``, the first over the
    ``enc_frames`` frames and the second over the tokens."""
    if cfg.family != "encdec":
        return float(active_param_count(cfg)) * batch * seq
    enc, dec = encdec_weights(cfg)
    return float(enc) * batch * cfg.enc_frames + float(dec) * batch * seq


def mixer_calls(cfg, batch: int, seq: int) -> List[Tuple[str, Tuple, bool,
                                                         int]]:
    """The sequence mixers' calls of one forward over ``batch`` x
    ``seq`` tokens: (kernel, shape, causal, calls).  Whisper: the
    encoder's non-causal self-attention over its frames, the decoder's
    causal self-attention and its cross-attention into the frames."""
    if cfg.family == "encdec":
        b, h, hkv, d, f = batch, cfg.n_heads, cfg.n_kv_heads, cfg.hdim, \
            cfg.enc_frames
        return [("flash_attention", (b, h, hkv, f, f, d), False,
                 cfg.enc_layers),
                ("flash_attention", (b, h, hkv, seq, seq, d), True,
                 cfg.n_layers),
                ("flash_attention", (b, h, hkv, seq, f, d), False,
                 cfg.n_layers)]
    shapes = {"flash_attention": attn_shape(cfg, batch, seq),
              "ssd_chunk": ssd_shape(cfg, batch, seq)
              if cfg.ssm is not None else None}
    return [(name, shapes[name], True, n)
            for name, n in prefill_launches(cfg).items()]


def _model_flops(cfg, batch: int, seq: int) -> float:
    """Model operations of one train step: 6 x ``weight_tokens`` for the
    weights plus the sequence mixers' products that no weight holds
    (``mixer_calls``), forward once and backward twice: attention's QK^T
    and PV over the pairs its mask keeps (``flash_flops``), the SSD's
    stage 1, G = C B^T and (G o L) X over each chunk's causal half
    (``ssd_flops``); the SSD's other stages are left out, as are
    rematerialisation, the norms and the routers' dropped assignments."""
    mix = sum(n * (flash_flops(shape, causal) if name == "flash_attention"
                   else ssd_flops(shape))
              for name, shape, causal, n in mixer_calls(cfg, batch, seq))
    return 6.0 * weight_tokens(cfg, batch, seq) + 3 * mix


def train_data(cfg, batch: int, seq: int, seed: int
               ) -> ShardedSyntheticDataset:
    """The ported pipeline's stream for ``cfg`` as the trainer builds it:
    an encoder-decoder's batches carry its frames (``enc_frames`` x
    ``d_model``)."""
    return ShardedSyntheticDataset(DataConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=seed,
        enc_frames=cfg.enc_frames if cfg.family == "encdec" else 0,
        d_model=cfg.d_model))


def train_batch(cfg, data: ShardedSyntheticDataset, step: int,
                device) -> Dict[str, torch.Tensor]:
    """Step ``step``'s global batch of ``data`` on ``device`` as the
    port's train step and trainer take it (``model_batch``: the frames
    in the model's dtype)."""
    return model_batch(cfg, data.global_batch_at(step), device)


def moe_layers(cfg) -> int:
    """The layers with a routed FFN: each calls ``moe.route`` once a
    forward."""
    if cfg.moe is None:
        return 0
    return cfg.n_layers // cfg.moe_every if cfg.family == "hybrid" \
        else cfg.n_layers


def phase_train_step(device, cfg, batch: int = TRAIN_BATCH,
                     seq: int = TRAIN_SEQ, warmup: int = TRAIN_WARMUP,
                     steps: int = TRAIN_STEPS, seed: int = 0,
                     card: str = "") -> Dict:
    """``make_train_step`` on ``cfg`` (seeded weights in the config's
    dtype, AdamW by ``for_config`` with its fp32 master copy, ``remat``
    on) over batches of the ported pipeline (``train_batch``: Whisper's
    frames in the model's dtype): ``warmup`` steps, the first with each
    kernel call counted by signature (``tally_calls``: every call must
    be in the model's dtype) and the routes recorded (the dropped share
    of a MoE's assignments), then ``steps`` steps timed on the host
    clock, synced, on batches made before the clock starts (the
    pipeline's seconds a batch are logged apart), every model kernel's
    count set to 0 just before and read just after.  Loss and grad norm
    finite; on the card each forward kernel launched twice a layer a
    step (the forward and its recomputation) and its backward once
    (``train_launches``).  The model-FLOP share counts
    ``_model_flops``.  Returns the launches and the measurements."""
    device = torch.device(device)
    params = api.init(cfg, torch.Generator(device).manual_seed(seed), device)
    n_params = sum(p.numel() for p in params.parameters())
    optimizer = opt_mod.for_config(cfg)
    state = optimizer.init(dict(params.named_parameters()))
    data = train_data(cfg, batch, seq, seed)
    step = make_train_step(cfg, optimizer, device=device)
    metrics, tally, routes = [], {}, []
    for i in range(warmup):
        with tally_calls(cfg, tally) if i == 0 else contextlib.nullcontext(), \
                record_routes(routes) if i == 0 else contextlib.nullcontext():
            params, state, m = step(params, state,
                                    train_batch(cfg, data, i, device))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    # the timed steps' batches made first (the pipeline synthesises
    # Whisper's frames on the host: timed apart, not in the step)
    t0 = time.perf_counter()
    batches = [train_batch(cfg, data, i, device)
               for i in range(warmup, warmup + steps + 1)]
    _sync(device)
    data_s = (time.perf_counter() - t0) / len(batches)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for k in MODEL_KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    for i in range(steps):
        params, state, m = step(params, state, batches[i])
    _sync(device)
    dt = (time.perf_counter() - t0) / steps
    metrics.append((float(m["loss"]), float(m["grad_norm"])))
    want = train_launches(cfg)
    launches = {k.__name__: k.launches for k in MODEL_KERNELS
                if k.__name__ in want}
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" \
        else None
    profile = profile_step(lambda: step(params, state, batches[-1]),
                           device) if device.type == "cuda" else None
    del batches
    del params, state
    per_step = {n: c / steps for n, c in launches.items()}
    if device.type != "cuda":
        want = {n: 0 for n in want}
    dtypes = {key[1] for key in tally}
    tallied = {n: sum(c for key, c in tally.items() if key[0] == n)
               for n in train_launches(cfg)}
    n_routes = (2 if cfg.remat else 1) * moe_layers(cfg)
    if per_step != want or dtypes != {cfg.dtype} or \
            tallied != train_launches(cfg) or len(routes) != n_routes:
        raise AssertionError(
            f"train step launched {per_step} a step, want {want}; kernel "
            f"calls in {dtypes} for a {cfg.dtype} model, {tallied} a step "
            f"(want {train_launches(cfg)}); {len(routes)} routes, want "
            f"{n_routes}")
    if not all(np.isfinite(x) for pair in metrics for x in pair):
        raise AssertionError(f"train step: non-finite loss or grad norm "
                             f"{metrics}")
    tokens = batch * seq
    active = active_param_count(cfg)
    flops = _model_flops(cfg, batch, seq)
    mfu = flops / dt / PEAK_FLOPS[torch.bfloat16]
    drop = dropped_share(routes)
    frames = f" over {batch}x{cfg.enc_frames} frames ({cfg.dtype})" \
        if cfg.family == "encdec" else ""
    log(f"train_step {cfg.name} {cfg.dtype} {n_params / 1e9:.3f}B params "
        f"({active / 1e9:.3f}B active by active_param_count), batch "
        f"{batch}x{seq}{frames}, AdamW (fp32 master), remat {cfg.remat} on "
        f"{card or device}: {dt:.4f} s a step, {tokens / dt:.1f} tokens/s, "
        f"model FLOP share {mfu:.2%} of 989 TFLOP/s ({flops:.4g} a step); "
        f"peak memory {peak if peak is None else f'{peak / 2**30:.2f} GiB'}"
        f"; the pipeline's batch {data_s:.4f} s on the host, apart; loss / "
        f"grad norm by step {metrics}; launches a step {per_step}"
        + ("" if drop is None else f"; dropped share {drop:.4%} of "
           f"{sum(r[2].numel() for r in routes)} assignments over "
           f"{len(routes)} routes (forward and recomputation)"))
    calls = [" ".join(key) + f": {n}" for key, n in tally.items()]
    for line in calls:
        log(f"train_step {cfg.name} kernel calls in step 0: {line}")
    if profile is not None:
        log_profile(profile, dt, cfg.name, card or str(device),
                    mixers=tuple(prefill_launches(cfg)))
    return {"launches": launches, "s_per_step": dt, "tokens_per_s":
            tokens / dt, "mfu": mfu, "peak_bytes": peak,
            "n_params": n_params, "active_params": active,
            "metrics": metrics, "dropped_share": drop, "data_s": data_s,
            "calls": calls}


def profile_step(run: Callable[[], object], device) -> Dict:
    """One call of ``run`` (a train step, a backward call) under
    ``torch.profiler`` (CPU and CUDA activity), synced: the host seconds of the window, each
    device kernel's time summed by name, and the device's busy time (the
    union of the kernels' intervals; the profiler's own cost inflates the
    host seconds, not the kernels')."""
    _sync(device)
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    t0 = time.perf_counter()
    with prof:
        run()
        _sync(device)
    wall = time.perf_counter() - t0
    by_name: Dict[str, float] = {}
    spans = []
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = ev.time_range.elapsed_us()
        by_name[ev.name] = by_name.get(ev.name, 0.0) + us
        spans.append((ev.time_range.start, ev.time_range.end))
    spans.sort()
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return {"wall_s": wall, "busy_s": busy * 1e-6, "by_name": by_name,
            "first_last_s": (end - spans[0][0]) * 1e-6 if spans else 0.0}


def _device_ms(by_name: Dict[str, float], entries) -> float:
    """Device ms of the profiled kernels whose names hold one of
    ``entries`` as a word."""
    return sum(us for k, us in by_name.items()
               if any(re.search(rf"\b{e}", k) for e in entries)) / 1e3


def log_profile(prof: Dict, step_s: float, name: str, card: str,
                top: int = 15, mixers=("flash_attention",)) -> None:
    """The step's profile: device time summed by kernel name (the largest
    ``top``), each sequence mixer's backward kernel's share of the step
    and of device time and its forward kernel's share of device time
    (``mixers``: the forward kernels of the model), and the device's idle
    share: of the untraced step (``step_s``, the timed steps' mean), of
    the traced window, and between the traced step's first and last
    kernel."""
    by_name = prof["by_name"]
    total = sum(by_name.values())
    for kname, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        log(f"train_step profile {name} on {card}: {us / 1e3:.4f} ms "
            f"({us / total:.2%} of device time) {kname[:110]}")
    wall, busy = prof["wall_s"], prof["busy_s"]
    span = prof["first_last_s"]
    shares = []
    for mixer in mixers:
        k = PATH_KERNELS[mixer]
        bwd = _device_ms(by_name, PATH_KERNELS[k.backward].entries)
        fwd = _device_ms(by_name, k.entries)
        label = k.label
        shares.append(
            f"{label} backward {bwd:.4f} ms ({bwd * 1e-3 / step_s:.2%} of "
            f"the step, {bwd * 1e3 / total:.2%} of device time), {label} "
            f"forward {fwd:.4f} ms ({fwd * 1e3 / total:.2%} of device "
            f"time)")
    log(f"train_step profile {name} on {card}: one step traced, device "
        f"busy {busy:.4f} s; idle share {1 - busy / step_s:.2%} of the "
        f"untraced step ({step_s:.4f} s), {1 - busy / wall:.2%} of the "
        f"traced window ({wall:.4f} s on the host), "
        f"{1 - busy / span:.2%} between its first and last kernel "
        f"({span:.4f} s); {len(by_name)} kernel names; " + "; ".join(shares))


def _loss_and_grads(cfg, params, batch):
    params.requires_grad_(True)
    named = dict(params.named_parameters())
    loss = api.loss_fn(cfg, params, batch)
    grads = torch.autograd.grad(loss, list(named.values()))
    return loss.item(), dict(zip(named, grads))


def phase_train_consistency(device, cfg, shape=TRAIN_CONSISTENCY_SHAPE,
                            seed: int = 6, card: str = "") -> Dict:
    """In fp32, one train step's loss and every parameter's gradient
    (the train step's ``api.loss_fn`` under autograd, over the pipeline's
    batch: ``train_batch``) with the model's kernels (attention or SSD
    and their backwards), against the same with those kernels on their
    plain versions (``plain_kernel``; torch autograd through them): the
    loss within TRAIN_LOSS_RTOL, each gradient within TRAIN_GRAD_TOL of
    its max abs.  With MoE layers the plain run replays the kernel run's
    routes (``replay_routes`` with ``grad``: the decisions, the gates
    from its own logits), forward and recomputation in the same order,
    as many as recorded: two a MoE layer under remat.  The kernels'
    counts are set to 0 just before the kernel run and read just after
    (``train_launches`` on the card: 2 forward and 1 backward launches a
    layer); each forward and backward kernel call is held to its plain
    version (``hold_calls``) on copies of its own inputs."""
    device = torch.device(device)
    cfg = dataclasses.replace(cfg, dtype="float32")
    b, s = shape
    params = api.init(cfg, torch.Generator(device).manual_seed(seed), device)
    batch = train_batch(cfg, train_data(cfg, b, s, seed), 0, device)
    calls: Dict[tuple, tuple] = {}
    routes: List[Tuple[torch.Tensor, ...]] = []
    for k in MODEL_KERNELS:
        k.launches = 0
    with record_calls(cfg, calls, backward=True), record_routes(routes):
        loss, grads = _loss_and_grads(cfg, params, batch)
    _sync(device)
    want = train_launches(cfg)
    launches = {k.__name__: k.launches for k in MODEL_KERNELS
                if k.__name__ in want}
    with plain_kernel(cfg), replay_routes(routes, grad=True):
        plain_loss, plain = _loss_and_grads(cfg, params, batch)
    del params
    if device.type != "cuda":
        want = {n: 0 for n in want}
    n_routes = (2 if cfg.remat else 1) * moe_layers(cfg)
    if launches != want or len(routes) != n_routes:
        raise AssertionError(f"train_consistency launched {launches}, "
                             f"want {want}; {len(routes)} routes recorded "
                             f"and replayed, want {n_routes}")
    loss_rel = abs(loss - plain_loss) / abs(plain_loss)
    worst, worst_name = 0.0, ""
    for name, w in plain.items():
        rel = float((grads[name] - w).abs().max()) / max(
            float(w.abs().max()), 1e-30)
        if rel > worst:
            worst, worst_name = rel, name
    del grads, plain
    if not loss_rel <= TRAIN_LOSS_RTOL or not worst <= TRAIN_GRAD_TOL:
        raise AssertionError(f"train_consistency: loss rel {loss_rel:.3g} "
                             f"(limit {TRAIN_LOSS_RTOL}), worst gradient "
                             f"{worst_name} {worst:.3g} of its max (limit "
                             f"{TRAIN_GRAD_TOL})")
    layers = f"{cfg.enc_layers} encoder and {cfg.n_layers} decoder" \
        if cfg.family == "encdec" else str(cfg.n_layers)
    frames = f" over {b}x{cfg.enc_frames} frames" \
        if cfg.family == "encdec" else ""
    replayed = f"; {len(routes)} routes recorded and replayed (forward " \
        f"and recomputation), none left over, dropped share " \
        f"{dropped_share(routes):.4%}" if routes else ""
    log(f"train_consistency {cfg.name} fp32 {layers} layers, batch "
        f"{b}x{s}{frames} on {card or device}: loss {loss:.7g}, plain "
        f"kernels {plain_loss:.7g} (rel {loss_rel:.3g}); worst gradient "
        f"{worst_name} {worst:.3g} of its max abs; launches {launches}"
        f"{replayed}")
    held = hold_calls(calls, f"train_consistency {cfg.name}")
    return {"launches": launches, "loss_rel": loss_rel, "grad_rel": worst,
            "held": held, "routes": len(routes)}


def phase_trainer(device, arch: str = TRAIN_ARCH,
                  layers: int = TRAIN_CUT_LAYERS, steps: int = TRAINER_STEPS,
                  every: int = TRAINER_EVERY, smoke: bool = False,
                  card: str = "") -> Dict:
    """``launch/train.py``'s ``main`` on ``arch`` at full width cut to
    ``layers`` layers, ``steps`` steps with a checkpoint every
    ``every`` (``smoke``: the smoke config, for a CPU rehearsal), in a
    temporary directory removed afterwards, through its 1 x 1 mesh
    (``--dp 1 --tp 1``); then a fresh ``Trainer`` on ``make_mesh(1, 1)``
    over ``device`` restores the checkpoint at ``every`` and trains to
    ``steps``.  Both trainers' meshes 1 x 1 over that one device, every
    parameter and optimizer-state tensor whole on it; the resumed last
    loss within rel 1e-4 of the uninterrupted one (the reference's
    property; whether it is the same bits is logged).  Checkpoint
    seconds are logged apart from step seconds.  Returns the launches of
    both runs and the losses."""
    device = torch.device(device)
    mesh = make_mesh(1, 1, device=device)
    work = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
    try:
        for k in MODEL_KERNELS:
            k.launches = 0
        args = ["--arch", arch, "--layers", str(layers), "--steps",
                str(steps), "--ckpt-every", str(every), "--log-every", "1",
                "--ckpt-dir", work, "--device", str(device), "--dp", "1",
                "--tp", "1"] + (["--smoke"] if smoke else [])
        t0 = time.perf_counter()
        first = train_main(args)
        first_s = time.perf_counter() - t0
        resumed = Trainer(first.cfg, dataclasses.replace(first.tcfg),
                          mesh=mesh)
        t0 = time.perf_counter()
        state = resumed.train(state=resumed.restore_or_init(step=every))
        _sync(device)
        resumed_s = time.perf_counter() - t0
        for tr in (first, resumed):
            if tr.mesh.shape != {"data": 1, "model": 1} or \
                    tr.mesh.devices != mesh.devices:
                raise AssertionError(f"trainer: mesh {tr.mesh.shape} over "
                                     f"{tr.mesh.devices}, want 1 x 1 over "
                                     f"{mesh.devices}")
        placed = assert_whole_on(mesh.devices[0], state.params,
                                 state.opt_state)
        launches = {k.__name__: k.launches for k in MODEL_KERNELS
                    if k.__name__ in train_launches(first.cfg)}
        want_loss = first.metrics_log[-1]["loss"]
        got = resumed.metrics_log[-1]
        if state.step != steps or got["step"] != steps or \
                resumed.metrics_log[0]["step"] != every + 1 or \
                not abs(got["loss"] - want_loss) <= 1e-4 * abs(want_loss):
            raise AssertionError(f"trainer: resumed to {state.step} with "
                                 f"loss {got['loss']} at step {got['step']},"
                                 f" uninterrupted {want_loss}")
        step_s = [r["s_per_step"] for r in first.metrics_log]
        log(f"trainer {first.cfg.name} {layers} layers, batch "
            f"{first.tcfg.global_batch}x{first.tcfg.seq_len} on "
            f"{card or device}: {steps} steps, checkpoint every {every}: "
            f"{first_s:.2f} s; s a step {[round(x, 4) for x in step_s]}; "
            f"checkpoint writes "
            f"{[round(x, 3) for x in first.ckpt.write_seconds]}"
            f" s (loop held {[round(x, 3) for x in first.save_seconds]} s); "
            f"resumed from step {every} in a fresh Trainer: {resumed_s:.2f} s"
            f", step-{steps} loss {got['loss']!r} against {want_loss!r} "
            f"uninterrupted: bit-equal {got['loss'] == want_loss}; mesh "
            f"{mesh.shape} over {mesh.devices[0]}, {placed} parameter and "
            f"state tensors whole on it; launches {launches}")
        return {"launches": launches, "loss": want_loss,
                "resumed_loss": got["loss"],
                "bit_equal": got["loss"] == want_loss,
                "write_s": list(first.ckpt.write_seconds),
                "step_s": step_s}
    finally:
        shutil.rmtree(work, ignore_errors=True)


def assert_whole_on(device: torch.device, params, opt_state) -> int:
    """Fails unless every parameter of ``params`` and every tensor of
    ``opt_state`` lies on ``device`` (a 1 x 1 mesh's one device), each
    per-parameter state tensor in its parameter's full shape (Adafactor's
    factored moments in theirs); returns how many tensors it checked."""
    shapes = {n: tuple(p.shape) for n, p in params.named_parameters()}
    found = [(n, p, shapes[n]) for n, p in params.named_parameters()]
    for key, sub in opt_state.items():
        if not isinstance(sub, dict):                     # the step count
            found.append((key, sub, tuple(sub.shape)))
            continue
        for n, t in sub.items():
            if isinstance(t, dict):                       # factored moments
                found += [(f"{key}.{n}.{k}", v, tuple(v.shape))
                          for k, v in t.items()]
            else:
                found.append((f"{key}.{n}", t, shapes[n]))
    for name, t, whole in found:
        if t.device != device or tuple(t.shape) != whole:
            raise AssertionError(f"trainer: {name} {tuple(t.shape)} on "
                                 f"{t.device}, want {whole} on {device}")
    return len(found)


def train_config(arch: str = TRAIN_ARCH, layers: Optional[int] = None):
    """``arch``'s published config, its depth cut to ``layers``."""
    cfg = TC.get(arch)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def family_train_plan():
    """Phases 37-42, one model each: (path, the train step's config and
    (batch, tokens), the fp32 step's config and (batch, tokens))."""
    enc, hyb = TC.get(ENCDEC_ARCH), hybrid_train_config()
    return (("moe", train_config(MOE_ARCH, MOE_TRAIN_LAYERS),
             MOE_TRAIN_SHAPE, train_config(MOE_ARCH, TRAIN_CUT_LAYERS),
             TRAIN_CONSISTENCY_SHAPE),
            ("encdec", enc, ENCDEC_TRAIN_SHAPE, dataclasses.replace(
                enc, n_layers=ENCDEC_CONSISTENCY_LAYERS,
                enc_layers=ENCDEC_CONSISTENCY_LAYERS),
             ENCDEC_TRAIN_CONSISTENCY_SHAPE),
            ("hybrid", hyb, HYBRID_TRAIN_SHAPE, hyb,
             TRAIN_CONSISTENCY_SHAPE))


def phase_family_training(device, card: str, plan=None, warmup: int =
                          TRAIN_WARMUP, steps: int = TRAIN_STEPS
                          ) -> Tuple[Dict[str, Dict], Dict[str, Dict],
                                     Dict[str, Dict]]:
    """Phases 37-42 (``family_train_plan``), one model at a time, the
    cache emptied after each phase: ``<path>_train_step`` and
    ``<path>_train_consistency``.  Returns the steps' measurements, each
    path's launches and the consistency results."""
    steps_out, paths, cons = {}, {}, {}
    for path, cfg, (b, s), cut, cut_shape in plan or family_train_plan():
        if path == "hybrid":
            log(f"training: {cfg.name} = {HYBRID_ARCH} with "
                f"{HYBRID_TRAIN_REDUCTION}")
        out = _timed(f"{path}_train_step", card, phase_train_step, device,
                     cfg, batch=b, seq=s, warmup=warmup, steps=steps,
                     card=card)
        steps_out[path] = out
        paths[f"{path}_train_step"] = out["launches"]
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        if cut is not cfg:
            log(f"training: {cut.name} = {cfg.name} with n_layers "
                f"{cfg.n_layers} -> {cut.n_layers}"
                + (f" and enc_layers {cfg.enc_layers} -> {cut.enc_layers}"
                   if cfg.family == "encdec" else "")
                + f" in phase {path}_train_consistency (widths, heads and "
                f"vocab unchanged)")
        c = _timed(f"{path}_train_consistency", card,
                   phase_train_consistency, device, cut, shape=cut_shape,
                   card=card)
        cons[f"{path}_train_consistency"] = c
        paths[f"{path}_train_consistency"] = c["launches"]
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return steps_out, paths, cons


def phase_training(device, card: str) -> Tuple[List[Dict], Dict[str, Dict],
                                               Dict[str, Dict]]:
    """Phases 30-42: flash_grad, train_step (OLMo-1B, full), then
    train_consistency and trainer at ``TRAIN_CUT_LAYERS`` layers; then
    ssd_grad, mamba2_train_step (Mamba2-1.3B, full) and
    mamba2_train_consistency at ``TRAIN_CUT_LAYERS`` layers; then the
    MoE, encoder-decoder and hybrid train paths
    (``phase_family_training``).  Returns the two backward kernels'
    records, each path's launches and the consistency results."""
    rec = _timed("flash_grad", card, phase_flash_grad, device, card=card)
    torch.cuda.empty_cache()
    full = train_config()
    step = _timed("train_step", card, phase_train_step, device, full,
                  card=card)
    torch.cuda.empty_cache()
    cut = train_config(layers=TRAIN_CUT_LAYERS)
    log(f"training: {cut.name} = {TRAIN_ARCH} with n_layers "
        f"{full.n_layers} -> {TRAIN_CUT_LAYERS} in phases "
        f"train_consistency and trainer (widths, heads and vocab unchanged)")
    cons = _timed("train_consistency", card, phase_train_consistency,
                  device, cut, card=card)
    torch.cuda.empty_cache()
    trainer = _timed("trainer", card, phase_trainer, device, card=card)
    torch.cuda.empty_cache()
    keys = ("s_per_step", "tokens_per_s", "mfu", "peak_bytes", "n_params",
            "active_params")
    rec["train_step"] = {k: step[k] for k in keys}
    rec["trainer"] = {k: trainer[k] for k in ("loss", "resumed_loss",
                                              "bit_equal", "write_s")}
    ssd_rec = _timed("ssd_grad", card, phase_ssd_grad, device, card=card)
    torch.cuda.empty_cache()
    m_full = train_config(MODEL_ARCH)
    m_step = _timed("mamba2_train_step", card, phase_train_step, device,
                    m_full, card=card)
    torch.cuda.empty_cache()
    m_cut = train_config(MODEL_ARCH, TRAIN_CUT_LAYERS)
    log(f"training: {m_cut.name} = {MODEL_ARCH} with n_layers "
        f"{m_full.n_layers} -> {TRAIN_CUT_LAYERS} in phase "
        f"mamba2_train_consistency (widths, heads, state and vocab "
        f"unchanged)")
    m_cons = _timed("mamba2_train_consistency", card,
                    phase_train_consistency, device, m_cut, card=card)
    torch.cuda.empty_cache()
    ssd_rec["train_step"] = {k: m_step[k] for k in keys}
    f_steps, f_paths, f_cons = phase_family_training(device, card)
    for path, out in f_steps.items():
        # the MoE's attention is the flash kernel's alone; the hybrid's
        # step runs both backward kernels
        for r, name in ((rec, "flash_attention"), (ssd_rec, "ssd_chunk")):
            if name in out["launches"]:
                r[f"{path}_train_step"] = {k: out[k] for k in keys}
    # launches are summed over the paths by ``attach_model_paths``
    rec["launches_by_path"] = {}
    ssd_rec["launches_by_path"] = {}
    paths = {"train_step": step["launches"],
             "train_consistency": cons["launches"],
             "trainer": trainer["launches"],
             "mamba2_train_step": m_step["launches"],
             "mamba2_train_consistency": m_cons["launches"], **f_paths}
    return [rec, ssd_rec], paths, {"train_consistency": cons,
                                   "mamba2_train_consistency": m_cons,
                                   **f_cons}


# ---------------------------------------------------------------------- #
# 43: the roofline of the timed steps (host only)
# ---------------------------------------------------------------------- #
def roofline_plan():
    """The steps this script times, as the dry run walks them: (the
    phase that times it, config, shape).  The train steps of phases
    train_step, mamba2_train_step and 37-42; the bf16 prefills of the
    main, dense and family paths."""
    out = [("train_step", train_config(),
            ShapeSpec("train_step", TRAIN_SEQ, TRAIN_BATCH, "train")),
           ("mamba2_train_step", train_config(MODEL_ARCH),
            ShapeSpec("mamba2_train_step", TRAIN_SEQ, TRAIN_BATCH,
                      "train"))]
    out += [(f"{path}_train_step", cfg, ShapeSpec(f"{path}_train_step", s,
                                                  b, "train"))
            for path, cfg, (b, s), _, _ in family_train_plan()]
    out += [("prefill", TC.get(MODEL_ARCH),
             ShapeSpec("prefill", PREFILL_SEQ, PREFILL_BATCH, "prefill")),
            ("dense_prefill", TC.get(DENSE_ARCH),
             ShapeSpec("dense_prefill", PREFILL_SEQ, PREFILL_BATCH,
                       "prefill"))]
    out += [(f"{path}_prefill", cfg, ShapeSpec(f"{path}_prefill", seq,
                                               PREFILL_BATCH, "prefill"))
            for path, cfg, seq, _, _ in family_plan()]
    return out


def phase_roofline(measured: Dict[str, float], card: str, plan=None,
                   peaks=None) -> Dict[str, Dict]:
    """Each step of ``plan`` (``roofline_plan``) dry-run on ``meta`` under
    ``h100_1x1`` (``launch/dryrun.step_costs``: aten's products and bytes,
    the kernels' own counts, from the 1- and 2-unit probes; nothing runs
    on the card), its terms on
    ``peaks`` (``peaks_for(card)``) beside the seconds its phase measured
    (``measured``): the compute and memory terms, the dominant one,
    each term over the measured seconds, and the counted operations over
    ``_model_flops`` (a prefill's: a third of it, 2 N D and the mixers
    once).  Fails if a step measured faster than its compute term (no
    count can be beaten) or a walk fails; the memory term's share is
    reported, not held (an eager op may find its operands in L2)."""
    peaks = peaks or peaks_for(card)
    mesh = make_mesh(1, 1, device="meta")
    out, fast = {}, []
    for name, cfg, shape in plan or roofline_plan():
        t0 = time.perf_counter()
        cost = dryrun.step_costs(cfg, shape, mesh)
        walk_s = time.perf_counter() - t0
        terms = roofline(cost["flops"], cost["hbm_bytes"],
                         cost["collective_wire_bytes"], 1,
                         peak_flops=peaks.bf16_flops,
                         hbm_gbs=peaks.hbm_bytes_per_s,
                         link_gbs=peaks.link_bytes_per_s)
        model = _model_flops(cfg, shape.global_batch, shape.seq_len)
        if shape.kind != "train":
            model /= 3
        sec = measured[name]
        rec = {**cost, "compute_s": terms.compute_s,
               "memory_s": terms.memory_s,
               "dominant": terms.dominant, "measured_s": sec,
               "compute_share": terms.compute_s / sec,
               "memory_share": terms.memory_s / sec,
               "counted_over_model": cost["flops"] / model,
               "walk_s": walk_s}
        out[name] = rec
        if sec < terms.compute_s:
            fast.append(name)
        log(f"roofline {name} {cfg.name} {shape.global_batch}x"
            f"{shape.seq_len} {shape.kind} on {card}: counted "
            f"{cost['flops']:.6g} operations "
            f"({rec['counted_over_model']:.4f} of the model's {model:.6g}; "
            f"kernels {cost['kernel_flops']}), {cost['hbm_bytes']:.6g} "
            f"bytes; compute term {terms.compute_s:.6g}"
            f" s, memory term {terms.memory_s:.6g} s: {terms.dominant}-"
            f"bound; measured {sec:.6g} s: compute {rec['compute_share']:.4f}"
            f" and memory {rec['memory_share']:.4f} of it; walk "
            f"{walk_s:.2f} s")
    if fast:
        raise AssertionError(f"roofline: {fast} measured faster than their "
                             f"compute terms")
    return out


# ---------------------------------------------------------------------- #
# 44: the pod and multipod dry runs (host only)
# ---------------------------------------------------------------------- #
#: (arch, shape) walked on both of the reference's production meshes
POD_CELLS = (("olmo-1b", "train_4k"), ("qwen2-moe-a2.7b", "train_4k"))


def phase_pod_dryrun(card: str, cells=POD_CELLS, peaks=None
                     ) -> Dict[str, Dict]:
    """Each cell of ``cells`` walked on ``dryrun.BOTH`` (``run_cell``,
    from its 1- and 2-unit probes; nothing runs on the card): one
    device's compute, memory and collective terms on ``peaks``
    (``peaks_for(card)``; the link is ``link_bytes_per_s`` of the
    mesh's chips), its collectives by op, its argument bytes against
    the card's memory and the walk's seconds.  Fails if a walk errs or
    leaves a ``torch.distributed`` process group behind."""
    import torch.distributed as dist
    peaks = peaks or peaks_for(card)
    out = {}
    walks = [(arch, shape, mesh) for arch, shape in cells
             for mesh in dryrun.BOTH]
    # one process a walk, up to one a core (``run_cells`` raises if one
    # leaves a process group behind)
    for (arch, shape, mesh), rec in zip(walks, dryrun.run_cells(
            walks, card, save=False, verbose=False)):
        if rec["status"] != "ok":
            raise AssertionError(f"pod_dryrun {arch} x {shape} x {mesh}: "
                                 f"{rec.get('error')}")
        if dist.is_initialized():
            raise AssertionError("pod_dryrun: a process group was left")
        link = link_bytes_per_s(peaks, rec["chips"])
        terms = roofline(rec["flops_corrected"],
                         rec["hbm_bytes_corrected"],
                         rec["collective_wire_bytes_corrected"], 1,
                         peak_flops=peaks.bf16_flops,
                         hbm_gbs=peaks.hbm_bytes_per_s, link_gbs=link)
        out[f"{arch}/{shape}/{mesh}"] = {
            "compute_s": terms.compute_s, "memory_s": terms.memory_s,
            "collective_s": terms.collective_s,
            "dominant": terms.dominant, "walk_s": rec["walk_s"],
            "collective_ops": rec["collective_ops_corrected"],
            "collective_bytes_by_op":
                rec["collective_bytes_by_op_corrected"]}
        log(f"pod_dryrun {arch} x {shape} x {mesh} ({rec['chips']} "
            f"devices) on {card}, per device: {rec['flops_corrected']:.6g}"
            f" operations, {rec['hbm_bytes_corrected']:.6g} bytes, "
            f"{rec['collective_wire_bytes_corrected']:.6g} wire bytes; "
            f"compute term {terms.compute_s:.6g} s, memory term "
            f"{terms.memory_s:.6g} s, collective term "
            f"{terms.collective_s:.6g} s at {link:.6g} B/s: "
            f"{terms.dominant}-bound; collectives "
            f"{rec['collective_ops_corrected']} wire bytes by op "
            f"{rec['collective_bytes_by_op_corrected']}; arguments "
            f"{rec['argument_bytes']:.6g} bytes a device, fits "
            f"{rec['fits']}; walk {rec['walk_s']:.2f} s")
    return out


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
    log(f"cut: phase dse's engine checks at {DSE_ENGINE_SIZE[0]}^2, "
        f"{DSE_ENGINE_SIZE[1]} nonzeros (was 2048^2, 20000): room for "
        f"phases 37-42")
    log(f"cut: phase dse's vector points {DSE_VECTOR_CAPS} MB (was 0.002 "
        f"and 6.0): room for phase 44 on a slow host")
    kernels = _timed("kernels", smi, phase_kernels, "cuda")
    _timed("oracle", smi, phase_oracle, "cuda")
    main_run = _timed("main", smi, phase_main, "cuda", card=smi)
    for rec in kernels:
        rec["launches"] = main_run["launches"][rec["name"]]
        rec.pop("shapes")
    replays = phase_replays("cuda", main_run)
    for rec in kernels:
        rec["replay"] = replays[rec["name"]]
    graph = _timed("graph", smi, phase_graph, "cuda", card=smi)
    replays = phase_replays("cuda", graph, path="graph")
    for rec in kernels:
        n = graph["launches"][rec["name"]]
        rec["launches_by_path"] = {"main": rec["launches"], "graph": n}
        rec["launches"] += n
        rec["graph"] = {"replay": replays[rec["name"]],
                        "sizes": graph["sizes"].get(rec["name"])}
    dse = _timed("dse", smi, phase_dse, "cuda", card=smi)
    for rec in kernels:
        n = dse["launches"][rec["name"]]
        rec["launches_by_path"]["dse"] = n
        rec["launches"] += n
    throughput = _timed("throughput", smi, phase_throughput, "cuda",
                        card=smi)["launches"]
    log("segmented_reduce ran in host numpy (no device kernel yet)")
    cfg = TC.get(MODEL_ARCH)
    ssd_rec = _timed("ssd_kernel", smi, phase_ssd_kernel, "cuda", card=smi)
    prefill = _timed("prefill", smi, phase_prefill, "cuda", cfg,
                     PREFILL_BATCH, PREFILL_SEQ, card=smi)
    measured = {"prefill": prefill["kernel_s"]}
    ssd_rec["launches"] = prefill["launches"]["ssd_chunk"]
    kernels.append(ssd_rec)
    cons = {"consistency": _timed("consistency", smi, phase_consistency,
                                  "cuda", cfg, card=smi)}
    _timed("serve", smi, phase_serve, "cuda", cfg, card=smi)
    flash_rec = _timed("flash_kernel", smi, phase_flash_kernel, "cuda",
                       card=smi)
    bsmm_rec = _timed("bsmm_kernel", smi, phase_bsmm_kernel, "cuda",
                      card=smi)
    torch.cuda.empty_cache()
    bsmm_rec["launches"] = _timed("kernels_bench", smi, phase_kernels_bench,
                                  "cuda")["block_sparse_matmul"]
    dense = TC.get(DENSE_ARCH)
    prefill = _timed("dense_prefill", smi, phase_prefill, "cuda", dense,
                     PREFILL_BATCH, PREFILL_SEQ, card=smi)
    flash_rec["launches"] = prefill["launches"]["flash_attention"]
    measured["dense_prefill"] = prefill["kernel_s"]
    kernels += [flash_rec, bsmm_rec]
    torch.cuda.empty_cache()
    cons["dense_consistency"] = _timed(
        "dense_consistency", smi, phase_consistency, "cuda", dense,
        seq=DENSE_CONSISTENCY_SEQ, card=smi)
    torch.cuda.empty_cache()
    _timed("dense_serve", smi, phase_serve, "cuda", dense, card=smi)
    torch.cuda.empty_cache()
    flash_rec["whisper"], jamba_ssd = _timed(
        "family_kernels", smi, phase_family_kernels, "cuda", card=smi)
    ssd_rec["jamba_prefill_shape"] = {
        k: jamba_ssd[k] for k in TIMED_KEYS + ("fp32",)}
    torch.cuda.empty_cache()
    log(f"hybrid: {hybrid_config().name} = {HYBRID_ARCH} with "
        f"{HYBRID_REDUCTION}")
    paths, family_cons = phase_families("cuda", smi, measured=measured)
    cons.update(family_cons)
    paths.update({p: cons[p]["launches"]
                  for p in ("consistency", "dense_consistency")})
    bwd_recs, train_paths, train_cons = phase_training("cuda", smi)
    flash_bwd_rec, ssd_bwd_rec = bwd_recs
    measured["train_step"] = flash_bwd_rec["train_step"]["s_per_step"]
    measured["mamba2_train_step"] = ssd_bwd_rec["train_step"]["s_per_step"]
    for path, _, _, _, _ in family_train_plan():
        measured[f"{path}_train_step"] = \
            flash_bwd_rec[f"{path}_train_step"]["s_per_step"]
    _timed("roofline", smi, phase_roofline, measured, name)
    _timed("pod_dryrun", smi, phase_pod_dryrun, name)
    kernels += bwd_recs
    paths.update(train_paths)
    cons.update(train_cons)
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
