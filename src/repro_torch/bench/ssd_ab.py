"""Time two builds of one kernel source on one card, in turns.

    python -m repro_torch.bench.ssd_ab --base DIR [--kernel NAME] [--reps 20]

``DIR`` is another checkout of this repository (the parent commit, for
example, unpacked with ``git archive`` under the ignored ``build/``).
``NAME`` is ``ssd_chunk`` (the default), ``flash_attention``,
``block_sparse_matmul``, ``search``, ``merge_path``,
``multi_merge_ranks``, ``flash_attention_bwd`` or ``ssd_chunk_bwd``.
The kernel's source under ``src/repro_torch/kernels/csrc/`` in ``DIR``
and in this tree are compiled with the flags of ``kernels/build.py`` and
launched through the same C interface, each build in a process of its
own that imports the package of its own checkout, in the order base,
this, this, base, so both come from one card.  The cases:

  * ``ssd_chunk``: the Mamba2-1.3B prefill shape (B 4, nc 8, l 256, H 64,
    P 64, N 128) in bf16 and fp32, and the reduced Jamba's (H 128) in
    fp32, held to ``ssd_chunk_plain`` within 2e-4 (1 + |want|);
  * ``flash_attention``: fp32 at Whisper-small's encoder (4, 12, 12,
    1500, 1500, 64, non-causal) and decode cross-attention (sq 1 over
    1,500 frames), and at the Qwen2-7B prefill (4, 28, 4, 2048, 2048,
    128, causal), then bf16 at Whisper's encoder, held to
    ``flash_attention_plain`` within 2e-5 (fp32) or 2e-2 (bf16);
  * ``block_sparse_matmul``: ``chip_smoke.py``'s card case (A 8192 x 8192
    in 128 x 128 tiles at 30% tile density, B 8192 x 1024) in fp32 and
    bf16, held to ``block_sparse_matmul_plain`` within 1e-4 sqrt(K)
    max |Z|;
  * ``search``: the table case (43M probes, half of them keys, into 21.5M
    sorted int64 keys), sorted and shuffled, equal to ``search_plain``;
  * ``merge_path``: the table case of ``chip_smoke.phase_kernels``
    (100,000 + 125,000 keys) and one launch of the simulator's main path
    (6,250 + 6,250), equal to ``merge_path_plain``;
  * ``multi_merge_ranks``: the table case (3 rows, 345,000 keys) and one
    main-path launch (3 x 6,250), equal to ``multi_merge_ranks_plain``;
  * ``flash_attention_bwd``: ``chip_smoke.FLASH_GRAD_CASES`` (OLMo-1B's
    train shape, Qwen2-7B's GQA shape, Whisper's cross-attention, its
    encoder and decoder self-attention, the reduced Jamba's GQA) in bf16
    and fp32, o and lse from the plain forward, each build called through
    its own checkout's wrapper (which allocates that build's scratch) and
    held to ``flash_attention_bwd_plain`` by ``bwd_err`` within ``ATOL``;
    each case also reports the device ms of each launch in one call;
  * ``ssd_chunk_bwd``: the first two shapes of
    ``chip_smoke.ssd_grad_cases`` (Mamba2-1.3B's train shape, 8 x 2048:
    (8, 8, 256, 64, 64, 128), and the reduced Jamba's, (4, 8, 256, 128,
    64, 128)) in bf16 and fp32, dy standard normal fp32, each build called
    through its own checkout's wrapper and held to
    ``ssd_chunk_bwd_plain`` by its ``bwd_err`` within ``ATOL``; each case
    also reports the device ms of each of the build's launches in one
    call, by kernel name, from ``torch.profiler``.

Each process holds its build to the plain version first, then times it
with CUDA events (mean of ``--reps`` launches after one warm-up).  The
merges' launches take a few microseconds, less than a ctypes call's host
time, so they are captured in a CUDA graph of ``--reps`` launches that is
replayed under the events; each of their cases also reports the host
microseconds of one call of its checkout's Python wrapper (median of 5
runs of 1,000 calls with no sync inside).  Prints the card's name and
power limit, one line per timing, and a JSON summary last.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from repro_torch.kernels import (block_sparse_matmul_plain, build,
                                 flash_attention_plain, merge_path,
                                 merge_path_plain, multi_merge_ranks,
                                 multi_merge_ranks_plain, search_plain,
                                 ssd_chunk_plain)
from repro_torch.kernels.block_sparse_matmul import _ARGTYPES as BSMM_ARGS
from repro_torch.kernels.block_sparse_matmul import _DTYPES as BSMM_DTYPES
from repro_torch.kernels.flash_attention import _ARGTYPES as FLASH_ARGS
from repro_torch.kernels.flash_attention import _DTYPES as FLASH_DTYPES
from repro_torch.kernels.flash_attention import ATOL as FLASH_ATOL
from repro_torch.kernels import flash_attention_bwd
from repro_torch.kernels.flash_attention_bwd import ATOL as BWD_ATOL
from repro_torch.kernels.flash_attention_bwd import (
    bwd_err, flash_attention_bwd_plain, flash_attention_bwd_scale)
from repro_torch.kernels.merge import _ARGTYPES as MERGE_ARGS
from repro_torch.kernels.multi_merge import _ARGTYPES as MULTI_ARGS
from repro_torch.kernels.search import _ARGTYPES as SEARCH_ARGS
from repro_torch.kernels.ssd_chunk import _ARGTYPES as SSD_ARGS
from repro_torch.kernels.ssd_chunk import _DTYPES as SSD_DTYPES

SHAPE = (4, 8, 256, 64, 64, 128)
#: the ssd_chunk cases: (label, shape, dtype)
SSD_CASES = (("mamba2", SHAPE, torch.bfloat16),
             ("mamba2", SHAPE, torch.float32),
             ("jamba", (4, 8, 256, 128, 64, 128), torch.float32))
SSD_TOL = 2e-4
#: the flash_attention cases: label -> ((b, h, hkv, sq, sk, d), causal,
#: dtype)
FLASH_CASES = {
    "whisper_encoder fp32": ((4, 12, 12, 1500, 1500, 64), False,
                             torch.float32),
    "whisper_cross_decode fp32": ((4, 12, 12, 1, 1500, 64), False,
                                  torch.float32),
    "qwen2_7b_prefill fp32": ((4, 28, 4, 2048, 2048, 128), True,
                              torch.float32),
    "whisper_encoder bf16": ((4, 12, 12, 1500, 1500, 64), False,
                             torch.bfloat16)}
#: ((b, h, hkv, sq, sk, d), causal): chip_smoke.FLASH_GRAD_CASES
BWD_CASES = (((8, 16, 16, 2048, 2048, 128), True),
             ((4, 28, 4, 2048, 2048, 128), True),
             ((4, 12, 12, 448, 1500, 64), False),
             ((8, 12, 12, 1500, 1500, 64), False),
             ((8, 12, 12, 448, 448, 64), True),
             ((4, 32, 8, 2048, 2048, 128), True))
#: (B, nc, l, H, P, N): chip_smoke.ssd_grad_cases()'s first two shapes
SSD_BWD_CASES = ((8, 8, 256, 64, 64, 128), (4, 8, 256, 128, 64, 128))
#: (M, K, N, bm, bk, tile density): chip_smoke.BSMM_CARD
BSMM_CASE = (8192, 8192, 1024, 128, 128, 0.3)
BSMM_RTOL = 1e-4
#: (keys, probes): the table case of chip_smoke.phase_kernels
SEARCH_CASE = (21_500_000, 43_000_000)
#: row lengths of the merges: the table case of chip_smoke.phase_kernels
#: and one launch of the simulator's main path
MERGE_CASES = {"table": (100_000, 125_000), "main": (6250, 6250)}
MULTI_CASES = {"table": (100_000, 125_000, 120_000), "main": (6250,) * 3}
#: the source file of each kernel, where it is not the kernel's name
SOURCE = {"multi_merge_ranks": "multi_merge"}


def compile_source(src: Path, tag: str) -> Path:
    """``src`` compiled with ``build.NVCC_FLAGS`` into ``build.BUILD_DIR``;
    prints nvcc's register and spill lines; returns the library."""
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        h.update(header.read_bytes())
    out = build.BUILD_DIR / f"ab-{tag}-{h.hexdigest()[:16]}.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                           str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    for line in (proc.stdout + proc.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"  {tag}: {line.strip()}", flush=True)
    return out


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {code}")


# ---------------------------------------------------------------------- #
# per kernel: cases of (label, run(lib), plain output, comparison)
# ---------------------------------------------------------------------- #
def ssd_cases(lib, gen):
    """x, a, b, c at each of SSD_CASES on the card, as chip_smoke.py makes
    them."""
    fn = lib.repro_ssd_chunk
    fn.argtypes, fn.restype = list(SSD_ARGS), ctypes.c_int

    def randn(*s):
        return torch.randn(s, generator=gen, device="cuda")

    for label, shape, dtype in SSD_CASES:
        B, nc, l, H, P, N = shape
        x = randn(B, nc, l, H, P).to(dtype)
        a = -randn(B, H, nc, l).abs() * 0.1
        b, c = randn(B, nc, l, N).to(dtype), randn(B, nc, l, N).to(dtype)
        want = ssd_chunk_plain(x, a, b, c)
        y = torch.full(want.shape, float("nan"), device="cuda")

        def run(x=x, a=a, b=b, c=c, y=y, shape=shape):
            _check(fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
                      y.data_ptr(), *shape, SSD_DTYPES[x.dtype], _stream()),
                   "ssd_chunk")
            return y

        def ok(got, want=want):
            err = (got - want).abs()
            return float(err.max()), bool((err <= SSD_TOL
                                           * (1 + want.abs())).all())

        yield f"{label} {dtype}", run, ok


def flash_cases(lib, gen):
    """q, k, v at each of FLASH_CASES on the card, standard normal, as
    chip_smoke.py makes them; contiguous, the output too."""
    fn = lib.repro_flash_attention
    fn.argtypes, fn.restype = list(FLASH_ARGS), ctypes.c_int
    for label, (shape, causal, dtype) in FLASH_CASES.items():
        b, h, hkv, sq, sk, d = shape
        q, k, v = (torch.randn(s, generator=gen, device="cuda").to(dtype)
                   for s in ((b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))
        want = flash_attention_plain(q, k, v, causal).float()
        o = torch.empty_like(q)
        strides = (ctypes.c_int64 * 12)(*(s for t in (q, k, v, o)
                                          for s in t.stride()[:3]))

        def run(q=q, k=k, v=v, o=o, strides=strides, shape=shape,
                causal=causal):
            b, h, hkv, sq, sk, d = shape
            _check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                      None, b, h, hkv, sq, sk, d, int(causal),
                      1.0 / math.sqrt(d),
                      FLASH_DTYPES[q.dtype], ctypes.addressof(strides),
                      _stream()), "flash_attention")
            return o

        def ok(got, want=want, atol=FLASH_ATOL[dtype]):
            err = float((got.float() - want).abs().max())
            return err, err <= atol

        yield label, run, ok


def bwd_cases(lib, gen):
    """q, k, v, do at each of BWD_CASES in bf16 and fp32, standard normal,
    with o and lse from the plain forward; the build in ``lib`` is called
    through this checkout's ``flash_attention_bwd`` wrapper."""
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    build._LIBS["flash_attention_bwd"] = lib
    from repro_torch.kernels import flash_attention_lse_plain
    for shape, causal in BWD_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            b, h, hkv, sq, sk, d = shape
            q, k, v, do = (torch.randn(s, generator=gen, device="cuda")
                           .to(dtype) for s in
                           ((b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, d),
                            (b, h, sq, d)))
            o = flash_attention_plain(q, k, v, causal)
            lse = flash_attention_lse_plain(q, k, v, causal)
            args = (q, k, v, o, lse, do, causal)
            want = flash_attention_bwd_plain(*args)
            scale = flash_attention_bwd_scale(*args)

            def run(args=args):
                return flash_attention_bwd(*args)

            def ok(got, want=want, scale=scale, atol=BWD_ATOL[dtype]):
                err = bwd_err(got, want, scale)
                return err, err <= atol

            yield f"{shape} causal={causal} {dtype}", run, ok


def ssd_bwd_cases(lib, gen):
    """x, a, b, c, dy at each of SSD_BWD_CASES in bf16 and fp32, as
    chip_smoke.py's phase ssd_grad makes them (a = -0.1 |normal|); the
    build in ``lib`` is called through this checkout's ``ssd_chunk_bwd``
    wrapper (which allocates that build's scratch)."""
    import importlib
    mod = importlib.import_module("repro_torch.kernels.ssd_chunk_bwd")
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    build._LIBS["ssd_chunk_bwd"] = lib
    for shape in SSD_BWD_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            B, nc, l, H, P, N = shape

            def randn(*s):
                return torch.randn(s, generator=gen, device="cuda")

            x = randn(B, nc, l, H, P).to(dtype)
            a = -randn(B, H, nc, l).abs() * 0.1
            b, c = randn(B, nc, l, N).to(dtype), randn(B, nc, l, N).to(dtype)
            dy = randn(B, nc, l, H, P)
            args = (x, a, b, c, dy)
            want = mod.ssd_chunk_bwd_plain(*args)
            scale = mod.ssd_chunk_bwd_scale(*args)

            def run(args=args):
                return mod.ssd_chunk_bwd(*args)

            def ok(got, want=want, scale=scale):
                err = mod.bwd_err(got, want, scale)
                return err, err <= mod.ATOL

            yield f"{shape} {dtype}", run, ok


def launch_ms(run) -> dict:
    """Device ms of each kernel launched by one ``run()``, by name, from
    ``torch.profiler``."""
    run()
    torch.cuda.synchronize()
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    with prof:
        run()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            # the function's name: the word before its template or
            # argument list
            found = re.search(r"(\w+)(?:<[^()]*>)?\(", ev.name)
            name = found.group(1) if found else ev.name
            out[name] = out.get(name, 0.0) + ev.time_range.elapsed_us() / 1e3
    return out


def bsmm_cases(lib, gen):
    fn = lib.repro_block_sparse_matmul
    fn.argtypes, fn.restype = list(BSMM_ARGS), ctypes.c_int
    M, K, N, bm, bk, density = BSMM_CASE
    n_row = M // bm
    mask = torch.rand(n_row, K // bk, generator=gen, device="cuda") < density
    rows, cols = mask.nonzero(as_tuple=True)          # sorted by (row, col)
    rowptr = torch.searchsorted(rows, torch.arange(n_row + 1, device="cuda"))
    tiles = torch.randn(len(rows), bm, bk, generator=gen, device="cuda")
    b32 = torch.randn(K, N, generator=gen, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        t, b = tiles.to(dtype), b32.to(dtype)
        want = block_sparse_matmul_plain(t, rows, cols, b, M)
        z = torch.full((M, N), float("nan"), device="cuda")
        code = BSMM_DTYPES[dtype]

        def run(t=t, b=b, z=z, code=code):
            _check(fn(t.data_ptr(), rowptr.data_ptr(), cols.data_ptr(),
                      b.data_ptr(), z.data_ptr(), n_row, M, K, N, bm, bk,
                      128, 128, code, code, _stream()),
                   "block_sparse_matmul")
            return z

        def ok(got, want=want):
            err = float((got - want).abs().max())
            return err, err <= BSMM_RTOL * K ** 0.5 * float(want.abs().max())

        yield str(dtype), run, ok


def search_cases(lib, gen):
    fn = lib.repro_search
    fn.argtypes, fn.restype = list(SEARCH_ARGS), ctypes.c_int
    m, n = SEARCH_CASE
    span = 150_000_000_000
    hay = torch.unique(torch.randint(0, span, (int(m * 1.02),),
                                     generator=gen, device="cuda"))[:m]
    hits = hay[torch.randint(0, len(hay), (n,), generator=gen,
                             device="cuda")]
    probes = torch.where(torch.rand(n, generator=gen, device="cuda") < 0.5,
                         hits, torch.randint(0, span, (n,), generator=gen,
                                             device="cuda"))
    sorted_probes = torch.sort(probes).values
    for label, p in (("sorted", sorted_probes), ("shuffled", probes)):
        want = search_plain(hay, p)
        out = torch.empty_like(p)

        def run(p=p, out=out):
            _check(fn(hay.data_ptr(), len(hay), p.data_ptr(), len(p),
                      out.data_ptr(), _stream()), "search")
            return out

        def ok(got, want=want):
            same = torch.equal(got, want)
            return (0.0 if same else float((got - want).abs().max())), same

        yield label, run, ok


def _rows(gen, sizes):
    """Sorted int64 rows of these lengths on the card, each after the
    first holding every fourth key of the first (a quarter of it at
    most), as chip_smoke.py's replays share keys."""
    rows = [torch.sort(torch.randint(0, 1 << 40, (n,), generator=gen,
                                     device="cuda")).values for n in sizes]
    for r in range(1, len(rows)):
        m = min(len(rows[0]), len(rows[r])) // 4
        rows[r] = torch.sort(torch.cat([rows[r][:len(rows[r]) - m],
                                        rows[0][::4][:m]])).values
    return rows


def _equal(got, want):
    same = all(torch.equal(g, w) for g, w in zip(got, want))
    return (0.0 if same else float("nan")), same


def merge_cases(lib, gen):
    fn = lib.repro_merge_path
    fn.argtypes, fn.restype = list(MERGE_ARGS), ctypes.c_int
    for label, sizes in MERGE_CASES.items():
        a, b = _rows(gen, sizes)
        want = merge_path_plain(a, b)
        merged = torch.empty_like(want[0])
        src = torch.empty_like(want[1])

        def run(a=a, b=b, merged=merged, src=src):
            _check(fn(a.data_ptr(), len(a), b.data_ptr(), len(b),
                      merged.data_ptr(), src.data_ptr(), _stream()),
                   "merge_path")
            return merged, src

        yield (label, run, lambda got, want=want: _equal(got, want),
               lambda a=a, b=b: merge_path(a, b))


def multi_cases(lib, gen):
    fn = lib.repro_multi_merge_ranks
    fn.argtypes, fn.restype = list(MULTI_ARGS), ctypes.c_int
    for label, sizes in MULTI_CASES.items():
        keys = torch.cat(_rows(gen, sizes))
        offs = torch.tensor([0, *sizes], device="cuda").cumsum(0)
        want = multi_merge_ranks_plain(keys, offs)
        ranks = torch.empty_like(want)

        def run(keys=keys, offs=offs, ranks=ranks):
            _check(fn(keys.data_ptr(), offs.data_ptr(), len(offs) - 1,
                      len(keys), ranks.data_ptr(), _stream()),
                   "multi_merge_ranks")
            return (ranks,)

        yield (label, run, lambda got, want=want: _equal(got, (want,)),
               lambda keys=keys, offs=offs: multi_merge_ranks(keys, offs))


KERNELS = {"ssd_chunk": ssd_cases, "flash_attention": flash_cases,
           "block_sparse_matmul": bsmm_cases,
           "search": search_cases, "merge_path": merge_cases,
           "multi_merge_ranks": multi_cases,
           "flash_attention_bwd": bwd_cases, "ssd_chunk_bwd": ssd_bwd_cases}


def time_ms(run, reps: int, graph: bool = False) -> float:
    """Mean ms a launch: CUDA events around ``reps`` launches after one
    warm-up, or around one replay of a CUDA graph that captured them."""
    run()
    torch.cuda.synchronize()
    g = None
    if graph:
        g = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side), torch.cuda.graph(g, stream=side):
            for _ in range(reps):
                run()
        torch.cuda.current_stream().wait_stream(side)
        g.replay()
        torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    if graph:
        g.replay()
    else:
        for _ in range(reps):
            run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_us(call, calls: int = 1000, runs: int = 5) -> float:
    """Median host microseconds of one ``call``: ``runs`` runs of
    ``calls`` calls with no sync inside."""
    call()
    torch.cuda.synchronize()
    out = []
    for _ in range(runs):
        t0 = time.perf_counter()
        for _ in range(calls):
            call()
        out.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(out)


def measure(kernel: str, lib_path: Path, reps: int) -> dict:
    """One build's error and time at each case of ``kernel`` (this
    process); for the merges also the host time of a wrapper call."""
    lib = ctypes.CDLL(str(lib_path))
    gen = torch.Generator("cuda").manual_seed(3)
    out = {}
    for label, run, ok, *wrapper in KERNELS[kernel](lib, gen):
        got = run()
        torch.cuda.synchronize()
        err, good = ok(got)
        out[label] = {"max_abs_err": err, "ok": good,
                      "ms": time_ms(run, reps, graph=bool(wrapper))
                      if good else None}
        if wrapper:
            out[label]["host_us"] = host_us(wrapper[0])
        if kernel in ("ssd_chunk_bwd", "flash_attention_bwd") and good:
            out[label]["launch_ms"] = launch_ms(run)
        del got
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", type=Path)
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="ssd_chunk")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--measure", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ssd_ab: no CUDA device", file=sys.stderr)
        return 1
    if args.measure:
        print(json.dumps(measure(args.kernel, args.measure, args.reps)))
        return 0
    if args.base is None:
        ap.error("--base is required")
    rel = Path("src/repro_torch/kernels/csrc") / \
        f"{SOURCE.get(args.kernel, args.kernel)}.cu"
    roots = {"base": args.base.resolve(), "this": build.CSRC.parents[3]}
    libs = {tag: compile_source(root / rel, f"{args.kernel}-{tag}")
            for tag, root in roots.items()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    turns, ok = [], True
    for tag in ("base", "this", "this", "base"):
        # this file, run with the checkout's own package on the path
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--kernel",
             args.kernel, "--measure", str(libs[tag]), "--reps",
             str(args.reps)], capture_output=True, text=True,
            env=dict(os.environ, PYTHONPATH=str(roots[tag] / "src")))
        if proc.returncode != 0:
            raise RuntimeError(f"{tag}: {proc.stdout}{proc.stderr}")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        for label, r in rec.items():
            ms = "not timed" if r["ms"] is None else f"{r['ms']:.4f} ms"
            host = f", wrapper {r['host_us']:.3f} us a call on the host" \
                if "host_us" in r else ""
            if "launch_ms" in r:
                host += ", device ms by launch " + ", ".join(
                    f"{n} {v:.4f}" for n, v in r["launch_ms"].items())
            print(f"{tag} {args.kernel} {label}: {ms}{host}, max abs err "
                  f"{r['max_abs_err']:.3g}, within its limit: {r['ok']}",
                  flush=True)
            ok = ok and r["ok"]
        turns.append({"build": tag, **rec})
    print(json.dumps({"card": smi, "kernel": args.kernel, "reps": args.reps,
                      "turns": turns}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
