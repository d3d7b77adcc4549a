"""Time two builds of one kernel source on one card, in turns.

    python -m repro_torch.bench.ssd_ab --base DIR [--kernel NAME] [--reps 20]

``DIR`` is another checkout of this repository (the parent commit, for
example, unpacked with ``git archive`` under the ignored ``build/``).
``NAME`` is ``ssd_chunk`` (the default), ``block_sparse_matmul`` or
``search``.  The kernel's source under ``src/repro_torch/kernels/csrc/``
in ``DIR`` and in this tree are compiled with the flags of
``kernels/build.py`` and launched through the same C interface, each
build in a process of its own, in the order base, this, this, base, so
both come from one card.  The cases:

  * ``ssd_chunk``: the Mamba2-1.3B prefill shape (B 4, nc 8, l 256, H 64,
    P 64, N 128) in bf16 and fp32, held to ``ssd_chunk_plain`` within
    2e-4 (1 + |want|);
  * ``block_sparse_matmul``: ``chip_smoke.py``'s card case (A 8192 x 8192
    in 128 x 128 tiles at 30% tile density, B 8192 x 1024) in fp32 and
    bf16, held to ``block_sparse_matmul_plain`` within 1e-4 sqrt(K)
    max |Z|;
  * ``search``: the table case (43M probes, half of them keys, into 21.5M
    sorted int64 keys), sorted and shuffled, equal to ``search_plain``.

Each process holds its build to the plain version first, then times it
with CUDA events (mean of ``--reps`` launches after one warm-up).  Prints
the card's name and power limit, one line per timing, and a JSON summary
last.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import (block_sparse_matmul_plain, build,
                                 search_plain, ssd_chunk_plain)
from repro_torch.kernels.block_sparse_matmul import _ARGTYPES as BSMM_ARGS
from repro_torch.kernels.block_sparse_matmul import _DTYPES as BSMM_DTYPES
from repro_torch.kernels.search import _ARGTYPES as SEARCH_ARGS
from repro_torch.kernels.ssd_chunk import _ARGTYPES as SSD_ARGS
from repro_torch.kernels.ssd_chunk import _DTYPES as SSD_DTYPES

SHAPE = (4, 8, 256, 64, 64, 128)
SSD_TOL = 2e-4
#: (M, K, N, bm, bk, tile density): chip_smoke.BSMM_CARD
BSMM_CASE = (8192, 8192, 1024, 128, 128, 0.3)
BSMM_RTOL = 1e-4
#: (keys, probes): the table case of chip_smoke.phase_kernels
SEARCH_CASE = (21_500_000, 43_000_000)


def compile_source(src: Path, tag: str) -> Path:
    """``src`` compiled with ``build.NVCC_FLAGS`` into ``build.BUILD_DIR``;
    prints nvcc's register and spill lines; returns the library."""
    h = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = build.BUILD_DIR / f"ab-{tag}-{h}.so"
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
    """x, a, b, c at SHAPE on the card, as chip_smoke.py makes them."""
    fn = lib.repro_ssd_chunk
    fn.argtypes, fn.restype = list(SSD_ARGS), ctypes.c_int
    B, nc, l, H, P, N = SHAPE

    def randn(*s):
        return torch.randn(s, generator=gen, device="cuda")

    for dtype in (torch.bfloat16, torch.float32):
        x = randn(B, nc, l, H, P).to(dtype)
        a = -randn(B, H, nc, l).abs() * 0.1
        b, c = randn(B, nc, l, N).to(dtype), randn(B, nc, l, N).to(dtype)
        want = ssd_chunk_plain(x, a, b, c)
        y = torch.full(want.shape, float("nan"), device="cuda")

        def run(x=x, a=a, b=b, c=c, y=y):
            _check(fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
                      y.data_ptr(), B, nc, l, H, P, N,
                      SSD_DTYPES[x.dtype], _stream()), "ssd_chunk")
            return y

        def ok(got, want=want):
            err = (got - want).abs()
            return float(err.max()), bool((err <= SSD_TOL
                                           * (1 + want.abs())).all())

        yield str(dtype), run, ok


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


KERNELS = {"ssd_chunk": ssd_cases, "block_sparse_matmul": bsmm_cases,
           "search": search_cases}


def time_ms(run, reps: int) -> float:
    run()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def measure(kernel: str, lib_path: Path, reps: int) -> dict:
    """One build's error and time at each case of ``kernel`` (this
    process)."""
    lib = ctypes.CDLL(str(lib_path))
    gen = torch.Generator("cuda").manual_seed(3)
    out = {}
    for label, run, ok in KERNELS[kernel](lib, gen):
        got = run()
        torch.cuda.synchronize()
        err, good = ok(got)
        out[label] = {"max_abs_err": err, "ok": good,
                      "ms": time_ms(run, reps) if good else None}
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
    rel = Path("src/repro_torch/kernels/csrc") / f"{args.kernel}.cu"
    libs = {"base": compile_source(args.base / rel, f"{args.kernel}-base"),
            "this": compile_source(build.CSRC / f"{args.kernel}.cu",
                                   f"{args.kernel}-this")}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    turns, ok = [], True
    for tag in ("base", "this", "this", "base"):
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.bench.ssd_ab", "--kernel",
             args.kernel, "--measure", str(libs[tag]), "--reps",
             str(args.reps)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{tag}: {proc.stdout}{proc.stderr}")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        for label, r in rec.items():
            ms = "not timed" if r["ms"] is None else f"{r['ms']:.4f} ms"
            print(f"{tag} {args.kernel} {label}: {ms}, max abs err "
                  f"{r['max_abs_err']:.3g}, within its limit: {r['ok']}",
                  flush=True)
            ok = ok and r["ok"]
        turns.append({"build": tag, **rec})
    print(json.dumps({"card": smi, "kernel": args.kernel, "reps": args.reps,
                      "turns": turns}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
