"""Time two builds of ``ssd_chunk.cu`` on one card, in turns.

    python -m repro_torch.bench.ssd_ab --base DIR [--reps 20]

``DIR`` is another checkout of this repository (the parent commit, for
example, unpacked with ``git archive`` under the ignored ``build/``).
Its ``src/repro_torch/kernels/csrc/ssd_chunk.cu`` and this tree's are
compiled with the flags of ``kernels/build.py`` and launched through the
same C interface at the Mamba2-1.3B prefill shape (B 4, nc 8, l 256,
H 64, P 64, N 128) in bf16 and fp32, each build in a process of its own,
in the order base, this, this, base, so both come from one card.  Each process holds its build to ``ssd_chunk_plain`` within 2e-4
(1 + |want|), then times it with CUDA events (mean of ``--reps``
launches after one warm-up).  Prints the card's name and power limit,
one line per timing, and a JSON summary last.
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

from repro_torch.kernels import build, ssd_chunk_plain
from repro_torch.kernels.ssd_chunk import _ARGTYPES, _DTYPES

SHAPE = (4, 8, 256, 64, 64, 128)
SSD_TOL = 2e-4


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


def inputs(dtype, seed: int = 3):
    """x, a, b, c at SHAPE on the card, as chip_smoke.py makes them."""
    B, nc, l, H, P, N = SHAPE
    gen = torch.Generator("cuda").manual_seed(seed)

    def randn(*s):
        return torch.randn(s, generator=gen, device="cuda")

    x = randn(B, nc, l, H, P).to(dtype)
    a = -randn(B, H, nc, l).abs() * 0.1
    return x, a, randn(B, nc, l, N).to(dtype), randn(B, nc, l, N).to(dtype)


def run_lib(lib, args, y) -> None:
    x, a, b, c = args
    B, nc, l, H, P, N = SHAPE
    code = lib.repro_ssd_chunk(x.data_ptr(), a.data_ptr(), b.data_ptr(),
                               c.data_ptr(), y.data_ptr(), B, nc, l, H, P,
                               N, _DTYPES[x.dtype],
                               torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise RuntimeError(f"ssd_chunk launch failed: CUDA error {code}")


def time_ms(lib, args, y, reps: int) -> float:
    run_lib(lib, args, y)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run_lib(lib, args, y)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def measure(lib_path: Path, reps: int) -> dict:
    """One build's error and time in bf16 and fp32 (this process)."""
    lib = ctypes.CDLL(str(lib_path))
    lib.repro_ssd_chunk.argtypes = list(_ARGTYPES)
    lib.repro_ssd_chunk.restype = ctypes.c_int
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        ins = inputs(dtype)
        want = ssd_chunk_plain(*ins)
        y = torch.full(want.shape, float("nan"), device="cuda")
        run_lib(lib, ins, y)
        torch.cuda.synchronize()
        err = (y - want).abs()
        ok = bool((err <= SSD_TOL * (1 + want.abs())).all())
        out[str(dtype)] = {"max_abs_err": float(err.max()), "ok": ok,
                           "ms": time_ms(lib, ins, y, reps)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", type=Path)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--measure", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ssd_ab: no CUDA device", file=sys.stderr)
        return 1
    if args.measure:
        print(json.dumps(measure(args.measure, args.reps)))
        return 0
    if args.base is None:
        ap.error("--base is required")
    rel = Path("src/repro_torch/kernels/csrc/ssd_chunk.cu")
    libs = {"base": compile_source(args.base / rel, "base"),
            "this": compile_source(build.CSRC / "ssd_chunk.cu", "this")}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    turns, ok = [], True
    for tag in ("base", "this", "this", "base"):
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.bench.ssd_ab", "--measure",
             str(libs[tag]), "--reps", str(args.reps)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{tag}: {proc.stdout}{proc.stderr}")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        for dtype, r in rec.items():
            print(f"{tag} {dtype}: {r['ms']:.4f} ms, max abs err "
                  f"{r['max_abs_err']:.3g}, within 2e-4 (1 + |want|): "
                  f"{r['ok']}", flush=True)
            ok = ok and r["ok"]
        turns.append({"build": tag, **rec})
    print(json.dumps({"card": smi, "shape": SHAPE, "reps": args.reps,
                      "turns": turns}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
