"""Kernel bench of the port: each hand-written kernel at the reference
bench's shapes (``benchmarks/kernels_bench.py`` ``run()``), against its
oracle, on the CUDA device unless ``--device`` names another.

    python -m repro_torch.bench.kernels_bench [--device cpu]

Rows print as ``name,us_per_call,err``, the reference's format; a name
ends in the route that ran (``cuda`` for the hand kernels, ``plain`` for
their plain versions on the CPU).  ``err`` is the largest absolute
difference from the oracle, also on the SpMSpM co-iteration row (the
reference prints a multiply rate there).  Each row carries the limit
it is held to; ``main`` exits non-zero when a row exceeds it.  The
reference's ``seam_rates`` and ``--record`` wait for the seam bench.
"""
from __future__ import annotations

import argparse
import math
import sys
import time
from typing import Callable, List, NamedTuple

import numpy as np
import torch

from repro_torch.accelerators.zoo import rowwise_spmspm
from repro_torch.core.generator import CascadeSimulator
from repro_torch.core.vectorized import VectorBackend
from repro_torch.kernels import (block_sparse_matmul, compact_tiles,
                                 flash_attention, ssd_chunk, ssd_chunk_plain)
from repro_torch.kernels.backends import kernels_for, resolve_device
from repro_torch.kernels.ref import attention_ref, block_sparse_matmul_ref

#: flash attention in fp32: the kernel and the oracle differ by the order
#: of their fp32 sums (the reference's own test holds it to 2e-6)
FLASH_ATOL = 2e-5
#: ssd_chunk: rtol = atol = 2e-4, the reference's kernel-vs-oracle limit
SSD_TOL = 2e-4


class Row(NamedTuple):
    name: str
    us_per_call: float
    err: float
    limit: float


def _t(fn: Callable[[], object], device: torch.device, reps: int = 3):
    """Mean microseconds of ``fn`` after one warm-up, on the host clock
    with the device synchronised; returns (us, the last result)."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    out = fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    sync()
    return (time.perf_counter() - t0) / reps * 1e6, out


def _max_abs(got, want) -> float:
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if got.numel() == 0:
        return 0.0
    return float((got.double() - want.double()).abs().max())


def run(device=None, reps: int = 3) -> List[Row]:
    """The reference bench's rows that the port has a kernel for."""
    device = resolve_device(device)
    route = "cuda" if device.type == "cuda" else "plain"
    rng = np.random.default_rng(0)
    rows: List[Row] = []

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    # flash attention
    q = dev(rng.standard_normal((1, 4, 256, 64)).astype(np.float32))
    k = dev(rng.standard_normal((1, 2, 256, 64)).astype(np.float32))
    v = dev(rng.standard_normal((1, 2, 256, 64)).astype(np.float32))
    us, got = _t(lambda: flash_attention(q, k, v), device, reps)
    rows.append(Row(f"kernels/flash_attention/{route}", us,
                    _max_abs(got, attention_ref(q, k, v)), FLASH_ATOL))
    us_ref, _ = _t(lambda: attention_ref(q, k, v), device, reps)
    rows.append(Row("kernels/flash_attention/torch_ref", us_ref, 0.0, 0.0))

    # block-sparse matmul
    a = rng.standard_normal((256, 256)).astype(np.float32)
    mask = rng.random((4, 4)) < 0.4
    a = a * np.kron(mask, np.ones((64, 64), np.float32))
    b = dev(rng.standard_normal((256, 128)).astype(np.float32))
    tiles, rws, cls = (dev(x) for x in compact_tiles(a, 64, 64))
    us, got = _t(lambda: block_sparse_matmul(tiles, rws, cls, b, m=256,
                                             bn=64), device, reps)
    want = block_sparse_matmul_ref(dev(a), b)
    # fp32 sums of K = 256 products in another order: 1e-4 sqrt(K) of |Z|
    rows.append(Row(f"kernels/block_sparse_matmul/{route}", us,
                    _max_abs(got, want),
                    1e-4 * math.sqrt(256) * float(want.abs().max())))

    # ssd chunk
    x = dev(rng.standard_normal((1, 2, 128, 4, 64)).astype(np.float32))
    aa = dev((-np.abs(rng.standard_normal((1, 4, 2, 128))) * 0.1)
             .astype(np.float32))
    bb = dev(rng.standard_normal((1, 2, 128, 32)).astype(np.float32))
    cc = dev(rng.standard_normal((1, 2, 128, 32)).astype(np.float32))
    us, got = _t(lambda: ssd_chunk(x, aa, bb, cc), device, reps)
    want = ssd_chunk_plain(x, aa, bb, cc)
    rows.append(Row(f"kernels/ssd_chunk/{route}", us, _max_abs(got, want),
                    SSD_TOL * (1 + float(want.abs().max()))))

    # sorted-coordinate intersection and sorted union through the seams
    seams = kernels_for(device)
    ac = np.sort(rng.choice(100000, 2000, replace=False)).astype(np.int64)
    bc = np.sort(rng.choice(100000, 4000, replace=False)).astype(np.int64)
    us, got = _t(lambda: seams.intersect_keys(ac, bc), device, reps)
    pos = np.searchsorted(bc, ac)
    hit = bc[np.minimum(pos, len(bc) - 1)] == ac
    rows.append(Row(f"kernels/intersect_sorted/{route}", us,
                    _max_abs(got, np.where(hit, pos, -1)), 0.0))
    am = np.sort(rng.choice(50000, 1500, replace=False)).astype(np.int64)
    bm = np.sort(rng.choice(50000, 2500, replace=False)).astype(np.int64)
    us, (union, pa, pb) = _t(lambda: seams.union_keys(am, bm), device, reps)
    want = np.union1d(am, bm)
    err = _max_abs(union, want)
    for keys, p in ((am, pa), (bm, pb)):
        hit = p >= 0
        err = max(err, _max_abs(keys[p[hit]], union[hit]),
                  float(np.isin(union[~hit], keys).sum()))
    rows.append(Row(f"kernels/merge_sorted/{route}", us, err, 0.0))

    # SpMSpM co-iteration through the port's simulator (the seams' real
    # call path)
    n = 256
    a = rng.random((n, n)) * (rng.random((n, n)) < 0.05)
    b = rng.random((n, n)) * (rng.random((n, n)) < 0.05)
    sim = CascadeSimulator(rowwise_spmspm(), model=False,
                           backend=VectorBackend(device=device))
    t0 = time.perf_counter()
    res = sim.run({"A": a, "B": b}, {"m": n, "k": n, "n": n})
    dt = time.perf_counter() - t0
    z = np.zeros((n, n))
    got = res["Z"].to_dense()
    z[:got.shape[0], :got.shape[1]] = got
    want = a @ b
    rows.append(Row("kernels/spmspm_coiter/vector", dt * 1e6,
                    _max_abs(z, want), 1e-12 * max(1.0, np.abs(want).max())))
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args()
    rows = run(args.device)
    print("name,us_per_call,err")
    for r in rows:
        print(f"{r.name},{r.us_per_call:.1f},{r.err:.3g}")
    bad = [r for r in rows if not r.err <= r.limit]
    for r in bad:
        print(f"{r.name}: err {r.err:.3g} above its limit {r.limit:.3g}",
              file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
