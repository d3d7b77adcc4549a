"""Synthetic workloads of the port's benchmarks (``benchmarks/workloads.py``,
copied): the paper's five evaluation matrices at simulator scale, the
uniform SpMSpM pair, and the graph workloads of the Fig-13 study.

The paper evaluates on SuiteSparse/SNAP matrices (8K-63K rows, 100-370K
nnz); the pure-Python fibertree simulator is cycle-accurate but ~10^4x
slower than the ASICs it models, so benchmarks synthesize matrices with
the same STRUCTURAL character (uniform vs power-law row occupancy,
matching density) at 256-512 rows.  All comparisons are RELATIVE
(normalized to the algorithmic minimum or across designs), which is
scale-robust.

One deliberate difference from the reference: ``synth_matrix`` seeds its
generator from ``seed + zlib.crc32(name) % 1000``, where the reference
takes ``seed + hash(name) % 1000``.  Python salts ``hash`` of a string
per process (``PYTHONHASHSEED``), so the reference builds other matrices
in every process; the crc32 digest builds the same ones everywhere.
Every other generator seeds ``numpy.random.default_rng`` from an integer
and builds the reference's arrays from the same seed.
"""
from __future__ import annotations

import zlib
from typing import Dict, Tuple

import numpy as np

from repro_torch.core.csf import CSF

# name -> (rows, cols, density, row-degree distribution)
# densities match the paper's Table 4 (nnz / (rows*cols))
PAPER_MATRICES: Dict[str, Tuple[int, int, float, str]] = {
    "wi": (256, 256, 1.5e-3 * 16, "powerlaw"),   # wiki-Vote: skewed
    "p2": (320, 320, 3.7e-5 * 160, "uniform"),   # p2p-Gnutella31
    "ca": (256, 256, 3.5e-4 * 40, "powerlaw"),   # ca-CondMat
    "po": (256, 384, 1.1e-3 * 16, "uniform"),    # poisson3Da
    "em": (288, 288, 2.7e-4 * 50, "powerlaw"),   # email-Enron
}


def synth_matrix(name: str, seed: int = 0) -> np.ndarray:
    rows, cols, density, dist = PAPER_MATRICES[name]
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % 1000)
    nnz_target = max(8, int(rows * cols * density))
    a = np.zeros((rows, cols))
    if dist == "uniform":
        idx = rng.choice(rows * cols, size=nnz_target, replace=False)
        a.flat[idx] = rng.random(nnz_target) + 0.1
    else:
        # zipf-ish row occupancy (graph degree skew)
        w = 1.0 / np.arange(1, rows + 1) ** 1.1
        row_nnz = rng.multinomial(nnz_target, w / w.sum())
        order = rng.permutation(rows)
        for r, n in zip(order, row_nnz):
            n = min(n, cols)
            if n:
                c = rng.choice(cols, size=n, replace=False)
                a[r, c] = rng.random(n) + 0.1
    return a


def uniform_pair(m=256, k=256, n=256, da=0.1, db=0.1, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.random((m, k)) * (rng.random((m, k)) < da)
    b = rng.random((k, n)) * (rng.random((k, n)) < db)
    return a, b


def grid_graph(side: int, extra: int = 0, weighted: bool = False,
               seed: int = 0) -> np.ndarray:
    """2D grid + shortcuts: the sparse-frontier BFS/SSSP workload."""
    v = side * side
    adj = np.zeros((v, v))
    for i in range(side):
        for j in range(side):
            u = i * side + j
            if j + 1 < side:
                adj[u + 1, u] = 1
            if i + 1 < side:
                adj[u + side, u] = 1
    rng = np.random.default_rng(seed)
    for _ in range(extra):
        s, d = rng.integers(0, v, 2)
        if s != d:
            adj[d, s] = 1
    if weighted:
        adj = adj * rng.integers(1, 8, size=adj.shape)
    return adj


def powerlaw_graph(v: int = 256, avg_deg: float = 4.0, weighted=False,
                   seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, v + 1) ** 1.0
    p = w / w.sum()
    nnz = int(v * avg_deg)
    src = rng.choice(v, size=nnz, p=p)
    dst = rng.choice(v, size=nnz, p=p)
    adj = np.zeros((v, v))
    for s, d in zip(src, dst):
        if s != d:
            adj[d, s] = rng.integers(1, 8) if weighted else 1.0
    return adj


def sparse_grid_graph(side: int, extra: int = 0, weighted: bool = False,
                      seed: int = 0):
    """2D grid + random shortcuts as a columnar FTensor in stored order
    [S, D] -- the sparse-frontier BFS/SSSP workload of ``grid_graph``,
    built without the dense v x v adjacency so 10^5+ vertex runs are
    feasible.  High diameter keeps per-iteration frontiers small
    relative to v (the regime where partition-gated property loading
    pays off)."""
    rng = np.random.default_rng(seed)
    v = side * side
    u = np.arange(v).reshape(side, side)
    src = np.concatenate([u[:, :-1].ravel(), u[:-1, :].ravel()])
    dst = np.concatenate([u[:, 1:].ravel(), u[1:, :].ravel()])
    if extra:
        s = rng.integers(0, v, size=extra)
        d = rng.integers(0, v, size=extra)
        keep = s != d
        src = np.concatenate([src, s[keep]])
        dst = np.concatenate([dst, d[keep]])
    vals = (rng.integers(1, 8, size=len(src)).astype(np.float64)
            if weighted else np.ones(len(src)))
    pts = np.stack([src, dst], axis=1).astype(np.int64)
    csf = CSF.from_coo("G", ["S", "D"], pts, vals, {"S": v, "D": v})
    return csf.to_ftensor()


def sparse_graph(v: int, avg_deg: float = 8.0, weighted: bool = False,
                 seed: int = 0, dist: str = "powerlaw"):
    """Power-law (or uniform) random digraph built columnar as an
    FTensor in the graph specs' stored order [S, D] -- no dense v x v
    adjacency, so 10^5+ vertex BFS/SSSP runs are feasible on the
    vector backend.  Duplicate (s, d) draws collapse (last wins)."""
    rng = np.random.default_rng(seed)
    nnz = int(v * avg_deg)
    if dist == "powerlaw":
        w = 1.0 / np.arange(1, v + 1) ** 1.0
        p = w / w.sum()
        src = rng.choice(v, size=nnz, p=p)
        dst = rng.choice(v, size=nnz, p=p)
    else:
        src = rng.integers(0, v, size=nnz)
        dst = rng.integers(0, v, size=nnz)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    vals = (rng.integers(1, 8, size=len(src)).astype(np.float64)
            if weighted else np.ones(len(src)))
    pts = np.stack([src, dst], axis=1).astype(np.int64)
    csf = CSF.from_coo("G", ["S", "D"], pts, vals, {"S": v, "D": v})
    return csf.to_ftensor()
