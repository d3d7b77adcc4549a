"""The graph workloads of the Fig-13 study (``benchmarks/workloads.py``'s
``grid_graph`` and ``sparse_grid_graph``, copied).

Both seed ``numpy.random.default_rng`` from an integer, so they build
the same graphs as the reference from the same seed.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.csf import CSF


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
