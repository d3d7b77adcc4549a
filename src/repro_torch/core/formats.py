"""Concrete tensor formats (TeAAL Section 4.1.1).

Lowers fibertrees onto concrete per-rank representations described by a
``TensorFormat`` (format type U/C/B, layout SoA/AoS, data widths for
coordinates / payloads / fiber headers).  Provides:

  * byte accounting per touched element (the storage models consume this),
  * whole-tensor / subtree footprints (eager fills, buffer occupancy),
  * reference lowerings to familiar formats (CSR, CSC, COO, bitmap,
    OuterSPACE's array-of-linked-lists) for tests and demos,
  * the algorithmic-minimum traffic used to normalize Figure 9.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .fibertree import Fiber, FTensor
from .spec import FormatSpec, RankFormat, TensorFormat


# ---------------------------------------------------------------------- #
# byte accounting
# ---------------------------------------------------------------------- #
def touch_bytes(fmt: TensorFormat, rank: str, kind: str) -> float:
    """Bytes moved by touching one coordinate/payload at ``rank``."""
    rf = fmt.ranks.get(rank, RankFormat())

    def coord_cost() -> float:
        if rf.format == "U":
            return 0.0                      # positional; nothing stored
        if rf.format == "B":
            return 1.0 / 8.0                # bitmap: one bit per position
        return rf.cbits / 8.0

    if kind == "coord":
        return coord_cost()
    if kind == "payload":
        return rf.pbits / 8.0
    if kind == "elem":
        return coord_cost() + rf.pbits / 8.0
    raise ValueError(kind)


def fiber_header_bytes(fmt: TensorFormat, rank: str) -> float:
    rf = fmt.ranks.get(rank, RankFormat())
    return rf.fhbits / 8.0


def subtree_bytes(ft: FTensor, fmt: TensorFormat, node: Any,
                  depth: int) -> float:
    """Footprint of the subtree rooted at ``node`` (a Fiber at level
    ``depth`` of ``ft``, or a leaf payload)."""
    if not isinstance(node, Fiber):
        return touch_bytes(fmt, ft.ranks[-1], "payload")
    rank = ft.ranks[depth]
    rf = fmt.ranks.get(rank, RankFormat())
    total = rf.fhbits / 8.0
    occupancy = len(node)
    if rf.format == "U":
        shape = ft.rank_shapes.get(rank) or occupancy
        if isinstance(shape, tuple):
            shape = int(np.prod([s or 1 for s in shape]))
        n_pay = shape
        n_coord = 0
    elif rf.format == "B":
        shape = ft.rank_shapes.get(rank) or occupancy
        if isinstance(shape, tuple):
            shape = int(np.prod([s or 1 for s in shape]))
        n_pay = occupancy
        n_coord = 0
        total += shape / 8.0                # bitmap: one bit per position
    else:                                    # C
        n_pay = occupancy
        n_coord = occupancy
    total += n_coord * rf.cbits / 8.0
    if depth == len(ft.ranks) - 1:
        total += n_pay * rf.pbits / 8.0
    else:
        # payloads are fiber references (pbits wide) + children footprints
        total += n_pay * rf.pbits / 8.0
        for _, child in node:
            total += subtree_bytes(ft, fmt, child, depth + 1)
    return total


def tensor_bytes(ft: FTensor, fmt: TensorFormat) -> float:
    return subtree_bytes(ft, fmt, ft.root, 0)


# ---------------------------------------------------------------------- #
# reference lowerings (tests / demos)
# ---------------------------------------------------------------------- #
@dataclass
class CSR:
    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])


def to_csr(ft: FTensor) -> CSR:
    """Lower a 2-rank fibertree (row rank outer) to CSR arrays."""
    assert len(ft.ranks) == 2
    nrows = ft._int_shape(ft.ranks[0])
    indptr = np.zeros(nrows + 1, dtype=np.int64)
    cols: List[int] = []
    vals: List[float] = []
    for r, fiber in ft.root:
        indptr[r + 1] = len(fiber)
        cols.extend(fiber.coords)
        vals.extend(fiber.payloads)
    indptr = np.cumsum(indptr)
    return CSR(indptr, np.asarray(cols, dtype=np.int64),
               np.asarray(vals, dtype=np.float64))


def to_csc(ft: FTensor) -> CSR:
    """CSC = CSR of the rank-swizzled tensor."""
    return to_csr(ft.swizzle(list(reversed(ft.ranks))))


def to_coo(ft: FTensor) -> Tuple[np.ndarray, np.ndarray]:
    """(coords [nnz, ndim], values [nnz]) in rank order."""
    pts, vals = [], []
    for path, v in ft.iter_leaves():
        flat = []
        for c in path:
            flat.extend(c) if isinstance(c, tuple) else flat.append(c)
        pts.append(flat)
        vals.append(v)
    if not pts:
        return (np.zeros((0, len(ft.ranks)), dtype=np.int64),
                np.zeros((0,), dtype=np.float64))
    return np.asarray(pts, dtype=np.int64), np.asarray(vals, dtype=np.float64)


def to_bitmap(ft: FTensor) -> Tuple[np.ndarray, np.ndarray]:
    """SIGMA-style bitmap + packed nonzero values for a 2-rank tensor."""
    dense = ft.to_dense()
    mask = dense != 0
    return mask, dense[mask]


@dataclass
class LinkedLists:
    """OuterSPACE's array-of-linked-lists (Fig. 5c): one list head per
    upper-rank coordinate; each node is a (coord, value, next) record."""
    heads: np.ndarray            # [shape_upper] -> node index or -1
    nodes: List[Tuple[int, float, int]]

    @property
    def nnz(self) -> int:
        return len(self.nodes)


def to_linked_lists(ft: FTensor) -> LinkedLists:
    assert len(ft.ranks) == 2
    n_upper = ft._int_shape(ft.ranks[0])
    heads = np.full(n_upper, -1, dtype=np.int64)
    nodes: List[Tuple[int, float, int]] = []
    for r, fiber in ft.root:
        prev = -1
        for c, v in fiber:
            nodes.append((int(c), float(v), -1))
            idx = len(nodes) - 1
            if prev == -1:
                heads[r] = idx
            else:
                pc, pv, _ = nodes[prev]
                nodes[prev] = (pc, pv, idx)
            prev = idx
    return LinkedLists(heads, nodes)


# ---------------------------------------------------------------------- #
# algorithmic minimum traffic (Fig. 9 normalization)
# ---------------------------------------------------------------------- #
def algorithmic_min_traffic(inputs: Dict[str, FTensor],
                            output: FTensor,
                            fmt: Optional[FormatSpec] = None) -> float:
    """Bytes if every input were read exactly once and the final output
    written exactly once, in the default format of each tensor."""
    fmt = fmt or FormatSpec()
    total = 0.0
    for name, ft in inputs.items():
        total += tensor_bytes(ft, fmt.default(name))
    total += tensor_bytes(output, fmt.default(output.name))
    return total
