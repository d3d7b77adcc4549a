"""Columnar CSF (compressed-sparse-fiber) tensor representation.

The fibertree interpreter (`core/fibertree.py`) stores one Python object
per fiber, which caps every accelerator model at toy sizes.  This module
stores the *same* tree as flat per-rank arrays -- the layout Sparseloop
and the Sparse Abstract Machine use for scaling this class of model:

  * ``coords[d]``   -- int32 array [n_d, width_d]: the coordinates of
                       every element at rank ``d``, in depth-first
                       (lexicographic) order.  ``width_d`` is 1 for
                       normal ranks and >1 for flattened (tuple-coord)
                       ranks.
  * ``segments[d]`` -- int32 array [n_{d-1} + 1] for d >= 1: element
                       ``i`` of rank ``d-1`` owns the child slice
                       ``coords[d][segments[d][i]:segments[d][i+1]]``.
                       Rank 0 is the root fiber (one implicit segment).
  * ``values``      -- float64 array [n_{L-1}]: leaf payloads aligned
                       with the innermost coords.

Conversion ``FTensor <-> CSF`` is lossless (same rank names, shapes,
coordinate order, upper-rank markers), and the TeAAL Section 3.2
content-preserving transformations -- rank swizzling, uniform-shape /
uniform-occupancy partitioning, rank flattening -- are reimplemented
here as vectorized array ops with semantics identical to the Fiber
implementations (asserted by tests/test_csf.py).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import guards
from .fibertree import Fiber, FTensor

COORD_DTYPE = np.int32
SEG_DTYPE = np.int32


def _as_coord_col(arr: Any) -> np.ndarray:
    a = np.asarray(arr)
    if a.dtype == COORD_DTYPE:       # hot path: no copy, no domain scan
        return a if a.ndim == 2 else a.reshape(-1, 1)
    if a.size:
        assert a.max() <= np.iinfo(COORD_DTYPE).max
    a = a.astype(COORD_DTYPE)
    if a.ndim == 1:
        a = a[:, None]
    return a


class CSF:
    """A named fibertree stored as flat per-rank arrays."""

    def __init__(self, name: str, ranks: Sequence[str],
                 coords: Sequence[np.ndarray],
                 segments: Sequence[Optional[np.ndarray]],
                 values: np.ndarray,
                 rank_shapes: Optional[Dict[str, Any]] = None,
                 default: Any = 0,
                 upper_ranks: Optional[set] = None):
        self.name = name
        self.ranks: List[str] = list(ranks)
        # coords[d]: [n_d, width_d] int; segments[d]: [n_{d-1}+1] (d>=1)
        self.coords: List[np.ndarray] = [_as_coord_col(c) for c in coords]
        self.segments: List[Optional[np.ndarray]] = [
            None if s is None else np.asarray(s).astype(SEG_DTYPE)
            for s in segments]
        self.values = np.asarray(values)
        self.rank_shapes: Dict[str, Any] = dict(rank_shapes or {})
        self.default = default
        self.upper_ranks: set = set(upper_ranks or ())
        assert len(self.coords) == len(self.ranks)
        assert len(self.segments) == len(self.ranks)
        assert self.segments[0] is None
        for d in range(1, len(self.ranks)):
            seg = self.segments[d]
            assert seg is not None and len(seg) == len(self.coords[d - 1]) + 1
            guards.check_monotone_segments(
                seg, f"csf:{self.name}:{self.ranks[d]}")
        assert len(self.values) == (len(self.coords[-1]) if self.ranks else 0)

    # ------------------------------------------------------------------ #
    # basics
    # ------------------------------------------------------------------ #
    @property
    def ndim(self) -> int:
        return len(self.ranks)

    @property
    def nnz(self) -> int:
        return int(len(self.values))

    def level_width(self, d: int) -> int:
        return int(self.coords[d].shape[1])

    def children(self, d: int, pos: int) -> Tuple[int, int]:
        """Child slice [start, end) in ``coords[d]`` of element ``pos``
        at rank ``d-1`` (``pos`` ignored for d == 0)."""
        if d == 0:
            return 0, len(self.coords[0])
        seg = self.segments[d]
        return int(seg[pos]), int(seg[pos + 1])

    # ------------------------------------------------------------------ #
    # conversion
    # ------------------------------------------------------------------ #
    @staticmethod
    def from_ftensor(ft: FTensor) -> "CSF":
        L = len(ft.ranks)
        coords: List[List[Tuple[int, ...]]] = [[] for _ in range(L)]
        segments: List[List[int]] = [[0] for _ in range(L)]
        values: List[Any] = []

        def rec(fiber: Fiber, depth: int) -> None:
            for c, p in fiber:
                coords[depth].append(c if isinstance(c, tuple) else (c,))
                if depth == L - 1:
                    values.append(p)
                else:
                    assert isinstance(p, Fiber), \
                        f"{ft.name}: non-fiber payload above leaf rank"
                    rec(p, depth + 1)
                    segments[depth + 1].append(len(coords[depth + 1]))

        if L:
            rec(ft.root, 0)
        widths = [max((len(t) for t in coords[d]), default=1)
                  for d in range(L)]
        carr = [np.asarray(coords[d], dtype=np.int64).reshape(
                    len(coords[d]), widths[d]) for d in range(L)]
        segs: List[Optional[np.ndarray]] = [None] + [
            np.asarray(segments[d], dtype=np.int64) for d in range(1, L)]
        vals = np.asarray(values, dtype=np.float64) if values else \
            np.zeros(0, dtype=np.float64)
        return CSF(ft.name, ft.ranks, carr, segs, vals,
                   dict(ft.rank_shapes), ft.default, set(ft.upper_ranks))

    def to_ftensor(self) -> FTensor:
        L = self.ndim
        out = FTensor(self.name, self.ranks, Fiber(),
                      dict(self.rank_shapes), self.default,
                      set(self.upper_ranks))
        if L == 0 or self.nnz == 0:
            return out
        clists = [c.tolist() for c in self.coords]
        widths = [self.level_width(d) for d in range(L)]
        vals = self.values.tolist()

        def coord_of(d: int, i: int):
            row = clists[d][i]
            return tuple(row) if widths[d] > 1 else row[0]

        def build(d: int, lo: int, hi: int) -> Fiber:
            fiber = Fiber()
            for i in range(lo, hi):
                if d == L - 1:
                    fiber.append(coord_of(d, i), vals[i])
                else:
                    seg = self.segments[d + 1]
                    fiber.append(coord_of(d, i),
                                 build(d + 1, int(seg[i]), int(seg[i + 1])))
            return fiber

        out.root = build(0, 0, len(self.coords[0]))
        return out

    @staticmethod
    def from_coo(name: str, ranks: Sequence[str], coords: np.ndarray,
                 values: np.ndarray,
                 rank_shapes: Optional[Dict[str, int]] = None,
                 default: Any = 0) -> "CSF":
        """Build from COO points [nnz, ndim] + values (vectorized).

        Duplicate points are collapsed (last value wins, matching
        Fiber.insert overwrite semantics)."""
        pts = np.asarray(coords, dtype=np.int64)
        vals = np.asarray(values, dtype=np.float64)
        ranks = list(ranks)
        L = len(ranks)
        assert pts.ndim == 2 and pts.shape[1] == L
        if len(pts) == 0:
            return CSF(name, ranks, [np.zeros((0, 1)) for _ in range(L)],
                       [None] + [np.zeros(1) for _ in range(L - 1)],
                       np.zeros(0), rank_shapes, default)
        order = np.lexsort(tuple(pts[:, d] for d in range(L - 1, -1, -1)))
        pts, vals = pts[order], vals[order]
        # collapse duplicates: keep the last of each run
        same = np.all(pts[1:] == pts[:-1], axis=1)
        keep = np.append(~same, True)
        pts, vals = pts[keep], vals[keep]
        shapes = dict(rank_shapes or {})
        for d, r in enumerate(ranks):
            shapes.setdefault(r, int(pts[:, d].max()) + 1)
        return _from_sorted_points(name, ranks,
                                   [pts[:, d:d + 1] for d in range(L)],
                                   vals, shapes, default, set())

    @staticmethod
    def from_dense(name: str, ranks: Sequence[str], array: np.ndarray,
                   default: Any = 0) -> "CSF":
        array = np.asarray(array)
        assert array.ndim == len(ranks)
        pts = np.argwhere(array != 0)
        vals = array[tuple(pts.T)].astype(np.float64)
        shapes = {r: int(s) for r, s in zip(ranks, array.shape)}
        return CSF.from_coo(name, ranks, pts, vals, shapes, default)

    def to_dense(self) -> np.ndarray:
        assert all(self.level_width(d) == 1 for d in range(self.ndim)), \
            "to_dense on flattened ranks is undefined"
        pts = self.point_matrix()
        shape = [int(self.rank_shapes.get(r) or
                     (pts[:, d].max() + 1 if len(pts) else 1))
                 for d, r in enumerate(self.ranks)]
        out = np.full(shape, self.default, dtype=np.float64)
        if len(pts):
            out[tuple(pts.T)] = self.values
        return out

    # ------------------------------------------------------------------ #
    # structural queries
    # ------------------------------------------------------------------ #
    def expand_level(self, d: int) -> np.ndarray:
        """Parent index (position at rank d-1) of every element at rank
        ``d``; for d == 0 an all-zero array."""
        n = len(self.coords[d])
        if d == 0:
            return np.zeros(n, dtype=np.int64)
        seg = self.segments[d]
        counts = np.diff(seg)
        return np.repeat(np.arange(len(counts), dtype=np.int64), counts)

    def point_matrix(self) -> np.ndarray:
        """[nnz, sum(widths)] coordinate matrix of every leaf, with each
        upper rank's coordinate columns repeated down the tree."""
        L = self.ndim
        cols: List[np.ndarray] = []
        n_leaf = len(self.coords[-1])
        for d in range(L):
            c = self.coords[d]
            # replicate down to leaf level
            for dd in range(d + 1, L):
                seg = self.segments[dd]
                counts = np.diff(seg)
                c = np.repeat(c, counts, axis=0)
            assert len(c) == n_leaf
            cols.append(c)
        if not cols:
            return np.zeros((0, 0), dtype=np.int64)
        return np.concatenate(cols, axis=1)

    def content_points(self) -> np.ndarray:
        """Like ``point_matrix`` but with partition-upper rank columns
        dropped (content coordinates only -- the CSF analogue of
        FTensor.content_signature)."""
        L = self.ndim
        keep: List[np.ndarray] = []
        pm = self.point_matrix()
        col = 0
        for d in range(L):
            w = self.level_width(d)
            if self.ranks[d] not in self.upper_ranks:
                keep.append(pm[:, col:col + w])
            col += w
        return np.concatenate(keep, axis=1) if keep else pm

    # ------------------------------------------------------------------ #
    # content-preserving transformations (TeAAL Sec. 3.2, vectorized)
    # ------------------------------------------------------------------ #
    def swizzle(self, new_order: Sequence[str]) -> "CSF":
        new_order = list(new_order)
        assert sorted(new_order) == sorted(self.ranks), \
            f"swizzle {self.ranks} -> {new_order} is not a permutation"
        if new_order == self.ranks:
            return self.copy()
        widths = [self.level_width(d) for d in range(self.ndim)]
        pm = self.point_matrix()
        col_of: Dict[str, Tuple[int, int]] = {}
        col = 0
        for d, r in enumerate(self.ranks):
            col_of[r] = (col, widths[d])
            col += widths[d]
        cols = [pm[:, col_of[r][0]:col_of[r][0] + col_of[r][1]]
                for r in new_order]
        flat = np.concatenate(cols, axis=1) if cols else pm
        order = np.lexsort(tuple(flat[:, c]
                                 for c in range(flat.shape[1] - 1, -1, -1)))
        shapes = {r: self.rank_shapes.get(r) for r in new_order}
        return _from_sorted_points(
            self.name, new_order, [c[order] for c in cols],
            self.values[order], shapes, self.default, set(self.upper_ranks))

    def flatten_ranks(self, upper: str, lower: str) -> "CSF":
        """Flatten adjacent ranks into one tuple-coordinate rank named
        ``upper + lower`` (identical semantics to FTensor.flatten_ranks)."""
        iu = self.ranks.index(upper)
        assert iu + 1 < self.ndim and self.ranks[iu + 1] == lower, \
            f"{upper},{lower} must be adjacent in {self.ranks}"
        new_rank = upper + lower
        L = self.ndim
        seg_l = self.segments[iu + 1]
        counts = np.diff(seg_l)
        up_rep = np.repeat(self.coords[iu], counts, axis=0)
        merged = np.concatenate([up_rep, self.coords[iu + 1]], axis=1)

        coords = (self.coords[:iu] + [merged] + self.coords[iu + 2:])
        segments: List[Optional[np.ndarray]] = list(self.segments)
        if iu == 0:
            new_segments = [None] + segments[iu + 2:]
        else:
            # parent slice of the merged level: compose segments
            seg_u = self.segments[iu]
            new_seg = seg_l[seg_u]
            new_segments = segments[:iu] + [new_seg] + segments[iu + 2:]
        ranks = self.ranks[:iu] + [new_rank] + self.ranks[iu + 2:]
        shapes = {r: self.rank_shapes.get(r) for r in ranks}
        shapes[new_rank] = (self.rank_shapes.get(upper),
                            self.rank_shapes.get(lower))
        return CSF(self.name, ranks, coords, new_segments, self.values,
                   shapes, self.default, set(self.upper_ranks))

    def partition_uniform_shape(self, rank: str, size: int) -> "CSF":
        """Shape-based split: rank R -> [R1, R0], upper coordinates are
        (c // size) * size.  Matches FTensor.partition_uniform_shape."""
        depth = self.ranks.index(rank)
        if self.level_width(depth) != 1:
            raise ValueError("uniform_shape cannot partition flattened ranks")
        upper = (self.coords[depth][:, 0] // size) * size
        return self._partition(depth, upper[:, None])

    def partition_uniform_occupancy(self, rank: str, size: int) -> "CSF":
        """Occupancy-based split: boundaries every ``size`` elements of
        each fiber; upper coordinate = first coordinate of each chunk.
        Matches FTensor.partition_uniform_occupancy (self-leader form;
        leader-follower boundary adoption stays on the FTensor path)."""
        depth = self.ranks.index(rank)
        n = len(self.coords[depth])
        parent = self.expand_level(depth)
        if depth == 0:
            starts = np.zeros(1, dtype=np.int64)
        else:
            starts = self.segments[depth][:-1]
        # position within the owning fiber
        within = np.arange(n, dtype=np.int64) - starts[parent]
        chunk = within // size
        first = within - (within % size)     # fiber position of chunk head
        head = starts[parent] + first
        upper = self.coords[depth][head]     # coords of each chunk head
        return self._partition(depth, upper, chunk_key=chunk)

    def _partition(self, depth: int, upper: np.ndarray,
                   chunk_key: Optional[np.ndarray] = None) -> "CSF":
        """Insert a new level above ``depth`` grouping its elements by
        ``upper`` coordinate (within each parent fiber).  ``chunk_key``
        disambiguates groups whose upper coordinate could repeat."""
        rank = self.ranks[depth]
        parent = self.expand_level(depth)
        key = upper[:, 0] if chunk_key is None else chunk_key
        n = len(key)
        if n == 0:
            new_coords = np.zeros((0, upper.shape[1]), dtype=np.int64)
            new_seg = np.zeros(1, dtype=np.int64)
            group_of = np.zeros(0, dtype=np.int64)
        else:
            boundary = np.ones(n, dtype=bool)
            boundary[1:] = (parent[1:] != parent[:-1]) | (key[1:] != key[:-1])
            group_starts = np.flatnonzero(boundary)
            new_coords = upper[group_starts]
            group_of = np.cumsum(boundary) - 1
            # segments for the new level: child ranges in coords[depth]
            new_seg = np.append(group_starts, n)
            # segments for the parent level: group ranges per parent elem
            parent_of_group = parent[group_starts]

        upper_rank, lower_rank = rank + "1", rank + "0"
        ranks = (self.ranks[:depth] + [upper_rank, lower_rank]
                 + self.ranks[depth + 1:])

        if depth == 0:
            parent_seg: Optional[np.ndarray] = None
        else:
            n_parent = len(self.coords[depth - 1])
            cnt = np.zeros(n_parent, dtype=np.int64)
            if n:
                np.add.at(cnt, parent_of_group, 1)
            parent_seg = np.concatenate([[0], np.cumsum(cnt)])

        coords = (self.coords[:depth] + [new_coords, self.coords[depth]]
                  + self.coords[depth + 1:])
        segments: List[Optional[np.ndarray]] = (
            list(self.segments[:depth]) + [parent_seg, new_seg]
            + list(self.segments[depth + 1:]))
        shapes = {r: self.rank_shapes.get(r) for r in ranks}
        shapes[upper_rank] = self.rank_shapes.get(rank)
        shapes[lower_rank] = self.rank_shapes.get(rank)
        return CSF(self.name, ranks, coords, segments, self.values,
                   shapes, self.default,
                   set(self.upper_ranks) | {upper_rank})

    def rename_ranks(self, mapping: Dict[str, str]) -> "CSF":
        ranks = [mapping.get(r, r) for r in self.ranks]
        shapes = {mapping.get(r, r): s for r, s in self.rank_shapes.items()}
        return CSF(self.name, ranks, self.coords, self.segments, self.values,
                   shapes, self.default,
                   {mapping.get(r, r) for r in self.upper_ranks})

    def copy(self, name: Optional[str] = None) -> "CSF":
        return CSF(name or self.name, self.ranks,
                   [c.copy() for c in self.coords],
                   [None if s is None else s.copy() for s in self.segments],
                   self.values.copy(), dict(self.rank_shapes), self.default,
                   set(self.upper_ranks))


def _from_sorted_points(name: str, ranks: Sequence[str],
                        cols: List[np.ndarray], values: np.ndarray,
                        rank_shapes: Optional[Dict[str, Any]],
                        default: Any, upper_ranks: set,
                        leaf_unique: bool = False) -> "CSF":
    """Build a CSF from per-rank coordinate columns already sorted
    lexicographically outer->inner (one row per leaf).

    ``leaf_unique`` promises every row is a distinct point (e.g. the
    vector path's reduced groups): the innermost level then skips its
    boundary scan entirely -- every row starts a leaf fiber entry."""
    L = len(ranks)
    n = len(values)
    cols = [_as_coord_col(c) for c in cols]
    # prefix-change boundaries per level
    coords: List[np.ndarray] = []
    segments: List[Optional[np.ndarray]] = []
    if n == 0:
        return CSF(name, ranks, [np.zeros((0, c.shape[1])) for c in cols],
                   [None] + [np.zeros(1) for _ in range(L - 1)],
                   values, rank_shapes, default, upper_ranks)
    new_prefix = np.zeros(n, dtype=bool)
    new_prefix[0] = True
    prev_starts: Optional[np.ndarray] = None
    for d in range(L):
        c = cols[d]
        if leaf_unique and d == L - 1 and d > 0:
            # distinct rows: searchsorted(arange(n), x) == x, so the
            # level's starts are all rows and segments come straight
            # from the parent boundaries
            coords.append(c)
            assert prev_starts is not None
            segments.append(np.append(prev_starts, n).astype(np.int64))
            prev_starts = None
            break
        changed = np.zeros(n, dtype=bool)
        changed[0] = True
        if c.shape[1] == 1:              # skip the reduce over one column
            np.not_equal(c[1:, 0], c[:-1, 0], out=changed[1:])
        else:
            changed[1:] = np.any(c[1:] != c[:-1], axis=1)
        new_prefix = new_prefix | changed
        starts = np.flatnonzero(new_prefix)
        coords.append(c[starts])
        if d == 0:
            segments.append(None)
        else:
            # element i at level d-1 spans leaves
            # [prev_starts[i], prev_starts[i+1]); its children are the
            # level-d groups starting inside that span
            assert prev_starts is not None
            seg = np.searchsorted(starts, np.append(prev_starts, n))
            segments.append(seg.astype(np.int64))
        prev_starts = starts
    return CSF(name, ranks, coords, segments, values, rank_shapes,
               default, upper_ranks)
