"""Fibertree abstraction (Sze et al. / TeAAL Section 2.1).

A fibertree represents an N-tensor as a tree with one level per rank.
Each level holds *fibers*: sorted sequences of (coordinate, payload)
elements, where payloads are scalars at the leaves and child fibers at
intermediate levels.

Supported content-preserving transformations (TeAAL Section 3.2):
  * rank flattening      -- combine two adjacent ranks (tuple coordinates)
  * rank partitioning    -- uniform_shape / uniform_occupancy (leader-follower)
  * rank swizzling       -- reorder tree levels

Dense <-> fibertree conversion is provided so every cascade evaluated on
fibertrees can be cross-checked against a dense einsum oracle.
"""
from __future__ import annotations

import bisect
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

Coord = Any  # int, or tuple of ints after flattening


class Fiber:
    """A sorted sequence of (coordinate, payload) elements."""

    __slots__ = ("coords", "payloads")

    def __init__(self, coords: Optional[List[Coord]] = None,
                 payloads: Optional[List[Any]] = None):
        self.coords: List[Coord] = list(coords) if coords else []
        self.payloads: List[Any] = list(payloads) if payloads else []
        assert len(self.coords) == len(self.payloads)

    # ------------------------------------------------------------------ #
    # basics
    # ------------------------------------------------------------------ #
    def __len__(self) -> int:
        return len(self.coords)

    def __iter__(self) -> Iterator[Tuple[Coord, Any]]:
        return zip(self.coords, self.payloads)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        items = ", ".join(f"{c}: {p!r}" for c, p in list(self)[:8])
        suffix = ", ..." if len(self) > 8 else ""
        return f"Fiber({{{items}{suffix}}})"

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Fiber):
            return NotImplemented
        return self.coords == other.coords and self.payloads == other.payloads

    def is_empty(self) -> bool:
        return not self.coords

    def lookup(self, coord: Coord) -> Optional[Any]:
        """Payload at ``coord`` or None."""
        i = bisect.bisect_left(self.coords, coord)
        if i < len(self.coords) and self.coords[i] == coord:
            return self.payloads[i]
        return None

    def insert(self, coord: Coord, payload: Any) -> None:
        i = bisect.bisect_left(self.coords, coord)
        if i < len(self.coords) and self.coords[i] == coord:
            self.payloads[i] = payload
        else:
            self.coords.insert(i, coord)
            self.payloads.insert(i, payload)

    def get_or_create(self, coord: Coord, default_factory: Callable[[], Any]):
        i = bisect.bisect_left(self.coords, coord)
        if i < len(self.coords) and self.coords[i] == coord:
            return self.payloads[i]
        payload = default_factory()
        self.coords.insert(i, coord)
        self.payloads.insert(i, payload)
        return payload

    def append(self, coord: Coord, payload: Any) -> None:
        """Fast-path insert when coord is known to be the largest so far."""
        assert not self.coords or coord > self.coords[-1], \
            f"append out of order: {coord} after {self.coords[-1]}"
        self.coords.append(coord)
        self.payloads.append(payload)

    # ------------------------------------------------------------------ #
    # co-iteration
    # ------------------------------------------------------------------ #
    def intersect(self, other: "Fiber") -> Iterator[Tuple[Coord, Any, Any]]:
        """Two-finger intersection: yields (coord, payload_a, payload_b)."""
        ia, ib = 0, 0
        a_c, b_c = self.coords, other.coords
        while ia < len(a_c) and ib < len(b_c):
            ca, cb = a_c[ia], b_c[ib]
            if ca == cb:
                yield ca, self.payloads[ia], other.payloads[ib]
                ia += 1
                ib += 1
            elif ca < cb:
                ia += 1
            else:
                ib += 1

    def union(self, other: "Fiber") -> Iterator[Tuple[Coord, Any, Any]]:
        """Yields (coord, payload_a_or_None, payload_b_or_None)."""
        ia, ib = 0, 0
        a_c, b_c = self.coords, other.coords
        while ia < len(a_c) or ib < len(b_c):
            if ib >= len(b_c) or (ia < len(a_c) and a_c[ia] < b_c[ib]):
                yield a_c[ia], self.payloads[ia], None
                ia += 1
            elif ia >= len(a_c) or b_c[ib] < a_c[ia]:
                yield b_c[ib], None, other.payloads[ib]
                ib += 1
            else:
                yield a_c[ia], self.payloads[ia], other.payloads[ib]
                ia += 1
                ib += 1

    def copy(self) -> "Fiber":
        return Fiber(
            list(self.coords),
            [p.copy() if isinstance(p, Fiber) else p for p in self.payloads],
        )


class FTensor:
    """A named fibertree: rank names (outer->inner) + root fiber + shapes.

    ``rank_shapes`` maps each rank name to its shape (max legal coordinate
    count); flattened ranks have tuple shapes; partitioned upper ranks
    inherit the source rank's shape.
    """

    def __init__(self, name: str, ranks: Sequence[str], root: Optional[Fiber] = None,
                 rank_shapes: Optional[Dict[str, Any]] = None,
                 default: Any = 0,
                 upper_ranks: Optional[set] = None):
        self.name = name
        self.ranks: List[str] = list(ranks)
        self.root: Fiber = root if root is not None else Fiber()
        self.rank_shapes: Dict[str, Any] = dict(rank_shapes or {})
        self.default = default
        # ranks created as the *upper* level of a partitioning: their
        # coordinates are partition starts, not content coordinates
        self.upper_ranks: set = set(upper_ranks or ())

    # ------------------------------------------------------------------ #
    # construction / conversion
    # ------------------------------------------------------------------ #
    @staticmethod
    def from_dense(name: str, ranks: Sequence[str], array: np.ndarray,
                   default: Any = 0) -> "FTensor":
        array = np.asarray(array)
        assert array.ndim == len(ranks)

        def build(sub: np.ndarray) -> Fiber:
            fiber = Fiber()
            if sub.ndim == 1:
                for c in np.nonzero(sub)[0]:
                    fiber.append(int(c), sub[c].item())
            else:
                # keep a coordinate if any value beneath it is nonzero
                flat = sub.reshape(sub.shape[0], -1)
                for c in np.nonzero(np.any(flat != 0, axis=1))[0]:
                    fiber.append(int(c), build(sub[c]))
            return fiber

        shapes = {r: int(s) for r, s in zip(ranks, array.shape)}
        return FTensor(name, ranks, build(array), shapes, default)

    def to_dense(self) -> np.ndarray:
        """Materialize to a dense numpy array (unflattened ranks only)."""
        shape = [self._int_shape(r) for r in self.ranks]
        out = np.full(shape, self.default, dtype=np.float64)

        def fill(fiber: Fiber, idx: Tuple[int, ...]):
            for c, p in fiber:
                if isinstance(p, Fiber):
                    fill(p, idx + (c,))
                else:
                    out[idx + (c,)] = p

        fill(self.root, ())
        return out

    def _int_shape(self, rank: str) -> int:
        s = self.rank_shapes.get(rank)
        if s is None:
            # derive from data
            s = 0
            for path, _ in self.iter_leaves():
                s = max(s, path[self.ranks.index(rank)] + 1)
            self.rank_shapes[rank] = s
        return int(s)

    def copy(self, name: Optional[str] = None) -> "FTensor":
        return FTensor(name or self.name, self.ranks, self.root.copy(),
                       dict(self.rank_shapes), self.default,
                       set(self.upper_ranks))

    # ------------------------------------------------------------------ #
    # queries
    # ------------------------------------------------------------------ #
    @property
    def nnz(self) -> int:
        return sum(1 for _ in self.iter_leaves())

    @property
    def is_empty(self) -> bool:
        """True when the tensor holds no leaves.  O(depth), unlike
        ``nnz == 0`` which walks every leaf before comparing."""
        return next(self.iter_leaves(), None) is None

    def iter_leaves(self) -> Iterator[Tuple[Tuple[Coord, ...], Any]]:
        def rec(fiber: Fiber, path: Tuple[Coord, ...]):
            for c, p in fiber:
                if isinstance(p, Fiber):
                    yield from rec(p, path + (c,))
                else:
                    yield path + (c,), p

        yield from rec(self.root, ())

    def lookup(self, coords: Sequence[Coord]) -> Any:
        node: Any = self.root
        for c in coords:
            if not isinstance(node, Fiber):
                raise KeyError("path too deep")
            node = node.lookup(c)
            if node is None:
                return None
        return node

    def content_signature(self) -> List[Tuple[Tuple[Coord, ...], Any]]:
        """Multiset of (fully-unflattened point, value): the *content*.

        Flattened tuple coordinates are expanded and partitioned paths are
        collapsed to the innermost (original) coordinate so that content
        preservation can be asserted across any transformation chain.
        """
        sig = []
        for path, val in self.iter_leaves():
            flat: List[Coord] = []
            for rank, c in zip(self.ranks, path):
                if rank in self.upper_ranks:
                    continue                  # partition start, not content
                if isinstance(c, tuple):
                    flat.extend(c)
                else:
                    flat.append(c)
            sig.append((tuple(flat), val))
        return sorted(sig, key=lambda x: (str(x[0]), repr(x[1])))

    # ------------------------------------------------------------------ #
    # content-preserving transformations
    # ------------------------------------------------------------------ #
    def swizzle(self, new_order: Sequence[str]) -> "FTensor":
        """Rank swizzle: reorder fibertree levels to ``new_order``."""
        new_order = list(new_order)
        assert sorted(new_order) == sorted(self.ranks), \
            f"swizzle {self.ranks} -> {new_order} is not a permutation"
        if new_order == self.ranks:
            return self.copy()
        perm = [self.ranks.index(r) for r in new_order]
        out = FTensor(self.name, new_order, Fiber(),
                      {r: self.rank_shapes.get(r) for r in new_order},
                      self.default, set(self.upper_ranks))
        for path, val in self.iter_leaves():
            new_path = [path[i] for i in perm]
            node = out.root
            for c in new_path[:-1]:
                node = node.get_or_create(c, Fiber)
            node.insert(new_path[-1], val)
        return out

    def flatten_ranks(self, upper: str, lower: str) -> "FTensor":
        """Flatten adjacent ranks ``upper``, ``lower`` into one tuple-coord
        rank named ``upper+lower`` (TeAAL Fig. 2, first transformation)."""
        iu = self.ranks.index(upper)
        assert iu + 1 < len(self.ranks) and self.ranks[iu + 1] == lower, \
            f"{upper},{lower} must be adjacent in {self.ranks}"
        new_rank = upper + lower

        def rec(fiber: Fiber, depth: int) -> Fiber:
            if depth == iu:
                out = Fiber()
                for cu, pu in fiber:
                    assert isinstance(pu, Fiber)
                    for cl, pl in pu:
                        cu_t = cu if isinstance(cu, tuple) else (cu,)
                        cl_t = cl if isinstance(cl, tuple) else (cl,)
                        out.append(cu_t + cl_t, pl)
                return out
            out = Fiber()
            for c, p in fiber:
                out.append(c, rec(p, depth + 1))
            return out

        ranks = self.ranks[:iu] + [new_rank] + self.ranks[iu + 2:]
        shapes = {r: self.rank_shapes.get(r) for r in ranks}
        shapes[new_rank] = (self.rank_shapes.get(upper),
                            self.rank_shapes.get(lower))
        return FTensor(self.name, ranks, rec(self.root, 0), shapes,
                       self.default, set(self.upper_ranks))

    # -- partitioning ---------------------------------------------------- #
    def partition_uniform_shape(self, rank: str, size: int) -> "FTensor":
        """Shape-based split: boundaries at multiples of ``size``.

        Rank R becomes [R1, R0]; upper coordinates are i*size (the first
        legal coordinate of the partition, TeAAL Sec. 2.1/3.2.1).
        Renaming of already-partitioned ranks is handled by the mapping
        layer; here the new ranks are literally named ``rank+'1'``/``'0'``.
        """
        return self._partition(rank, lambda fiber: _shape_boundaries(fiber, size))

    def partition_uniform_occupancy(self, rank: str, size: int,
                                    leader: Optional["FTensor"] = None,
                                    leader_rank: Optional[str] = None) -> "FTensor":
        """Occupancy-based split with leader-follower semantics.

        If ``leader`` is None (or is this tensor) boundaries equalize *this*
        tensor's fiber occupancies; otherwise boundaries are adopted from the
        leader's fibers at ``leader_rank`` (matched by shared parent
        coordinates, TeAAL Sec. 3.2.1).
        """
        if leader is None or leader is self:
            return self._partition(
                rank, lambda fiber: _occupancy_boundaries(fiber, size))
        lrank = leader_rank or rank
        table = leader.boundary_table(lrank, size)
        # Shared parent ranks: leader ranks above ``lrank`` matched against
        # follower ranks above ``rank``.  A follower rank that was already
        # partitioned matches through its innermost level (e.g. follower
        # 'M0' matches leader 'M'), because only that level carries the
        # original coordinates used as leader-table keys.
        above_self = self.ranks[: self.ranks.index(rank)]
        above_leader = leader.ranks[: leader.ranks.index(lrank)]
        shared: List[str] = []
        for lr in above_leader:
            if lr in above_self:
                shared.append(lr)
            elif lr + "0" in above_self:
                shared.append(lr + "0")

        def chooser(fiber: Fiber, parent: Dict[str, Coord]) -> List[Coord]:
            key = tuple(parent[r] for r in shared)
            bounds = table.get(key)
            if bounds is None:
                # follower fiber with no matching leader fiber: fall back to
                # equalizing its own occupancy (empty leader partition).
                return _occupancy_boundaries(fiber, size)
            return bounds

        return self._partition(rank, chooser, pass_parent=True)

    def boundary_table(self, rank: str, size: int) -> Dict[Tuple, List[Coord]]:
        """Occupancy boundaries of every fiber at ``rank``, keyed by the
        coordinates of the ranks above it (outer->inner)."""
        depth = self.ranks.index(rank)
        table: Dict[Tuple, List[Coord]] = {}

        def rec(fiber: Fiber, d: int, path: Tuple[Coord, ...]):
            if d == depth:
                table[path] = _occupancy_boundaries(fiber, size)
                return
            for c, p in fiber:
                rec(p, d + 1, path + (c,))

        rec(self.root, 0, ())
        return table

    def _partition(self, rank: str, boundary_fn, pass_parent: bool = False
                   ) -> "FTensor":
        depth = self.ranks.index(rank)

        def rec(fiber: Fiber, d: int, parent: Dict[str, Coord]) -> Fiber:
            if d == depth:
                bounds = (boundary_fn(fiber, parent) if pass_parent
                          else boundary_fn(fiber))
                upper = Fiber()
                if not bounds:
                    return upper
                for bi, start in enumerate(bounds):
                    end = bounds[bi + 1] if bi + 1 < len(bounds) else None
                    lo = bisect.bisect_left(fiber.coords, start)
                    hi = (bisect.bisect_left(fiber.coords, end)
                          if end is not None else len(fiber.coords))
                    if lo == hi:
                        continue
                    upper.append(start, Fiber(fiber.coords[lo:hi],
                                              fiber.payloads[lo:hi]))
                return upper
            out = Fiber()
            for c, p in fiber:
                sub_parent = dict(parent)
                sub_parent[self.ranks[d]] = c
                out.append(c, rec(p, d + 1, sub_parent))
            return out

        new_upper, new_lower = rank + "1", rank + "0"
        ranks = (self.ranks[:depth] + [new_upper, new_lower]
                 + self.ranks[depth + 1:])
        shapes = {r: self.rank_shapes.get(r) for r in ranks}
        shapes[new_upper] = self.rank_shapes.get(rank)
        shapes[new_lower] = self.rank_shapes.get(rank)
        return FTensor(self.name, ranks, rec(self.root, 0, {}), shapes,
                       self.default, set(self.upper_ranks) | {new_upper})

    def rename_ranks(self, mapping: Dict[str, str]) -> "FTensor":
        ranks = [mapping.get(r, r) for r in self.ranks]
        shapes = {mapping.get(r, r): s for r, s in self.rank_shapes.items()}
        return FTensor(self.name, ranks, self.root, shapes, self.default,
                       {mapping.get(r, r) for r in self.upper_ranks})


# ---------------------------------------------------------------------- #
# boundary helpers
# ---------------------------------------------------------------------- #
def _shape_boundaries(fiber: Fiber, size: int) -> List[Coord]:
    if not fiber.coords:
        return []
    last = fiber.coords[-1]
    if isinstance(last, tuple):
        raise ValueError("uniform_shape cannot partition flattened ranks")
    return [i * size for i in range(int(last) // size + 1)]


def _occupancy_boundaries(fiber: Fiber, size: int) -> List[Coord]:
    """First coordinate of each occupancy-``size`` chunk of ``fiber``."""
    return [fiber.coords[i] for i in range(0, len(fiber.coords), size)]
