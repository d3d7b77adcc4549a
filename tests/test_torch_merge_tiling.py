"""The partitions of the merge kernels, modelled in numpy and held to the
plain versions.

``csrc/merge_path.cu`` and ``csrc/multi_merge.cu`` cannot run here, so
this file states, step for step, how they cut their work:

* ``merge_path_model``: tiles of ``threads x items`` outputs; a tile's
  bounds are the merge-path splits of its first and its end diagonal,
  each found by a warp's 32-way search with the predicate a[i] <= b[d - 1
  - i] (a first on ties); each thread's split inside the tile's window by
  a binary search with the same predicate, then its ``items`` outputs.
* ``multi_merge_model``: blocks of ``threads x per`` elements of one row,
  mapped to (row, start) from the offsets 32 rows at a time, ceil(total /
  block) + k blocks launched; for every other row the window between the
  bounds of the block's first and last key (upper bound for rows before,
  lower for rows after, each by a warp's many-way search), counted
  through chunks in shared memory by branch-free binary searches or,
  past ``dense`` keys, through a splitter sample.

The models take the kernels' constants from their sources and also
smaller tiles, so that small inputs cross many tile edges.  The same
input generator drives the card tests (``tests/test_torch_cuda.py``).
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from _hyp import given, settings, st

from repro_torch.kernels import merge_path_plain, multi_merge_ranks_plain

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / \
    "kernels" / "csrc"
I32_MAX = (1 << 31) - 1
#: key domains: duplicate-heavy, around INT32_MAX, around 2^62, wide
DOMAINS = {"dense": (0, 24), "i32": (I32_MAX - 40, I32_MAX + 40),
           "i64": ((1 << 62) - 60, (1 << 62) + 60), "wide": (0, 1 << 62)}


def kernel_constants(source: str) -> dict:
    """The ``constexpr`` integers of ``csrc/<source>``, evaluated."""
    out = {}
    for name, expr in re.findall(
            r"constexpr (?:int|int64_t) (\w+) = ([^;]+);",
            (CSRC / source).read_text()):
        out[name] = int(eval(expr.replace("/", "//"), {}, dict(out)))
    return out


MERGE = kernel_constants("merge_path.cu")
MULTI = kernel_constants("multi_merge.cu")
#: (threads, items) of merge_path's tiles: the kernel's and small ones
#: (threads, items, probes a level of a tile split) of merge_path's
#: tiles: the kernel's and small ones
MERGE_TILES = [(MERGE["kThreads"], MERGE["kItems"], MERGE["kWays"]),
               (4, 2, 32), (2, 3, 64), (8, 4, 128), (1, 1, 32)]
#: (threads, per, chunk keys, densest streamed window, other rows a step,
#: probes a level of a window's search) of multi_merge_ranks' blocks
MULTI_TILES = [(MULTI["kThreads"], MULTI["kPer"], MULTI["kKeys"],
                MULTI["kDense"], MULTI["kGroup"], MULTI["kWays"]),
               (4, 2, 4, 8, 1, 32), (2, 2, 2, 4, 2, 64),
               (8, 1, 3, 6, 4, 128)]


def sorted_rows(rng, k: int, n_max: int, domain: str):
    """``k`` sorted int64 rows from ``DOMAINS[domain]``: empty, one key,
    short, long, or a few keys in long runs; keys repeat within a row
    and across rows (drawn with replacement)."""
    lo, hi = DOMAINS[domain]
    rows = []
    for _ in range(k):
        kind = int(rng.integers(0, 6))
        if kind == 5:                                # runs of equal keys
            vals = np.sort(rng.integers(lo, hi, size=3, dtype=np.int64))
            rows.append(np.repeat(vals, rng.integers(1, n_max + 1, size=3)))
            continue
        n = (0, 1, int(rng.integers(2, max(n_max, 2) + 1)),
             int(rng.integers(2, max(n_max // 8, 2) + 1)), n_max)[kind]
        rows.append(np.sort(rng.integers(lo, hi, size=n, dtype=np.int64)))
    return rows


# ---------------------------------------------------------------------- #
# partition.cuh
# ---------------------------------------------------------------------- #
def warp_partition(lo: int, hi: int, pred, ways: int) -> int:
    """``part::warp_partition<ways>``: ``ways`` probes a level."""
    while hi - lo > ways:
        step = (hi - lo + ways - 1) // ways
        held = [lo + q * step < hi and bool(pred(lo + q * step))
                for q in range(ways)]
        cnt = sum(held)
        assert held == [True] * cnt + [False] * (ways - cnt), "not a prefix"
        new_lo = lo if cnt == 0 else lo + (cnt - 1) * step + 1
        hi = min(lo + cnt * step, hi)
        lo = new_lo
    return lo + sum(lo + q < hi and bool(pred(lo + q)) for q in range(ways))


def partition(lo: int, hi: int, pred) -> int:
    """``part::partition``: a binary search."""
    while lo < hi:
        mid = lo + ((hi - lo) >> 1)
        if pred(mid):
            lo = mid + 1
        else:
            hi = mid
    return lo


def point(s, at: int, ln: int, pred) -> int:
    """``point``: the first i in [at, at + ln) where ``pred(s[i])``
    fails (at + ln if none), by a branch-free binary search whose steps
    depend on ln alone."""
    while ln > 1:
        half = ln >> 1
        if pred(s[at + half - 1]):
            at += half
        ln -= half
    return at + bool(pred(s[at])) if ln == 1 else at


# ---------------------------------------------------------------------- #
# the kernels' decompositions
# ---------------------------------------------------------------------- #
def merge_path_model(a: np.ndarray, b: np.ndarray, threads: int,
                     items: int, ways: int):
    """``merge_path_kernel``'s outputs (merged keys, int8 flags)."""
    n, m = len(a), len(b)
    total, tile = n + m, threads * items
    merged = np.full(total, -1, dtype=np.int64)
    src = np.full(total, -1, dtype=np.int8)

    def split(d):                   # a's among the first d outputs
        return warp_partition(max(0, d - m), min(d, n),
                              lambda x: a[x] <= b[d - 1 - x], ways)

    for d0 in range(0, total, tile):
        ln = min(tile, total - d0)
        i0, i1 = split(d0), split(d0 + ln)
        j0, na = d0 - i0, i1 - i0
        nb = ln - na
        assert 0 <= na <= ln and j0 + nb == d0 + ln - i1 <= m
        win = np.concatenate([a[i0:i1], b[j0:j0 + nb]])
        sa, sb = win[:na], win[na:]
        for t in range(threads):
            dl = t * items
            if dl >= ln:
                break
            i = partition(max(0, dl - nb), min(dl, na),
                          lambda x: sa[x] <= sb[dl - 1 - x])
            j = dl - i
            for s in range(dl, min(dl + items, ln)):
                take_a = i < na and (j >= nb or sa[i] <= sb[j])
                assert merged[d0 + s] == -1 and src[d0 + s] == -1
                merged[d0 + s] = sa[i] if take_a else sb[j]
                src[d0 + s] = 0 if take_a else 1
                i, j = (i + 1, j) if take_a else (i, j + 1)
    return merged, src


def _takes(x, e, upper: bool) -> bool:
    return x <= e if upper else x < e


def block_map(offs: np.ndarray, block: int, bid: int):
    """Warp 0's map of block ``bid`` to (row, first element), 32 rows a
    step; (-1, 0) past the last row's blocks."""
    k, before = len(offs) - 1, 0
    for c in range(0, k, 32):
        js = np.arange(c, min(c + 32, k))
        nb = (offs[js + 1] - offs[js] + block - 1) // block
        firsts = before + np.cumsum(nb) - nb
        hit = np.flatnonzero((firsts <= bid) & (bid < firsts + nb))
        if len(hit):
            q = int(hit[0])
            return c + q, int(offs[c + q] + (bid - firsts[q]) * block)
        before += int(nb.sum())
    return -1, 0


def multi_merge_model(keys: np.ndarray, offs: np.ndarray, threads: int,
                      per: int, chunk: int, dense: int, group: int,
                      ways: int):
    """``multi_merge_kernel``'s ranks, and how many windows it streamed
    and how many it sampled."""
    k, total = len(offs) - 1, int(offs[-1])
    block = threads * per
    ranks = np.full(total, -1, dtype=np.int64)
    taken = {"streamed": 0, "sampled": 0}
    for bid in range((total + block - 1) // block + k):
        r, base = block_map(offs, block, bid)
        if r < 0:
            continue
        cnt = min(block, int(offs[r + 1]) - base)
        first, last = keys[base], keys[base + cnt - 1]
        rank = {g: g - int(offs[r]) for g in range(base, base + cnt)}
        # the other rows, ``group`` at a time
        others = [j for j in range(k) if j != r]
        for g0 in range(0, k - 1, group):
            wins = {}
            for j in others[g0:g0 + group]:
                upper = j < r
                wins[j] = tuple(warp_partition(
                    int(offs[j]), int(offs[j + 1]),
                    lambda i, p=p: _takes(keys[i], p, upper), ways)
                    for p in (first, last))
            for j, (lo, hi) in wins.items():
                upper = j < r
                for g in rank:
                    rank[g] += lo - int(offs[j])
                if hi - lo <= dense:
                    taken["streamed"] += lo < hi
                    for c0 in range(lo, hi, chunk):
                        s_k = keys[c0:min(c0 + chunk, hi)]
                        for g in rank:
                            rank[g] += point(s_k, 0, len(s_k),
                                             lambda x, e=keys[g]:
                                             _takes(x, e, upper))
                else:
                    taken["sampled"] += 1
                    step = (hi - lo + chunk - 1) // chunk
                    s_k = keys[lo:hi:step]
                    assert len(s_k) <= chunk
                    for g in rank:
                        e = keys[g]
                        js = partition(0, len(s_k),
                                       lambda i: _takes(s_k[i], e, upper))
                        a = lo if js == 0 else lo + (js - 1) * step + 1
                        pos = partition(a, min(lo + js * step, hi),
                                        lambda i: _takes(keys[i], e, upper))
                        rank[g] += pos - lo
        for g, v in rank.items():
            assert ranks[g] == -1, "two blocks wrote one element"
            ranks[g] = v
    return ranks, taken


def _merge_case(rows, tiles):
    a, b = rows
    want_m, want_s = merge_path_plain(torch.from_numpy(a),
                                      torch.from_numpy(b))
    got_m, got_s = merge_path_model(a, b, *tiles)
    np.testing.assert_array_equal(got_m, want_m.numpy())
    np.testing.assert_array_equal(got_s, want_s.numpy())


def _multi_case(rows, tiles):
    keys = np.concatenate(rows).astype(np.int64)
    offs = np.cumsum([0] + [len(r) for r in rows]).astype(np.int64)
    want = multi_merge_ranks_plain(torch.from_numpy(keys),
                                   torch.from_numpy(offs))
    got, ways = multi_merge_model(keys, offs, *tiles)
    np.testing.assert_array_equal(got, want.numpy())
    return ways


# ---------------------------------------------------------------------- #
# tests
# ---------------------------------------------------------------------- #
def test_models_take_the_kernels_constants():
    assert MERGE["kTile"] == MERGE["kThreads"] * MERGE["kItems"] == 512
    assert MULTI["kBlock"] == MULTI["kThreads"] * MULTI["kPer"] == 1024
    # one warp for each end of each window of a step; whole loads a chunk
    assert 2 * MULTI["kGroup"] * 32 <= MULTI["kThreads"]
    assert MULTI["kLoads"] * MULTI["kThreads"] == MULTI["kKeys"]
    assert MULTI["kDense"] == 4 * MULTI["kKeys"]
    assert MERGE["kWays"] % 32 == 0 and MULTI["kWays"] % 32 == 0


@settings(max_examples=40, deadline=None)
@given(lo=st.integers(0, 300), width=st.integers(0, 300),
       seed=st.integers(0, 2 ** 31))
def test_partition_helpers_agree_with_searchsorted(lo, width, seed):
    rng = np.random.default_rng(seed)
    hay = np.sort(rng.integers(0, 50, size=lo + width))
    p = int(rng.integers(-1, 51))
    hi = lo + width

    def pred_key(x, side):
        return x < p if side == "left" else x <= p

    for side, pred in (("left", lambda i: hay[i] < p),
                       ("right", lambda i: hay[i] <= p)):
        want = lo + int(np.searchsorted(hay[lo:hi], p, side=side))
        for ways in (32, 128):
            assert warp_partition(lo, hi, pred, ways) == want
        assert partition(lo, hi, pred) == want
        assert point(hay, lo, width, lambda x: pred_key(x, side)) == want


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2 ** 31), n_max=st.integers(1, 300),
       domain=st.sampled_from(sorted(DOMAINS)),
       tiles=st.sampled_from(MERGE_TILES))
def test_merge_path_tiling_matches_plain(seed, n_max, domain, tiles):
    _merge_case(sorted_rows(np.random.default_rng(seed), 2, n_max, domain),
                tiles)


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2 ** 31), k=st.integers(3, 8),
       n_max=st.integers(1, 120), domain=st.sampled_from(sorted(DOMAINS)),
       tiles=st.sampled_from(MULTI_TILES))
def test_multi_merge_tiling_matches_plain(seed, k, n_max, domain, tiles):
    _multi_case(sorted_rows(np.random.default_rng(seed), k, n_max, domain),
                tiles)


@pytest.mark.parametrize("domain", ["dense", "wide"])
def test_merge_path_tiling_at_the_main_paths_size(domain):
    """6,250 + 6,250 keys, a quarter of them shared, at the kernel's
    tiles (25 of them); in the dense domain runs of equal keys cross
    every tile edge."""
    rng = np.random.default_rng(7)
    lo, hi = DOMAINS[domain]
    a = np.sort(rng.integers(lo, hi, size=6250))
    b = np.sort(np.concatenate([rng.integers(lo, hi, size=4688),
                                a[::4][:1562]]))
    _merge_case([a, b], MERGE_TILES[0])


def test_multi_merge_tiling_at_the_main_paths_size():
    """3 rows of 6,250 keys sharing keys, at the kernel's blocks: every
    window streams through shared memory."""
    rng = np.random.default_rng(8)
    rows = [np.sort(rng.integers(0, 1 << 40, size=6250)) for _ in range(3)]
    rows[1] = np.sort(np.concatenate([rows[1][:-1000], rows[0][::6][:1000]]))
    rows[2] = np.sort(np.concatenate([rows[2][:-1000], rows[0][::5][:1000]]))
    ways = _multi_case(rows, MULTI_TILES[0])
    assert ways["streamed"] > 0 and ways["sampled"] == 0


def test_multi_merge_tiling_samples_dense_rows():
    """A row much denser than the block's over its key range goes
    through the splitter sample, at the kernel's constants and at small
    ones; duplicates at the window's ends included."""
    rng = np.random.default_rng(9)
    dense = np.sort(rng.integers(0, 1 << 20, size=20_000))
    sparse = np.sort(np.concatenate([dense[[0, 5000, 19_999]],
                                     rng.integers(0, 1 << 20, size=40)]))
    rows = [sparse, dense, sparse.copy()]
    for tiles in (MULTI_TILES[0], MULTI_TILES[1]):
        ways = _multi_case(rows, tiles)
        assert ways["sampled"] > 0


@pytest.mark.parametrize("k", [33, 40])
def test_multi_merge_block_map_past_32_rows(k):
    """More than 32 rows: warp 0 maps blocks in two steps; empty rows
    take no block, and every element is ranked once."""
    rng = np.random.default_rng(k)
    rows = sorted_rows(rng, k, 9, "dense")
    _multi_case(rows, MULTI_TILES[1])
    offs = np.cumsum([0] + [len(r) for r in rows])
    maps = [block_map(offs, 8, bid)
            for bid in range((offs[-1] + 7) // 8 + k)]
    starts = sorted(s for r, s in maps if r >= 0)
    want = sorted(int(o) + c for o, n in zip(offs[:-1], np.diff(offs))
                  for c in range(0, int(n), 8))
    assert starts == want
