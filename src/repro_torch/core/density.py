"""Per-rank occupancy / density models for the analytic backend.

Sparseloop (Wu et al.) showed that statistical density models make
execution-based evaluation of sparse accelerators *analytical*: instead
of walking every nonzero, propagate the expected fiber occupancy at
each rank of each tensor through the mapped loop nest.  This module
provides the distributions; ``core/analytic.py`` does the propagation.

Three occupancy models, all describing a tensor in a given rank order
as one ``LevelStats`` per rank (number of fibers at that level, total
elements, coordinate domain):

  * ``uniform``        -- i.i.d. Bernoulli(p) nonzeros: the occupancy of
                          a fiber at rank d is ``shape_d`` times the
                          probability that a subtree below is nonempty.
  * ``hypergeometric`` -- exactly ``nnz`` nonzeros placed uniformly
                          without replacement (fixed-budget sampling);
                          expectations via the hypergeometric inclusion
                          probability, computed in log space.
  * ``calibrated``     -- exact per-level totals from a one-pass scan of
                          a real tensor's CSF arrays (`len(coords[d])`
                          per level).  Expected counts derived from
                          calibrated stats are *exact* whenever the
                          analytic frontier covers every fiber of the
                          tensor (single-driver / dense-rank plans);
                          they are unbiased estimates under
                          intersection (see DESIGN.md).

``mean_field_levels`` rebuilds per-level stats for an arbitrary rank
order from (nnz, per-var marginals) -- the statistical bridge used for
cascade intermediates that the analytic backend never materializes.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .fibertree import Fiber, FTensor


# ---------------------------------------------------------------------- #
# small combinatorial helpers
# ---------------------------------------------------------------------- #
def expected_distinct(domain: float, balls: float) -> float:
    """Expected number of distinct bins hit when ``balls`` balls land
    i.i.d. uniformly in ``domain`` bins: D * (1 - (1 - 1/D)^balls)."""
    if domain <= 0 or balls <= 0:
        return 0.0
    if domain <= 1:
        return 1.0
    # stable for large domain / small balls
    return domain * -math.expm1(balls * math.log1p(-1.0 / domain))


def occupancy_overlap(occ_a: float, occ_b: float, domain: float) -> float:
    """E[|A ∩ B|] for two independent uniform subsets of sizes occ_a,
    occ_b drawn from a domain of ``domain`` coordinates (the
    hypergeometric expectation n*K/N)."""
    if domain <= 0:
        return 0.0
    return min(occ_a * occ_b / domain, occ_a, occ_b)


def union_size(occ_a: float, occ_b: float, domain: float) -> float:
    """E[|A ∪ B|] under the same model."""
    return occ_a + occ_b - occupancy_overlap(occ_a, occ_b, domain)


def affine_span(terms: Sequence[Tuple[str, int]], const: float,
                var_shapes: Dict[str, float]) -> Tuple[float, float]:
    """[lo, hi] range of ``const + sum(coeff * v)`` when each var ``v``
    sweeps [0, shape_v); the probe span of an affine index map."""
    lo = hi = float(const)
    for v, cf in terms:
        s = max(float(var_shapes.get(v) or 1.0), 1.0)
        ext = float(cf) * (s - 1.0)
        if ext >= 0:
            hi += ext
        else:
            lo += ext
    return lo, hi


def affine_hit_fraction(terms: Sequence[Tuple[str, int]], const: float,
                        var_shapes: Dict[str, float],
                        domain: float) -> float:
    """Expected fraction of affine probes that land inside the target
    coordinate domain [0, domain) -- the halo / boundary-occupancy
    correction for affine-shifted lookups (e.g. conv's ``h = p + r``
    against an input of height H).

    Model: the probe value is uniform over its span [lo, hi] (exact for
    a single unit-coefficient term; a boundary-linear approximation for
    multi-term sums).  Valid-padding conv (H = P + R - 1) gives exactly
    1.0; shifted or cropped windows shed the out-of-range halo."""
    lo, hi = affine_span(terms, const, var_shapes)
    width = hi - lo + 1.0
    if width <= 0:
        return 0.0
    if domain <= 0:
        return 1.0                       # unknown domain: no correction
    overlap = min(hi + 1.0, domain) - max(lo, 0.0)
    return max(0.0, min(overlap / width, 1.0))


def stat_misses(n: float, unique: float, nbytes: float,
                capacity_bytes: float) -> float:
    """Expected misses of an aggregate touch under the Sparseloop-style
    statistical residency model: ``unique`` compulsory misses, plus --
    when the touched footprint exceeds capacity -- capacity misses on
    the reuse accesses proportional to the non-resident fraction of the
    working set.  The single scalar closed form shared by
    ``components.StorageLevel.touch_stat`` and its point-axis
    vectorization below (both must stay bit-identical)."""
    footprint = unique * nbytes
    misses = float(unique)
    if footprint > capacity_bytes and n > unique:
        misses += (n - unique) * (1.0 - capacity_bytes / footprint)
    return misses


def batched_stat_misses(n: float, unique: float, nbytes, capacity_bytes):
    """``stat_misses`` broadcast across a *point axis*: ``nbytes`` and
    ``capacity_bytes`` are arrays with one entry per design point (the
    swept scalar params -- e.g. a FiberCache capacity axis), evaluated
    in one numpy pass instead of a Python loop per point.

    Bit-identity contract: every arithmetic op mirrors the scalar
    closed form exactly (same +,-,*,/ on float64; no transcendentals),
    so ``batched_stat_misses(n, u, b, caps)[i] == stat_misses(n, u,
    b[i], caps[i])`` bitwise -- asserted by a parity test."""
    import numpy as np
    nbytes = np.asarray(nbytes, dtype=np.float64)
    caps = np.asarray(capacity_bytes, dtype=np.float64)
    footprint = unique * nbytes
    base = np.full(np.broadcast(footprint, caps).shape, float(unique))
    if n <= unique:
        return base
    with np.errstate(divide="ignore", invalid="ignore"):
        reuse = (n - unique) * (1.0 - caps / footprint)
    return np.where(footprint > caps, base + reuse, base)


def _log_nonempty_prob(inner: float, nnz: float, total: float) -> float:
    """log P(a block of ``inner`` positions holds >= 1 of ``nnz``
    nonzeros placed without replacement among ``total`` positions):
    1 - C(total - inner, nnz) / C(total, nnz)."""
    if nnz <= 0 or total <= 0 or inner >= total:
        return 0.0 if nnz > 0 and inner >= total else -math.inf
    # log C(total-inner, nnz) - log C(total, nnz)
    #   = sum_{i=0..nnz-1} log((total-inner-i) / (total-i))
    if total - inner < nnz:
        return 0.0                      # guaranteed nonempty
    lg = (math.lgamma(total - inner + 1) - math.lgamma(total - inner - nnz + 1)
          - math.lgamma(total + 1) + math.lgamma(total - nnz + 1))
    p_empty = math.exp(lg)
    return math.log1p(-p_empty) if p_empty < 1.0 else -math.inf


# ---------------------------------------------------------------------- #
# the stats records
# ---------------------------------------------------------------------- #
@dataclass
class LevelStats:
    """Occupancy statistics of one rank (level) of a tensor in a fixed
    rank order.  ``fibers`` is the expected number of fibers at this
    level (== elements at the level above, 1 at the root); ``elems`` the
    expected total number of coordinates across those fibers."""
    rank: str
    fibers: float
    elems: float
    domain: float                        # coordinate domain size

    @property
    def occupancy(self) -> float:
        """Expected coordinates per fiber, conditioned on the fiber
        existing."""
        return self.elems / self.fibers if self.fibers > 0 else 0.0


@dataclass
class TensorDensity:
    """Per-level occupancy stats of one tensor in one rank order, plus
    the order-independent summary (nnz, per-var marginals) used to
    re-derive stats for other rank orders."""
    name: str
    ranks: List[str]
    levels: List[LevelStats]
    nnz: float
    #: var -> expected number of distinct coordinates of that var
    marginals: Dict[str, float] = field(default_factory=dict)
    #: var -> coordinate domain size
    domains: Dict[str, float] = field(default_factory=dict)
    #: rank name -> expected per-fiber occupancy of that rank (carried
    #: across reorderings of predicted intermediates, where rank names
    #: -- including partition-created ones -- are shared between the
    #: producing and consuming plans)
    rank_marginals: Dict[str, float] = field(default_factory=dict)
    #: source tensors this tensor's structure was computed from
    #: (transitively); used to flag correlated intersections
    derived_from: frozenset = frozenset()

    def occ(self, depth: int) -> float:
        return self.levels[depth].occupancy

    def domain(self, depth: int) -> float:
        return self.levels[depth].domain

    # ------------------------------------------------------------------ #
    # calibrated: one-pass scan of real data
    # ------------------------------------------------------------------ #
    @staticmethod
    def calibrated(ft: "FTensor | Any",
                   var_map: Optional[Dict[str, Tuple[str, ...]]] = None,
                   var_shapes: Optional[Dict[str, float]] = None
                   ) -> "TensorDensity":
        """Exact per-level element totals from one pass over the tensor.

        Accepts an ``FTensor`` (walked once) or a ``CSF`` (read off the
        level arrays directly)."""
        from .csf import CSF                      # local: avoid cycle
        if isinstance(ft, CSF):
            name, ranks = ft.name, list(ft.ranks)
            per_level = [float(len(ft.coords[d])) for d in range(ft.ndim)]
            shapes = dict(ft.rank_shapes)
        else:
            name, ranks = ft.name, list(ft.ranks)
            per_level = [0.0] * len(ranks)

            def walk(fiber: Fiber, depth: int) -> None:
                per_level[depth] += len(fiber)
                if depth + 1 < len(ranks):
                    for _, child in fiber:
                        walk(child, depth + 1)

            if ranks:
                walk(ft.root, 0)
            shapes = dict(ft.rank_shapes)
        levels: List[LevelStats] = []
        fibers = 1.0
        for d, r in enumerate(ranks):
            dom = _rank_domain(r, shapes.get(r), var_map, var_shapes)
            levels.append(LevelStats(r, fibers, per_level[d], dom))
            fibers = per_level[d]
        nnz = per_level[-1] if per_level else 0.0
        return TensorDensity(name, ranks, levels, nnz,
                             marginals=_marginals_from_levels(
                                 ranks, levels, var_map),
                             domains=_domains_from_levels(
                                 ranks, levels, var_map))

    # ------------------------------------------------------------------ #
    # statistical models
    # ------------------------------------------------------------------ #
    @staticmethod
    def uniform(name: str, ranks: Sequence[str],
                shapes: Sequence[float], density: float,
                var_map: Optional[Dict[str, Tuple[str, ...]]] = None
                ) -> "TensorDensity":
        """i.i.d. Bernoulli(density) nonzeros over the dense shape."""
        density = min(max(density, 0.0), 1.0)
        ranks = list(ranks)
        levels: List[LevelStats] = []
        fibers = 1.0
        inner = [float(math.prod(shapes[d + 1:])) for d in range(len(ranks))]
        for d, r in enumerate(ranks):
            # P(a coordinate at this level is present) given its prefix
            # exists: 1 - (1-p)^(inner positions)
            if density >= 1.0:
                p_nonempty = 1.0
            else:
                p_nonempty = -math.expm1(inner[d] * math.log1p(-density)) \
                    if inner[d] > 0 else density
            elems = fibers * shapes[d] * p_nonempty
            levels.append(LevelStats(r, fibers, elems, float(shapes[d])))
            fibers = elems
        nnz = float(math.prod(shapes)) * density
        if levels:
            levels[-1] = LevelStats(levels[-1].rank, levels[-1].fibers,
                                    nnz, levels[-1].domain)
        return TensorDensity(name, ranks, levels, nnz,
                             marginals=_marginals_from_levels(
                                 ranks, levels, var_map),
                             domains=_domains_from_levels(
                                 ranks, levels, var_map))

    @staticmethod
    def hypergeometric(name: str, ranks: Sequence[str],
                       shapes: Sequence[float], nnz: float,
                       var_map: Optional[Dict[str, Tuple[str, ...]]] = None
                       ) -> "TensorDensity":
        """Exactly ``nnz`` nonzeros placed uniformly without
        replacement over the dense shape."""
        ranks = list(ranks)
        total = float(math.prod(shapes)) if shapes else 0.0
        nnz = min(float(nnz), total)
        levels: List[LevelStats] = []
        fibers = 1.0
        for d, r in enumerate(ranks):
            inner = float(math.prod(shapes[d + 1:]))
            lp = _log_nonempty_prob(inner, nnz, total)
            p_nonempty = math.exp(lp) if lp > -math.inf else 0.0
            # expected distinct prefixes of length d+1 across the whole
            # tensor; per-fiber occupancy follows by dividing by fibers
            n_prefix = float(math.prod(shapes[:d + 1]))
            elems = n_prefix * p_nonempty
            levels.append(LevelStats(r, fibers, elems, float(shapes[d])))
            fibers = elems
        if levels:
            levels[-1] = LevelStats(levels[-1].rank, levels[-1].fibers,
                                    nnz, levels[-1].domain)
        return TensorDensity(name, ranks, levels, nnz,
                             marginals=_marginals_from_levels(
                                 ranks, levels, var_map),
                             domains=_domains_from_levels(
                                 ranks, levels, var_map))

    # ------------------------------------------------------------------ #
    # reorder / re-derive (mean field)
    # ------------------------------------------------------------------ #
    def renamed(self, name: str, extra_source: Optional[str] = None
                ) -> "TensorDensity":
        """Deep-ish copy under a new tensor name, optionally recording
        one more provenance source (whole-tensor alias/copy)."""
        derived = self.derived_from
        if extra_source is not None:
            derived = derived | frozenset([extra_source])
        return TensorDensity(name, list(self.ranks), list(self.levels),
                             self.nnz, dict(self.marginals),
                             dict(self.domains), dict(self.rank_marginals),
                             derived)

    def project(self, ranks: Sequence[str],
                var_map: Dict[str, Tuple[str, ...]],
                var_shapes: Dict[str, float]) -> "TensorDensity":
        """Stats for a *different* rank order of the same content, via
        the mean-field model (exact totals are order-dependent; this is
        the documented statistical bridge for predicted intermediates
        and online-swizzled tensors)."""
        if list(ranks) == self.ranks:
            return self
        return mean_field_density(self.name, ranks, var_map, self.nnz,
                                  self.marginals, self.domains or
                                  {v: var_shapes.get(v, 0.0)
                                   for v in var_shapes},
                                  rank_marginals=self.rank_marginals,
                                  derived_from=self.derived_from)


# ---------------------------------------------------------------------- #
def _rank_domain(rank: str, shape: Any,
                 var_map: Optional[Dict[str, Tuple[str, ...]]],
                 var_shapes: Optional[Dict[str, float]]) -> float:
    if isinstance(shape, (int, float)) and shape:
        return float(shape)
    if var_map and var_shapes:
        vars_ = var_map.get(rank, (rank.lower(),))
        dom = 1.0
        known = False
        for v in vars_:
            s = var_shapes.get(v)
            if s:
                dom *= float(s)
                known = True
        if known:
            return dom
    return 0.0


def _marginals_from_levels(ranks: Sequence[str], levels: List[LevelStats],
                           var_map: Optional[Dict[str, Tuple[str, ...]]]
                           ) -> Dict[str, float]:
    """Distinct-coordinate estimate per index var: the occupancy of the
    var's *outermost* level (distinct values across the whole tensor
    approximated by the first level that spans the var)."""
    out: Dict[str, float] = {}
    for r, lv in zip(ranks, levels):
        vars_ = (var_map or {}).get(r, (r.lower(),))
        for v in vars_:
            if v not in out:
                out[v] = max(lv.elems, 1.0) if lv.elems > 0 else 0.0
    return out


def _domains_from_levels(ranks: Sequence[str], levels: List[LevelStats],
                         var_map: Optional[Dict[str, Tuple[str, ...]]]
                         ) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for r, lv in zip(ranks, levels):
        vars_ = (var_map or {}).get(r, (r.lower(),))
        if len(vars_) == 1 and lv.domain:
            out.setdefault(vars_[0], lv.domain)
    return out


def mean_field_density(name: str, ranks: Sequence[str],
                       var_map: Dict[str, Tuple[str, ...]],
                       nnz: float, var_marginals: Dict[str, float],
                       var_domains: Dict[str, float],
                       rank_marginals: Optional[Dict[str, float]] = None,
                       derived_from: frozenset = frozenset()
                       ) -> TensorDensity:
    """Build per-level stats for an arbitrary rank order from the
    order-independent summary (nnz + marginals).

    Walks the ranks outer->inner keeping U = expected leaves below one
    fiber; the occupancy at each level is the expected number of
    distinct coordinates among U leaves whose coordinate is uniform
    over the rank's available values.  A per-rank marginal (known
    per-fiber occupancy of the same rank name in another order, e.g. a
    partition-created M0 of width 32) takes precedence; otherwise vars
    that span several ranks split their var marginal evenly in log
    space across the occurrences."""
    ranks = list(ranks)
    rank_marginals = rank_marginals or {}
    occur: Dict[str, int] = {}
    for r in ranks:
        for v in var_map.get(r, (r.lower(),)):
            occur[v] = occur.get(v, 0) + 1
    levels: List[LevelStats] = []
    fibers = 1.0
    U = max(nnz, 0.0)
    for r in ranks:
        vars_ = var_map.get(r, (r.lower(),))
        dom = rank_marginals.get(r)
        if dom is None:
            dom = 1.0
            for v in vars_:
                m = var_marginals.get(v, var_domains.get(v, 1.0))
                k = occur.get(v, 1)
                dom *= max(m ** (1.0 / k), 1.0) if m > 0 else 1.0
        occ = min(expected_distinct(dom, U), U) if U > 0 else 0.0
        occ = max(occ, 1.0) if U > 0 else 0.0
        elems = fibers * occ
        levels.append(LevelStats(r, fibers, elems, dom))
        fibers = elems
        U = U / occ if occ > 0 else 0.0
    if levels and nnz > 0:
        levels[-1] = LevelStats(levels[-1].rank, levels[-1].fibers,
                                max(nnz, levels[-1].fibers),
                                levels[-1].domain)
    return TensorDensity(name, ranks, levels,
                         levels[-1].elems if levels else 0.0,
                         marginals=dict(var_marginals),
                         domains=dict(var_domains),
                         rank_marginals=dict(rank_marginals),
                         derived_from=derived_from)
