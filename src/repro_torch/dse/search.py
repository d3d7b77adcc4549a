"""Gradient-free search over a design space.

Exhaustive grids stop scaling once a few axes multiply out; these
optimizers walk the space instead, consuming the ordinary
``PointResult`` stream from a :class:`~repro_torch.dse.engine.SweepEngine`.
Both are deliberately cache-shaped: every generation/rung is evaluated
through ``engine.sweep``, so

  * points sharing a mapping signature share one probe (batched
    analytic evaluation), and
  * re-visited configurations -- elites carried between generations,
    survivors promoted between rungs -- hit the engine's
    :class:`~repro_torch.dse.cache.ResultCache` instead of the backend.

Failed / timed-out points get an infinite objective: faults steer the
search away rather than crashing it.

:class:`EvolutionarySearch` -- fixed-budget genetic search: tournament
selection, uniform crossover, per-gene mutation, elite carry-over.

:class:`HalvingSearch` -- successive halving across fidelity rungs:
a wide random cohort is scored on a cheap engine and the top ``1/eta``
fraction is promoted to the next (more exact / more expensive) engine.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

from .engine import PointResult, SweepEngine
from .space import DesignPoint, DesignSpace

Objective = Union[str, Callable[[PointResult], float]]


def _objective_value(res: PointResult, objective: Objective) -> float:
    if not res.ok:
        return math.inf
    v = objective(res) if callable(objective) else getattr(res, objective)
    v = float(v)
    return v if math.isfinite(v) else math.inf


@dataclass
class SearchResult:
    """Outcome of one search run."""
    best: Optional[PointResult]          #: best ok result (None if none)
    best_value: float                    #: its objective (inf if none)
    evaluations: int                     #: engine queries issued
    history: List[Tuple[str, float]] = field(default_factory=list)
    #: per-round best objective, for convergence plots / tests
    trajectory: List[float] = field(default_factory=list)


class _Genome:
    """A design-space configuration as per-axis value indices --
    crossover and mutation operate on indices, so every offspring is a
    legal grid member by construction."""

    def __init__(self, space: DesignSpace):
        self.space = space
        self.kw_keys = list(space.axes)
        self.p_keys = list(space.param_axes)
        self.sizes = [len(space.axes[k]) for k in self.kw_keys] + \
                     [len(space.param_axes[k]) for k in self.p_keys]

    def random(self, rng: random.Random) -> Tuple[int, ...]:
        return tuple(rng.randrange(max(s, 1)) for s in self.sizes)

    def mutate(self, g: Tuple[int, ...], rate: float,
               rng: random.Random) -> Tuple[int, ...]:
        out = list(g)
        for i, s in enumerate(self.sizes):
            if s > 1 and rng.random() < rate:
                out[i] = rng.randrange(s)
        return tuple(out)

    def crossover(self, a: Tuple[int, ...], b: Tuple[int, ...],
                  rng: random.Random) -> Tuple[int, ...]:
        return tuple(x if rng.random() < 0.5 else y for x, y in zip(a, b))

    def point(self, g: Tuple[int, ...]) -> DesignPoint:
        nk = len(self.kw_keys)
        kw = {k: self.space.axes[k][g[i]]
              for i, k in enumerate(self.kw_keys)}
        params = {k: self.space.param_axes[k][g[nk + i]]
                  for i, k in enumerate(self.p_keys)}
        return self.space.point(kw, params)


class EvolutionarySearch:
    """Fixed-budget genetic search for the objective-minimizing point.

    Each generation is evaluated through one ``engine.sweep`` call;
    elites re-appear verbatim in the next generation and are served
    from the result cache, so the marginal cost of a generation is
    only its genuinely new configurations.
    """

    def __init__(self, space: DesignSpace, engine: SweepEngine, *,
                 population: int = 16, generations: int = 8,
                 elite: int = 2, mutation: float = 0.25,
                 tournament: int = 3, seed: int = 0,
                 objective: Objective = "seconds"):
        if population < 2:
            raise ValueError("population must be >= 2")
        if not 0 < elite < population:
            raise ValueError("elite must be in (0, population)")
        self.space = space
        self.engine = engine
        self.population = population
        self.generations = generations
        self.elite = elite
        self.mutation = mutation
        self.tournament = tournament
        self.seed = seed
        self.objective = objective

    def run(self) -> SearchResult:
        rng = random.Random(self.seed)
        genome = _Genome(self.space)
        pop = []
        seen = set()
        while len(pop) < self.population:
            g = genome.random(rng)
            if g not in seen or len(seen) >= self.space.size:
                seen.add(g)
                pop.append(g)

        out = SearchResult(best=None, best_value=math.inf, evaluations=0)
        for _ in range(self.generations):
            points = [genome.point(g) for g in pop]
            results = self.engine.sweep(points)
            out.evaluations += len(points)
            by_label = {r.label: r for r in results}
            scored = []
            for g, p in zip(pop, points):
                res = by_label[p.label]
                val = _objective_value(res, self.objective)
                scored.append((val, g, res))
                out.history.append((p.label, val))
                if val < out.best_value:
                    out.best_value, out.best = val, res
            scored.sort(key=lambda t: t[0])
            out.trajectory.append(scored[0][0])

            elites = [g for _, g, _ in scored[:self.elite]]
            nxt = list(elites)

            def pick() -> Tuple[int, ...]:
                k = min(self.tournament, len(scored))
                return min(rng.sample(scored, k), key=lambda t: t[0])[1]

            while len(nxt) < self.population:
                child = genome.crossover(pick(), pick(), rng)
                nxt.append(genome.mutate(child, self.mutation, rng))
            pop = nxt
        return out


class HalvingSearch:
    """Successive halving over fidelity rungs.

    ``engines`` is ordered cheap -> exact (e.g. an analytic engine in
    ``uniform`` mode, then ``calibrated``, then an execution backend).
    Rung 0 scores ``n`` random candidates on the cheapest engine; each
    following rung keeps the best ``1/eta`` fraction and re-scores them
    on the next engine.  With a single engine this degrades gracefully
    to plain random search with ``len(engines)`` == 1 rung.
    """

    def __init__(self, space: DesignSpace,
                 engines: Sequence[SweepEngine], *,
                 n: int = 27, eta: int = 3, seed: int = 0,
                 objective: Objective = "seconds"):
        if not engines:
            raise ValueError("need at least one engine")
        if eta < 2:
            raise ValueError("eta must be >= 2")
        self.space = space
        self.engines = list(engines)
        self.n = n
        self.eta = eta
        self.seed = seed
        self.objective = objective

    def run(self) -> SearchResult:
        candidates = self.space.random(self.n, seed=self.seed)
        out = SearchResult(best=None, best_value=math.inf, evaluations=0)
        for rung, engine in enumerate(self.engines):
            if not candidates:
                break
            results = engine.sweep(candidates)
            out.evaluations += len(candidates)
            by_label = {r.label: r for r in results}
            scored = []
            for p in candidates:
                res = by_label[p.label]
                val = _objective_value(res, self.objective)
                scored.append((val, p, res))
                out.history.append((p.label, val))
            scored.sort(key=lambda t: t[0])
            out.trajectory.append(scored[0][0])
            last = rung == len(self.engines) - 1
            if last:
                val, _, res = scored[0]
                if val < out.best_value:
                    out.best_value, out.best = val, res
                break
            keep = max(1, len(scored) // self.eta)
            candidates = [p for _, p, _ in scored[:keep]]
        return out
