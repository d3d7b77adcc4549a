"""Pareto-frontier extraction over modeled objectives.

All objectives are minimized.  Objectives are attribute names on the
result objects (``seconds``, ``energy_pj``, ``dram_bytes`` by default,
matching ``PointResult`` / ``Report``) or callables.
"""
from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple, Union

Objective = Union[str, Callable[[Any], float]]

DEFAULT_OBJECTIVES: Tuple[str, ...] = ("seconds", "energy_pj", "dram_bytes")


def _values(item: Any, objectives: Sequence[Objective]) -> Tuple[float, ...]:
    out = []
    for ob in objectives:
        v = ob(item) if callable(ob) else getattr(item, ob)
        out.append(float(v))
    return tuple(out)


def dominates(a: Sequence[float], b: Sequence[float]) -> bool:
    """True when ``a`` is no worse than ``b`` on every objective and
    strictly better on at least one (minimization)."""
    assert len(a) == len(b)
    no_worse = all(x <= y for x, y in zip(a, b))
    better = any(x < y for x, y in zip(a, b))
    return no_worse and better


def pareto_front(results: Sequence[Any],
                 objectives: Sequence[Objective] = DEFAULT_OBJECTIVES
                 ) -> List[Any]:
    """Non-dominated subset of ``results``, in input order.  Duplicate
    objective vectors keep their first representative.

    Results that report a falsy ``ok`` attribute (failed / timed-out
    ``PointResult``s, whose objectives are NaN placeholders) are
    filtered out before frontier construction -- a failed point can
    never appear on the front.  Objects without an ``ok`` attribute
    (plain ``Report``s, ad-hoc records) are kept."""
    alive = [r for r in results if getattr(r, "ok", True)]
    vals = [_values(r, objectives) for r in alive]
    front: List[Any] = []
    seen = set()
    for i, (r, v) in enumerate(zip(alive, vals)):
        if v in seen:
            continue
        if any(dominates(w, v) for j, w in enumerate(vals) if j != i):
            continue
        seen.add(v)
        front.append(r)
    return front
