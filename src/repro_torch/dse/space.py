"""Sweep-space construction: which design points to evaluate.

A ``DesignPoint`` names a design (a ``repro_torch.accelerators`` registry
entry or a ``spec()`` factory) plus the spec-factory keyword overrides
and symbolic mapping params that define one concrete configuration.
``DesignSpace`` expands axes of such overrides into points -- full
grid, random subsample, or explicit per-point override dicts.
"""
from __future__ import annotations

import itertools
import random
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, Iterable, List, Mapping, Optional,
                    Sequence, Tuple, Union)


def _freeze(d: Optional[Mapping[str, Any]]) -> Tuple[Tuple[str, Any], ...]:
    return tuple(sorted((d or {}).items()))


@dataclass(frozen=True)
class DesignPoint:
    """One concrete configuration of one design."""
    design: Any                                   # registry name or factory
    spec_kw: Tuple[Tuple[str, Any], ...] = ()     # spec-factory overrides
    params: Tuple[Tuple[str, int], ...] = ()      # symbolic mapping params
    label: str = ""

    @staticmethod
    def make(design: Any, spec_kw: Optional[Mapping[str, Any]] = None,
             params: Optional[Mapping[str, int]] = None,
             label: str = "") -> "DesignPoint":
        return DesignPoint(design, _freeze(spec_kw), _freeze(params),
                           label or DesignPoint._auto_label(design, spec_kw))

    @staticmethod
    def _auto_label(design: Any, spec_kw: Optional[Mapping[str, Any]]
                    ) -> str:
        name = design if isinstance(design, str) else \
            getattr(design, "__module__", repr(design)).rsplit(".", 1)[-1]
        kw = ",".join(f"{k}={v}" for k, v in sorted((spec_kw or {}).items()))
        return f"{name}({kw})" if kw else name

    @property
    def spec_kwargs(self) -> Dict[str, Any]:
        return dict(self.spec_kw)

    @property
    def param_dict(self) -> Optional[Dict[str, int]]:
        return dict(self.params) if self.params else None

    def build_spec(self):
        """Instantiate the AcceleratorSpec for this point."""
        if callable(self.design):
            return self.design(**self.spec_kwargs)
        from repro_torch.accelerators import REGISTRY
        return REGISTRY[self.design](**self.spec_kwargs)

    def default_params(self) -> Optional[Dict[str, int]]:
        if self.params:
            return dict(self.params)
        if isinstance(self.design, str):
            from repro_torch.accelerators import DEFAULT_PARAMS
            return DEFAULT_PARAMS.get(self.design)
        return None


@dataclass
class DesignSpace:
    """Axes of spec-factory overrides (and mapping params) for one
    design; expand with ``grid()`` or ``random(n)``."""
    design: Any
    axes: Dict[str, Sequence[Any]] = field(default_factory=dict)
    param_axes: Dict[str, Sequence[int]] = field(default_factory=dict)
    base_kw: Dict[str, Any] = field(default_factory=dict)
    base_params: Dict[str, int] = field(default_factory=dict)

    @property
    def size(self) -> int:
        n = 1
        for vals in self.axes.values():
            n *= max(len(vals), 1)
        for vals in self.param_axes.values():
            n *= max(len(vals), 1)
        return n

    def __len__(self) -> int:
        return self.size

    # ------------------------------------------------------------------ #
    def point(self, kw: Mapping[str, Any],
              params: Mapping[str, int]) -> DesignPoint:
        merged_kw = dict(self.base_kw)
        merged_kw.update(kw)
        merged_params = dict(self.base_params)
        merged_params.update(params)
        return DesignPoint.make(self.design, merged_kw,
                                merged_params or None)

    def grid(self) -> List[DesignPoint]:
        """Full Cartesian product of all axes, in axis-definition
        order."""
        kw_keys = list(self.axes)
        p_keys = list(self.param_axes)
        out: List[DesignPoint] = []
        kw_vals = [self.axes[k] for k in kw_keys]
        p_vals = [self.param_axes[k] for k in p_keys]
        for combo in itertools.product(*kw_vals, *p_vals):
            kw = dict(zip(kw_keys, combo[:len(kw_keys)]))
            params = dict(zip(p_keys, combo[len(kw_keys):]))
            out.append(self.point(kw, params))
        return out

    def random(self, n: int, seed: int = 0) -> List[DesignPoint]:
        """Random subsample of the grid: ``n`` distinct points,
        deterministic in ``seed``.

        The draw depends only on (axes, seed): ``random.Random`` is
        stable across processes and platforms (unlike ``hash``-seeded
        orderings), so sharded sweep workers and cache keys agree on
        the same points.  ``n`` is clamped to the space size;
        duplicates are rejected, so the result is always
        collision-free (every label unique) and a subset of
        ``grid()``."""
        n = min(n, self.size)
        if n <= 0:
            return []
        rng = random.Random(seed)
        if self.size <= max(n * 4, 64):
            pts = self.grid()
            rng.shuffle(pts)
            return pts[:n]
        out: List[DesignPoint] = []
        seen = set()
        # n <= size/4 here, so each i.i.d. draw collides with
        # probability < 1/4 and the bounded loop cannot realistically
        # exhaust; the cap turns a logic error into a loud failure
        # instead of a hang
        budget = 64 * n + 256
        while len(out) < n and budget > 0:
            budget -= 1
            kw = {k: rng.choice(list(v)) for k, v in self.axes.items()}
            params = {k: rng.choice(list(v))
                      for k, v in self.param_axes.items()}
            pt = self.point(kw, params)
            if pt in seen:
                continue
            seen.add(pt)
            out.append(pt)
        if len(out) < n:
            raise RuntimeError(
                f"DesignSpace.random drew {len(out)}/{n} distinct "
                f"points from a size-{self.size} space before "
                f"exhausting its draw budget")
        return out

    def overrides(self, per_point: Iterable[Mapping[str, Any]]
                  ) -> List[DesignPoint]:
        """Explicit per-point spec-kw override dicts (param overrides
        under the reserved key ``'params'``)."""
        out: List[DesignPoint] = []
        for ov in per_point:
            ov = dict(ov)
            params = ov.pop("params", {})
            out.append(self.point(ov, params))
        return out
