"""Design-space exploration over declarative TeAAL specs (the
reference's ``dse`` package, ported).

The paper's Section-8 workflow -- sweep point changes to a spec and
compare modeled designs -- made engine-shaped:

  * ``space``   -- declarative sweep-space construction (grid / random /
    parameter overrides) producing hashable ``DesignPoint``s;
  * ``engine``  -- evaluation of points through any execution backend
    (default: the analytic engine, with memoized plan lowering, a
    shared per-workload density-calibration cache, and batched
    probe+replay evaluation of points sharing a mapping signature);
  * ``cache``   -- content-addressed result cache (in-memory LRU plus
    an optional persistent store) serving repeat queries without the
    backend;
  * ``service`` -- persistent micro-batching front-end coalescing
    concurrent what-if queries into shared sweeps;
  * ``search``  -- gradient-free optimizers (evolutionary, successive
    halving) walking spaces too large to grid;
  * ``pareto``  -- dominance filtering over the modeled objectives
    (time / energy / DRAM traffic).

``repro_torch.bench.dse_sweep`` sits on top of this package.  The
analytic backend is host numpy; the 'vector' backend runs its seams on
the CUDA device unless the engine is given another (``device='cpu'``).
"""
from .cache import ResultCache, result_key, workload_hash
from .engine import PointResult, SweepEngine
from .pareto import dominates, pareto_front
from .search import EvolutionarySearch, HalvingSearch, SearchResult
from .service import (ServiceClosed, ServiceOverloaded, SweepService)
from .space import DesignPoint, DesignSpace

__all__ = ["DesignPoint", "DesignSpace", "EvolutionarySearch",
           "HalvingSearch", "PointResult", "ResultCache", "SearchResult",
           "ServiceClosed", "ServiceOverloaded", "SweepEngine",
           "SweepService", "dominates", "pareto_front", "result_key",
           "workload_hash"]
