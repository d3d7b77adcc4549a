"""TeAAL core, ported: the declarative language + simulator generator.

Public API:
    load_spec          -- YAML-shaped dict -> AcceleratorSpec
    CascadeSimulator   -- spec + real tensors -> outputs + Report
    FTensor / Fiber    -- the fibertree abstraction
    CSF                -- columnar compressed-sparse-fiber arrays
    ExecutorBackend    -- pluggable execution engines
                          (python | vector | analytic)
    TensorDensity      -- per-rank occupancy models (analytic engine)
    Semiring           -- redefinable (+, *) for graph algorithms
"""
from .analytic import AnalyticBackend
from .csf import CSF
from .density import TensorDensity
from .einsum import Einsum, Semiring, dense_reference, parse_einsum
from .fibertree import Fiber, FTensor
from .generator import CascadeSimulator, SimResult, check_against_dense
from .iteration import ExecutorBackend, PythonBackend, get_backend
from .mapping import MappingResolver
from .metrics import ENERGY_TABLE_PJ, Report
from .spec import AcceleratorSpec, load_spec
from .vectorized import VectorBackend
from .vplan import VectorPlan, lower as lower_vector_plan

__all__ = [
    "Einsum", "Semiring", "dense_reference", "parse_einsum",
    "Fiber", "FTensor", "CSF", "CascadeSimulator", "SimResult",
    "check_against_dense", "MappingResolver", "ENERGY_TABLE_PJ",
    "Report", "AcceleratorSpec", "load_spec",
    "ExecutorBackend", "PythonBackend", "VectorBackend",
    "AnalyticBackend", "TensorDensity", "get_backend",
    "VectorPlan", "lower_vector_plan",
]
