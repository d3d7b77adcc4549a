"""Carry tensors from the reference package into this one.

The reference package's ``CSF`` and ``FTensor`` objects are read
through their public fields only (numpy arrays, rank names, shapes,
leaf iteration), never by importing the reference, and rebuilt as this
package's objects.  A test feeds one set of reference inputs through
both simulators this way, so that they simulate exactly the same data.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

from .core.csf import CSF
from .core.fibertree import Fiber, FTensor


def csf_from_arrays(name: str, ranks: Sequence[str],
                    coords: Sequence[np.ndarray],
                    segments: Sequence[Optional[np.ndarray]],
                    values: np.ndarray,
                    rank_shapes: Optional[Dict[str, Any]] = None,
                    default: Any = 0,
                    upper_ranks: Optional[set] = None) -> CSF:
    """This package's ``CSF`` from the fields of a reference ``CSF``
    (copied, so the two never share a buffer)."""
    return CSF(name, list(ranks), [np.array(c) for c in coords],
               [None if s is None else np.array(s) for s in segments],
               np.array(values), dict(rank_shapes or {}), default,
               set(upper_ranks or ()))


def ftensor_from_dense(name: str, ranks: Sequence[str], array: Any,
                       default: Any = 0) -> FTensor:
    """This package's ``FTensor`` from a dense array whose axes follow
    ``ranks`` (the same tree the reference builds from it)."""
    return FTensor.from_dense(name, list(ranks), np.asarray(array), default)


def ftensor_from_leaves(name: str, ranks: Sequence[str],
                        leaves: Iterable[Tuple[Tuple[Any, ...], Any]],
                        rank_shapes: Optional[Dict[str, Any]] = None,
                        default: Any = 0,
                        upper_ranks: Optional[set] = None) -> FTensor:
    """This package's ``FTensor`` from (path, value) leaves in the
    depth-first order ``FTensor.iter_leaves`` yields them.  Fibers with
    no leaf below them have no path and are not rebuilt."""
    out = FTensor(name, list(ranks), rank_shapes=dict(rank_shapes or {}),
                  default=default, upper_ranks=set(upper_ranks or ()))
    for path, val in leaves:
        node = out.root
        for c in path[:-1]:
            node = node.get_or_create(c, Fiber)
        node.insert(path[-1], val)
    return out


def carry(obj: Any) -> Any:
    """A simulator input of the reference package as one of this
    package: a ``CSF`` (anything with ``segments``) or an ``FTensor``
    (anything with ``iter_leaves``) is rebuilt; a dense array is copied
    to a numpy array."""
    if hasattr(obj, "segments"):
        return csf_from_arrays(obj.name, obj.ranks, obj.coords,
                               obj.segments, obj.values, obj.rank_shapes,
                               obj.default, obj.upper_ranks)
    if hasattr(obj, "iter_leaves"):
        return ftensor_from_leaves(obj.name, obj.ranks, obj.iter_leaves(),
                                   obj.rank_shapes, obj.default,
                                   obj.upper_ranks)
    return np.array(obj)
