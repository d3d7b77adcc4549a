"""Statistical residency model of the performance model's storage levels.

Only ``stat_misses`` is kept here: ``components.StorageLevel.touch_stat``
needs it on every execution path.  The occupancy models of the analytic
backend are not part of this package yet.
"""
from __future__ import annotations


def stat_misses(n: float, unique: float, nbytes: float,
                capacity_bytes: float) -> float:
    """Expected misses of an aggregate touch under the Sparseloop-style
    statistical residency model: ``unique`` compulsory misses, plus --
    when the touched footprint exceeds capacity -- capacity misses on
    the reuse accesses proportional to the non-resident fraction of the
    working set."""
    footprint = unique * nbytes
    misses = float(unique)
    if footprint > capacity_bytes and n > unique:
        misses += (n - unique) * (1.0 - capacity_bytes / footprint)
    return misses
