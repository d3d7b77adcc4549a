"""Runtime invariant guards for the execution layer (``REPRO_GUARDS``).

Execution-driven backends can be corrupted silently -- a faulty kernel
backend, a bad device, a poisoned reduction -- in ways an analytic
model cannot.  This module hosts the *cheap* runtime invariant checks
the vector pipeline and the CSF builders run on the hot path, behind a
single process-wide knob:

    REPRO_GUARDS=strict   violations raise ``GuardViolation``
    REPRO_GUARDS=warn     violations warn once per (check, site) and
                          execution continues (the default)
    REPRO_GUARDS=off      checks are skipped entirely

The checks are deliberately O(n) single-pass or O(1): a NaN/inf scan
over leaf values (arithmetic semirings only -- min-plus legitimately
folds infinities), a monotone-segments check on CSF builds, and stream
conservation ((yielded, drained) accounting) on frontier levels.  The
guard budget is <= 3% of hot-path wall time at the default level
(asserted by ``BENCH_backend.json`` regressions).

Seam-level *postconditions* (output length / range / sortedness of the
kernel-dispatch seams) live with the guarded dispatcher in
``kernels/backends.py`` but consult the same knob; there a violation is
actionable -- the seam downgrades to the next backend in the chain --
rather than merely raised or warned.
"""
from __future__ import annotations

import os
import warnings
from typing import Set, Tuple

import numpy as np

ENV_VAR = "REPRO_GUARDS"

LEVELS = ("strict", "warn", "off")

DEFAULT_LEVEL = "warn"


class GuardViolation(RuntimeError):
    """A runtime invariant of the execution layer failed."""


_warned: Set[Tuple[str, str]] = set()


#: (raw env value, parsed level) of the last lookup -- level() runs on
#: every guarded seam call, so the strip/lower/validate is memoized on
#: the raw string while the env var itself is still read per call
_level_cache: Tuple[str, str] = ("\0unset", DEFAULT_LEVEL)


def level() -> str:
    """The active guard level (env-read per call: tests flip it)."""
    global _level_cache
    raw = os.environ.get(ENV_VAR, DEFAULT_LEVEL)
    if raw != _level_cache[0]:
        lv = raw.strip().lower()
        _level_cache = (raw, lv if lv in LEVELS else DEFAULT_LEVEL)
    return _level_cache[1]


def enabled() -> bool:
    return level() != "off"


def violation(check: str, site: str, detail: str = "") -> None:
    """Report a failed invariant per the active level."""
    lv = level()
    if lv == "off":
        return
    msg = f"guard {check!r} violated at {site}" + \
        (f": {detail}" if detail else "")
    # telemetry first -- a strict-mode raise must not lose the tally.
    # Imported lazily: violations are rare, and repro_torch.obs must stay
    # import-free from the guard hot path.
    from repro_torch.obs.metrics import metrics
    from repro_torch.obs.spans import active_tracer
    metrics().counter(f"guards.violation/{check}").inc()
    tr = active_tracer()
    if tr is not None:
        tr.instant(f"guard:{check}", cat="guard",
                   args={"site": site, "detail": detail, "level": lv})
    if lv == "strict":
        raise GuardViolation(msg)
    key = (check, site)
    if key not in _warned:
        _warned.add(key)
        warnings.warn(msg, RuntimeWarning, stacklevel=3)


# ---------------------------------------------------------------------- #
# the checks
# ---------------------------------------------------------------------- #
def check_finite(arr: np.ndarray, site: str) -> None:
    """NaN/inf scan (call only where the algebra promises finiteness,
    i.e. arithmetic semirings over real data)."""
    if level() == "off" or len(arr) == 0:
        return
    if arr.dtype.kind != "f":
        return
    with np.errstate(invalid="ignore"):
        bad = not bool(np.isfinite(arr).all())
    if bad:
        violation("finite-values", site,
                  f"{int((~np.isfinite(arr)).sum())} non-finite of "
                  f"{len(arr)}")


def check_monotone_segments(seg: np.ndarray, site: str) -> None:
    """CSF segment arrays must be non-decreasing and start at 0."""
    if level() == "off" or len(seg) == 0:
        return
    if int(seg[0]) != 0 or (len(seg) > 1
                            and bool((np.diff(seg) < 0).any())):
        violation("monotone-segments", site,
                  "segment offsets decrease or do not start at 0")


def check_conservation(yielded: int, drained: int, site: str) -> None:
    """(yielded, drained) stream-accounting conservation: a node cannot
    drain more elements than were yielded to it."""
    if level() == "off":
        return
    if drained > yielded or yielded < 0 or drained < 0:
        violation("stream-conservation", site,
                  f"yielded={yielded} drained={drained}")


def reset_warned() -> None:
    """Test hook: forget which (check, site) pairs already warned."""
    _warned.clear()
