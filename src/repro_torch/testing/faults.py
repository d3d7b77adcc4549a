"""Deterministic fault injection for the resilient execution layer
(the reference's ``testing/faults.py``; ``REPRO_FAULTS`` parses the same).

Every failure path in the stack -- seam faults in the guarded dispatch
(``kernels/backends.py``), per-Einsum isolation on the CPU
(``core/vectorized.py``) and sweep-level timeouts / retries /
checkpoint-resume (``dse/engine.py``) -- is *provoked and asserted*
through this harness rather than just believed.  An injector holds an
ordered list of ``FaultSpec``s; the guarded kernel dispatcher and the
sweep engine call its hooks at well-defined instants:

  * ``before_seam(seam, backend)``  -- may raise (simulated backend
    fault: generic, transient, device-absent, i32-window overflow) or
    sleep;
  * ``after_seam(seam, backend, out)`` -- may corrupt the seam output
    (NaN/inf poisoning of reductions, out-of-range positions) so the
    guard postconditions have something real to catch;
  * ``before_point(label)``         -- sweep-engine hook: may delay a
    point (provoking the wall-clock timeout), raise (a failing design
    point) or raise ``SimulatedCrash`` (a ``BaseException`` that tears
    the whole sweep down mid-flight for checkpoint-resume tests).

The port's guarded dispatch has one lowering per device (``cuda``: the
hand kernels; ``torch``: their plain versions) and no chain behind it:
every injected seam fault, transient ones included, is recorded as a
``DowngradeEvent`` and raises ``KernelChainExhausted``.  On the card
that fails the run (a sweep records the point as failed); no fault
makes the card run the plain versions.

Faults are deterministic: ``at=N`` fires on the N-th *matching* call
(1-based), ``times=K`` keeps firing for K consecutive matches,
``every=K`` re-fires periodically, and probabilistic injection (``p=``)
draws from a seeded generator, so a failing chaos run replays exactly.

Selection comes from an explicitly installed injector
(``install_injector``) or, when none is installed, from the
``REPRO_FAULTS`` environment variable -- semicolon-separated specs of
comma-separated ``key=value`` pairs::

    REPRO_FAULTS='seam=intersect_keys,backend=cuda,kind=raise,at=1'
    REPRO_FAULTS='seam=*,kind=raise,every=7;seam=segmented_reduce,kind=nan,at=2'

Accounting: the injector counts every fault it fires at a seam; the
guarded dispatcher counts every ``DowngradeEvent`` it records.  A chaos
run fails when a seam fault fired without a recorded event -- that is
the definition of a *silent* downgrade (``verify_no_silent_downgrades``).
"""
from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

ENV_VAR = "REPRO_FAULTS"

#: fault kinds an injector understands (see FaultSpec.kind)
FAULT_KINDS = ("raise", "transient", "device-absent", "i32-overflow",
               "nan", "corrupt-pos", "delay", "point-error",
               "point-delay", "crash")

#: hook names FaultSpec.seam may match ('*' matches any seam)
SEAMS = ("intersect_keys", "union_keys", "union_k_keys", "lookup_keys",
         "segmented_reduce")


# ---------------------------------------------------------------------- #
# injected exception types
# ---------------------------------------------------------------------- #
class InjectedFault(RuntimeError):
    """A deterministic, injected backend fault."""


class InjectedTransientFault(InjectedFault):
    """An injected *transient* fault (the reference's guard retries it;
    the port's records and raises it like any other)."""


class InjectedDeviceAbsent(InjectedFault):
    """Simulates a missing / lost accelerator device."""


class InjectedI32Overflow(InjectedFault):
    """Simulates a key domain blowing a kernel's i32 admissibility
    window at kernel time (past the host-side pre-checks)."""


class SimulatedCrash(BaseException):
    """Tears down a sweep mid-flight.  Deliberately *not* an
    ``Exception``: per-point isolation must not absorb it, exactly like
    a SIGKILL / OOM would not be absorbed."""


_RAISES = {
    "raise": InjectedFault,
    "transient": InjectedTransientFault,
    "device-absent": InjectedDeviceAbsent,
    "i32-overflow": InjectedI32Overflow,
}


# ---------------------------------------------------------------------- #
# fault specs
# ---------------------------------------------------------------------- #
@dataclass
class FaultSpec:
    """One deterministic fault rule.

    ``at`` fires on the N-th matching call (1-based, 0 = disabled
    unless ``p`` or ``every`` is set); ``times`` keeps it firing for
    that many consecutive matches; ``every`` re-fires on every K-th
    matching call after the first firing; ``p`` fires probabilistically
    from the injector's seeded generator."""
    kind: str = "raise"
    seam: str = "*"                  # seam name or '*' (seam faults)
    backend: str = "*"               # kernel-backend name or '*'
    point: str = "*"                 # sweep point-label substring or '*'
    at: int = 1
    times: int = 1
    every: int = 0
    p: float = 0.0
    delay_s: float = 0.0
    # runtime state
    calls: int = 0
    fired: int = 0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"choose from {FAULT_KINDS}")

    # -------------------------------------------------------------- #
    def _matches(self, seam: Optional[str], backend: Optional[str],
                 point: Optional[str]) -> bool:
        if seam is not None:
            if self.kind in ("point-error", "point-delay", "crash"):
                return False
            if self.seam not in ("*", seam):
                return False
            if backend is not None and self.backend not in ("*", backend):
                return False
            return True
        # sweep-point hook
        if self.kind not in ("point-error", "point-delay", "crash"):
            return False
        return self.point == "*" or (point is not None
                                     and self.point in point)

    def _should_fire(self, rng: np.random.Generator) -> bool:
        self.calls += 1
        if self.p > 0.0:
            return bool(rng.random() < self.p)
        if self.at <= 0:
            return False
        if self.calls < self.at:
            return False
        if self.calls < self.at + self.times:
            return True
        if self.every > 0:
            return (self.calls - self.at) % self.every == 0
        return False


def parse_faults(text: str) -> List[FaultSpec]:
    """Parse a ``REPRO_FAULTS`` string into FaultSpecs."""
    specs: List[FaultSpec] = []
    for chunk in text.split(";"):
        chunk = chunk.strip()
        if not chunk:
            continue
        kw: Dict[str, object] = {}
        for pair in chunk.split(","):
            if "=" not in pair:
                raise ValueError(
                    f"bad fault spec {chunk!r}: expected key=value pairs")
            k, v = pair.split("=", 1)
            k = k.strip().replace("-", "_")
            v = v.strip()
            if k in ("at", "times", "every"):
                kw[k] = int(v)
            elif k in ("p", "delay_s"):
                kw[k] = float(v)
            elif k in ("kind", "seam", "backend", "point"):
                kw[k] = v
            else:
                raise ValueError(f"unknown fault-spec key {k!r} in {chunk!r}")
        specs.append(FaultSpec(**kw))
    return specs


# ---------------------------------------------------------------------- #
# the injector
# ---------------------------------------------------------------------- #
@dataclass
class FaultInjector:
    """Holds fault rules plus deterministic firing state.  Thread-safe:
    sweep engines evaluate points from worker threads."""
    specs: List[FaultSpec] = field(default_factory=list)
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self._lock = threading.Lock()
        #: seam faults fired (raises + corruptions) -- the number the
        #: guarded dispatcher's recorded events must cover
        self.seam_faults_fired = 0
        #: sweep-point faults fired (errors + delays + crashes)
        self.point_faults_fired = 0

    # -------------------------------------------------------------- #
    def before_seam(self, seam: str, backend: str) -> None:
        """Called by the guarded dispatcher before each seam call on
        each backend; raises / sleeps per the matching specs."""
        with self._lock:
            for sp in self.specs:
                if not sp._matches(seam, backend, None):
                    continue
                if sp.kind in ("nan", "corrupt-pos"):
                    continue                   # output hooks, not input
                if not sp._should_fire(self._rng):
                    continue
                sp.fired += 1
                if sp.kind == "delay":
                    time.sleep(sp.delay_s)
                    continue
                self.seam_faults_fired += 1
                raise _RAISES[sp.kind](
                    f"injected {sp.kind} fault at {seam}/{backend} "
                    f"(call {sp.calls})")

    def after_seam(self, seam: str, backend: str, out):
        """Output-corruption hook: returns ``out`` possibly poisoned.
        The corruption is intentionally detectable by the guard
        postconditions (NaN in a reduction, out-of-range position)."""
        with self._lock:
            for sp in self.specs:
                if sp.kind not in ("nan", "corrupt-pos"):
                    continue
                if not sp._matches(seam, backend, None):
                    continue
                if not sp._should_fire(self._rng):
                    continue
                sp.fired += 1
                self.seam_faults_fired += 1
                out = _corrupt(seam, out, sp.kind)
        return out

    def before_point(self, label: str) -> None:
        """Sweep-engine hook, called once per evaluation attempt."""
        with self._lock:
            todo = []
            for sp in self.specs:
                if not sp._matches(None, None, label):
                    continue
                if not sp._should_fire(self._rng):
                    continue
                sp.fired += 1
                self.point_faults_fired += 1
                todo.append(sp)
        # act outside the lock: delays must not serialize other threads
        for sp in todo:
            if sp.kind == "point-delay":
                time.sleep(sp.delay_s)
            elif sp.kind == "crash":
                raise SimulatedCrash(
                    f"injected sweep crash at point {label!r}")
            else:
                raise InjectedFault(
                    f"injected point failure at {label!r}")

    # -------------------------------------------------------------- #
    def reset(self) -> None:
        with self._lock:
            for sp in self.specs:
                sp.calls = sp.fired = 0
            self.seam_faults_fired = 0
            self.point_faults_fired = 0
            self._rng = np.random.default_rng(self.seed)


def _corrupt(seam: str, out, kind: str):
    """Poison a seam output in a way the guard postconditions detect."""
    if seam == "segmented_reduce":
        arr = np.array(out, dtype=np.float64, copy=True)
        if len(arr):
            arr[0] = np.nan if kind == "nan" else np.inf
            return arr
        return out
    if seam in ("union_keys", "union_k_keys"):
        u, pos = (out[0], list(out[1:])) if seam == "union_keys" \
            else (out[0], out[1])
        u = np.array(u, copy=True)
        if len(u) > 1:
            u[0], u[-1] = u[-1], u[0]          # break sortedness
        return (u, *pos) if seam == "union_keys" else (u, pos)
    # position seams: out-of-range index
    arr = np.array(out, copy=True)
    if len(arr):
        arr[0] = (1 << 62)
    return arr


# ---------------------------------------------------------------------- #
# process-wide installation
# ---------------------------------------------------------------------- #
_EXPLICIT: Optional[FaultInjector] = None
_ENV_TEXT: Optional[str] = None
_ENV_INJ: Optional[FaultInjector] = None


def install_injector(inj: Optional[FaultInjector]) -> Optional[FaultInjector]:
    """Install ``inj`` as the process-wide injector (wins over
    ``$REPRO_FAULTS``; None clears)."""
    global _EXPLICIT
    _EXPLICIT = inj
    return inj


def clear_injector() -> None:
    global _EXPLICIT, _ENV_TEXT, _ENV_INJ
    _EXPLICIT = None
    _ENV_TEXT = None
    _ENV_INJ = None


def active_injector() -> Optional[FaultInjector]:
    """The explicitly installed injector, else one parsed from
    ``$REPRO_FAULTS`` (re-parsed when the variable changes), else
    None."""
    global _ENV_TEXT, _ENV_INJ
    if _EXPLICIT is not None:
        return _EXPLICIT
    text = os.environ.get(ENV_VAR, "")
    if not text:
        _ENV_TEXT, _ENV_INJ = None, None
        return None
    if text != _ENV_TEXT:
        _ENV_TEXT = text
        _ENV_INJ = FaultInjector(parse_faults(text),
                                 seed=int(os.environ.get(
                                     "REPRO_FAULTS_SEED", "0")))
    return _ENV_INJ


def verify_no_silent_downgrades() -> None:
    """Chaos-run gate: every seam fault the active injector fired must
    be covered by a recorded ``DowngradeEvent`` (see
    ``kernels.backends.events_recorded``).  Raises AssertionError on a
    silent downgrade."""
    inj = active_injector()
    if inj is None or inj.seam_faults_fired == 0:
        return
    from repro_torch.kernels import backends as kbk
    recorded = kbk.events_recorded()
    assert recorded >= inj.seam_faults_fired, (
        f"silent downgrade: injector fired {inj.seam_faults_fired} seam "
        f"fault(s) but only {recorded} DowngradeEvent(s) were recorded")
