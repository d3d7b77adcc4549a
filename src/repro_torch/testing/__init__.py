"""Deterministic test harnesses (fault injection, chaos tooling)."""
from .faults import (FaultInjector, FaultSpec, InjectedFault,
                     InjectedTransientFault, SimulatedCrash,
                     active_injector, clear_injector, install_injector,
                     parse_faults)

__all__ = [
    "FaultInjector", "FaultSpec", "InjectedFault",
    "InjectedTransientFault", "SimulatedCrash", "active_injector",
    "clear_injector", "install_injector", "parse_faults",
]
