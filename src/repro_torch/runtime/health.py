"""Heartbeat-based health tracking + straggler detection (the
reference's ``runtime/health.py``, plain Python).

The control-plane logic that decides *when* to trigger an elastic
resize: hosts post heartbeats with their last completed step and step
latency; the monitor flags

  * DEAD hosts (no heartbeat within ``dead_after_s``),
  * STRAGGLERS (step latency > ``straggler_factor`` x fleet median,
    sustained for ``straggler_patience`` reports).

On a real cluster heartbeats arrive over RPC; in tests they are posted
directly.  The decision logic is identical either way.
"""
from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List, Optional


class HostState(Enum):
    HEALTHY = "healthy"
    STRAGGLER = "straggler"
    DEAD = "dead"


@dataclass
class HostRecord:
    host_id: int
    last_seen: float = 0.0
    last_step: int = -1
    latencies: List[float] = field(default_factory=list)
    slow_reports: int = 0
    state: HostState = HostState.HEALTHY


@dataclass
class HealthDecision:
    dead: List[int]
    stragglers: List[int]
    should_resize: bool
    healthy_count: int


class HeartbeatMonitor:
    def __init__(self, n_hosts: int, dead_after_s: float = 60.0,
                 straggler_factor: float = 2.0,
                 straggler_patience: int = 3,
                 latency_window: int = 20):
        self.hosts: Dict[int, HostRecord] = {
            i: HostRecord(i) for i in range(n_hosts)}
        self.dead_after_s = dead_after_s
        self.straggler_factor = straggler_factor
        self.straggler_patience = straggler_patience
        self.latency_window = latency_window

    # ------------------------------------------------------------------ #
    def heartbeat(self, host_id: int, step: int, step_latency_s: float,
                  now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        h = self.hosts[host_id]
        h.last_seen = now
        h.last_step = step
        h.latencies.append(step_latency_s)
        if len(h.latencies) > self.latency_window:
            h.latencies.pop(0)

    # ------------------------------------------------------------------ #
    def evaluate(self, now: Optional[float] = None) -> HealthDecision:
        now = time.time() if now is None else now
        recents = [h.latencies[-1] for h in self.hosts.values()
                   if h.latencies and h.state != HostState.DEAD]
        median = statistics.median(recents) if recents else 0.0

        dead, stragglers = [], []
        for h in self.hosts.values():
            if h.state == HostState.DEAD:
                dead.append(h.host_id)
                continue
            if h.last_seen and now - h.last_seen > self.dead_after_s:
                h.state = HostState.DEAD
                dead.append(h.host_id)
                continue
            if (median > 0 and h.latencies
                    and h.latencies[-1] > self.straggler_factor * median):
                h.slow_reports += 1
            else:
                h.slow_reports = 0
            if h.slow_reports >= self.straggler_patience:
                h.state = HostState.STRAGGLER
                stragglers.append(h.host_id)
            elif h.state == HostState.STRAGGLER:
                h.state = HostState.HEALTHY

        healthy = len(self.hosts) - len(dead)
        # resize when capacity is lost, or stragglers gate the fleet
        should = bool(dead) or len(stragglers) >= max(
            1, len(self.hosts) // 16)
        return HealthDecision(dead=dead, stragglers=stragglers,
                              should_resize=should,
                              healthy_count=healthy)

    def evict(self, host_id: int) -> None:
        self.hosts[host_id].state = HostState.DEAD

    def admit(self, host_id: int) -> None:
        self.hosts[host_id] = HostRecord(host_id, last_seen=time.time())
