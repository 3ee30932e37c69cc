"""Elastic scaling and failure-handling policy (a copy of
``repro.train.elastic``, which imports no framework).

On a real cluster the coordinator detects failed hosts (heartbeat
timeout), reforms the mesh with the survivors, and resumes from the
latest checkpoint, which the CheckpointManager stores independently of
the mesh, so restore is the whole recovery path.  This module holds the
policy logic (pure, unit-testable) plus a straggler-mitigation helper for
the synchronous train loop.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class HostState:
    host_id: int
    last_heartbeat: float
    healthy: bool = True


@dataclasses.dataclass
class MeshPlan:
    n_hosts: int
    data_parallel: int
    model_parallel: int

    @property
    def n_devices(self) -> int:
        return self.data_parallel * self.model_parallel


class ElasticCoordinator:
    """Tracks host health; decides when/how to reform the mesh."""

    def __init__(self, hosts: Sequence[int], devices_per_host: int = 8,
                 heartbeat_timeout: float = 60.0,
                 model_parallel: int = 16):
        now = time.time()
        self.hosts: Dict[int, HostState] = {
            h: HostState(h, now) for h in hosts}
        self.devices_per_host = devices_per_host
        self.timeout = heartbeat_timeout
        self.model_parallel = model_parallel
        self.generation = 0

    def heartbeat(self, host_id: int, now: Optional[float] = None) -> None:
        now = now if now is not None else time.time()
        if host_id in self.hosts:
            self.hosts[host_id].last_heartbeat = now
            self.hosts[host_id].healthy = True

    def sweep(self, now: Optional[float] = None) -> List[int]:
        """Mark hosts that missed the heartbeat window; returns failures."""
        now = now if now is not None else time.time()
        failed = []
        for h in self.hosts.values():
            if h.healthy and now - h.last_heartbeat > self.timeout:
                h.healthy = False
                failed.append(h.host_id)
        return failed

    def join(self, host_id: int, now: Optional[float] = None) -> None:
        now = now if now is not None else time.time()
        self.hosts[host_id] = HostState(host_id, now)

    def healthy_hosts(self) -> List[int]:
        return sorted(h.host_id for h in self.hosts.values() if h.healthy)

    def plan(self) -> MeshPlan:
        """Largest mesh over healthy hosts keeping model_parallel fixed
        and data_parallel a power of two (collective-friendly)."""
        n = len(self.healthy_hosts()) * self.devices_per_host
        mp = self.model_parallel
        dp = max(1, n // mp)
        dp = 1 << (dp.bit_length() - 1)          # floor to power of two
        return MeshPlan(n_hosts=len(self.healthy_hosts()),
                        data_parallel=dp, model_parallel=mp)

    def reform(self) -> MeshPlan:
        self.generation += 1
        return self.plan()


@dataclasses.dataclass
class StragglerPolicy:
    """Synchronous-step straggler mitigation: a step that exceeds
    `deadline_factor` x the trailing-median step time is flagged; after
    `tolerance` consecutive flags the host is reported to the
    coordinator (paper's static schedule bounds sampling skew; this
    covers compute skew)."""
    deadline_factor: float = 3.0
    tolerance: int = 3
    window: int = 32

    def __post_init__(self):
        self._times: List[float] = []
        self._strikes: Dict[int, int] = {}

    def observe(self, host_id: int, step_time: float) -> bool:
        """Returns True if `host_id` should be reported as a straggler."""
        self._times.append(step_time)
        if len(self._times) > self.window:
            self._times.pop(0)
        med = sorted(self._times)[len(self._times) // 2]
        if step_time > self.deadline_factor * max(med, 1e-9):
            self._strikes[host_id] = self._strikes.get(host_id, 0) + 1
        else:
            self._strikes[host_id] = 0
        return self._strikes.get(host_id, 0) >= self.tolerance
