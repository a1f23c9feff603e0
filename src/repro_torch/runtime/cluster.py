"""Cluster health: heartbeats, straggler quarantine, elastic re-meshing.

The counterpart of ``repro.runtime.cluster``, pure Python and numpy.
Workers heartbeat to the controller; the controller's only persistent
state is the (tiny, replicated) correlation model, so failover is
re-subscription, not recovery.  ``ElasticMesh`` shrinks the data axis to
the largest feasible grid when workers are lost; lost stream assignments
are rebalanced round-robin.  On the card a "mesh" is the (data, model)
grid of torch devices the fleet's workers map to.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np


@dataclasses.dataclass
class WorkerState:
    last_seen: float
    # None = no latency sample yet; a real 0.0 first sample must NOT be
    # treated as "unset" (it would re-seed the EWMA on the next report)
    latency_ewma: float | None = None
    quarantined: bool = False


class HeartbeatMonitor:
    """Tracks liveness + per-tick latency; flags stragglers at k x median."""

    def __init__(self, workers: list[str], timeout: float = 10.0,
                 straggler_factor: float = 3.0, ewma: float = 0.3,
                 clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self.timeout = timeout
        self.straggler_factor = straggler_factor
        self.ewma = ewma
        now = clock()
        self.workers = {w: WorkerState(last_seen=now) for w in workers}

    def heartbeat(self, worker: str, tick_latency: float | None = None):
        st = self.workers[worker]
        st.last_seen = self._clock()
        if tick_latency is not None:
            if st.latency_ewma is None:     # explicit first-sample seed
                st.latency_ewma = float(tick_latency)
            else:
                st.latency_ewma = (self.ewma * tick_latency +
                                   (1 - self.ewma) * st.latency_ewma)

    def dead(self) -> list[str]:
        now = self._clock()
        return [w for w, st in self.workers.items()
                if now - st.last_seen > self.timeout]

    def stragglers(self) -> list[str]:
        lat = np.array([st.latency_ewma for st in self.workers.values()
                        if st.latency_ewma is not None])
        if len(lat) < 2:
            return []
        med = float(np.median(lat))
        return [w for w, st in self.workers.items()
                if st.latency_ewma is not None
                and st.latency_ewma > self.straggler_factor * max(med, 1e-9)
                and not st.quarantined]

    def quarantine(self, worker: str):
        self.workers[worker].quarantined = True

    def active(self) -> list[str]:
        dead = set(self.dead())
        return [w for w, st in self.workers.items()
                if not st.quarantined and w not in dead]


class ElasticMesh:
    """Pick the largest (data, model) grid fitting the live device count.

    The model axis is pinned (tensor-parallel degree is a property of the
    model's sharding); the data axis shrinks to the largest multiple that
    the surviving devices support.  Streams rebalance onto the new data
    axis.
    """

    def __init__(self, model_parallel: int):
        self.model_parallel = model_parallel

    def grid_for(self, n_devices: int) -> tuple[int, int]:
        data = n_devices // self.model_parallel
        if data < 1:
            raise RuntimeError(
                f"{n_devices} devices cannot host model-parallel "
                f"degree {self.model_parallel}")
        return data, self.model_parallel

    def make_mesh(self, devices) -> list[list]:
        """The (data, model) grid over ``devices`` (torch devices, one per
        worker; several entries may name the same card), as nested lists:
        ``mesh[d][m]``.  Devices past the largest feasible grid are left
        out."""
        devices = list(devices)
        data, model = self.grid_for(len(devices))
        return [devices[d * model:(d + 1) * model] for d in range(data)]

    def rebalance_streams(self, streams: list[int], n_shards: int) -> list[list[int]]:
        """Round-robin camera streams over the surviving data shards."""
        out: list[list[int]] = [[] for _ in range(n_shards)]
        for i, s in enumerate(streams):
            out[i % n_shards].append(s)
        return out
