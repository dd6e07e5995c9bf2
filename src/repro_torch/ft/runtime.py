"""Fleet monitoring and elastic re-meshing.

At 1000+ nodes, failures are the steady state, not the exception (the
paper's central claim, transplanted from PEDs to preemptible pods).  This
module provides:

  * ``FleetMonitor`` — heartbeat bookkeeping with a phi-style timeout
    detector and ONLINE estimation of each pod class's failure rate
    ``lambda`` (the paper's Table-IV fit, running live instead of offline);
  * ``plan_remesh`` — given the surviving pods, choose the largest
    supported (data, model) mesh that fits, assign pods to mesh coordinates
    deterministically, and report which batch shards must be re-assigned —
    the elastic-scaling path after a failure (restore comes from the
    replicated checkpoints of :mod:`repro_torch.ckpt`).

Failure semantics follow the paper: pods depart silently; detection is by
missed heartbeats only.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.availability import (
    SurvivalForecast,
    fit_failure_rate,
    prob_fail_during,
)

__all__ = ["PodState", "FleetMonitor", "ElasticPlan", "plan_remesh"]


@dataclass
class PodState:
    pod_id: str
    cls: str = "default"            # capacity class (e.g. "reserved"/"preemptible")
    joined: float = 0.0
    last_heartbeat: float = 0.0
    alive: bool = True
    death_time: Optional[float] = None


@dataclass
class FleetMonitor:
    """Heartbeat-based failure detector + online lambda estimation."""

    timeout: float = 30.0           # seconds without heartbeat -> dead
    pods: Dict[str, PodState] = field(default_factory=dict)
    # per-class exposure bookkeeping for the lambda MLE
    _exposure: Dict[str, float] = field(default_factory=dict)
    _deaths: Dict[str, int] = field(default_factory=dict)

    def join(self, pod_id: str, cls: str = "default",
             now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        self.pods[pod_id] = PodState(pod_id, cls, joined=now, last_heartbeat=now)

    def heartbeat(self, pod_id: str, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        p = self.pods[pod_id]
        if p.alive:
            self._exposure[p.cls] = self._exposure.get(p.cls, 0.0) + (
                now - p.last_heartbeat
            )
            p.last_heartbeat = now

    def sweep(self, now: Optional[float] = None) -> List[str]:
        """Mark pods dead on heartbeat timeout; returns newly-dead pod ids."""
        now = time.monotonic() if now is None else now
        dead = []
        for p in self.pods.values():
            if p.alive and (now - p.last_heartbeat) > self.timeout:
                p.alive = False
                p.death_time = now
                self._deaths[p.cls] = self._deaths.get(p.cls, 0) + 1
                dead.append(p.pod_id)
        return dead

    def alive_pods(self) -> List[str]:
        return [p.pod_id for p in self.pods.values() if p.alive]

    # -- availability model (paper Fig. 7 / Table IV, estimated online) -----
    def lam(self, cls: str = "default") -> float:
        """MLE failure rate of one pod class, via the SAME
        :func:`~repro_torch.core.availability.fit_failure_rate` estimator the
        paper fits offline on the CrowdBind trace (deaths / alive-exposure,
        right-censored exponential): the class's accumulated heartbeat
        exposure is one censored observation plus one death record per
        timeout.  These live estimates feed straight back into the churn
        generator (:func:`repro_torch.sim.churn.churn_from_monitor`), so the
        monitoring runtime and the simulator share one availability model."""
        exposure = self._exposure.get(cls, 0.0)
        if exposure <= 0:
            return 1e-6
        deaths = self._deaths.get(cls, 0)
        return fit_failure_rate(
            [exposure] + [0.0] * deaths, [True] + [False] * deaths
        ) or 1e-9

    def fleet_lams(self) -> List[float]:
        return [self.lam(p.cls) for p in self.pods.values() if p.alive]

    def forecast(
        self,
        classes: Sequence[str],
        horizon: float = 30.0,
        n_points: int = 16,
    ) -> np.ndarray:
        """(D, K) survival-probability tensor extrapolated from the online
        lambda MLE: entry ``[d, k]`` is P(a class-``classes[d]`` pod stays
        up through the next ``k/(K-1) * horizon`` seconds).  The same shape
        :class:`~repro_torch.sim.churn.ChurnSchedule.forecast` exports, so the
        monitor can stand in as the availability forecast for live fleets."""
        return self.forecaster(classes, horizon=horizon,
                               n_points=n_points).sample(0.0)

    def forecaster(
        self,
        classes: Sequence[str],
        *,
        horizon: float = 30.0,
        n_points: int = 16,
    ) -> SurvivalForecast:
        """A :class:`SurvivalForecast` over the MLE rates of ``classes``
        (one entry per device), installable on a ``ClusterState`` so the
        ``churn_aware`` policy plans against the monitor's live estimates."""
        return SurvivalForecast.from_rates(
            [self.lam(c) for c in classes],
            horizon=horizon, n_points=n_points,
        )

    def prob_job_interrupted(self, horizon: float) -> float:
        """P(any member pod dies within ``horizon`` s) under independence."""
        total = sum(self.fleet_lams())
        return prob_fail_during(total, horizon)


@dataclass(frozen=True)
class ElasticPlan:
    """Output of :func:`plan_remesh`."""

    mesh_shape: Tuple[int, ...]          # (data, model) [pods folded into data]
    axis_names: Tuple[str, ...]
    assignment: Tuple[Tuple[str, Tuple[int, ...]], ...]  # pod -> mesh coords
    dropped_pods: Tuple[str, ...]
    batch_reshard: bool                  # global batch must be re-split
    restore_step: Optional[int] = None


def plan_remesh(
    alive: Sequence[str],
    *,
    model_parallel: int,
    prev_data_parallel: Optional[int] = None,
    restore_step: Optional[int] = None,
) -> ElasticPlan:
    """Choose the largest (data, model) mesh supported by the survivors.

    The model axis is load-bearing (sharded parameters) and cannot shrink
    without resharding checkpoints, so it is held fixed; the data axis
    absorbs the loss — classic elastic data parallelism.  Surviving pods
    are assigned to mesh coordinates in sorted order (deterministic across
    all participants, no coordinator needed)."""
    alive = sorted(alive)
    n = len(alive)
    if n < model_parallel:
        raise ValueError(
            f"only {n} pods alive; cannot sustain model_parallel={model_parallel}"
        )
    data = n // model_parallel
    used = data * model_parallel
    assignment = tuple(
        (alive[i], (i // model_parallel, i % model_parallel))
        for i in range(used)
    )
    return ElasticPlan(
        mesh_shape=(data, model_parallel),
        axis_names=("data", "model"),
        assignment=assignment,
        dropped_pods=tuple(alive[used:]),
        batch_reshard=(prev_data_parallel is not None and data != prev_data_parallel),
        restore_step=restore_step,
    )
