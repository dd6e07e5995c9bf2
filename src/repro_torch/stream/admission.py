"""Bounded admission with deadline-aware shedding and SLO-class backpressure.

The controller sits between the open-loop arrival stream and the fused
``orchestrate_batch`` dispatch path.  Three mechanisms:

  * **Deadline-aware shedding** — an arrival (or a queued entry at dequeue
    time) is dropped when it *provably* cannot meet its deadline under the
    controller's own latency model: the idle-fleet placement-latency
    estimate from the batched scorers (:class:`PlacementLatencyEstimator`)
    plus, for ``best_effort`` work, a queue-delay estimate from the entries
    ahead of it.  ``latency_critical`` entries are dequeued first, so their
    shed test uses the idle estimate alone — a critical instance is never
    deadline-shed while it could still finish on an idle fleet.
  * **Backpressure** — the queue is bounded (``queue_cap``).  A
    ``latency_critical`` arrival hitting a full queue evicts the
    ``best_effort`` entry with the *latest* deadline; a ``best_effort``
    arrival hitting a full queue is shed outright.  Criticals are only
    capacity-shed once no best-effort entry remains to evict.
  * **Degradation signal** — above ``degrade_threshold`` queue fill the
    service dispatches ``best_effort`` waves through a degraded policy
    (replication off) to protect the p99 of critical traffic; the
    controller just exposes the fill fraction.

Every shed is logged (:class:`ShedRecord`) with the exact predicate inputs
so the property tests can re-verify each decision against an independent
idle-fleet replan.  The controller keeps a conservation ledger —
``offered == dispatched + shed + len(queue)`` — asserted by
:meth:`AdmissionController.assert_drained` (the admission-queue analogue of
the engine's T_alloc netting).
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..core.cluster import ClusterState, Device
from ..core.orchestrator import orchestrate
from ..core.policy import Policy
from .arrivals import Arrival

__all__ = [
    "AdmissionConfig",
    "AdmissionController",
    "PlacementLatencyEstimator",
    "ShedRecord",
]


@dataclass(frozen=True)
class AdmissionConfig:
    """Knobs of the bounded admission queue.

    ``queue_cap=None`` gives an unbounded queue; ``shed=False`` disables
    deadline shedding too — together they are the no-admission baseline
    (the open-loop run every over-offered instance still executes)."""

    queue_cap: Optional[int] = 512
    # multiplier on the idle-fleet estimate inside the shed predicate
    # (>1 sheds earlier / more conservatively; 1.0 = exactly "provably
    # cannot meet the deadline under the estimator")
    safety: float = 1.0
    # queue fill fraction beyond which best_effort dispatch degrades
    # (replication off); >= 1.0 disables degradation
    degrade_threshold: float = 0.75
    shed: bool = True


@dataclass(frozen=True)
class ShedRecord:
    """One shed decision with the predicate inputs that justified it."""

    uid: int
    kind: str                 # workload key (stream name)
    slo: str                  # SLO-class name
    reason: str               # "deadline" | "stale" | "capacity" | "evicted"
    t: float                  # decision time
    deadline: float
    est: float                # idle-fleet placement-latency estimate
    wait_est: float           # queue-delay estimate used (0 for criticals)
    best_depth: int           # best_effort entries queued at decision time


def _idle_clone(cluster: ClusterState) -> ClusterState:
    """A pristine copy of the fleet's static side: same devices (classes,
    memory, link rates, tiers, failure rates), empty T_alloc, cold caches,
    everything alive — the reference fleet the shed predicate is defined
    against.  It plans on the fleet's own device."""
    devices = [
        Device(
            did=d.did, cls=d.cls, mem_total=d.mem_total, lam=d.lam,
            tier=d.tier, up_bw=d.up_bw, down_bw=d.down_bw,
        )
        for d in cluster.devices
    ]
    return ClusterState(
        devices=devices, model=cluster.model, horizon=60.0, dt=cluster.dt,
        backhaul=cluster.backhaul, model_source=cluster.model_source,
        device=cluster.device,
    )


class PlacementLatencyEstimator:
    """Idle-fleet Eq. (3) latency per workload kind, from the same batched
    scorer path the dispatcher uses (``orchestrate`` over an idle clone of
    the fleet).  Estimates are cached per stream kind — the stream service
    plans thousands of instances of a handful of app types."""

    def __init__(self, cluster: ClusterState, policy: Policy):
        self.cluster = cluster
        self.policy = policy
        self._idle = _idle_clone(cluster)
        self._cache: Dict[str, float] = {}

    def estimate(self, arrival: Arrival) -> float:
        """Idle-fleet end-to-end latency estimate for this arrival's kind
        (``inf`` when the app is infeasible even on the idle fleet)."""
        key = arrival.kind
        est = self._cache.get(key)
        if est is None:
            plan = orchestrate(
                arrival.instantiate(), self._idle, 0.0, self.policy
            )
            est = float(plan.est_latency) if plan.feasible else float("inf")
            self._cache[key] = est
        return est

    def n_alive(self, t: float) -> int:
        return max(1, int(self.cluster.alive_mask(t).sum()))


# queue entries: (deadline, tiebreak, Arrival, est)
_Entry = Tuple[float, int, Arrival, float]


class AdmissionController:
    """Bounded, SLO-class-aware admission queue (EDF within each class)."""

    def __init__(
        self,
        cfg: AdmissionConfig,
        estimator: PlacementLatencyEstimator,
    ):
        self.cfg = cfg
        self.estimator = estimator
        self._critical: List[_Entry] = []
        self._best: List[_Entry] = []
        self._best_est_sum = 0.0        # running sum of queued best ests
        self._crit_est_sum = 0.0
        self._seq = itertools.count()
        # conservation ledger: offered == dispatched + shed + len(self)
        self.offered = 0
        self.dispatched = 0
        self.shed = 0
        self.shed_log: List[ShedRecord] = []

    def __len__(self) -> int:
        return len(self._critical) + len(self._best)

    @property
    def best_depth(self) -> int:
        return len(self._best)

    @property
    def fill(self) -> float:
        """Queue fill fraction (0 when unbounded)."""
        if self.cfg.queue_cap is None or self.cfg.queue_cap <= 0:
            return 0.0
        return len(self) / self.cfg.queue_cap

    # -- shed predicate ---------------------------------------------------------
    def _wait_estimate(self, critical: bool, now: float) -> float:
        """Expected queue delay from the entries dequeued ahead: their mean
        idle-fleet latency, divided by the live device count (waves run
        concurrently across the fleet).  Criticals are dequeued first and
        their shed test deliberately uses NO wait term — see module doc."""
        if critical:
            return 0.0
        ahead = len(self._critical) + len(self._best)
        if ahead == 0:
            return 0.0
        est_sum = self._crit_est_sum + self._best_est_sum
        return est_sum / self.estimator.n_alive(now)

    def _shed(
        self, arrival: Arrival, now: float, est: float, wait: float,
        reason: str,
    ) -> None:
        self.shed += 1
        self.shed_log.append(ShedRecord(
            uid=arrival.uid, kind=arrival.kind, slo=arrival.slo.name,
            reason=reason, t=now, deadline=arrival.deadline, est=est,
            wait_est=wait, best_depth=len(self._best),
        ))

    # -- offer / dispatch -------------------------------------------------------
    def offer(self, arrival: Arrival, now: float) -> bool:
        """Admit (True) or shed (False) one arrival at time ``now``."""
        self.offered += 1
        cfg = self.cfg
        est = self.estimator.estimate(arrival)
        if cfg.shed:
            wait = self._wait_estimate(arrival.slo.critical, now)
            if now + wait + cfg.safety * est > arrival.deadline:
                self._shed(arrival, now, est, wait, "deadline")
                return False
        if cfg.queue_cap is not None and len(self) >= cfg.queue_cap:
            if arrival.slo.critical and self._best:
                # evict the best_effort entry with the LATEST deadline
                worst = max(range(len(self._best)),
                            key=lambda i: self._best[i][0])
                _, _, victim, vest = self._best.pop(worst)
                heapq.heapify(self._best)
                self._best_est_sum -= vest
                self._shed(victim, now, vest, 0.0, "evicted")
            else:
                self._shed(arrival, now, est, 0.0, "capacity")
                return False
        entry = (arrival.deadline, next(self._seq), arrival, est)
        if arrival.slo.critical:
            heapq.heappush(self._critical, entry)
            self._crit_est_sum += est
        else:
            heapq.heappush(self._best, entry)
            self._best_est_sum += est
        return True

    def pop_wave(
        self, now: float, max_n: Optional[int] = None
    ) -> List[Arrival]:
        """Dequeue the next dispatch wave: criticals first (EDF), then
        best_effort (EDF).  Entries that went stale while queued — ``now``
        plus the idle estimate already exceeds their deadline — are shed
        here instead of wasting fleet capacity."""
        cfg = self.cfg
        wave: List[Arrival] = []
        budget = len(self) if max_n is None else max_n
        for heap, critical in ((self._critical, True), (self._best, False)):
            while heap and len(wave) < budget:
                _, _, arrival, est = heapq.heappop(heap)
                if critical:
                    self._crit_est_sum -= est
                else:
                    self._best_est_sum -= est
                if cfg.shed and now + cfg.safety * est > arrival.deadline:
                    self._shed(arrival, now, est, 0.0, "stale")
                    continue
                wave.append(arrival)
        self.dispatched += len(wave)
        return wave

    # -- conservation -----------------------------------------------------------
    def assert_drained(self) -> None:
        """Post-drain occupancy nets to zero: the queue is empty and the
        ledger balances (every offered instance was dispatched or shed)."""
        if len(self):
            raise RuntimeError(
                f"admission queue not drained: {len(self)} entries remain"
            )
        if self.offered != self.dispatched + self.shed:
            raise RuntimeError(
                "admission ledger drift: offered "
                f"{self.offered} != dispatched {self.dispatched} + shed "
                f"{self.shed}"
            )
        if abs(self._crit_est_sum) > 1e-6 or abs(self._best_est_sum) > 1e-6:
            raise RuntimeError(
                "admission queue-delay accumulators did not net to zero: "
                f"critical {self._crit_est_sum!r}, best {self._best_est_sum!r}"
            )
