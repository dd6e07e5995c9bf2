"""The always-on orchestration service loop.

:class:`StreamingOrchestrator` turns the closed-loop
:class:`repro_torch.api.Orchestrator` into an open-loop service: arrivals from
:mod:`repro_torch.stream.arrivals` flow through the bounded
:class:`~repro_torch.stream.admission.AdmissionController`, admitted waves are
planned through the existing fused ``orchestrate_batch`` path (one batched
``decide_batch`` kernel call per wave-stage), and execution — churn,
recovery, salvage included — runs on the unchanged discrete-event engine.

The loop advances in fixed ``tick`` steps:

  1. step the engine to the tick boundary (task completions, churn events);
  2. offer every arrival with ``t <= now`` to the admission controller
     (deadline shedding, SLO-class backpressure);
  3. pop the next dispatch wave (criticals first, EDF) and plan it fused at
     ``now`` — under queue pressure ``best_effort`` instances go through
     the degraded policy (replication off) to protect critical p99;
  4. sample the metrics registry on its interval.

Admission decisions therefore happen at tick granularity: an arrival waits
at most one tick before its first shed/dispatch decision.

Accounting: shed instances are charged to the engine's conservation ledger
(``admitted == completed + lost + shed``, asserted by ``Engine.drain``),
and the admission queue's own ledger must net to zero after the run — the
T_alloc-style invariant for the queue.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, replace as _dc_replace
from typing import List, Optional, Sequence, Tuple, Union

from ..core.orchestrator import orchestrate_batch
from ..core.policy import IBDASHPolicy, Policy
from ..sim.engine import SimResult
from .admission import (
    AdmissionConfig,
    AdmissionController,
    PlacementLatencyEstimator,
    ShedRecord,
)
from .arrivals import Arrival
from .metrics import MetricsRegistry

__all__ = ["StreamingOrchestrator", "StreamResult", "WALL_CLOCK_METRICS",
           "without_wall_clock"]

# The two metrics read off the host's clock (``time.perf_counter`` around
# each wave's ``orchestrate_batch``): the histogram of wave planning times
# and the placement-rate gauge.  They differ from run to run; every other
# metric is a function of the seeds.
WALL_CLOCK_METRICS = ("wave_plan_s", "placements_per_sec")


def without_wall_clock(metrics: dict) -> dict:
    """A :meth:`MetricsRegistry.snapshot` without :data:`WALL_CLOCK_METRICS`
    (in every section, the interval samples included): the part of a run's
    metrics that two runs of the same seeds must reproduce exactly."""
    def keep(row: dict) -> dict:
        return {k: v for k, v in row.items() if k not in WALL_CLOCK_METRICS}

    return {
        section: [keep(row) for row in val] if section == "samples" else keep(val)
        for section, val in metrics.items()
    }


@dataclass
class StreamResult:
    """Outcome of one open-loop service run."""

    result: SimResult               # the paper-shaped per-instance records
    metrics: dict                   # MetricsRegistry.snapshot() export
    stats: dict                     # engine counters (admitted/shed/lost/...)
    n_arrivals: int
    shed_log: List[ShedRecord]

    @property
    def shed_rate(self) -> float:
        return self.stats["shed"] / self.n_arrivals if self.n_arrivals else 0.0

    def p(self, q: str = "p99", slo: str = "latency_critical") -> float:
        """E2E latency quantile for one SLO class (q in p50/p99/p999)."""
        h = self.metrics["histograms"].get(f"e2e_{slo}", {})
        return float(h.get(q, float("nan")))


def _auto_degrade(policy: Policy) -> Optional[Policy]:
    """Default degraded policy: the same IBDASH scoring with replication
    off (gamma=0) — best_effort work keeps its latency-optimal primary but
    stops consuming backup capacity.  Non-IBDASH-family policies have no
    replication to shed, so there is nothing to degrade.  It decides on
    the main policy's device."""
    if isinstance(policy, IBDASHPolicy) and policy.cfg.gamma > 0:
        return IBDASHPolicy(_dc_replace(policy.cfg, gamma=0), device=policy.device)
    return None


class StreamingOrchestrator:
    """Open-loop service loop over one :class:`repro_torch.api.Orchestrator`.

    ``admission=None`` runs the no-admission baseline: an unbounded FIFO
    with shedding disabled — every offered instance eventually executes,
    however late.  ``degrade_policy`` may be a Policy, ``"auto"`` (IBDASH
    with gamma=0 when the main policy is IBDASH-family), or None (off).
    """

    def __init__(
        self,
        orchestrator,
        *,
        admission: Optional[AdmissionConfig] = AdmissionConfig(),
        tick: float = 0.25,
        wave_cap: Optional[int] = None,
        metrics_interval: float = 1.0,
        degrade_policy: Union[Policy, str, None] = "auto",
    ):
        self.orch = orchestrator
        self.cfg = admission if admission is not None else AdmissionConfig(
            queue_cap=None, shed=False, degrade_threshold=float("inf")
        )
        self.tick = float(tick)
        self.wave_cap = wave_cap
        self.metrics_interval = float(metrics_interval)
        self.estimator = PlacementLatencyEstimator(
            orchestrator.cluster, orchestrator.policy
        )
        self.controller = AdmissionController(self.cfg, self.estimator)
        self.metrics = MetricsRegistry()
        if degrade_policy == "auto":
            degrade_policy = _auto_degrade(orchestrator.policy)
        self.degrade_policy = degrade_policy
        # (arrival, dispatch_t, degraded) per dispatched instance, aligned
        # with engine.records order (app names are NOT instance-unique, so
        # stream metadata travels by submission order, never by name)
        self._meta: List[Tuple[Arrival, float, bool]] = []
        self._shed_synced = 0
        self._shed_logged = 0
        self._plan_time = 0.0
        self._planned = 0

    # -- internals --------------------------------------------------------------
    def _sync_shed(self) -> None:
        """Mirror controller sheds into the engine ledger + metrics (a shed
        instance counts as admitted-and-shed so the engine's conservation
        identity covers the whole service)."""
        eng = self.orch.engine
        new = self.controller.shed - self._shed_synced
        if new:
            eng.stats.admitted += new
            eng.stats.shed += new
            self._shed_synced = self.controller.shed
        log = self.controller.shed_log
        m, tr = self.metrics, eng.trace
        for rec in log[self._shed_logged:]:
            m.counter("shed").inc()
            m.counter(f"shed_{rec.slo}").inc()
            m.counter(f"shed_reason_{rec.reason}").inc()
            if tr is not None:
                # a shed instance never reaches the engine: its whole
                # trace is one zero-length envelope with the drop instant,
                # so the ledger still round-trips from spans alone
                tid = tr.begin_instance(
                    rec.kind, rec.t, uid=rec.uid, slo=rec.slo
                )
                tr.event(tid, "shed", rec.t, reason=rec.reason)
                tr.end_instance(tid, rec.t, outcome="shed")
        self._shed_logged = len(log)

    def _dispatch(self, wave: List[Arrival], now: float) -> None:
        degrade = (
            self.degrade_policy is not None
            and self.controller.fill >= self.cfg.degrade_threshold
        )
        if degrade:
            groups = [
                (self.orch.policy, [a for a in wave if a.slo.critical]),
                (self.degrade_policy, [a for a in wave if not a.slo.critical]),
            ]
        else:
            groups = [(self.orch.policy, wave)]
        eng, cluster = self.orch.engine, self.orch.cluster
        for pol, arrivals in groups:
            if not arrivals:
                continue
            degraded = pol is not self.orch.policy
            apps = [a.instantiate() for a in arrivals]
            times = [now] * len(apps)
            t0 = time.perf_counter()
            plans = orchestrate_batch(apps, cluster, pol, times=times)
            dt = time.perf_counter() - t0
            self._plan_time += dt
            self._planned += len(apps)
            self.metrics.histogram("wave_plan_s").observe(dt)
            eng.add_arrivals(apps, times, plans=plans)
            self._meta.extend((a, now, degraded) for a in arrivals)
            if degraded:
                self.metrics.counter("degraded").inc(len(arrivals))

    def _finalize(self, rec0: int) -> None:
        """Join the engine's outcome records back to their arrivals (by
        submission order) and fill the E2E histograms."""
        records = self.orch.engine.records[rec0:]
        if len(records) != len(self._meta):
            raise RuntimeError(
                f"record/metadata drift: {len(records)} records vs "
                f"{len(self._meta)} dispatched arrivals"
            )
        m = self.metrics
        tr = self.orch.engine.trace
        for rec, (arrival, disp_t, degraded) in zip(records, self._meta):
            if tr is not None and rec.tid >= 0:
                # the queue wait the engine never saw: true arrival ->
                # dispatch wave (the instance envelope starts at dispatch)
                tr.add_span(
                    rec.tid, "admission_queue", arrival.t, disp_t,
                    slo=arrival.slo.name, degraded=degraded,
                    deadline=arrival.deadline,
                )
            if rec.failed:
                m.counter("failed").inc()
                m.counter(f"failed_{arrival.slo.name}").inc()
                continue
            m.counter("completed").inc()
            e2e = rec.finished - arrival.t
            m.histogram("e2e").observe(e2e)
            m.histogram(f"e2e_{arrival.slo.name}").observe(e2e)
            if rec.finished > arrival.deadline + 1e-9:
                m.counter("deadline_missed").inc()
                m.counter(f"deadline_missed_{arrival.slo.name}").inc()
        if self._plan_time > 0:
            m.gauge("placements_per_sec").set(self._planned / self._plan_time)

    # -- the service loop -------------------------------------------------------
    def run(self, arrivals: Sequence[Arrival]) -> StreamResult:
        """Drive the whole stream to quiescence and export the metrics."""
        arrivals = sorted(arrivals, key=lambda a: a.t)
        orch, m = self.orch, self.metrics
        rec0 = len(orch.engine.records)
        n = len(arrivals)
        idx = 0
        now = orch.now
        next_sample = now
        while True:
            orch.step(until=now)
            while idx < n and arrivals[idx].t <= now:
                a = arrivals[idx]
                idx += 1
                if self.controller.offer(a, now):
                    m.counter("admitted").inc()
                    m.counter(f"admitted_{a.slo.name}").inc()
            wave = self.controller.pop_wave(now, self.wave_cap)
            if wave:
                self._dispatch(wave, now)
            self._sync_shed()
            if now >= next_sample:
                m.gauge("queue_depth").set(len(self.controller))
                m.gauge("queue_fill").set(self.controller.fill)
                m.histogram("queue_depth_samples").observe(
                    len(self.controller)
                )
                m.sample(now)
                next_sample = now + self.metrics_interval
            if idx >= n and not len(self.controller) \
                    and orch.pending_events == 0:
                break
            now += self.tick
        orch.drain()                    # asserts the conservation identity
        self.controller.assert_drained()
        self._finalize(rec0)
        m.gauge("queue_depth").set(0.0)
        # one export surface: the engine's typed ledger is published into
        # the same registry the service metrics live in
        orch.engine.stats.to_registry(m)
        m.sample(orch.now)
        return StreamResult(
            result=orch.result(scenario="stream", horizon=orch.now),
            metrics=m.snapshot(),
            stats=dict(orch.stats),
            n_arrivals=n,
            shed_log=list(self.controller.shed_log),
        )
