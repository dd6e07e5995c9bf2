"""Discrete-event simulator for edge orchestration (paper §V).

Reproduces the paper's evaluation protocol: per 15 s cycle, ~1000
application instances arrive clustered inside the first 1.5 s; 100 edge
devices (uniform over the 8 Table-III classes) serve them; devices leave the
network permanently at exponentially-distributed lifetimes (Table IV rates)
*without announcing it* — a task lands on a departed device simply fails at
its estimated completion time.

Ground truth execution times follow the same linear interference law the
orchestrator was profiled with (Eq. 1) — evaluated with the *actual*
co-located task counts at start — times multiplicative log-normal noise.
T_alloc bookkeeping mirrors the paper: provisional intervals are recorded at
placement and replaced by actual intervals when tasks really start.

Placement goes through the pure two-phase protocol: each arrival is planned
with ``orchestrate(app, cluster, t, policy)`` and made real with
``cluster.apply(plan)`` — the engine never calls a mutating ``place``.
Prefer driving the engine through :class:`repro_torch.api.Orchestrator`
(``submit`` / ``step`` / ``drain``).

Stage barrier: tasks of stage i+1 start only once every stage-i task has
completed (Algorithm 1 line 44).  A task completes when any replica
succeeds; what happens when a task's LAST replica dies is the recovery
strategy's call (:mod:`repro_torch.core.recovery`): ``fail_fast`` fails the
instance immediately (Eq. 4, the bit-identical default), ``failover``
restarts the task on the best surviving device after a detection delay,
``replan`` re-invokes the placement policy on the live sub-fleet.

Churn runtime: pass a :class:`repro_torch.sim.churn.ChurnSchedule` and the engine
processes DEVICE_DOWN / DEVICE_UP events — a departing device kills its
in-flight replicas on the spot (their remaining T_alloc occupancy is
returned) and is masked out of every later placement's feasibility; a
rejoining device comes back empty (fresh join time, cold model cache) and
is re-admitted as placement capacity.

Partial-result salvage: with ``salvage > 0``, an instance about to be
declared lost (its recovery strategy gave up, or ``fail_fast`` fired) is
re-submitted instead of discarded when it has completed stages to show for
itself: the completed tasks' placements are pinned through the pure
``orchestrate(pinned=...)`` substrate — so their outputs' transfer costs
keep being priced from the devices that hold them — and only the unfinished
remainder is re-planned and restarted.  Completed stages are NEVER re-run.
"""
from __future__ import annotations

import heapq
import itertools
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ..core.cluster import ClusterState
from ..core.dag import AppDAG
from ..core.orchestrator import Placement, Replica, orchestrate, policy_on
from ..core.policy import Policy
from ..core.recovery import RecoveryStrategy, make_recovery
from ..obs.metrics import EngineStats
from ..obs.tracing import FLEET_TID, Tracer

__all__ = ["InstanceRecord", "SimResult", "Engine"]


@dataclass
class InstanceRecord:
    app: str
    arrival: float
    finished: float = float("nan")
    failed: bool = False
    service_time: float = float("nan")
    n_tasks: int = 0
    n_replicas: int = 0
    pred_latency: float = float("nan")
    pred_fail: float = float("nan")
    # trace id in the engine's Tracer (-1 = tracing disabled)
    tid: int = -1


@dataclass
class SimResult:
    scheme: str
    scenario: str
    instances: List[InstanceRecord]
    load_per_device: np.ndarray          # tasks executed per device
    horizon: float
    # attached extras: the StreamResult (scenario "stream") and the span
    # trace (SimConfig(trace=True)); None when the feature is off.
    stream: Optional[object] = None
    trace: Optional[Tracer] = None

    # -- paper metrics (§V-E) ---------------------------------------------------
    @property
    def n(self) -> int:
        return len(self.instances)

    @property
    def prob_failure(self) -> float:
        if not self.instances:
            return 0.0
        return float(np.mean([r.failed for r in self.instances]))

    @property
    def avg_service_time(self) -> float:
        ok = [r.service_time for r in self.instances if not r.failed]
        return float(np.mean(ok)) if ok else float("nan")

    def per_app(self) -> Dict[str, Tuple[float, float]]:
        """app name -> (avg service time, prob failure)."""
        out: Dict[str, Tuple[float, float]] = {}
        for name in sorted({r.app for r in self.instances}):
            rs = [r for r in self.instances if r.app == name]
            ok = [r.service_time for r in rs if not r.failed]
            out[name] = (
                float(np.mean(ok)) if ok else float("nan"),
                float(np.mean([r.failed for r in rs])),
            )
        return out


@dataclass
class _AppRun:
    rec: InstanceRecord
    app: AppDAG
    placement: Placement
    # The plan's own timestamp: ``ClusterState.apply`` recorded every
    # provisional interval at ``plan.now + est_start``, so cancellation MUST
    # use the same origin.  For fused waves planned against one snapshot,
    # ``plan.now`` can differ from the arrival event time — cancelling at
    # ``rec.arrival + est_start`` would leave ghost T_alloc residue.
    plan_now: float = 0.0
    stage_idx: int = 0
    stage_pending: int = 0
    # task -> #replicas still in flight (None once task resolved)
    inflight: Dict[str, int] = field(default_factory=dict)
    done: Dict[str, bool] = field(default_factory=dict)
    started: set = field(default_factory=set)
    failed: bool = False
    # -- churn / recovery state ------------------------------------------------
    # replica ids of this instance still executing (engine._active keys)
    live_rids: Set[int] = field(default_factory=set)
    # per-task provisional-interval origin: a replanned task's occupancy was
    # re-recorded by apply at ITS plan's timestamp, not the original one
    origins: Dict[str, float] = field(default_factory=dict)
    # per-task recovery attempts consumed (failover / replan budgets)
    retries: Dict[str, int] = field(default_factory=dict)
    # a replica of this instance died at some point (recovered-vs-lost stats)
    touched: bool = False
    # -- partial-result salvage -------------------------------------------------
    # salvage resubmissions consumed (bounded by Engine.salvage)
    salvages: int = 0
    # bumped on every salvage so RECOVER events scheduled for the doomed
    # pre-salvage placement are dropped instead of double-restarting tasks
    epoch: int = 0


class Engine:
    """Runs one (scheduler, scenario) simulation."""

    ARRIVAL = 0
    TASK_END = 1
    DEVICE_DOWN = 2
    DEVICE_UP = 3
    RECOVER = 4

    def __init__(
        self,
        cluster: ClusterState,
        scheduler,
        seed: int = 0,
        noise_sigma: float = 0.10,
        churn=None,
        recovery="fail_fast",
        salvage: int = 0,
        track_intervals: bool = False,
        trace: Optional[Tracer] = None,
    ):
        """``scheduler`` may be a pure :class:`~repro_torch.core.policy.Policy` or
        a registered policy name — every placement is routed through
        ``orchestrate`` + ``cluster.apply``.

        ``churn`` is an optional :class:`repro_torch.sim.churn.ChurnSchedule`;
        installing one makes the schedule the single source of truth for
        device lifetimes (DEVICE_DOWN / DEVICE_UP events drive departures
        and rejoins).  ``recovery`` names a registered
        :class:`~repro_torch.core.recovery.RecoveryStrategy` (or passes an
        instance); the default ``fail_fast`` is bit-identical to the
        pre-churn engine.  ``salvage`` bounds per-instance partial-result
        salvage resubmissions (0 = off, the bit-identical default): a lost
        instance with completed stages is re-planned through
        ``orchestrate(pinned=...)`` instead of discarded.
        ``track_intervals`` records every replica's
        actual execution span in :attr:`executed` so tests can prove the
        occupancy bookkeeping nets to exactly the executed work.
        ``trace`` takes a :class:`repro_torch.obs.tracing.Tracer`: every
        instance then gets a structured span trace (admission -> plan ->
        per-replica exec -> recovery -> terminal outcome), sim-clock
        timestamped; None (the default) emits nothing and costs one
        ``is not None`` check per event."""
        self.cluster = cluster
        self.policy: Policy = policy_on(scheduler, cluster, seed=seed)
        self.recovery: RecoveryStrategy = (
            make_recovery(recovery) if isinstance(recovery, str) else recovery
        )
        self.noise = np.random.default_rng(seed + 17)
        self.noise_sigma = noise_sigma
        self.events: List[Tuple[float, int, int, tuple]] = []
        self._seq = itertools.count()
        self.records: List[InstanceRecord] = []
        self.load = np.zeros(cluster.n_devices, dtype=np.int64)
        self.now = 0.0
        # in-flight replica registry: rid -> (run, tname, did, ttype, t0, t1)
        self._active: Dict[int, tuple] = {}
        self._dev_active: List[Set[int]] = [set() for _ in cluster.devices]
        self._rid = itertools.count()
        self.track_intervals = track_intervals
        # (did, ttype, t0, t1, t_cut) actual execution spans; t_cut < t1
        # marks a replica killed mid-flight (its tail occupancy returned)
        self.executed: List[Tuple[int, int, float, float, float]] = []
        self.replan_time = 0.0
        self.salvage = int(salvage)
        # Conservation ledger: every instance the engine takes accounting
        # responsibility for lands in exactly one terminal bucket —
        #   admitted == completed + lost + shed
        # ("shed" is charged by the stream admission layer, which counts a
        # shed arrival as admitted-and-shed; pure engine runs keep it 0).
        # ``drain`` asserts the identity.  EngineStats is typed over the
        # frozen ENGINE_COUNTERS vocabulary: a misspelled counter raises
        # AttributeError instead of silently minting a new key.
        self.stats = EngineStats()
        self.trace = trace
        # rid -> open "exec" span id, populated only when tracing
        self._span_of: Dict[int, int] = {}
        self.churn = churn or None      # False (churn forced off) == None
        if self.churn is not None:
            churn.install(cluster)
            for ev in churn.events:
                kind = self.DEVICE_DOWN if ev.kind == "leave" else self.DEVICE_UP
                self._push(ev.t, kind, (ev.did, ev.until))

    # -- event helpers ----------------------------------------------------------
    def _push(self, t: float, kind: int, payload: tuple) -> None:
        heapq.heappush(self.events, (t, next(self._seq), kind, payload))

    def add_arrivals(
        self,
        apps: List[AppDAG],
        times: List[float],
        plans: Optional[List] = None,
    ) -> None:
        """Enqueue arrivals.  ``plans`` (from ``orchestrate_batch``) carries
        pre-computed placements for the fused burst path; without it each
        arrival is planned when its event fires."""
        if plans is None:
            plans = [None] * len(apps)
        for app, t, plan in zip(apps, times, plans):
            self._push(t, self.ARRIVAL, (app, plan))

    # -- task lifecycle -----------------------------------------------------------
    def _start_stage(self, run: _AppRun) -> None:
        app, placement = run.app, run.placement
        while run.stage_idx < app.n_stages:
            stage = app.stages[run.stage_idx]
            # done tasks are skipped: after a salvage resubmission earlier
            # stages are complete (pinned) and must never re-run
            todo = [
                t for t in stage
                if t in placement.tasks and not run.done.get(t, False)
            ]
            if todo:
                run.stage_pending = len(todo)
                for tname in todo:
                    self._start_task(run, tname)
                return
            run.stage_idx += 1
        # no runnable stage left -> app complete
        self._finish_app(run, failed=False)

    def _start_task(self, run: _AppRun, tname: str) -> None:
        cluster = self.cluster
        tp = run.placement.tasks[tname]
        spec = run.app.tasks[tname]
        run.inflight[tname] = 0
        run.started.add(tname)
        prov_start = run.origins.get(tname, run.plan_now) + tp.est_start
        for rep in tp.replicas:
            # Replace the provisional T_alloc interval with the actual one.
            cluster.add_interval(
                rep.did, spec.ttype, prov_start, prov_start + rep.est_total, w=-1.0
            )
            self._launch_replica(run, tname, rep)

    def _launch_replica(self, run: _AppRun, tname: str, rep: Replica) -> None:
        """Start one replica NOW: ground-truth duration from the actual
        co-located counts (Eq. 1 + noise), actual T_alloc interval, and an
        entry in the in-flight registry so a device departure can kill it."""
        cluster = self.cluster
        spec = run.app.tasks[tname]
        counts = np.asarray(
            cluster.device_counts_at(rep.did, self.now), dtype=np.float64
        ).copy()
        dev = cluster.devices[rep.did]
        exec_t = cluster.model.estimate(dev.cls, spec.ttype, counts)
        if self.noise_sigma > 0:
            exec_t *= float(
                self.noise.lognormal(mean=0.0, sigma=self.noise_sigma)
            )
        dur = exec_t + rep.est_upload + rep.est_transfer
        cluster.add_interval(rep.did, spec.ttype, self.now, self.now + dur)
        self.load[rep.did] += 1
        run.inflight[tname] = run.inflight.get(tname, 0) + 1
        rid = next(self._rid)
        self._active[rid] = (
            run, tname, rep.did, spec.ttype, self.now, self.now + dur
        )
        self._dev_active[rep.did].add(rid)
        run.live_rids.add(rid)
        ok = (self.now + dur) <= dev.alive_until
        if self.trace is not None:
            tid = run.rec.tid
            # The open exec span mirrors the in-flight registry entry:
            # [t0, sched_end] is the scheduled window, the close time is
            # the actual cut (== sched_end unless churn kills it) — the
            # same triple the `executed` interval log records, which the
            # T_alloc replay property test holds the two paths to.
            self._span_of[rid] = self.trace.open_span(
                tid, "exec", self.now, name=tname,
                device=rep.did, tier=int(dev.tier), ttype=spec.ttype,
                stage=run.stage_idx, sched_end=self.now + dur,
                pred_exec=rep.est_exec, pred_upload=rep.est_upload,
                pred_transfer=rep.est_transfer, pred_fail=rep.pred_fail,
                real_exec=exec_t,
            )
            if rep.est_upload > 0:
                self.trace.add_span(
                    tid, "model_upload", self.now,
                    self.now + rep.est_upload, name=tname, device=rep.did,
                )
            if rep.est_transfer > 0:
                t0u = self.now + rep.est_upload
                self.trace.add_span(
                    tid, "parent_transfer", t0u, t0u + rep.est_transfer,
                    name=tname, device=rep.did,
                )
        self._push(self.now + dur, self.TASK_END, (run, tname, rid, ok))

    def _retire_replica(self, rid: int, info: tuple) -> None:
        """Drop one replica from the in-flight registries."""
        run, _tname, did, _ttype, _t0, _t1 = info
        self._dev_active[did].discard(rid)
        run.live_rids.discard(rid)

    def _task_end(self, run: _AppRun, tname: str, rid: int, ok: bool) -> None:
        info = self._active.pop(rid, None)
        if info is None:
            return          # replica was killed (device departure/app failure)
        self._retire_replica(rid, info)
        if self.track_intervals:
            _, _, did, ttype, t0, t1 = info
            self.executed.append((did, ttype, t0, t1, t1))
        if self.trace is not None:
            sid = self._span_of.pop(rid, None)
            if sid is not None:
                self.trace.close_span(
                    sid, info[5], outcome="ok" if ok else "dead"
                )
        if run.failed or run.done.get(tname, False):
            return
        run.inflight[tname] -= 1
        if not ok:
            run.touched = True
            self.stats.replica_deaths += 1
        if ok:
            run.done[tname] = True
            run.stage_pending -= 1
            if run.stage_pending == 0:
                run.stage_idx += 1
                self._start_stage(run)
        elif run.inflight[tname] == 0:
            # every replica failed -> the recovery strategy decides the
            # instance's fate (fail_fast == Eq. 4: fail immediately)
            self.recovery.on_task_dead(self, run, tname)

    # -- churn runtime ----------------------------------------------------------
    def _device_down(self, did: int) -> None:
        """A device departs: mask it out of future placements and kill its
        in-flight replicas on the spot — their remaining occupancy is
        returned to T_alloc and each affected task is routed through the
        recovery strategy when it just lost its last replica."""
        self.stats.device_down += 1
        self.cluster.mark_down(did, self.now)
        if self.trace is not None:
            self.trace.event(FLEET_TID, "device_down", self.now, device=did)
        # Each entry is stamped with its run's epoch AT THE POP: a salvage
        # fired by an earlier entry's recovery re-plans the run (bumping the
        # epoch) — the remaining pre-popped deaths then belong to a
        # placement that no longer exists and must not touch the relaunched
        # tasks' inflight counts (their occupancy is still returned below).
        dead: List[Tuple[int, tuple, int]] = [
            (rid, info, info[0].epoch)
            for rid, info in (
                (r, self._active.pop(r)) for r in sorted(self._dev_active[did])
            )
        ]
        for rid, info, epoch in dead:
            run, tname, _did, ttype, t0, t1 = info
            self._retire_replica(rid, info)
            self.cluster.cancel_from(did, ttype, t0, t1, self.now)
            if self.track_intervals:
                self.executed.append((did, ttype, t0, t1, self.now))
            if self.trace is not None:
                sid = self._span_of.pop(rid, None)
                if sid is not None:
                    self.trace.close_span(sid, self.now, outcome="killed")
            if (run.failed or run.done.get(tname, False)
                    or epoch != run.epoch):
                continue
            run.touched = True
            self.stats.replica_deaths += 1
            run.inflight[tname] -= 1
            if run.inflight[tname] == 0:
                self.recovery.on_task_dead(self, run, tname)

    def _device_up(self, did: int, until: float) -> None:
        """A device rejoins empty (fresh join time, cold caches) and is
        re-admitted as placement capacity until its next departure."""
        self.stats.device_up += 1
        self.cluster.mark_up(did, self.now, alive_until=until)
        if self.trace is not None:
            self.trace.event(
                FLEET_TID, "device_up", self.now, device=did, until=until
            )

    def schedule_recovery(self, run: _AppRun, tname: str, t: float) -> None:
        """Recovery-strategy hook: fire ``recovery.recover(run, tname)`` at
        absolute time ``t`` (death + detection delay).  The event carries
        the run's current epoch: a salvage resubmission in between
        invalidates it (the doomed placement it targeted no longer exists)."""
        if self.trace is not None:
            self.trace.add_span(
                run.rec.tid, "recovery_wait", self.now, t, name=tname
            )
        self._push(t, self.RECOVER, (run, tname, run.epoch))

    def _finish_app(self, run: _AppRun, failed: bool) -> None:
        if not np.isnan(run.rec.finished):
            return
        if failed and run.salvages < self.salvage and any(run.done.values()):
            if self._salvage(run):
                return                  # the instance lives on, re-planned
        if failed:
            self._cancel_running(run)
            self._cancel_provisional(run)
        run.failed = failed
        run.rec.failed = failed
        run.rec.finished = self.now
        run.rec.service_time = self.now - run.rec.arrival
        if failed:
            self.stats.lost += 1
        else:
            self.stats.completed += 1
            if run.touched:
                self.stats.recovered += 1
                if run.salvages:
                    self.stats.salvaged += 1
        if self.trace is not None and run.rec.tid >= 0:
            self.trace.end_instance(
                run.rec.tid, self.now,
                outcome="lost" if failed else "completed",
                recovered=bool(run.touched and not failed),
                salvages=run.salvages,
            )

    def _salvage(self, run: _AppRun) -> bool:
        """Partial-result salvage: instead of discarding a lost instance,
        pin its COMPLETED tasks' placements (their outputs stay where they
        were computed and keep pricing downstream transfers from those
        devices) and re-plan + restart only the unfinished remainder via the
        pure ``orchestrate(pinned=...)`` substrate.  Returns False when even
        the live sub-fleet cannot host the remainder (the instance is then
        truly lost)."""
        cluster, t = self.cluster, self.now
        run.salvages += 1
        run.epoch += 1                  # invalidate pending RECOVER events
        self.stats.salvages += 1
        # kill still-running sibling replicas and return the unstarted
        # remainder's provisional occupancy before re-planning, so the
        # salvage plan prices the fleet as it will actually be
        self._cancel_running(run)
        self._cancel_provisional(run)
        done = {k for k, v in run.done.items() if v}
        pinned = {
            k: tp for k, tp in run.placement.tasks.items() if k in done
        }
        for k in list(run.placement.tasks):
            if k not in pinned:
                del run.placement.tasks[k]
        t0 = time.perf_counter()
        plan = orchestrate(run.app, cluster, t, self.policy, pinned=pinned)
        self.replan_time += time.perf_counter() - t0
        if self.trace is not None:
            self.trace.event(
                run.rec.tid, "salvage", t,
                ok=plan.feasible, pinned=len(pinned),
            )
        if not plan.feasible:
            return False
        cluster.apply(plan)
        for k, tp in plan.placement.tasks.items():
            run.placement.tasks[k] = tp
            run.origins[k] = plan.now
        run.started = set(done)
        run.inflight = {}
        run.touched = True
        run.stage_idx = 0               # _start_stage skips completed stages
        self._start_stage(run)
        return True

    def _cancel_running(self, run: _AppRun) -> None:
        """A failed app's still-executing sibling replicas (other in-flight
        tasks of the same instance) produce output nobody will consume:
        return their unfinished occupancy so they stop distorting Eq. (1)
        estimates for everyone else."""
        for rid in sorted(run.live_rids):
            info = self._active.pop(rid, None)
            if info is None:
                continue
            _, _tname, did, ttype, t0, t1 = info
            self._dev_active[did].discard(rid)
            self.cluster.cancel_from(did, ttype, t0, t1, self.now)
            if self.track_intervals:
                self.executed.append((did, ttype, t0, t1, self.now))
            if self.trace is not None:
                sid = self._span_of.pop(rid, None)
                if sid is not None:
                    self.trace.close_span(
                        sid, self.now, outcome="cancelled"
                    )
        run.live_rids.clear()

    def _cancel_provisional(
        self, run: _AppRun, tasks: Optional[List[str]] = None
    ) -> None:
        """Remove the provisional T_alloc intervals of not-yet-started tasks
        (recorded by ``apply`` at each task's plan origin + est_start) so no
        ghost occupancy survives — on app failure (every unstarted task) or
        on a replan (the tasks about to be re-planned)."""
        cluster = self.cluster
        names = tasks if tasks is not None else list(run.placement.tasks)
        for tname in names:
            if tname in run.started:
                continue
            tp = run.placement.tasks[tname]
            spec = run.app.tasks[tname]
            start = run.origins.get(tname, run.plan_now) + tp.est_start
            for rep in tp.replicas:
                cluster.add_interval(
                    rep.did, spec.ttype, start, start + rep.est_total, w=-1.0
                )

    # -- main loop -------------------------------------------------------------
    def run(self, until: float) -> None:
        while self.events and self.events[0][0] <= until:
            t, _, kind, payload = heapq.heappop(self.events)
            self.now = t
            if kind == self.ARRIVAL:
                app, plan = payload
                # Two-phase protocol: pure planning (unless the arrival came
                # pre-planned by a fused `orchestrate_batch` wave), then the
                # one blessed mutation path (T_alloc intervals + uploads).
                if plan is None:
                    plan = orchestrate(app, self.cluster, t, self.policy)
                self.cluster.apply(plan)
                placement = plan.placement
                rec = InstanceRecord(
                    app=app.name, arrival=t, n_tasks=app.n_tasks,
                    n_replicas=placement.n_replicas(),
                    pred_latency=placement.est_latency,
                    pred_fail=placement.pred_app_fail,
                )
                self.records.append(rec)
                self.stats.admitted += 1
                if self.trace is not None:
                    rec.tid = self.trace.begin_instance(
                        app.name, t,
                        n_tasks=app.n_tasks, n_replicas=rec.n_replicas,
                    )
                    self.trace.event(
                        rec.tid, "plan", t, policy=self.policy.name,
                        pred_latency=placement.est_latency,
                        pred_fail=placement.pred_app_fail,
                        feasible=placement.feasible,
                    )
                if not placement.feasible:
                    # an infeasible arrival is an instance the fleet turned
                    # away: it is LOST the moment it arrives (previously it
                    # only set rec.failed, silently drifting the counters)
                    rec.failed = True
                    rec.finished = t
                    rec.service_time = 0.0
                    self.stats.lost += 1
                    if self.trace is not None:
                        self.trace.end_instance(
                            rec.tid, t, outcome="lost", reason="infeasible"
                        )
                    continue
                run = _AppRun(rec=rec, app=app, placement=placement,
                              plan_now=plan.now)
                self._start_stage(run)
            elif kind == self.TASK_END:
                run, tname, rid, ok = payload
                self._task_end(run, tname, rid, ok)
            elif kind == self.DEVICE_DOWN:
                self._device_down(payload[0])
            elif kind == self.DEVICE_UP:
                self._device_up(payload[0], payload[1])
            else:                                   # RECOVER
                run, tname, epoch = payload
                # stale epoch: a salvage resubmission replaced the placement
                # this recovery was scheduled against
                if (epoch == run.epoch and not run.failed
                        and not run.done.get(tname, False)):
                    self.recovery.recover(self, run, tname)
        self.now = until

    def drain(self) -> None:
        """Process every remaining event (online mode: no fixed horizon),
        then assert the conservation identity — a drained engine must have
        resolved every admitted instance into exactly one terminal bucket,
        and its in-flight replica registry must be empty (the occupancy
        analogue: nothing still holds queue capacity)."""
        while self.events:
            self.run(until=self.events[0][0])
        self.check_conservation()

    def check_conservation(self) -> None:
        """``admitted == completed + lost + shed`` (the identity itself
        lives on :class:`~repro_torch.obs.metrics.EngineStats`, checked in one
        place) and no replica in flight.  Raises RuntimeError on drift —
        the regression guard for the counter bookkeeping."""
        self.stats.check_conservation()
        if self._active:
            raise RuntimeError(
                f"{len(self._active)} replicas still in flight after drain"
            )
        if self.trace is not None:
            self.trace.check_closed()

    def finalize(self, until: Optional[float] = None) -> None:
        """Permanently close the books: anything still unfinished counts as
        failed (the paper's cycles are long enough that this is rare).  Only
        call when the run is over — mid-run snapshots should use ``result``,
        which does NOT mutate the live records."""
        until = self.now if until is None else until
        for rec in self.records:
            if np.isnan(rec.finished):
                rec.failed = True
                rec.finished = until
                rec.service_time = until - rec.arrival
                self.stats.lost += 1
                if self.trace is not None and rec.tid >= 0:
                    self.trace.end_instance(
                        rec.tid, until, outcome="lost", reason="horizon"
                    )

    def result(self, scenario: str, horizon: float) -> SimResult:
        """Snapshot the metrics.  In-flight instances are *reported* as
        failed-at-now (the seed's horizon semantics) via per-record copies —
        the live records stay untouched, so a mid-run ``result`` followed by
        ``drain`` still yields correct final numbers."""
        from dataclasses import replace as _replace

        instances = [
            _replace(rec, failed=True, finished=self.now,
                     service_time=self.now - rec.arrival)
            if np.isnan(rec.finished) else rec
            for rec in self.records
        ]
        return SimResult(
            scheme=self.policy.name,
            scenario=scenario,
            instances=instances,
            load_per_device=self.load.copy(),
            horizon=horizon,
        )
