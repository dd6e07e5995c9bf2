"""Recovery strategies: what the runtime does when a task loses its last
replica.

The paper stops at Eq. (4): an application instance fails as soon as any of
its tasks has every replica fail.  Proactive replication (Algorithm 1's
gamma loop) is the only defence — nothing in the system ever *reacts* to a
device leaving.  The dependability literature for edge fleets
(arXiv:1710.11222, arXiv:2110.07808) argues that detection + recovery is
what actually makes personal-device fleets usable, so this module adds a
pluggable recovery layer behind the simulator's churn runtime:

  * ``fail_fast``  — the paper's Eq. (4) verdict, bit-identical to the seed
    engine: the instance fails the moment a task's last replica dies.
  * ``failover``   — surviving sibling replicas absorb a loss for free
    (that already falls out of first-success semantics); when a task loses
    ALL replicas, the runtime notices after ``detection_delay`` seconds
    (missed heartbeats) and restarts the task on the best surviving
    feasible device by the same Eq. (2) cost it was placed with — a greedy
    hot-spare, no policy round-trip.  The instance fails only when no live
    device is feasible or ``max_retries`` restarts are exhausted.
  * ``replan``     — after the same detection delay, re-invoke the
    *placement policy* on the live sub-fleet for the dead task and every
    not-yet-started downstream stage, through the pure
    ``orchestrate(pinned=...)`` / ``cluster.apply`` machinery: completed
    and in-flight tasks keep their placements (and keep pricing downstream
    transfers), the doomed remainder is re-planned anew.

Recovery composes with the engine's partial-result salvage layer: every
``engine._finish_app(run, failed=True)`` verdict a strategy hands down —
``fail_fast``'s immediate one, or a ``failover``/``replan`` giving up after
``max_retries`` — is intercepted when ``Engine(salvage=...)`` is enabled
and the instance has completed stages: those stages' placements are pinned
through the same ``orchestrate(pinned=...)`` substrate ``replan`` uses and
only the unfinished remainder is re-planned, so giving up on a *task* no
longer always means discarding the whole instance's work.

Strategies are engine-agnostic: they react to ``on_task_dead`` callbacks
from :class:`repro_torch.sim.engine.Engine` (fired both by the churn runtime's
DEVICE_DOWN kills and by the passive lands-on-a-dead-device failure path)
and drive recovery through the engine's public task-lifecycle helpers.
They hold only their own configuration — per-instance retry state lives on
the engine's run records — so one strategy instance can serve any number of
concurrent instances.

Registered by name (mirroring the policy registry) so the simulator, the
``Orchestrator`` façade, and the serving fleet construct them uniformly:
``make_recovery("replan", detection_delay=0.5)``.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple, Type

import numpy as np

__all__ = [
    "RecoveryStrategy",
    "FailFastRecovery",
    "FailoverRecovery",
    "ReplanRecovery",
    "register_recovery",
    "make_recovery",
    "available_recoveries",
]


class RecoveryStrategy:
    """Reacts to task deaths.  ``on_task_dead`` fires when the LAST
    in-flight replica of a task has died (the moment Eq. (4) would fail the
    instance); ``recover`` fires when a recovery the strategy scheduled
    (via ``engine.schedule_recovery``) comes due after its detection delay.
    Implementations decide the instance's fate through
    ``engine._finish_app`` / the engine's task-restart helpers.
    """

    name: str = "base"

    def on_task_dead(self, engine, run, tname: str) -> None:
        raise NotImplementedError

    def recover(self, engine, run, tname: str) -> None:  # pragma: no cover
        raise NotImplementedError


# -- registry (mirrors the policy registry) -----------------------------------
_REGISTRY: "Dict[str, Type[RecoveryStrategy]]" = {}


def register_recovery(
    name: str,
) -> Callable[[Type[RecoveryStrategy]], Type[RecoveryStrategy]]:
    def deco(cls: Type[RecoveryStrategy]) -> Type[RecoveryStrategy]:
        if name in _REGISTRY:
            raise ValueError(f"recovery strategy {name!r} already registered")
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def make_recovery(name: str, **kwargs) -> RecoveryStrategy:
    """Instantiate a registered recovery strategy by name (every strategy
    accepts the full kwarg bundle and keeps what it needs)."""
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown recovery strategy {name!r}; available: "
            f"{sorted(_REGISTRY)}"
        ) from None
    return cls(**kwargs)


def available_recoveries() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


@register_recovery("fail_fast")
class FailFastRecovery(RecoveryStrategy):
    """The paper's Eq. (4) behaviour, bit-identical to the seed engine: a
    task with every replica dead fails its instance immediately."""

    def __init__(self, **_):
        pass

    def on_task_dead(self, engine, run, tname: str) -> None:
        engine._finish_app(run, failed=True)

    def recover(self, engine, run, tname: str) -> None:  # pragma: no cover
        raise RuntimeError("fail_fast never schedules a recovery")


class _DelayedRecovery(RecoveryStrategy):
    """Shared detection/retry plumbing: a death is only *noticed*
    ``detection_delay`` seconds later (missed heartbeats), and each task
    gets at most ``max_retries`` recovery attempts before its instance is
    declared lost."""

    def __init__(
        self,
        *,
        detection_delay: float = 0.25,
        max_retries: int = 2,
        **_,
    ):
        self.detection_delay = float(detection_delay)
        self.max_retries = int(max_retries)

    def on_task_dead(self, engine, run, tname: str) -> None:
        n = run.retries.get(tname, 0)
        if n >= self.max_retries:
            engine._finish_app(run, failed=True)
            return
        run.retries[tname] = n + 1
        engine.schedule_recovery(run, tname, engine.now + self.detection_delay)


@register_recovery("failover")
class FailoverRecovery(_DelayedRecovery):
    """Greedy hot-spare: restart the dead task on the surviving feasible
    device with the lowest Eq. (2) cost (execution + model upload + input
    transfer from its parents' actual hosts), no policy round-trip."""

    def recover(self, engine, run, tname: str) -> None:
        if run.failed or run.done.get(tname, False):
            return
        engine.stats.task_failovers += 1
        rep = _best_surviving_replica(engine, run, tname)
        if engine.trace is not None:
            engine.trace.event(
                run.rec.tid, "failover", engine.now, name=tname,
                ok=rep is not None,
                device=-1 if rep is None else rep.did,
            )
        if rep is None:
            engine._finish_app(run, failed=True)
            return
        run.placement.tasks[tname].replicas = [rep]
        engine._launch_replica(run, tname, rep)


@register_recovery("replan")
class ReplanRecovery(_DelayedRecovery):
    """Re-invoke the placement policy on the live sub-fleet for the dead
    task and every not-yet-started downstream stage.

    Completed and in-flight tasks are pinned (they keep their placements
    and keep pricing downstream transfer costs); the doomed remainder's
    provisional T_alloc occupancy is cancelled *before* planning so the
    policy prices the fleet as it will actually be, and the fresh plan is
    applied through the one blessed mutation path.  If even the live
    sub-fleet cannot host the remainder, the instance is lost."""

    def recover(self, engine, run, tname: str) -> None:
        from .orchestrator import orchestrate  # deferred: avoids cycle at import

        if run.failed or run.done.get(tname, False):
            return
        cluster, t = engine.cluster, engine.now
        unstarted = [k for k in run.placement.tasks if k not in run.started]
        pinned = {
            k: tp for k, tp in run.placement.tasks.items()
            if k in run.started and k != tname
        }
        # the doomed remainder's provisional occupancy must not distort the
        # replan's Eq. (1) estimates — cancel it first
        engine._cancel_provisional(run, tasks=unstarted)
        for k in unstarted:
            del run.placement.tasks[k]
        t0 = time.perf_counter()
        plan = orchestrate(run.app, cluster, t, engine.policy, pinned=pinned)
        engine.replan_time += time.perf_counter() - t0
        engine.stats.replans += 1
        if engine.trace is not None:
            engine.trace.event(
                run.rec.tid, "replan", t, name=tname, ok=plan.feasible,
            )
        if not plan.feasible:
            engine._finish_app(run, failed=True)
            return
        cluster.apply(plan)
        for k, tp in plan.placement.tasks.items():
            run.placement.tasks[k] = tp
            run.origins[k] = plan.now
        engine._start_task(run, tname)


def _best_surviving_replica(engine, run, tname: str):
    """The failover target: min Eq. (2) total over live, memory-feasible
    devices, with model-cache admission checked for real (a device whose
    cache cannot absorb the artifact is skipped, like ``apply`` would)."""
    from .orchestrator import Replica  # deferred: avoids cycle at import

    cluster, t = engine.cluster, engine.now
    spec = run.app.tasks[tname]
    feasible = np.asarray(cluster.alive_mask(t)) & (
        cluster.mem_totals() >= spec.mem_bytes + spec.model_bytes
    )
    if not feasible.any():
        return None
    exec_lat = cluster.estimate_exec(spec.ttype, t)
    if spec.model_id is not None:
        missing = np.array(
            [not d.has_model(spec.model_id) for d in cluster.devices]
        )
        upload = np.where(missing, spec.model_bytes / cluster.upload_bw(), 0.0)
    else:
        upload = np.zeros(cluster.n_devices)
    transfer = np.zeros(cluster.n_devices)
    for dep in spec.deps:
        parent = run.placement.tasks.get(dep)
        if parent is not None and parent.replicas:
            # the survivor re-shards the parent's output over the actual
            # link (for serving fleets: the KV-cache re-shard cost), priced
            # from the factorized model's lazily derived sender row
            transfer = transfer + (
                run.app.tasks[dep].out_bytes
                / cluster.link_row(parent.replicas[0].did)
            )
    total = exec_lat + upload + transfer
    order = np.argsort(np.where(feasible, total, np.inf), kind="stable")
    lams = cluster.lams()
    for did in order:
        did = int(did)
        if not feasible[did]:
            break
        dev = cluster.devices[did]
        if spec.model_id is not None and not dev.admit_model(
            spec.model_id, spec.model_bytes
        ):
            continue
        window = (t - dev.join_time) + float(total[did])
        pf = float(1.0 - np.exp(-lams[did] * max(window, 0.0)))
        return Replica(
            did=did,
            est_exec=float(exec_lat[did]),
            est_upload=float(upload[did]),
            est_transfer=float(transfer[did]),
            pred_fail=pf,
        )
    return None
