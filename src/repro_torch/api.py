"""repro_torch.api — the one front door for DAG orchestration in the port.

The same façade as the JAX package's ``repro.api``, with a ``device``:

  * ``plan = orchestrate(app, cluster, now, policy)`` — pure planning: the
    policy (a registered name or a :class:`~repro_torch.core.policy.Policy`)
    maps array-native contexts to device decisions; nothing is mutated.
    The contexts are numpy on the host; the registered policies' batched
    decisions run as float64 torch kernels on the card (or on the CPU when
    the cluster, the policy or the call says ``device="cpu"``).
  * ``token = cluster.apply(plan)`` / ``cluster.undo(token)`` — the single
    explicit mutation path (T_alloc intervals + model-cache admission),
    undoable for speculative what-if planning (alpha/gamma sweeps).
  * :class:`Orchestrator` — the online façade: ``submit(app, t)`` arrivals,
    ``step(until)`` the discrete-event clock forward, ``drain()`` to
    quiescence.  ``sim.runner.run_one/run_grid/sweep_*`` are thin layers
    over this class.

Quick tour::

    from repro_torch.api import Orchestrator, SimConfig, make_cluster, make_profile, run_one

    profile = make_profile(seed=0)                      # device="cuda" by default
    cluster = make_cluster(profile, scenario="mix")     # inherits the profile's device
    orch = Orchestrator(cluster, "ibdash", seed=0)
    orch.submit_batch(apps, times, fused=True)          # one fused wave
    orch.step(until=15.0)
    res = orch.result("mix", horizon=15.0)

    res = run_one("ibdash", SimConfig(device="cpu", n_cycles=1))

Not ported yet (ROADMAP.md): the serving fleet (``ServingFleet`` raises
``NotImplementedError``), the streaming service, the attribution reports
and trace exporters.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

from .core.cluster import (
    TIER_CLOUD,
    TIER_DEVICE,
    TIER_EDGE_SERVER,
    TIER_NAMES,
    ApplyToken,
    ClusterState,
    Device,
)
from .core.dag import AppDAG, TaskSpec
from .core.interference import InterferenceModel
from .core.batched import BatchedDecision, BatchedPolicyContext, FleetSnapshot
from .core.orchestrator import (
    IBDASHConfig,
    Placement,
    Plan,
    Replica,
    TaskPlacement,
    orchestrate,
    orchestrate_batch,
    policy_on,
)
from .core.policy import (
    Policy,
    PolicyContext,
    TaskDecision,
    available_policies,
    make_policy,
    register_policy,
)
from .core.recovery import (
    RecoveryStrategy,
    available_recoveries,
    make_recovery,
    register_recovery,
)
from .sim.engine import Engine, InstanceRecord, SimResult

__all__ = [
    "Orchestrator",
    "orchestrate",
    "orchestrate_batch",
    "Plan",
    "Placement",
    "TaskPlacement",
    "Replica",
    "Policy",
    "PolicyContext",
    "TaskDecision",
    "FleetSnapshot",
    "BatchedPolicyContext",
    "BatchedDecision",
    "register_policy",
    "make_policy",
    "available_policies",
    "RecoveryStrategy",
    "register_recovery",
    "make_recovery",
    "available_recoveries",
    "IBDASHConfig",
    "ApplyToken",
    "ClusterState",
    "Device",
    "TIER_DEVICE",
    "TIER_EDGE_SERVER",
    "TIER_CLOUD",
    "TIER_NAMES",
    "InterferenceModel",
    "AppDAG",
    "TaskSpec",
    "Engine",
    "InstanceRecord",
    "SimResult",
    # lazily re-exported (see __getattr__): run_one, run_grid, sweep_alpha,
    # sweep_gamma, SimConfig, make_profile, make_cluster,
    # make_multi_tier_cluster
]


class Orchestrator:
    """Online orchestration façade over one cluster + one policy.

    Owns the discrete-event engine: arrivals submitted with :meth:`submit`
    are planned with the pure policy API the moment they occur, applied via
    ``cluster.apply``, and executed against ground-truth interference/
    failure dynamics as the clock advances through :meth:`step`.
    """

    def __init__(
        self,
        cluster: ClusterState,
        policy: Union[str, Policy],
        *,
        seed: int = 0,
        noise_sigma: float = 0.10,
        churn=None,
        recovery: Union[str, RecoveryStrategy] = "fail_fast",
        detection_delay: Optional[float] = None,
        max_retries: Optional[int] = None,
        salvage: int = 0,
        track_intervals: bool = False,
        trace=None,
        device=None,
        **policy_kwargs,
    ):
        """``churn`` takes a :class:`repro_torch.sim.churn.ChurnSchedule`: the
        engine then processes DEVICE_DOWN / DEVICE_UP events (in-flight
        replicas on a departing device are killed, capacity is returned and
        later re-admitted on rejoin), and the schedule's forecastable side
        (scripted windows, MLE rates) is installed as the cluster's
        availability forecast — the ``churn_aware`` policy's input.
        ``recovery`` names the registered
        :class:`~repro_torch.core.recovery.RecoveryStrategy` applied when a task
        loses its last replica — ``fail_fast`` (the default) is
        bit-identical to the pre-churn engine.  ``salvage`` bounds
        partial-result salvage resubmissions per instance: a lost instance
        with completed stages is re-planned through
        ``orchestrate(pinned=...)`` instead of discarded (0 = off).
        ``trace`` takes a :class:`repro_torch.obs.Tracer` (or ``True`` to
        construct one): every instance then gets a structured span trace
        (:mod:`repro_torch.obs`); None = tracing off, zero overhead.
        ``device`` is where a policy given by name runs its decision
        kernels (default: the cluster's device); a Policy instance keeps
        its own."""
        if trace is True:
            from .obs import Tracer

            trace = Tracer()
        elif not trace:                    # False/None both mean "off"
            trace = None
        policy = policy_on(policy, cluster, device, seed=seed, **policy_kwargs)
        recovery_kw = {
            k: v for k, v in dict(
                detection_delay=detection_delay, max_retries=max_retries
            ).items() if v is not None
        }
        if isinstance(recovery, str):
            recovery = make_recovery(recovery, **recovery_kw)
        elif recovery_kw:
            raise ValueError(
                f"{sorted(recovery_kw)} only apply when `recovery` is a "
                "registered name; configure the RecoveryStrategy instance "
                "directly instead"
            )
        self.cluster = cluster
        self.policy = policy
        self.engine = Engine(
            cluster, policy, seed=seed, noise_sigma=noise_sigma,
            churn=churn, recovery=recovery, salvage=salvage,
            track_intervals=track_intervals, trace=trace,
        )

    # -- online interface -------------------------------------------------------
    def submit(self, app: AppDAG, t: float) -> "Orchestrator":
        """Enqueue one application instance arriving at absolute time ``t``."""
        self.engine.add_arrivals([app], [t])
        return self

    def submit_batch(
        self,
        apps: Sequence[AppDAG],
        times: Sequence[float],
        *,
        fused: bool = False,
    ) -> "Orchestrator":
        """Enqueue a burst of simultaneous/clustered arrivals (the paper's
        ~1000 instances inside 1.5 s).

        ``fused=False`` (default): each arrival is planned when its event
        fires, so later arrivals see earlier arrivals' provisional T_alloc
        occupancy — the sequential Fig. 8/9 semantics.

        ``fused=True``: the whole burst is planned NOW against the current
        cluster snapshot by :func:`orchestrate_batch` — one batched context
        and one fused ``decide_batch`` kernel call per wave-stage places all
        B instances at once.  Plans are applied at each arrival's
        event time as usual.  Because the plans share one snapshot they do
        not see each other's provisional load, so a heavy burst concentrates
        onto the devices that look best in that snapshot — use the fused
        mode when planning throughput dominates (admission control, what-if
        sweeps, light-load waves), and the default sequential mode when
        load-aware spreading matters.
        """
        if len(apps) != len(times):
            raise ValueError("apps and times must have equal length")
        if fused:
            plans = orchestrate_batch(
                list(apps), self.cluster, self.policy, times=list(times)
            )
            self.engine.add_arrivals(list(apps), list(times), plans=plans)
        else:
            self.engine.add_arrivals(list(apps), list(times))
        return self

    def step(self, until: float) -> "Orchestrator":
        """Advance the event clock, processing every event with t <= until."""
        self.engine.run(until=until)
        return self

    def drain(self) -> "Orchestrator":
        """Run to quiescence: process every remaining event."""
        self.engine.drain()
        return self

    # -- two-phase planning (speculative / what-if) -----------------------------
    def plan(self, app: AppDAG, now: Optional[float] = None) -> Plan:
        """Pure planning against the current state (no mutation)."""
        return orchestrate(
            app, self.cluster, self.now if now is None else now, self.policy
        )

    def commit(self, plan: Plan) -> ApplyToken:
        """Apply a plan; the returned token undoes it via ``cluster.undo``."""
        return self.cluster.apply(plan)

    # -- results ----------------------------------------------------------------
    def result(self, scenario: str = "online", horizon: Optional[float] = None) -> SimResult:
        return self.engine.result(
            scenario=scenario, horizon=self.now if horizon is None else horizon
        )

    @property
    def now(self) -> float:
        return self.engine.now

    @property
    def records(self) -> List[InstanceRecord]:
        return self.engine.records

    @property
    def pending_events(self) -> int:
        return len(self.engine.events)

    @property
    def trace(self):
        """The engine's :class:`~repro_torch.obs.Tracer` (None = tracing off)."""
        return self.engine.trace

    @property
    def stats(self):
        """Engine counters (a typed :class:`~repro_torch.obs.EngineStats` over
        the frozen counter vocabulary; misspelled names raise
        AttributeError).  Instance ledger — ``admitted`` (instances whose
        ARRIVAL fired, plus stream-layer sheds), ``completed``, ``lost``
        (failed) and ``shed`` (dropped by admission control) satisfy
        ``admitted == completed + lost + shed``, asserted by :meth:`drain`.
        Churn-runtime counters: device_down/device_up, replica_deaths,
        task_failovers, replans, recovered (instances that survived a
        replica death), salvages (partial-result resubmissions) and
        salvaged (instances that completed after at least one salvage)."""
        return self.engine.stats


_LAZY = {
    "run_one": ("repro_torch.sim.runner", "run_one"),
    "run_grid": ("repro_torch.sim.runner", "run_grid"),
    "sweep_alpha": ("repro_torch.sim.runner", "sweep_alpha"),
    "sweep_gamma": ("repro_torch.sim.runner", "sweep_gamma"),
    "SimConfig": ("repro_torch.sim.runner", "SimConfig"),
    "make_profile": ("repro_torch.sim.profiles", "make_profile"),
    "make_cluster": ("repro_torch.sim.profiles", "make_cluster"),
    "make_multi_tier_cluster": ("repro_torch.sim.profiles", "make_multi_tier_cluster"),
    "EdgeProfile": ("repro_torch.sim.profiles", "EdgeProfile"),
    "ChurnSchedule": ("repro_torch.sim.churn", "ChurnSchedule"),
    "ChurnEvent": ("repro_torch.sim.churn", "ChurnEvent"),
    "exponential_churn": ("repro_torch.sim.churn", "exponential_churn"),
    "deterministic_churn": ("repro_torch.sim.churn", "deterministic_churn"),
    "trace_churn": ("repro_torch.sim.churn", "trace_churn"),
    "churn_from_monitor": ("repro_torch.sim.churn", "churn_from_monitor"),
    "maintenance_windows": ("repro_torch.sim.churn", "maintenance_windows"),
    "correlated_churn": ("repro_torch.sim.churn", "correlated_churn"),
    "periodic_windows": ("repro_torch.sim.churn", "periodic_windows"),
    "device_groups": ("repro_torch.sim.churn", "device_groups"),
    "SurvivalForecast": ("repro_torch.core.availability", "SurvivalForecast"),
    # observability (repro_torch.obs): tracing and the engine's counters
    "Tracer": ("repro_torch.obs", "Tracer"),
    "Span": ("repro_torch.obs", "Span"),
    "SPAN_SCHEMA": ("repro_torch.obs", "SPAN_SCHEMA"),
    "EngineStats": ("repro_torch.obs", "EngineStats"),
    "ENGINE_COUNTERS": ("repro_torch.obs", "ENGINE_COUNTERS"),
    "MetricsRegistry": ("repro_torch.obs", "MetricsRegistry"),
}

# Names of the JAX package's façade whose modules the port has not reached
# yet, with where ROADMAP.md queues each.
_NOT_PORTED = {
    "ServingFleet": "serve/scheduler.py (ROADMAP.md, slice 5, item C.9)",
    **{name: "stream/ (ROADMAP.md, slice 5, item C.8)" for name in (
        "StreamingOrchestrator", "StreamResult", "AdmissionConfig",
        "AdmissionController", "PlacementLatencyEstimator", "ShedRecord",
        "SLOClass", "LATENCY_CRITICAL", "BEST_EFFORT", "AppStream", "Arrival",
        "default_streams", "poisson_arrivals", "diurnal_arrivals",
        "trace_replay",
    )},
    **{name: "obs/attribution.py and obs/export.py (ROADMAP.md, slice 5)"
       for name in (
           "attribution_report", "instance_breakdown", "format_report",
           "to_chrome_trace", "ledger_from_trace", "validate_chrome_trace",
           "json_summary",
       )},
}


def __getattr__(name: str):
    """Lazy re-exports of the grid runners, so that ``repro_torch.api``
    stays import-light and free of circular imports (the runners
    themselves build :class:`Orchestrator` instances).  A name whose
    module is not ported yet raises ``NotImplementedError`` saying where
    it is queued."""
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"repro_torch.api.{name}: {_NOT_PORTED[name]} is not ported yet"
        )
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module 'repro_torch.api' has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod_name), attr)
