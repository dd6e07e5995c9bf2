"""Experiment runner: reproduces the paper's evaluation grids (§V-G..J).

Protocol (paper §V-G): ``n_cycles`` cycles of ``cycle_len`` seconds;
``instances_per_cycle`` application instances arrive uniformly inside the
first ``arrival_window`` seconds of each cycle; the application mix is
uniform over the four test applications; the fleet is ``n_devices`` devices
uniform over the 8 Table-III classes.

Fairness: every scheme sees the *same* environment draw — identical device
lifetimes, arrival times and application instances (common random numbers).

Every scheme is built through the policy registry
(``make_policy(name, **kwargs)``) and driven online through the unified
:class:`repro_torch.api.Orchestrator` façade — there is no per-scheme
construction code here.  ``SimConfig.device`` says where the policies'
decision kernels run (the card by default); the scenario ``stream`` drives
the always-on streaming service (:mod:`repro_torch.stream`) there too.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.dag import AppDAG
from ..core.policy import Policy, available_policies, make_policy
from .apps import APP_BUILDERS
from .engine import Engine, SimResult
from .profiles import EdgeProfile, make_cluster, make_profile

__all__ = [
    "SimConfig",
    "policy_for",
    "make_churn",
    "run_one",
    "run_grid",
    "sweep_alpha",
    "sweep_gamma",
    "SCHEME_NAMES",
    "ALL_SCHEME_NAMES",
]

SCHEME_NAMES = ("ibdash", "lats", "lavea", "petrel", "round_robin", "random")
# The paper's six schemes plus the multi-tier escalation policy (which only
# differs from greedy-min-latency on fleets that declare tiers) and the
# forecast-aware IBDASH variant (which only differs from ibdash on clusters
# with an installed availability forecast).
ALL_SCHEME_NAMES = SCHEME_NAMES + ("tier_escalation", "churn_aware")


@dataclass
class SimConfig:
    scenario: str = "mix"
    n_devices: int = 100
    n_cycles: int = 20
    cycle_len: float = 15.0
    arrival_window: float = 1.5
    instances_per_cycle: int = 1000
    seed: int = 0
    noise_sigma: float = 0.10
    alpha: float = 0.5
    beta: float = 0.1
    gamma: int = 3
    # tier_escalation: escalate device -> edge -> cloud once the best
    # same-or-lower-tier candidate's Eq. (2) latency exceeds this budget.
    latency_budget: float = float("inf")
    # Plan each cycle's burst in one fused `orchestrate_batch` wave (all
    # plans share the cycle-start fleet snapshot) instead of per arrival.
    fused_burst: bool = False
    # -- churn runtime (repro_torch.sim.churn + repro_torch.core.recovery) -----------------
    # Recovery strategy when a task loses its last replica: "fail_fast"
    # (Eq. 4, bit-identical to the seed engine), "failover", or "replan".
    recovery: str = "fail_fast"
    # None = churn auto-enables for the churn scenarios only; True/False forces.
    churn: Optional[bool] = None
    churn_seed: Optional[int] = None    # None = seed + 101
    rejoin: bool = True                 # departed devices rejoin after downtime
    mean_downtime: float = 20.0         # Exp() mean seconds away per departure
    detection_delay: float = 0.25       # missed-heartbeat detection lag
    max_retries: int = 2                # failover/replan attempts per task
    # Partial-result salvage attempts per instance (0 = off): a lost
    # instance with completed stages is re-planned via orchestrate(pinned=)
    # instead of discarded.
    salvage: int = 0
    # -- correlated churn (scenario "correlated_churn") ------------------------
    churn_groups: int = 8               # shared-shock groups (did % groups)
    shock_rate: float = 0.005           # per-group mass-departure rate (1/s)
    maintenance_period: float = 7.5     # one scripted drain per period...
    maintenance_duration: float = 5.0   # ...taking a group down this long
    maintenance_phase: float = 1.0      # first window start offset
    # -- streaming service (scenario "stream") ---------------------------------
    stream_rate: float = 120.0          # offered load, instances/sec
    stream_process: str = "poisson"     # "poisson" | "diurnal"
    stream_peak_rate: Optional[float] = None  # diurnal peak (None = 2x rate)
    stream_period: float = 60.0         # diurnal period, seconds
    stream_queue_cap: Optional[int] = 512
    stream_admission: bool = True       # False = no-admission baseline
    stream_tick: float = 0.25           # service-loop dispatch tick
    stream_wave: Optional[int] = None   # max instances per dispatch wave
    slo_critical: float = 6.0           # latency_critical E2E budget (s)
    slo_best_effort: float = 30.0       # best_effort E2E budget (s)
    stream_metrics_interval: float = 1.0
    # -- observability (repro_torch.obs) ---------------------------------------------
    # True: attach a Tracer to the engine; the returned SimResult carries
    # it as ``res.trace``.
    trace: bool = False
    # -- device ------------------------------------------------------------------
    # Where the profile, cluster and policies plan: the card unless "cpu".
    device: str = "cuda"

    @property
    def churn_enabled(self) -> bool:
        if self.churn is not None:
            return self.churn
        return self.scenario in ("churn", "correlated_churn")

    @property
    def horizon(self) -> float:
        return self.n_cycles * self.cycle_len


def policy_for(name: str, profile: EdgeProfile, cfg: SimConfig) -> Policy:
    """Uniform registry construction: one kwarg bundle serves every scheme."""
    return make_policy(
        name,
        alpha=cfg.alpha,
        beta=cfg.beta,
        gamma=cfg.gamma,
        seed=cfg.seed,
        lats_model=profile.lats_model,
        latency_budget=cfg.latency_budget,
        device=cfg.device,
    )


def _make_workload(cfg: SimConfig) -> Tuple[List[AppDAG], List[float]]:
    """Deterministic (apps, arrival times) shared by every scheme."""
    rng = np.random.default_rng(cfg.seed + 1)
    builders = list(APP_BUILDERS.values())
    apps: List[AppDAG] = []
    times: List[float] = []
    uid = 0
    for c in range(cfg.n_cycles):
        t0 = c * cfg.cycle_len
        arr = np.sort(rng.uniform(0.0, cfg.arrival_window, cfg.instances_per_cycle))
        for t in arr:
            base = builders[int(rng.integers(len(builders)))]()
            apps.append(base.relabel(f"#{uid}"))
            times.append(float(t0 + t))
            uid += 1
    return apps, times


def make_churn(cfg: SimConfig, cluster) -> Optional["ChurnSchedule"]:
    """Build the scenario's churn schedule over an already-built cluster
    (shared by run_one, the churn benchmark and the demo): exponential
    leave/rejoin cycles by default, the correlated generator — per-group
    shared shocks plus rotating scripted maintenance windows — for
    scenario "correlated_churn".  Returns None when churn is disabled."""
    if not cfg.churn_enabled:
        return None
    # lazy: keeps the import graph flat
    from .churn import (
        correlated_churn,
        device_groups,
        exponential_churn,
        periodic_windows,
    )

    seed = cfg.seed + 101 if cfg.churn_seed is None else cfg.churn_seed
    horizon = cfg.horizon + 25.0
    if cfg.scenario == "correlated_churn":
        groups = device_groups(cluster.n_devices, cfg.churn_groups)
        windows = periodic_windows(
            groups,
            period=cfg.maintenance_period,
            duration=cfg.maintenance_duration,
            horizon=horizon,
            phase=cfg.maintenance_phase,
        )
        return correlated_churn(
            cluster, horizon=horizon, seed=seed, groups=groups,
            shock_rate=cfg.shock_rate, rejoin=cfg.rejoin,
            mean_downtime=cfg.mean_downtime, windows=windows,
        )
    return exponential_churn(
        cluster, horizon=horizon, seed=seed, rejoin=cfg.rejoin,
        mean_downtime=cfg.mean_downtime,
    )


def _run_stream(cfg: SimConfig, scheme: str, profile: EdgeProfile) -> SimResult:
    """Scenario ``"stream"``: open-loop arrivals through the always-on
    service (:mod:`repro_torch.stream`) instead of the closed-loop cycle
    burst, on ``cfg.device``.  The returned :class:`SimResult` carries the
    full :class:`~repro_torch.stream.service.StreamResult` as ``res.stream``."""
    from ..api import Orchestrator
    from ..stream import (
        AdmissionConfig,
        StreamingOrchestrator,
        default_streams,
        diurnal_arrivals,
        poisson_arrivals,
    )

    # Generous horizon: the no-admission baseline drains its backlog long
    # after the last arrival.
    cluster = make_cluster(
        profile, scenario="stream", n_devices=cfg.n_devices, seed=cfg.seed,
        horizon=cfg.horizon * 3.0 + 60.0, device=cfg.device,
    )
    churn = make_churn(cfg, cluster)
    orch = Orchestrator(
        cluster, policy_for(scheme, profile, cfg),
        seed=cfg.seed, noise_sigma=cfg.noise_sigma,
        churn=churn, recovery=cfg.recovery, salvage=cfg.salvage,
        detection_delay=cfg.detection_delay, max_retries=cfg.max_retries,
        trace=cfg.trace,
    )
    streams = default_streams(
        slo_critical=cfg.slo_critical, slo_best_effort=cfg.slo_best_effort
    )
    if cfg.stream_process == "diurnal":
        peak = cfg.stream_peak_rate or 2.0 * cfg.stream_rate
        arrivals = diurnal_arrivals(
            streams, cfg.stream_rate, peak, cfg.horizon,
            period=cfg.stream_period, seed=cfg.seed + 7,
        )
    elif cfg.stream_process == "poisson":
        arrivals = poisson_arrivals(
            streams, cfg.stream_rate, cfg.horizon, seed=cfg.seed + 7,
        )
    else:
        raise ValueError(f"unknown stream_process {cfg.stream_process!r}")
    admission = (
        AdmissionConfig(queue_cap=cfg.stream_queue_cap)
        if cfg.stream_admission else None
    )
    service = StreamingOrchestrator(
        orch, admission=admission, tick=cfg.stream_tick,
        wave_cap=cfg.stream_wave,
        metrics_interval=cfg.stream_metrics_interval,
    )
    stream_res = service.run(arrivals)
    res = stream_res.result
    res.stream = stream_res            # SimResult is a plain dataclass
    if cfg.trace:
        res.trace = orch.trace
    return res


def run_one(
    scheme: str,
    cfg: SimConfig,
    profile: Optional[EdgeProfile] = None,
) -> SimResult:
    from ..api import Orchestrator  # lazy: api sits above sim in the layering

    profile = profile or make_profile(seed=cfg.seed, device=cfg.device)
    if cfg.scenario == "stream":
        return _run_stream(cfg, scheme, profile)
    cluster = make_cluster(
        profile, scenario=cfg.scenario, n_devices=cfg.n_devices, seed=cfg.seed,
        horizon=cfg.horizon + 30.0, device=cfg.device,
    )
    churn = make_churn(cfg, cluster)
    orch = Orchestrator(
        cluster, policy_for(scheme, profile, cfg),
        seed=cfg.seed, noise_sigma=cfg.noise_sigma,
        churn=churn, recovery=cfg.recovery, salvage=cfg.salvage,
        detection_delay=cfg.detection_delay, max_retries=cfg.max_retries,
        trace=cfg.trace,
    )
    apps, times = _make_workload(cfg)
    if cfg.fused_burst:
        # One fused wave per cycle: advance the clock to each cycle start,
        # then plan that cycle's burst against the fleet state at that
        # instant (running tasks from earlier cycles included).
        per = cfg.instances_per_cycle
        for c in range(cfg.n_cycles):
            orch.step(until=c * cfg.cycle_len)
            orch.submit_batch(
                apps[c * per:(c + 1) * per],
                times[c * per:(c + 1) * per],
                fused=True,
            )
    else:
        orch.submit_batch(apps, times)
    orch.step(until=cfg.horizon + 25.0)
    res = orch.result(scenario=cfg.scenario, horizon=cfg.horizon)
    if cfg.trace:
        res.trace = orch.trace
    return res


def run_grid(
    schemes: Sequence[str] = SCHEME_NAMES,
    scenarios: Sequence[str] = ("ced", "ped", "mix"),
    cfg: Optional[SimConfig] = None,
) -> Dict[Tuple[str, str], SimResult]:
    """The full Fig. 8 / Fig. 9 grid: scheme x scenario."""
    cfg = cfg or SimConfig()
    profile = make_profile(seed=cfg.seed, device=cfg.device)
    out: Dict[Tuple[str, str], SimResult] = {}
    for scen in scenarios:
        for scheme in schemes:
            out[(scheme, scen)] = run_one(
                scheme, replace(cfg, scenario=scen), profile
            )
    return out


def sweep_alpha(
    alphas: Sequence[float],
    cfg: Optional[SimConfig] = None,
) -> List[Tuple[float, float, float]]:
    """Fig. 12a: sweep the joint-optimisation weight.  Returns
    (alpha, avg service time, avg P_f) triples."""
    cfg = cfg or SimConfig(scenario="mix")
    profile = make_profile(seed=cfg.seed, device=cfg.device)
    rows = []
    for a in alphas:
        res = run_one("ibdash", replace(cfg, alpha=float(a)), profile)
        rows.append((float(a), res.avg_service_time, res.prob_failure))
    return rows


def sweep_gamma(
    gammas: Sequence[int],
    cfg: Optional[SimConfig] = None,
) -> List[Tuple[int, float, float, float]]:
    """Fig. 12b: sweep the replication-degree cap.  Returns
    (gamma, avg service time, avg P_f, avg #replicas) tuples."""
    cfg = cfg or SimConfig(scenario="ped")
    profile = make_profile(seed=cfg.seed, device=cfg.device)
    rows = []
    for g in gammas:
        res = run_one("ibdash", replace(cfg, gamma=int(g)), profile)
        nrep = float(np.mean([r.n_replicas for r in res.instances]))
        rows.append((int(g), res.avg_service_time, res.prob_failure, nrep))
    return rows
