"""Fleet-level serving scheduler: IBDASH over model replicas.

The mapping:
  edge device  -> model-replica group (a slice of pods serving one copy)
  task type    -> request class (prefill-heavy vs decode-heavy, ctx length)
  (m, c) plot  -> measured decode/prefill latency vs co-batched requests
                  (fit by serve.engine.measure_interference — real timings)
  model upload -> model/LoRA artifact load onto a replica (M_info = which
                  adapters are resident; LRU eviction under HBM pressure)
  failure      -> replica preemption (spot pods); exponential model
  replication  -> speculative duplicate dispatch of requests on flaky
                  replicas (first responder wins)

A request is itself a 2-task DAG: prefill -> decode, so the full Algorithm 1
machinery (stage barriers, transfer costs between stages placed on
different replicas = KV-cache migration cost) applies verbatim — the same
``repro_torch.core`` code that reproduces the paper schedules the serving fleet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..api import Orchestrator
from ..core.cluster import ClusterState, Device
from ..core.dag import AppDAG, TaskSpec
from ..core.interference import InterferenceModel
from ..core.policy import make_policy
from ..sim.engine import SimResult

__all__ = ["RequestClass", "make_request_dag", "ServingFleet"]

MB = 1e6

# Request classes = "task types" for the interference table.
#   0: prefill-short   1: prefill-long   2: decode-short   3: decode-long
N_REQUEST_TYPES = 4


@dataclass(frozen=True)
class RequestClass:
    name: str
    prefill_type: int
    decode_type: int
    kv_bytes: float              # KV-cache size moved if stages change replica
    adapter: Optional[str] = None
    adapter_bytes: float = 0.0


SHORT = RequestClass("short", 0, 2, kv_bytes=2 * MB)
LONG = RequestClass("long", 1, 3, kv_bytes=64 * MB,
                    adapter="lora-long", adapter_bytes=120 * MB)


def make_request_dag(req_id: str, rc: RequestClass) -> AppDAG:
    """prefill -> decode, with the KV cache as the inter-stage data."""
    return AppDAG.from_tasks(
        f"req-{rc.name}",
        [
            TaskSpec(
                f"prefill{req_id}", ttype=rc.prefill_type,
                out_bytes=rc.kv_bytes, model_id=rc.adapter,
                model_bytes=rc.adapter_bytes, mem_bytes=rc.kv_bytes,
            ),
            TaskSpec(
                f"decode{req_id}", ttype=rc.decode_type,
                deps=(f"prefill{req_id}",), out_bytes=0.1 * MB,
                model_id=rc.adapter, model_bytes=rc.adapter_bytes,
                mem_bytes=rc.kv_bytes,
            ),
        ],
    )


class ServingFleet:
    """A fleet of model replicas driven by any registered placement policy."""

    def __init__(
        self,
        interference: InterferenceModel,
        *,
        n_replicas: int = 16,
        replica_classes: Optional[Sequence[int]] = None,
        lams: Sequence[float] = (1e-5, 8e-4),      # (reserved, spot)
        hbm_bytes: float = 16e9,
        link_bw: float = 2e9,
        # Optional placement-domain topology: per-replica tier ids (same pod /
        # same rack / cross-zone) plus up/down rates and a (T, T) backhaul
        # matrix — KV-cache migration between stages is then priced over the
        # pairwise bw_eff[s, d] link instead of a flat fleet-wide rate.
        tiers: Optional[Sequence[int]] = None,
        up_bw: Optional[Sequence[float]] = None,
        down_bw: Optional[Sequence[float]] = None,
        backhaul: Optional[np.ndarray] = None,
        policy: str = "ibdash",
        alpha: float = 0.5,
        beta: float = 0.1,
        gamma: int = 2,
        seed: int = 0,
        horizon: float = 120.0,
        latency_budget: float = float("inf"),
        # -- churn runtime: replica preemption + recovery ----------------------
        # ``churn=True`` generates exponential preemption/re-provision cycles
        # over the replicas from their lams; or pass a ChurnSchedule.  When a
        # replica dies mid-request, ``recovery="replan"`` re-places the
        # in-flight stages on the survivors — the decode stage's KV cache is
        # re-sharded onto the new replica at the link-matrix transfer price.
        churn=None,
        recovery: str = "fail_fast",
        detection_delay: float = 0.1,
        max_retries: int = 2,
        mean_downtime: float = 15.0,
        churn_seed: int = 7,
        # Where the fleet's policy runs its decision kernels: the card
        # unless the caller names the CPU.
        device="cuda",
    ):
        self.interference = interference
        classes = (
            list(replica_classes)
            if replica_classes is not None
            else [i % 2 for i in range(n_replicas)]   # alternate reserved/spot
        )
        rng = np.random.default_rng(seed)
        devices = []
        for i, cls in enumerate(classes):
            lam = float(lams[cls])
            lifetime = rng.exponential(1 / lam) if lam > 0 else float("inf")
            devices.append(Device(
                did=i, cls=cls, mem_total=hbm_bytes, lam=lam,
                alive_until=lifetime,
                tier=int(tiers[i]) if tiers is not None else 0,
                up_bw=float(up_bw[i]) if up_bw is not None else link_bw,
                down_bw=float(down_bw[i]) if down_bw is not None else link_bw,
            ))
        self.cluster = ClusterState(
            devices=devices, model=interference, horizon=horizon, dt=0.02,
            backhaul=backhaul, device=device,
        )
        if churn is True:
            from ..sim.churn import exponential_churn

            churn = exponential_churn(
                self.cluster, horizon=horizon, seed=churn_seed,
                rejoin=True, mean_downtime=mean_downtime,
            )
        # Every scheme comes out of the policy registry; the online flow is
        # the unified Orchestrator façade (submit -> step -> result).
        self.orchestrator = Orchestrator(
            self.cluster,
            make_policy(policy, alpha=alpha, beta=beta, gamma=gamma, seed=seed,
                        latency_budget=latency_budget, device=self.cluster.device),
            seed=seed,
            churn=churn,
            recovery=recovery,
            detection_delay=detection_delay,
            max_retries=max_retries,
        )
        self.horizon = horizon

    @property
    def policy(self):
        return self.orchestrator.policy

    @property
    def engine(self):
        """Back-compat alias for callers that poked at the raw engine."""
        return self.orchestrator.engine

    def run(
        self,
        n_requests: int = 500,
        long_frac: float = 0.3,
        arrival_window: float = 20.0,
        seed: int = 1,
        fused: bool = False,
        admission: Optional["AdmissionConfig"] = None,
        admission_slo: Tuple[float, float] = (2.0, 10.0),
        tick: float = 0.1,
    ) -> SimResult:
        """Serve a request stream.  ``fused=True`` admission-plans the whole
        wave with one batched ``decide_batch`` call per stage (prefill wave,
        then decode wave) — the bulk-admission mode for traffic spikes.

        Passing ``admission`` (an :class:`repro_torch.stream.AdmissionConfig`)
        routes the request stream through the SAME bounded admission queue
        the simulator's streaming service uses: short requests become the
        ``latency_critical`` class, long requests ``best_effort``
        (``admission_slo`` gives their E2E deadlines in seconds), overload
        is deadline-shed/backpressured instead of queued forever, and the
        returned result carries the service's
        :class:`~repro_torch.stream.StreamResult` as ``res.stream``."""
        rng = np.random.default_rng(seed)
        if admission is not None:
            return self._run_admitted(
                n_requests, long_frac, arrival_window, rng, admission,
                admission_slo, tick,
            )
        apps, times = [], []
        for i in range(n_requests):
            rc = LONG if rng.random() < long_frac else SHORT
            apps.append(make_request_dag(f"#{i}", rc))
            times.append(float(rng.uniform(0.0, arrival_window)))
        self.orchestrator.submit_batch(apps, sorted(times), fused=fused)
        self.orchestrator.step(until=self.horizon)
        return self.orchestrator.result(scenario="serving", horizon=self.horizon)

    def _run_admitted(
        self,
        n_requests: int,
        long_frac: float,
        arrival_window: float,
        rng: np.random.Generator,
        admission: "AdmissionConfig",
        admission_slo: Tuple[float, float],
        tick: float,
    ) -> SimResult:
        from ..stream import (
            Arrival,
            AppStream,
            SLOClass,
            StreamingOrchestrator,
        )

        short_slo = SLOClass("latency_critical", admission_slo[0], True)
        long_slo = SLOClass("best_effort", admission_slo[1], False)
        streams = {
            "short": AppStream(
                "short", lambda: make_request_dag("", SHORT), slo=short_slo
            ),
            "long": AppStream(
                "long", lambda: make_request_dag("", LONG), slo=long_slo
            ),
        }
        rows = []
        for _ in range(n_requests):
            name = "long" if rng.random() < long_frac else "short"
            rows.append((float(rng.uniform(0.0, arrival_window)), name))
        rows.sort(key=lambda r: r[0])
        arrivals = [
            Arrival(
                t=t, slo=streams[name].slo,
                deadline=t + streams[name].slo.deadline,
                stream=streams[name], uid=uid,
            )
            for uid, (t, name) in enumerate(rows)
        ]
        service = StreamingOrchestrator(
            self.orchestrator, admission=admission, tick=tick,
        )
        stream_res = service.run(arrivals)
        res = self.orchestrator.result(
            scenario="serving", horizon=self.horizon
        )
        res.stream = stream_res
        return res


def serving_interference_model(
    m_short: float = 0.004, c_short: float = 0.035,
    m_long: float = 0.012, c_long: float = 0.220,
    n_classes: int = 2, fast_factor: float = 0.6,
) -> InterferenceModel:
    """Build the replica interference table from measured (m, c) pairs
    (defaults match CPU measurements of the tiny-model engine; production
    would feed measure_interference outputs per hardware class)."""
    base = np.zeros((n_classes, N_REQUEST_TYPES))
    slope = np.zeros((n_classes, N_REQUEST_TYPES, N_REQUEST_TYPES))
    c = np.array([c_short, c_long, c_short * 0.5, c_long * 0.5])
    m = np.array([m_short, m_long, m_short, m_long])
    for cls in range(n_classes):
        f = 1.0 if cls == 0 else 1.0 / fast_factor   # class 1 = slower spot HW
        base[cls] = c * f
        # decode-vs-decode contention dominates; prefill adds compute bursts
        for i in range(N_REQUEST_TYPES):
            for j in range(N_REQUEST_TYPES):
                scale = 1.0 if (i >= 2) == (j >= 2) else 1.6
                slope[cls, i, j] = m[i] * scale * f
    return InterferenceModel(base=base, slope=slope)
