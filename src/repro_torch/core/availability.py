"""Device availability / failure prediction (paper §V-F, Fig. 7, Table IV).

The paper models the probability that an edge device is still available
``t`` seconds after it joined the platform as ``P(ED) = exp(-lambda * t)``,
with per-device failure rates ``lambda`` (Table IV: lambda_1 = mixed
PED+CED, lambda_2 = CED-only, lambda_3 = PED-only).  It validates the model
against a one-month campus mobility trace [13].

For the distributed-training runtime the same exponential model drives two
production decisions:

  * the probability that a (preemptible) pod dies during a task of length L
    — memoryless, so ``F = 1 - exp(-lambda * L)`` — which feeds the
    replication loop of Algorithm 1 and the straggler/backup-task policy;
  * the optimal checkpoint cadence: for exponential failures with MTBF
    ``1/lambda`` and checkpoint write cost ``C`` the Young/Daly interval
    ``sqrt(2 * C / lambda)`` minimises expected lost work.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "availability",
    "prob_fail_during",
    "sample_lifetime",
    "fit_failure_rate",
    "young_daly_interval",
    "expected_makespan_with_restarts",
    "SurvivalForecast",
    "LAMBDA_MIX",
    "LAMBDA_CED",
    "LAMBDA_PED",
]

# Table IV of the paper — failure rates per edge-device class ED0..ED7.
LAMBDA_MIX = np.array(
    [1.5e-6, 1.1e-4, 1.5e-4, 2.4e-5, 9e-6, 3.2e-6, 3.1e-5, 1e-7]
)
LAMBDA_CED = np.array(
    [1.5e-5, 1.1e-5, 1.5e-5, 1.1e-5, 1.8e-5, 1.2e-5, 1.0e-5, 2.0e-5]
)
LAMBDA_PED = np.array(
    [1.5e-4, 1.1e-4, 1.5e-4, 2.4e-4, 9e-4, 3.2e-5, 1.0e-4, 9.0e-4]
)


def availability(lam: float, t: float) -> float:
    """P(device still available ``t`` seconds after joining) = exp(-lam t)."""
    return float(np.exp(-lam * max(t, 0.0)))


def prob_fail_during(lam: float, duration: float) -> float:
    """``F(T_i)``: probability the device fails within ``duration`` seconds.

    The exponential law is memoryless, so the window's start does not
    matter — only its length."""
    return float(1.0 - np.exp(-lam * max(duration, 0.0)))


def prob_fail_during_vec(lam: np.ndarray, duration: np.ndarray) -> np.ndarray:
    return 1.0 - np.exp(-np.asarray(lam) * np.maximum(np.asarray(duration), 0.0))


def sample_lifetime(lam: float, rng: np.random.Generator) -> float:
    """Draw an exponential device lifetime (time from join until it leaves)."""
    if lam <= 0:
        return float("inf")
    return float(rng.exponential(1.0 / lam))


def fit_failure_rate(
    timestamps: Sequence[float], alive: Sequence[bool]
) -> float:
    """MLE of ``lambda`` from an availability trace.

    ``timestamps[i]`` is the elapsed time since join of observation ``i`` and
    ``alive[i]`` whether the device was still present.  Treats each device
    observation as a (possibly right-censored) exponential sample:
    lambda_hat = (#deaths) / (total observed alive-time).  This is what the
    paper fits on the CrowdBind mobility trace (Fig. 7a)."""
    t = np.asarray(timestamps, dtype=np.float64)
    a = np.asarray(alive, dtype=bool)
    if t.shape != a.shape or t.ndim != 1 or t.size == 0:
        raise ValueError("bad trace")
    deaths = int((~a).sum())
    exposure = float(t.sum())
    if exposure <= 0:
        raise ValueError("no exposure time in trace")
    return deaths / exposure


@dataclass(frozen=True)
class SurvivalForecast:
    """Per-device availability forecast: ``S_d(t, t + h)`` = probability that
    device ``d`` stays up throughout the span ``[t, t + h]`` given everything
    predictable at ``t``.

    The paper prices every future failure through the memoryless ``F(T_i)``
    term, yet personal-device departures are often *announced* (a maintenance
    calendar, a lecture timetable) — the mobility-aware orchestration line
    (arXiv:2110.07808) plans around exactly such forecastable departures.
    This object separates the two hazard components:

      * ``departures`` — per-device sorted KNOWN future departure times
        (scripted maintenance windows, calendars, trace replays).  Exact: a
        span reaching past the next known departure has survival 0.
      * ``lams`` — per-device residual stochastic hazard rates for the
        *unpredictable* component (MLE-extrapolated: individual exponential
        churn, shared-shock rates).  ``None`` = no stochastic hazard.

    A forecast is installed on a :class:`~repro_torch.core.cluster.ClusterState`
    (usually by ``ChurnSchedule.install``) and surfaces to policies two ways:
    sampled on a ``(K,)`` horizon grid as the ``surv_grid``/``survival``
    :class:`FleetSnapshot` pytree leaves, and — exactly, per candidate — as
    the ``survival`` column of the policy contexts, evaluated over each
    task's estimated execution span.  The ``churn_aware`` policy replaces the
    memoryless ``pf`` with ``1 - S_d`` where the forecast knows better.
    """

    departures: Tuple[Tuple[float, ...], ...]   # per-device sorted times
    lams: Optional[Tuple[float, ...]] = None    # (D,) stochastic rates
    horizon: float = 30.0                       # grid span for sample()
    n_points: int = 16                          # grid resolution K

    @property
    def n_devices(self) -> int:
        return len(self.departures)

    @staticmethod
    def from_rates(lams: Sequence[float], **kwargs) -> "SurvivalForecast":
        """Pure-stochastic forecast (no scripted departures known)."""
        lams = tuple(float(l) for l in lams)
        return SurvivalForecast(
            departures=((),) * len(lams), lams=lams, **kwargs
        )

    @cached_property
    def _lams_arr(self) -> Optional[np.ndarray]:
        if self.lams is None:
            return None
        return np.asarray(self.lams, dtype=np.float64)

    def next_departure(self, t: float) -> np.ndarray:
        """(D,) first known departure strictly after ``t`` (+inf if none).
        A departure exactly at ``t`` is already visible as the device being
        down (``alive_mask``), so it does not bound future spans."""
        out = np.full(self.n_devices, np.inf)
        for d, deps in enumerate(self.departures):
            for tl in deps:                 # sorted: first hit wins
                if tl > t:
                    out[d] = tl
                    break
        return out

    def survival(self, t: float, spans: np.ndarray) -> np.ndarray:
        """(D,) survival over per-device spans: ``S_d(t, t + spans[d])``.

        Exact for the scripted component — survival is 1.0 up to (and
        including: the engine's ``ok = completion <= alive_until``) the next
        known departure, 0.0 past it — times the extrapolated stochastic
        survival ``exp(-lam_d * span)``."""
        spans = np.maximum(np.asarray(spans, dtype=np.float64), 0.0)
        if self._lams_arr is not None:
            s = np.exp(-self._lams_arr * spans)
        else:
            s = np.ones(self.n_devices)
        return np.where(t + spans <= self.next_departure(t), s, 0.0)

    def grid(self) -> np.ndarray:
        """(K,) span offsets the sampled tensor is evaluated at."""
        return np.linspace(0.0, self.horizon, self.n_points)

    def sample(self, t: float) -> np.ndarray:
        """(D, K) survival tensor over the horizon grid at instant ``t`` —
        the :class:`FleetSnapshot` ``survival`` leaf."""
        g = self.grid()
        if self._lams_arr is not None:
            s = np.exp(-self._lams_arr[:, None] * g[None, :])
        else:
            s = np.ones((self.n_devices, g.shape[0]))
        nxt = self.next_departure(t)
        return np.where(t + g[None, :] <= nxt[:, None], s, 0.0)


def young_daly_interval(lam: float, ckpt_cost: float) -> float:
    """Optimal checkpoint interval ``sqrt(2 C / lambda)`` for exponential
    failures (Young '74 / Daly '06).  ``lam`` is the failure rate of the
    *job* (sum of member-pod rates for a gang-scheduled job)."""
    if lam <= 0:
        return float("inf")
    if ckpt_cost < 0:
        raise ValueError("checkpoint cost must be >= 0")
    return float(np.sqrt(2.0 * ckpt_cost / lam))


def expected_makespan_with_restarts(
    work: float, lam: float, ckpt_cost: float, interval: Optional[float] = None,
    restart_cost: float = 0.0,
) -> float:
    """Expected wall-clock of ``work`` seconds of compute under exponential
    failures with rate ``lam``, checkpointing every ``interval`` seconds at
    cost ``ckpt_cost`` (Daly's first-order model).

    Used by the FT runtime to pick between checkpoint cadences and to price
    replication-vs-restart trade-offs, and by the tests as an oracle that
    the Young/Daly interval is (near-)optimal."""
    if lam <= 0:
        n_ckpt = 0 if interval in (None, float("inf")) else int(np.ceil(work / interval)) - 1
        return work + max(n_ckpt, 0) * ckpt_cost
    tau = young_daly_interval(lam, ckpt_cost) if interval is None else interval
    tau = min(tau, work)
    if tau <= 0:
        raise ValueError("interval must be positive")
    # Daly's first-order model: a segment holds tau useful seconds + a
    # checkpoint; expected #failures per segment is exp(lam*(tau+C)) - 1 and
    # the expected wall-clock per segment is (1/lam)(exp(lam*(tau+C)) - 1)
    # plus a restart cost per failure.
    fails = np.exp(lam * (tau + ckpt_cost)) - 1.0
    seg = (1.0 / lam) * fails + fails * restart_cost
    n_seg = work / tau
    return float(n_seg * seg)


def gang_failure_rate(lams: Sequence[float]) -> float:
    """A gang-scheduled job fails when *any* member fails: rates add."""
    return float(np.sum(np.asarray(lams, dtype=np.float64)))
