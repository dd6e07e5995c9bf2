"""Open-loop arrival processes for the always-on orchestration service.

The paper's evaluation replays a fixed closed-loop burst (~1000 instances
inside each cycle's first 1.5 s); real AR/video-analytics traffic is an
open-loop *stream* whose rate the fleet cannot always absorb.  This module
generates that stream:

  * :func:`poisson_arrivals` — homogeneous Poisson traffic per app stream;
  * :func:`diurnal_arrivals` — a time-varying (sinusoidal day-shape) rate,
    sampled by thinning a homogeneous process at the peak rate;
  * :func:`trace_replay` — replay of recorded ``(t, stream[, deadline])``
    rows, so a production trace can drive the simulator directly.

Determinism contract (same as :mod:`repro_torch.sim.churn`): every stream draws
from ONE rng keyed by ``(seed, stream index)``, so adding or removing a
stream never reshuffles any other stream's arrival times — workload mixes
are extensible under common random numbers.

Arrivals are deliberately *lazy* about DAG construction: an
:class:`Arrival` carries its :class:`AppStream` (builder + SLO class) and
only instantiates the relabelled :class:`~repro_torch.core.dag.AppDAG` when the
admission controller actually dispatches it.  Shed work therefore costs a
few hundred nanoseconds, and generation sustains well over 10k
instances/sec (gated in the JAX package's ``benchmarks/bench_stream.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..core.dag import AppDAG

__all__ = [
    "SLOClass",
    "LATENCY_CRITICAL",
    "BEST_EFFORT",
    "AppStream",
    "Arrival",
    "default_streams",
    "poisson_arrivals",
    "diurnal_arrivals",
    "trace_replay",
]


@dataclass(frozen=True)
class SLOClass:
    """A service-level objective class the admission controller trades off.

    ``deadline`` is the end-to-end budget in seconds from *arrival* (not
    dispatch).  ``critical`` classes are dequeued first, are only ever
    deadline-shed when they provably cannot finish even on an idle fleet,
    and under queue pressure evict ``best_effort`` entries instead of being
    dropped themselves."""

    name: str
    deadline: float
    critical: bool = False


LATENCY_CRITICAL = SLOClass("latency_critical", deadline=6.0, critical=True)
BEST_EFFORT = SLOClass("best_effort", deadline=30.0, critical=False)


@dataclass(frozen=True)
class AppStream:
    """One application traffic stream: a DAG builder plus its SLO class.

    ``weight`` is the stream's share of the total offered rate."""

    name: str
    builder: Callable[[], AppDAG]
    slo: SLOClass = BEST_EFFORT
    weight: float = 1.0


@dataclass
class Arrival:
    """One ``(app, class, deadline, t)`` event of the open-loop stream.

    Either ``stream`` (lazy: the DAG is built at dispatch) or ``app`` (an
    already-concrete instance, e.g. trace replay of recorded DAGs) is set.
    ``deadline`` is absolute simulation time."""

    t: float
    slo: SLOClass
    deadline: float
    stream: Optional[AppStream] = None
    app: Optional[AppDAG] = None
    uid: int = -1

    @property
    def kind(self) -> str:
        """Stable workload key (estimator cache key; NOT instance-unique)."""
        return self.stream.name if self.stream is not None else self.app.name

    def instantiate(self) -> AppDAG:
        """The concrete DAG instance, with instance-unique task names."""
        if self.app is not None:
            return self.app
        return self.stream.builder().relabel(f"#{self.uid}")


def default_streams(
    critical: Sequence[str] = ("video", "matrix"),
    *,
    slo_critical: float = LATENCY_CRITICAL.deadline,
    slo_best_effort: float = BEST_EFFORT.deadline,
) -> Tuple[AppStream, ...]:
    """The paper's four applications as streams: ``critical`` names get the
    ``latency_critical`` class (AR-style traffic), the rest ``best_effort``."""
    from ..sim.apps import APP_BUILDERS

    crit = SLOClass("latency_critical", deadline=slo_critical, critical=True)
    best = SLOClass("best_effort", deadline=slo_best_effort, critical=False)
    return tuple(
        AppStream(name, builder, slo=crit if name in critical else best)
        for name, builder in APP_BUILDERS.items()
    )


def _stream_rng(seed: int, idx: int) -> np.random.Generator:
    """The keyed-stream contract: one rng per (seed, stream index)."""
    return np.random.default_rng((int(seed), int(idx)))


def _poisson_times(
    rng: np.random.Generator, rate: float, horizon: float, t0: float
) -> np.ndarray:
    """Vectorised homogeneous Poisson event times on [t0, t0 + horizon)."""
    if rate <= 0.0 or horizon <= 0.0:
        return np.empty(0)
    n_guess = int(rate * horizon + 6 * np.sqrt(rate * horizon) + 16)
    gaps = rng.exponential(1.0 / rate, size=n_guess)
    times = np.cumsum(gaps)
    while times.size and times[-1] < horizon:       # rare under-draw
        extra = rng.exponential(1.0 / rate, size=max(16, n_guess // 4))
        times = np.concatenate([times, times[-1] + np.cumsum(extra)])
    return t0 + times[times < horizon]


def _merge(
    streams: Sequence[AppStream], per_stream: List[np.ndarray]
) -> List[Arrival]:
    """Time-sort the per-stream event times into one Arrival list with
    deterministic uids (ties broken by stream index)."""
    ts = np.concatenate(per_stream) if per_stream else np.empty(0)
    sidx = np.concatenate(
        [np.full(t.size, i, dtype=np.int64) for i, t in enumerate(per_stream)]
    ) if per_stream else np.empty(0, dtype=np.int64)
    order = np.lexsort((sidx, ts))
    out: List[Arrival] = []
    for uid, j in enumerate(order.tolist()):
        s = streams[sidx[j]]
        t = float(ts[j])
        out.append(Arrival(
            t=t, slo=s.slo, deadline=t + s.slo.deadline, stream=s, uid=uid,
        ))
    return out


def poisson_arrivals(
    streams: Sequence[AppStream],
    rate: float,
    horizon: float,
    *,
    seed: int = 0,
    t0: float = 0.0,
) -> List[Arrival]:
    """Homogeneous Poisson traffic at ``rate`` total instances/sec, split
    across ``streams`` by weight, on ``[t0, t0 + horizon)``."""
    wsum = sum(s.weight for s in streams)
    per = [
        _poisson_times(_stream_rng(seed, i), rate * s.weight / wsum, horizon, t0)
        for i, s in enumerate(streams)
    ]
    return _merge(list(streams), per)


def diurnal_arrivals(
    streams: Sequence[AppStream],
    base_rate: float,
    peak_rate: float,
    horizon: float,
    *,
    period: float = 60.0,
    phase: float = 0.0,
    seed: int = 0,
    t0: float = 0.0,
) -> List[Arrival]:
    """Time-varying (diurnal) traffic: the instantaneous rate follows

        lam(t) = base + (peak - base) * (1 - cos(2 pi (t - phase) / period)) / 2

    (troughs at ``phase`` modulo ``period``), sampled by thinning a
    homogeneous process at ``peak_rate`` — the standard exact method for
    inhomogeneous Poisson streams."""
    if peak_rate < base_rate:
        raise ValueError("peak_rate must be >= base_rate")
    wsum = sum(s.weight for s in streams)
    per: List[np.ndarray] = []
    for i, s in enumerate(streams):
        rng = _stream_rng(seed, i)
        peak_i = peak_rate * s.weight / wsum
        cand = _poisson_times(rng, peak_i, horizon, 0.0)
        lam = base_rate + (peak_rate - base_rate) * 0.5 * (
            1.0 - np.cos(2.0 * np.pi * (cand - phase) / period)
        )
        keep = rng.random(cand.size) < lam / peak_rate
        per.append(t0 + cand[keep])
    return _merge(list(streams), per)


def trace_replay(
    rows: Iterable[tuple],
    streams: Sequence[AppStream],
) -> List[Arrival]:
    """Replay recorded traffic: rows of ``(t, stream_name)`` or
    ``(t, stream_name, deadline)`` (absolute deadline overriding the
    stream's SLO default).  Rows are sorted by time; uids follow that
    order, so a replay is bit-deterministic."""
    by_name = {s.name: s for s in streams}
    parsed = []
    for row in rows:
        t, name = float(row[0]), row[1]
        s = by_name[name]
        deadline = float(row[2]) if len(row) > 2 else t + s.slo.deadline
        parsed.append((t, s, deadline))
    parsed.sort(key=lambda r: r[0])
    return [
        Arrival(t=t, slo=s.slo, deadline=deadline, stream=s, uid=uid)
        for uid, (t, s, deadline) in enumerate(parsed)
    ]
