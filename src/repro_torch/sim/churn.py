"""Device lifecycle event streams for the churn runtime (paper §V-F).

The paper models a device's availability as ``P(ED) = exp(-lambda t)`` and
validates the exponential fit on a one-month campus mobility trace — but
the seed simulator only ever *sampled* one lifetime per device and let
tasks silently land on the departed.  This module turns the availability
model into an explicit event stream the engine can react to:

  * :func:`exponential_churn` — per-device exponential leave/rejoin cycles
    from the fleet's Table-IV rates (or any per-device override, e.g. the
    live lambda-MLE estimates of :class:`repro.ft.runtime.FleetMonitor`);
  * :func:`deterministic_churn` — an explicit ``(t, did, kind)`` script
    (tests, adversarial what-if schedules);
  * :func:`trace_churn` — replay of an availability trace: timestamped
    ``(t, did, alive)`` observations, exactly the shape
    :func:`repro_torch.core.availability.fit_failure_rate` consumes — so one
    recorded trace can both fit the model and drive the simulator;
  * :func:`churn_from_monitor` — the ``sim``/``ft`` bridge: generate churn
    at the failure rates a :class:`FleetMonitor` estimated online, closing
    the loop between heartbeat-observed reality and simulated futures;
  * :func:`maintenance_windows` — scripted mass drains: whole device groups
    leave at a known instant and return together (the "end of a lecture
    empties the room" shape of mobility traces, arXiv:2110.07808);
  * :func:`correlated_churn` — Marshall–Olkin-style shared shocks: each
    group carries a Poisson shock process that departs every member at
    once, compounded with per-device individual churn and (optionally)
    scripted maintenance windows — the correlated mass-departure stress
    the per-device-independent generators cannot produce.

Determinism contract: every stochastic generator draws each device's
lifetimes from ONE stream keyed by ``(seed, device_id)`` (and each group's
shocks from a stream keyed by the group), so adding or removing a device
never reshuffles any other device's schedule — fleets are extensible
under common random numbers.

A :class:`ChurnSchedule` installed on a cluster becomes the single source
of truth for device lifetimes: each device's ``alive_until`` is set to its
first scheduled departure (``+inf`` if it never leaves), join events carry
the device's next departure so a rejoined device knows its new lifetime,
and the engine turns the events into DEVICE_DOWN / DEVICE_UP processing.
Schedules also carry their *forecastable* side — per-device known departure
times (scripted windows) plus residual stochastic rates — which ``install``
turns into a :class:`~repro_torch.core.availability.SurvivalForecast` on the
cluster, making the churn schedule a first-class policy input (the
``churn_aware`` policy plans around it) instead of only an engine event
source.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..core.cluster import ClusterState
from ..core.availability import SurvivalForecast, sample_lifetime

__all__ = [
    "ChurnEvent",
    "ChurnSchedule",
    "exponential_churn",
    "deterministic_churn",
    "trace_churn",
    "churn_from_monitor",
    "maintenance_windows",
    "correlated_churn",
    "periodic_windows",
    "device_groups",
]

LEAVE, JOIN = "leave", "join"


@dataclass(frozen=True)
class ChurnEvent:
    """One device lifecycle transition.

    ``until`` is only meaningful on ``join`` events: the device's next
    scheduled departure (``+inf`` if it stays), so the engine can re-arm
    ``alive_until`` — the ground truth the passive failure path and the
    in-flight ``ok`` precompute read — in O(1) at the event."""

    t: float
    did: int
    kind: str                       # "leave" | "join"
    until: float = float("inf")


@dataclass(frozen=True)
class ChurnSchedule:
    """A time-sorted stream of device leave/join events.

    ``known_departures``/``forecast_lams`` carry the schedule's
    *forecastable* side (what an orchestrator could plausibly know in
    advance): per-device scripted departure times, and residual stochastic
    hazard rates for the unpredictable component.  Schedules built from raw
    events (``ChurnSchedule(events)``) carry neither — they install no
    forecast and policies keep pricing failures through ``F(T_i)`` alone.
    """

    events: Tuple[ChurnEvent, ...]
    # per-device KNOWN future departure times (sorted); None = none scripted
    known_departures: Optional[Dict[int, Tuple[float, ...]]] = None
    # per-device stochastic hazard rates of the unpredictable component
    forecast_lams: Optional[Tuple[float, ...]] = None

    @property
    def n_events(self) -> int:
        return len(self.events)

    def __iter__(self):
        return iter(self.events)

    def device_events(self, did: int) -> Tuple[ChurnEvent, ...]:
        return tuple(ev for ev in self.events if ev.did == did)

    def first_leave(self, did: int) -> float:
        for ev in self.events:
            if ev.did == did and ev.kind == LEAVE:
                return ev.t
        return float("inf")

    # -- availability forecast (the schedule as a policy input) ---------------
    def forecaster(
        self, n_devices: int, *, horizon: float = 30.0, n_points: int = 16
    ) -> Optional[SurvivalForecast]:
        """Build the :class:`SurvivalForecast` this schedule supports, or
        None when the schedule carries no forecast metadata (hand-built
        event lists)."""
        if self.known_departures is None and self.forecast_lams is None:
            return None
        known = self.known_departures or {}
        deps = tuple(known.get(d, ()) for d in range(n_devices))
        lams = self.forecast_lams
        if lams is not None and len(lams) != n_devices:
            raise ValueError(
                f"forecast_lams covers {len(lams)} devices, asked for "
                f"{n_devices}"
            )
        return SurvivalForecast(
            departures=deps, lams=lams, horizon=horizon, n_points=n_points
        )

    def forecast(
        self,
        t: float,
        horizon: float = 30.0,
        *,
        n_points: int = 16,
        n_devices: Optional[int] = None,
    ) -> np.ndarray:
        """(D, K) survival-probability tensor at instant ``t``: entry
        ``[d, k]`` is P(device ``d`` stays up throughout
        ``[t, t + k/(K-1) * horizon]``).  Exact (0/1 cliffs) for the
        scripted component, ``exp(-lambda h)``-extrapolated for the
        stochastic one, all-ones when the schedule is not forecastable."""
        if n_devices is None:
            dids = [ev.did for ev in self.events]
            if self.known_departures:
                dids += list(self.known_departures)
            if self.forecast_lams is not None:
                dids.append(len(self.forecast_lams) - 1)
            n_devices = max(dids) + 1 if dids else 0
        fc = self.forecaster(n_devices, horizon=horizon, n_points=n_points)
        if fc is None:
            return np.ones((n_devices, n_points))
        return fc.sample(t)

    def install(self, cluster: ClusterState) -> "ChurnSchedule":
        """Make this schedule the single source of truth for the fleet's
        lifetimes: every device's ``alive_until`` becomes its first
        scheduled departure (``+inf`` when the schedule never removes it),
        and the schedule's forecastable side — if any — is installed as the
        cluster's :class:`SurvivalForecast` (the ``churn_aware`` policy's
        input).  Idempotent; returns self for chaining."""
        firsts: Dict[int, float] = {}
        for ev in self.events:
            if ev.kind == LEAVE and ev.did not in firsts:
                firsts[ev.did] = ev.t
        for d in cluster.devices:
            d.alive_until = firsts.get(d.did, float("inf"))
        fc = self.forecaster(cluster.n_devices)
        if fc is not None:
            cluster.install_forecast(fc)
        cluster.refresh_topology()
        return self


def _finalize(
    events: List[ChurnEvent],
    *,
    known: Optional[Dict[int, Tuple[float, ...]]] = None,
    lams: Optional[Sequence[float]] = None,
) -> ChurnSchedule:
    """Sort by time and stamp each join event with the device's next
    departure (the rejoined lifetime the engine re-arms)."""
    events = sorted(events, key=lambda ev: (ev.t, ev.did))
    next_leave: Dict[int, List[float]] = {}
    for ev in events:
        if ev.kind == LEAVE:
            next_leave.setdefault(ev.did, []).append(ev.t)
    out: List[ChurnEvent] = []
    for ev in events:
        if ev.kind == JOIN:
            later = [t for t in next_leave.get(ev.did, []) if t > ev.t]
            until = min(later) if later else float("inf")
            out.append(ChurnEvent(ev.t, ev.did, JOIN, until))
        else:
            out.append(ev)
    return ChurnSchedule(
        events=tuple(out),
        known_departures=(
            {d: tuple(sorted(ts)) for d, ts in known.items()}
            if known is not None else None
        ),
        forecast_lams=(
            tuple(float(l) for l in lams) if lams is not None else None
        ),
    )


# -- deterministic per-entity rng streams --------------------------------------
def _device_rng(seed: int, did: int) -> np.random.Generator:
    """ONE stream per (churn seed, device): every stochastic generator draws
    this device's lifetimes from here, so fleet membership changes cannot
    reshuffle anyone else's schedule."""
    return np.random.default_rng(
        np.random.SeedSequence(entropy=(int(seed), int(did)))
    )


def _group_rng(seed: int, gidx: int) -> np.random.Generator:
    """Per-group shock stream, namespaced away from the device streams."""
    return np.random.default_rng(
        np.random.SeedSequence(entropy=(int(seed), 0x53484B, int(gidx)))
    )


# -- down-interval plumbing ----------------------------------------------------
def _union_intervals(
    ivals: List[Tuple[float, float]]
) -> List[Tuple[float, float]]:
    """Merge overlapping/touching [t0, t1) down intervals."""
    out: List[List[float]] = []
    for t0, t1 in sorted(ivals):
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return [(a, b) for a, b in out]


def _events_from_down(
    did: int,
    ivals: List[Tuple[float, float]],
    horizon: Optional[float] = None,
) -> List[ChurnEvent]:
    """Turn a device's (possibly overlapping) down intervals into an
    alternating leave/join event list.  A join past ``horizon`` is dropped
    (the device simply stays away for the rest of the run)."""
    evs: List[ChurnEvent] = []
    for t0, t1 in _union_intervals(ivals):
        if horizon is not None and t0 > horizon:
            continue
        evs.append(ChurnEvent(float(t0), did, LEAVE))
        if np.isfinite(t1) and (horizon is None or t1 <= horizon):
            evs.append(ChurnEvent(float(t1), did, JOIN))
        else:
            break                       # down for the rest of the run
    return evs


def _individual_down_intervals(
    lam: float,
    first_leave: float,
    horizon: float,
    rejoin: bool,
    mean_downtime: float,
    rng: np.random.Generator,
) -> List[Tuple[float, float]]:
    """One device's exponential leave/rejoin cycle as down intervals."""
    out: List[Tuple[float, float]] = []
    t_leave = first_leave
    while t_leave <= horizon:
        if not rejoin:
            out.append((t_leave, float("inf")))
            break
        t_join = t_leave + float(rng.exponential(mean_downtime))
        if t_join > horizon:
            out.append((t_leave, float("inf")))
            break
        out.append((t_leave, t_join))
        t_leave = t_join + sample_lifetime(lam, rng)
    return out


def _ingest_windows(
    windows: Iterable[Tuple[float, Optional[float], Iterable[int]]],
    down: Dict[int, List[Tuple[float, float]]],
    known: Dict[int, List[float]],
) -> None:
    """Fold scripted ``(t0, t1, dids)`` drains into the per-device down
    intervals and the known-departure ledger (shared by
    :func:`maintenance_windows` and :func:`correlated_churn`).  Schedules
    are fleet-agnostic: any device id is accepted; validation against a
    concrete fleet happens at ``install``."""
    for t0, t1, dids in windows:
        t1 = float("inf") if t1 is None else float(t1)
        if t1 <= float(t0):
            raise ValueError(f"empty maintenance window [{t0}, {t1})")
        for did in dids:
            down.setdefault(int(did), []).append((float(t0), t1))
            known.setdefault(int(did), []).append(float(t0))


def device_groups(n_devices: int, n_groups: int) -> List[Tuple[int, ...]]:
    """Default correlated-churn grouping: device ``d`` belongs to group
    ``d % n_groups`` (on the standard fleets this groups by device class —
    one "room" per hardware class)."""
    return [
        tuple(d for d in range(n_devices) if d % n_groups == g)
        for g in range(n_groups)
    ]


def periodic_windows(
    groups: Sequence[Sequence[int]],
    *,
    period: float,
    duration: float,
    horizon: float,
    phase: float = 1.0,
) -> List[Tuple[float, float, Tuple[int, ...]]]:
    """Rotating scripted maintenance drains: window ``i`` starts at
    ``phase + i * period``, lasts ``duration`` seconds, and empties group
    ``i % len(groups)`` (the lecture-timetable shape)."""
    out: List[Tuple[float, float, Tuple[int, ...]]] = []
    i, t = 0, float(phase)
    while t <= horizon:
        out.append((t, t + float(duration), tuple(groups[i % len(groups)])))
        i += 1
        t += float(period)
    return out


def exponential_churn(
    cluster: ClusterState,
    *,
    horizon: float,
    seed: int = 0,
    rejoin: bool = True,
    mean_downtime: float = 20.0,
    lams: Optional[Sequence[float]] = None,
    resample_first: bool = False,
) -> ChurnSchedule:
    """Exponential leave/rejoin cycles for every device, up to ``horizon``.

    Each device's first departure is its already-sampled ``alive_until``
    (so the schedule agrees with the fleet's ground truth and with every
    policy's Table-IV knowledge) unless ``resample_first`` — or the device
    was built immortal — in which case a fresh lifetime is drawn from its
    rate.  After a departure the device stays away ``Exp(mean_downtime)``
    seconds, then rejoins with a fresh exponential lifetime (memoryless, as
    the paper's model demands).  ``lams`` overrides the per-device rates —
    the hook :func:`churn_from_monitor` uses to feed online MLE estimates
    back into the generator.

    Every device draws from its own ``(seed, did)``-keyed stream, so
    growing or shrinking the fleet leaves every other device's lifetimes
    untouched.  The resulting schedule is forecastable only stochastically:
    ``install`` attaches a rate-extrapolated :class:`SurvivalForecast`
    (``exp(-lambda h)``), never the sampled departure times themselves —
    memoryless departures are by definition not predictable.
    """
    events: List[ChurnEvent] = []
    rates: List[float] = []
    for d in cluster.devices:
        lam = float(lams[d.did]) if lams is not None else float(d.lam)
        rates.append(lam)
        rng = _device_rng(seed, d.did)
        if resample_first or not np.isfinite(d.alive_until):
            t_leave = d.join_time + sample_lifetime(lam, rng)
        else:
            t_leave = float(d.alive_until)
        ivals = _individual_down_intervals(
            lam, t_leave, horizon, rejoin, mean_downtime, rng
        )
        events.extend(_events_from_down(d.did, ivals, horizon))
    return _finalize(events, lams=rates)


def deterministic_churn(
    events: Iterable[Tuple[float, int, str]]
) -> ChurnSchedule:
    """An explicit script of ``(t, did, "leave"|"join")`` transitions.

    Scripted means *announced*: every departure time is carried in the
    schedule's ``known_departures``, so ``install`` attaches an exact
    availability forecast the ``churn_aware`` policy can plan around."""
    out: List[ChurnEvent] = []
    known: Dict[int, List[float]] = {}
    for t, did, kind in events:
        if kind not in (LEAVE, JOIN):
            raise ValueError(f"unknown churn event kind {kind!r}")
        out.append(ChurnEvent(float(t), int(did), kind))
        if kind == LEAVE:
            known.setdefault(int(did), []).append(float(t))
    return _finalize(
        out, known={d: tuple(ts) for d, ts in known.items()}
    )


def trace_churn(
    observations: Iterable[Tuple[float, int, bool]]
) -> ChurnSchedule:
    """Replay an availability trace: ``(t, did, alive)`` observations (the
    campus-mobility-trace shape of §V-F).  A device emits a leave event
    when its observed state flips up -> down and a join event on the flip
    back; devices are assumed present before their first observation.
    Replays are scripted futures, so — like :func:`deterministic_churn` —
    the departures are exported as an exact forecast."""
    state: Dict[int, bool] = {}
    out: List[ChurnEvent] = []
    known: Dict[int, List[float]] = {}
    for t, did, alive in sorted(observations, key=lambda o: (o[0], o[1])):
        prev = state.get(did, True)
        alive = bool(alive)
        if prev and not alive:
            out.append(ChurnEvent(float(t), int(did), LEAVE))
            known.setdefault(int(did), []).append(float(t))
        elif not prev and alive:
            out.append(ChurnEvent(float(t), int(did), JOIN))
        state[did] = alive
    return _finalize(out, known={d: tuple(ts) for d, ts in known.items()})


def maintenance_windows(
    windows: Iterable[Tuple[float, Optional[float], Iterable[int]]]
) -> ChurnSchedule:
    """Scripted mass drains: each window ``(t0, t1, dids)`` takes every
    listed device down at ``t0`` and returns the whole group at ``t1``
    (``None``/inf = they never come back).  Overlapping windows merge.

    The entire schedule is announced in advance, so ``install`` attaches an
    exact forecast: a task whose estimated span crosses a member's next
    window start has survival exactly 0 there — the cliff the
    ``churn_aware`` placement guard keys on."""
    down: Dict[int, List[Tuple[float, float]]] = {}
    known: Dict[int, List[float]] = {}
    _ingest_windows(windows, down, known)
    events: List[ChurnEvent] = []
    for did, ivals in down.items():
        events.extend(_events_from_down(did, ivals))
    return _finalize(
        events, known={d: tuple(ts) for d, ts in known.items()}
    )


def correlated_churn(
    cluster: ClusterState,
    *,
    horizon: float,
    seed: int = 0,
    groups: Optional[Sequence[Sequence[int]]] = None,
    n_groups: int = 8,
    shock_rate: float = 0.005,
    rejoin: bool = True,
    mean_downtime: float = 20.0,
    lams: Optional[Sequence[float]] = None,
    windows: Iterable[Tuple[float, Optional[float], Iterable[int]]] = (),
    resample_first: bool = False,
) -> ChurnSchedule:
    """Cluster-level correlated churn: Marshall–Olkin shared shocks plus
    scripted maintenance windows on top of per-device individual cycles.

    Three hazard sources compose (their down intervals union per device):

      * **individual** — each device's own exponential leave/rejoin cycle,
        drawn from its ``(seed, did)``-keyed stream exactly like
        :func:`exponential_churn` (the two generators share the contract:
        same seed -> same individual lifetimes);
      * **shared shocks** — each group carries a Poisson process with rate
        ``shock_rate``; when it fires, EVERY member departs at that instant
        and the whole group returns together after ``Exp(mean_downtime)``
        (the lecture ends, the room empties).  Groups default to
        :func:`device_groups` (device ``d`` -> group ``d % n_groups``);
      * **windows** — scripted ``(t0, t1, dids)`` drains (see
        :func:`maintenance_windows`), e.g. from :func:`periodic_windows`.

    Forecastability follows the sources: window departures are exported
    exactly (``known_departures``), while the individual and shock hazards
    are exported as rates — device ``d``'s residual forecast rate is
    ``lam_d + shock_rate`` (a shock departs it like any other failure, just
    correlated with its roommates)."""
    D = cluster.n_devices
    if groups is None:
        groups = device_groups(D, n_groups)
    down: Dict[int, List[Tuple[float, float]]] = {d.did: [] for d in cluster.devices}
    known: Dict[int, List[float]] = {}
    rates = np.array(
        [float(lams[d.did]) if lams is not None else float(d.lam)
         for d in cluster.devices]
    )

    # individual component: the exponential_churn contract, stream-for-stream
    for d in cluster.devices:
        rng = _device_rng(seed, d.did)
        if resample_first or not np.isfinite(d.alive_until):
            t_leave = d.join_time + sample_lifetime(float(rates[d.did]), rng)
        else:
            t_leave = float(d.alive_until)
        down[d.did].extend(_individual_down_intervals(
            float(rates[d.did]), t_leave, horizon, rejoin, mean_downtime, rng
        ))

    # shared shocks: one Poisson stream per group, mass departure + return
    shock_of = np.zeros(D)
    for g, members in enumerate(groups):
        members = [int(m) for m in members]
        if not members:
            continue
        shock_of[members] = shock_rate
        if shock_rate <= 0:
            continue
        rng = _group_rng(seed, g)
        t = float(rng.exponential(1.0 / shock_rate))
        while t <= horizon:
            dt = float(rng.exponential(mean_downtime))
            for did in members:
                down[did].append(
                    (t, t + dt if rejoin else float("inf"))
                )
            if not rejoin:
                break
            t = t + dt + float(rng.exponential(1.0 / shock_rate))

    # scripted windows: the forecast-exact component
    _ingest_windows(windows, down, known)

    events: List[ChurnEvent] = []
    for did, ivals in down.items():
        if ivals:
            events.extend(_events_from_down(did, ivals, horizon))
    return _finalize(
        events,
        known={d: tuple(ts) for d, ts in known.items()},
        lams=rates + shock_of,
    )


def churn_from_monitor(
    monitor,
    cluster: ClusterState,
    *,
    horizon: float,
    cls_key=None,
    **kwargs,
) -> ChurnSchedule:
    """Generate churn at the failure rates a
    :class:`repro.ft.runtime.FleetMonitor` estimated online.

    The monitor's per-class lambda MLE (deaths / alive-exposure — the same
    :func:`~repro_torch.core.availability.fit_failure_rate` estimator the paper
    fits offline on the CrowdBind trace) replaces each device's nominal
    Table-IV rate, so ``sim`` and ``ft`` share one availability model —
    and the resulting schedule's forecast extrapolates those same MLE
    rates.  ``cls_key`` maps a sim :class:`~repro_torch.core.cluster.Device` to
    the monitor's class label (default: ``str(device.cls)``).
    """
    key = cls_key if cls_key is not None else (lambda d: str(d.cls))
    lams = np.array([monitor.lam(key(d)) for d in cluster.devices])
    return exponential_churn(
        cluster, horizon=horizon, lams=lams, resample_first=True, **kwargs
    )
