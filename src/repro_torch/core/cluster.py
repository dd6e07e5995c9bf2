"""Cluster state visible to the orchestrator.

Mirrors the bookkeeping structures of the paper (Table II):
  ED_info   — total and free memory on each edge device
  M_info    — which model artifacts are cached on each device (LRU order)
  Task_info — number of running tasks of each type on each device
  T_alloc   — "the allocation of each task and the estimated time it will be
               on that edge device", so the orchestrator "can calculate the
               number of running tasks on each device at a certain time by a
               simple summation" (§IV-A).

``T_alloc`` is realised as a time-bucketed occupancy tensor
``alloc[device, task_type, bucket]`` so that Eq. (1) estimates at any time t
are O(1) slices; the summation the paper describes is a range-add here.

The cluster also names the ``device`` its planning runs on: a policy
built by name for it (``orchestrate(..., policy="ibdash")``,
``Orchestrator(cluster, "ibdash")``) runs its decision kernels there.  All
cluster state itself stays numpy on the host.
"""
from __future__ import annotations

import warnings
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..device import resolve_device
from .batched import FleetSnapshot
from .interference import InterferenceModel

__all__ = [
    "Device",
    "ClusterState",
    "ApplyToken",
    "TIER_DEVICE",
    "TIER_EDGE_SERVER",
    "TIER_CLOUD",
    "TIER_NAMES",
]

# Fleet tiers (the multi-tier DAG-scheduling extension of arXiv:2409.10839):
# end devices -> edge servers -> cloud.  Tier ids index the backhaul matrix.
TIER_DEVICE, TIER_EDGE_SERVER, TIER_CLOUD = 0, 1, 2
TIER_NAMES = ("device", "edge_server", "cloud")


@dataclass
class Device:
    """One edge device (or pod)."""

    did: int
    cls: int                      # index into the device-class/profile table
    mem_total: float              # H(ED) in bytes
    lam: float                    # failure rate lambda (Table IV)
    # DEPRECATED scalar link bandwidth in bytes/s.  Kept as a symmetric shim:
    # when ``up_bw``/``down_bw`` are not given they both default to it, so
    # existing profiles load unchanged.  New code should set the directional
    # rates (phone uplinks are much slower than their downlinks).
    bandwidth: Optional[float] = None
    join_time: float = 0.0
    alive_until: float = float("inf")  # sampled ground-truth lifetime (sim only)
    tier: int = TIER_DEVICE       # fleet tier (indexes the backhaul matrix)
    up_bw: Optional[float] = None    # uplink rate in bytes/s (device -> net)
    down_bw: Optional[float] = None  # downlink rate in bytes/s (net -> device)

    # dynamic state ------------------------------------------------------------
    mem_free: float = 0.0
    # model_id -> bytes; least-recently-used first (we evict from the front;
    # the paper keeps MRU at the front and evicts from the end — same policy).
    model_cache: "OrderedDict[str, float]" = field(default_factory=OrderedDict)

    def __post_init__(self) -> None:
        if self.bandwidth is None and (self.up_bw is None or self.down_bw is None):
            raise ValueError(
                "Device needs either the deprecated scalar `bandwidth` or "
                "both `up_bw` and `down_bw`"
            )
        if self.up_bw is None:
            self.up_bw = float(self.bandwidth)
        if self.down_bw is None:
            self.down_bw = float(self.bandwidth)
        if self.bandwidth is None:
            self.bandwidth = float(min(self.up_bw, self.down_bw))

    def init_dynamic(self) -> None:
        self.mem_free = self.mem_total
        self.model_cache = OrderedDict()

    # -- model cache (Algorithm 1, lines 19-27) -------------------------------
    def has_model(self, model_id: Optional[str]) -> bool:
        return model_id is None or model_id in self.model_cache

    def touch_model(self, model_id: str) -> None:
        """moveFront(M(T_i)) — mark most recently used."""
        self.model_cache.move_to_end(model_id)

    def admit_model(self, model_id: str, size: float) -> bool:
        """Upload a model, LRU-evicting (removeEnd) until it fits.

        Returns False when the model cannot fit even on an empty device."""
        if model_id in self.model_cache:
            self.touch_model(model_id)
            return True
        if size > self.mem_total:
            return False
        while self.mem_free < size and self.model_cache:
            _, evicted = self.model_cache.popitem(last=False)
            self.mem_free += evicted
        if self.mem_free < size:
            return False
        self.model_cache[model_id] = size
        self.mem_free -= size
        return True

    def alive(self, now: float) -> bool:
        return now < self.alive_until


@dataclass
class ApplyToken:
    """Undo record for one ``ClusterState.apply`` call.

    Captures the occupancy intervals that were added and, for every device
    whose model cache was touched, an exact snapshot of its prior
    ``(mem_free, model_cache)`` — LRU order included — so speculative plans
    and what-if sweeps can be rolled back bit-exactly with
    ``cluster.undo(token)``.
    """

    intervals: List[Tuple[int, int, float, float, float]] = field(
        default_factory=list
    )  # (did, ttype, t0, t1, w)
    cache_snaps: Dict[int, Tuple[float, "OrderedDict[str, float]"]] = field(
        default_factory=dict
    )
    applied: bool = False       # False for infeasible / rejected plans
    undone: bool = False


@dataclass
class ClusterState:
    """The orchestrator's view of the fleet + the profiled ED_mc table."""

    devices: List[Device]
    model: InterferenceModel
    horizon: float = 300.0        # total simulated time covered by T_alloc
    dt: float = 0.05              # T_alloc bucket width (seconds)
    # (T, T) inter-tier backhaul rates in bytes/s (T = number of tiers);
    # None = unconstrained (single-tier fleets).
    backhaul: Optional[np.ndarray] = None
    # Device id hosting the model artifacts (an edge server / registry node):
    # uploads to device d are charged over the bw_eff[model_source, d] link.
    # None = legacy semantics (artifacts arrive at each device's downlink).
    model_source: Optional[int] = None
    # Where policies built by name for this cluster run their decision
    # kernels: the card unless the caller names the CPU (resolved, and
    # refused without a card, at construction).
    device: object = "cuda"

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)
        for d in self.devices:
            d.init_dynamic()
        # Optional availability forecast (repro_torch.core.availability
        # .SurvivalForecast), installed by ChurnSchedule.install or
        # install_forecast; None = no forecast -> snapshots carry the
        # uniform all-ones survival leaf and policies fall back to F(T_i).
        self.forecast = None
        self.topology_version = -1
        self.refresh_topology()
        self.n_buckets = int(np.ceil(self.horizon / self.dt)) + 1
        # T_alloc: (devices, task types, time buckets).  float64 like all
        # pricing: apply/undo/cancel cycles add and subtract the SAME
        # values, which cancel exactly in float64 (a float32 accumulator
        # rounds the f64 interval weights on entry, leaving residue that
        # the counts_at clip then silently masks).
        self.alloc = np.zeros(
            (len(self.devices), self.model.n_types, self.n_buckets),
            dtype=np.float64,
        )
        self._horizon_warned = False

    # Fleet vectors handed out to frozen snapshots as shared (zero-copy)
    # leaves.  When `_leased` is set, the next in-place mutation
    # copies them first (copy-on-write), so already-taken snapshots stay
    # immutable without re-deriving O(D) state on every wave.
    _LEAF_VECTORS = (
        "_classes", "_lams", "_bw", "_mem_total", "_tiers", "_up", "_down",
        "_join_times",
    )

    def refresh_topology(self) -> None:
        """(Re)build the static O(D) fleet vectors from the current
        ``Device`` attributes, validate the backhaul matrix, and bump
        ``topology_version`` so snapshot-scoped caches (the wave context
        builder) can detect staleness.

        The bottleneck rule prices the *link*, not the endpoint:

            bw_eff[s, d] = min(up[s], down[d], backhaul[tier[s], tier[d]])

        — the sender's uplink, the receiver's downlink, and the inter-tier
        backhaul all bound a transfer.  The diagonal is +inf (a co-located
        transfer crosses no network hop).  The dense ``(D, D)`` matrix is
        never built here: snapshots carry only the factors and sender rows
        are derived lazily by :meth:`link_row` (the factorization that
        scales the fleet to 100k devices).  Call this after mutating device
        attributes wholesale; for a single device use :meth:`set_bandwidth`,
        which is O(D) instead of a full rebuild."""
        devs = self.devices
        self._classes = np.array([d.cls for d in devs], dtype=np.int64)
        self._lams = np.array([d.lam for d in devs], dtype=np.float64)
        self._alive_until = np.array(
            [d.alive_until for d in devs], dtype=np.float64
        )
        self._bw = np.array([d.bandwidth for d in devs], dtype=np.float64)
        self._mem_total = np.array([d.mem_total for d in devs], dtype=np.float64)
        self._tiers = np.array([d.tier for d in devs], dtype=np.int64)
        self._up = np.array([d.up_bw for d in devs], dtype=np.float64)
        self._down = np.array([d.down_bw for d in devs], dtype=np.float64)
        self._join_times = np.array(
            [d.join_time for d in devs], dtype=np.float64
        )
        max_tier = int(self._tiers.max()) if self._tiers.size else 0
        if self.backhaul is None:
            # unconstrained single-/multi-tier fleet: an all-inf matrix is
            # the identity of the min, so the factorized rule degenerates to
            # min(up[s], down[d]) exactly as before
            self._backhaul = np.full((max_tier + 1, max_tier + 1), np.inf)
        else:
            bh = np.asarray(self.backhaul, dtype=np.float64)
            if bh.ndim != 2 or bh.shape[0] != bh.shape[1]:
                raise ValueError(
                    f"backhaul matrix must be square (T, T), got {bh.shape}"
                )
            if self._tiers.size and bh.shape[0] <= max_tier:
                raise ValueError(
                    f"backhaul matrix {bh.shape} too small for tier "
                    f"{max_tier}"
                )
            self._backhaul = bh
        self._link_rows: Dict[int, np.ndarray] = {}
        self._leased = False
        self.topology_version += 1

    def _cow(self) -> None:
        """Copy-on-write the leased fleet vectors before an in-place
        mutation, so frozen snapshots taken earlier keep their values."""
        if not self._leased:
            return
        for name in self._LEAF_VECTORS:
            setattr(self, name, getattr(self, name).copy())
        self._leased = False

    def set_bandwidth(
        self,
        did: int,
        *,
        up: Optional[float] = None,
        down: Optional[float] = None,
        tier: Optional[int] = None,
    ) -> None:
        """Update one device's link rates / tier incrementally (the blessed
        way to change topology between planning waves).

        Touches only that device's entries in the O(D) factor vectors
        (copy-on-write when snapshots hold them) and invalidates the cached
        link rows — no O(D^2) state exists to rebuild, and no other
        device's leaves are re-derived.  Still bumps ``topology_version``
        so live wave builders raise instead of mixing topologies."""
        d = self.devices[did]
        if up is not None:
            d.up_bw = float(up)
        if down is not None:
            d.down_bw = float(down)
        if tier is not None:
            d.tier = int(tier)
            if d.tier >= self._backhaul.shape[0]:
                if self.backhaul is not None:
                    raise ValueError(
                        f"backhaul matrix {self._backhaul.shape} too small "
                        f"for tier {d.tier}"
                    )
                # unconstrained fleet: grow the all-inf matrix to cover the
                # new tier id
                self._backhaul = np.full((d.tier + 1, d.tier + 1), np.inf)
        if up is not None or down is not None:
            d.bandwidth = float(min(d.up_bw, d.down_bw))
        self._cow()
        self._up[did] = d.up_bw
        self._down[did] = d.down_bw
        self._tiers[did] = d.tier
        self._bw[did] = d.bandwidth
        self._link_rows = {}
        self.topology_version += 1

    def install_forecast(self, forecast) -> None:
        """Install (or clear, with ``None``) an availability forecast
        (:class:`~repro_torch.core.availability.SurvivalForecast`).  Snapshots
        taken afterwards carry its ``(D, K)`` survival tensor as the
        ``surv_grid``/``survival`` leaves and the wave context
        builder prices per-candidate survival from it; the topology version
        bumps so a live wave builder raises instead of mixing forecasts."""
        if forecast is not None and forecast.n_devices != len(self.devices):
            raise ValueError(
                f"forecast covers {forecast.n_devices} devices, fleet has "
                f"{len(self.devices)}"
            )
        self.forecast = forecast
        self.topology_version += 1

    # -- device lifecycle (the churn runtime's view) ----------------------------
    def alive_mask(self, t: float) -> np.ndarray:
        """(D,) bool: devices that have not departed as of time ``t``.

        A device past its ``alive_until`` has already left the network, so
        the orchestrator can observe the departure (missed heartbeats) and
        MUST NOT place onto it — :meth:`snapshot` and the wave context
        builder bake this mask into every policy's feasibility.  Future
        departures stay invisible: ``alive_until > t`` is indistinguishable
        from immortal, exactly the paper's silent-departure model (the
        orchestrator only ever prices future deaths probabilistically via
        ``F(T_i)``)."""
        return t < self._alive_until

    def mark_down(self, did: int, t: float) -> None:
        """Record that device ``did`` left the network at time ``t`` (the
        churn runtime's DEVICE_DOWN).  Snapshots taken at or after ``t``
        mask it infeasible; the topology version bumps so a live wave
        builder raises instead of planning onto the departed device."""
        dev = self.devices[did]
        dev.alive_until = min(dev.alive_until, float(t))
        self._alive_until[did] = dev.alive_until
        self.topology_version += 1

    def mark_up(
        self, did: int, t: float, alive_until: float = float("inf")
    ) -> None:
        """Re-admit device ``did`` at time ``t`` (the churn runtime's
        DEVICE_UP): it rejoins empty — free memory, cold model cache, a
        fresh ``join_time`` (its availability clock restarts) — and stays
        until ``alive_until`` (its next scheduled departure)."""
        dev = self.devices[did]
        dev.join_time = float(t)
        dev.alive_until = float(alive_until)
        dev.init_dynamic()
        self._alive_until[did] = dev.alive_until
        self._cow()
        self._join_times[did] = dev.join_time
        self.topology_version += 1

    # -- static fleet views ------------------------------------------------------
    @property
    def n_devices(self) -> int:
        return len(self.devices)

    @property
    def n_types(self) -> int:
        return self.model.n_types

    def classes(self) -> np.ndarray:
        return self._classes

    def lams(self) -> np.ndarray:
        return self._lams

    def bandwidths(self) -> np.ndarray:
        """DEPRECATED (D,) scalar bandwidths — use :meth:`link_bw`."""
        return self._bw

    def tiers(self) -> np.ndarray:
        return self._tiers

    def up_bandwidths(self) -> np.ndarray:
        return self._up

    def down_bandwidths(self) -> np.ndarray:
        return self._down

    def backhaul_bw(self) -> np.ndarray:
        """(T, T) inter-tier backhaul rates (all-inf when unconstrained)."""
        return self._backhaul

    def join_times(self) -> np.ndarray:
        """(D,) device join times (the availability-clock epochs)."""
        return self._join_times

    def link_row(self, s: int) -> np.ndarray:
        """(D,) sender row of the effective link-bandwidth matrix:
        ``bw_eff[s, d] = min(up[s], down[d], backhaul[tier[s], tier[d]])``,
        +inf at ``d == s``.

        Derived lazily from the O(D) factors and cached per sender until
        the topology changes — only rows of devices that actually *send*
        (DAG parents, the model source) are ever built, so planning cost
        scales with senders, not D^2."""
        s = int(s)
        row = self._link_rows.get(s)
        if row is None:
            row = np.minimum(self._up[s], self._down)
            row = np.minimum(
                row, self._backhaul[self._tiers[s], self._tiers]
            )
            row[s] = np.inf
            self._link_rows[s] = row
        return row

    def link_bw(self) -> np.ndarray:
        """(D, D) effective link bandwidth: ``bw_eff[s, d] = min(up[s],
        down[d], backhaul[tier[s], tier[d]])``, +inf on the diagonal.

        Materialized on demand from the factors — O(D^2) memory, for
        debugging and small-fleet inspection only; hot paths (the wave
        builder's transfer vectors, recovery repricing) slice
        :meth:`link_row` instead."""
        link = np.minimum(self._up[:, None], self._down[None, :])
        link = np.minimum(
            link, self._backhaul[self._tiers[:, None], self._tiers[None, :]]
        )
        np.fill_diagonal(link, np.inf)
        return link

    def upload_bw(self) -> np.ndarray:
        """(D,) effective model-upload bandwidth per device: the link row
        from ``model_source`` (artifacts live on that node) or, when no
        source is declared, each device's downlink — which equals the
        deprecated scalar ``bandwidth`` on shimmed fleets, preserving the
        legacy upload pricing exactly."""
        if self.model_source is None:
            return self._down
        return self.link_row(self.model_source)

    def mem_totals(self) -> np.ndarray:
        return self._mem_total

    # -- T_alloc ------------------------------------------------------------------
    def bucket(self, t: float) -> int:
        return min(max(int(t / self.dt), 0), self.n_buckets - 1)

    def add_interval(
        self, did: int, ttype: int, t0: float, t1: float, w: float = 1.0
    ) -> None:
        """Record that a ``ttype`` task occupies device ``did`` over [t0, t1).

        Intervals reaching past ``horizon`` are clipped to it (with a
        one-time warning) instead of being silently clamped into the final
        T_alloc bucket, where their occupancy would otherwise pile up and
        corrupt late-horizon Eq. (1) estimates.  Clipping is a pure function
        of ``(t0, t1)``, so undo/replacement passes (negative ``w``) cancel
        the exact same buckets.
        """
        if t1 > self.horizon:
            self._warn_horizon(t1)
            t1 = self.horizon
        if t0 >= self.horizon:
            return                      # entirely past the recorded window
        b0 = self.bucket(t0)
        b1 = max(self.bucket(t1), b0 + 1)  # at least one bucket
        self.alloc[did, ttype, b0:b1] += w

    def _warn_horizon(self, t1: float) -> None:
        if self._horizon_warned:
            return
        self._horizon_warned = True
        warnings.warn(
            f"T_alloc interval extends to t={t1:.2f}s past horizon="
            f"{self.horizon:.2f}s; clipping occupancy at the horizon "
            "(build the cluster with a larger `horizon` to track it)",
            RuntimeWarning,
            stacklevel=3,
        )

    def cancel_from(
        self, did: int, ttype: int, t0: float, t1: float, t_cut: float,
        w: float = 1.0,
    ) -> None:
        """Remove the ``[t_cut, t1)`` tail of a previously recorded
        ``[t0, t1)`` occupancy interval, bucket-exactly.

        Used when a replica is killed mid-flight (device departure, app
        failure): the capacity it would have held from the cut onward is
        returned to T_alloc.  Operates on the *same* buckets the original
        :meth:`add_interval` touched — the partial bucket containing the
        cut is removed with the tail — so a cancelled interval can never
        leave negative residue, whatever the bucket alignment."""
        if t1 > self.horizon:
            t1 = self.horizon
        if t0 >= self.horizon or t_cut >= t1:
            return
        b0 = self.bucket(t0)
        b1 = max(self.bucket(t1), b0 + 1)
        bc = min(max(self.bucket(t_cut), b0), b1)
        self.alloc[did, ttype, bc:b1] -= w

    def counts_at(self, t: float) -> np.ndarray:
        """Task_info snapshot at time t: (D, N) running-task counts.

        Clipped at zero: the engine replaces provisional placement-time
        intervals with actual execution intervals by subtraction, which can
        transiently leave small negative residue in individual buckets."""
        return np.maximum(self.alloc[:, :, self.bucket(t)], 0.0)

    def device_counts_at(self, did: int, t: float) -> np.ndarray:
        """One device's Task_info row at time t, clipped at zero like
        ``counts_at`` (provisional-interval subtraction can leave small
        negative residue that must not shrink interference estimates)."""
        return np.maximum(self.alloc[did, :, self.bucket(t)], 0.0)

    # -- Eq. (1) across the fleet ---------------------------------------------
    def estimate_exec(self, ttype: int, t: float) -> np.ndarray:
        """(D,) expected execution latency of a new ``ttype`` task started at
        time ``t`` on every device, given T_alloc."""
        return self.model.estimate_devices(
            self._classes, ttype, np.asarray(self.counts_at(t), dtype=np.float64)
        )

    def queue_len_at(self, t: float) -> np.ndarray:
        """(D,) total running tasks per device (LAVEA's SQLF signal)."""
        return np.asarray(self.counts_at(t), dtype=np.float64).sum(axis=1)

    def snapshot(
        self,
        t: float,
        *,
        counts: Optional[np.ndarray] = None,
        join_times: Optional[np.ndarray] = None,
        alive: Optional[np.ndarray] = None,
        surv_grid: Optional[np.ndarray] = None,
        survival: Optional[np.ndarray] = None,
    ) -> FleetSnapshot:
        """Struct-of-arrays :class:`FleetSnapshot` of the fleet at time
        ``t``: the static device vectors plus the Task_info counts — the
        batched policies' whole world view, as one frozen struct.

        ``counts``/``join_times``/``surv_grid``/``survival`` let hot callers
        (the wave context builder) pass their cached copies; this stays the
        single construction site for snapshots.  The link model is carried
        as its O(D) factors (``up_bw``/``down_bw``/``backhaul`` + ``tiers``)
        — never the dense ``(D, D)`` matrix — so a snapshot of a 100k-device
        fleet is still O(D) memory.  The fleet vectors are shared zero-copy;
        the next in-place mutation copies them first (see :meth:`_cow`)."""
        if counts is None:
            counts = np.asarray(self.counts_at(t), dtype=np.float64)
        if join_times is None:
            join_times = self._join_times
        if alive is None:
            alive = self.alive_mask(t)
        if (survival is None) != (surv_grid is None):
            # catch the half-supplied forecast HERE, not in the __debug__
            # twin (silently wrong under python -O otherwise): a (D, K)
            # survival tensor is meaningless without its (K,) span grid
            raise ValueError(
                "snapshot() needs `survival` and `surv_grid` together "
                f"(got survival={'set' if survival is not None else 'None'}, "
                f"surv_grid={'set' if surv_grid is not None else 'None'})"
            )
        if survival is None:
            if self.forecast is None:
                # no forecast installed: the uniform leaf — every policy
                # falls back bit-identically to the memoryless F(T_i)
                surv_grid = np.zeros(1)
                survival = np.ones((len(self.devices), 1))
            else:
                surv_grid = self.forecast.grid()
                survival = self.forecast.sample(t)
        snap = FleetSnapshot(
            t=t,
            classes=self._classes,
            lams=self._lams,
            bandwidths=self._bw,
            tiers=self._tiers,
            up_bw=self._up,
            down_bw=self._down,
            backhaul=self._backhaul,
            mem_total=self._mem_total,
            join_times=join_times,
            alive=alive,
            surv_grid=surv_grid,
            survival=survival,
            counts=counts,
            queue_len=counts.sum(axis=1),
            base=self.model.base,
            slope=self.model.slope,
        )
        if __debug__:
            # runtime twin of the snapshot-schema lint rule: leaf drift
            # fails HERE, not as a wrong tensor inside a decision kernel
            snap.validate()
        self._leased = True
        return snap

    # -- the one blessed mutation path ----------------------------------------
    def apply(self, plan) -> ApplyToken:
        """Make a :class:`~repro_torch.core.orchestrator.Plan` real.

        Records the provisional T_alloc occupancy interval of every replica
        and admits required model artifacts into the per-device LRU caches
        (Algorithm 1 lines 19-27) — exactly the bookkeeping the seed's
        scheduler commit step performed, but as an explicit, undoable step.

        Returns an :class:`ApplyToken`; pass it to :meth:`undo` to roll the
        state back exactly (speculative planning, alpha/gamma what-if
        sweeps).  Infeasible plans are a no-op.

        If a required model cannot fit on its chosen device even after LRU
        eviction, the whole application is rolled back and the plan is
        marked infeasible at that task (mirroring the memory-constraint
        branch of the planning phase) instead of silently treating the
        model as cached.
        """
        token = ApplyToken()
        placement = plan.placement
        if not placement.feasible:
            return token
        app, now = plan.app, plan.now
        for tname, tp in placement.tasks.items():
            spec = app.tasks[tname]
            start = now + tp.est_start
            for rep in tp.replicas:
                self.add_interval(
                    rep.did, spec.ttype, start, start + rep.est_total
                )
                token.intervals.append(
                    (rep.did, spec.ttype, start, start + rep.est_total, 1.0)
                )
                dev = self.devices[rep.did]
                if spec.model_id is not None:
                    if rep.did not in token.cache_snaps:
                        token.cache_snaps[rep.did] = (
                            dev.mem_free, OrderedDict(dev.model_cache)
                        )
                    if not dev.admit_model(spec.model_id, spec.model_bytes):
                        # the model cannot fit even after evicting the whole
                        # cache: surface it instead of pretending it loaded
                        self.undo(token)
                        placement.feasible = False
                        placement.infeasible_task = tname
                        return ApplyToken()
        token.applied = True
        return token

    def undo(self, token: ApplyToken) -> None:
        """Roll back one :meth:`apply` exactly (idempotent per token)."""
        if token.undone:
            return
        for did, ttype, t0, t1, w in reversed(token.intervals):
            self.add_interval(did, ttype, t0, t1, w=-w)
        for did, (mem_free, cache) in token.cache_snaps.items():
            dev = self.devices[did]
            dev.mem_free = mem_free
            dev.model_cache = OrderedDict(cache)
        token.undone = True
