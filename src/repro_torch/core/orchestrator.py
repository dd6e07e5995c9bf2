"""Orchestration — faithful implementation of Algorithm 1, split into
a pure planning phase and an explicit state-mutation phase.

Given an application DAG, the current cluster state (T_alloc / ED_info /
M_info) and the profiled interference table ED_mc, :func:`orchestrate`
produces a placement ``P(T_i)`` for every task that minimises

    L(T_i) = L(T_i)_{ED_p} + L(M(T_i))_{ED_p} + L(T_i)_d          (Eq. 2)

subject to bandwidth and memory constraints, and (for the IBDASH policy)
reduces the predicted probability of failure by replicating tasks whose
``F(T_i)`` exceeds the threshold ``beta``, for as long as the weighted
joint score

    WeightS = alpha * L~(T_i) + (1 - alpha) * F(T_i)              (line 29)

keeps improving and the replication degree stays below ``gamma``.

API shape (the redesign)
------------------------
* ``plan = orchestrate(app, cluster, now, policy)`` is PURE: it reads
  cluster state, builds one ``(B, D)``-shaped
  :class:`~repro_torch.core.batched.BatchedPolicyContext` per stage (sharing the
  expensive T_alloc snapshot + Eq. 1 evaluation across the stage's tasks),
  asks the policy to ``decide_batch``, and assembles a :class:`Plan`.
  Nothing is written back.
* ``plans = orchestrate_batch(apps, cluster, policy, times=...)`` fuses a
  whole arrival wave: one batched context — and for the registered
  policies one call of the float64 torch decision kernels on the policy's
  device — per wave-stage places every task of ~1000 simultaneous
  instances at once, bit-identically to looping the scalar rule over the
  same rows.  The contexts are built on the host in numpy; only the
  decision runs on the device.
* ``token = cluster.apply(plan)`` records the provisional T_alloc occupancy
  intervals and admits model uploads into the per-device LRU caches —
  exactly the bookkeeping the paper's orchestrator performs — and returns
  an undo token so speculative planning and what-if sweeps can
  ``cluster.undo(token)`` without corrupting state.
* The seed's mutate-inside-``place()`` ``Scheduler`` classes are gone:
  every scheme is a registry policy (``make_policy(name, ...)``) driven
  through this pure two-phase protocol.  The verbatim seed implementations
  survive only in the JAX package's ``tests/_legacy_reference.py``.

Notes on fidelity
-----------------
* Stage processing order, the per-task priority queue over devices, the LRU
  model-cache maintenance (lines 19-27) and the replication loop
  (lines 30-41) follow Algorithm 1 line by line.
* ``F(T_i)`` uses the exponential availability model of §V-F: the device
  must stay alive from the moment of allocation until the task's estimated
  completion (stage offset + task latency), and — because PEDs depart
  silently — the orchestrator does *not* get to condition on liveness at
  task start, matching Fig. 7's unconditional availability curves.
* The paper's WeightS mixes seconds with a probability; we normalise the
  latency term by the best candidate latency for the task so that ``alpha``
  sweeps the same [0, 1] range as the paper's Fig. 12a.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .batched import BatchedPolicyContext, FleetSnapshot
from .cluster import ClusterState
from .dag import AppDAG
from .policy import (
    IBDASHConfig,
    Policy,
    PolicyContext,
    TaskDecision,
    make_policy,
)

__all__ = [
    "Replica",
    "TaskPlacement",
    "Placement",
    "Plan",
    "orchestrate",
    "orchestrate_batch",
    "policy_on",
    "IBDASHConfig",
]


@dataclass(slots=True)
class Replica:
    """One placed copy of a task."""

    did: int
    est_exec: float          # L(T_i)_{ED_p}: execution only (Eq. 1)
    est_upload: float        # L(M(T_i))_{ED_p}
    est_transfer: float      # L(T_i)_d
    pred_fail: float         # F(T_i) for this device

    @property
    def est_total(self) -> float:
        return self.est_exec + self.est_upload + self.est_transfer


@dataclass(slots=True)
class TaskPlacement:
    task: str
    ttype: int
    replicas: List[Replica]              # primary first
    est_start: float                     # offset from app arrival (stage barrier)
    # Estimated task latency = the primary replica's total: replicas start
    # concurrently and the task completes on the FIRST success, so extra
    # replicas cost fleet capacity (interference), not direct task latency.
    est_latency: float

    @property
    def pred_fail(self) -> float:
        """Combined failure probability: every replica must fail."""
        p = 1.0
        for r in self.replicas:
            p *= r.pred_fail
        return p


@dataclass
class Placement:
    app_name: str
    tasks: Dict[str, TaskPlacement]
    est_latency: float                   # L(G) = sum of stage maxima (Eq. 3)
    feasible: bool = True
    infeasible_task: Optional[str] = None

    @property
    def pred_app_fail(self) -> float:
        """P_f(G) = 1 - prod_i (1 - F(T_i))   (Eq. 4, independence approx)."""
        p = 1.0
        for tp in self.tasks.values():
            p *= 1.0 - tp.pred_fail
        return 1.0 - p

    def n_replicas(self) -> int:
        return sum(len(tp.replicas) - 1 for tp in self.tasks.values())


@dataclass
class Plan:
    """A pure placement proposal: everything ``ClusterState.apply`` needs to
    record the bookkeeping, and everything callers need to inspect it first.

    ``plan.placement`` is the paper-shaped result; ``plan.app`` / ``plan.now``
    carry the context ``apply`` requires (task specs for model ids and
    interval endpoints)."""

    app: AppDAG
    now: float
    placement: Placement

    # convenience pass-throughs -------------------------------------------------
    @property
    def feasible(self) -> bool:
        return self.placement.feasible

    @property
    def est_latency(self) -> float:
        return self.placement.est_latency

    @property
    def tasks(self) -> Dict[str, TaskPlacement]:
        return self.placement.tasks

    @property
    def infeasible_task(self) -> Optional[str]:
        return self.placement.infeasible_task


# A wave-stage row is the lightweight tuple (state, tname, t_start, bucket);
# at ~6000 rows per 1000-instance wave even dataclass construction overhead
# is measurable, so rows stay plain tuples.


@dataclass(slots=True)
class _AppPlanState:
    """Mutable planning state of one application inside a wave."""

    app: AppDAG
    arrival: float
    n_stages: int
    placements: Dict[str, TaskPlacement] = field(default_factory=dict)
    # Already-decided tasks (completed / in-flight on a replan): their
    # placements price downstream transfers but are never re-decided.
    pinned: frozenset = frozenset()
    stage_offset: float = 0.0
    stage_latency: float = 0.0
    alive: bool = True
    infeasible_task: Optional[str] = None


class _WaveContextBuilder:
    """Builds :class:`BatchedPolicyContext` tensors for a wave of tasks,
    amortising fleet-wide array work.

    The shared pieces — the T_alloc snapshot + queue lengths at each start
    time, the Eq. (1) execution-latency vector per ``(time, task type)``,
    and the per-model "not cached" masks — are computed once per wave and
    reused by every row (the paper's burst of ~1000 simultaneous instances
    makes this the hot path).  Per-row pieces (upload/transfer vectors,
    feasibility, pf) are assembled as ``(B, D)`` tensors in one shot.
    """

    def __init__(self, cluster: ClusterState, now: float = 0.0):
        self.cluster = cluster
        # the link model stays factorized: no (D, D) matrix is materialized
        # anywhere in a wave — transfer_vec slices per-sender rows lazily
        self.upload_bw = cluster.upload_bw() # (D,) artifact-path bandwidth
        self.lams = cluster.lams()
        self.mem_total = cluster.mem_totals()
        self.classes = cluster.classes()
        self.join = cluster.join_times()
        self.n_dev = cluster.n_devices
        # Devices already departed at the planning instant are masked out of
        # every feasibility row: the orchestrator can observe a PAST
        # departure (missed heartbeats), while future deaths remain priced
        # probabilistically through pf (silent-departure model).  Constant
        # for the whole wave — churn events cannot fire inside one pure
        # planning call (and would bump topology_version if they did).
        self.alive = np.asarray(cluster.alive_mask(float(now)), dtype=bool)
        # Installed availability forecast (None = uniform survival): per-
        # candidate survival over each task's span is priced EXACTLY from
        # it (the sampled snapshot tensor is only the snapshot's representation).
        self.forecast = getattr(cluster, "forecast", None)
        self._surv_sample: Dict[float, Tuple[np.ndarray, np.ndarray]] = {}
        # Wave-level caches, scoped to ONE snapshot (planning is pure:
        # cluster state cannot change under us, so cached vectors stay valid
        # for the whole wave; `_topo_version` makes any violation loud).
        # Time-dependent entries are keyed by T_alloc BUCKET, not by exact
        # time — `counts_at` only reads the bucket, so this is exact and
        # collapses the ~B distinct per-app stage offsets of a big wave onto
        # a handful of shared snapshots.
        self._topo_version = cluster.topology_version
        self._counts: Dict[int, np.ndarray] = {}
        self._queue: Dict[int, np.ndarray] = {}
        self._exec: Dict[Tuple[int, int], np.ndarray] = {}
        self._missing: Dict[str, np.ndarray] = {}
        self._upload: Dict[Tuple[str, float], np.ndarray] = {}
        self._transfer: Dict[Tuple[float, int], np.ndarray] = {}
        self._feasible: Dict[float, np.ndarray] = {}
        self._feasible_any: Dict[float, bool] = {}

    def counts_at_bucket(self, bkt: int) -> np.ndarray:
        c = self._counts.get(bkt)
        if c is None:
            c = np.maximum(self.cluster.alloc[:, :, bkt], 0.0).astype(np.float64)
            self._counts[bkt] = c
            self._queue[bkt] = c.sum(axis=1)
        return c

    def exec_lat(self, bkt: int, ttype: int) -> np.ndarray:
        key = (bkt, ttype)
        lat = self._exec.get(key)
        if lat is None:
            lat = self.cluster.model.estimate_devices(
                self.classes, ttype, self.counts_at_bucket(bkt)
            )
            self._exec[key] = lat
        return lat

    def missing_model(self, model_id: str) -> np.ndarray:
        """(D,) bool: devices that would have to upload ``model_id``."""
        m = self._missing.get(model_id)
        if m is None:
            m = np.array(
                [not d.has_model(model_id) for d in self.cluster.devices]
            )
            self._missing[model_id] = m
        return m

    def upload_row(self, model_id: str, model_bytes: float) -> np.ndarray:
        """(D,) model-upload latency vector (lines 7-10), cached per
        (model, size) — tasks may disagree on a shared artifact's size.
        Uploads travel the device <-> artifact-server link (the
        ``model_source`` row of the link matrix; each device's downlink on
        legacy fleets without one)."""
        key = (model_id, model_bytes)
        u = self._upload.get(key)
        if u is None:
            u = np.where(
                self.missing_model(model_id), model_bytes / self.upload_bw, 0.0
            )
            self._upload[key] = u
        return u

    def transfer_vec(self, out_bytes: float, src: int) -> np.ndarray:
        """(D,) transfer-cost row for one parent output moved FROM ``src``:
        ``out_bytes / bw_eff[src, d]`` — the sender's uplink, the receiver's
        downlink, and the tier backhaul all bound the link (Eq. 2's
        ``L(T_i)_d`` priced on the actual path, not the endpoint).  The
        sender row is derived lazily from the factorized link model
        (``cluster.link_row``); its ``src`` entry is +inf, so staying on
        ``src`` costs exactly 0."""
        key = (out_bytes, src)
        v = self._transfer.get(key)
        if v is None:
            v = out_bytes / self.cluster.link_row(src)
            self._transfer[key] = v
        return v

    def surv_leaves(self, t: float) -> Tuple[np.ndarray, np.ndarray]:
        """The snapshot's (surv_grid, survival) forecast leaves at ``t``,
        cached per planning instant (waves share a handful of times)."""
        cached = self._surv_sample.get(t)
        if cached is None:
            if self.forecast is None:
                cached = (np.zeros(1), np.ones((self.n_dev, 1)))
            else:
                cached = (self.forecast.grid(), self.forecast.sample(t))
            self._surv_sample[t] = cached
        return cached

    def fleet(self, t: float) -> FleetSnapshot:
        """Struct-of-arrays snapshot of the fleet at time ``t`` (delegates
        to the one construction site, reusing the wave's cached arrays)."""
        bkt = self.cluster.bucket(t)
        surv_grid, survival = self.surv_leaves(t)
        return self.cluster.snapshot(
            t, counts=self.counts_at_bucket(bkt), join_times=self.join,
            alive=self.alive, surv_grid=surv_grid, survival=survival,
        )

    def feasible_row(self, spec) -> np.ndarray:
        # memory constraint H(T_i) <= H(ED_p) after LRU eviction of cached
        # models (lines 20-23 make cache space reclaimable, so the binding
        # constraint is total memory).
        key = spec.mem_bytes + spec.model_bytes
        f = self._feasible.get(key)
        if f is None:
            f = (self.mem_total >= key) & self.alive
            self._feasible[key] = f
            self._feasible_any[key] = bool(f.any())
        return f

    def feasible_any(self, spec) -> bool:
        key = spec.mem_bytes + spec.model_bytes
        if key not in self._feasible_any:
            self.feasible_row(spec)
        return self._feasible_any[key]

    def batch(self, rows: List[tuple]) -> BatchedPolicyContext:
        """The deduplicated struct-of-arrays view for one wave-stage.

        One light Python pass per row resolves the cached ingredient
        vectors (execution by ``(bucket, ttype)``, upload by model,
        feasibility by memory footprint, transfer by parent output/device)
        and assigns each row to a pool entry keyed by the full ingredient
        tuple + exact start time — everything a context row is a function
        of.  The ``(G, D)`` pool tensors (G = distinct rows, typically a
        handful per wave of a 1000-instance burst) are then assembled once;
        per-row ``(B, D)`` views materialise lazily only if a policy needs
        them.
        """
        if self.cluster.topology_version != self._topo_version:
            raise RuntimeError(
                "cluster topology changed under a live wave builder; the "
                "builder's caches are scoped to one snapshot — plan the next "
                "wave with a fresh orchestrate/orchestrate_batch call"
            )
        B, D = len(rows), self.n_dev
        tasks = []
        ttypes = np.empty(B, dtype=np.int64)
        t_start = np.fromiter((r[2] for r in rows), np.float64, count=B)
        stage_offset = np.fromiter(
            (r[0].stage_offset for r in rows), np.float64, count=B
        )
        buckets = np.fromiter((r[3] for r in rows), np.int64, count=B)

        exec_keys: Dict[Tuple[int, int], int] = {}
        up_keys: Dict[Tuple[Optional[str], float], int] = {(None, 0.0): 0}
        feas_keys: Dict[float, int] = {}
        tvec_keys: Dict[Tuple[float, int], int] = {}
        pool_keys: Dict[tuple, int] = {}
        exec_mats: List[np.ndarray] = []
        up_mats: List[np.ndarray] = [np.zeros(D)]
        feas_mats: List[np.ndarray] = []
        tvecs: List[np.ndarray] = []
        pool_specs: List[tuple] = []      # (exec_i, up_i, feas_i, contrib, t)
        pool_first: List[int] = []
        row_pool = np.empty(B, np.int64)

        for b, (state, tname, t, bkt) in enumerate(rows):
            spec = state.app.tasks[tname]
            tasks.append(tname)
            ttypes[b] = spec.ttype
            k = (bkt, spec.ttype)
            ei = exec_keys.get(k)
            if ei is None:
                ei = exec_keys[k] = len(exec_mats)
                exec_mats.append(self.exec_lat(bkt, spec.ttype))
            # lines 7-10: model upload latency where M(T_i) is missing.
            mid = spec.model_id
            uk = (mid, spec.model_bytes) if mid is not None else (None, 0.0)
            ui = up_keys.get(uk)
            if ui is None:
                ui = up_keys[uk] = len(up_mats)
                up_mats.append(self.upload_row(mid, spec.model_bytes))
            mk = spec.mem_bytes + spec.model_bytes
            fi = feas_keys.get(mk)
            if fi is None:
                fi = feas_keys[mk] = len(feas_mats)
                feas_mats.append(self.feasible_row(spec))
            # lines 11-14: input data transfer from parents' devices, each
            # priced over the sender's row of the link matrix.
            contrib: Tuple[int, ...] = ()
            if spec.deps:
                chosen = state.placements
                acc = []
                for dep in spec.deps:
                    parent = chosen.get(dep)
                    if parent is None or not parent.replicas:
                        continue
                    ob = state.app.tasks[dep].out_bytes
                    pdid = parent.replicas[0].did
                    vk = (ob, pdid)
                    vi = tvec_keys.get(vk)
                    if vi is None:
                        vi = tvec_keys[vk] = len(tvecs)
                        tvecs.append(self.transfer_vec(ob, pdid))
                    acc.append(vi)
                contrib = tuple(acc)
            kk = (ei, ui, fi, contrib, t)
            g = pool_keys.get(kk)
            if g is None:
                g = pool_keys[kk] = len(pool_specs)
                pool_specs.append(kk)
                pool_first.append(b)
            row_pool[b] = g

        G = len(pool_specs)
        exec_pool = np.stack([exec_mats[s[0]] for s in pool_specs])
        upload_pool = np.stack([up_mats[s[1]] for s in pool_specs])
        feasible_pool = np.stack([feas_mats[s[2]] for s in pool_specs])
        transfer_pool = np.zeros((G, D))
        for g, (_ei, _ui, _fi, contrib, _t) in enumerate(pool_specs):
            for vi in contrib:
                # the link-matrix diagonal is +inf, so the sender's own
                # entry is already an exact 0.0 — no copy-and-zero needed
                transfer_pool[g] += tvecs[vi]

        total_pool = exec_pool + upload_pool + transfer_pool    # line 15

        # F(T_i): device must survive from allocation until the task's
        # estimated completion (it departs silently, so the orchestrator
        # cannot condition on liveness at start).
        pool_first_arr = np.asarray(pool_first, dtype=np.int64)
        t_pool = t_start[pool_first_arr]
        window = (t_pool[:, None] - self.join[None, :]) + total_pool
        pf_pool = 1.0 - np.exp(-self.lams[None, :] * window)

        # Forecast survival over each candidate's estimated execution span,
        # evaluated exactly (scripted windows are step functions — sampling
        # a grid would smear the cliff the churn_aware guard relies on).
        if self.forecast is None:
            survival_pool = np.ones_like(total_pool)
        else:
            survival_pool = np.empty_like(total_pool)
            for g in range(G):
                survival_pool[g] = self.forecast.survival(
                    float(t_pool[g]), total_pool[g]
                )

        # Per-row Task_info snapshots: rows sharing a T_alloc bucket share
        # one pool entry; (B, D, N) views materialise lazily on access.
        uniq, inv = np.unique(buckets, return_inverse=True)
        counts_pool = np.stack([self.counts_at_bucket(int(u)) for u in uniq])
        queue_pool = np.stack([self._queue[int(u)] for u in uniq])

        return BatchedPolicyContext(
            tasks=tuple(tasks),
            ttypes=ttypes,
            t_start=t_start,
            stage_offset=stage_offset,
            row_pool=row_pool,
            pool_first=pool_first_arr,
            exec_pool=exec_pool,
            upload_pool=upload_pool,
            transfer_pool=transfer_pool,
            total_pool=total_pool,
            feasible_pool=feasible_pool,
            pf_pool=pf_pool,
            survival_pool=survival_pool,
            counts_pool=counts_pool,
            queue_pool=queue_pool,
            bucket_inv=inv,
            fleet=self.fleet(rows[0][2]),
        )


def policy_on(policy, cluster: ClusterState, device=None, **kwargs) -> Policy:
    """The policy a planning call runs: a registered name is built on
    ``device`` (default: the cluster's) with ``kwargs``; an instance is
    returned as it is, and then ``device`` must be unset, since an instance
    keeps the device it was made for."""
    if isinstance(policy, str):
        return make_policy(
            policy, device=cluster.device if device is None else device,
            **kwargs,
        )
    if device is not None:
        raise ValueError(
            "`device` applies to a policy given by name; a Policy instance "
            "runs on the device it was made for (make_policy(..., device=))"
        )
    return policy


def orchestrate_batch(
    apps: Sequence[AppDAG],
    cluster: ClusterState,
    policy: Policy,
    *,
    now: float = 0.0,
    times: Optional[Sequence[float]] = None,
    batched: bool = True,
    pinned: Optional[Sequence[Optional[Dict[str, TaskPlacement]]]] = None,
    device=None,
) -> List[Plan]:
    """Pure fused planning for a whole arrival wave of B applications.

    Walks all apps' staged DAGs in lock-step (wave-stage s = stage s of
    every app), builds ONE :class:`BatchedPolicyContext` per wave-stage, and
    lets ``policy.decide_batch`` place every task of the wave in one fused
    call.  Cluster state is only read; apply each returned plan (or none)
    explicitly.

    Semantics: every plan is computed against the SAME cluster snapshot —
    plans do not see each other's provisional T_alloc occupancy, which is
    exactly the "burst of simultaneous arrivals" reading of the paper's
    §V-G protocol (for arrivals far apart in time, plan sequentially and
    apply in between instead).  Rows are ordered app-major within each
    wave-stage, and stateful policies consume their rng/cursor state once
    per row in that order, so ``batched=False`` (loop ``policy.decide`` over
    the same rows) is bit-identical — that is the parity contract the tests
    pin down.  For stateless policies the result also equals looping
    ``orchestrate`` per app without intermediate applies.

    An application whose task has no memory-feasible live device is marked
    infeasible at that task and drops out of later wave-stages; its rows
    are screened out *before* the policy sees the batch, so stateful
    policies consume nothing for them (matching the scalar path, which
    returns before calling ``decide``).  Devices already departed at the
    wave's planning instant (the earliest arrival) are masked infeasible
    for every row — a policy can never select a dead device.

    ``pinned`` (aligned with ``apps``; entries may be None) carries task
    placements that are already decided — completed or in-flight tasks of a
    partially-executed instance.  Pinned tasks are not re-decided and emit
    no rows (stateful policies consume nothing for them), but their chosen
    devices still price the transfer costs of downstream tasks, and the
    returned plan contains ONLY the newly planned tasks — this is the
    replan recovery strategy's substrate (re-place a dead task and the
    not-yet-started remainder of its DAG on the live sub-fleet).

    ``device`` is where a policy given by name runs its decision kernels
    (default: the cluster's device, the card unless it was built for the
    CPU).  A :class:`Policy` instance runs on the device it was made for,
    so ``device`` must then be left unset.
    """
    policy = policy_on(policy, cluster, device)
    if times is None:
        times = [float(now)] * len(apps)
    elif len(times) != len(apps):
        raise ValueError("apps and times must have equal length")
    if pinned is None:
        pinned = [None] * len(apps)
    elif len(pinned) != len(apps):
        raise ValueError("apps and pinned must have equal length")

    builder = _WaveContextBuilder(
        cluster, now=min(times, default=float(now))
    )
    bucket = cluster.bucket
    states = [
        _AppPlanState(
            app=app, arrival=float(t), n_stages=app.n_stages,
            placements=dict(pin) if pin else {},
            pinned=frozenset(pin) if pin else frozenset(),
        )
        for app, t, pin in zip(apps, times, pinned)
    ]
    max_stages = max((st.n_stages for st in states), default=0)

    for s in range(max_stages):                         # line 3 (per wave)
        rows: List[tuple] = []
        for st in states:
            if not st.alive or s >= st.n_stages:
                continue
            st.stage_latency = 0.0
            t_start = st.arrival + st.stage_offset
            bkt = bucket(t_start)
            for tname in st.app.stages[s]:              # line 4
                if tname not in st.pinned:
                    rows.append((st, tname, t_start, bkt))

        # Screen memory-infeasible rows before the policy sees the batch:
        # the app dies at its first infeasible task and its later rows are
        # excluded (stateful policies must not consume state for them).
        kept: List[tuple] = []
        for row in rows:
            st = row[0]
            if not st.alive:
                continue
            if not builder.feasible_any(st.app.tasks[row[1]]):
                st.alive = False
                st.infeasible_task = row[1]
            else:
                kept.append(row)
        if not kept:
            continue

        batch = builder.batch(kept)
        if batched:
            decisions = policy.decide_batch(batch).devices
        else:
            # the scalar reference: same rows, same order, one decide() each
            decisions = tuple(
                policy.decide(batch.row(b)).devices
                for b in range(batch.n_rows)
            )

        # Bulk-extract the primary replica's estimate columns (one gather +
        # one C-level tolist per tensor instead of 4B numpy scalar reads).
        Bk = len(kept)
        prim = np.fromiter(
            (d[0] if d else 0 for d in decisions), np.int64, count=Bk
        )
        ex_p, up_p, tr_p, pf_p = batch.primary_estimates(prim)
        ttypes_l = batch.ttypes.tolist()

        # Apps that died during SCREENING still record their earlier kept
        # rows (the scalar path places a stage's tasks one by one and keeps
        # them when a later task turns out infeasible); apps that die here,
        # on an empty DECISION, skip their remaining rows.
        dead_in_record = set()
        for b, row in enumerate(kept):
            st = row[0]
            if id(st) in dead_in_record:
                continue                 # app died at an earlier row
            devs = decisions[b]
            if not devs:                 # e.g. the IBDASH avail_floor guard
                st.alive = False
                st.infeasible_task = row[1]
                dead_in_record.add(id(st))
                continue
            replicas = [Replica(int(devs[0]), ex_p[b], up_p[b], tr_p[b], pf_p[b])]
            for did in devs[1:]:
                replicas.append(Replica(int(did), *batch.estimates_at(b, did)))
            tp = TaskPlacement(
                task=row[1],
                ttype=ttypes_l[b],
                replicas=replicas,
                est_start=st.stage_offset,
                est_latency=replicas[0].est_total,
            )
            st.placements[row[1]] = tp                  # line 42
            st.stage_latency = max(st.stage_latency, tp.est_latency)  # l.44

        for st in states:
            if st.alive and s < st.n_stages:
                st.stage_offset += st.stage_latency

    # L(G) = sum of stage maxima (Eq. 3) == the final stage offset.  On a
    # replan, pinned tasks drop out: the plan holds only the newly placed
    # remainder (apply must not re-record the pinned tasks' occupancy).
    return [
        Plan(app=st.app, now=st.arrival, placement=Placement(
            app_name=st.app.name,
            tasks=(
                {k: v for k, v in st.placements.items() if k not in st.pinned}
                if st.pinned else st.placements
            ),
            est_latency=st.stage_offset if st.alive else 0.0,
            feasible=st.alive,
            infeasible_task=st.infeasible_task,
        ))
        for st in states
    ]


def orchestrate(
    app: AppDAG, cluster: ClusterState, now: float, policy: Policy,
    *, batched: bool = True,
    pinned: Optional[Dict[str, TaskPlacement]] = None,
    device=None,
) -> Plan:
    """Pure planning: walk the staged DAG (Algorithm 1 lines 3-4), build one
    batched context per stage, let the policy pick devices (one
    ``decide_batch`` call per stage, or ``decide`` per task with
    ``batched=False`` — the two are bit-identical), and assemble the Plan.
    Cluster state is only read — call ``cluster.apply(plan)`` to make the
    placement real (or discard the plan for free).  ``pinned`` placements
    are kept as-is and only the remaining tasks are planned (the replan
    recovery path; see :func:`orchestrate_batch`, which also says what
    ``device`` does).
    """
    return orchestrate_batch(
        [app], cluster, policy, times=[now], batched=batched,
        pinned=[pinned] if pinned else None, device=device,
    )[0]

