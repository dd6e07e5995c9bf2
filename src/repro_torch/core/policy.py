"""Pure, array-native placement policies (the redesigned orchestration API).

The paper's Algorithm 1 is, at heart, a *scoring rule*: blend the latency
estimate of Eq. (2) with the failure probability of Eq. (4) using the
weight of Eq. (5) and pick devices.  The seed buried that rule inside
``Scheduler.place``, which also mutated cluster state — so policies could
not be composed, batched, or replayed.  This module splits the two concerns:

  * :class:`PolicyContext` — a frozen, array-shaped snapshot of everything a
    policy may look at for ONE task: the per-device execution-latency vector
    (Eq. 1 across the fleet), upload/transfer cost vectors, the feasibility
    mask, per-device failure probabilities, queue lengths and running-task
    counts.  It is precomputed once per task (and the expensive pieces once
    per *stage*) by :func:`repro_torch.core.orchestrator.orchestrate`.
  * :class:`TaskDecision` — the policy's entire output: an ordered tuple of
    device ids (primary first; extras are replicas).
  * ``decide(ctx) -> TaskDecision`` — a pure function of the context (plus,
    for the randomized baselines, the policy's own rng stream).  IBDASH and
    all five baselines are each ~10-30 lines.
  * ``decide_batch(batch)`` — the fused twin over a whole wave.  IBDASH
    (and ``churn_aware``), LAVEA, round robin and tier escalation run the
    float64 torch kernels of :mod:`repro_torch.core.batched` on the
    policy's ``device``; the randomized baselines keep their seeded numpy
    draws on the host, so their streams match the scalar rule's.

Policies are registered by name with :func:`register_policy` and built with
:func:`make_policy`.  The registry is the port's own (registering here
leaves the JAX package's registry untouched).  Every factory accepts the
full keyword bundle (``alpha``, ``beta``, ``gamma``, ``seed``,
``lats_model``, ``device``, ...) and picks out what it needs, so callers
can construct any scheme uniformly.

State mutation is *not* a policy concern: ``orchestrate`` returns a
:class:`~repro_torch.core.orchestrator.Plan` and the caller decides whether to
``cluster.apply(plan)`` (which returns an undo token for speculative
what-if planning).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable, Dict, Optional, Tuple, Type

import numpy as np

from ..device import resolve_device
from .batched import (
    BatchedDecision,
    BatchedPolicyContext,
    FleetSnapshot,
    BATCH_KERNEL_MIN_ROWS,
    ibdash_decide_batch,
    lavea_decide_batch,
    round_robin_decide_batch,
    tier_escalation_decide_batch,
)

__all__ = [
    "PolicyContext",
    "TaskDecision",
    "FleetSnapshot",
    "BatchedPolicyContext",
    "BatchedDecision",
    "Policy",
    "register_policy",
    "make_policy",
    "available_policies",
    "IBDASHConfig",
    "IBDASHPolicy",
    "RandomPolicy",
    "RoundRobinPolicy",
    "LAVEAPolicy",
    "PetrelPolicy",
    "LaTSModel",
    "LaTSPolicy",
    "TierEscalationPolicy",
    "ChurnAwarePolicy",
]


@dataclass(frozen=True)
class PolicyContext:
    """Everything a policy may inspect to place ONE task — all array-shaped.

    Vectors are indexed by device id (length ``n_devices``); ``counts`` is
    the ``(D, N)`` running-task matrix (Task_info at ``t_start``).  The
    context is built from :class:`~repro_torch.core.cluster.ClusterState` by the
    ``orchestrate`` entry point and never mutated; policies must treat the arrays
    as read-only.
    """

    task: str                    # task name (for error reporting)
    ttype: int                   # index into the task-type table
    t_start: float               # absolute estimated start (now + stage offset)
    stage_offset: float          # offset from app arrival (stage barrier)
    exec_lat: np.ndarray         # (D,) Eq. (1) execution latency per device
    upload: np.ndarray           # (D,) L(M(T_i)) model-upload latency
    transfer: np.ndarray         # (D,) L(T_i)_d input-transfer latency
    total: np.ndarray            # (D,) Eq. (2): exec + upload + transfer
    feasible: np.ndarray         # (D,) bool memory-feasibility mask
    feasible_ids: np.ndarray     # (D',) int ids where feasible
    pf: np.ndarray               # (D,) F(T_i): P(device dies before completion)
    lams: np.ndarray             # (D,) failure rates
    join_times: np.ndarray       # (D,) device join times
    queue_len: np.ndarray        # (D,) total running tasks (LAVEA's SQLF signal)
    counts: np.ndarray           # (D, N) per-type running-task counts
    classes: np.ndarray          # (D,) device-class ids
    # (D,) fleet tier ids (0=device, 1=edge server, 2=cloud); None on
    # contexts built before multi-tier fleets existed == single-tier.
    tiers: Optional[np.ndarray] = None
    # (D,) bool churn mask: devices not yet departed when the plan was made.
    # Already ANDed into ``feasible``; None on hand-built contexts == all up.
    alive: Optional[np.ndarray] = None
    # (D,) forecast survival over THIS task's estimated execution span:
    # S_d(t_start, t_start + total[d]).  All-ones when no availability
    # forecast is installed; None on hand-built contexts == no forecast.
    # Only forecast-aware policies (churn_aware) read it — the paper's six
    # keep pricing failures through the memoryless ``pf``.
    survival: Optional[np.ndarray] = None

    @property
    def n_devices(self) -> int:
        return int(self.exec_lat.shape[0])


@dataclass(frozen=True)
class TaskDecision:
    """A policy's verdict for one task: devices to run it on, primary first.

    An empty tuple means the policy found no acceptable device (e.g. the
    IBDASH availability floor filtered every candidate); the orchestrator
    marks the plan infeasible at this task.
    """

    devices: Tuple[int, ...]

    @property
    def primary(self) -> int:
        return self.devices[0]

    @property
    def n_replicas(self) -> int:
        return max(len(self.devices) - 1, 0)


class Policy:
    """A pure placement policy: ``decide`` maps a context to a decision.

    Implementations hold only configuration and (for randomized schemes)
    their own rng / cursor state — never cluster state.

    ``decide_batch`` is the fused entry point: one call decides all B rows
    of a :class:`~repro_torch.core.batched.BatchedPolicyContext`.  Batch semantics
    are DEFINED as processing the rows in order, exactly as if ``decide``
    were called once per row — stateful policies (rng streams, the
    round-robin cursor) consume their state once per row with a non-empty
    feasible set, in row order.  The default implementation is that loop;
    registered policies override it with vectorised implementations (the
    torch decision kernels on the policy's device, or numpy on the host)
    that are bit-identical to the loop.
    """

    name: str = "base"

    def decide(self, ctx: PolicyContext) -> TaskDecision:
        raise NotImplementedError

    def decide_batch(self, batch: BatchedPolicyContext) -> BatchedDecision:
        return BatchedDecision(devices=tuple(
            self.decide(batch.row(b)).devices for b in range(batch.n_rows)
        ))


# -- registry -----------------------------------------------------------------
_REGISTRY: "Dict[str, Type[Policy]]" = {}


def register_policy(name: str) -> Callable[[Type[Policy]], Type[Policy]]:
    """Class decorator: register a policy under ``name`` (kebab/snake case).

    The registered class must accept keyword-only construction; extra
    keywords it does not understand are ignored (``**_``) so that
    :func:`make_policy` can pass one uniform kwarg bundle to every scheme.
    """

    def deco(cls: Type[Policy]) -> Type[Policy]:
        if name in _REGISTRY:
            raise ValueError(f"policy {name!r} already registered")
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def make_policy(name: str, *, device="cuda", **kwargs) -> Policy:
    """Instantiate a registered policy by name.

    All callers pass the same kwarg bundle (alpha/beta/gamma/seed/
    lats_model/...); each policy keeps what it needs.  ``device`` is where
    the policy's decision kernels run: the card unless the caller names
    the CPU (raises when CUDA is asked for and there is no card).
    """
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown policy {name!r}; available: {sorted(_REGISTRY)}"
        ) from None
    return cls(device=resolve_device(device), **kwargs)


def available_policies() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


# -- IBDASH (Algorithm 1's scoring + replication rule) ------------------------
@dataclass
class IBDASHConfig:
    alpha: float = 0.5     # joint optimisation weight (Eq. 5)
    beta: float = 0.1      # probability-of-failure threshold
    gamma: int = 3         # replication degree cap
    # When True the orchestrator drops devices whose *predicted* availability
    # is below ``avail_floor`` from the candidate set entirely (a beyond-paper
    # guard; disabled by default to stay faithful).
    avail_floor: float = 0.0


@register_policy("ibdash")
class IBDASHPolicy(Policy):
    """Algorithm 1, lines 16-41, as a pure function of the context."""

    def __init__(
        self,
        config: Optional[IBDASHConfig] = None,
        *,
        alpha: Optional[float] = None,
        beta: Optional[float] = None,
        gamma: Optional[int] = None,
        avail_floor: Optional[float] = None,
        device="cuda",
        **_,
    ):
        self.device = resolve_device(device)
        cfg = config or IBDASHConfig()
        over = {k: v for k, v in dict(
            alpha=alpha, beta=beta, gamma=gamma, avail_floor=avail_floor
        ).items() if v is not None}
        self.cfg = replace(cfg, **over) if over else cfg

    def _columns(
        self, ctx: PolicyContext
    ) -> Tuple[np.ndarray, np.ndarray]:
        """The (pf, feasible) columns the scoring rule runs over — the
        override hook for forecast-aware variants (ChurnAwarePolicy)."""
        cfg = self.cfg
        feasible = ctx.feasible
        if cfg.avail_floor > 0.0:
            avail = np.exp(-ctx.lams * (ctx.t_start - ctx.join_times))
            feasible = feasible & (avail >= cfg.avail_floor)
        return ctx.pf, feasible

    def _batch_columns(
        self, batch: BatchedPolicyContext
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(G, D) twin of :meth:`_columns` for the pooled batch tensors."""
        cfg = self.cfg
        feasible = batch.feasible_pool
        if cfg.avail_floor > 0.0:
            t_pool = batch.t_start[batch.pool_first]
            avail = np.exp(
                -batch.lams[None, :]
                * (t_pool[:, None] - batch.join_times[None, :])
            )
            feasible = feasible & (avail >= cfg.avail_floor)
        return batch.pf_pool, feasible

    def decide(self, ctx: PolicyContext) -> TaskDecision:
        pf, feasible = self._columns(ctx)
        return TaskDecision(devices=self._score(ctx.total, pf, feasible))

    def decide_batch(self, batch: BatchedPolicyContext) -> BatchedDecision:
        """All B rows in one fused call on ``self.device``: the queue by a
        stable device sort, then the scoring + replication loop vectorised
        over rows (see :func:`repro_torch.core.batched.ibdash_decide_batch`).
        Bit-identical to looping :meth:`decide`.

        IBDASH is stateless, so it decides once per DISTINCT context row
        (the batch's pool) and fans the decision out — a 1000-instance
        burst of a few app types collapses to a handful of scored rows.
        Small pools take the scalar loop directly (a device call's fixed
        cost would dominate)."""
        cfg = self.cfg
        pf, feasible = self._batch_columns(batch)
        if batch.n_distinct < BATCH_KERNEL_MIN_ROWS:
            pool_dec = [
                self._score(batch.total_pool[g], pf[g], feasible[g])
                for g in range(batch.n_distinct)
            ]
        else:
            pool_dec = ibdash_decide_batch(
                batch.total_pool, pf, feasible,
                cfg.alpha, cfg.beta, cfg.gamma, self.device,
            )
        return BatchedDecision(devices=tuple(
            pool_dec[g] for g in batch.row_pool.tolist()
        ))

    def _score(
        self, total: np.ndarray, pf: np.ndarray, feasible: np.ndarray
    ) -> Tuple[int, ...]:
        """Algorithm 1 lines 16-41 for ONE task (the scalar reference)."""
        cfg = self.cfg
        cand = np.flatnonzero(feasible)
        if cand.size == 0:
            return ()

        # lines 16-18: priority queue == ascending order over L(T_i).
        order = cand[np.argsort(total[cand], kind="stable")]
        best_total = float(total[order[0]])
        l_ref = max(best_total, 1e-9)
        devices = [int(order[0])]
        comb_fail = float(pf[order[0]])
        # line 29: weighted joint score, latency normalised by the best
        # candidate so alpha sweeps [0,1] meaningfully.
        weight_s = cfg.alpha * (best_total / l_ref) + (1 - cfg.alpha) * comb_fail

        t_rep = 0
        qi = 1
        while comb_fail >= cfg.beta and t_rep < cfg.gamma and qi < order.size:  # line 30
            did = order[qi]                                 # line 31
            qi += 1
            cand_total = float(total[did])
            new_fail = comb_fail * float(pf[did])
            weight_new = cfg.alpha * (cand_total / l_ref) + (1 - cfg.alpha) * new_fail
            if weight_new <= weight_s:                      # line 34
                devices.append(int(did))                    # line 35
                comb_fail = new_fail
                weight_s = weight_new
                t_rep += 1                                  # line 37
            else:
                break                                       # line 39
        return tuple(devices)


# -- baselines (§V-D) ---------------------------------------------------------
# All baselines return an empty decision on an empty feasible set (like
# IBDASH) so the orchestrator can mark the plan infeasible instead of the
# policy crashing on an unguarded ``feasible_ids`` index.
@register_policy("random")
class RandomPolicy(Policy):
    """Uniform random feasible device."""

    def __init__(self, *, seed: int = 0, **_):
        self.rng = np.random.default_rng(seed)

    def decide(self, ctx: PolicyContext) -> TaskDecision:
        ids = ctx.feasible_ids
        if ids.size == 0:
            return TaskDecision(devices=())
        return TaskDecision(devices=(int(self.rng.choice(ids)),))

    def decide_batch(self, batch: BatchedPolicyContext) -> BatchedDecision:
        # One rng draw per non-empty row, in row order: the draws themselves
        # must replay the scalar numpy stream, so only the feasibility scan
        # is vectorised.
        out = []
        for b in range(batch.n_rows):
            ids = batch.feasible_ids(b)
            out.append(
                () if ids.size == 0 else (int(self.rng.choice(ids)),)
            )
        return BatchedDecision(devices=tuple(out))


@register_policy("round_robin")
class RoundRobinPolicy(Policy):
    """Cyclic assignment over the feasible set."""

    def __init__(self, *, seed: int = 0, device="cuda", **_):
        self.device = resolve_device(device)
        self._next = 0

    def decide(self, ctx: PolicyContext) -> TaskDecision:
        return TaskDecision(devices=self._pick(ctx.feasible_ids))

    def _pick(self, ids: np.ndarray) -> Tuple[int, ...]:
        """The scalar rule: the cursor's feasible device, cursor advanced."""
        if ids.size == 0:
            return ()
        did = int(ids[self._next % ids.size])
        self._next += 1
        return (did,)

    def decide_batch(self, batch: BatchedPolicyContext) -> BatchedDecision:
        # Cursor semantics under batching: the cursor advances once per
        # non-empty row, in row order (== looping ``decide``); the gather of
        # each row's k-th feasible device is one fused kernel call.  Fewer
        # rows than BATCH_KERNEL_MIN_ROWS take the scalar rule.
        if batch.n_rows < BATCH_KERNEL_MIN_ROWS:
            return BatchedDecision(devices=tuple(
                self._pick(batch.feasible_ids(b)) for b in range(batch.n_rows)
            ))
        devices, self._next = round_robin_decide_batch(
            batch.feasible, self._next, self.device
        )
        return BatchedDecision(devices=tuple(devices))


@register_policy("lavea")
class LAVEAPolicy(Policy):
    """Shortest Queue Length First (best scheme of LAVEA [6])."""

    def __init__(self, *, seed: int = 0, device="cuda", **_):
        self.device = resolve_device(device)

    def decide(self, ctx: PolicyContext) -> TaskDecision:
        return TaskDecision(devices=self._pick(ctx.queue_len, ctx.feasible_ids))

    @staticmethod
    def _pick(queue_len: np.ndarray, ids: np.ndarray) -> Tuple[int, ...]:
        """The scalar rule: the first feasible device of shortest queue."""
        if ids.size == 0:
            return ()
        return (int(ids[int(np.argmin(queue_len[ids]))]),)

    def decide_batch(self, batch: BatchedPolicyContext) -> BatchedDecision:
        # SQLF is stateless: argmin once per distinct context row, fan out.
        # Fewer distinct rows than BATCH_KERNEL_MIN_ROWS take the scalar rule.
        q_pool = batch.queue_pool[batch.bucket_inv[batch.pool_first]]
        if batch.n_distinct < BATCH_KERNEL_MIN_ROWS:
            pool_dec = [
                self._pick(q_pool[g], np.flatnonzero(batch.feasible_pool[g]))
                for g in range(batch.n_distinct)
            ]
        else:
            pool_dec = lavea_decide_batch(
                q_pool, batch.feasible_pool, self.device
            )
        return BatchedDecision(devices=tuple(
            pool_dec[g] for g in batch.row_pool.tolist()
        ))


@register_policy("petrel")
class PetrelPolicy(Policy):
    """Power-of-two-choices randomized load balancing [7], [8]."""

    def __init__(self, *, seed: int = 0, **_):
        self.rng = np.random.default_rng(seed)

    def decide(self, ctx: PolicyContext) -> TaskDecision:
        ids = ctx.feasible_ids
        if ids.size == 0:
            return TaskDecision(devices=())
        if ids.size == 1:
            return TaskDecision(devices=(int(ids[0]),))
        a, b = self.rng.choice(ids, size=2, replace=False)
        pick = a if ctx.exec_lat[a] <= ctx.exec_lat[b] else b
        return TaskDecision(devices=(int(pick),))

    def decide_batch(self, batch: BatchedPolicyContext) -> BatchedDecision:
        # Two-sample draws replay the scalar stream row by row (rows with
        # zero/one feasible device consume no randomness, like ``decide``).
        out = []
        exec_pool = batch.exec_pool
        row_pool = batch.row_pool
        for b in range(batch.n_rows):
            ids = batch.feasible_ids(b)
            if ids.size == 0:
                out.append(())
            elif ids.size == 1:
                out.append((int(ids[0]),))
            else:
                a, c = self.rng.choice(ids, size=2, replace=False)
                g = row_pool[b]
                pick = a if exec_pool[g, a] <= exec_pool[g, c] else c
                out.append((int(pick),))
        return BatchedDecision(devices=tuple(out))


@dataclass
class LaTSModel:
    """Parametric latency model of LaTS [9]: log(latency) is linear in CPU
    usage (paper Fig. 5):  lat(cls, type, usage) = base * exp(b * usage).

    ``cpu_usage[cls, ttype]`` is the incremental CPU fraction one running
    task of ``ttype`` consumes on a class-``cls`` device; the device's total
    usage saturates at 1.0.
    """

    base: np.ndarray       # (P, N) unloaded latency per class/type
    b: np.ndarray          # (P,) fitted log-linear slope per class
    cpu_usage: np.ndarray  # (P, N)
    usage_cap: float = 4.0  # >1: oversubscribed CPU still adds latency signal

    def predict(self, classes: np.ndarray, ttype: int, counts: np.ndarray) -> np.ndarray:
        usage = np.minimum(
            (self.cpu_usage[classes] * counts).sum(axis=1), self.usage_cap
        )
        return self.base[classes, ttype] * np.exp(self.b[classes] * usage)


@register_policy("lats")
class LaTSPolicy(Policy):
    """Latency-aware task scheduling via the latency–CPU-usage model.

    LaTS predicts execution latency well but ignores data-transfer and
    model-upload costs as well as failure probability — which is why (as in
    the paper) it concentrates load on the single fastest device."""

    def __init__(
        self,
        *,
        lats_model: Optional[LaTSModel] = None,
        model: Optional[LaTSModel] = None,
        seed: int = 0,
        **_,
    ):
        self.model = lats_model if lats_model is not None else model
        if self.model is None:
            raise ValueError("LaTS needs a fitted LaTSModel (lats_model=...)")
        self.rng = np.random.default_rng(seed)

    def decide(self, ctx: PolicyContext) -> TaskDecision:
        ids = ctx.feasible_ids
        if ids.size == 0:
            return TaskDecision(devices=())
        pred = self.model.predict(ctx.classes[ids], ctx.ttype, ctx.counts[ids])
        # Devices of the same class at saturated CPU usage produce identical
        # predictions; break ties randomly so LaTS spreads within its
        # favourite class instead of degenerating onto device 0.
        lo = pred.min()
        ties = np.flatnonzero(pred <= lo * (1.0 + 1e-9))
        return TaskDecision(devices=(int(ids[int(self.rng.choice(ties))]),))

    def decide_batch(self, batch: BatchedPolicyContext) -> BatchedDecision:
        # The latency model is evaluated once per DISTINCT context row in
        # one vectorised shot; only the per-row tie-break draw stays
        # sequential (it must replay the scalar rng stream).
        model = self.model
        classes = batch.classes
        counts_g = batch.counts_pool[batch.bucket_inv[batch.pool_first]]
        tt_g = batch.ttypes[batch.pool_first]               # (G,)
        usage = np.minimum(
            (model.cpu_usage[classes][None, :, :] * counts_g).sum(axis=2),
            model.usage_cap,
        )                                                   # (G, D)
        pred = model.base[classes[None, :], tt_g[:, None]] * np.exp(
            model.b[classes][None, :] * usage
        )                                                   # (G, D)
        row_pool = batch.row_pool
        out = []
        for b in range(batch.n_rows):
            ids = batch.feasible_ids(b)
            if ids.size == 0:
                out.append(())
                continue
            pred_sub = pred[row_pool[b], ids]
            lo = pred_sub.min()
            ties = np.flatnonzero(pred_sub <= lo * (1.0 + 1e-9))
            out.append((int(ids[int(self.rng.choice(ties))]),))
        return BatchedDecision(devices=tuple(out))


# -- multi-tier fleets (arXiv:2409.10839's device -> edge -> cloud extension) --
@register_policy("tier_escalation")
class TierEscalationPolicy(Policy):
    """Prefer same-tier placement, escalate device -> edge server -> cloud.

    Tasks originate on the end-device tier; the policy places on the
    min-``total``-latency feasible device of the lowest tier level whose
    best candidate meets ``latency_budget`` (Eq. 2 latency, which already
    prices transfers over the tier-aware link matrix).  A tier level is
    escalated past when it has no memory-feasible device or its best
    candidate blows the budget; if even the cloud misses the budget, the
    globally best feasible device wins.  Stateless, so the batched path
    decides once per distinct context row and fans out."""

    def __init__(self, *, latency_budget: float = float("inf"),
                 device="cuda", **_):
        self.device = resolve_device(device)
        self.latency_budget = float(latency_budget)

    def _tiers_of(self, tiers: Optional[np.ndarray], n: int) -> np.ndarray:
        if tiers is None:
            return np.zeros(n, dtype=np.int64)
        return tiers

    def decide(self, ctx: PolicyContext) -> TaskDecision:
        tiers = self._tiers_of(ctx.tiers, ctx.n_devices)
        return TaskDecision(
            devices=self._pick(ctx.total, ctx.feasible, tiers)
        )

    def decide_batch(self, batch: BatchedPolicyContext) -> BatchedDecision:
        tiers = self._tiers_of(batch.tiers, batch.n_devices)
        if batch.n_distinct < BATCH_KERNEL_MIN_ROWS:
            pool_dec = [
                self._pick(batch.total_pool[g], batch.feasible_pool[g], tiers)
                for g in range(batch.n_distinct)
            ]
        else:
            pool_dec = tier_escalation_decide_batch(
                batch.total_pool, batch.feasible_pool, tiers,
                self.latency_budget, self.device,
            )
        return BatchedDecision(devices=tuple(
            pool_dec[g] for g in batch.row_pool.tolist()
        ))

    def _pick(
        self, total: np.ndarray, feasible: np.ndarray, tiers: np.ndarray
    ) -> Tuple[int, ...]:
        """The scalar reference rule (the fused kernel's bit-exact twin)."""
        if not feasible.any():
            return ()
        budget = self.latency_budget
        for lv in range(int(tiers.max()) + 1):
            masked = np.where(feasible & (tiers <= lv), total, np.inf)
            best = int(np.argmin(masked))
            if np.isfinite(masked[best]) and masked[best] <= budget:
                return (best,)
        return (int(np.argmin(np.where(feasible, total, np.inf))),)


# -- churn-aware planning (the availability forecast as a policy input) --------
@register_policy("churn_aware")
class ChurnAwarePolicy(IBDASHPolicy):
    """IBDASH scoring over forecast-adjusted failure probabilities.

    The paper prices future departures only through the memoryless
    ``F(T_i)`` (Eq. 3), but scripted maintenance windows and predicted
    departures are *knowable in advance* (the mobility-aware orchestration
    premise of arXiv:2110.07808).  When an availability forecast is
    installed (``ChurnSchedule.install`` / ``ClusterState.install_forecast``)
    the contexts carry each candidate's survival over the task's estimated
    execution span, and this policy:

      * drops candidates whose survival is at or below ``surv_floor``
        (default 0.0 — i.e. candidates the forecast says WILL depart before
        the task completes) whenever at least one feasible survivor exists,
        so a task is never knowingly placed across a maintenance window;
      * replaces the memoryless ``pf`` with the compound hazard
        ``1 - S_d * (1 - pf_d)`` — the device must dodge both the forecast
        hazard and the residual memoryless one — and runs Algorithm 1's
        score-and-replicate rule unchanged over it.

    With no forecast installed (or the uniform all-ones forecast) both
    adjustments are exact no-ops — ``np.where(S >= 1, pf, ...)`` keeps the
    pf column bit-identical — so placements equal registry ``ibdash``
    bit-for-bit (pinned by the parity suite).  Stateless; the batched path
    reuses the IBDASH device kernels over the adjusted columns (adjusted on
    the host, in numpy) and is bit-identical to the scalar twin.
    """

    def __init__(self, *, surv_floor: float = 0.0, **kwargs):
        super().__init__(**kwargs)
        self.surv_floor = float(surv_floor)

    def _adjust(
        self, pf: np.ndarray, feasible: np.ndarray, surv: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(pf_eff, feasible_eff) for one row or a whole (G, D) pool."""
        # exact no-op where the forecast is uniform: 1 - 1*(1 - pf) is NOT
        # bit-identical to pf in IEEE arithmetic, so branch on S >= 1
        pf_eff = np.where(surv >= 1.0, pf, 1.0 - surv * (1.0 - pf))
        ok = feasible & (surv > self.surv_floor)
        if ok.ndim == 1:
            feas_eff = ok if ok.any() else feasible
        else:
            has = ok.any(axis=1)
            feas_eff = np.where(has[:, None], ok, feasible)
        return pf_eff, feas_eff

    def _columns(
        self, ctx: PolicyContext
    ) -> Tuple[np.ndarray, np.ndarray]:
        pf, feasible = super()._columns(ctx)
        if ctx.survival is None:        # hand-built context: no forecast
            return pf, feasible
        return self._adjust(pf, feasible, ctx.survival)

    def _batch_columns(
        self, batch: BatchedPolicyContext
    ) -> Tuple[np.ndarray, np.ndarray]:
        pf, feasible = super()._batch_columns(batch)
        return self._adjust(pf, feasible, batch.survival_pool)
