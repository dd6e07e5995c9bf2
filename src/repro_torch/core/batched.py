"""Batched, array-native substrate for placement policies, and the float64
torch decision kernels their ``decide_batch`` overrides run.

Each policy is a pure function ``decide(ctx) -> TaskDecision`` of a
per-task :class:`~repro_torch.core.policy.PolicyContext`, but a burst of
~1000 simultaneous application instances (the paper's §V-G protocol) would
pay a Python round-trip per task.  This module holds the batched
counterparts:

  * :class:`FleetSnapshot` — a struct-of-arrays snapshot of the fleet at one
    planning instant: the static device vectors (classes, failure rates,
    bandwidths, memory, join times) plus the dynamic ``(D, N)`` Task_info
    counts.
  * :class:`BatchedPolicyContext` — ``(B, D)``-shaped exec/upload/transfer/
    total/pf/feasible tensors for all B tasks of a stage or arrival wave,
    built once per wave by :func:`repro_torch.core.orchestrator.orchestrate_batch`.
    ``row(b)`` recovers the exact scalar :class:`PolicyContext` of row ``b``,
    which is how the default ``Policy.decide_batch`` fallback and the parity
    tests tie the two APIs together.
  * :class:`BatchedDecision` — one device tuple per row, primary first.

Snapshots and contexts keep numpy leaves on the host.  The bottom half holds
the decision kernels, plain functions of torch tensors on any device: the
IBDASH score-and-replicate loop (Algorithm 1 lines 29-41) over the sorted
candidate queue, vectorised over all rows; the queue itself, selected on
the device by a stable sort; LAVEA's masked argmin; the round-robin
gather; and tier escalation.  Each ``*_decide_batch`` moves its ``(G, D)``
pool inputs to the policy's device once a call (rows padded to a bounded
set of counts, :func:`_padded`), runs its kernel there and brings the
result back.  The kernels are eager float64 torch ops, one IEEE operation
per numpy operation of the reference rule (no fused multiply-add, no
compiled graph), so they are **bit-identical** to the numpy scalar path:
parity is asserted, not approximate.  Beside each kernel sits its plain
numpy version (``*_plain``), which the tests and ``chip_smoke.py`` hold
the kernel against; no planning path calls a plain version.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from functools import cached_property
from typing import List, Tuple, Union

import numpy as np
import torch

__all__ = [
    "FLEET_SNAPSHOT_SCHEMA",
    "FleetSnapshot",
    "BatchedPolicyContext",
    "BatchedDecision",
    "BATCH_KERNEL_MIN_ROWS",
    "TOPK_PRUNE_MIN_DEVICES",
    "DECISION_KERNELS",
    "ibdash_decide_batch",
    "lavea_decide_batch",
    "round_robin_decide_batch",
    "tier_escalation_decide_batch",
    "select_queue",
    "ibdash_scan_kernel",
    "lavea_kernel",
    "round_robin_kernel",
    "tier_escalation_kernel",
    "select_queue_plain",
    "ibdash_scan_plain",
    "lavea_plain",
    "round_robin_plain",
    "tier_escalation_plain",
]

# Below this many distinct rows a policy decides row by row with its scalar
# rule: a device call's fixed cost (launches, copies, a sync) exceeds the
# fused kernels' win.  The reference's threshold, kept so the two packages
# take the same paths.
BATCH_KERNEL_MIN_ROWS = 8

# Above this many devices the plain queue selection pre-prunes with a
# partial selection (O(D) per row) instead of a full O(D log D) stable
# argsort — only the first n_scan + 1 queue entries are ever reachable.
# The device selection (:func:`select_queue`) always sorts stably.
TOPK_PRUNE_MIN_DEVICES = 256

# THE declarative FleetSnapshot leaf schema — the single source of truth the
# dataclass declaration, every construction site, the numpy converter
# (:mod:`repro_torch.core.convert`) and the ``snapshot-schema`` lint rule are
# all checked against.  To add a leaf, extend this tuple AND the dataclass
# together, then let ``python -m repro.analysis`` point at every
# construction site that needs the new keyword.
#
# The dense ``link_bw`` matrix is not a leaf: the bottleneck rule
# bw_eff[s, d] = min(up[s], down[d], backhaul[tier[s], tier[d]]) is carried
# as its O(D) + O(T^2) factors (``up_bw``, ``down_bw``, ``backhaul`` + the
# existing ``tiers``), so a snapshot never holds O(D^2) state and
# 100k-device fleets fit.  Sender rows are derived lazily
# (:meth:`FleetSnapshot.link_row`).
FLEET_SNAPSHOT_SCHEMA: Tuple[str, ...] = (
    "t",
    "classes",
    "lams",
    "bandwidths",
    "tiers",
    "up_bw",
    "down_bw",
    "backhaul",
    "mem_total",
    "join_times",
    "alive",
    "surv_grid",
    "survival",
    "counts",
    "queue_len",
    "base",
    "slope",
)




@dataclass(frozen=True)
class FleetSnapshot:
    """Struct-of-arrays view of the whole fleet at one planning instant.

    Everything is indexed by device id (length ``D``); ``counts`` is the
    Task_info matrix at time ``t`` (the paper's "number of running tasks on
    each device at a certain time", §IV-A) and ``queue_len`` its row sum.
    ``base``/``slope`` carry the profiled ED_mc interference table so a
    snapshot is self-contained for Eq. (1) evaluation.  Snapshots are frozen
    and keep numpy leaves on the host; a policy's ``decide_batch`` moves
    only the pool tensors it decides over to its device.
    """

    t: float                 # absolute time of the snapshot
    classes: np.ndarray      # (D,) device-class ids
    lams: np.ndarray         # (D,) failure rates (Table IV)
    bandwidths: np.ndarray   # (D,) DEPRECATED scalar bandwidths (see link_row)
    tiers: np.ndarray        # (D,) fleet tier ids (device/edge_server/cloud)
    # Factorized bottleneck link model: bw_eff[s, d] = min(up_bw[s],
    # down_bw[d], backhaul[tiers[s], tiers[d]]), +inf on the diagonal.  The
    # dense (D, D) matrix is never a leaf — derive rows with ``link_row``.
    up_bw: np.ndarray        # (D,) sender uplink rates in bytes/s
    down_bw: np.ndarray      # (D,) receiver downlink rates in bytes/s
    backhaul: np.ndarray     # (T, T) inter-tier backhaul rates (inf = free)
    mem_total: np.ndarray    # (D,) H(ED) in bytes (memory-feasibility data)
    join_times: np.ndarray   # (D,) device join times
    alive: np.ndarray        # (D,) bool: not yet departed at t (churn mask)
    # Availability forecast sampled at t: survival[d, k] = P(device d stays
    # up throughout [t, t + surv_grid[k]]) — exact for scripted maintenance
    # windows, MLE-extrapolated for stochastic churn.  With no forecast
    # installed the leaves are the uniform (K=1) all-ones tensor.
    surv_grid: np.ndarray    # (K,) span offsets of the forecast grid
    survival: np.ndarray     # (D, K) survival probabilities over the grid
    counts: np.ndarray       # (D, N) Task_info at t
    queue_len: np.ndarray    # (D,) total running tasks per device
    base: np.ndarray         # (P, N) ED_mc base latencies c[p, i]
    slope: np.ndarray        # (P, N, N) ED_mc interference slopes m[p, i, j]

    @property
    def n_devices(self) -> int:
        return int(self.classes.shape[0])

    @property
    def n_types(self) -> int:
        return int(self.counts.shape[1])

    def link_row(self, s: int) -> np.ndarray:
        """(D,) sender row ``bw_eff[s, :]`` of the effective link matrix,
        derived from the O(D) factors: ``min(up_bw[s], down_bw[d],
        backhaul[tiers[s], tiers[d]])`` with ``+inf`` at ``d == s`` (a
        co-located transfer crosses no network hop).  Bit-identical to
        slicing the dense matrix the pre-factorization snapshots carried."""
        s = int(s)
        row = np.minimum(self.up_bw[s], self.down_bw)
        row = np.minimum(row, self.backhaul[self.tiers[s], self.tiers])
        row[s] = np.inf
        return row

    @cached_property
    def link_bw(self) -> np.ndarray:
        """(D, D) dense ``bw_eff`` matrix, materialized ON DEMAND from the
        factor leaves (and cached on the instance).  Debug / small-fleet
        convenience only: it is O(D^2) memory, is NOT a leaf, and hot
        paths must slice :meth:`link_row` instead."""
        link = np.minimum(self.up_bw[:, None], self.down_bw[None, :])
        link = np.minimum(
            link, self.backhaul[self.tiers[:, None], self.tiers[None, :]]
        )
        np.fill_diagonal(link, np.inf)
        return link

    def validate(self) -> "FleetSnapshot":
        """Runtime twin of the ``snapshot-schema`` lint rule: assert this
        snapshot's leaf count and order match
        :data:`FLEET_SNAPSHOT_SCHEMA` exactly.

        Field order IS leaf order (the converter and every consumer
        iterate ``fields()``), so checking the field tuple checks what
        every reader of the snapshot will see.  Called once per
        ``ClusterState.snapshot()`` under ``__debug__`` (``python -O``
        strips it from hot production runs).  Returns ``self`` so call
        sites can chain."""
        names = tuple(f.name for f in fields(self))
        if names != FLEET_SNAPSHOT_SCHEMA:
            raise TypeError(
                f"FleetSnapshot leaf drift: instance flattens to "
                f"{list(names)} but FLEET_SNAPSHOT_SCHEMA declares "
                f"{list(FLEET_SNAPSHOT_SCHEMA)}; update the schema, the "
                "dataclass, and every construction site together"
            )
        return self


@dataclass(frozen=True)
class BatchedPolicyContext:
    """Everything a policy may inspect to place B tasks at once.

    Row ``b`` is one task.  Rows of one batch were built against the same
    cluster state — a stage of one application, or a whole arrival wave —
    so a batched decision is defined to equal deciding the rows one by one
    in order (stateful policies consume their rng/cursor once per row; see
    ``Policy.decide_batch``).

    Storage is a deduplicated struct-of-arrays: a burst of ~1000 instances
    of a few application types produces waves whose rows are largely
    IDENTICAL (same task type, model, parents, bucketed start time), so the
    ``*_pool`` tensors hold only the G << B distinct context rows and
    ``row_pool`` maps each row to its pool entry.  The pool key covers
    everything a context row is a function of, so ``pool_row == row`` holds
    exactly — stateless policies may decide once per pool entry and fan the
    decision out (bit-identical memoisation of a pure function), while the
    classic ``(B, D)`` views (``exec_lat``, ``total``, ``pf``, ...)
    materialise lazily for stateful policies and the scalar ``row(b)``
    bridge.  ``fleet`` carries the shared static device vectors.
    """

    tasks: Tuple[str, ...]       # (B,) task names (error reporting)
    ttypes: np.ndarray           # (B,) task-type indices
    t_start: np.ndarray          # (B,) absolute estimated starts
    stage_offset: np.ndarray     # (B,) offsets from each app's arrival
    row_pool: np.ndarray         # (B,) row -> distinct-context pool entry
    pool_first: np.ndarray       # (G,) pool entry -> its first row
    exec_pool: np.ndarray        # (G, D) Eq. (1) execution latency
    upload_pool: np.ndarray      # (G, D) L(M(T_i)) model-upload latency
    transfer_pool: np.ndarray    # (G, D) L(T_i)_d input-transfer latency
    total_pool: np.ndarray       # (G, D) Eq. (2): exec + upload + transfer
    feasible_pool: np.ndarray    # (G, D) bool memory-feasibility mask
    pf_pool: np.ndarray          # (G, D) F(T_i) per device
    # Per-candidate forecast survival over each row's estimated execution
    # span: S_d(t_start, t_start + total[g, d]), evaluated EXACTLY from the
    # installed forecast (all-ones when none is installed, so policies fall
    # back bit-identically to the memoryless pf column).
    survival_pool: np.ndarray    # (G, D)
    # Task_info snapshots are pooled separately by T_alloc bucket.
    counts_pool: np.ndarray      # (Gc, D, N) distinct Task_info snapshots
    queue_pool: np.ndarray       # (Gc, D) their queue lengths
    bucket_inv: np.ndarray       # (B,) row -> counts/queue pool index
    # Shared fleet vectors.  NOTE: the snapshot is taken at the wave-stage's
    # FIRST row's start time — its static vectors (classes, lams, ...) hold
    # for every row, but in a multi-time wave its dynamic `counts`/
    # `queue_len` describe only that reference instant; per-row dynamic
    # state lives in `counts_pool`/`queue_pool`/`bucket_inv` (or the lazy
    # `counts`/`queue_len` views).
    fleet: FleetSnapshot

    # -- lazily materialised (B, D[, N]) views -------------------------------
    def _expand(self, pool: np.ndarray, inv: np.ndarray) -> np.ndarray:
        """Per-row view of a pool: broadcast when the pool is one entry,
        gather by ``inv`` otherwise."""
        if pool.shape[0] == 1:
            return np.broadcast_to(
                pool[0], (len(self.tasks),) + pool.shape[1:]
            )
        return pool[inv]

    @cached_property
    def exec_lat(self) -> np.ndarray:
        return self._expand(self.exec_pool, self.row_pool)

    @cached_property
    def upload(self) -> np.ndarray:
        return self._expand(self.upload_pool, self.row_pool)

    @cached_property
    def transfer(self) -> np.ndarray:
        return self._expand(self.transfer_pool, self.row_pool)

    @cached_property
    def total(self) -> np.ndarray:
        return self._expand(self.total_pool, self.row_pool)

    @cached_property
    def feasible(self) -> np.ndarray:
        return self._expand(self.feasible_pool, self.row_pool)

    @cached_property
    def pf(self) -> np.ndarray:
        return self._expand(self.pf_pool, self.row_pool)

    @cached_property
    def survival(self) -> np.ndarray:
        """(B, D) per-candidate forecast survival over each row's span."""
        return self._expand(self.survival_pool, self.row_pool)

    @cached_property
    def counts(self) -> np.ndarray:
        """(B, D, N) Task_info at each row's t_start (lazy; see pools)."""
        return self._expand(self.counts_pool, self.bucket_inv)

    @cached_property
    def queue_len(self) -> np.ndarray:
        """(B, D) LAVEA's SQLF signal per row (lazy; see pools)."""
        return self._expand(self.queue_pool, self.bucket_inv)

    @property
    def n_rows(self) -> int:
        return len(self.tasks)

    @property
    def n_devices(self) -> int:
        return int(self.exec_pool.shape[1])

    @property
    def n_distinct(self) -> int:
        """Number of distinct context rows (pool entries)."""
        return int(self.exec_pool.shape[0])

    # shared static fleet vectors, delegated for policy convenience ----------
    @property
    def classes(self) -> np.ndarray:
        return self.fleet.classes

    @property
    def lams(self) -> np.ndarray:
        return self.fleet.lams

    @property
    def join_times(self) -> np.ndarray:
        return self.fleet.join_times

    @property
    def bandwidths(self) -> np.ndarray:
        return self.fleet.bandwidths

    @property
    def tiers(self) -> np.ndarray:
        return self.fleet.tiers

    def link_row(self, s: int) -> np.ndarray:
        """(D,) sender row of the effective link matrix (factorized)."""
        return self.fleet.link_row(s)

    @property
    def link_bw(self) -> np.ndarray:
        """(D, D) dense bw_eff matrix, materialized on demand from the
        snapshot's factor leaves — debug/small-fleet only (O(D^2))."""
        return self.fleet.link_bw

    @property
    def mem_total(self) -> np.ndarray:
        return self.fleet.mem_total

    @property
    def alive(self) -> np.ndarray:
        """(D,) bool: devices not yet departed when the wave was planned.
        Already ANDed into ``feasible``; exposed for custom policies that
        build their own masks."""
        return self.fleet.alive

    def feasible_ids(self, b: int) -> np.ndarray:
        return np.flatnonzero(self.feasible_pool[self.row_pool[b]])

    def estimates_at(
        self, b: int, did: int
    ) -> Tuple[float, float, float, float]:
        """(exec, upload, transfer, pf) of device ``did`` for row ``b``."""
        g = self.row_pool[b]
        return (
            float(self.exec_pool[g, did]),
            float(self.upload_pool[g, did]),
            float(self.transfer_pool[g, did]),
            float(self.pf_pool[g, did]),
        )

    def primary_estimates(
        self, dids: np.ndarray
    ) -> Tuple[list, list, list, list]:
        """Bulk (exec, upload, transfer, pf) lists at one device per row
        (the chosen primaries) — four fused gathers instead of 4B scalar
        reads."""
        g = self.row_pool
        return (
            self.exec_pool[g, dids].tolist(),
            self.upload_pool[g, dids].tolist(),
            self.transfer_pool[g, dids].tolist(),
            self.pf_pool[g, dids].tolist(),
        )

    def row(self, b: int):
        """The exact scalar :class:`PolicyContext` of row ``b`` — the bridge
        between the batched and scalar APIs (used by the default
        ``decide_batch`` fallback and the parity tests)."""
        from .policy import PolicyContext  # deferred: policy imports us

        g = self.row_pool[b]
        gc = self.bucket_inv[b]
        feasible = self.feasible_pool[g]
        return PolicyContext(
            task=self.tasks[b],
            ttype=int(self.ttypes[b]),
            t_start=float(self.t_start[b]),
            stage_offset=float(self.stage_offset[b]),
            exec_lat=self.exec_pool[g],
            upload=self.upload_pool[g],
            transfer=self.transfer_pool[g],
            total=self.total_pool[g],
            feasible=feasible,
            feasible_ids=np.flatnonzero(feasible),
            pf=self.pf_pool[g],
            lams=self.fleet.lams,
            join_times=self.fleet.join_times,
            queue_len=self.queue_pool[gc],
            counts=self.counts_pool[gc],
            classes=self.fleet.classes,
            tiers=self.fleet.tiers,
            alive=self.fleet.alive,
            survival=self.survival_pool[g],
        )


@dataclass(frozen=True)
class BatchedDecision:
    """A policy's verdict for a whole batch: row-aligned device tuples,
    primary first; an empty tuple marks the row's task unplaceable."""

    devices: Tuple[Tuple[int, ...], ...]

    @property
    def n_rows(self) -> int:
        return len(self.devices)

    def __iter__(self):
        return iter(self.devices)

    def __getitem__(self, b: int) -> Tuple[int, ...]:
        return self.devices[b]


# -- device plumbing ------------------------------------------------------------
DeviceLike = Union[str, torch.device]


def _padded(B: int) -> int:
    """Pad the row count to a bounded set of shapes, so a burst's shrinking
    wave sizes give the kernels a bounded set of tensor shapes (the caching
    allocator reuses their blocks): powers of two up to 1024, then
    multiples of 1024."""
    if B <= 1024:
        return 1 << max(B - 1, 0).bit_length()
    return -(-B // 1024) * 1024


def _on(arr: np.ndarray, device: DeviceLike, dtype: torch.dtype,
        n_rows: int, fill) -> torch.Tensor:
    """``arr`` on ``device`` as ``dtype``: one host-to-device copy of its
    rows into a tensor of ``n_rows`` rows, the rows past ``arr``'s filled
    with ``fill`` (the reference's pad values, inert in every kernel)."""
    host = torch.from_numpy(np.ascontiguousarray(arr))
    if n_rows == host.shape[0]:
        return host.to(device=device, dtype=dtype)
    out = torch.empty((n_rows,) + tuple(host.shape[1:]), dtype=dtype,
                      device=device)
    out[: host.shape[0]].copy_(host)
    out[host.shape[0]:] = fill
    return out


# -- decision kernels (torch tensors in, torch tensors out) ----------------------
def select_queue(masked: torch.Tensor, k: int) -> torch.Tensor:
    """Algorithm 1 lines 16-18 for all rows: the first ``k`` entries of each
    row's priority queue, the row-wise STABLE ascending argsort of
    ``masked`` (infeasible devices at +inf).  Equal keys keep ascending
    device ids, exactly as numpy's stable sort orders them; ``torch.topk``
    breaks ties otherwise, so a full stable sort it is.  ``(B, D)`` float64
    -> ``(B, k)`` int64."""
    select_queue.launches += 1
    return torch.sort(masked, dim=1, stable=True).indices[:, :k]


def ibdash_scan_kernel(
    s_total: torch.Tensor, s_pf: torch.Tensor, n_feas: torch.Tensor,
    alpha: float, beta: float, gamma: int,
) -> torch.Tensor:
    """Algorithm 1's score-and-replicate loop (lines 29-41) for all rows at
    once, carrying one ``active`` lane per row — a lane goes (and stays)
    inactive exactly when the scalar ``while`` would have exited or hit
    its ``break``.

    Inputs are the first ``K = n_scan + 1`` columns of each task's priority
    queue, sorted ascending by total latency (``(B, K)`` float64), and the
    feasible count ``n_feas`` (``(B,)`` int64).  Every scalar iteration
    either accepts a replica (at most ``gamma`` times) or breaks, so
    ``n_scan = min(gamma + 1, D - 1)`` steps cover every reachable state;
    the loop runs all of them (no early exit, which would sync the host
    every step).  Each line is one IEEE operation in float64, in the
    reference's order; ``1 - alpha`` is a Python double, as in numpy.
    Returns ``(B, n_scan)`` bool: row ``b`` replicates onto queue entry
    ``j + 1`` where ``accepts[b, j]``."""
    ibdash_scan_kernel.launches += 1
    alpha, beta, gamma = float(alpha), float(beta), int(gamma)
    one_minus_alpha = 1 - alpha
    n_rows, n_scan = s_total.shape[0], s_total.shape[1] - 1
    best = s_total[:, 0]
    l_ref = torch.clamp(best, min=1e-9)
    comb = s_pf[:, 0]
    w_s = alpha * (best / l_ref) + one_minus_alpha * comb     # line 29
    active = torch.ones(n_rows, dtype=torch.bool, device=s_total.device)
    t_rep = torch.zeros(n_rows, dtype=torch.int64, device=s_total.device)
    accepts = torch.zeros((n_rows, n_scan), dtype=torch.bool,
                          device=s_total.device)
    for qi in range(1, n_scan + 1):
        cond = active & (comb >= beta) & (t_rep < gamma) & (n_feas > qi)  # line 30
        new_fail = comb * s_pf[:, qi]
        w_new = alpha * (s_total[:, qi] / l_ref) + one_minus_alpha * new_fail
        accept = cond & (w_new <= w_s)                           # line 34
        comb = torch.where(accept, new_fail, comb)
        w_s = torch.where(accept, w_new, w_s)
        t_rep = t_rep + accept.to(torch.int64)                   # line 37
        accepts[:, qi - 1] = accept
        # rejection => break (line 39); cond failure => loop exit
        active = accept
    return accepts


def lavea_kernel(queue_len: torch.Tensor, feasible: torch.Tensor) -> torch.Tensor:
    """Shortest Queue Length First: masked argmin per row, the first
    minimum on ties (as ``np.argmin``).  ``(B, D)`` float64 and bool ->
    ``(B,)`` int64."""
    lavea_kernel.launches += 1
    return torch.argmin(torch.where(feasible, queue_len, np.inf), dim=1)


def round_robin_kernel(feasible: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Select each row's ``targets[b]``-th feasible device.  ``(B, D)``
    bool and ``(B,)`` int64 -> ``(B,)`` int64 (0 where no device
    matches, as ``np.argmax``).  ``argmax`` takes no bool tensor on the
    card, so the match mask is cast to uint8 first."""
    round_robin_kernel.launches += 1
    pos = torch.cumsum(feasible, dim=1) - 1
    match = feasible & (pos == targets[:, None])
    return torch.argmax(match.to(torch.uint8), dim=1)


def tier_escalation_kernel(
    total: torch.Tensor, feasible: torch.Tensor, tiers: torch.Tensor,
    budget: float, n_tiers: int,
) -> torch.Tensor:
    """Tier escalation for all rows: per level L (device -> edge -> cloud)
    take the masked argmin over feasible devices at tiers <= L, accept the
    first level whose best candidate meets the latency budget, fall back to
    the global feasible argmin.  ``(B, D)`` float64 and bool, ``(D,)``
    int64 -> ``(B,)`` int64."""
    tier_escalation_kernel.launches += 1
    rows = torch.arange(total.shape[0], device=total.device)
    picked = torch.zeros(total.shape[0], dtype=torch.int64, device=total.device)
    chosen = torch.zeros(total.shape[0], dtype=torch.bool, device=total.device)
    for lv in range(n_tiers):
        masked = torch.where(feasible & (tiers[None, :] <= lv), total, np.inf)
        best = torch.argmin(masked, dim=1)
        best_val = masked[rows, best]
        take = ~chosen & torch.isfinite(best_val) & (best_val <= budget)
        picked = torch.where(take, best, picked)
        chosen = chosen | take
    gbest = torch.argmin(torch.where(feasible, total, np.inf), dim=1)
    return torch.where(chosen, picked, gbest)


DECISION_KERNELS = (
    select_queue, ibdash_scan_kernel, lavea_kernel, round_robin_kernel,
    tier_escalation_kernel,
)
for _kernel in DECISION_KERNELS:
    _kernel.launches = 0      # calls of each kernel, read by the smoke run
del _kernel


# -- plain numpy versions (the reference's numpy twins) ---------------------------
def _topk_stable(masked: np.ndarray, k: int) -> np.ndarray:
    """First ``k`` columns of the row-wise stable ascending argsort of
    ``masked``, without sorting all D columns.

    ``np.partition`` finds each row's k-th smallest value (the selection
    boundary) in O(D); everything strictly below the boundary survives, and
    boundary ties are resolved to the LOWEST device ids — exactly the
    entries a stable full sort would keep — so the result is bit-identical
    to ``np.argsort(masked, kind="stable")[:, :k]`` including tie-breaks.
    Only the <= k survivors are then sorted: O(D + k log k) per row."""
    B = masked.shape[0]
    boundary = np.partition(masked, k - 1, axis=1)[:, k - 1]
    out = np.empty((B, k), np.int64)
    for b in range(B):
        below = np.flatnonzero(masked[b] < boundary[b])
        ties = np.flatnonzero(masked[b] == boundary[b])[: k - below.size]
        cand = np.concatenate([below, ties])
        out[b] = cand[np.argsort(masked[b, cand], kind="stable")]
    return out


def select_queue_plain(masked: np.ndarray, k: int) -> np.ndarray:
    """Plain version of :func:`select_queue`: the reference's selection, a
    partial selection on big fleets and a full stable argsort otherwise."""
    D = masked.shape[1]
    if D > TOPK_PRUNE_MIN_DEVICES and k < D:
        return _topk_stable(masked, k)
    return np.argsort(masked, axis=1, kind="stable")[:, :k]


def ibdash_scan_plain(s_total, s_pf, n_feas, alpha, beta, gamma):
    """Plain version of :func:`ibdash_scan_kernel` (vectorised numpy)."""
    B = s_total.shape[0]
    n_scan = s_total.shape[1] - 1
    best = s_total[:, 0]
    l_ref = np.maximum(best, 1e-9)
    comb = s_pf[:, 0].copy()
    w_s = alpha * (best / l_ref) + (1 - alpha) * comb
    active = np.ones(B, bool)
    t_rep = np.zeros(B, np.int64)
    accepts = np.zeros((B, n_scan), bool)
    for qi in range(1, n_scan + 1):
        cond = active & (comb >= beta) & (t_rep < gamma) & (qi < n_feas)
        if not cond.any():
            break
        new_fail = comb * s_pf[:, qi]
        w_new = alpha * (s_total[:, qi] / l_ref) + (1 - alpha) * new_fail
        accept = cond & (w_new <= w_s)
        comb = np.where(accept, new_fail, comb)
        w_s = np.where(accept, w_new, w_s)
        t_rep = t_rep + accept
        accepts[:, qi - 1] = accept
        active = accept
    return accepts


def lavea_plain(queue_len: np.ndarray, feasible: np.ndarray) -> np.ndarray:
    """Plain version of :func:`lavea_kernel`."""
    return np.argmin(np.where(feasible, queue_len, np.inf), axis=1)


def round_robin_plain(feasible: np.ndarray, targets: np.ndarray) -> np.ndarray:
    """Plain version of :func:`round_robin_kernel`."""
    pos = np.cumsum(feasible, axis=1) - 1
    match = feasible & (pos == targets[:, None])
    return np.argmax(match, axis=1)


def tier_escalation_plain(total, feasible, tiers, budget, n_tiers) -> np.ndarray:
    """Plain version of :func:`tier_escalation_kernel`."""
    B = total.shape[0]
    rows = np.arange(B)
    picked = np.zeros(B, np.int64)
    chosen = np.zeros(B, bool)
    for lv in range(n_tiers):
        masked = np.where(feasible & (tiers[None, :] <= lv), total, np.inf)
        best = np.argmin(masked, axis=1)
        best_val = masked[rows, best]
        take = ~chosen & np.isfinite(best_val) & (best_val <= budget)
        picked = np.where(take, best, picked)
        chosen |= take
    gbest = np.argmin(np.where(feasible, total, np.inf), axis=1)
    return np.where(chosen, picked, gbest)


# -- fused decisions (numpy pools in, device tuples out) --------------------------
def ibdash_decide_batch(
    total: np.ndarray,
    pf: np.ndarray,
    feasible: np.ndarray,
    alpha: float,
    beta: float,
    gamma: int,
    device: DeviceLike,
) -> List[Tuple[int, ...]]:
    """One fused call of the IBDASH score-and-replicate rule for B tasks on
    ``device``: the priority queue by :func:`select_queue`, its first
    ``n_scan + 1`` entries gathered, then :func:`ibdash_scan_kernel`.

    Bit-identical to looping the scalar rule: float64 arithmetic, stable
    sorts, and the same IEEE expressions per step.
    """
    B, D = total.shape
    n_scan = min(int(gamma) + 1, D - 1)  # a scalar iteration accepts or breaks
    # rows padded before the selection too, so both kernels see a bounded
    # set of shapes; a pad row has no feasible device, which makes it inert
    # in the selection and in the scan
    n_pad = _padded(B)
    d_total = _on(total, device, torch.float64, n_pad, 1.0)
    d_pf = _on(pf, device, torch.float64, n_pad, 0.0)
    d_feas = _on(feasible, device, torch.bool, n_pad, False)
    n_feas = d_feas.sum(dim=1)
    # lines 16-18: the priority queue == stable ascending sort over L(T_i)
    # with infeasible devices pushed to +inf; only its first n_scan + 1
    # entries are reachable.
    order = select_queue(torch.where(d_feas, d_total, np.inf), n_scan + 1)
    accepts = ibdash_scan_kernel(
        torch.gather(d_total, 1, order), torch.gather(d_pf, 1, order), n_feas,
        alpha, beta, gamma,
    )
    order, accepts, n_feas = (t[:B].cpu().numpy() for t in (order, accepts, n_feas))
    n_extra = accepts.sum(axis=1)
    out: List[Tuple[int, ...]] = []
    for b in range(B):
        if n_feas[b] == 0:
            out.append(())
        elif n_extra[b] == 0:                       # the common, no-replica row
            out.append((int(order[b, 0]),))
        else:
            extras = order[b, np.flatnonzero(accepts[b]) + 1]
            out.append((int(order[b, 0]), *(int(d) for d in extras)))
    return out


def lavea_decide_batch(
    queue_len: np.ndarray, feasible: np.ndarray, device: DeviceLike,
) -> List[Tuple[int, ...]]:
    """Fused SQLF for B tasks on ``device``: masked argmin (first minimum,
    like the scalar ``ids[argmin(queue[ids])]``)."""
    B = queue_len.shape[0]
    n_feas = feasible.sum(axis=1)
    n_pad = _padded(B)
    picked = lavea_kernel(
        _on(queue_len, device, torch.float64, n_pad, 0.0),
        _on(feasible, device, torch.bool, n_pad, True),
    )[:B].cpu().numpy()
    return [(int(picked[b]),) if n_feas[b] > 0 else () for b in range(B)]


def tier_escalation_decide_batch(
    total: np.ndarray,
    feasible: np.ndarray,
    tiers: np.ndarray,
    budget: float,
    device: DeviceLike,
) -> List[Tuple[int, ...]]:
    """Fused tier-escalation rule for B tasks on ``device``.

    For each row, widen the candidate set one tier level at a time (devices
    first, then edge servers, then cloud) and place on the min-``total``
    candidate of the first level whose best option meets ``budget``; if even
    the whole fleet misses the budget, place on the global feasible best.
    Bit-identical to looping the scalar rule (same float64 masked argmins,
    first-minimum tie-break)."""
    B = total.shape[0]
    n_feas = feasible.sum(axis=1)
    n_tiers = int(tiers.max()) + 1 if tiers.size else 1
    n_pad = _padded(B)
    picked = tier_escalation_kernel(
        _on(total, device, torch.float64, n_pad, 1.0),
        _on(feasible, device, torch.bool, n_pad, False),
        torch.from_numpy(np.asarray(tiers, np.int64)).to(device),
        float(budget),
        n_tiers,
    )[:B].cpu().numpy()
    return [(int(picked[b]),) if n_feas[b] > 0 else () for b in range(B)]


def round_robin_decide_batch(
    feasible: np.ndarray, cursor: int, device: DeviceLike,
) -> Tuple[List[Tuple[int, ...]], int]:
    """Fused cyclic assignment on ``device``.  Batch semantics: rows are
    served in order and the cursor advances once per row with a non-empty
    feasible set — exactly what looping the scalar rule does.  Returns
    (decisions, new cursor)."""
    B = feasible.shape[0]
    sizes = feasible.sum(axis=1)
    nonempty = sizes > 0
    before = np.cumsum(nonempty) - nonempty          # non-empty rows before b
    targets = np.where(nonempty, (cursor + before) % np.maximum(sizes, 1), 0)
    n_pad = _padded(B)
    picked = round_robin_kernel(
        _on(feasible, device, torch.bool, n_pad, True),
        _on(targets, device, torch.int64, n_pad, 0),
    )[:B].cpu().numpy()
    decisions = [
        (int(picked[b]),) if nonempty[b] else () for b in range(B)
    ]
    return decisions, cursor + int(nonempty.sum())
