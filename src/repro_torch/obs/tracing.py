"""Structured spans & traces for the orchestration pipeline.

Every application instance the engine takes accounting responsibility for
gets one *trace*: an ``instance`` span from admission to its terminal
outcome (``completed`` / ``lost`` / ``shed``), plus structured child spans
for each pipeline stage it passes through — the admission queue, the
planning decision, per-replica model upload / parent transfer / execution,
recovery waits, failover / replan / salvage actions.  Fleet-level events
(device churn) hang off the reserved :data:`FLEET_TID` trace.

Design constraints (the lint rules stay green):

  * **sim-clock only** — every timestamp is an engine ``now`` value; the
    tracer never reads a wall clock, so traces are deterministic and
    replayable (same seed, same trace, byte for byte).
  * **zero overhead when disabled** — emitters hold ``trace=None`` by
    default and guard every call site with ``if self.trace is not None``;
    the tracer itself is only ever constructed by opting in
    (``Orchestrator(trace=...)`` / ``SimConfig(trace=True)``).
  * **predicted next to realized** — ``exec`` spans carry the planner's
    Eq. (2) terms (``pred_exec`` / ``pred_upload`` / ``pred_transfer``)
    and per-replica ``pred_fail`` from the very
    :class:`~repro_torch.core.orchestrator.Replica` the policy produced, so
    :mod:`repro_torch.obs.attribution` can score calibration without joining
    back to planner state.
  * **literal span kinds** — call sites pass the ``kind`` as a string
    literal drawn from :data:`SPAN_SCHEMA`; the ``span-parity`` lint rule
    statically cross-checks every emitted kind against the schema and the
    test suite, and :meth:`Tracer._span` rejects unknown kinds at runtime.

See ``src/repro/obs/README.md`` for the full span schema with a worked
trace example.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Tuple

__all__ = ["Span", "Tracer", "SPAN_SCHEMA", "FLEET_TID"]

# Fleet-scoped events (device churn) do not belong to any one instance;
# they are recorded against this reserved trace id.
FLEET_TID = -1

# kind -> one-line contract.  The span-parity lint rule requires every kind
# emitted in src/repro to appear here AND to be named in the test suite;
# the tracer enforces membership at runtime.  Extend this table (and
# obs/README.md) when adding a kind.
SPAN_SCHEMA: Dict[str, str] = {
    "instance": "whole-instance envelope: admission to terminal outcome "
                "(attrs: outcome=completed|lost|shed)",
    "admission_queue": "true arrival to dispatch wave (stream layer; "
                       "attrs: slo, degraded, deadline)",
    "plan": "placement decision instant (attrs: policy, pred_latency, "
            "pred_fail, feasible)",
    "model_upload": "predicted model-artifact upload window at the head "
                    "of a replica's execution (attrs: device, task)",
    "parent_transfer": "predicted parent-output transfer window after "
                       "upload (attrs: device, task)",
    "exec": "one replica occupying one device, open at launch / closed at "
            "end or kill (attrs: device, tier, task, ttype, stage, "
            "sched_end, pred_* terms, real_exec, outcome)",
    "recovery_wait": "death detected -> recovery fires (detection delay)",
    "failover": "hot-spare restart attempt instant (attrs: task, ok)",
    "replan": "policy replan attempt instant (attrs: task, ok)",
    "salvage": "partial-result resubmission instant (attrs: ok, pinned)",
    "shed": "admission-control drop instant (attrs: reason)",
    "device_down": "fleet event: device departs (attrs: device)",
    "device_up": "fleet event: device rejoins (attrs: device, until)",
}

_OPEN = float("nan")


@dataclass
class Span:
    """One timestamped interval (or instant, ``t0 == t1``) in a trace."""

    kind: str
    tid: int                    # owning trace (instance) id; FLEET_TID = fleet
    t0: float
    t1: float                   # NaN while the span is still open
    name: str = ""
    attrs: Dict[str, Any] = field(default_factory=dict)

    @property
    def closed(self) -> bool:
        return self.t1 == self.t1          # not NaN

    @property
    def dur(self) -> float:
        return self.t1 - self.t0


class Tracer:
    """Append-only span collector with sequential instance ids.

    Emission API (what :class:`~repro_torch.sim.engine.Engine`, the stream
    service and the recovery strategies call):

      * ``tid = begin_instance(name, t, **attrs)`` — open a trace
      * ``end_instance(tid, t, outcome, **attrs)`` — close it
      * ``add_span(tid, kind, t0, t1, **attrs)`` — completed interval
      * ``sid = open_span(tid, kind, t0, **attrs)`` / ``close_span(sid,
        t1, **attrs)`` — interval whose end is not yet known
      * ``event(tid, kind, t, **attrs)`` — instant

    Query API (what attribution / export read): :meth:`instances`,
    :meth:`instance`, :meth:`spans_of`, :meth:`outcome_counts`.
    """

    __slots__ = ("spans", "_next_tid", "_inst_sid")

    def __init__(self) -> None:
        self.spans: List[Span] = []
        self._next_tid = 0
        self._inst_sid: Dict[int, int] = {}     # tid -> instance span index

    # -- emission ---------------------------------------------------------------
    def _span(self, kind: str, tid: int, t0: float, t1: float,
              name: str, attrs: Dict[str, Any]) -> int:
        if kind not in SPAN_SCHEMA:
            raise ValueError(
                f"unknown span kind {kind!r}; add it to SPAN_SCHEMA "
                f"(and obs/README.md) first"
            )
        self.spans.append(Span(kind, tid, float(t0), float(t1), name, attrs))
        return len(self.spans) - 1

    def begin_instance(self, name: str, t: float, **attrs) -> int:
        tid = self._next_tid
        self._next_tid += 1
        self._inst_sid[tid] = self._span("instance", tid, t, _OPEN, name, attrs)
        return tid

    def end_instance(self, tid: int, t: float, outcome: str, **attrs) -> None:
        span = self.spans[self._inst_sid[tid]]
        if span.closed:
            raise RuntimeError(f"instance trace {tid} ended twice")
        span.t1 = float(t)
        span.attrs["outcome"] = outcome
        span.attrs.update(attrs)

    def add_span(self, tid: int, kind: str, t0: float, t1: float,
                 name: str = "", **attrs) -> int:
        return self._span(kind, tid, t0, t1, name, attrs)

    def open_span(self, tid: int, kind: str, t0: float,
                  name: str = "", **attrs) -> int:
        return self._span(kind, tid, t0, _OPEN, name, attrs)

    def close_span(self, sid: int, t1: float, **attrs) -> None:
        span = self.spans[sid]
        if span.closed:
            raise RuntimeError(f"span {sid} ({span.kind}) closed twice")
        span.t1 = float(t1)
        span.attrs.update(attrs)

    def event(self, tid: int, kind: str, t: float,
              name: str = "", **attrs) -> int:
        return self._span(kind, tid, t, t, name, attrs)

    # -- queries ----------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.spans)

    @property
    def n_instances(self) -> int:
        return self._next_tid

    def instance(self, tid: int) -> Span:
        """The ``instance`` envelope span of trace ``tid``."""
        return self.spans[self._inst_sid[tid]]

    def instances(self) -> Iterator[Span]:
        """Every instance envelope, in admission order."""
        for tid in range(self._next_tid):
            yield self.spans[self._inst_sid[tid]]

    def spans_of(self, tid: int) -> List[Span]:
        """All non-envelope spans of one trace, in emission order."""
        return [s for s in self.spans
                if s.tid == tid and s.kind != "instance"]

    def by_kind(self, kind: str) -> List[Span]:
        return [s for s in self.spans if s.kind == kind]

    def outcome_counts(self) -> Dict[str, int]:
        """Terminal outcomes over all instance envelopes — the trace-side
        half of the conservation ledger (open envelopes count as
        ``open``; a drained engine leaves none)."""
        out: Dict[str, int] = {}
        for span in self.instances():
            key = span.attrs.get("outcome", "open") if span.closed else "open"
            out[key] = out.get(key, 0) + 1
        return out

    def check_closed(self) -> None:
        """Raise if any span is still open (drain-time invariant)."""
        dangling: List[Tuple[int, str]] = [
            (i, s.kind) for i, s in enumerate(self.spans) if not s.closed
        ]
        if dangling:
            raise RuntimeError(
                f"{len(dangling)} spans still open after drain: "
                f"{dangling[:5]}"
            )
