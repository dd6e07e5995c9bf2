"""Trace exporters: Chrome/Perfetto ``trace_event`` JSON and a summary.

``to_chrome_trace`` renders a :class:`~repro_torch.obs.tracing.Tracer` as the
Trace Event Format consumed by ``chrome://tracing`` and
https://ui.perfetto.dev — two process rows:

  * **pid 0 "instances"** — one thread per instance trace: the instance
    envelope as a complete ("X") event with its admission-queue /
    recovery-wait child intervals stacked inside, and plan / failover /
    replan / salvage / shed instants ("i").
  * **pid 1 "devices"** — one thread per device: every replica exec
    window as an "X" event (model-upload / parent-transfer sub-windows
    nested at its head), so device occupancy, churn kills and the
    paper's interference crowding are directly visible.  Fleet
    device_down / device_up events land on their device's row.

Flow events ("s"/"t", one id per instance) stitch each instance row to
the device rows its replicas ran on.

Timestamps: sim-clock seconds scaled to microseconds (the format's unit).
The export is lossless for accounting purposes —
:func:`ledger_from_trace` recomputes the engine's conservation identity
``admitted == completed + lost + shed`` from the JSON alone, which the
test suite pins against the live engine counters.
"""
from __future__ import annotations

import json
import math
from typing import Any, Dict, List, Optional, Union

from .metrics import MetricsRegistry
from .tracing import FLEET_TID, Tracer

__all__ = [
    "to_chrome_trace",
    "ledger_from_trace",
    "validate_chrome_trace",
    "json_summary",
]

_US = 1e6                      # sim seconds -> trace microseconds

# span kinds rendered as instants on the instance row
_INSTANT_KINDS = ("plan", "failover", "replan", "salvage", "shed")
# span kinds rendered as intervals on the instance row
_INSTANCE_INTERVALS = ("admission_queue", "recovery_wait")
# span kinds rendered as intervals on the device row
_DEVICE_INTERVALS = ("exec", "model_upload", "parent_transfer")


def _clean(attrs: Dict[str, Any]) -> Dict[str, Any]:
    """JSON-safe args: NaN/inf become strings (strict JSON has neither)."""
    out: Dict[str, Any] = {}
    for k, v in attrs.items():
        if isinstance(v, float) and not math.isfinite(v):
            out[k] = repr(v)
        else:
            out[k] = v
    return out


def to_chrome_trace(
    tracer: Tracer, path: Optional[str] = None
) -> Dict[str, Any]:
    """Render the trace; optionally write it to ``path`` as JSON."""
    ev: List[Dict[str, Any]] = [
        {"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
         "args": {"name": "instances"}},
        {"name": "process_name", "ph": "M", "pid": 1, "tid": 0,
         "args": {"name": "devices"}},
    ]
    named_devices = set()

    def device_thread(did: int) -> None:
        if did not in named_devices:
            named_devices.add(did)
            ev.append({
                "name": "thread_name", "ph": "M", "pid": 1, "tid": did,
                "args": {"name": f"dev{did}"},
            })

    for span in tracer.spans:
        if not span.closed:
            raise ValueError(
                f"open {span.kind!r} span at t0={span.t0}: drain the engine "
                "before exporting"
            )
        args = _clean(span.attrs)
        if span.kind == "instance":
            ev.append({
                "name": span.name or f"instance{span.tid}",
                "cat": "instance", "ph": "X", "pid": 0, "tid": span.tid,
                "ts": span.t0 * _US, "dur": span.dur * _US, "args": args,
            })
            ev.append({
                "name": "thread_name", "ph": "M", "pid": 0, "tid": span.tid,
                "args": {"name": f"#{span.tid} {span.name}"},
            })
            ev.append({
                "name": "lifetime", "cat": "flow", "ph": "s",
                "pid": 0, "tid": span.tid, "ts": span.t0 * _US,
                "id": span.tid,
            })
        elif span.kind in _INSTANCE_INTERVALS:
            ev.append({
                "name": span.kind, "cat": span.kind, "ph": "X",
                "pid": 0, "tid": span.tid,
                "ts": span.t0 * _US, "dur": span.dur * _US, "args": args,
            })
        elif span.kind in _INSTANT_KINDS:
            ev.append({
                "name": span.name or span.kind, "cat": span.kind,
                "ph": "i", "s": "t", "pid": 0, "tid": max(span.tid, 0),
                "ts": span.t0 * _US, "args": args,
            })
        elif span.kind in _DEVICE_INTERVALS:
            did = int(span.attrs.get("device", 0))
            device_thread(did)
            ev.append({
                "name": f"{span.name}:{span.kind}" if span.kind != "exec"
                        else (span.name or "exec"),
                "cat": span.kind, "ph": "X", "pid": 1, "tid": did,
                "ts": span.t0 * _US, "dur": span.dur * _US, "args": args,
            })
            if span.kind == "exec" and span.tid != FLEET_TID:
                ev.append({
                    "name": "lifetime", "cat": "flow", "ph": "t",
                    "pid": 1, "tid": did, "ts": span.t0 * _US,
                    "id": span.tid,
                })
        else:                         # device_down / device_up fleet events
            did = int(span.attrs.get("device", 0))
            device_thread(did)
            ev.append({
                "name": span.kind, "cat": "churn", "ph": "i", "s": "t",
                "pid": 1, "tid": did, "ts": span.t0 * _US, "args": args,
            })
    doc = {"traceEvents": ev, "displayTimeUnit": "ms"}
    if path is not None:
        with open(path, "w") as f:
            json.dump(doc, f)
    return doc


def _events(doc: Union[Dict[str, Any], List[Dict[str, Any]]]
            ) -> List[Dict[str, Any]]:
    return doc["traceEvents"] if isinstance(doc, dict) else doc


def ledger_from_trace(
    doc: Union[Dict[str, Any], List[Dict[str, Any]]]
) -> Dict[str, int]:
    """Recompute the conservation ledger from an exported trace alone:
    every ``cat == "instance"`` complete event is one admitted instance,
    its ``args.outcome`` names its terminal bucket.  The result must
    satisfy ``admitted == completed + lost + shed`` for any trace of a
    drained engine — the round-trip check the test suite pins."""
    out = {"admitted": 0, "completed": 0, "lost": 0, "shed": 0}
    for e in _events(doc):
        if e.get("cat") == "instance" and e.get("ph") == "X":
            out["admitted"] += 1
            outcome = e.get("args", {}).get("outcome")
            if outcome not in ("completed", "lost", "shed"):
                raise ValueError(
                    f"instance event {e.get('name')!r} has no terminal "
                    f"outcome (got {outcome!r})"
                )
            out[outcome] += 1
    return out


def validate_chrome_trace(
    doc: Union[Dict[str, Any], List[Dict[str, Any]]]
) -> int:
    """Structural validation of a trace_event document; returns the event
    count.  Raises ValueError on anything chrome://tracing would choke
    on: missing keys, non-finite or negative timestamps/durations, or a
    document that does not survive strict JSON round-tripping."""
    events = _events(json.loads(json.dumps(doc, allow_nan=False)))
    if not events:
        raise ValueError("empty trace")
    for e in events:
        for key in ("name", "ph", "pid", "tid"):
            if key not in e:
                raise ValueError(f"event missing {key!r}: {e}")
        if e["ph"] == "M":
            continue
        ts = e.get("ts")
        if ts is None or not math.isfinite(ts) or ts < 0:
            raise ValueError(f"bad ts in event: {e}")
        if e["ph"] == "X":
            dur = e.get("dur")
            if dur is None or not math.isfinite(dur) or dur < 0:
                raise ValueError(f"bad dur in complete event: {e}")
    return len(events)


def json_summary(
    tracer: Tracer,
    registry: Optional[MetricsRegistry] = None,
    path: Optional[str] = None,
) -> Dict[str, Any]:
    """Compact JSON export: the trace-side ledger, span counts by kind,
    and (optionally) a full metrics-registry snapshot."""
    by_kind: Dict[str, int] = {}
    for span in tracer.spans:
        by_kind[span.kind] = by_kind.get(span.kind, 0) + 1
    out: Dict[str, Any] = {
        "ledger": tracer.outcome_counts(),
        "n_instances": tracer.n_instances,
        "n_spans": len(tracer.spans),
        "spans_by_kind": dict(sorted(by_kind.items())),
    }
    if registry is not None:
        out["metrics"] = registry.snapshot()
    if path is not None:
        with open(path, "w") as f:
            json.dump(out, f, indent=2)
    return out
