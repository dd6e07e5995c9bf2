"""Predicted-vs-actual cost attribution over traces.

Answers the three questions the aggregate counters cannot:

  * **where did the latency go?** — per-instance critical-path breakdown:
    admission-queue wait, executing time (the union of replica exec
    windows), model-upload / parent-transfer totals, recovery waits, and
    the unattributed stall remainder; per stage, the critical (latest
    finishing) replica decomposed into its Eq. (2) terms.
  * **how wrong was the planner?** — calibration of the Eq. (2) estimates
    the placement was chosen by: per policy, predicted vs realized E2E
    latency and predicted P_f vs the empirical failure rate; per device
    and per tier, predicted vs realized replica duration and predicted
    per-replica failure probability vs the observed death rate.
  * **why was this instance slow / lost?** — ranked reports over the
    worst offenders with their breakdowns and recovery/salvage history.

Everything reads only :class:`~repro_torch.obs.tracing.Tracer` spans — the
attrs each emitter attached are the whole data model, so these reports
work on exported traces as well as live runs.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .tracing import Span, Tracer

__all__ = [
    "instance_breakdown",
    "calibration",
    "slow_instances",
    "lost_instances",
    "attribution_report",
    "format_report",
]


def _union_len(intervals: Sequence[Tuple[float, float]]) -> float:
    """Total length of the union of (t0, t1) intervals."""
    if not intervals:
        return 0.0
    total = 0.0
    lo = hi = None
    for t0, t1 in sorted(intervals):
        if hi is None or t0 > hi:
            if hi is not None:
                total += hi - lo
            lo, hi = t0, t1
        else:
            hi = max(hi, t1)
    total += hi - lo
    return total


def instance_breakdown(tracer: Tracer, tid: int) -> Dict[str, Any]:
    """Critical-path breakdown of one instance trace.

    ``e2e`` runs from the TRUE arrival (the admission-queue span's start,
    when the stream layer is in play; the engine arrival otherwise) to the
    terminal outcome.  ``exec_busy`` is the union of replica exec windows
    (overlapping replicas are not double counted); ``stall`` is whatever
    the queue, exec and recovery unions leave unexplained — stage-barrier
    gaps and detection lags outside recorded waits land there.
    """
    inst = tracer.instance(tid)
    spans = tracer.spans_of(tid)
    queue = [s for s in spans if s.kind == "admission_queue"]
    execs = [s for s in spans if s.kind == "exec" and s.closed]
    waits = [s for s in spans if s.kind == "recovery_wait"]
    arrival = min([s.t0 for s in queue] + [inst.t0])
    end = inst.t1 if inst.closed else float("nan")
    e2e = end - arrival
    queue_wait = sum(s.dur for s in queue)
    exec_busy = _union_len([(s.t0, s.t1) for s in execs])
    busy_or_waiting = _union_len(
        [(s.t0, s.t1) for s in execs] + [(s.t0, s.t1) for s in waits]
    )
    recovery_wait = busy_or_waiting - exec_busy
    stall = e2e - queue_wait - busy_or_waiting
    if stall == stall:                       # leave NaN (open trace) alone
        stall = max(stall, 0.0)

    stages: Dict[int, Dict[str, Any]] = {}
    for s in execs:
        stages.setdefault(int(s.attrs.get("stage", -1)), []).append(s)  # type: ignore[arg-type]
    stage_rows: Dict[int, Dict[str, Any]] = {}
    for idx in sorted(stages):
        group: List[Span] = stages[idx]      # type: ignore[assignment]
        crit = max(group, key=lambda s: s.t1)
        up = min(float(crit.attrs.get("pred_upload", 0.0)), crit.dur)
        tr = min(float(crit.attrs.get("pred_transfer", 0.0)), crit.dur - up)
        stage_rows[idx] = {
            "wall": max(s.t1 for s in group) - min(s.t0 for s in group),
            "n_replicas": len(group),
            "critical_task": crit.name,
            "critical_device": crit.attrs.get("device"),
            "critical": {"upload": up, "transfer": tr,
                         "exec": max(crit.dur - up - tr, 0.0)},
        }

    actions = {k: sum(1 for s in spans if s.kind == k)
               for k in ("failover", "replan", "salvage", "shed")}
    return {
        "tid": tid,
        "name": inst.name,
        "outcome": inst.attrs.get("outcome", "open"),
        "arrival": arrival,
        "e2e": e2e,
        "queue_wait": queue_wait,
        "exec_busy": exec_busy,
        "upload_total": sum(s.dur for s in spans if s.kind == "model_upload"),
        "transfer_total": sum(
            s.dur for s in spans if s.kind == "parent_transfer"
        ),
        "recovery_wait": recovery_wait,
        "stall": stall,
        "stages": stage_rows,
        "actions": {k: v for k, v in actions.items() if v},
    }


def _err_row(pred: List[float], real: List[float]) -> Dict[str, float]:
    p, r = np.asarray(pred, dtype=float), np.asarray(real, dtype=float)
    return {
        "n": int(p.size),
        "pred_mean": float(p.mean()) if p.size else float("nan"),
        "real_mean": float(r.mean()) if r.size else float("nan"),
        "bias": float((r - p).mean()) if p.size else float("nan"),
        "mae": float(np.abs(r - p).mean()) if p.size else float("nan"),
    }


def calibration(tracer: Tracer) -> Dict[str, Dict[str, Dict[str, Any]]]:
    """Calibration error of the planner's Eq. (2) estimates.

    ``policy`` rows compare the plan-time instance-level prediction
    (``pred_latency`` / ``pred_fail`` of the chosen placement) against the
    realized engine-side service time and the empirical loss rate.
    ``device`` / ``tier`` rows compare per-replica predicted duration
    (exec + upload + transfer) against the realized occupancy window of
    replicas that ran to their scheduled end, and the per-replica
    predicted failure probability against the observed death rate (dead
    at scheduled end, or killed mid-flight by churn).
    """
    by_policy: Dict[str, Dict[str, List[float]]] = {}
    for s in tracer.by_kind("plan"):
        inst = tracer.instance(s.tid)
        if not inst.closed:
            continue
        row = by_policy.setdefault(
            str(s.attrs.get("policy", "?")),
            {"pl": [], "rl": [], "pf": [], "lost": []},
        )
        outcome = inst.attrs.get("outcome")
        row["pf"].append(float(s.attrs.get("pred_fail", float("nan"))))
        row["lost"].append(1.0 if outcome == "lost" else 0.0)
        if outcome == "completed":
            row["pl"].append(float(s.attrs.get("pred_latency", float("nan"))))
            row["rl"].append(inst.t1 - inst.t0)

    policy_rows: Dict[str, Dict[str, Any]] = {}
    for name, row in sorted(by_policy.items()):
        out = {"latency": _err_row(row["pl"], row["rl"])}
        pf = np.asarray(row["pf"], dtype=float)
        out["p_fail"] = {
            "n": int(pf.size),
            "pred_mean": float(pf.mean()) if pf.size else float("nan"),
            "empirical": float(np.mean(row["lost"])) if row["lost"]
                         else float("nan"),
        }
        policy_rows[name] = out

    def group_execs(key: str) -> Dict[str, Dict[str, Any]]:
        groups: Dict[Any, Dict[str, List[float]]] = {}
        for s in tracer.by_kind("exec"):
            if not s.closed:
                continue
            g = groups.setdefault(
                s.attrs.get(key, "?"),
                {"pred": [], "real": [], "pf": [], "dead": []},
            )
            g["pf"].append(float(s.attrs.get("pred_fail", float("nan"))))
            g["dead"].append(
                1.0 if s.attrs.get("outcome") in ("dead", "killed") else 0.0
            )
            if s.attrs.get("outcome") in ("ok", "dead"):
                # ran to its scheduled end: the realized window is the
                # honest counterpart of the predicted Eq. (2) duration
                g["pred"].append(
                    float(s.attrs.get("pred_exec", 0.0))
                    + float(s.attrs.get("pred_upload", 0.0))
                    + float(s.attrs.get("pred_transfer", 0.0))
                )
                g["real"].append(s.dur)
        rows: Dict[str, Dict[str, Any]] = {}
        for gkey in sorted(groups, key=str):
            g = groups[gkey]
            row = {"duration": _err_row(g["pred"], g["real"])}
            pf = np.asarray(g["pf"], dtype=float)
            row["p_fail"] = {
                "n": int(pf.size),
                "pred_mean": float(pf.mean()) if pf.size else float("nan"),
                "empirical": float(np.mean(g["dead"])) if g["dead"]
                             else float("nan"),
            }
            rows[str(gkey)] = row
        return rows

    return {
        "policy": policy_rows,
        "device": group_execs("device"),
        "tier": group_execs("tier"),
    }


def slow_instances(tracer: Tracer, k: int = 5) -> List[Dict[str, Any]]:
    """The k slowest COMPLETED instances, each with its breakdown — the
    'why was this instance slow' report."""
    done = [
        s for s in tracer.instances()
        if s.closed and s.attrs.get("outcome") == "completed"
    ]
    done.sort(key=lambda s: s.t1 - s.t0, reverse=True)
    return [instance_breakdown(tracer, s.tid) for s in done[:k]]


def lost_instances(tracer: Tracer, k: Optional[int] = None
                   ) -> List[Dict[str, Any]]:
    """Every lost instance (latest first, optionally capped at ``k``) with
    its breakdown and failure context — the 'why was this instance lost'
    report.  Shed instances are excluded: they never ran."""
    lost = [
        s for s in tracer.instances()
        if s.closed and s.attrs.get("outcome") == "lost"
    ]
    lost.sort(key=lambda s: s.t1, reverse=True)
    out = []
    for s in lost[:k]:
        row = instance_breakdown(tracer, s.tid)
        row["reason"] = s.attrs.get("reason", "task_dead")
        deaths = [
            x for x in tracer.spans_of(s.tid)
            if x.kind == "exec" and x.closed
            and x.attrs.get("outcome") in ("dead", "killed")
        ]
        row["replica_deaths"] = len(deaths)
        row["death_devices"] = sorted(
            {int(x.attrs.get("device", -1)) for x in deaths}
        )
        out.append(row)
    return out


def attribution_report(tracer: Tracer, top_k: int = 5) -> Dict[str, Any]:
    """The full report: trace-side ledger, aggregate critical-path
    breakdown over completed instances, planner calibration, and the
    slow/lost offender lists."""
    completed = [
        instance_breakdown(tracer, s.tid)
        for s in tracer.instances()
        if s.closed and s.attrs.get("outcome") == "completed"
    ]
    fields = ("e2e", "queue_wait", "exec_busy", "upload_total",
              "transfer_total", "recovery_wait", "stall")
    agg = {"n": len(completed)}
    for f in fields:
        vals = np.asarray([b[f] for b in completed], dtype=float)
        agg[f"{f}_mean"] = float(vals.mean()) if vals.size else float("nan")
        agg[f"{f}_p99"] = (
            float(np.quantile(vals, 0.99)) if vals.size else float("nan")
        )
    return {
        "ledger": tracer.outcome_counts(),
        "critical_path": agg,
        "calibration": calibration(tracer),
        "slow": slow_instances(tracer, top_k),
        "lost": lost_instances(tracer, top_k),
    }


def format_report(report: Dict[str, Any]) -> str:
    """Human-readable rendering of :func:`attribution_report`."""
    lines: List[str] = []
    led = report["ledger"]
    lines.append("== instance ledger (from spans alone) ==")
    lines.append("  " + "  ".join(f"{k}={v}" for k, v in sorted(led.items())))
    cp = report["critical_path"]
    lines.append(f"== critical path (mean over {cp['n']} completed) ==")
    for f in ("e2e", "queue_wait", "exec_busy", "upload_total",
              "transfer_total", "recovery_wait", "stall"):
        lines.append(
            f"  {f:<15} mean {cp[f + '_mean']:8.3f}s"
            f"   p99 {cp[f + '_p99']:8.3f}s"
        )
    lines.append("== calibration: policy ==")
    for name, row in report["calibration"]["policy"].items():
        lat, pf = row["latency"], row["p_fail"]
        lines.append(
            f"  {name:<16} latency pred {lat['pred_mean']:.3f}s"
            f" real {lat['real_mean']:.3f}s bias {lat['bias']:+.3f}s"
            f" (n={lat['n']})  P_f pred {pf['pred_mean']:.3f}"
            f" emp {pf['empirical']:.3f}"
        )
    lines.append("== calibration: tier ==")
    for name, row in report["calibration"]["tier"].items():
        d, pf = row["duration"], row["p_fail"]
        lines.append(
            f"  tier {name:<4} dur pred {d['pred_mean']:.3f}s"
            f" real {d['real_mean']:.3f}s bias {d['bias']:+.3f}s"
            f" (n={d['n']})  P_f pred {pf['pred_mean']:.3f}"
            f" death-rate {pf['empirical']:.3f}"
        )
    lines.append(f"== slowest completed ({len(report['slow'])}) ==")
    for b in report["slow"]:
        lines.append(
            f"  [{b['tid']}] {b['name']:<14} e2e {b['e2e']:7.3f}s = "
            f"queue {b['queue_wait']:.3f} + exec {b['exec_busy']:.3f} + "
            f"recovery {b['recovery_wait']:.3f} + stall {b['stall']:.3f}"
            + (f"  actions {b['actions']}" if b["actions"] else "")
        )
    lines.append(f"== lost ({len(report['lost'])} shown) ==")
    for b in report["lost"]:
        lines.append(
            f"  [{b['tid']}] {b['name']:<14} reason {b['reason']}"
            f" after {b['e2e']:.3f}s, {b['replica_deaths']} replica deaths"
            f" on devices {b['death_devices']}"
            + (f"  actions {b['actions']}" if b["actions"] else "")
        )
    return "\n".join(lines)
