"""repro_torch.obs — observability for the orchestration pipeline.

  * :mod:`repro_torch.obs.tracing` — per-instance traces of structured,
    sim-clock-timestamped spans (:data:`SPAN_SCHEMA`), emitted by the
    engine / stream service / recovery strategies through a
    zero-overhead-when-disabled :class:`Tracer`;
  * :mod:`repro_torch.obs.metrics` — the counters / gauges /
    exact-quantile histograms registry (:mod:`repro_torch.stream.metrics`
    re-exports from here) and :class:`EngineStats`, the engine's typed
    counter ledger with the conservation identity checked in one place;
  * :mod:`repro_torch.obs.attribution` — predicted-vs-actual cost
    attribution: critical-path breakdowns, Eq. (2) / P_f calibration per
    policy / tier / device, slow- and lost-instance reports;
  * :mod:`repro_torch.obs.export` — Chrome/Perfetto ``trace_event`` JSON
    (device rows + instance flows) and summary exports, with the
    instance ledger recomputable from the exported trace alone;
  * :mod:`repro_torch.obs.runtime` — the serving engine's, the model's and
    the trainer's spans on the host clock (:data:`RUNTIME_SCHEMA`: the
    ``serve.*``, ``model.*`` and ``train.*`` kinds), each also a
    ``record_function`` range in a running profile and, on a CUDA device,
    timed on the card by two events.

Enable the simulator's tracing via ``Orchestrator(cluster, policy,
trace=Tracer())`` or ``SimConfig(trace=True)``.  The runtime's spans record
only while a ``torch.profiler`` profile runs or after ``runtime.enable()``;
otherwise ``runtime.span`` returns a shared no-op, and read them with
``runtime.profile_spans()`` (the latest profile's) or ``runtime.drain()``.
"""
from .attribution import (
    attribution_report,
    calibration,
    format_report,
    instance_breakdown,
    lost_instances,
    slow_instances,
)
from .export import (
    json_summary,
    ledger_from_trace,
    to_chrome_trace,
    validate_chrome_trace,
)
from .metrics import (
    ENGINE_COUNTERS,
    Counter,
    EngineStats,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from .tracing import FLEET_TID, RUNTIME_SCHEMA, SPAN_SCHEMA, Span, Tracer

__all__ = [
    "Span",
    "Tracer",
    "SPAN_SCHEMA",
    "RUNTIME_SCHEMA",
    "FLEET_TID",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "ENGINE_COUNTERS",
    "EngineStats",
    "instance_breakdown",
    "calibration",
    "slow_instances",
    "lost_instances",
    "attribution_report",
    "format_report",
    "to_chrome_trace",
    "ledger_from_trace",
    "validate_chrome_trace",
    "json_summary",
]
