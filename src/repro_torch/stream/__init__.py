"""Always-on orchestration service: open-loop arrivals, bounded admission
with deadline-aware shedding, SLO classes, and a metrics export surface.

  * :mod:`repro_torch.stream.arrivals` — Poisson / diurnal / trace-replay arrival
    processes, seeded per-stream like :mod:`repro_torch.sim.churn`;
  * :mod:`repro_torch.stream.admission` — the bounded queue: backpressure,
    deadline-aware shedding from idle-fleet scorer estimates, and
    ``latency_critical`` / ``best_effort`` SLO-class trade-offs;
  * :mod:`repro_torch.stream.service` — :class:`StreamingOrchestrator`, the
    service loop draining admitted waves through fused
    ``orchestrate_batch`` under churn + recovery + salvage;
  * :mod:`repro_torch.stream.metrics` — counters / histograms / interval samples,
    exportable as JSON (:func:`without_wall_clock` drops the two read off
    the host's clock, for comparing runs).
"""
from .arrivals import (
    BEST_EFFORT,
    LATENCY_CRITICAL,
    AppStream,
    Arrival,
    SLOClass,
    default_streams,
    diurnal_arrivals,
    poisson_arrivals,
    trace_replay,
)
from .admission import (
    AdmissionConfig,
    AdmissionController,
    PlacementLatencyEstimator,
    ShedRecord,
)
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .service import (
    WALL_CLOCK_METRICS,
    StreamingOrchestrator,
    StreamResult,
    without_wall_clock,
)

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
    "AdmissionConfig",
    "AdmissionController",
    "PlacementLatencyEstimator",
    "ShedRecord",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "StreamingOrchestrator",
    "StreamResult",
    "WALL_CLOCK_METRICS",
    "without_wall_clock",
]
