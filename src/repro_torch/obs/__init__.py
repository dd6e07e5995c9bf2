"""repro_torch.obs — observability for the orchestration pipeline.

  * :mod:`repro_torch.obs.tracing` — per-instance traces of structured,
    sim-clock-timestamped spans (:data:`SPAN_SCHEMA`), emitted by the
    engine and the recovery strategies through a
    zero-overhead-when-disabled :class:`Tracer`;
  * :mod:`repro_torch.obs.metrics` — the counters / gauges /
    exact-quantile histograms registry and :class:`EngineStats`, the
    engine's typed counter ledger with the conservation identity checked
    in one place.

The JAX package's attribution reports and trace exporters are not ported
yet (ROADMAP.md, slice 5).
"""
from .metrics import (
    ENGINE_COUNTERS,
    Counter,
    EngineStats,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from .tracing import FLEET_TID, SPAN_SCHEMA, Span, Tracer

__all__ = [
    "Span",
    "Tracer",
    "SPAN_SCHEMA",
    "FLEET_TID",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "ENGINE_COUNTERS",
    "EngineStats",
]
