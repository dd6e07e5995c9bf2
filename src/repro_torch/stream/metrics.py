"""Metrics primitives for the streaming service — re-export shim.

The counters / gauges / exact-quantile histograms and the get-or-create
registry moved to :mod:`repro_torch.obs.metrics`, the unified metrics layer
shared by the stream service and the engine's typed counter ledger
(:class:`~repro_torch.obs.metrics.EngineStats`).  This module keeps the
original import path working; new code should import from ``repro_torch.obs``.
"""
from __future__ import annotations

from ..obs.metrics import Counter, Gauge, Histogram, MetricsRegistry

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]
