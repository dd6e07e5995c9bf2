"""Serving: the single-replica continuous-batching engine.  The fleet
scheduler (``ServingFleet``) is queued in ROADMAP.md."""
from .engine import ServingEngine, measure_interference

__all__ = ["ServingEngine", "measure_interference"]
