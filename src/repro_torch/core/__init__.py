"""Orchestration core.  Only the interference fit and the checkpoint
cadence's two availability functions are ported so far; the placement core
is queued in ROADMAP.md."""
from .availability import gang_failure_rate, young_daly_interval
from .interference import fit_linear_interference

__all__ = ["fit_linear_interference", "gang_failure_rate", "young_daly_interval"]
