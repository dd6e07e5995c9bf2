"""Orchestration core.  Only the interference fit is ported so far; the
placement core is queued in ROADMAP.md."""
from .interference import fit_linear_interference

__all__ = ["fit_linear_interference"]
