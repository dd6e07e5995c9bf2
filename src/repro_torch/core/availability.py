"""The two functions of the JAX package's ``core/availability.py`` that the
checkpoint cadence needs, copied so the port imports nothing of ``repro``.

For exponential failures with MTBF ``1/lambda`` and checkpoint write cost
``C``, the Young/Daly interval ``sqrt(2 * C / lambda)`` minimises expected
lost work; a gang-scheduled job fails when any member fails, so member
failure rates add.  The rest of the module comes with the placement core
(ROADMAP.md, slice 5).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ["young_daly_interval", "gang_failure_rate"]


def young_daly_interval(lam: float, ckpt_cost: float) -> float:
    """Optimal checkpoint interval ``sqrt(2 C / lambda)`` for exponential
    failures (Young '74 / Daly '06).  ``lam`` is the failure rate of the
    *job* (sum of member-pod rates for a gang-scheduled job)."""
    if lam <= 0:
        return float("inf")
    if ckpt_cost < 0:
        raise ValueError("checkpoint cost must be >= 0")
    return float(np.sqrt(2.0 * ckpt_cost / lam))


def gang_failure_rate(lams: Sequence[float]) -> float:
    """A gang-scheduled job fails when *any* member fails: rates add."""
    return float(np.sum(np.asarray(lams, dtype=np.float64)))
