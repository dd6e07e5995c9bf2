"""Linear interference fit (paper §IV-A), the part the serving engine needs.

A copy of ``fit_linear_interference`` from the JAX package's
``core/interference.py``: decode-step latency of a continuously batched
replica grows linearly in the number of co-resident sequences,
``T = m*k + c``.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ["fit_linear_interference"]


def fit_linear_interference(
    k_counts: Sequence[float], latencies: Sequence[float]
) -> tuple:
    """Least-squares fit of one interference plot ``lat = m*k + c``.
    Returns ``(m, c, r2)``."""
    k = np.asarray(k_counts, dtype=np.float64)
    y = np.asarray(latencies, dtype=np.float64)
    if k.shape != y.shape or k.ndim != 1 or k.size < 2:
        raise ValueError("need >=2 paired samples")
    A = np.stack([k, np.ones_like(k)], axis=1)
    (m, c), *_ = np.linalg.lstsq(A, y, rcond=None)
    pred = m * k + c
    ss_res = float(((y - pred) ** 2).sum())
    ss_tot = float(((y - y.mean()) ** 2).sum())
    # a (numerically) constant line is a perfect fit, not an undefined one
    if ss_tot <= 1e-12 * max(1.0, float((y * y).sum())):
        r2 = 1.0
    else:
        r2 = 1.0 - ss_res / ss_tot
    return float(m), float(c), r2
