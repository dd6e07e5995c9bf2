"""Interference service-time model (paper §IV-A).

The paper characterises interference on an edge device with *linear service
time plots*: running a new task of type ``T_i`` on device ``ED_p`` while
``k`` tasks of type ``T_j`` are already co-located costs

    f_ij(T_i, k * T_j) = m[p, i, j] * k + c[p, i]

and the patterns are assumed **independent and additive** (verified in the
paper's Fig. 4), so with running-task counts ``alpha = (a_1..a_N)``:

    f_i(T_i, alpha) = c[p, i] + sum_j m[p, i, j] * a_j              (Eq. 1)

``c`` depends only on (device, task type) — it is the unloaded base latency —
while the pairwise slopes ``m`` form the N^2 interference-coefficient matrix
``ED_mc`` of the paper.

The same linear law is reused by the serving scheduler
(:mod:`repro.serve.scheduler`): decode-step latency of a continuously-batched
replica grows linearly in the number of co-resident sequences, so each model
replica is a "device" and each request class a "task type".
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

__all__ = ["InterferenceModel", "fit_linear_interference"]


@dataclass
class InterferenceModel:
    """Vectorised ``ED_mc`` table.

    base  : (n_classes, n_types)            -- c[p, i]
    slope : (n_classes, n_types, n_types)   -- m[p, i, j]
    """

    base: np.ndarray
    slope: np.ndarray

    def __post_init__(self) -> None:
        self.base = np.asarray(self.base, dtype=np.float64)
        self.slope = np.asarray(self.slope, dtype=np.float64)
        if self.base.ndim != 2 or self.slope.ndim != 3:
            raise ValueError("base must be (P,N), slope must be (P,N,N)")
        p, n = self.base.shape
        if self.slope.shape != (p, n, n):
            raise ValueError(
                f"slope shape {self.slope.shape} inconsistent with base {self.base.shape}"
            )
        if (self.base < 0).any() or (self.slope < 0).any():
            raise ValueError("negative interference coefficients")

    @property
    def n_classes(self) -> int:
        return self.base.shape[0]

    @property
    def n_types(self) -> int:
        return self.base.shape[1]

    # -- Eq. (1) ---------------------------------------------------------------
    def estimate(self, cls: int, ttype: int, counts: np.ndarray) -> float:
        """Expected service time of a new ``ttype`` task on a class-``cls``
        device currently running ``counts[j]`` tasks of each type."""
        return float(self.base[cls, ttype] + self.slope[cls, ttype] @ counts)

    def estimate_all_classes(self, ttype: int, counts_per_class: np.ndarray) -> np.ndarray:
        """Vectorised Eq. (1) across every device class at once.

        counts_per_class: (P, N) running-task counts for one device of each
        class.  Returns (P,) expected service times.
        """
        return self.base[:, ttype] + np.einsum(
            "pj,pj->p", self.slope[:, ttype, :], counts_per_class
        )

    def estimate_devices(
        self, classes: np.ndarray, ttype: int, counts: np.ndarray
    ) -> np.ndarray:
        """Eq. (1) for a fleet: ``classes`` is (D,) class ids, ``counts`` is
        (D, N) per-device running-task counts.  Returns (D,) estimates."""
        return self.base[classes, ttype] + np.einsum(
            "dj,dj->d", self.slope[classes, ttype, :], counts
        )

    def pair_plot(self, cls: int, i: int, j: int, k_max: int = 10) -> np.ndarray:
        """The raw 'interference plot' f_ij(T_i, k*T_j) for k = 0..k_max
        (paper Fig. 2a / Fig. 4)."""
        k = np.arange(k_max + 1, dtype=np.float64)
        return self.base[cls, i] + self.slope[cls, i, j] * k


def fit_linear_interference(
    k_counts: Sequence[float], latencies: Sequence[float]
) -> tuple:
    """Least-squares fit of one interference plot ``lat = m*k + c``.

    Used both by the offline profiler of the edge simulator and by the
    serving scheduler when it calibrates decode-latency-vs-batch-size from
    real measurements.  Returns ``(m, c, r2)``.
    """
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
