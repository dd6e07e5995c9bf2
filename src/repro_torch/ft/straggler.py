"""Straggler mitigation = the paper's replication loop, applied to gang jobs.

A straggling or about-to-be-preempted pod delays the whole synchronous
step.  IBDASH's insight: when the predicted failure probability of a
placement exceeds beta, replicate onto the next-best resource as long as
the weighted score alpha*L + (1-alpha)*F keeps improving (Algorithm 1,
lines 30-41).  Here the "task" is a shard of work (e.g. a data-shard's
gradient computation or an eval/ckpt job) and the "devices" are pods whose
failure rates come from the online FleetMonitor fit.

``StragglerMitigator.decide`` is pure (testable): given per-pod expected
completion times and failure rates it returns which backup pods to launch.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.availability import prob_fail_during

__all__ = ["BackupDecision", "StragglerMitigator"]


@dataclass(frozen=True)
class BackupDecision:
    primary: int                     # index of the chosen pod
    backups: Tuple[int, ...]         # replica pods, best-first
    pred_fail: float                 # combined P(all replicas fail)
    est_latency: float               # primary's expected completion


@dataclass
class StragglerMitigator:
    alpha: float = 0.5               # joint weight (paper Eq. 5)
    beta: float = 0.05               # failure-probability threshold
    gamma: int = 2                   # max backups per task

    def decide(
        self,
        est_latency: Sequence[float],     # per-pod expected completion (s)
        lams: Sequence[float],            # per-pod failure rates
        eligible: Optional[Sequence[bool]] = None,
    ) -> BackupDecision:
        lat = np.asarray(est_latency, dtype=np.float64)
        lam = np.asarray(lams, dtype=np.float64)
        ok = np.ones(len(lat), dtype=bool) if eligible is None else np.asarray(eligible)
        cand = np.flatnonzero(ok)
        if cand.size == 0:
            raise ValueError("no eligible pods")
        order = cand[np.argsort(lat[cand], kind="stable")]

        pf = np.array([prob_fail_during(lam[i], lat[i]) for i in range(len(lat))])
        primary = int(order[0])
        l_ref = max(lat[primary], 1e-9)
        comb = pf[primary]
        score = self.alpha * (lat[primary] / l_ref) + (1 - self.alpha) * comb
        backups: List[int] = []
        qi = 1
        while comb >= self.beta and len(backups) < self.gamma and qi < order.size:
            i = int(order[qi]); qi += 1
            new_comb = comb * pf[i]
            new_score = self.alpha * (lat[i] / l_ref) + (1 - self.alpha) * new_comb
            if new_score <= score:
                backups.append(i)
                comb, score = new_comb, new_score
            else:
                break
        return BackupDecision(
            primary=primary, backups=tuple(backups),
            pred_fail=float(comb), est_latency=float(lat[primary]),
        )

    def expected_step_speedup(
        self, lat: Sequence[float], lams: Sequence[float], horizon: float
    ) -> float:
        """Expected saving from backups on one synchronous step: without a
        backup a failure costs a full restore ``horizon``; with backups the
        step completes unless all replicas fail."""
        d = self.decide(lat, lams)
        pf_primary = prob_fail_during(lams[d.primary], lat[d.primary])
        return (pf_primary - d.pred_fail) * horizon
