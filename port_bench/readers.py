"""What the metric readers under ``metrics/`` share: picking a record's
spans, and the trace's arithmetic.  Every reader returns None where the
record holds nothing for it to read."""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from . import costs


def window_spans(rec, name: str) -> List:
    """The ``name`` spans that started inside the window."""
    return [s for s in rec.spans if s.name == name and s.t0 < rec.elapsed]


def traced_spans(rec, name: str) -> List:
    """The ``name`` spans inside the traced span."""
    tr = rec.trace
    return [s for s in rec.spans if s.name == name and tr.t0 <= s.t0 and s.t1 <= tr.t1]


def mean_ms(spans) -> Optional[float]:
    return 1e3 * float(np.mean([s.t1 - s.t0 for s in spans])) if spans else None


def idle_pct(rec) -> Optional[float]:
    tr = rec.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def roofline_pct(rec, kernel: str, least_s: float) -> Optional[float]:
    """The least time of the traced calls of ``kernel`` over its device
    time in the trace, in percent."""
    if rec.trace is None:
        return None
    spent = rec.trace.kernel_s(kernel)
    if spent <= 0 or least_s <= 0:
        return None
    return 100.0 * least_s / spent


def attention_least_s(m, B: int, S: int) -> float:
    ops, nbytes = costs.attention_work(B, S, m["n_heads"], m["n_kv_heads"], m["head_dim"], 2)
    return costs.least_s(ops, nbytes)

