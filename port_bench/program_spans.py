"""What the readers of the program's own spans share: the spans that
``repro_torch.obs.runtime`` recorded while the traced run's kept profile ran.

The runtime records a span only while a profile runs, and numbers each
profile it sees (a session).  The harness keeps only the last profile it
takes, so with ``rec.trace`` set the program's latest session is the kept
profile.  Every reader returns None without a kept profile, and where the
program has no runtime spans to read."""
from __future__ import annotations

from typing import List, Optional

import numpy as np


def kept_spans(rec) -> Optional[List]:
    """The program's spans of the kept profile, or None."""
    if rec.trace is None:
        return None
    try:
        from repro_torch.obs.runtime import profile_spans
    except ImportError:             # a program without the runtime's spans
        return None
    return profile_spans() or None


def of_kind(spans, kind: str, parent: Optional[str] = None) -> List:
    """The ``kind`` spans, those whose parent is a ``parent`` span where given."""
    ids = {s.attrs["id"]: s for s in spans}
    out = [s for s in spans if s.kind == kind]
    if parent is not None:
        out = [s for s in out if s.attrs["parent"] in ids
               and ids[s.attrs["parent"]].kind == parent]
    return out


def host_ms(spans) -> Optional[float]:
    """The mean host time of ``spans`` in ms."""
    return float(np.mean([(s.t1 - s.t0) / 1e6 for s in spans])) if spans else None


def device_ms(spans) -> Optional[float]:
    """The mean device time of ``spans`` in ms (those with one): the stream's
    elapsed time between each span's two events, idle gaps included."""
    ms = [s.attrs["device_ms"] for s in spans if "device_ms" in s.attrs]
    return float(np.mean(ms)) if ms else None


def per_step_device_ms(rec, kind: str) -> Optional[float]:
    """The device time of the kept profile's ``kind`` spans over its
    ``train.step`` spans, in ms a step."""
    spans = kept_spans(rec)
    if spans is None:
        return None
    steps = of_kind(spans, "train.step")
    ms = [s.attrs["device_ms"] for s in of_kind(spans, kind) if "device_ms" in s.attrs]
    return float(sum(ms)) / len(steps) if steps and ms else None
