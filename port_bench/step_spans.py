"""What the readers of the ``chat`` cell's program spans share: a decode
step's device time from the spans a replayed step opens, and a layer
kind's device time summed over each prefill.  Every reader returns None
without a kept profile, and where the program has no such spans (a
program whose replays open no ``model.backbone``, or whose layers open no
``model.moe`` or ``model.mla``)."""
from __future__ import annotations

from typing import Optional

import numpy as np

from .program_spans import kept_spans, of_kind


def decode_device_ms(rec) -> Optional[float]:
    """The mean device time of the kept profile's decode steps (those inside
    a ``serve.step``): the backbone's replay (``model.backbone``) plus the
    head's (``model.logits``), each from two CUDA events."""
    spans = kept_spans(rec)
    if not spans:
        return None
    steps = {s.attrs["id"] for s in of_kind(spans, "model.decode_step", "serve.step")}
    parts = {}
    for s in spans:
        if (s.kind in ("model.backbone", "model.logits") and s.attrs["parent"] in steps
                and "device_ms" in s.attrs):
            parts.setdefault(s.attrs["parent"], {})[s.kind] = s.attrs["device_ms"]
    ms = [sum(p.values()) for p in parts.values() if len(p) == 2]
    return float(np.mean(ms)) if ms else None


def prefill_device_ms(rec, kind: str) -> Optional[float]:
    """The device time of the kept profile's ``kind`` spans (one a layer)
    summed over each ``model.prefill``, mean over the prefills that have
    them."""
    spans = kept_spans(rec)
    if not spans:
        return None
    prefills = {s.attrs["id"] for s in of_kind(spans, "model.prefill")}
    per = {}
    for s in of_kind(spans, kind):
        if s.attrs["parent"] in prefills and "device_ms" in s.attrs:
            per[s.attrs["parent"]] = per.get(s.attrs["parent"], 0.0) + s.attrs["device_ms"]
    return float(np.mean(list(per.values()))) if per else None
