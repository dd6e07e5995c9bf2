"""The kernels' launch counters, read and advanced together.

Each wrapper counts its own calls (``flash_decode.launches`` and the
others), and the head's product its calls by route
(``head_product.routes``).  A CUDA graph's replay launches what its capture
recorded without calling a wrapper, and its capture called the wrappers
without launching anything on the card; :class:`repro_torch.models.transformer.DecodeGraph`
takes back what a capture counted (:func:`since`, :func:`add` of its
negation) and adds it at every replay, so the counters keep counting the
launches the card runs.
"""
from __future__ import annotations

from typing import Dict, Tuple

from ..models.layers import head_product
from .bf16_split import bf16_split
from .flash_attention import flash_attention
from .flash_decode import flash_decode
from .rwkv6_scan import rwkv6_scan

__all__ = ["Counts", "snapshot", "since", "add"]

# each wrapper and its counters: an int, or a dict of ints by kind
_COUNTERS = (
    (flash_attention, ("launches", "wgmma_launches", "simt_launches")),
    (flash_decode, ("launches", "kind_launches")),
    (rwkv6_scan, ("launches",)),
    (bf16_split, ("launches",)),
    (head_product, ("routes",)),      # the head's products by route
)

Counts = Dict[Tuple[str, str], object]


def snapshot() -> Counts:
    """Every counter's value now (dicts copied)."""
    out: Counts = {}
    for fn, names in _COUNTERS:
        for name in names:
            val = getattr(fn, name)
            out[(fn.__name__, name)] = dict(val) if isinstance(val, dict) else val
    return out


def since(before: Counts) -> Counts:
    """What each counter counted since ``before`` was taken."""
    now = snapshot()
    out: Counts = {}
    for key, val in now.items():
        old = before[key]
        if isinstance(val, dict):
            out[key] = {k: n - old.get(k, 0) for k, n in val.items() if n != old.get(k, 0)}
        else:
            out[key] = val - old
    return out


def add(delta: Counts, sign: int = 1) -> None:
    """Advance every counter by ``sign`` times its entry in ``delta``."""
    for fn, names in _COUNTERS:
        for name in names:
            d = delta[(fn.__name__, name)]
            if isinstance(d, dict):
                kinds = getattr(fn, name)
                for k, n in d.items():
                    kinds[k] = kinds.get(k, 0) + sign * n
            else:
                setattr(fn, name, getattr(fn, name) + sign * d)
