"""Optimizer (AdamW), LR schedules and gradient clipping.  Adafactor and the
int8 gradient compression are queued in ROADMAP.md."""
from .optimizers import AdamW, Optimizer, clip_by_global_norm, global_norm
from .schedules import constant, cosine_with_warmup, linear_warmup

__all__ = [
    "Optimizer",
    "AdamW",
    "clip_by_global_norm",
    "global_norm",
    "constant",
    "cosine_with_warmup",
    "linear_warmup",
]
