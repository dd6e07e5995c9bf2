"""Optimizers (AdamW, Adafactor), LR schedules and gradient clipping.  The
int8 gradient compression is queued in ROADMAP.md."""
from .optimizers import Adafactor, AdamW, Optimizer, clip_by_global_norm, global_norm
from .schedules import constant, cosine_with_warmup, linear_warmup

__all__ = [
    "Optimizer",
    "AdamW",
    "Adafactor",
    "clip_by_global_norm",
    "global_norm",
    "constant",
    "cosine_with_warmup",
    "linear_warmup",
]
