"""Learning-rate schedules: callables of the int32 step tensor, returning a
float32 tensor, as in the JAX package's ``optim/schedules.py``."""
from __future__ import annotations

import math

import torch

__all__ = ["constant", "linear_warmup", "cosine_with_warmup"]


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32, device=step.device)


def linear_warmup(lr: float, warmup: int):
    def f(step):
        s = step.to(torch.float32)
        return lr * torch.clamp(s / max(warmup, 1), max=1.0)
    return f


def cosine_with_warmup(lr: float, warmup: int, total: int, final_frac: float = 0.1):
    def f(step):
        s = step.to(torch.float32)
        warm = torch.clamp(s / max(warmup, 1), max=1.0)
        t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t))
        return lr * warm * cos
    return f
