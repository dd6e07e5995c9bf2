"""Ported-architecture registry: ``get_config(arch_id)`` returns the exact
published ModelConfig; ``ARCHS`` lists every selectable ``--arch``.

Ported so far: ``qwen1.5-0.5b`` and ``minitron-8b`` (the ``dense`` family,
trained through ``launch/train.py`` and served with a KV cache through
``launch/serve.py``) and ``rwkv6-3b`` (the ``ssm`` family, served and
trainable).  The JAX package's seven other architectures are queued in
ROADMAP.md ("Remaining model families").
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

from ..models.config import ModelConfig
from .minitron_8b import config as _minitron8
from .qwen1_5_0_5b import config as _qwen05
from .rwkv6_3b import config as _rwkv6

ARCH_BUILDERS: Dict[str, Callable[[], ModelConfig]] = {
    "qwen1.5-0.5b": _qwen05,
    "minitron-8b": _minitron8,
    "rwkv6-3b": _rwkv6,
}

ARCHS: List[str] = list(ARCH_BUILDERS)


def get_config(arch: str, **overrides) -> ModelConfig:
    if arch not in ARCH_BUILDERS:
        raise KeyError(
            f"unknown arch {arch!r}; ported: {ARCHS} (the rest are queued in "
            "ROADMAP.md, 'Remaining model families')"
        )
    cfg = ARCH_BUILDERS[arch]()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


__all__ = ["ARCHS", "ARCH_BUILDERS", "get_config"]
