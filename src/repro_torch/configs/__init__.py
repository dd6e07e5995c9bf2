"""Ported-architecture registry: ``get_config(arch_id)`` returns the exact
published ModelConfig; ``ARCHS`` lists every selectable ``--arch``.

Ported so far: the ``dense`` family (``qwen1.5-0.5b``, ``minitron-8b``,
``olmo-1b``, ``command-r-plus-104b``; trained through ``launch/train.py``
and served with a KV cache through ``launch/serve.py``), the ``ssm``
family (``rwkv6-3b``, served and trainable), the ``moe`` family
(``qwen2-moe-a2.7b`` with GQA, ``deepseek-v3-671b`` with MLA; served) and
the ``hybrid`` family (``recurrentgemma-9b``: RG-LRU and local attention;
served).  The JAX package's two other architectures are queued in
ROADMAP.md ("Remaining model families").
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

from ..models.config import ModelConfig
from .command_r_plus_104b import config as _command_r_plus
from .deepseek_v3_671b import config as _dsv3
from .minitron_8b import config as _minitron8
from .olmo_1b import config as _olmo
from .qwen1_5_0_5b import config as _qwen05
from .qwen2_moe_a2_7b import config as _qwen_moe
from .recurrentgemma_9b import config as _rgemma
from .rwkv6_3b import config as _rwkv6

ARCH_BUILDERS: Dict[str, Callable[[], ModelConfig]] = {
    "qwen1.5-0.5b": _qwen05,
    "minitron-8b": _minitron8,
    "rwkv6-3b": _rwkv6,
    "olmo-1b": _olmo,
    "command-r-plus-104b": _command_r_plus,
    "qwen2-moe-a2.7b": _qwen_moe,
    "deepseek-v3-671b": _dsv3,
    "recurrentgemma-9b": _rgemma,
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
