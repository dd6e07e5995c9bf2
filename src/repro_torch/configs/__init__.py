"""Architecture registry: ``get_config(arch_id)`` returns the exact
published ModelConfig; ``ARCHS`` lists every selectable ``--arch``, all ten
of the JAX package's, in its order.

The ``dense`` family (``minitron-8b``, ``command-r-plus-104b``,
``qwen1.5-0.5b``, ``olmo-1b``; trained through ``launch/train.py`` and
served with a KV cache through ``launch/serve.py``), the ``audio`` family
(``whisper-tiny``: trained, and decoded through ``LM.prefill`` and
``LM.decode_step``; the ``ServingEngine`` passes only tokens), the ``moe``
family (``qwen2-moe-a2.7b`` with GQA, ``deepseek-v3-671b`` with MLA;
served), the ``ssm`` family (``rwkv6-3b``, served and trainable), the
``hybrid`` family (``recurrentgemma-9b``: RG-LRU and local attention;
served) and the ``vlm`` family (``qwen2-vl-72b``: M-RoPE; served on text
and trained).
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
from .qwen2_vl_72b import config as _qwen_vl
from .recurrentgemma_9b import config as _rgemma
from .rwkv6_3b import config as _rwkv6
from .whisper_tiny import config as _whisper

ARCH_BUILDERS: Dict[str, Callable[[], ModelConfig]] = {
    "minitron-8b": _minitron8,
    "command-r-plus-104b": _command_r_plus,
    "qwen1.5-0.5b": _qwen05,
    "olmo-1b": _olmo,
    "whisper-tiny": _whisper,
    "qwen2-moe-a2.7b": _qwen_moe,
    "deepseek-v3-671b": _dsv3,
    "rwkv6-3b": _rwkv6,
    "recurrentgemma-9b": _rgemma,
    "qwen2-vl-72b": _qwen_vl,
}

ARCHS: List[str] = list(ARCH_BUILDERS)


def get_config(arch: str, **overrides) -> ModelConfig:
    if arch not in ARCH_BUILDERS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCHS}")
    cfg = ARCH_BUILDERS[arch]()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


__all__ = ["ARCHS", "ARCH_BUILDERS", "get_config"]
