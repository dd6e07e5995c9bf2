"""The assigned input shapes (the four cells of every architecture), a copy
of the JAX package's ``configs/shapes.py``:

  train_4k     seq 4096,   global batch 256  -> a train step
  prefill_32k  seq 32768,  global batch 32   -> a prefill
  decode_32k   seq 32768,  global batch 128  -> one decode step (one new
                token against a KV cache of seq_len)
  long_500k    seq 524288, global batch 1    -> one decode step; needs
                sub-quadratic attention (the SSM and hybrid families only:
                the full-attention architectures skip this cell)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

from ..models.config import ModelConfig

__all__ = ["ShapeSpec", "SHAPES", "cell_applicable"]


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str           # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def cell_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """``(applicable, reason)``.  The only skip in the grid is long_500k on
    an architecture whose attention is full and quadratic."""
    if shape.name == "long_500k" and not cfg.sub_quadratic():
        return False, ("full quadratic attention at 524k context (skip per assignment; "
                       "see DESIGN.md)")
    return True, ""
