"""Optimizers (AdamW, Adafactor), LR schedules, gradient clipping and the
int8 gradient compression for the links between pods."""
from .compression import (compress_gradients, decompress_gradients, int8_dequantize,
                          int8_quantize)
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
    "int8_quantize",
    "int8_dequantize",
    "compress_gradients",
    "decompress_gradients",
]
