"""Public entry points to the port's kernels.

The device of the tensors decides: a CPU tensor goes to the plain PyTorch
version in :mod:`.ref`, a CUDA tensor to the hand-written kernel, which
either launches or raises, and a meta tensor to :mod:`.meta`, which returns
meta outputs and counts the kernel's work for the dry-run.  There is no
fallback from the kernel to the plain version on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import meta as _meta
from . import ref as _ref
from .bf16_split import bf16_split as _bf16_split
from .flash_attention import flash_attention as _flash_attention
from .flash_decode import flash_decode as _flash_decode
from .rwkv6_scan import rwkv6_scan as _rwkv6_scan

__all__ = ["attention", "decode_attention", "rwkv6", "split_bf16"]


def attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: Optional[int] = None,
) -> torch.Tensor:
    """GQA attention forward.  q ``(B,S,Hq,D)``, k and v ``(B,S,Hk,D)``;
    returns ``(B,S,Hq,D)``; see :func:`repro_torch.kernels.ref.attention_ref`."""
    if q.device.type == "cpu":
        return _ref.attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type == "meta":
        return _meta.attention(q, k, v, causal, window)
    return _flash_attention(q, k, v, causal=causal, window=window)


def decode_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor,
) -> torch.Tensor:
    """Single-token GQA decode over a padded cache.  q ``(B,Hq,D)``, k and v
    ``(B,C,Hk,D)``, ``lengths`` ``(B,)`` int32 in ``[1, C]``; returns
    ``(B,Hq,D)``; see :func:`repro_torch.kernels.ref.decode_attention_ref`."""
    if q.device.type == "cpu":
        return _ref.decode_attention_ref(q, k, v, lengths)
    if q.device.type == "meta":
        return _meta.decode_attention(q, k, v, lengths)
    return _flash_decode(q, k, v, lengths)


def rwkv6(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
    u: torch.Tensor, S0: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """WKV recurrence over a whole sequence.  Returns ``(y, S_T)``; see
    :func:`repro_torch.kernels.ref.rwkv6_ref` for the shapes."""
    if r.device.type == "cpu":
        return _ref.rwkv6_ref(r, k, v, w, u, S0)
    if r.device.type == "meta":
        return _meta.rwkv6(r, k, v, w, u, S0)
    return _rwkv6_scan(r, k, v, w, u, S0)


def split_bf16(g: torch.Tensor) -> torch.Tensor:
    """A float32 matrix ``(rows, cols)`` as three bfloat16 pieces ``(rows, 3,
    cols)`` that sum to it; see :func:`repro_torch.kernels.ref.bf16_split_ref`.
    Plain torch ops on the CPU and the meta device alike."""
    if g.device.type == "cuda":
        return _bf16_split(g)
    return _ref.bf16_split_ref(g)
