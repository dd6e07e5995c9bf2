"""Public entry points to the port's kernels.

The device of the tensors decides: a CPU tensor goes to the plain PyTorch
version in :mod:`.ref`, a CUDA tensor to the hand-written kernel, which
either launches or raises.  There is no fallback from the kernel to the
plain version on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import ref as _ref
from .flash_attention import flash_attention as _flash_attention
from .flash_decode import flash_decode as _flash_decode
from .rwkv6_scan import rwkv6_scan as _rwkv6_scan

__all__ = ["attention", "decode_attention", "rwkv6"]


def attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: Optional[int] = None,
) -> torch.Tensor:
    """GQA attention forward.  q ``(B,S,Hq,D)``, k and v ``(B,S,Hk,D)``;
    returns ``(B,S,Hq,D)``; see :func:`repro_torch.kernels.ref.attention_ref`."""
    if q.device.type == "cpu":
        return _ref.attention_ref(q, k, v, causal=causal, window=window)
    return _flash_attention(q, k, v, causal=causal, window=window)


def decode_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor,
) -> torch.Tensor:
    """Single-token GQA decode over a padded cache.  q ``(B,Hq,D)``, k and v
    ``(B,C,Hk,D)``, ``lengths`` ``(B,)`` int32 in ``[1, C]``; returns
    ``(B,Hq,D)``; see :func:`repro_torch.kernels.ref.decode_attention_ref`."""
    if q.device.type == "cpu":
        return _ref.decode_attention_ref(q, k, v, lengths)
    return _flash_decode(q, k, v, lengths)


def rwkv6(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
    u: torch.Tensor, S0: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """WKV recurrence over a whole sequence.  Returns ``(y, S_T)``; see
    :func:`repro_torch.kernels.ref.rwkv6_ref` for the shapes."""
    if r.device.type == "cpu":
        return _ref.rwkv6_ref(r, k, v, w, u, S0)
    return _rwkv6_scan(r, k, v, w, u, S0)
