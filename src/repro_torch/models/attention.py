"""Grouped-query attention (GQA) without a cache: training and prefill from
position 0.

The counterpart of the GQA part of the JAX package's ``models/attention.py``.
With no cache, no cross-attention source, a causal mask, no logit softcap
and S > 1, attention goes through
:func:`repro_torch.kernels.flash_attention.flash_attention_trainable`: the
hand-written kernel on the card, ``attention_ref`` on the CPU, the oracle
backward on both.  Unlike the JAX model this route needs no
``attention_impl`` and no S % 128 test, since the kernel masks a ragged last
tile.  What the route does not take (non-causal, a softcap, one token) goes
through ``_mask_bias`` and ``_sdpa``, the JAX model's ``"xla"`` route, which
computes the same function.

Not ported yet: the KV cache (decode, ROADMAP.md slice 3), cross-attention
(``kv_x``, ``cache_read_only``: the whisper family) and M-RoPE (the qwen2-vl
family), both in ROADMAP.md "Remaining model families"; each raises
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..kernels.flash_attention import flash_attention_trainable
from .config import ModelConfig
from .layers import apply_rope, dense_apply, dense_init, torch_dtype

__all__ = ["gqa_init", "gqa_apply", "AttnFn"]

NEG_INF = -1e30

AttnFn = Callable[..., torch.Tensor]


def gqa_init(gen: torch.Generator, cfg: ModelConfig, device: torch.device,
             layers: Optional[int] = None) -> Dict:
    dt = torch_dtype(cfg.dtype)
    d, hq, hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": dense_init(gen, d, hq * hd, dt, device, bias=cfg.qkv_bias, layers=layers),
        "wk": dense_init(gen, d, hk * hd, dt, device, bias=cfg.qkv_bias, layers=layers),
        "wv": dense_init(gen, d, hk * hd, dt, device, bias=cfg.qkv_bias, layers=layers),
        "wo": dense_init(gen, hq * hd, d, dt, device, layers=layers),
    }


def _mask_bias(pos_q: torch.Tensor, pos_k: torch.Tensor, causal: bool,
               window: Optional[int]) -> torch.Tensor:
    """(B, S_q, S_k) additive float32 bias from absolute positions."""
    valid = pos_k[:, None, :] >= 0
    if causal:
        valid = valid & (pos_k[:, None, :] <= pos_q[:, :, None])
    if window is not None:
        valid = valid & (pos_k[:, None, :] > pos_q[:, :, None] - window)
    zero = torch.zeros((), dtype=torch.float32, device=pos_q.device)
    return torch.where(valid, zero, zero + NEG_INF)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
          softcap: Optional[float]) -> torch.Tensor:
    """q: (B,Sq,Hk,G,D)  k/v: (B,Sk,Hk,D)  bias: (B,Sq,Sk)."""
    scale = 1.0 / np.sqrt(q.shape[-1])
    f32 = torch.float32
    logits = torch.einsum("bqhgd,bkhd->bhgqk", q.to(f32), k.to(f32)) * scale
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    logits = logits + bias[:, None, None, :, :]
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", w, v)


def gqa_apply(
    cfg: ModelConfig,
    p: Dict,
    x: torch.Tensor,                         # (B, S, d)
    positions: torch.Tensor,                 # (B, S) absolute positions
    *,
    cache: Optional[Dict] = None,
    cache_read_only: bool = False,
    kv_x: Optional[torch.Tensor] = None,
    causal: bool = True,
    window: Optional[int] = None,
    position_ids: Optional[torch.Tensor] = None,
    attn_fn: Optional[AttnFn] = None,
) -> Tuple[torch.Tensor, None]:
    """Self-attention over ``x`` with no cache.  Returns ``(out (B,S,d),
    None)``.  ``attn_fn`` replaces the kernel route's attention (the plain
    version, to hold the kernel's path against it on the card)."""
    if cache is not None or cache_read_only:
        raise NotImplementedError(
            "attention with a KV cache is not ported yet (ROADMAP.md, queue 1, "
            "slice 3 and 'Remaining model families')")
    if kv_x is not None:
        raise NotImplementedError(
            "cross-attention (kv_x) is not ported yet (ROADMAP.md, queue 1, "
            "'Remaining model families': whisper)")
    if cfg.rope == "mrope" and position_ids is not None:
        raise NotImplementedError(
            "M-RoPE is not ported yet (ROADMAP.md, queue 1, 'Remaining model "
            "families': qwen2-vl)")
    B, S, d = x.shape
    hq, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    q = dense_apply(p["wq"], x).reshape(B, S, hq, hd)
    k = dense_apply(p["wk"], x).reshape(B, S, hk, hd)
    v = dense_apply(p["wv"], x).reshape(B, S, hk, hd)
    if cfg.rope != "none":
        q, k = apply_rope(q, k, positions, cfg.rope_theta)

    if causal and cfg.attn_logit_softcap is None and S > 1:
        fn = attn_fn or flash_attention_trainable
        out = fn(q.contiguous(), k.contiguous(), v.contiguous(), causal=True, window=window)
    else:
        bias = _mask_bias(positions, positions, causal=causal, window=window)
        out = _sdpa(q.reshape(B, S, hk, hq // hk, hd), k, v, bias, cfg.attn_logit_softcap)
    return dense_apply(p["wo"], out.reshape(B, S, hq * hd)), None
