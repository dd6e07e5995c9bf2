"""Plain PyTorch versions of the port's kernels.

Each function is the mathematical ground truth its kernel is held against,
on the CPU in the tests and on the card in ``chip_smoke.py``.  A wrapper
takes the plain version only for tensors that lie on the CPU.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .cast import astype

__all__ = ["attention_ref", "decode_attention_ref", "rwkv6_ref", "bf16_split_ref"]


def attention_ref(
    q: torch.Tensor,            # (B, S, Hq, D)
    k: torch.Tensor,            # (B, S, Hk, D)
    v: torch.Tensor,            # (B, S, Hk, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Naive GQA attention (full S x S score materialisation): scores in
    float32, masked to -1e30, softmax in float32, the weights rounded to
    v's dtype before the product with v.  Returns ``(B, S, Hq, D)``."""
    B, S, Hq, D = q.shape
    Hk = k.shape[2]
    g = Hq // Hk
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qg = q.reshape(B, S, Hk, g, D)
    f32 = torch.float32
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(f32), k.to(f32)) * scale
    pos = torch.arange(S, device=q.device)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window is not None:
        mask &= pos[None, :] > pos[:, None] - window
    logits = torch.where(mask, logits, torch.full((), -1e30, dtype=f32, device=q.device))
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v)
    return out.reshape(B, S, Hq, D)


def decode_attention_ref(
    q: torch.Tensor,            # (B, Hq, D)       single query token
    k: torch.Tensor,            # (B, C, Hk, D)    cache
    v: torch.Tensor,            # (B, C, Hk, D)
    lengths: torch.Tensor,      # (B,) valid cache lengths
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Naive single-token GQA decode over a padded KV cache: k and v cast
    to q's dtype first as JAX casts them (:func:`~.cast.astype`: a float8 or
    a narrower cache widened exactly, a float32 one rounded to q's bf16),
    scores in float32, slots ``j >= lengths[b]`` masked to -1e30, softmax in
    float32, the weights rounded to q's dtype before the product with v.
    Returns ``(B, Hq, D)``."""
    k, v = astype(k, q.dtype), astype(v, q.dtype)
    B, Hq, D = q.shape
    C, Hk = k.shape[1], k.shape[2]
    g = Hq // Hk
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qg = q.reshape(B, Hk, g, D)
    f32 = torch.float32
    logits = torch.einsum("bhgd,bkhd->bhgk", qg.to(f32), k.to(f32)) * scale
    valid = torch.arange(C, device=q.device)[None, :] < lengths[:, None]     # (B, C)
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.full((), -1e30, dtype=f32, device=q.device))
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhgk,bkhd->bhgd", w, v)
    return out.reshape(B, Hq, D)


def rwkv6_ref(
    r: torch.Tensor,            # (B, T, H, N)
    k: torch.Tensor,            # (B, T, H, N)
    v: torch.Tensor,            # (B, T, H, N)
    w: torch.Tensor,            # (B, T, H, N) per-channel decay in (0, 1)
    u: torch.Tensor,            # (H, N) bonus
    S0: torch.Tensor,           # (B, H, N, N) initial state [k-dim, v-dim]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact sequential RWKV6 WKV recurrence, for any ``T``:

        y_t = r_t . (S_{t-1} + u * k_t (x) v_t)
        S_t = diag(w_t) S_{t-1} + k_t (x) v_t

    Returns ``(y (B,T,H,N) in r's dtype, S_T (B,H,N,N) float32)``.
    """
    f32 = torch.float32
    rs, ks, vs, ws = (a.to(f32) for a in (r, k, v, w))
    uf = u.to(f32)[..., :, None]
    S = S0.to(f32)
    ys = []
    for t in range(r.shape[1]):
        kv = ks[:, t, :, :, None] * vs[:, t, :, None, :]          # (B,H,N,N)
        ys.append(torch.einsum("bhi,bhij->bhj", rs[:, t], S + uf * kv))
        S = ws[:, t, :, :, None] * S + kv
    y = torch.stack(ys, dim=1) if ys else rs.new_zeros(rs.shape)
    return y.to(r.dtype), S


def bf16_split_ref(g: torch.Tensor) -> torch.Tensor:
    """``g`` ``(rows, cols)`` float32 as three bfloat16 pieces, ``(rows, 3,
    cols)``: ``hi = bf16(g)``, ``mid = bf16(g - hi)``, ``lo = bf16(g - hi -
    mid)``, each rounded to nearest even.  ``hi + mid + lo == g`` bit for bit
    wherever ``|g| >= 2**-110`` or ``g == 0`` (three 8-bit significands cover
    float32's 24; below, ``lo`` rounds to a multiple of bf16's least
    subnormal, ``2**-133``)."""
    bf16 = torch.bfloat16
    hi = g.to(bf16)
    r = g - hi.to(g.dtype)
    mid = r.to(bf16)
    return torch.stack([hi, mid, (r - mid.to(g.dtype)).to(bf16)], dim=1)
