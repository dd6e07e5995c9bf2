"""Grouped-query attention (GQA), with and without a KV cache.

The counterpart of the GQA part of the JAX package's ``models/attention.py``,
with its cache layout: per layer ``{"k", "v": (B, C, Hk, D), "pos": (B, C)
int32}``, ``pos`` holding each slot's absolute position (-1 = empty); a
global cache writes position ``p`` at slot ``clip(p, 0, C-1)``, a windowed
one is a ring buffer at ``p % C``.  The cache is written in place.

Routes.  The JAX model sends only a causal prefill *without* a cache to its
kernel and computes everything else with ``_mask_bias`` + ``_sdpa`` over
the cache.  The port sends two more cases to kernels, where they compute
the same function:

* No cache (training), causal, no softcap, S > 1:
  :func:`~repro_torch.kernels.flash_attention.flash_attention_trainable`
  (the kernel on the card, ``attention_ref`` on the CPU, the oracle
  backward on both).  It needs no ``attention_impl`` and no S % 128 test,
  since the kernel masks a ragged last tile.

The other two hold only where the caller vouches, with ``gapless=True``,
that each row's new tokens are the next ones of the sequence its cache
holds from position 0, with no gap, and that a call of more than one token
starts that sequence: ``LM.prefill`` (positions ``0..S-1``, which
``LM.backbone`` makes itself) and ``LM.decode_step`` (position ``p`` after
``0..p-1``, as the ``ServingEngine`` drives it).  Any other call, such as a
chunked prefill or a step at a position past a gap, takes the JAX route.

* A cache, no softcap, 1 < S <= C, gapless: a prefill from position 0.
  It writes positions ``0..S-1`` (at slots ``0..S-1``, in a global cache
  and in a ring alike, since S <= C); every other slot holds -1 or a
  position >= S, which causality masks, so attention over the cache is
  causal attention over the S new tokens: the same kernel route, with the
  window (which masks nothing there: S <= C <= window), then the write.
* A cache, no softcap, S == 1, gapless: a decode step at position ``p``.
  In every slot the ``ServingEngine`` decodes (a fresh request, a reused
  slot that a splice has overwritten, an idle slot whose position has run
  past C), slots ``[0, min(p + 1, C))`` hold positions <= p and the others
  -1 or positions > p, so ``_mask_bias`` admits exactly those: this is
  :func:`~repro_torch.kernels.ops.decode_attention` (the flash-decode kernel
  on the card, ``decode_attention_ref`` on the CPU) with ``lengths =
  min(pos + 1, C)``, after the write.  In a global cache a position past
  the end is written to the last slot.  A windowed cache is a ring of C =
  ``min(capacity, window)`` slots written at ``p % C``: before the wrap it
  is a global cache; once a gapless row has passed C, its C slots hold
  positions ``p-C+1 .. p`` (slot order is not position order, and
  attention does not care), every one inside the window since C <= window,
  so ``lengths = C`` admits exactly what ``_mask_bias`` does.  A ring wider
  than its window (a cache made elsewhere) takes the JAX route.

``tests/test_torch_decode.py::test_cache_routes_equal_the_mask_bias_route``
holds each cache route, global and ring, against ``_mask_bias`` + ``_sdpa``
over the same cache.  ``attn_fn`` and ``decode_fn`` replace the two kernels
(the plain versions, to hold the kernels' path against them on the card).
What the routes do not take (non-causal, a softcap, one token without a
cache, a prefill longer than the cache, a cache not vouched gapless) goes
through ``_mask_bias`` + ``_sdpa``, the JAX route.  A prefill longer than a
ring writes S positions into C slots, so the early queries lose their keys
and duplicate slots scatter in no fixed order, as in the JAX model
(ROADMAP.md, "Known reference faults").

M-RoPE (qwen2-vl): with ``cfg.rope == "mrope"`` and ``position_ids`` (3, B,
S) given, q and k are rotated by :func:`~repro_torch.models.layers.apply_mrope`;
otherwise by RoPE on ``positions``, as in the JAX model.  Only the rotation
reads ``position_ids``: the masks and the cache slots still come from
``positions``, so every kernel route above stays valid under M-RoPE.

Cross-attention (whisper's decoder), as in the JAX model: with ``kv_x``
(B, Sk, d) and ``kv_positions`` (B, Sk), K and V are projected from
``kv_x`` with no rotation, written at ``clip(kv_pos, 0, C-1)`` when a cache
is given, and attended with a non-causal mask; with ``cache_read_only``,
K, V and their positions are read from the cache and only Q is computed.
Both go through ``_mask_bias`` + ``_sdpa``: they reach no Pallas kernel in
the JAX model, and the kernel routes above need causal self-attention.

MLA (Multi-head Latent Attention, DeepSeek-V3) caches only the compressed
latent ``ckv`` and the shared RoPE key ``krope`` (per layer ``{"ckv": (B,
C, rank), "krope": (B, C, dr), "pos": (B, C)}``), and decodes in the
*absorbed* form, in latent space.  It reaches no Pallas kernel in the JAX
model, so it is plain torch here and takes no kernel route.  A prefill the
caller vouches gapless attends over its own keys, not the cache's slots;
on the card the scores against the keys every head shares are one 16-bit
product with a float32 output (:func:`_shared_key_scores`).

A cache in another dtype than the model's (``kv_dtype``: float8_e4m3fn or
float8_e5m2, written through ``uint8`` views; or float32, bfloat16 or
float16) holds the keys and values rounded as the JAX model rounds them on
write (:func:`~repro_torch.models.layers.astype`, bit for bit with
``jnp.astype``, NaN beyond float8_e4m3fn's range included).  Every route
attends over the stored values read back in q's dtype, as the JAX route
does (``cache.astype(q.dtype)``): a prefill through the attention kernel
over the new keys and values rounded to ``kv_dtype`` and cast back (the
slots it just wrote), a decode step through the decode kernel over the
cache itself (the kernel converts each tile as it lands; the cache is
never copied), the JAX route over ``astype(cache, q.dtype)``.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..kernels import ops
from ..kernels.flash_attention import flash_attention_trainable
from .config import ModelConfig
from .layers import (FLOAT8, Layers, apply_mrope, apply_rope, astype, dense_apply, dense_init,
                     torch_dtype)

__all__ = ["gqa_init", "gqa_apply", "make_cache", "mla_init", "mla_apply", "make_mla_cache",
           "AttnFn", "DecodeFn"]

NEG_INF = -1e30

AttnFn = Callable[..., torch.Tensor]
DecodeFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def gqa_init(gen: torch.Generator, cfg: ModelConfig, device: torch.device,
             layers: Layers = None, cross: bool = False) -> Dict:
    """Self-attention weights; ``cross`` (a decoder's cross-attention) has
    the same shapes, as in the JAX ``gqa_init``."""
    dt = torch_dtype(cfg.dtype)
    d, hq, hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": dense_init(gen, d, hq * hd, dt, device, bias=cfg.qkv_bias, layers=layers),
        "wk": dense_init(gen, d, hk * hd, dt, device, bias=cfg.qkv_bias, layers=layers),
        "wv": dense_init(gen, d, hk * hd, dt, device, bias=cfg.qkv_bias, layers=layers),
        "wo": dense_init(gen, hq * hd, d, dt, device, layers=layers),
    }


def make_cache(cfg: ModelConfig, batch: int, capacity: int, n_layers: int,
               device: torch.device, dtype: Optional[torch.dtype] = None) -> Dict:
    """Stacked-over-layers KV cache (leading axis = layer), in ``kv_dtype``
    or the model's dtype, every slot empty (a float8 cache made as zero
    bytes, which are +0 in both formats)."""
    dt = dtype or torch_dtype(cfg.kv_dtype or cfg.dtype)
    shape = (n_layers, batch, capacity, cfg.n_kv_heads, cfg.head_dim)

    def zeros():
        if dt in FLOAT8:
            return torch.zeros(shape, dtype=torch.uint8, device=device).view(dt)
        return torch.zeros(shape, dtype=dt, device=device)

    return {"k": zeros(), "v": zeros(),
            "pos": torch.full(shape[:3], -1, dtype=torch.int32, device=device)}


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


def _ring_write(cache: Dict, k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor,
                window: Optional[int]) -> None:
    """Write the new keys, values and positions (B,S,...) in place at their
    slots: ``p % C`` in a windowed ring cache, ``clip(p, 0, C-1)`` in a
    global one; cast to the cache's dtype by ``astype``, a float8 leaf
    written through a ``uint8`` view (its bytes are what the scatter moves,
    and no float8 scatter kernel is needed)."""
    C = cache["k"].shape[1]
    slots = positions % C if window is not None else positions.clamp(0, C - 1)
    b_idx = torch.arange(slots.shape[0], device=slots.device)[:, None]
    for key, new in (("k", k), ("v", v), ("pos", positions)):
        leaf, new = cache[key], astype(new, cache[key].dtype)
        if leaf.dtype in FLOAT8:
            leaf, new = leaf.view(torch.uint8), new.view(torch.uint8)
        leaf[b_idx, slots] = new


def gqa_apply(
    cfg: ModelConfig,
    p: Dict,
    x: torch.Tensor,                         # (B, S, d)
    positions: torch.Tensor,                 # (B, S) absolute positions
    *,
    cache: Optional[Dict] = None,            # per-layer cache (no layer axis)
    cache_read_only: bool = False,           # cross-attention decode: K/V from the cache
    kv_x: Optional[torch.Tensor] = None,     # cross-attention source (B, Sk, d)
    kv_positions: Optional[torch.Tensor] = None,
    causal: bool = True,
    window: Optional[int] = None,
    position_ids: Optional[torch.Tensor] = None,   # (3, B, S) for M-RoPE
    attn_fn: Optional[AttnFn] = None,
    decode_fn: Optional[DecodeFn] = None,
    gapless: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Attention over ``x`` (or, for cross-attention, from ``x`` to ``kv_x``
    or to a read-only cache), reading and writing ``cache`` if one is
    given.  Returns ``(out (B,S,d), cache)``; the cache is updated in place
    (None without one).  ``gapless`` vouches that each row's tokens are
    the next ones of its cached sequence from position 0, with no gap, and
    that more than one token starts it; the kernel routes over a cache need
    that.  ``attn_fn`` replaces the attention kernel's route and
    ``decode_fn`` the decode kernel's (see the module docstring)."""
    B, S, d = x.shape
    hq, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    q = dense_apply(p["wq"], x).reshape(B, S, hq, hd)
    if cache_read_only:
        if cache is None or kv_x is not None:
            raise ValueError("cache_read_only reads K and V from a cache, and takes no kv_x")
        bias = _mask_bias(positions, cache["pos"], causal=causal, window=window)
        out = _sdpa(q.reshape(B, S, hk, hq // hk, hd), astype(cache["k"], q.dtype),
                    astype(cache["v"], q.dtype), bias, cfg.attn_logit_softcap)
        return dense_apply(p["wo"], out.reshape(B, S, hq * hd)), cache

    src = x if kv_x is None else kv_x
    k = dense_apply(p["wk"], src).reshape(B, -1, hk, hd)
    v = dense_apply(p["wv"], src).reshape(B, -1, hk, hd)
    k_pos = positions if kv_x is None else kv_positions
    if cfg.rope != "none" and kv_x is None:
        if cfg.rope == "mrope" and position_ids is not None:
            q, k = apply_mrope(q, k, position_ids, cfg.rope_theta, cfg.mrope_sections)
        else:
            q, k = apply_rope(q, k, positions, cfg.rope_theta)
    if cache is not None:
        # rounded as the cache holds them: the prefill route attends over these
        k, v = astype(k, cache["k"].dtype), astype(v, cache["k"].dtype)
        _ring_write(cache, k, v, k_pos, window)

    kernel_ok = causal and kv_x is None and cfg.attn_logit_softcap is None
    over_cache = (gapless and cache is not None
                  and (window is None or cache["k"].shape[1] <= window))
    if kernel_ok and S > 1 and (cache is None or over_cache and S <= cache["k"].shape[1]):
        fn = attn_fn or flash_attention_trainable
        out = fn(q.contiguous(), astype(k, q.dtype).contiguous(),
                 astype(v, q.dtype).contiguous(), causal=True, window=window)
    elif kernel_ok and over_cache and S == 1:
        lengths = (positions[:, 0] + 1).clamp(max=cache["k"].shape[1]).to(torch.int32)
        out = (decode_fn or ops.decode_attention)(q[:, 0].contiguous(), cache["k"],
                                                  cache["v"], lengths)
    else:
        if cache is not None:
            k, v, k_pos = astype(cache["k"], q.dtype), astype(cache["v"], q.dtype), cache["pos"]
        bias = _mask_bias(positions, k_pos, causal=causal and kv_x is None, window=window)
        out = _sdpa(q.reshape(B, S, hk, hq // hk, hd), k, v, bias, cfg.attn_logit_softcap)
    return dense_apply(p["wo"], out.reshape(B, S, hq * hd)), cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3)
# ---------------------------------------------------------------------------
def mla_init(gen: torch.Generator, cfg: ModelConfig, device: torch.device,
             layers: Optional[int] = None) -> Dict:
    m = cfg.mla
    dt = torch_dtype(cfg.dtype)
    d, H = cfg.d_model, cfg.n_heads
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    lead = () if layers is None else (layers,)

    def ones(n):
        return {"scale": torch.ones(lead + (n,), dtype=dt, device=device)}

    if m.q_lora_rank:
        q = {"wdq": dense_init(gen, d, m.q_lora_rank, dt, device, layers=layers),
             "q_norm": ones(m.q_lora_rank),
             "wuq": dense_init(gen, m.q_lora_rank, H * qk_head, dt, device, layers=layers)}
    else:       # no low-rank step: one product d -> H * (nope + rope)
        q = {"wq": dense_init(gen, d, H * qk_head, dt, device, layers=layers)}
    return {
        **q,
        "wdkv": dense_init(gen, d, m.kv_lora_rank + m.qk_rope_head_dim, dt, device,
                           layers=layers),
        "kv_norm": ones(m.kv_lora_rank),
        "wuk": dense_init(gen, m.kv_lora_rank, H * m.qk_nope_head_dim, dt, device,
                          layers=layers),
        "wuv": dense_init(gen, m.kv_lora_rank, H * m.v_head_dim, dt, device, layers=layers),
        "wo": dense_init(gen, H * m.v_head_dim, d, dt, device, layers=layers),
    }


def make_mla_cache(cfg: ModelConfig, batch: int, capacity: int, n_layers: int,
                   device: torch.device) -> Dict:
    """Stacked-over-layers latent cache in the model's dtype, every slot empty."""
    m = cfg.mla
    dt = torch_dtype(cfg.dtype)
    lead = (n_layers, batch, capacity)
    return {
        "ckv": torch.zeros(lead + (m.kv_lora_rank,), dtype=dt, device=device),
        "krope": torch.zeros(lead + (m.qk_rope_head_dim,), dtype=dt, device=device),
        "pos": torch.full(lead, -1, dtype=torch.int32, device=device),
    }


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return y.to(x.dtype) * scale


def _shared_key_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``q . k`` in float32 for keys every head shares: q (B, S, H, D), k (B,
    K, D) -> (B, H, S, K).  On a CUDA device a 16-bit q and k go through
    one batched product with a float32 output (each product exact, summed in
    float32), which reads the keys once; elsewhere both are cast to float32
    first (the JAX route's einsum), which on the card copies every key."""
    B, S, H, D = q.shape
    if q.is_cuda and q.dtype in (torch.bfloat16, torch.float16) and k.dtype == q.dtype:
        qh = q.transpose(1, 2).reshape(B, H * S, D)
        return torch.bmm(qh, k.transpose(1, 2), out_dtype=torch.float32).view(B, H, S, -1)
    return torch.einsum("bshd,bkd->bhsk", q.to(torch.float32), k.to(torch.float32))


def mla_apply(
    cfg: ModelConfig,
    p: Dict,
    x: torch.Tensor,                         # (B, S, d)
    positions: torch.Tensor,                 # (B, S) absolute positions
    *,
    cache: Optional[Dict] = None,            # per-layer latent cache (no layer axis)
    absorbed: Optional[bool] = None,
    gapless: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """MLA attention.  ``absorbed=None`` picks as the JAX function does: the
    expanded form for prefill and training (S > 1, or no cache), the
    absorbed latent-space form for a decode step (S == 1 with a cache).
    The cache is written in place at ``clip(p, 0, C-1)``.  ``gapless``
    vouches, as for :func:`gqa_apply`, that a call of more than one token
    starts its rows' sequences at position 0: a prefill of 1 < S <= C
    tokens then attends over its own S new tokens alone (every other slot
    of the cache holds -1 or a position >= S, which causality masks), not
    over the C slots."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    dn, dr, dv, rank = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim, m.kv_lora_rank
    if absorbed is None:
        absorbed = S == 1 and cache is not None
    f32 = torch.float32

    # -- queries: through the low-rank step and its norm, or one product
    if m.q_lora_rank:
        cq = _rms(dense_apply(p["wdq"], x), p["q_norm"]["scale"], cfg.norm_eps)
        q = dense_apply(p["wuq"], cq).reshape(B, S, H, dn + dr)
    else:
        q = dense_apply(p["wq"], x).reshape(B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]

    # -- compressed KV
    dkv = dense_apply(p["wdkv"], x)
    ckv = _rms(dkv[..., :rank], p["kv_norm"]["scale"], cfg.norm_eps)   # (B,S,rank)
    # RoPE, decoupled: on q_rope and the one shared k_rope
    q_rope, k_rope_new = apply_rope(q_rope, dkv[..., rank:][..., None, :], positions,
                                    cfg.rope_theta)
    k_rope_new = k_rope_new[..., 0, :]                          # (B,S,dr)

    k_pos = positions
    if cache is not None:
        C = cache["ckv"].shape[1]
        slots = positions.clamp(0, C - 1)
        b_idx = torch.arange(B, device=x.device)[:, None]
        for key, new in (("ckv", ckv), ("krope", k_rope_new), ("pos", positions)):
            cache[key][b_idx, slots] = new.to(cache[key].dtype)
    if cache is not None and not (gapless and 1 < S <= cache["ckv"].shape[1]):
        ckv_all, k_rope_all, k_pos = cache["ckv"], cache["krope"], cache["pos"]
    else:       # no cache, or a gapless prefill: the new tokens are every key
        ckv_all, k_rope_all = ckv, k_rope_new

    bias = _mask_bias(positions, k_pos, causal=True, window=None)
    scale = 1.0 / np.sqrt(dn + dr)
    wuk = p["wuk"]["w"].reshape(rank, H, dn)
    wuv = p["wuv"]["w"].reshape(rank, H, dv)
    s_rope = _shared_key_scores(q_rope, k_rope_all)

    if absorbed:
        # q_nope . k_nope = (W_uk^T q_nope) . c_kv: stay in rank space
        q_lat = torch.einsum("bshd,rhd->bshr", q_nope, wuk)     # (B,S,H,rank)
        s_nope = _shared_key_scores(q_lat, ckv_all)
        logits = (s_nope + s_rope) * scale + bias[:, None, :, :]
        w = torch.softmax(logits, dim=-1).to(x.dtype)
        ctx_lat = torch.einsum("bhsk,bkr->bshr", w, ckv_all)     # (B,S,H,rank)
        out = torch.einsum("bshr,rhd->bshd", ctx_lat, wuv)       # (B,S,H,dv)
    else:
        k_nope = torch.einsum("bkr,rhd->bkhd", ckv_all, wuk)     # (B,K,H,dn)
        vv = torch.einsum("bkr,rhd->bkhd", ckv_all, wuv)         # (B,K,H,dv)
        s_nope = torch.einsum("bshd,bkhd->bhsk", q_nope.to(f32), k_nope.to(f32))
        logits = (s_nope + s_rope) * scale + bias[:, None, :, :]
        w = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.einsum("bhsk,bkhd->bshd", w, vv)

    return dense_apply(p["wo"], out.reshape(B, S, H * dv)), cache
