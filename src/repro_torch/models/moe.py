"""Mixture-of-Experts layer: shared + routed experts, two dispatch modes.

The counterpart of the JAX package's ``models/moe.py``, with its parameter
layout, so JAX weights load as they are.  Supports Qwen1.5-MoE-A2.7B (4
shared + 60 routed, top-4, softmax router) and DeepSeek-V3 (1 shared + 256
routed, top-8, sigmoid router with normalised gates).

Dispatch modes, as in the JAX package:

``einsum``  capacity dispatch through one-hot tensors: tokens are grouped,
            a (G, s, E, C) dispatch tensor routes them into per-expert
            buffers by a batched product, and a combine tensor that carries
            the gates brings the expert outputs back.  The default, and the
            route the port serves.
``sort``    tokens are sorted by expert id, written into (E*C, d) buffers at
            computed slots, and combined with a scatter-add.

Both drop the claims routed beyond an expert's capacity ``C = ceil(
tokens_per_group * top_k * capacity_factor / E)``, with the JAX package's
priority: claims are taken k-major (every token's first choice, then every
token's second, ...), in token order within each.  So a token's output
depends on the other tokens of its group, as in the JAX model.

``dropless``  the port's alone: every claim is computed, so a token's output
            depends on it alone, as in DeepSeek-V3-style inference.  The
            claims are sorted by expert and the experts' products run as
            grouped products over their rows (``_dispatch_dropless``).

The routing and dispatch are plain torch; the expert products are batched
matrix products (``torch.einsum``), which the JAX package computes with
``jnp.einsum`` outside any Pallas kernel.  Three places where torch and JAX
differ are pinned down:

* ``jax.lax.top_k`` gives a tie to the lower index; the router takes the
  first ``top_k`` of a stable descending sort, which does the same.
* ``jax.nn.one_hot`` of a position outside ``[0, C)`` is a row of zeros;
  ``torch.nn.functional.one_hot`` raises, so positions are clamped and the
  row masked.
* The sort route's out-of-range writes (``mode="drop"``) and reads
  (``mode="fill"``) go to a spare row at index ``E*C``.  Its scatter-add is
  ``scatter_add_``, which on the card adds in no fixed order.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import activation, dense_apply, stacked_normal, torch_dtype

__all__ = ["moe_init", "moe_apply", "SORT_GROUPS"]

SORT_GROUPS = 32   # the JAX package's sort groups (aligned with its dp extent)


def moe_init(gen: torch.Generator, cfg: ModelConfig, device: torch.device,
             layers: Optional[int] = None) -> Dict:
    """Router, routed experts and (if any) shared experts, stacked over
    ``layers`` as the JAX model's ``vmap``-ed init stacks them: ``wi`` and
    ``wg`` (E, d, f) scaled by 1/sqrt(d), ``wo`` (E, f, d) by 1/sqrt(f); the
    shared experts one gated MLP of width ``n_shared_experts * d_expert``;
    with ``router_bias`` the router's ``bias`` (E,), zero."""
    m = cfg.moe
    dt = torch_dtype(cfg.dtype)
    d, E, f = cfg.d_model, m.n_experts, m.d_expert
    lead = () if layers is None else (layers,)
    p = {
        "router": {"w": stacked_normal(gen, lead, (d, E), 1.0 / np.sqrt(d), dt, device)},
        "experts": {
            "wi": stacked_normal(gen, lead + (E,), (d, f), 1.0 / np.sqrt(d), dt, device),
            "wg": stacked_normal(gen, lead + (E,), (d, f), 1.0 / np.sqrt(d), dt, device),
            "wo": stacked_normal(gen, lead + (E,), (f, d), 1.0 / np.sqrt(f), dt, device),
        },
    }
    if m.router_bias:        # zero, as DeepSeek-V3 starts its correction bias
        p["router"]["bias"] = torch.zeros(lead + (E,), dtype=dt, device=device)
    if m.n_shared_experts:
        fs = m.n_shared_experts * f
        p["shared"] = {
            "wi": {"w": stacked_normal(gen, lead, (d, fs), 1.0 / np.sqrt(d), dt, device)},
            "wg": {"w": stacked_normal(gen, lead, (d, fs), 1.0 / np.sqrt(d), dt, device)},
            "wo": {"w": stacked_normal(gen, lead, (fs, d), 1.0 / np.sqrt(fs), dt, device)},
        }
    return p


def _router(cfg: ModelConfig, p: Dict, x2d: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x2d: (T, d) -> (gates (T,K) in x's dtype, idx (T,K) int64, probs (T,E)
    float32).  Logits in float32; softmax (Qwen) or sigmoid (DeepSeek-V3),
    then the top k, ties to the lower index, and gates renormalised.  With
    ``router_bias`` the experts are chosen by ``probs + bias`` and gated by
    ``probs`` at the chosen ones; the normalised gates are multiplied by
    ``routed_scaling`` where it is not 1."""
    m = cfg.moe
    logits = x2d.to(torch.float32) @ p["router"]["w"].to(torch.float32)
    if m.router_act == "sigmoid":
        probs = torch.sigmoid(logits)
    else:
        probs = torch.softmax(logits, dim=-1)
    if m.router_bias:
        choice = probs + p["router"]["bias"].to(torch.float32)
        idx = torch.sort(choice, dim=-1, descending=True, stable=True)[1][:, :m.top_k]
        gates = probs.gather(1, idx)
    else:
        gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        gates, idx = gates[:, :m.top_k], idx[:, :m.top_k]
    gates = gates / (gates.sum(dim=-1, keepdim=True) + 1e-9)
    if m.routed_scaling != 1.0:
        gates = gates * m.routed_scaling
    return gates.to(x2d.dtype), idx, probs


def _expert_ffn(cfg: ModelConfig, experts: Dict, xe: torch.Tensor) -> torch.Tensor:
    """Batched per-expert gated FFN.  xe: (E, C, d) -> (E, C, d)."""
    act = activation(cfg.act)
    h = torch.einsum("ecd,edf->ecf", xe, experts["wi"])
    g = torch.einsum("ecd,edf->ecf", xe, experts["wg"])
    return torch.einsum("ecf,efd->ecd", act(g) * h, experts["wo"])


def _aux_loss(probs: torch.Tensor, idx: torch.Tensor, E: int) -> torch.Tensor:
    """Switch-style load-balance loss ``E * sum_e f_e * p_e``, float32."""
    onehot = F.one_hot(idx, E).to(torch.float32)              # (T,K,E)
    f = onehot.sum(dim=(0, 1)) / onehot.sum().clamp(min=1.0)
    pmean = probs.mean(dim=0)
    pbar = pmean / pmean.sum().clamp(min=1e-9)
    return E * (f * pbar).sum()


def _capacity(s: int, cfg: ModelConfig) -> int:
    m = cfg.moe
    return max(int(math.ceil(s * m.top_k * m.capacity_factor / m.n_experts)), 1)


def _dispatch_einsum(cfg: ModelConfig, p: Dict, x2d: torch.Tensor, gates: torch.Tensor,
                     idx: torch.Tensor) -> torch.Tensor:
    m = cfg.moe
    T, d = x2d.shape
    E, K = m.n_experts, m.top_k
    s = min(m.group_size, T)
    while T % s != 0:
        s -= 1
    G = T // s
    C = _capacity(s, cfg)

    xg = x2d.reshape(G, s, d)
    idx_g = idx.reshape(G, s, K)
    gates_g = gates.reshape(G, s, K)

    # position of each (token, k) claim inside its expert, priority = (k, s)
    mask = F.one_hot(idx_g, E)                                  # (G,s,K,E)
    mask_kf = mask.transpose(1, 2).reshape(G, K * s, E)         # k-major priority
    pos_kf = torch.cumsum(mask_kf, dim=1) * mask_kf - 1         # (G,Ks,E)
    pos = pos_kf.reshape(G, K, s, E).transpose(1, 2)            # (G,s,K,E)
    keep = (pos >= 0) & (pos < C)

    # one_hot(pos, C) with the out-of-range rows zero, as jax.nn.one_hot gives
    disp = F.one_hot(pos.clamp(0, C - 1), C).to(x2d.dtype) * keep[..., None].to(x2d.dtype)
    disp_se = disp.sum(dim=2)                                   # (G,s,E,C)
    comb = (disp * gates_g[..., None, None]).sum(dim=2)         # (G,s,E,C)

    xe = torch.einsum("gsec,gsd->gecd", disp_se, xg)            # (G,E,C,d)
    xe = xe.transpose(0, 1).reshape(E, G * C, d)
    ye = _expert_ffn(cfg, p["experts"], xe)
    ye = ye.reshape(E, G, C, d).transpose(0, 1)                 # (G,E,C,d)
    y = torch.einsum("gsec,gecd->gsd", comb, ye)
    return y.reshape(T, d)


def _dispatch_sort(cfg: ModelConfig, p: Dict, x2d: torch.Tensor, gates: torch.Tensor,
                   idx: torch.Tensor) -> torch.Tensor:
    """Sort-based dispatch, group-local as in the JAX package: each of G
    groups sorts its own (s*K,) expert ids and writes into its own (E, C, d)
    buffer; the JAX ``vmap`` over groups is a batch dimension here."""
    m = cfg.moe
    T, d = x2d.shape
    E, K = m.n_experts, m.top_k
    G = SORT_GROUPS
    while T % G != 0:
        G //= 2
    s = T // G
    C = _capacity(s, cfg)
    dev = x2d.device

    xg = x2d.reshape(G, s, d)
    eid = idx.reshape(G, s * K)
    tok = torch.arange(s, device=dev).repeat_interleave(K).expand(G, s * K)
    gat = gates.reshape(G, s * K)
    order = torch.argsort(eid, dim=1, stable=True)
    s_eid, s_tok, s_gat = eid.gather(1, order), tok.gather(1, order), gat.gather(1, order)
    experts = torch.arange(E, device=dev, dtype=s_eid.dtype).expand(G, E).contiguous()
    seg_start = torch.searchsorted(s_eid.contiguous(), experts)             # (G,E)
    pos_in_seg = torch.arange(s * K, device=dev) - seg_start.gather(1, s_eid)
    valid = pos_in_seg < C
    slot = torch.where(valid, s_eid * C + pos_in_seg, E * C)                # E*C = dropped
    g_idx = torch.arange(G, device=dev)[:, None]

    # row E*C is the spare that takes the dropped writes and gives zeros back
    buf = torch.zeros((G, E * C + 1, d), dtype=x2d.dtype, device=dev)
    buf[g_idx, slot] = xg[g_idx, s_tok]
    xe = buf[:, :E * C].reshape(G, E, C, d).transpose(0, 1).reshape(E, G * C, d)
    ye = _expert_ffn(cfg, p["experts"], xe)
    ye = ye.reshape(E, G, C, d).transpose(0, 1).reshape(G, E * C, d)
    ye = torch.cat([ye, ye.new_zeros((G, 1, d))], dim=1)

    gathered = torch.where(valid[..., None], ye[g_idx, slot], 0.0)
    y = torch.zeros((G, s, d), dtype=x2d.dtype, device=dev)
    y.scatter_add_(1, s_tok[..., None].expand(G, s * K, d), gathered * s_gat[..., None])
    return y.reshape(T, d)


def _dispatch_dropless(cfg: ModelConfig, p: Dict, x2d: torch.Tensor, gates: torch.Tensor,
                       idx: torch.Tensor, load: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Every claim computed, whatever the load: the T*K claims sorted by
    expert (stably, so token order within an expert), each expert's rows
    found by a search of the sorted ids, the three products of all experts
    as grouped products over those rows (``torch._grouped_mm``: one
    launch a product, each expert's rows against its own matrix), and each
    token's K outputs weighted by its gates in one batched product.  The
    sizes are T*K rows whatever the routing, and the offsets stay on the
    device: no host sync, so a decode step with this route is captured as a
    CUDA graph like any other."""
    m = cfg.moe
    T, d = x2d.shape
    E, K = m.n_experts, m.top_k
    flat = idx.reshape(T * K)
    order = torch.argsort(flat, stable=True)
    ends = torch.searchsorted(flat[order], torch.arange(E, device=x2d.device), right=True)
    if load is not None:
        load += torch.diff(ends, prepend=ends.new_zeros(1))
    offs = ends.to(torch.int32)
    ex = p["experts"]
    xs = x2d[order // K]                                        # (T*K, d), by expert
    h = torch._grouped_mm(xs, ex["wi"], offs=offs)
    g = torch._grouped_mm(xs, ex["wg"], offs=offs)
    ys = torch._grouped_mm(activation(cfg.act)(g) * h, ex["wo"], offs=offs)
    ye = torch.empty_like(ys)
    ye[order] = ys                                              # back in claim order
    return torch.bmm(gates.reshape(T, 1, K), ye.reshape(T, K, d)).reshape(T, d)


def moe_apply(cfg: ModelConfig, p: Dict, x: torch.Tensor, dispatch: Optional[str] = None,
              load: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y (B,S,d), aux loss, a float32 scalar).  On the
    ``dropless`` route ``load``, an (E,) integer tensor, gains the claims
    each expert computed, in place, on the device; the other routes leave
    it."""
    m = cfg.moe
    B, S, d = x.shape
    x2d = x.reshape(B * S, d)
    gates, idx, probs = _router(cfg, p, x2d)
    route = dispatch or m.dispatch
    if route == "dropless":
        y = _dispatch_dropless(cfg, p, x2d, gates, idx, load)
    elif route == "sort":
        y = _dispatch_sort(cfg, p, x2d, gates, idx)
    else:
        y = _dispatch_einsum(cfg, p, x2d, gates, idx)
    if "shared" in p:
        act = activation(cfg.act)
        h = dense_apply(p["shared"]["wi"], x2d)
        g = dense_apply(p["shared"]["wg"], x2d)
        y = y + dense_apply(p["shared"]["wo"], act(g) * h)
    return y.reshape(B, S, d), _aux_loss(probs, idx, m.n_experts)
