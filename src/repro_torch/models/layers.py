"""Shared layers: dense projections, norms, gated MLPs, the token embedding
and rotary embeddings.

Plain functions on tensors, with parameters held in dictionaries laid out
as in the JAX package's ``models/layers.py``, so JAX weights load as they
are.  The ``*_init`` functions take ``layers=n`` to stack ``n`` blocks' leaves
over a leading layer axis, as the JAX model's ``vmap``-ed init does, or a
tuple of leading axes (a hybrid group's ``(groups, blocks)``); matrices are
drawn one at a time (:func:`stacked_normal`), so no float32 copy of a whole
stack is made.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.cast import FLOAT8, astype
from .config import ModelConfig

__all__ = [
    "torch_dtype", "Layers", "lead_axes", "stacked_normal", "dense_init", "dense_apply",
    "norm_init", "norm_apply",
    "activation", "mlp_init", "mlp_apply", "embed_init", "rope_freqs",
    "apply_rope", "apply_mrope", "FLOAT8", "astype",
]


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype for a config's dtype name (``"bfloat16"``, ...)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


Layers = Optional[Union[int, Tuple[int, ...]]]


def lead_axes(layers: Layers) -> Tuple[int, ...]:
    """The leading stack axes ``layers`` names: none, one or a tuple."""
    if layers is None:
        return ()
    return tuple(layers) if isinstance(layers, tuple) else (layers,)


def stacked_normal(gen: torch.Generator, lead: Tuple[int, ...], shape: Tuple[int, ...],
                   scale: float, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A ``lead + shape`` tensor of normal draws times ``scale`` in ``dtype``,
    drawn one ``shape`` matrix at a time so that no float32 copy of the whole
    stack is ever made: Qwen-MoE's stacked ``wi`` is (24, 60, 2048, 1408),
    16.6 GB in float32.  On the meta device (the dry-run) nothing is drawn:
    the tensor is its shape and dtype alone."""
    out = torch.empty(lead + shape, dtype=dtype, device=device)
    if out.device.type == "meta":
        return out
    flat = out.view((-1,) + shape)
    for i in range(flat.shape[0]):
        flat[i] = (torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
                   * scale).to(dtype)
    return out


# -- dense ----------------------------------------------------------------------
def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype: torch.dtype,
               device: torch.device, bias: bool = False, scale: Optional[float] = None,
               layers: Layers = None) -> Dict[str, torch.Tensor]:
    """``w`` (in_dim, out_dim) ~ N(0, 1) * scale (1/sqrt(in_dim) unless
    given), stacked over ``layers`` one matrix at a time."""
    scale = scale if scale is not None else 1.0 / np.sqrt(in_dim)
    p = {"w": stacked_normal(gen, lead_axes(layers), (in_dim, out_dim), scale, dtype, device)}
    if bias:
        p["b"] = torch.zeros(lead_axes(layers) + (out_dim,), dtype=dtype, device=device)
    return p


def dense_apply(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


# -- normalisation ----------------------------------------------------------------
def norm_init(cfg: ModelConfig, device: torch.device, dim: Optional[int] = None,
              layers: Layers = None) -> Dict[str, torch.Tensor]:
    dim = dim or cfg.d_model
    dt = torch_dtype(cfg.dtype)
    if cfg.norm == "nonparametric":        # OLMo-style non-parametric LN
        return {}
    shape = lead_axes(layers) + (dim,)
    p = {"scale": torch.ones(shape, dtype=dt, device=device)}
    if cfg.norm == "layernorm":            # with bias
        p["bias"] = torch.zeros(shape, dtype=dt, device=device)
    return p


def norm_apply(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
               eps: Optional[float] = None) -> torch.Tensor:
    """RMSNorm or LayerNorm over the last axis in float32, cast back, then
    the affine part in the activation dtype (the JAX ``norm_apply``); eps
    ``cfg.norm_eps`` unless given."""
    eps = cfg.norm_eps if eps is None else eps
    xf = x.to(torch.float32)
    if cfg.norm == "rmsnorm":
        y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    else:
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
    y = y.to(x.dtype)
    if "scale" in p:
        y = y * p["scale"]
    if "bias" in p:
        y = y + p["bias"]
    return y


# -- activations / MLP -------------------------------------------------------------
def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu2":  # squared ReLU (Nemotron / Minitron family)
        return lambda x: F.relu(x).square()
    raise ValueError(f"unknown activation {name!r}")


def mlp_init(gen: torch.Generator, cfg: ModelConfig, device: torch.device,
             d_ff: Optional[int] = None, layers: Layers = None) -> Dict:
    d_ff = d_ff or cfg.d_ff
    dt = torch_dtype(cfg.dtype)
    p = {"wi": dense_init(gen, cfg.d_model, d_ff, dt, device, layers=layers)}
    if cfg.mlp in ("swiglu", "geglu"):
        p["wg"] = dense_init(gen, cfg.d_model, d_ff, dt, device, layers=layers)
    p["wo"] = dense_init(gen, d_ff, cfg.d_model, dt, device, layers=layers)
    return p


def mlp_apply(cfg: ModelConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    act = activation("gelu" if cfg.mlp == "geglu" else cfg.act)
    h = dense_apply(p["wi"], x)
    if "wg" in p:
        h = act(dense_apply(p["wg"], x)) * h
    else:
        h = act(h)
    return dense_apply(p["wo"], h)


# -- embeddings ----------------------------------------------------------------------
def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype: torch.dtype,
               device: torch.device) -> Dict[str, torch.Tensor]:
    w = torch.randn((vocab, dim), generator=gen, dtype=torch.float32, device=device) * 0.02
    return {"embedding": w.to(dtype)}


# -- rotary embeddings ----------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, positions: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for integer positions ``(..., S)``, each of shape
    ``(..., S, head_dim // 2)``, in float32."""
    half = head_dim // 2
    f32 = torch.float32
    inv = 1.0 / (theta ** (torch.arange(half, dtype=f32, device=positions.device) / half))
    ang = positions.to(f32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, n_heads, head_dim); cos/sin broadcastable to (..., S, 1, half)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_rope(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
               theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Standard RoPE.  q: (B,S,Hq,D), k: (B,S,Hk,D), positions: (B,S)."""
    cos, sin = rope_freqs(q.shape[-1], theta, positions)
    cos, sin = cos[..., None, :], sin[..., None, :]
    return _rotate(q, cos, sin), _rotate(k, cos, sin)


def apply_mrope(q: torch.Tensor, k: torch.Tensor, position_ids: torch.Tensor, theta: float,
                sections: Tuple[int, ...]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Qwen2-VL multimodal RoPE (arXiv:2409.12191).  ``position_ids`` (3, B, S):
    the temporal, height and width position of each token.  The head_dim/2
    frequency slots are split into ``sections`` (t, h, w), and each section
    takes its angle from its own stream, in float32.  For text the three
    streams are equal and M-RoPE is RoPE."""
    half = q.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to head_dim/2 = {half}")
    f32 = torch.float32
    inv = 1.0 / (theta ** (torch.arange(half, dtype=f32, device=q.device) / half))
    bounds = np.cumsum((0,) + tuple(sections))
    ang = torch.cat([position_ids[s].to(f32)[..., None] * inv[lo:hi]
                     for s, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:]))], dim=-1)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]   # (B,S,1,half)
    return _rotate(q, cos, sin), _rotate(k, cos, sin)
