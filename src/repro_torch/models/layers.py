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

from ..kernels import ops
from ..kernels.cast import FLOAT8, astype
from .config import ModelConfig

__all__ = [
    "torch_dtype", "Layers", "lead_axes", "stacked_normal", "dense_init", "dense_apply",
    "norm_init", "norm_apply",
    "activation", "mlp_init", "mlp_apply", "embed_init", "rope_freqs",
    "apply_rope", "apply_mrope", "FLOAT8", "astype", "HEAD_SPLIT_BYTES", "HEAD_MAX_K",
    "HeadProduct", "head_route", "head_product",
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


# -- the head's product ---------------------------------------------------------------
# the most bytes of the cotangent's bf16 pieces that the head's backward holds at once
HEAD_SPLIT_BYTES = 1 << 30
# the longest contraction one tensor-core product of the head takes: the tensor
# cores' float32 accumulation drifts from float32 sums with the length of the chain,
# so a longer one goes in pieces added in float32
HEAD_MAX_K = 4096


def head_route(h: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype) -> str:
    """How :func:`head_product` computes ``h @ w`` into ``out_dtype``:
    ``"tensor_core"`` on a CUDA device where ``h`` and ``w`` share a 16-bit
    dtype and the result is float32 (:class:`HeadProduct`); ``"upcast"``
    everywhere else, operands in another dtype than ``out_dtype`` cast to it
    first (:class:`_CastProduct`): on the CPU, where aten's ``mm`` has no
    ``out_dtype`` kernel, on meta tensors, for float32 operands and for
    logits in the operands' own dtype."""
    if (h.is_cuda and h.dtype in (torch.bfloat16, torch.float16) and w.dtype == h.dtype
            and out_dtype == torch.float32):
        return "tensor_core"
    return "upcast"


def head_product(h: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """``h (..., d) @ w (d, V)`` in ``out_dtype`` by :func:`head_route`'s
    route: the JAX model's product with ``preferred_element_type``.  Each
    product of two 16-bit values is exact in float32, so the routes differ
    only in how the sums are ordered and rounded.  ``head_product.routes``
    counts the calls by route."""
    route = head_route(h, w, out_dtype)
    head_product.routes[route] += 1
    if h.dtype == w.dtype == out_dtype:
        return h @ w
    h2d = h.reshape(-1, h.shape[-1])
    out = (HeadProduct.apply(h2d, w) if route == "tensor_core"
           else _CastProduct.apply(h2d, w, out_dtype))
    return out.view(*h.shape[:-1], w.shape[1])


head_product.routes = {"tensor_core": 0, "upcast": 0}


def _cast_grads(ctx, g: torch.Tensor):
    """The gradients of ``h.to(g.dtype) @ w.to(g.dtype)`` for the saved
    ``h`` (T, d) and ``w`` (d, V), cast back to their dtypes: the products
    autograd makes through the casts, on copies cast anew."""
    h, w = ctx.saved_tensors
    need_h, need_w = ctx.needs_input_grad[:2]
    gh = g.mm(w.to(g.dtype).t()).to(h.dtype) if need_h else None
    gw = h.to(g.dtype).t().mm(g).to(w.dtype) if need_w else None
    return gh, gw


class _CastProduct(torch.autograd.Function):
    """The upcast route: ``h.to(dt) @ w.to(dt)``, the same values as
    autograd through the casts, but saving ``h`` and ``w`` as they are and
    casting them anew in the backward, so no cast copy is held between the
    passes, as the tensor-core route holds none (the dry-run's trace on meta
    takes this route for a card's step)."""

    @staticmethod
    def forward(ctx, h, w, dt):
        ctx.save_for_backward(h, w)
        return h.to(dt) @ w.to(dt)

    @staticmethod
    def backward(ctx, g):
        return (*_cast_grads(ctx, g), None)


def _mm_f32(a: torch.Tensor, b: torch.Tensor,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``a @ b`` in float32 from 16-bit operands, added into ``out`` (float32)
    when given.  On a card cuBLAS products on the tensor cores, accumulating
    in float32, one for each :data:`HEAD_MAX_K` of the contraction, each
    added into the result in float32; elsewhere the operands cast up, the
    same exact products summed in another order."""
    if not a.is_cuda:
        prod = torch.mm(a.float(), b.float())
        return prod if out is None else out.add_(prod)
    for k0 in range(0, a.shape[1], HEAD_MAX_K):
        ak, bk = a[:, k0:k0 + HEAD_MAX_K], b[k0:k0 + HEAD_MAX_K]
        if out is None:
            out = torch.mm(ak, bk, out_dtype=torch.float32)
        else:
            torch.addmm(out, ak, bk, out_dtype=torch.float32, out=out)
    return out


class HeadProduct(torch.autograd.Function):
    """``h (T, d) @ w (d, V)`` -> float32 ``(T, V)`` from 16-bit operands,
    with an exact backward.  It saves ``h`` and ``w`` as they are, no float32
    copy.

    The backward does not round the float32 cotangent ``G``: a bf16 ``G``
    would lose 16 of its 24 bits.  It splits ``G`` into three bf16 pieces
    that sum to it (:func:`repro_torch.kernels.ops.split_bf16`, one pass) and
    multiplies the pieces on the tensor cores with float32 outputs, ``dh =
    sum_k piece_k @ w.T`` and ``dw = sum_k h.T @ piece_k``, cast once to the
    operands' dtype as the upcast route's backward casts its float32
    gradients.  The vocabulary goes in column blocks whose pieces hold at
    most :data:`HEAD_SPLIT_BYTES`; in a block the pieces are stacked along
    the contracted axis, so each gradient is one contraction: ``(T, 3n) @
    (3n, d)`` against the block of ``w.T`` repeated three times, added into
    ``dh`` in float32, and ``(d, 3T) @ (3T, n)`` against ``h`` with each row
    repeated three times, written into the block's columns of ``dw``.  With
    float16 operands the pieces would leave float16's exponent range, so the
    backward multiplies by the operands cast up, as the upcast route's does.
    On the CPU each product is emulated (:func:`_mm_f32`)."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        return _mm_f32(h, w)

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        need_h, need_w = ctx.needs_input_grad[:2]
        g = g.contiguous()
        if h.dtype != torch.bfloat16:
            return _cast_grads(ctx, g)
        T, V = g.shape
        n = min(V, max(64, HEAD_SPLIT_BYTES // (6 * T) // 64 * 64))
        gh = torch.zeros(h.shape, dtype=g.dtype, device=g.device) if need_h else None
        gw = torch.empty(w.shape, dtype=w.dtype, device=w.device) if need_w else None
        h3 = h.repeat_interleave(3, dim=0).T if need_w else None    # column 3t + k is h[t]
        for v0 in range(0, V, n):
            wb = w[:, v0:v0 + n]
            nb = wb.shape[1]
            p = ops.split_bf16(g[:, v0:v0 + nb])                       # (T, 3, nb)
            if need_h:
                _mm_f32(p.view(T, 3 * nb), wb.T.repeat(3, 1), out=gh)
            if need_w:
                gw[:, v0:v0 + nb] = _mm_f32(h3, p.view(3 * T, nb))
        return (gh.to(h.dtype) if need_h else None), gw


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
