"""Shared layers the RWKV6 model needs: dense projections, the final
LayerNorm and the token embedding.

Plain functions on tensors, with parameters held in dictionaries laid out
as in the JAX package's ``models/layers.py``, so JAX weights load as they
are.  RMSNorm, the gated MLPs and rotary embeddings come with the families
that use them (ROADMAP.md, "Remaining model families").
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from .config import ModelConfig

__all__ = ["torch_dtype", "dense_apply", "norm_init", "norm_apply", "embed_init"]


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype for a config's dtype name (``"bfloat16"``, ...)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def dense_apply(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def norm_init(cfg: ModelConfig, device: torch.device,
              dim: Optional[int] = None) -> Dict[str, torch.Tensor]:
    dim = dim or cfg.d_model
    dt = torch_dtype(cfg.dtype)
    if cfg.norm == "nonparametric":
        return {}
    if cfg.norm == "rmsnorm":
        raise NotImplementedError(
            "rmsnorm is not ported yet (ROADMAP.md, 'Remaining model families')")
    p = {"scale": torch.ones(dim, dtype=dt, device=device)}
    if cfg.norm == "layernorm":            # with bias
        p["bias"] = torch.zeros(dim, dtype=dt, device=device)
    return p


def norm_apply(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis in float32, cast back, then the affine
    part in the activation dtype (the JAX ``norm_apply`` layernorm branch)."""
    if cfg.norm == "rmsnorm":
        raise NotImplementedError(
            "rmsnorm is not ported yet (ROADMAP.md, 'Remaining model families')")
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)
    if "scale" in p:
        y = y * p["scale"]
    if "bias" in p:
        y = y + p["bias"]
    return y


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype: torch.dtype,
               device: torch.device) -> Dict[str, torch.Tensor]:
    w = torch.randn((vocab, dim), generator=gen, dtype=torch.float32, device=device) * 0.02
    return {"embedding": w.to(dtype)}
