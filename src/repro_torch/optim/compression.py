"""Gradient compression for the slow links between pods.

The counterpart of the JAX package's ``optim/compression.py``.  Between
pods the gradient reduction rides links an order of magnitude slower than
the ones inside a pod.  ``compress_gradients`` quantises each leaf to int8
with one float32 max-abs scale a leaf (stochastic rounding optional), so
the cross-pod exchange moves one byte an element; the receiver dequantises,
and the reduction inside a pod stays exact.  The train step exposes it as
``grad_compression="int8"`` and the dry-run counts its bytes.  The step
quantises leaf by leaf (``train.step._cross_pod_int8_mean``); the tree
functions ``compress_gradients`` and ``decompress_gradients`` are kept for
parity with the JAX package's API, and only the tests call them.

Rounding to nearest is the same IEEE float32 operations as the JAX
function's (a max, a division by 127, a division by the scale, round half
to even, a clip), so the two agree bit for bit.  Stochastic rounding draws
``U[0, 1)`` from an explicit ``torch.Generator``.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from ..tree import flatten_up_to, tree_flatten, tree_unflatten

__all__ = ["int8_quantize", "int8_dequantize", "compress_gradients", "decompress_gradients"]


def int8_quantize(x: torch.Tensor, generator: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantisation.  Returns ``(q, scale)``, q
    int8 in [-127, 127] and scale a float32 scalar: ``max(max|x|, 1e-12) /
    127``.  With ``generator``, y = x / scale rounds stochastically,
    ``floor(y + U[0, 1))`` (an unbiased estimate of y); without, to
    nearest, half to even."""
    xf = x.to(torch.float32)
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    y = xf / scale
    if generator is not None:
        u = torch.rand(y.shape, generator=generator, dtype=torch.float32, device=y.device)
        y = torch.floor(y + u)
    else:
        y = torch.round(y)
    return torch.clamp(y, -127, 127).to(torch.int8), scale


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def compress_gradients(grads: Any, generator: Optional[torch.Generator] = None) -> Any:
    """Quantise every leaf; returns a tree of ``{"q", "scale"}`` dicts."""
    leaves, structure = tree_flatten(grads)
    out = []
    for leaf in leaves:
        q, s = int8_quantize(leaf, generator)
        out.append({"q": q, "scale": s})
    return tree_unflatten(structure, out)


def decompress_gradients(cgrads: Any, like: Any) -> Any:
    """The dequantised tree, each leaf in the dtype of ``like``'s leaf."""
    leaves, structure = tree_flatten(like)
    packed = flatten_up_to(structure, cgrads)
    return tree_unflatten(structure, [int8_dequantize(c["q"], c["scale"], p.dtype)
                                      for c, p in zip(packed, leaves)])
