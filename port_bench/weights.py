"""Random weights of a dense model from a run's seed, made on the device in
the dtype they are served in, one call a stacked leaf, laid out as the
port's ``LM`` takes them (the tree of the JAX ``LM.init``):

    {"embed": {"embedding": (V, d)},
     "final_norm": {"scale": (d,)[, "bias": (d,)]},
     "segments": [{"norm1": {"scale": (L, d)[, "bias"]}, "norm2": ...,
                   "attn": {"wq": {"w": (L, d, Hq*D)[, "b"]}, "wk": ..., "wv": ...,
                            "wo": {"w": (L, Hq*D, d)}},
                   "ffn": {"wi": {"w": (L, d, F)}[, "wg": ...], "wo": {"w": (L, F, d)}}}],
     ["lm_head": {"w": (d, V)}]}

The benchmark hands the same tensors to the port and to the reference.
Imports nothing of the program.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["make_dense", "torch_dtype"]


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def make_dense(m: Dict, seed: int, device: torch.device) -> Dict:
    """Weights of the dense model ``m`` (a configuration's ``model`` group)
    from ``seed``: products N(0, 1/fan_in), embedding and head N(0, 0.02^2),
    q/k/v biases N(0, 0.02^2), norm scales 1, LayerNorm biases N(0, 0.02^2)."""
    dt = torch_dtype(m["dtype"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2 ** 64)
    d, hq, hk, hd, ff, V, L = (m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"],
                               m["d_ff"], m["vocab"], m["n_layers"])

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, dtype=dt, device=device).mul_(scale)

    def dense(n_in, n_out, bias=False):
        p = {"w": normal((L, n_in, n_out), 1.0 / np.sqrt(n_in))}
        if bias:
            p["b"] = normal((L, n_out), 0.02)
        return p

    def norm(*shape):
        p = {"scale": torch.ones(shape, dtype=dt, device=device)}
        if m["norm"] == "layernorm":
            p["bias"] = normal(shape, 0.02)
        return p

    bias = bool(m.get("qkv_bias"))
    ffn = {"wi": dense(d, ff)}
    if m["mlp"] in ("swiglu", "geglu"):
        ffn["wg"] = dense(d, ff)
    ffn["wo"] = dense(ff, d)
    params = {
        "embed": {"embedding": normal((V, d), 0.02)},
        "final_norm": norm(d),
        "segments": [{
            "norm1": norm(L, d),
            "norm2": norm(L, d),
            "attn": {"wq": dense(d, hq * hd, bias), "wk": dense(d, hk * hd, bias),
                     "wv": dense(d, hk * hd, bias), "wo": dense(hq * hd, d)},
            "ffn": ffn,
        }],
    }
    if not m["tie_embeddings"]:
        params["lm_head"] = {"w": normal((d, V), 0.02)}
    return params
