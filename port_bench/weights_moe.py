"""Random weights of a mixture-of-experts model with MLA attention and no
q-LoRA (DeepSeek-V3's layout as Moonlight-16B-A3B has it) from a run's
seed, made on the device in the dtype they are served in, one call a
stacked leaf, laid out as the port's ``LM`` takes them: ``n_dense_layers`` dense layers in a first
segment, the expert layers in a second, each leaf stacked over its
segment's layers (L):

    {"embed": {"embedding": (V, d)}, "final_norm": {"scale": (d,)},
     "segments": [{"norm1": {"scale": (L, d)}, "norm2": ...,
                   "attn": {"wq": {"w": (L, d, H*(dn+dr))},
                            "wdkv": {"w": (L, d, r+dr)}, "kv_norm": {"scale": (L, r)},
                            "wuk": {"w": (L, r, H*dn)}, "wuv": {"w": (L, r, H*dv)},
                            "wo": {"w": (L, H*dv, d)}},
                   "ffn": {"wi", "wg": {"w": (L, d, F)}, "wo": {"w": (L, F, d)}}},   dense
                  {... "ffn": {"router": {"w": (L, d, E)[, "bias": (L, E)]},
                               "experts": {"wi", "wg": (L, E, d, f), "wo": (L, E, f, d)},
                               "shared": {"wi", "wg": {"w": (L, d, S*f)},
                                          "wo": {"w": (L, S*f, d)}}}}],          experts
     "lm_head": {"w": (d, V)}}

The benchmark hands the same tensors to the port and to the reference.
Imports nothing of the program.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .weights import torch_dtype

__all__ = ["make_moe"]


def make_moe(m: Dict, seed: int, device: torch.device) -> Dict:
    """Weights of the model ``m`` (a configuration's ``model`` group, with
    its ``mla`` and ``moe`` groups) from ``seed``: products N(0, 1/fan_in),
    embedding and head N(0, 0.02^2), the router's selection bias N(0,
    0.02^2) (so that it changes some choices), norm scales 1."""
    if m.get("attention") != "mla" or not m.get("moe") or m["mla"].get("q_lora_rank"):
        raise ValueError("make_moe makes the weights of a mixture of experts with MLA "
                         "and no q-LoRA")
    dt = torch_dtype(m["dtype"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2 ** 64)
    d, H, V = m["d_model"], m["n_heads"], m["vocab"]
    mla, moe = m["mla"], m["moe"]
    dn, dr, dv, r = (mla["qk_nope_head_dim"], mla["qk_rope_head_dim"], mla["v_head_dim"],
                     mla["kv_lora_rank"])
    E, f = moe["n_experts"], moe["d_expert"]

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, dtype=dt, device=device).mul_(scale)

    def ones(*shape):
        return {"scale": torch.ones(shape, dtype=dt, device=device)}

    def dense(lead, n_in, n_out):
        return {"w": normal(lead + (n_in, n_out), 1.0 / np.sqrt(n_in))}

    def segment(L: int, experts: bool) -> Dict:
        lead = (L,)
        attn = {"wq": dense(lead, d, H * (dn + dr)), "wdkv": dense(lead, d, r + dr),
                "kv_norm": ones(L, r), "wuk": dense(lead, r, H * dn),
                "wuv": dense(lead, r, H * dv), "wo": dense(lead, H * dv, d)}
        if experts:
            fs = moe["n_shared_experts"] * f
            ffn = {"router": dense(lead, d, E),
                   "experts": {"wi": normal((L, E, d, f), 1.0 / np.sqrt(d)),
                               "wg": normal((L, E, d, f), 1.0 / np.sqrt(d)),
                               "wo": normal((L, E, f, d), 1.0 / np.sqrt(f))}}
            if moe.get("router_bias"):
                ffn["router"]["bias"] = normal((L, E), 0.02)
            if fs:
                ffn["shared"] = {"wi": dense(lead, d, fs), "wg": dense(lead, d, fs),
                                 "wo": dense(lead, fs, d)}
        else:
            ffn = {"wi": dense(lead, d, m["d_ff"]), "wg": dense(lead, d, m["d_ff"]),
                   "wo": dense(lead, m["d_ff"], d)}
        return {"norm1": ones(L, d), "norm2": ones(L, d), "attn": attn, "ffn": ffn}

    n_dense = moe["n_dense_layers"]
    segments = ([segment(n_dense, False)] if n_dense else []) + [
        segment(m["n_layers"] - n_dense, True)]
    params = {"embed": {"embedding": normal((V, d), 0.02)}, "final_norm": ones(d),
              "segments": segments}
    if not m["tie_embeddings"]:
        params["lm_head"] = {"w": normal((d, V), 0.02)}
    return params
