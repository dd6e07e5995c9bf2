"""The yardstick's arithmetic: the card's published peaks, and the operations
and bytes an attention call, a prefill and a training step need, computed
from shapes alone.

Frozen copies, kept here so that a change to the program cannot move the
yardstick: the peaks of ``repro_torch/launch/roofline.py`` and
``chip_smoke.py`` (NVIDIA's H100 SXM data sheet, dense, at 700 W) and the
attention count of ``repro_torch/kernels/meta.py`` (``attention_work``).
Imports nothing of the program.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

# Published peaks of one H100 SXM, dense, at 700 W.
PEAK_FLOPS_BF16 = 989e12
HBM_BYTES_PER_S = 3.35e12


def _pairs(S: int, causal: bool, window: Optional[int]) -> int:
    i = np.arange(S, dtype=np.int64)
    hi = i + 1 if causal else np.full(S, S, dtype=np.int64)
    lo = np.maximum(0, i - window + 1) if window else np.zeros(S, dtype=np.int64)
    return int((hi - lo).sum())


def attention_work(B: int, S: int, Hq: int, Hk: int, D: int, elem_bytes: int,
                   causal: bool = True, window: Optional[int] = None) -> Tuple[int, int]:
    """(operations, bytes) of one attention call: q, k, v read once and o
    written once; 4*D operations for each (query head, attended pair)."""
    nbytes = (2 * B * S * Hq * D + 2 * B * S * Hk * D) * elem_bytes
    return 4 * D * _pairs(S, causal, window) * B * Hq, nbytes


def least_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations at
    the bf16 peak and the bytes at the HBM peak."""
    return max(ops / PEAK_FLOPS_BF16, nbytes / HBM_BYTES_PER_S)


# -- a dense model's sizes -----------------------------------------------------
def layer_matmul_params(m: Dict) -> int:
    """Weights of one dense layer's products (biases and norms left out):
    q, k, v and o, and the MLP's two (plain) or three (gated) matrices."""
    d, hq, hk, hd, ff = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"], m["d_ff"]
    n_mlp = 3 if m["mlp"] in ("swiglu", "geglu") else 2
    return d * hq * hd + 2 * d * hk * hd + hq * hd * d + n_mlp * d * ff


def param_count(m: Dict) -> int:
    """Every parameter of the dense model, as the port's ``LM.init`` lays
    them out: embedding, per layer two norms (a scale, and a bias under
    LayerNorm), the products and the q/k/v biases, the final norm, an
    untied head."""
    d, hq, hk, hd, V, L = (m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"],
                           m["vocab"], m["n_layers"])
    norm = 2 * d if m["norm"] == "layernorm" else d
    per_layer = layer_matmul_params(m) + 2 * norm
    if m.get("qkv_bias"):
        per_layer += hq * hd + 2 * hk * hd
    total = V * d + L * per_layer + norm
    if not m.get("tie_embeddings"):
        total += d * V
    return total


def prefill_flops(m: Dict, S: int) -> float:
    """Model operations of one request's prefill: 2 x the layers' product
    weights x the prompt's tokens, causal attention in every layer, and the
    last token's logits."""
    L, hq, hd = m["n_layers"], m["n_heads"], m["head_dim"]
    attn = 4 * hd * _pairs(S, True, None) * hq
    return 2.0 * layer_matmul_params(m) * S * L + attn * L + 2.0 * m["d_model"] * m["vocab"]


def train_step_flops(m: Dict, B: int, S: int) -> float:
    """Model operations of one training step: 6 x the product weights (the
    layers' and the head's) x the tokens, and the causal attention's forward
    and backward (three forwards' worth) in every layer."""
    L, hq, hd = m["n_layers"], m["n_heads"], m["head_dim"]
    w = layer_matmul_params(m) * L + m["d_model"] * m["vocab"]
    attn_fwd = 4 * hd * _pairs(S, True, None) * hq * B
    return 6.0 * w * B * S + 3.0 * attn_fwd * L
