"""The yardstick's arithmetic for a mixture of experts with MLA attention
(Moonlight-16B-A3B): its parameters, and the operations and bytes a decode
step needs, computed from shapes alone.  The peaks are ``costs.py``'s.
Imports nothing of the program.

A decode step's least bytes: every weight read once (the embedding's rows
are left out: a step reads one row a slot), the head once in the served
dtype, and each busy slot's latent cache (``c_kv``, ``k_pe`` and the
position, every layer) at its length; of the routed experts, only those the
busy slots' tokens are expected to choose (:func:`experts_read`).  The
program routes its idle slots too and so reads more; the least counts the
work the busy slots need.  Its least operations: 2 x the active product weights (the routed experts a token
takes, the shared ones, attention's projections, the head) a busy slot,
and MLA's absorbed attention over each busy slot's length.
"""
from __future__ import annotations

from typing import Dict

from .costs import least_s

__all__ = ["mla_params", "expert_params", "layer_params", "param_count", "cache_bytes",
           "experts_read", "decode_step_bytes", "decode_step_flops", "decode_least_s"]

POS_BYTES = 4          # a cache slot's position, int32


def mla_params(m: Dict) -> int:
    """Weights of one MLA attention with no q-LoRA: the query product, the KV
    down product, its norm, the K and V up products and the output product."""
    d, H, a = m["d_model"], m["n_heads"], m["mla"]
    dn, dr, dv, r = a["qk_nope_head_dim"], a["qk_rope_head_dim"], a["v_head_dim"], a["kv_lora_rank"]
    return d * H * (dn + dr) + d * (r + dr) + r + r * H * (dn + dv) + H * dv * d


def expert_params(m: Dict) -> int:
    """Weights of one routed expert (a SwiGLU of ``d_expert``)."""
    return 3 * m["d_model"] * m["moe"]["d_expert"]


def layer_params(m: Dict, experts: bool) -> int:
    """Every weight of one layer: two norms, attention, and the dense MLP or
    the router (and its bias), the routed and the shared experts."""
    d, moe = m["d_model"], m["moe"]
    total = 2 * d + mla_params(m)
    if not experts:
        return total + 3 * d * m["d_ff"]
    router = d * moe["n_experts"] + (moe["n_experts"] if moe.get("router_bias") else 0)
    shared = 3 * d * moe["d_expert"] * moe["n_shared_experts"]
    return total + router + moe["n_experts"] * expert_params(m) + shared


def param_count(m: Dict) -> int:
    """Every parameter: embedding, layers, final norm, untied head."""
    n_dense = m["moe"]["n_dense_layers"]
    total = m["vocab"] * m["d_model"] + m["d_model"]
    total += n_dense * layer_params(m, False)
    total += (m["n_layers"] - n_dense) * layer_params(m, True)
    if not m["tie_embeddings"]:
        total += m["d_model"] * m["vocab"]
    return total


def cache_bytes(m: Dict, elem_bytes: int = 2) -> int:
    """The latent cache one token holds over every layer: ``c_kv`` and
    ``k_pe`` in the served dtype and the slot's position."""
    a = m["mla"]
    return m["n_layers"] * ((a["kv_lora_rank"] + a["qk_rope_head_dim"]) * elem_bytes + POS_BYTES)


def experts_read(m: Dict, busy: int) -> float:
    """The routed experts of one layer that ``busy`` tokens are expected to
    choose, each token ``top_k`` of ``n_experts`` as if uniformly:
    ``E (1 - (1 - K/E)**busy)``.  A skewed router chooses fewer, so this is
    the most a step is expected to need (at 30 busy slots, 60.7 of 64)."""
    E, K = m["moe"]["n_experts"], m["moe"]["top_k"]
    return E * (1.0 - (1.0 - K / E) ** busy)


def decode_step_bytes(m: Dict, busy: int, live_tokens: int, elem_bytes: int = 2) -> float:
    """The least bytes of one decode step of ``busy`` slots whose lengths
    sum to ``live_tokens``: every weight but the embedding and the routed
    experts no busy token is expected to choose once, and the busy slots'
    latent cache."""
    moe = m["moe"]
    unread = (m["n_layers"] - moe["n_dense_layers"]) * (
        moe["n_experts"] - experts_read(m, busy)) * expert_params(m)
    weights = param_count(m) - m["vocab"] * m["d_model"] - unread
    return weights * elem_bytes + live_tokens * cache_bytes(m, elem_bytes)


def decode_step_flops(m: Dict, busy: int, live_tokens: int) -> float:
    """The least operations of one decode step of ``busy`` slots whose
    lengths sum to ``live_tokens``: per slot 2 x its active product weights
    (attention's projections, the dense MLP or the router, its ``top_k``
    experts and the shared ones, every layer; the head), and per layer
    MLA's absorbed attention: q's nope part into the latent space and the
    context out through ``W_uv`` per slot, the scores against ``c_kv`` and
    ``k_pe`` and the context in the latent space per cached token."""
    d, H, moe, a = m["d_model"], m["n_heads"], m["moe"], m["mla"]
    dn, dr, dv, r = a["qk_nope_head_dim"], a["qk_rope_head_dim"], a["v_head_dim"], a["kv_lora_rank"]
    L, n_dense = m["n_layers"], moe["n_dense_layers"]
    proj = d * H * (dn + dr) + d * (r + dr) + H * dv * d
    active = L * proj + n_dense * 3 * d * m["d_ff"] + (L - n_dense) * (
        d * moe["n_experts"] + (moe["top_k"] + moe["n_shared_experts"]) * expert_params(m))
    active += d * m["vocab"] + L * H * r * (dn + dv)
    return 2.0 * busy * active + 2.0 * L * H * live_tokens * (2 * r + dr)


def decode_least_s(m: Dict, busy: int, live_tokens: int, elem_bytes: int = 2) -> float:
    """The least time of one decode step of ``busy`` slots whose lengths sum
    to ``live_tokens``: the larger of its operations at the bf16 peak and
    its bytes at the HBM peak."""
    return least_s(decode_step_flops(m, busy, live_tokens),
                   decode_step_bytes(m, busy, live_tokens, elem_bytes))
