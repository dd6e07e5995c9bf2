"""The plain reference of the ``moe`` family with MLA attention
(DeepSeek-V3's layer, as Moonlight-16B-A3B publishes it), in float32 with
TF32 off.

Written from the configuration's stated equations, not from the program.
Each layer:

* RMSNorm (eps ``norm_eps``) of the stream.
* MLA in its expanded form, with no q-LoRA: ``q = h W_q``, ``H`` heads
  of ``nope + rope``; ``[c, k_pe] = h W_dkv``,
  ``c = RMSNorm(c)``; ``k_nope = c W_uk``, ``v = c W_uv`` per head; RoPE on
  q's rope part and on the one ``k_pe`` all heads share; causal softmax of
  ``q . k / sqrt(nope + rope)``; the output product; a residual.
* RMSNorm, then the first ``n_dense_layers`` a SwiGLU MLP, the rest the
  mixture of experts: scores ``s = sigmoid(h W_r)`` in float32, the top k
  experts of ``s + b`` (``b`` the router's selection bias, where the
  configuration has one; ``n_group = topk_group = 1``, so no group
  limit), gates ``s`` at the chosen experts over their sum (plus 1e-20,
  as the published ``noaux_tc`` router divides), times ``routed_scaling``;
  ``y = sum gate * SwiGLU_e(h) + SharedSwiGLU(h)``, every claim computed (a
  loop over the experts, each on the rows that chose it); a residual.

Then a final RMSNorm and the untied head.

Departures from the published checkpoint's code, each an exact relabelling
of the seeded weights, not a change of the mathematics: RoPE pairs the
rope columns rotate-half (``x[:half]`` with ``x[half:]``), as the port
does, where the published code pairs them interleaved (``x[2i]`` with
``x[2i+1]``): with weights drawn from a seed that is a fixed permutation of
the 64 rope columns of ``W_q`` and ``W_dkv``.  ``W_uk`` and ``W_uv`` are
two matrices where the checkpoint holds one ``kv_b_proj`` with each head's
``nope`` and ``v`` columns side by side: a fixed permutation of its columns.

``prec="fp8"`` is the control: every product of the layers (attention's
projections, the experts', the shared experts', the dense MLP's) and the
head takes its operands rounded to float8 e4m3 (one scale a tensor) and
sums in float32, as an FP8 recipe runs the linear layers; the router's
product, attention's scores and the norms stay float32, as DeepSeek-V3's
FP8 recipe keeps them.

:func:`hidden_states` runs the sequences layer by layer (all sequences
through one layer before the next, each layer's weights cast up once),
attention in blocks of query rows and the experts over every sequence's
tokens at once, so that it fits on the card beside the served weights.
Imports nothing of the program.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F

from .dense import QROWS, _mm, attention, exact_matmul, logit_gaps, rope

__all__ = ["exact_matmul", "hidden_states", "head", "logit_gaps", "route", "moe_layer",
           "layer_weights"]

F32 = torch.float32


def rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * scale


def _segment(m: Dict, params: Dict, i: int):
    """(segment tree, index in it, whether the layer has experts) of layer ``i``."""
    n_dense = m["moe"]["n_dense_layers"]
    if i < n_dense:
        return params["segments"][0], i, False
    return params["segments"][1 if n_dense else 0], i - n_dense, True


def layer_weights(m: Dict, params: Dict, i: int) -> Dict:
    """Layer ``i``'s weights in float32, as a tree of the same keys."""
    seg, j, experts = _segment(m, params, i)

    def up(tree):
        return {k: up(v) for k, v in tree.items()} if isinstance(tree, dict) else tree[j].to(F32)

    return {"experts": experts, **up(seg)}


def route(m: Dict, router: Dict, h: torch.Tensor):
    """(gates (T, k), chosen experts (T, k)) of the tokens ``h`` (T, d)."""
    moe = m["moe"]
    s = h @ router["w"]
    s = torch.sigmoid(s) if moe["router_act"] == "sigmoid" else torch.softmax(s, dim=-1)
    choice = s + router["bias"] if "bias" in router else s
    idx = torch.topk(choice, moe["top_k"], dim=-1).indices
    gates = s.gather(1, idx)
    gates = gates / (gates.sum(dim=-1, keepdim=True) + 1e-20) * moe.get("routed_scaling", 1.0)
    return gates, idx


def _swiglu(h: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor, wo: torch.Tensor,
            mm: Callable) -> torch.Tensor:
    return mm(F.silu(mm(h, wg)) * mm(h, wi), wo)


def moe_layer(m: Dict, ffn: Dict, h: torch.Tensor, mm: Callable) -> torch.Tensor:
    """The mixture of experts over the tokens ``h`` (T, d): every claim."""
    gates, idx = route(m, ffn["router"], h)
    ex = ffn["experts"]
    y = torch.zeros_like(h)
    for e in range(m["moe"]["n_experts"]):
        rows, k = (idx == e).nonzero(as_tuple=True)
        if rows.numel():
            out = _swiglu(h[rows], ex["wi"][e], ex["wg"][e], ex["wo"][e], mm)
            y.index_add_(0, rows, out * gates[rows, k][:, None])
    if "shared" in ffn:
        sh = ffn["shared"]
        y = y + _swiglu(h, sh["wi"]["w"], sh["wg"]["w"], sh["wo"]["w"], mm)
    return y


def mla(m: Dict, a: Dict, h: torch.Tensor, positions: torch.Tensor, mm: Callable,
        rows: int = QROWS) -> torch.Tensor:
    """Causal MLA attention of one sequence ``h`` (S, d), expanded, and its
    output product."""
    S = h.shape[0]
    H, mla_ = m["n_heads"], m["mla"]
    dn, dr, dv, r = (mla_["qk_nope_head_dim"], mla_["qk_rope_head_dim"], mla_["v_head_dim"],
                     mla_["kv_lora_rank"])
    eps = m["norm_eps"]
    q = mm(h, a["wq"]["w"]).reshape(S, H, dn + dr)
    kv = mm(h, a["wdkv"]["w"])
    c = rms(kv[:, :r], a["kv_norm"]["scale"], eps)
    k_pe = rope(kv[:, None, r:], positions, m["rope_theta"])           # (S, 1, dr)
    q = torch.cat([q[..., :dn], rope(q[..., dn:], positions, m["rope_theta"])], dim=-1)
    k = torch.cat([mm(c, a["wuk"]["w"]).reshape(S, H, dn), k_pe.expand(S, H, dr)], dim=-1)
    v = mm(c, a["wuv"]["w"]).reshape(S, H, dv)
    o = attention(q, k, v, rows)                                        # scale 1/sqrt(dn+dr)
    return mm(o.reshape(S, H * dv), a["wo"]["w"])


def head(m: Dict, params: Dict) -> torch.Tensor:
    """The (d, V) head in float32."""
    if m["tie_embeddings"]:
        return params["embed"]["embedding"].to(F32).T
    return params["lm_head"]["w"].to(F32)


@torch.no_grad()
def hidden_states(m: Dict, params: Dict, seqs: Sequence[torch.Tensor],
                  keep_from: Sequence[int], prec: str = "f32") -> List[torch.Tensor]:
    """The final-normed hidden states (float32) of every sequence in
    ``seqs`` (1-D token ids on the device), at positions ``keep_from[i]``
    onward: the positions whose logits predict the served tokens."""
    mm = _mm(prec)
    eps = m["norm_eps"]
    emb = params["embed"]["embedding"]
    xs = [emb[s].to(F32) for s in seqs]
    pos = [torch.arange(s.shape[0], device=s.device) for s in seqs]
    sizes = [x.shape[0] for x in xs]
    for i in range(m["n_layers"]):
        p = layer_weights(m, params, i)
        xs = [x + mla(m, p["attn"], rms(x, p["norm1"]["scale"], eps), ps, mm)
              for x, ps in zip(xs, pos)]
        h = rms(torch.cat(xs), p["norm2"]["scale"], eps)              # every token at once
        ffn = p["ffn"]
        y = (moe_layer(m, ffn, h, mm) if p["experts"]
             else _swiglu(h, ffn["wi"]["w"], ffn["wg"]["w"], ffn["wo"]["w"], mm))
        xs = [x + dy for x, dy in zip(xs, torch.split(y, sizes))]
        del p, h, y
    final = params["final_norm"]["scale"].to(F32)
    return [rms(x[k:], final, eps) for x, k in zip(xs, keep_from)]
