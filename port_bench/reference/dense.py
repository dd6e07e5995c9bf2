"""The plain reference of the ``dense`` family, in float32 with TF32 off.

Written from the configuration's stated equations, not from the program:
embedding lookup; in each layer a norm (RMSNorm, or LayerNorm with a bias
where ``norm`` is "layernorm"; eps 1e-6), q/k/v products (plus biases where
``qkv_bias``), rotary embedding over the whole head (the
rotate-half form, angles in float64), causal softmax attention with grouped
K/V heads, the output product, a residual, the norm, the MLP (squared ReLU
plain, or SiLU-gated), a residual; a final norm and the head (the
embedding's transpose when tied).  Imports nothing of the program and
reads only the tensors the benchmark made.

``prec="fp8"`` is the control: every product of the layers and the head
takes its operands rounded to float8 e4m3 (one scale a tensor, its largest
magnitude at 448) and sums in float32, as an FP8 recipe runs the linear
layers; attention and the norms stay float32.

Serving: :func:`hidden_states` runs whole sequences layer by layer (all
sequences through one layer before the next, each layer's weights cast up
once), attention in blocks of query rows, so that it fits beside the
weights.  Training: :func:`train_steps` runs AdamW steps one row of the
batch at a time, each layer recomputed in the backward pass.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

__all__ = ["exact_matmul", "fp8_round", "hidden_states", "logit_gaps", "train_steps",
           "leaves", "QROWS"]

F32 = torch.float32
FP8_MAX = 448.0
QROWS = 1024          # query rows an attention block takes in the serving reference
EPS = 1e-6


def exact_matmul() -> None:
    """Float32 products in full float32: no TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale, back in float32."""
    s = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(F32) * s


class _Fp8Matmul(torch.autograd.Function):
    """``a @ b`` on float8-rounded operands, its gradients on float8-rounded
    operands too."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = fp8_round(a), fp8_round(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = fp8_round(g)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg


def _mm(prec: str) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    if prec == "f32":
        return torch.matmul
    if prec == "fp8":
        return _Fp8Matmul.apply
    raise ValueError(f"unknown precision {prec!r}")


def norm(m: Dict, x: torch.Tensor, scale: torch.Tensor,
         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """RMSNorm, or LayerNorm (``m["norm"] == "layernorm"``) plus its bias."""
    if m["norm"] == "rmsnorm":
        return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + EPS) * scale
    if m["norm"] != "layernorm":
        raise ValueError(f"the dense reference has no norm {m['norm']!r}")
    c = x - x.mean(dim=-1, keepdim=True)
    return c * torch.rsqrt(c.square().mean(dim=-1, keepdim=True) + EPS) * scale + bias


def _norm_leaves(tree: Dict, name: str, i: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """A norm's scale (``name``) and bias (``name + "_b"``), layer ``i``'s
    slice if given."""
    out = {}
    for key, suffix in (("scale", ""), ("bias", "_b")):
        if key in tree:
            out[name + suffix] = tree[key] if i is None else tree[key][i]
    return out


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (S, H, D); positions: (S,)."""
    half = x.shape[-1] // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float64, device=x.device) / half)
    ang = positions.to(torch.float64)[:, None] * inv
    cos, sin = torch.cos(ang).to(F32)[:, None, :], torch.sin(ang).to(F32)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              rows: Optional[int] = None) -> torch.Tensor:
    """Causal softmax attention.  q: (S, Hq, D), k and v: (S, Hk, D); each
    K/V head serves Hq/Hk query heads.  In blocks of ``rows`` query rows
    (all at once if None)."""
    S, Hq, D = q.shape
    g = Hq // k.shape[1]
    k = k.repeat_interleave(g, dim=1).transpose(0, 1)          # (Hq, S, D)
    v = v.repeat_interleave(g, dim=1).transpose(0, 1)
    qh = q.transpose(0, 1) / D ** 0.5
    rows = rows or S
    out = []
    for lo in range(0, S, rows):
        hi = min(S, lo + rows)
        s = qh[:, lo:hi] @ k[:, :hi].transpose(1, 2)           # (Hq, r, hi)
        mask = torch.arange(hi, device=q.device)[None, :] > torch.arange(
            lo, hi, device=q.device)[:, None]
        s = s.masked_fill(mask, float("-inf"))
        out.append(torch.softmax(s, dim=-1) @ v[:, :hi])
    return torch.cat(out, dim=1).transpose(0, 1)                # (S, Hq, D)


def _act(m: Dict, h: torch.Tensor, gate: Optional[torch.Tensor]) -> torch.Tensor:
    if m["mlp"] == "mlp" and m["act"] == "relu2":
        return torch.relu(h).square()
    if m["mlp"] == "swiglu" and m["act"] == "silu":
        return F.silu(gate) * h
    raise ValueError(f"the dense reference has no MLP {m['mlp']}/{m['act']}")


def layer(params: Dict, i: int, prec: str) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s weights in float32 (float8-rounded products under
    ``prec="fp8"``), flat by name."""
    seg = params["segments"][0]
    out = {k: v.to(F32) for n in ("norm1", "norm2") for k, v in _norm_leaves(seg[n], n, i).items()}
    for name in ("wq", "wk", "wv", "wo"):
        out[name] = seg["attn"][name]["w"][i].to(F32)
        if "b" in seg["attn"][name]:
            out[name + "_b"] = seg["attn"][name]["b"][i].to(F32)
    for name in seg["ffn"]:
        out["ffn_" + name] = seg["ffn"][name]["w"][i].to(F32)
    return out


def block(m: Dict, p: Dict[str, torch.Tensor], x: torch.Tensor, positions: torch.Tensor,
          mm: Callable, rows: Optional[int] = None) -> torch.Tensor:
    """One layer over one sequence.  x: (S, d) float32."""
    S = x.shape[0]
    hq, hk, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    h = norm(m, x, p["norm1"], p.get("norm1_b"))
    q, k, v = (mm(h, p[n]) + p[n + "_b"] if n + "_b" in p else mm(h, p[n])
               for n in ("wq", "wk", "wv"))
    q = rope(q.reshape(S, hq, hd), positions, m["rope_theta"])
    k = rope(k.reshape(S, hk, hd), positions, m["rope_theta"])
    a = attention(q, k, v.reshape(S, hk, hd), rows)
    x = x + mm(a.reshape(S, hq * hd), p["wo"])
    h = norm(m, x, p["norm2"], p.get("norm2_b"))
    gate = mm(h, p["ffn_wg"]) if "ffn_wg" in p else None
    return x + mm(_act(m, mm(h, p["ffn_wi"]), gate), p["ffn_wo"])


def head(m: Dict, params: Dict) -> torch.Tensor:
    """The (d, V) head in float32."""
    if m["tie_embeddings"]:
        return params["embed"]["embedding"].to(F32).T
    return params["lm_head"]["w"].to(F32)


# -- serving ---------------------------------------------------------------------
@torch.no_grad()
def hidden_states(m: Dict, params: Dict, seqs: Sequence[torch.Tensor],
                  keep_from: Sequence[int], prec: str = "f32") -> List[torch.Tensor]:
    """The final-normed hidden states (float32) of every sequence in
    ``seqs`` (1-D token ids on the device), at positions ``keep_from[i]``
    onward: the positions whose logits predict the served tokens."""
    mm = _mm(prec)
    emb = params["embed"]["embedding"]
    xs = [emb[s].to(F32) for s in seqs]
    pos = [torch.arange(s.shape[0], device=s.device) for s in seqs]
    for i in range(m["n_layers"]):
        p = layer(params, i, prec)
        xs = [block(m, p, x, ps, mm, QROWS) for x, ps in zip(xs, pos)]
        del p
    final = {k: v.to(F32) for k, v in params["final_norm"].items()}
    return [norm(m, x[k:], final["scale"], final.get("bias")) for x, k in zip(xs, keep_from)]


@torch.no_grad()
def logit_gaps(w: torch.Tensor, h32: torch.Tensor, tokens: torch.Tensor,
               h_first: Optional[torch.Tensor] = None, rows: int = 256
               ) -> torch.Tensor:
    """For each row of ``h32`` (n, d): how far the reference logit ``h32 @
    w`` of ``tokens[row]`` lies below the row's best.  With ``h_first``
    (the control's hidden states), the token judged is instead the one that
    ``fp8(h_first) @ fp8(w)`` puts first."""
    gaps = []
    wq = fp8_round(w) if h_first is not None else None
    for lo in range(0, h32.shape[0], rows):
        hi = min(h32.shape[0], lo + rows)
        lg = h32[lo:hi] @ w
        tok = tokens[lo:hi] if h_first is None else (fp8_round(h_first[lo:hi]) @ wq).argmax(-1)
        gaps.append(lg.max(dim=-1).values - lg.gather(1, tok[:, None].long())[:, 0])
    return torch.cat(gaps)


# -- training --------------------------------------------------------------------
def leaves(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """``(path, tensor)`` for every leaf of a tree of dictionaries and lists,
    dictionary keys sorted."""
    if isinstance(tree, dict):
        return [kv for key in sorted(tree) for kv in leaves(tree[key], f"{prefix}{key}.")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, val in enumerate(tree) for kv in leaves(val, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


def _tree_like(tree, fn):
    if isinstance(tree, dict):
        return {key: _tree_like(val, fn) for key, val in tree.items()}
    if isinstance(tree, list):
        return [_tree_like(val, fn) for val in tree]
    return fn(tree)


def _row_loss(m: Dict, p32: Dict, tokens: torch.Tensor, labels: torch.Tensor,
              mm: Callable) -> torch.Tensor:
    """The summed cross-entropy of one row, each layer recomputed in the
    backward pass."""
    S = tokens.shape[0]
    positions = torch.arange(S, device=tokens.device)
    x = p32["embed"]["embedding"][tokens]
    seg = p32["segments"][0]
    for i in range(m["n_layers"]):
        p = {**_norm_leaves(seg["norm1"], "norm1", i), **_norm_leaves(seg["norm2"], "norm2", i)}
        for name in ("wq", "wk", "wv", "wo"):
            p[name] = seg["attn"][name]["w"][i]
            if "b" in seg["attn"][name]:
                p[name + "_b"] = seg["attn"][name]["b"][i]
        for name in seg["ffn"]:
            p["ffn_" + name] = seg["ffn"][name]["w"][i]
        x = checkpoint(lambda x_, p_: block(m, p_, x_, positions, mm), x, p,
                       use_reentrant=False)
    h = norm(m, x, p32["final_norm"]["scale"], p32["final_norm"].get("bias"))
    w = p32["embed"]["embedding"].T if m["tie_embeddings"] else p32["lm_head"]["w"]
    return F.cross_entropy(mm(h, w), labels, reduction="sum")


def train_steps(m: Dict, params0: Dict, batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                opt: Dict, prec: str = "f32") -> Dict:
    """AdamW steps from ``params0`` over ``batches`` of (tokens, labels),
    each (B, S).  The loss is the mean cross-entropy over the batch's
    tokens.  The parameters and AdamW's two moments are stored in the
    parameters' dtype, as the configuration states (``m``'s dtype), and
    every sum, product and update is computed in float32:

        m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2
        p = p - lr ((m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps) + wd p)

    each of m, v and p rounded to the stored dtype when written, the update
    from the unrounded m and v (no clip unless ``opt["clip_norm"]``).
    Returns the losses, the first step's gradients (float32) and the
    parameters after the last step (stored dtype)."""
    mm = _mm(prec)
    store = params0["embed"]["embedding"].dtype
    stored = _tree_like(params0, lambda t: t.detach().clone())
    mom = _tree_like(params0, lambda t: torch.zeros_like(t))
    vel = _tree_like(params0, lambda t: torch.zeros_like(t))
    losses, grads1 = [], None
    b1, b2, eps, lr = opt["b1"], opt["b2"], opt["eps"], opt["lr"]
    wd = opt.get("weight_decay") or 0.0
    for t, (tokens, labels) in enumerate(batches, start=1):
        p32 = _tree_like(stored, lambda x: x.to(F32).requires_grad_(True))
        flat = [x for _, x in leaves(p32)]
        B, S = tokens.shape
        total = 0.0
        acc = [torch.zeros_like(x) for x in flat]
        for r in range(B):
            loss = _row_loss(m, p32, tokens[r], labels[r], mm) / (B * S)
            gs = torch.autograd.grad(loss, flat, allow_unused=True)
            for a, g in zip(acc, gs):
                if g is not None:
                    a.add_(g)
            total += float(loss.detach())
        losses.append(total)
        if t == 1:
            grads1 = acc
        with torch.no_grad():
            scale = 1.0
            if opt.get("clip_norm"):
                norm = torch.sqrt(sum(g.square().sum() for g in acc))
                scale = torch.clamp(opt["clip_norm"] / (norm + 1e-9), max=1.0)
            c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t
            for (_, p), (_, mo), (_, ve), g in zip(leaves(stored), leaves(mom), leaves(vel), acc):
                g = g * scale
                mf = b1 * mo.to(F32) + (1 - b1) * g
                vf = b2 * ve.to(F32) + (1 - b2) * g * g
                u = (mf / c1) / (torch.sqrt(vf / c2) + eps)
                if wd:
                    u = u + wd * p.to(F32)
                p.copy_((p.to(F32) - lr * u).to(store))
                mo.copy_(mf.to(store))
                ve.copy_(vf.to(store))
        del p32, flat, acc
    names = [name for name, _ in leaves(params0)]
    return {"losses": losses, "grads1": dict(zip(names, grads1)),
            "params": dict(leaves(stored))}
