"""RWKV6 (Finch, arXiv:2404.05892) and RG-LRU (Griffin, arXiv:2402.19427)
blocks in PyTorch.

The counterpart of the JAX package's ``models/recurrent.py``.  Every RWKV6 prefill with
more than one token runs the WKV recurrence through
:func:`repro_torch.kernels.ops.rwkv6`, the hand-written CUDA kernel on the
card; training (no state) goes through its trainable form,
:func:`repro_torch.kernels.rwkv6_scan.rwkv6_scan_trainable`, whose backward
differentiates the plain version.  A single decode token is the one-step
update in plain PyTorch, as the JAX package keeps it.

RWKV6 state layout (per layer, stacked over layers by the model):
  {"ts_tm": (B,d), "ts_cm": (B,d) in the activation dtype, "S": (B,H,N,N) f32}

The RG-LRU (RecurrentGemma's temporal block) reaches no Pallas kernel in the
JAX package: its linear recurrence ``h_t = a_t h_{t-1} + b_t`` is a
``jax.lax.associative_scan``.  Here it is plain torch, a log-depth scan over
the sequence axis in float32 (:func:`linear_scan`); a single decode token
is the one step ``h = a h0 + b``, as in the JAX function.  RG-LRU state
layout (per block, stacked by the model over its leading axes):
  {"conv": (B, conv_width-1, W) in the activation dtype, "h": (B, W) f32}
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import ops
from ..kernels.ref import rwkv6_ref
from ..kernels.rwkv6_scan import rwkv6_scan_trainable
from .config import ModelConfig
from .layers import Layers, dense_apply, dense_init, lead_axes, stacked_normal, torch_dtype

__all__ = ["rwkv6_init", "rwkv6_state", "rwkv6_apply", "N_GATE_BLOCKS", "RGLRU_C",
           "rglru_init", "rglru_state", "rglru_apply", "linear_scan"]

MixFn = Callable[..., Tuple[torch.Tensor, torch.Tensor]]


def rwkv6_init(gen: torch.Generator, cfg: ModelConfig, n_layers: int,
               device: torch.device) -> Dict:
    """Parameters of ``n_layers`` RWKV6 blocks, stacked over a leading layer
    axis, with the JAX ``rwkv6_init`` distributions and dtypes (``w0`` and
    ``u`` float32, the rest in the activation dtype)."""
    d = cfg.d_model
    dt = torch_dtype(cfg.dtype)
    f32 = torch.float32
    L = n_layers
    lora = 64

    def mat(din, dout, s=None):
        s = s if s is not None else 1.0 / np.sqrt(din)
        w = torch.randn((L, din, dout), generator=gen, dtype=f32, device=device)
        return (w * s).to(dt)

    def full(value, dtype=dt):
        return torch.full((L, d), value, dtype=dtype, device=device)

    def ln():
        return {"scale": full(1.0), "bias": full(0.0)}

    return {
        "ln1": ln(),
        "ln2": ln(),
        # token-shift lerp coefficients (static part of ddlerp)
        "mu": {key: full(0.5) for key in ("r", "k", "v", "g", "w")},
        "wr": {"w": mat(d, d)},
        "wk": {"w": mat(d, d)},
        "wv": {"w": mat(d, d)},
        "wg": {"w": mat(d, d)},
        "wo": {"w": mat(d, d)},
        # data-dependent decay LoRA: w_t = exp(-exp(w0 + tanh(xw A) B))
        "w0": full(-2.0, f32),
        "wA": mat(d, lora, s=0.01),
        "wB": mat(lora, d, s=0.01),
        "u": torch.randn((L, d), generator=gen, dtype=f32, device=device) * 0.1,
        # per-head group norm on the time-mix output
        "ln_x": ln(),
        # channel mix
        "mu_cm": {key: full(0.5) for key in ("k", "r")},
        "cm_k": {"w": mat(d, cfg.d_ff)},
        "cm_v": {"w": mat(cfg.d_ff, d)},
        "cm_r": {"w": mat(d, d)},
    }


def rwkv6_state(cfg: ModelConfig, batch: int, n_layers: int,
                device: torch.device) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    N = cfg.recurrent.head_size
    H = d // N
    dt = torch_dtype(cfg.dtype)
    return {
        "ts_tm": torch.zeros((n_layers, batch, d), dtype=dt, device=device),
        "ts_cm": torch.zeros((n_layers, batch, d), dtype=dt, device=device),
        "S": torch.zeros((n_layers, batch, H, N, N), dtype=torch.float32, device=device),
    }


def _group_norm(x: torch.Tensor, H: int, scale, bias, eps: float = 1e-5):
    """GroupNorm over each head's channels. x: (B,S,d)."""
    B, S, d = x.shape
    xh = x.reshape(B, S, H, d // H).to(torch.float32)
    mu = xh.mean(dim=-1, keepdim=True)
    var = xh.var(dim=-1, keepdim=True, unbiased=False)
    xn = (xh - mu) * torch.rsqrt(var + eps)
    return xn.reshape(B, S, d).to(x.dtype) * scale + bias


def _layer_norm(x: torch.Tensor, scale, bias, eps: float = 1e-5):
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * scale + bias


def _wkv_one_token(r, k, v, w, u, S0):
    # y stays float32, as the JAX block's sequential path leaves it
    return rwkv6_ref(r.to(torch.float32), k, v, w, u, S0)


def rwkv6_apply(
    cfg: ModelConfig, p: Dict, x: torch.Tensor, state: Optional[Dict],
    mix_fn: Optional[MixFn] = None,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Full RWKV6 block (pre-norms included):

        x = x + time_mix(ln1(x));  x = x + channel_mix(ln2(x))

    x: (B,S,d).  ``state=None`` means a zero initial state and no state
    returned.  Token-shift states hold the last *normed* token of each
    sub-block's input, so decode continues exactly where prefill stopped.
    ``mix_fn`` replaces the WKV recurrence (the plain version, to check the
    kernel's path on the card); by default S > 1 goes to ``ops.rwkv6``,
    through its trainable form when there is no state (training).
    """
    B, S, d = x.shape
    N = cfg.recurrent.head_size
    H = d // N
    if mix_fn is not None:
        mix = mix_fn
    elif S == 1:
        mix = _wkv_one_token
    elif state is None:
        mix = rwkv6_scan_trainable
    else:
        mix = ops.rwkv6

    # ---- time mix -------------------------------------------------------------
    xn = _layer_norm(x, p["ln1"]["scale"], p["ln1"]["bias"])
    prev_tm = state["ts_tm"] if state is not None else torch.zeros_like(xn[:, 0])
    xs = torch.cat([prev_tm[:, None, :], xn[:, :-1, :]], dim=1)

    def lerp(mu):
        return xn + (xs - xn) * mu

    r = dense_apply(p["wr"], lerp(p["mu"]["r"])).reshape(B, S, H, N)
    k = dense_apply(p["wk"], lerp(p["mu"]["k"])).reshape(B, S, H, N)
    v = dense_apply(p["wv"], lerp(p["mu"]["v"])).reshape(B, S, H, N)
    g = dense_apply(p["wg"], lerp(p["mu"]["g"]))
    f32 = torch.float32
    xw = lerp(p["mu"]["w"]).to(f32)
    decay_in = p["w0"] + torch.tanh(xw @ p["wA"].to(f32)) @ p["wB"].to(f32)
    w = torch.exp(-torch.exp(decay_in)).reshape(B, S, H, N)     # (0,1) decay

    S0 = (
        state["S"] if state is not None
        else torch.zeros((B, H, N, N), dtype=f32, device=x.device)
    )
    u = p["u"].reshape(H, N)
    y, S_T = mix(r, k, v, w, u, S0)
    y = _group_norm(y.reshape(B, S, d), H, p["ln_x"]["scale"], p["ln_x"]["bias"])
    y = y * F.silu(g)
    x = x + dense_apply(p["wo"], y.to(x.dtype))

    # ---- channel mix ------------------------------------------------------------
    hn = _layer_norm(x, p["ln2"]["scale"], p["ln2"]["bias"])
    prev_cm = state["ts_cm"] if state is not None else torch.zeros_like(hn[:, 0])
    hs = torch.cat([prev_cm[:, None, :], hn[:, :-1, :]], dim=1)

    def lerp_cm(mu):
        return hn + (hs - hn) * mu

    kk = torch.relu(dense_apply(p["cm_k"], lerp_cm(p["mu_cm"]["k"]))).square()
    cm = torch.sigmoid(dense_apply(p["cm_r"], lerp_cm(p["mu_cm"]["r"]))) * dense_apply(p["cm_v"], kk)
    out = x + cm

    new_state = None
    if state is not None:
        new_state = {"ts_tm": xn[:, -1, :], "ts_cm": hn[:, -1, :], "S": S_T}
    return out, new_state


# ---------------------------------------------------------------------------
# RG-LRU (Griffin, arXiv:2402.19427): RecurrentGemma's temporal block
# ---------------------------------------------------------------------------
N_GATE_BLOCKS = 16
RGLRU_C = 8.0


def rglru_init(gen: torch.Generator, cfg: ModelConfig, device: torch.device,
               layers: Layers = None) -> Dict:
    """Parameters of RG-LRU blocks stacked over ``layers``, with the JAX
    ``rglru_init`` distributions and dtypes: the projections, the depthwise
    conv and the block-diagonal gate matrices in the activation dtype, the
    gate biases ``ba``, ``bx`` and ``lam`` in float32; ``lam`` spans
    a = sigmoid(lam)^c over about (0.9, 0.999) (Griffin section 2.4)."""
    d = cfg.d_model
    W = cfg.recurrent.lru_width or d
    cw = cfg.recurrent.conv_width
    dt = torch_dtype(cfg.dtype)
    f32 = torch.float32
    lead = lead_axes(layers)
    bs = W // N_GATE_BLOCKS
    lam = torch.log(torch.expm1(torch.linspace(0.35, 0.9, W, dtype=f32, device=device)))
    return {
        "proj_x": dense_init(gen, d, W, dt, device, layers=layers),
        "proj_g": dense_init(gen, d, W, dt, device, layers=layers),
        "proj_out": dense_init(gen, W, d, dt, device, layers=layers),
        "conv": stacked_normal(gen, lead, (cw, W), 1.0 / np.sqrt(cw), dt, device),
        "conv_b": torch.zeros(lead + (W,), dtype=dt, device=device),
        "wa": stacked_normal(gen, lead + (N_GATE_BLOCKS,), (bs, bs), 1.0 / np.sqrt(bs), dt,
                             device),
        "ba": torch.zeros(lead + (W,), dtype=f32, device=device),
        "wx": stacked_normal(gen, lead + (N_GATE_BLOCKS,), (bs, bs), 1.0 / np.sqrt(bs), dt,
                             device),
        "bx": torch.zeros(lead + (W,), dtype=f32, device=device),
        "lam": lam.expand(lead + (W,)).contiguous(),
    }


def rglru_state(cfg: ModelConfig, batch: int, layers: Layers,
                device: torch.device) -> Dict[str, torch.Tensor]:
    """Zero RG-LRU states stacked over ``layers``: the conv window in the
    activation dtype, ``h`` in float32."""
    W = cfg.recurrent.lru_width or cfg.d_model
    cw = cfg.recurrent.conv_width
    lead = lead_axes(layers)
    return {
        "conv": torch.zeros(lead + (batch, cw - 1, W), dtype=torch_dtype(cfg.dtype),
                            device=device),
        "h": torch.zeros(lead + (batch, W), dtype=torch.float32, device=device),
    }


def _block_diag_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B,S,W), w: (nb, bs, bs) block-diagonal -> (B,S,W)."""
    B, S, W = x.shape
    nb, bs, _ = w.shape
    return torch.einsum("bsnd,nde->bsne", x.reshape(B, S, nb, bs), w).reshape(B, S, W)


def _causal_conv(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                 prev: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x: (B,S,W), kernel: (cw,W), prev: (B,cw-1,W).
    Returns ``(y (B,S,W), the last cw-1 inputs)``."""
    cw, S = kernel.shape[0], x.shape[1]
    if prev is None:
        prev = torch.zeros((x.shape[0], cw - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([prev, x], dim=1)                           # (B, S+cw-1, W)
    y = sum(xp[:, i:i + S, :] * kernel[i] for i in range(cw)) + bias
    return y.to(x.dtype), xp[:, -(cw - 1):, :]


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t h_{t-1} + b_t`` from ``h_{-1} = 0`` along axis 1, for every
    t: a Hillis-Steele scan of the pairs (a, b) under ``(a_l, b_l) then
    (a_r, b_r) = (a_l a_r, a_r b_l + b_r)``, ceil(log2 S) doubling steps of
    whole-tensor operations rather than one launch a token.  Each step makes
    new tensors, so autograd keeps every step's (a, b) for the backward pass
    (an in-place step would overwrite what the backward pass reads)."""
    d, S = 1, a.shape[1]
    while d < S:
        b = torch.cat([b[:, :d], torch.addcmul(b[:, d:], a[:, d:], b[:, :-d])], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru_apply(cfg: ModelConfig, p: Dict, x: torch.Tensor, state: Optional[Dict]
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Griffin recurrent block: projections -> causal conv -> RG-LRU, gated by
    a GeLU branch.  x: (B,S,d).  ``state=None`` means a zero initial state
    and no state returned; otherwise returns ``{"conv", "h"}`` after the
    last token.  The gates and the recurrence run in float32."""
    B, S, _ = x.shape
    f32 = torch.float32
    xb = dense_apply(p["proj_x"], x)                            # (B,S,W)
    gb = dense_apply(p["proj_g"], x)
    conv_prev = state["conv"] if state is not None else None
    xc, conv_state = _causal_conv(xb, p["conv"], p["conv_b"], conv_prev)

    # the RG-LRU gates (block-diagonal input projections)
    rgate = torch.sigmoid(_block_diag_mm(xc, p["wa"]).to(f32) + p["ba"])
    igate = torch.sigmoid(_block_diag_mm(xc, p["wx"]).to(f32) + p["bx"])
    softplus = torch.logaddexp(p["lam"], torch.zeros_like(p["lam"]))   # jax.nn.softplus
    log_a = -RGLRU_C * rgate * softplus                         # log a_t  (B,S,W)
    a = torch.exp(log_a)
    gated_x = igate * xc.to(f32)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * gated_x

    h0 = state["h"] if state is not None else torch.zeros((B, xb.shape[-1]), dtype=f32,
                                                            device=x.device)
    if S == 1:
        h_last = a[:, 0] * h0 + b[:, 0]
        hs = h_last[:, None, :]
    else:
        # fold the incoming state into the first step's offset
        b = torch.cat([(b[:, 0] + a[:, 0] * h0)[:, None], b[:, 1:]], dim=1)
        hs = linear_scan(a, b)
        h_last = hs[:, -1, :]

    y = hs.to(x.dtype) * F.gelu(gb, approximate="tanh")
    out = dense_apply(p["proj_out"], y)
    new_state = None
    if state is not None:
        new_state = {"conv": conv_state, "h": h_last}
    return out, new_state
