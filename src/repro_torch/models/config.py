"""Unified model configuration covering all assigned architecture families.

A copy of the JAX package's ``models/config.py``, kept whole so that a
config built here compares field by field with the reference's, plus a few
fields of the port's alone (``ModelConfig.norm_eps``, ``MLAConfig``'s
``q_lora_rank=None``, ``MoEConfig.router_bias``, ``routed_scaling`` and
``dispatch="dropless"``), each at a default that computes what the JAX
package computes, so every registered architecture is as the reference's.  One
``ModelConfig`` describes dense GQA transformers, MoE (shared+routed, MLA),
RWKV6-style SSMs, RecurrentGemma-style hybrids, encoder-decoder audio
backbones, and VLM backbones (M-RoPE).  The architectures ported so far are
in :mod:`repro_torch.configs`.  The port runs every prefill with more than
one token through its WKV kernel on the card and reads no
``attention_impl``; the field stays so the dataclass matches.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

__all__ = ["ModelConfig", "MoEConfig", "MLAConfig", "RecurrentConfig", "reduced"]


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0            # routed experts
    n_shared_experts: int = 0     # always-on shared experts (Qwen-MoE/DeepSeek)
    top_k: int = 2
    d_expert: int = 0             # per-expert FFN hidden size
    n_dense_layers: int = 0       # leading layers that use a dense FFN (DeepSeek-V3: 3)
    capacity_factor: float = 1.25
    group_size: int = 256         # tokens per dispatch group (einsum mode)
    # "einsum" | "sort" (sort = beyond-paper opt) | "dropless" (the port's
    # alone: every claim computed, whatever the load)
    dispatch: str = "einsum"
    router_dtype: str = "float32"
    # DeepSeek-V3 uses sigmoid routing with bias-based aux-free balancing;
    # Qwen uses softmax.  "softmax" | "sigmoid"
    router_act: str = "softmax"
    # The port's alone, each at a default that computes as the JAX package
    # does.  ``router_bias``: a per-layer vector added to the router's
    # scores for the choice of experts only, never to the gates (DeepSeek-V3's
    # ``e_score_correction_bias``, ``topk_method="noaux_tc"``).
    # ``routed_scaling``: multiplies the normalised gates
    # (``routed_scaling_factor``).
    router_bias: bool = False
    routed_scaling: float = 1.0


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 Multi-head Latent Attention dims (arXiv:2412.19437).
    ``q_lora_rank=None`` (the port's alone) projects the queries directly,
    ``d -> H * (nope + rope)``, with no low-rank step and no query norm."""

    q_lora_rank: Optional[int] = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class RecurrentConfig:
    """RWKV6 / RG-LRU settings."""

    kind: str = "rwkv6"           # "rwkv6" | "rglru"
    head_size: int = 64           # rwkv6 head size
    conv_width: int = 4           # rg-lru temporal conv width
    lru_width: Optional[int] = None  # rg-lru recurrent width (default d_model)
    # hybrid block pattern, e.g. ("rec", "rec", "attn") for RecurrentGemma
    pattern: Tuple[str, ...] = ("rec",)


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"         # dense | moe | ssm | hybrid | audio | vlm

    n_layers: int = 4
    d_model: int = 512
    n_heads: int = 8
    n_kv_heads: int = 8
    head_dim: Optional[int] = None   # default d_model // n_heads
    d_ff: int = 2048
    vocab: int = 32000

    act: str = "silu"             # silu | gelu
    mlp: str = "swiglu"           # swiglu | geglu | mlp (plain 2-matrix)
    norm: str = "rmsnorm"         # rmsnorm | layernorm | layernorm_nobias | nonparametric
    # the port's alone: every norm's epsilon (the LM's RMSNorms and
    # LayerNorms, MLA's q_norm and kv_norm); the JAX package fixes 1e-6
    norm_eps: float = 1e-6
    qkv_bias: bool = False        # Qwen1.5-style QKV bias
    attn_logit_softcap: Optional[float] = None
    tie_embeddings: bool = False

    rope: str = "rope"            # rope | mrope | none
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, ...] = (16, 24, 24)  # Qwen2-VL t/h/w split

    attention: str = "full"       # full | local | mla | none
    attn_window: Optional[int] = None   # local-attention window

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    recurrent: Optional[RecurrentConfig] = None

    # encoder-decoder (Whisper): n_layers applies to BOTH encoder and decoder
    enc_dec: bool = False
    enc_len: int = 1500           # encoder frames (Whisper 30 s @ 50 Hz)

    # VLM backbone: expects fused M-RoPE position ids as an input
    needs_position_ids: bool = False

    # numerics
    dtype: str = "bfloat16"       # activation/param dtype
    logits_dtype: str = "float32"
    # KV-cache storage dtype (None = activation dtype).  "float8_e4m3fn"
    # halves decode cache bandwidth (beyond-paper serving optimisation).
    kv_dtype: Optional[str] = None
    # Attention inner implementation: "xla" (einsum softmax — the dry-run /
    # CPU path), "kernel" (Pallas flash attention on TPU),
    # "kernel_interpret" (Pallas body interpreted on CPU, for validation).
    attention_impl: str = "xla"
    remat: str = "none"           # none | block | dots  (activation ckpt policy)
    # vocab-chunked cross-entropy (beyond-paper memory optimisation)
    xent_chunk: int = 0           # 0 = unchunked
    # Fully unroll layer scans.  Used by the dry-run's cost-probe compiles:
    # XLA's cost_analysis counts a while-loop body ONCE regardless of trip
    # count, so roofline FLOPs are extrapolated from small unrolled probes.
    scan_unroll: bool = False

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_heads % max(self.n_kv_heads, 1) != 0:
            raise ValueError("n_heads must be a multiple of n_kv_heads")
        if self.attention == "local" and not self.attn_window:
            raise ValueError("local attention requires attn_window")
        if self.family == "moe" and self.moe is None:
            raise ValueError("moe family requires MoEConfig")

    # -- derived ---------------------------------------------------------------
    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def sub_quadratic(self) -> bool:
        """True when the arch supports O(S) / windowed decode at 500k ctx."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.attention == "local"

    def has_decode(self) -> bool:
        """Encoder-only models have no decode step; everything else decodes."""
        return True  # all assigned archs are decoder or enc-dec

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head), used for
        MODEL_FLOPS = 6*N*D in the roofline analysis."""
        d, L, V = self.d_model, self.n_layers, self.vocab
        hd = self.head_dim
        emb = V * d * (1 if self.tie_embeddings else 2)
        total = emb
        rec = self.recurrent

        def attn_params() -> int:
            if self.attention == "mla":
                m = self.mla
                qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
                if m.q_lora_rank:
                    p = d * m.q_lora_rank + m.q_lora_rank * self.n_heads * qk_head
                else:
                    p = d * self.n_heads * qk_head
                p += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                p += m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
                p += self.n_heads * m.v_head_dim * d
                return p
            qp = d * self.n_heads * hd
            kvp = 2 * d * self.n_kv_heads * hd
            op = self.n_heads * hd * d
            bias = (self.n_heads + 2 * self.n_kv_heads) * hd if self.qkv_bias else 0
            return qp + kvp + op + bias

        def ffn_params(dff: int) -> int:
            mats = 3 if self.mlp in ("swiglu", "geglu") else 2
            return mats * d * dff

        def rec_params() -> int:
            if rec is None:
                return 0
            if rec.kind == "rwkv6":
                # time-mix: r,k,v,g,o (5 d*d) + decay lora + mix params
                return 5 * d * d + 2 * d * 64 + 6 * d
            w = rec.lru_width or d
            # rg-lru: in/out proj + conv + gates
            return 2 * d * w + rec.conv_width * w + 2 * w * (w // 8) + w

        norm_p = 0 if self.norm == "nonparametric" else d
        for i in range(L):
            kind = "rec"
            if self.family in ("dense", "moe", "audio", "vlm"):
                kind = "attn"
            elif self.family == "hybrid":
                kind = rec.pattern[i % len(rec.pattern)]
            if kind == "attn":
                total += attn_params()
            else:
                total += rec_params()
            # FFN / MoE
            if self.moe is not None and i >= self.moe.n_dense_layers:
                total += self.moe.n_experts * ffn_params(self.moe.d_expert)
                total += self.moe.n_shared_experts * ffn_params(self.moe.d_expert)
                total += d * self.moe.n_experts  # router
                if self.moe.router_bias:
                    total += self.moe.n_experts
            elif self.family != "ssm" or rec.kind != "rwkv6":
                total += ffn_params(self.d_ff)
            else:
                total += 2 * d * self.d_ff  # rwkv channel-mix (2 matrices)
            total += 2 * norm_p
        if self.enc_dec:  # decoder side (cross-attn + self-attn + ffn)
            for _ in range(L):
                total += 2 * attn_params() + ffn_params(self.d_ff) + 3 * norm_p
        return int(total)

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only routed top-k + shared)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        m = self.moe
        n_moe_layers = self.n_layers - m.n_dense_layers
        mats = 3 if self.mlp in ("swiglu", "geglu") else 2
        per_expert = mats * self.d_model * m.d_expert
        inactive = n_moe_layers * (m.n_experts - m.top_k) * per_expert
        return int(full - inactive)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Shrink a config to smoke-test scale, preserving family/topology."""
    small: Dict = dict(
        n_layers=min(cfg.n_layers, 2 if not cfg.recurrent else len((cfg.recurrent.pattern or ("rec",))) * 2),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=32,
        d_ff=256,
        vocab=512,
        dtype="float32",
        logits_dtype="float32",
        enc_len=32 if cfg.enc_dec else cfg.enc_len,
    )
    if cfg.moe is not None:
        small["moe"] = dataclasses.replace(
            cfg.moe, n_experts=min(cfg.moe.n_experts, 8), d_expert=64,
            n_dense_layers=min(cfg.moe.n_dense_layers, 1),
            top_k=min(cfg.moe.top_k, 2), group_size=16,
        )
    if cfg.mla is not None:
        small["mla"] = MLAConfig(
            q_lora_rank=64 if cfg.mla.q_lora_rank else None, kv_lora_rank=32,
            qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
        )
    if cfg.recurrent is not None:
        small["recurrent"] = dataclasses.replace(
            cfg.recurrent, head_size=32,
            lru_width=128 if cfg.recurrent.lru_width else None,
        )
    if cfg.attn_window:
        small["attn_window"] = 16
    if cfg.rope == "mrope":
        # rescale the t/h/w frequency sections to the reduced head_dim
        half = small.get("head_dim", cfg.head_dim) // 2
        tot = sum(cfg.mrope_sections)
        secs = [max(1, s * half // tot) for s in cfg.mrope_sections]
        secs[0] += half - sum(secs)
        small["mrope_sections"] = tuple(secs)
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
