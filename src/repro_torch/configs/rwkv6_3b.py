"""RWKV6-3B "Finch" [arXiv:2404.05892; hf].

32L, d_model=2560 (attention-free), channel-mix d_ff=8960, vocab=65536.
Data-dependent per-channel decay (the Finch signature), head_size=64
(40 heads).  State is O(H * N^2) regardless of context length.
"""
from ..models.config import ModelConfig, RecurrentConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b",
        family="ssm",
        n_layers=32,
        d_model=2560,
        n_heads=40,
        n_kv_heads=40,
        head_dim=64,
        d_ff=8960,
        vocab=65536,
        norm="layernorm",
        rope="none",
        attention="none",
        tie_embeddings=False,
        recurrent=RecurrentConfig(kind="rwkv6", head_size=64),
    )
