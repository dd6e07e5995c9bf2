"""Qwen1.5-0.5B [hf:Qwen/Qwen1.5-0.5B; hf].

24L, d_model=1024, 16 heads (kv=16, i.e. MHA), d_ff=2816, vocab=151936.
QKV bias (the Qwen signature), RMSNorm, SwiGLU, tied embeddings.
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-0.5b",
        family="dense",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        head_dim=64,
        d_ff=2816,
        vocab=151936,
        act="silu",
        mlp="swiglu",
        norm="rmsnorm",
        qkv_bias=True,
        rope="rope",
        rope_theta=1000000.0,
        tie_embeddings=True,
    )
