"""Command R+ (104B) — Cohere [hf:CohereForAI/c4ai-command-r-plus; unverified].

64L, d_model=12288, 96 heads (GQA kv=8), d_ff=33792, vocab=256000.
Cohere family: bias-free LayerNorm, no QKV bias, tied embeddings, SiLU
gated MLP, RoPE.
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="command-r-plus-104b",
        family="dense",
        n_layers=64,
        d_model=12288,
        n_heads=96,
        n_kv_heads=8,
        head_dim=128,
        d_ff=33792,
        vocab=256000,
        act="silu",
        mlp="swiglu",
        norm="layernorm_nobias",
        rope="rope",
        rope_theta=75000.0,
        tie_embeddings=True,
    )
