"""Whisper-tiny [arXiv:2212.04356; unverified].

Encoder-decoder, 4L each side, d_model=384, 6 heads (MHA), d_ff=1536,
vocab=51865.  The conv audio front end is a stub, as in the JAX package:
the model takes precomputed frame embeddings ``frames`` (B, 1500, d_model).
GELU, plain (non-gated) MLP, LayerNorm with bias, sinusoidal positions
(rope="none").
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny",
        family="audio",
        n_layers=4,
        d_model=384,
        n_heads=6,
        n_kv_heads=6,
        head_dim=64,
        d_ff=1536,
        vocab=51865,
        act="gelu",
        mlp="mlp",
        norm="layernorm",
        rope="none",
        tie_embeddings=True,
        enc_dec=True,
        enc_len=1500,
    )
