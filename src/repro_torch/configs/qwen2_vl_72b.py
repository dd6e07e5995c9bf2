"""Qwen2-VL-72B backbone [arXiv:2409.12191; hf].

80L, d_model=8192, 64 heads (GQA kv=8, head_dim=128), d_ff=29568,
vocab=152064.  M-RoPE (multimodal rotary: temporal/height/width sections
16/24/24 over the 64 half-dims); the vision front end (dynamic-resolution
ViT) is a stub, as in the JAX package: the model takes fused M-RoPE
position ids ``position_ids`` (3, B, S) beside the tokens.
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b",
        family="vlm",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=29568,
        vocab=152064,
        act="silu",
        mlp="swiglu",
        norm="rmsnorm",
        qkv_bias=True,
        rope="mrope",
        rope_theta=1000000.0,
        mrope_sections=(16, 24, 24),
        tie_embeddings=False,
        needs_position_ids=True,
    )
