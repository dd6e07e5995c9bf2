"""OLMo-1B [arXiv:2402.00838; hf].

16L, d_model=2048, 16 heads (MHA), d_ff=8192, vocab=50304.
OLMo signature: NON-PARAMETRIC LayerNorm (no scale/bias), SwiGLU, RoPE,
no biases, tied embeddings.
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b",
        family="dense",
        n_layers=16,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=8192,
        vocab=50304,
        act="silu",
        mlp="swiglu",
        norm="nonparametric",
        rope="rope",
        tie_embeddings=True,
    )
