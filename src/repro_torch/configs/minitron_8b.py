"""Minitron-8B — width/depth-pruned Nemotron-4 [arXiv:2407.14679; hf].

32L, d_model=4096, 32 heads (GQA kv=8), d_ff=16384, vocab=256000.
Nemotron family: squared-ReLU non-gated MLP, RoPE, no biases, untied
embeddings, RMSNorm.
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minitron-8b",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab=256000,
        act="relu2",
        mlp="mlp",
        norm="rmsnorm",
        rope="rope",
        rope_theta=10000.0,
        tie_embeddings=False,
    )
