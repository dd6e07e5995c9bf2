"""Qwen1.5/2-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B; hf].

24L, d_model=2048, 16 heads (MHA), vocab=151936.  MoE every layer:
60 routed experts (top-4) + 4 shared experts, expert d_ff=1408,
softmax router.  QKV bias, RMSNorm, SwiGLU experts.
"""
from ..models.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b",
        family="moe",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=1408,
        vocab=151936,
        act="silu",
        mlp="swiglu",
        norm="rmsnorm",
        qkv_bias=True,
        rope="rope",
        rope_theta=1000000.0,
        tie_embeddings=False,
        moe=MoEConfig(
            n_experts=60,
            n_shared_experts=4,
            top_k=4,
            d_expert=1408,
            n_dense_layers=0,
            router_act="softmax",
            group_size=512,
            dispatch="einsum",
        ),
    )
