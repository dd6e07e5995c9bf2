"""RecurrentGemma-9B (Griffin) [arXiv:2402.19427; unverified].

38L, d_model=4096, 16 heads (MQA kv=1, head_dim=256), d_ff=12288,
vocab=256000.  Block pattern 2:1 — (recurrent, recurrent, local-attention)
repeated; RG-LRU recurrence (lru_width=4096, conv width 4), local window
2048, GeGLU MLP.  The attention cache is the 2048-token ring buffer, plus
an O(W) recurrent state.
"""
from ..models.config import ModelConfig, RecurrentConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        n_layers=38,
        d_model=4096,
        n_heads=16,
        n_kv_heads=1,
        head_dim=256,
        d_ff=12288,
        vocab=256000,
        act="gelu",
        mlp="geglu",
        norm="rmsnorm",
        rope="rope",
        rope_theta=10000.0,
        tie_embeddings=True,
        attention="local",
        attn_window=2048,
        recurrent=RecurrentConfig(
            kind="rglru",
            conv_width=4,
            lru_width=4096,
            pattern=("rec", "rec", "attn"),
        ),
    )
