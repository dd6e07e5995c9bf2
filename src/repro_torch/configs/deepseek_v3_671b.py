"""DeepSeek-V3 (671B total / 37B active) [arXiv:2412.19437; hf].

61L, d_model=7168, 128 heads, vocab=129280.  MLA attention (q_lora 1536,
kv_lora 512, nope 128 + rope 64 per head, v 128); first 3 layers dense FFN
(d_ff=18432), remaining 58 layers MoE: 1 shared + 256 routed top-8 experts
of d_expert=2048, sigmoid router with normalised gates.

Not implemented, as in the JAX package: the MTP (multi-token-prediction)
auxiliary head.

Dispatch default is ``einsum`` (t5x-style capacity dispatch), the JAX
package's default and the route the port serves; ``sort`` is the other
route of ``models/moe.py``.
"""
from ..models.config import MLAConfig, ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b",
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=128,
        n_kv_heads=128,
        head_dim=128,
        d_ff=18432,            # dense layers' FFN width
        vocab=129280,
        act="silu",
        mlp="swiglu",
        norm="rmsnorm",
        rope="rope",
        rope_theta=10000.0,
        tie_embeddings=False,
        attention="mla",
        mla=MLAConfig(
            q_lora_rank=1536,
            kv_lora_rank=512,
            qk_nope_head_dim=128,
            qk_rope_head_dim=64,
            v_head_dim=128,
        ),
        moe=MoEConfig(
            n_experts=256,
            n_shared_experts=1,
            top_k=8,
            d_expert=2048,
            n_dense_layers=3,
            router_act="sigmoid",
            group_size=256,
            dispatch="einsum",
        ),
    )
