"""granite-moe-3b-a800m [moe] — 40 experts, top-8, every layer MoE.

32L d_model=1536 24H (GQA kv=8) d_ff(expert)=512 vocab=49155
[hf:ibm-granite/granite-3.0-3b-a800m-base family]
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, MoEConfig, register


@register
def granite_moe_3b_a800m() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m",
        family="moe",
        num_layers=32,
        d_model=1536,
        d_ff=512,  # unused: every layer is MoE
        vocab_size=49_155,
        attention=AttentionConfig(
            kind="gqa",
            num_heads=24,
            num_kv_heads=8,
            head_dim=64,
            rope_theta=10_000.0,
        ),
        moe=MoEConfig(
            num_experts=40,
            top_k=8,
            d_ff_expert=512,
            period=1,
        ),
        activation="silu",
        tie_embeddings=True,
        max_seq_len=4_096,
        source="hf:ibm-granite/granite-3.0-3b-a800m-base",
    )
