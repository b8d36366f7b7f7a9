"""jamba-v0.1-52b [hybrid] — Mamba+attn 1:7 interleave, MoE 16e top-2.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536  [arXiv:2403.19887]
Attention appears once per 8-layer block (position 4); every other layer's
MLP is MoE (16 experts, top-2).
"""
from repro_torch.configs.base import (
    AttentionConfig,
    ModelConfig,
    MoEConfig,
    SSMConfig,
    register,
)


@register
def jamba_v0_1_52b() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        num_layers=32,
        d_model=4096,
        d_ff=14336,
        vocab_size=65536,
        attention=AttentionConfig(
            kind="gqa",
            num_heads=32,
            num_kv_heads=8,
            head_dim=128,
            rope_theta=10_000.0,  # jamba uses no positional embedding on
            # mamba layers; attn layers carry RoPE here for generality
        ),
        moe=MoEConfig(
            num_experts=16,
            top_k=2,
            d_ff_expert=14336,
            period=2,
            offset=1,
        ),
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
        layer_cycle=(
            "mamba", "mamba", "mamba", "mamba",
            "attn", "mamba", "mamba", "mamba",
        ),
        activation="silu",
        max_seq_len=262_144,
        source="arXiv:2403.19887; hf:ai21labs/Jamba-v0.1",
    )
