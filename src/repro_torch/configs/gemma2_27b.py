"""gemma2-27b [dense] — alternating local:global attention + logit softcaps.

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000  [arXiv:2408.00118]
window=4096 on local layers; attn softcap 50.0; final-logit softcap 30.0.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, register


@register
def gemma2_27b() -> ModelConfig:
    return ModelConfig(
        name="gemma2-27b",
        family="dense",
        num_layers=46,
        d_model=4608,
        d_ff=36864,
        vocab_size=256_000,
        attention=AttentionConfig(
            kind="gqa",
            num_heads=32,
            num_kv_heads=16,
            head_dim=128,
            rope_theta=10_000.0,
            pattern=("local", "global"),
            window=4096,
            softcap=50.0,
        ),
        activation="gelu",
        final_softcap=30.0,
        tie_embeddings=True,
        max_seq_len=8_192,
        source="arXiv:2408.00118; hf:google/gemma-2-27b",
    )
