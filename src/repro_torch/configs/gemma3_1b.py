"""gemma3-1b [dense] — 5:1 local:global sliding-window attention.

26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144
[hf:google/gemma-3-1b-pt]  head_dim=256, window=512, tied embeddings.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, register


@register
def gemma3_1b() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b",
        family="dense",
        num_layers=26,
        d_model=1152,
        d_ff=6912,
        vocab_size=262_144,
        attention=AttentionConfig(
            kind="gqa",
            num_heads=4,
            num_kv_heads=1,
            head_dim=256,
            rope_theta=1_000_000.0,
            pattern=("local", "local", "local", "local", "local", "global"),
            window=512,
        ),
        activation="gelu",
        tie_embeddings=True,
        max_seq_len=131_072,
        source="hf:google/gemma-3-1b-pt (Gemma 3 technical report)",
    )
