"""minitron-8b [dense] — width-pruned Nemotron-4 15B.

32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000  [arXiv:2407.14679]
Nemotron family uses squared-ReLU MLPs (no gating).
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, register


@register
def minitron_8b() -> ModelConfig:
    return ModelConfig(
        name="minitron-8b",
        family="dense",
        num_layers=32,
        d_model=4096,
        d_ff=16384,
        vocab_size=256_000,
        attention=AttentionConfig(
            kind="gqa",
            num_heads=32,
            num_kv_heads=8,
            head_dim=128,
            rope_theta=10_000.0,
        ),
        activation="relu2",  # squared ReLU, 2-matrix MLP
        tie_embeddings=False,
        max_seq_len=4_096,
        source="arXiv:2407.14679; hf:nvidia/Minitron-8B-Base",
    )
