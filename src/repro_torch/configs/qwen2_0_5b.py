"""qwen2-0.5b [dense] — GQA with QKV bias, tied embeddings.

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936  [arXiv:2407.10671]
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, register


@register
def qwen2_0_5b() -> ModelConfig:
    return ModelConfig(
        name="qwen2-0.5b",
        family="dense",
        num_layers=24,
        d_model=896,
        d_ff=4864,
        vocab_size=151_936,
        attention=AttentionConfig(
            kind="gqa",
            num_heads=14,
            num_kv_heads=2,
            head_dim=64,
            qkv_bias=True,
            rope_theta=1_000_000.0,
        ),
        activation="silu",
        tie_embeddings=True,
        max_seq_len=131_072,
        source="arXiv:2407.10671; hf:Qwen/Qwen2-0.5B",
    )
