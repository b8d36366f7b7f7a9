"""internvl2-2b [vlm] — InternViT frontend (STUB) + InternLM2-1.8B backbone.

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553  [arXiv:2404.16821]
The ViT is a stub per spec: input_specs() provides precomputed patch
embeddings (1024-d InternViT-300M features); the model owns the MLP
projector and the LM backbone.
"""
from repro_torch.configs.base import AttentionConfig, FrontendConfig, ModelConfig, register


@register
def internvl2_2b() -> ModelConfig:
    return ModelConfig(
        name="internvl2-2b",
        family="vlm",
        num_layers=24,
        d_model=2048,
        d_ff=8192,
        vocab_size=92553,
        attention=AttentionConfig(
            kind="gqa",
            num_heads=16,
            num_kv_heads=8,
            head_dim=128,
            rope_theta=1_000_000.0,
        ),
        frontend=FrontendConfig(kind="vit_stub", embed_dim=1024, num_tokens=256),
        activation="silu",
        tie_embeddings=False,
        max_seq_len=32_768,
        source="arXiv:2404.16821; hf:OpenGVLab/InternVL2-2B",
    )
