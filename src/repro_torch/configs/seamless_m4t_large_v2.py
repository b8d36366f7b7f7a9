"""seamless-m4t-large-v2 [audio] — encoder-decoder transformer backbone.

24L(enc)+24L(dec) d_model=1024 16H (kv=16) d_ff=8192 vocab=256206
[arXiv:2308.11596]  The speech frontend (w2v-BERT conformer) is a STUB per
spec: input_specs() provides precomputed frame embeddings (B, T, 1024).
"""
from repro_torch.configs.base import AttentionConfig, FrontendConfig, ModelConfig, register


@register
def seamless_m4t_large_v2() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2",
        family="audio",
        num_layers=24,  # decoder layers
        encoder_layers=24,
        d_model=1024,
        d_ff=8192,
        vocab_size=256_206,
        attention=AttentionConfig(
            kind="gqa",
            num_heads=16,
            num_kv_heads=16,
            head_dim=64,
            rope_theta=10_000.0,
        ),
        frontend=FrontendConfig(kind="speech_stub", embed_dim=1024, num_tokens=0),
        activation="gelu",
        tie_embeddings=True,
        max_seq_len=32_768,
        source="arXiv:2308.11596; hf:facebook/seamless-m4t-v2-large",
    )
