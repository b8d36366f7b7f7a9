"""falcon-mamba-7b [ssm] — attention-free pure Mamba-1 stack.

64L d_model=4096 d_ff=0 vocab=65024 ssm_state=16  [arXiv:2410.05355]
Pure mamba blocks: no attention, no separate MLP (d_ff=0).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register


@register
def falcon_mamba_7b() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b",
        family="ssm",
        num_layers=64,
        d_model=4096,
        d_ff=0,  # mamba blocks only — no interleaved MLP
        vocab_size=65024,
        attention=None,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
        layer_cycle=("mamba",),
        activation="silu",
        tie_embeddings=False,
        max_seq_len=1_048_576,  # SSM: unbounded in principle
        source="arXiv:2410.05355; hf:tiiuae/falcon-mamba-7b",
    )
