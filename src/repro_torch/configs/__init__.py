"""Config registry: importing this package registers every assigned arch."""
from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    AttentionConfig,
    FrontendConfig,
    ModelConfig,
    MoEConfig,
    ParallelConfig,
    ServeConfig,
    ShapeConfig,
    SSMConfig,
    TrainConfig,
    get_config,
    list_archs,
    register,
    shape_applicable,
)

# side-effect imports: each module registers its ModelConfig
from repro_torch.configs import (  # noqa: F401
    deepseek_v3_671b,
    falcon_mamba_7b,
    gemma2_27b,
    gemma3_1b,
    granite_moe_3b_a800m,
    internvl2_2b,
    jamba_v0_1_52b,
    minitron_8b,
    qwen2_0_5b,
    seamless_m4t_large_v2,
)
from repro_torch.configs.cnn import CNN_BENCHMARKS  # noqa: F401

ASSIGNED_ARCHS = (
    "jamba-v0.1-52b",
    "internvl2-2b",
    "falcon-mamba-7b",
    "gemma3-1b",
    "qwen2-0.5b",
    "minitron-8b",
    "gemma2-27b",
    "deepseek-v3-671b",
    "granite-moe-3b-a800m",
    "seamless-m4t-large-v2",
)
