"""deepseek-v3-671b [moe] — MLA + 1 shared + 256 routed top-8 experts + MTP.

61L d_model=7168 128H d_ff(expert)=2048 vocab=129280  [arXiv:2412.19437]
MLA: q_lora=1536, kv_lora=512, qk_rope_head_dim=64, qk_nope=128, v_head=128.
First 3 layers are dense with d_ff=18432.  One MTP depth.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, MoEConfig, register


@register
def deepseek_v3_671b() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b",
        family="moe",
        num_layers=61,
        d_model=7168,
        d_ff=18432,  # the dense (first_dense) layers
        vocab_size=129_280,
        attention=AttentionConfig(
            kind="mla",
            num_heads=128,
            num_kv_heads=128,  # MLA: per-head K/V decompressed from kv_lora
            head_dim=128,  # qk_nope_head_dim
            rope_theta=10_000.0,
            q_lora_rank=1536,
            kv_lora_rank=512,
            qk_rope_head_dim=64,
            v_head_dim=128,
        ),
        moe=MoEConfig(
            num_experts=256,
            top_k=8,
            d_ff_expert=2048,
            num_shared_experts=1,
            period=1,
            first_dense=3,
            aux_loss_coef=0.0001,  # aux-loss-free balancing; tiny seq-wise term
        ),
        activation="silu",
        mtp_depth=1,
        tie_embeddings=False,
        max_seq_len=131_072,
        source="arXiv:2412.19437; hf:deepseek-ai/DeepSeek-V3",
    )
