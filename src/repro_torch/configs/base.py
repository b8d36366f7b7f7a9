"""Config system: model / mesh / train / serve configs and the arch registry.

Every assigned architecture lives in its own module under ``repro.configs``
and registers a :class:`ModelConfig` via :func:`register`.  Configs are
frozen dataclasses so they can be hashed into jit static args.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field, replace
from typing import Callable, Optional, Tuple

# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AttentionConfig:
    """GQA / MLA attention settings."""

    kind: str = "gqa"  # "gqa" | "mla"
    num_heads: int = 8
    num_kv_heads: int = 8
    head_dim: int = 64
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    # sliding-window pattern: cycle over layers, each entry "global" or
    # "local".  gemma3 = 5 local : 1 global; gemma2 alternates.
    pattern: Tuple[str, ...] = ("global",)
    window: Optional[int] = None  # size of the local window
    softcap: Optional[float] = None  # attention-logit soft cap (gemma2)
    # --- MLA (deepseek-v3) ---
    q_lora_rank: Optional[int] = None
    kv_lora_rank: Optional[int] = None
    qk_rope_head_dim: int = 0
    v_head_dim: Optional[int] = None

    def layer_window(self, layer_idx: int) -> Optional[int]:
        """Window for this layer (None = full/global attention)."""
        if self.pattern[layer_idx % len(self.pattern)] == "local":
            return self.window
        return None

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def v_dim(self) -> int:
        return self.num_heads * (self.v_head_dim or self.head_dim)


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    d_ff_expert: int = 2048
    num_shared_experts: int = 0
    # which layers are MoE: layer l is MoE iff l >= first_dense and
    # (l - offset) % period == 0
    period: int = 1
    offset: int = 0
    first_dense: int = 0
    router_noise: float = 0.0
    aux_loss_coef: float = 0.01
    capacity_factor: float = 1.25

    def is_moe_layer(self, layer_idx: int) -> bool:
        if layer_idx < self.first_dense:
            return False
        return (layer_idx - self.offset) % self.period == 0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-1 block settings."""

    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)

    def resolved_dt_rank(self, d_model: int) -> int:
        return self.dt_rank or max(1, math.ceil(d_model / 16))


@dataclass(frozen=True)
class FrontendConfig:
    """Modality frontend STUB: input_specs() ships precomputed embeddings."""

    kind: str = "none"  # "vit_stub" | "speech_stub"
    embed_dim: int = 0  # dimensionality of the precomputed embeddings
    num_tokens: int = 0  # image-patch / audio-frame tokens per example


# ---------------------------------------------------------------------------
# ModelConfig
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attention: Optional[AttentionConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    frontend: Optional[FrontendConfig] = None
    # per-layer kind cycle: "attn" | "mamba"; hybrid archs override.
    layer_cycle: Tuple[str, ...] = ("attn",)
    activation: str = "silu"  # silu | gelu | relu2
    norm_eps: float = 1e-6
    final_softcap: Optional[float] = None  # gemma2 final-logit cap
    tie_embeddings: bool = False
    encoder_layers: int = 0  # >0 => encoder-decoder (seamless)
    mtp_depth: int = 0  # deepseek multi-token-prediction heads
    max_seq_len: int = 131_072
    # numerics
    dtype: str = "bfloat16"
    # source provenance (public literature)
    source: str = ""

    # -- structural helpers ------------------------------------------------

    def layer_kind(self, layer_idx: int) -> str:
        return self.layer_cycle[layer_idx % len(self.layer_cycle)]

    @property
    def num_attn_layers(self) -> int:
        return sum(1 for l in range(self.num_layers) if self.layer_kind(l) == "attn")

    @property
    def num_mamba_layers(self) -> int:
        return self.num_layers - self.num_attn_layers

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def subquadratic(self) -> bool:
        """True if decode-time per-token cost does not grow ~seq_len for the
        dominant layer type (SSM / hybrid archs) -> eligible for long_500k."""
        return self.family in ("ssm", "hybrid")

    # -- parameter counting (used for 6ND model-FLOPs and memory planning) --

    def param_count(self, active_only: bool = False) -> int:
        """Analytic parameter count.  ``active_only`` counts only the params
        touched per token (MoE top-k + shared instead of all experts)."""
        d = self.d_model
        total = 0
        # embeddings (+ output head unless tied)
        total += self.vocab_size * d
        if not self.tie_embeddings:
            total += self.vocab_size * d

        def attn_params() -> int:
            a = self.attention
            assert a is not None
            if a.kind == "mla":
                p = d * (a.q_lora_rank or d)
                if a.q_lora_rank:
                    p += a.q_lora_rank * a.num_heads * (a.head_dim + a.qk_rope_head_dim)
                p += d * (a.kv_lora_rank + a.qk_rope_head_dim)
                p += a.kv_lora_rank * a.num_heads * (a.head_dim + (a.v_head_dim or a.head_dim))
                p += a.num_heads * (a.v_head_dim or a.head_dim) * d
                return p
            q = d * a.num_heads * a.head_dim
            kv = 2 * d * a.num_kv_heads * a.head_dim
            o = a.num_heads * a.head_dim * d
            return q + kv + o

        def mlp_params(d_ff: int) -> int:
            n_mat = 3 if self.activation in ("silu", "gelu") else 2  # gated vs plain
            return n_mat * d * d_ff

        def mamba_params() -> int:
            s = self.ssm
            assert s is not None
            d_in = s.expand * d
            dt_rank = s.resolved_dt_rank(d)
            p = d * d_in * 2  # in_proj (x and z branches)
            p += d_in * s.d_conv  # depthwise conv
            p += d_in * (dt_rank + 2 * s.d_state)  # x_proj
            p += dt_rank * d_in + d_in  # dt_proj
            p += d_in * s.d_state + d_in  # A_log, D
            p += d_in * d  # out_proj
            return p

        n_layers = self.num_layers + self.encoder_layers
        for l in range(self.num_layers):
            if self.layer_kind(l) == "mamba":
                total += mamba_params()
            else:
                total += attn_params()
                if self.is_encdec:
                    total += attn_params()  # cross-attention
            if self.moe is not None and self.moe.is_moe_layer(l):
                n_exp = (self.moe.top_k if active_only else self.moe.num_experts)
                n_exp += self.moe.num_shared_experts
                total += n_exp * mlp_params(self.moe.d_ff_expert)
                total += d * self.moe.num_experts  # router
            else:
                total += mlp_params(self.d_ff)
        for _ in range(self.encoder_layers):
            total += attn_params() + mlp_params(self.d_ff)
        # norms (small)
        total += (2 * n_layers + 1) * d
        return total

    # -- smoke-test reduction ----------------------------------------------

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        a = self.attention
        if a is not None:
            ratio = max(1, a.num_heads // max(1, a.num_kv_heads))
            a = replace(
                a,
                num_heads=4,
                num_kv_heads=max(1, 4 // ratio),
                head_dim=16,
                q_lora_rank=32 if a.q_lora_rank else None,
                kv_lora_rank=32 if a.kv_lora_rank else None,
                qk_rope_head_dim=8 if a.qk_rope_head_dim else 0,
                v_head_dim=16 if a.v_head_dim else None,
                window=8 if a.window else None,
            )
        m = self.moe
        if m is not None:
            m = replace(
                m,
                num_experts=4,
                top_k=min(2, m.top_k),
                d_ff_expert=64,
                first_dense=min(1, m.first_dense),
                # tiny smoke batches: generous capacity so no tokens drop
                # (keeps prefill==decode exactly reproducible)
                capacity_factor=4.0,
            )
        s = self.ssm
        if s is not None:
            s = replace(s, d_state=4, d_conv=2)
        # keep at least one full layer_cycle so hybrids stay hybrid
        n_layers = max(2, min(len(self.layer_cycle), 8))
        fe = self.frontend
        if fe is not None and fe.kind != "none":
            fe = replace(fe, embed_dim=32, num_tokens=4)
        return replace(
            self,
            num_layers=n_layers,
            d_model=64,
            d_ff=128,
            vocab_size=256,
            attention=a,
            moe=m,
            ssm=s,
            frontend=fe,
            encoder_layers=2 if self.encoder_layers else 0,
            mtp_depth=min(self.mtp_depth, 1),
            max_seq_len=128,
        )


# ---------------------------------------------------------------------------
# Input-shape configs (assigned shape set)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(model: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """(applicable, reason).  long_500k needs sub-quadratic decode."""
    if shape.name == "long_500k" and not model.subquadratic:
        return False, (
            f"{model.name} is pure full-attention ({model.family}); long_500k "
            "requires sub-quadratic decode (SSM/hybrid) - skipped per spec"
        )
    return True, ""


# ---------------------------------------------------------------------------
# Mesh / parallelism / runtime configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ParallelConfig:
    """How the model maps onto the mesh — the hillclimb levers."""

    # Domino reduction discipline for TP linears: "ring" (computing-on-the-
    # move, paper) or "allreduce" (conventional baseline).
    reduction: str = "ring"
    # remat policy for the layer scan: "full" | "none" | "dots"
    remat: str = "full"
    # gradient-accumulation microbatches in train_step
    microbatches: int = 1
    # shard optimizer state over these mesh axes (ZeRO)
    zero_axes: Tuple[str, ...] = ("data", "model")
    # int8 CIM weights for serving (paper: ReRAM stores 8-bit weights)
    cim_weights: bool = False
    # int8 KV cache
    kv_cache_dtype: str = "bfloat16"  # or "int8"
    # int8 gradient all-reduce with error feedback
    grad_compression: bool = False
    # sequence-parallel attention for decode when batch < data axis
    seq_sharded_cache: bool = True
    # ZeRO-3/FSDP: params sharded over the data axes too, gathered
    # per-cycle inside the layer scan (for >100B-param training)
    zero3: bool = False
    zero3_min_size: int = 1 << 22  # only shard leaves >= this many elems
    # pod-scale weight duplication (paper §5.3/Fig. 7): replicate weights
    # and run pure DP over every mesh axis — for models that fit per-chip
    # it removes all activation collectives (grad sync only)
    dp_only: bool = False


@dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "adamw"  # adamw | adafactor | sgd
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1_000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    moment_dtype: str = "float32"  # bf16 moments halve optimizer HBM
    seed: int = 0
    checkpoint_every: int = 200
    checkpoint_dir: str = "/tmp/repro_ckpt"
    keep_checkpoints: int = 3


@dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 8
    max_seq_len: int = 4096
    temperature: float = 0.0
    cim_weights: bool = True
    kv_cache_dtype: str = "bfloat16"


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict = {}


def register(cfg_fn: Callable[[], ModelConfig]) -> Callable[[], ModelConfig]:
    cfg = cfg_fn()
    _REGISTRY[cfg.name] = cfg_fn
    return cfg_fn


def get_config(name: str) -> ModelConfig:
    # import arch modules lazily so `repro.configs` has no import cost
    from repro_torch import configs as _pkg  # noqa: F401  (side-effect imports)

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch '{name}'; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> list:
    from repro_torch import configs as _pkg  # noqa: F401

    return sorted(_REGISTRY)
