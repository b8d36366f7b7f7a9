"""GQA attention on torch — the GQA, tp = 1 subset of
``repro/models/attention.py``, for every attention layer the port runs
(the dense stacks, granite-moe's, jamba's one in eight): projections
with optional QKV bias, RoPE, sliding windows and logit soft caps;
prefill through the sliding-window kernel, and one-token decode against
a bfloat16 / float or int8 KV cache kept as a ring buffer on local
layers.

MLA (DeepSeek-V3 latent attention) and the sequence-sharded decode of
tp > 1 are not ported (ROADMAP Queue 1 items 14 and 15).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (
    ShardingPlan,
    dense_init,
    flash_attention,
    local_linear,
    rope,
    softcap,
)

MASKED = -1e30

# ---------------------------------------------------------------------------
# int8 KV-cache quantization (Domino: 8-bit residency)
# ---------------------------------------------------------------------------


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., S, D) -> int8 values + a float32 scale per (..., S)."""
    amax = torch.amax(torch.abs(x.float()), dim=-1, keepdim=True)
    scale = torch.clamp_min(amax, 1e-6) / 127.0
    q = torch.clamp(torch.round(x / scale), -128, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype
                  ) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------


def init_gqa(gen: torch.Generator, cfg: ModelConfig, plan: ShardingPlan,
             dtype) -> Dict[str, torch.Tensor]:
    a = cfg.attention
    d, hd = cfg.d_model, a.head_dim
    h, kv = a.num_heads, a.num_kv_heads
    p = {
        "wq": dense_init(gen, d, (d, h * hd), dtype),
        "wk": dense_init(gen, d, (d, kv * hd), dtype),
        "wv": dense_init(gen, d, (d, kv * hd), dtype),
        "wo": dense_init(gen, h * hd, (h * hd, d), dtype),
    }
    if a.qkv_bias:
        for name, width in (("bq", h * hd), ("bk", kv * hd), ("bv", kv * hd)):
            p[name] = torch.zeros((width,), dtype=dtype, device=gen.device)
    return p


def gqa_forward(p, x: torch.Tensor, cfg: ModelConfig, layer_idx: int,
                plan: ShardingPlan, positions: torch.Tensor,
                want_cache: bool = False, kv_dtype: str = "bfloat16"):
    """x: (B, S, D) -> (out (B, S, D), cache | None).  ``layer_idx`` is
    the layer's index into the attention pattern (window selection).
    The reference's ``_gqa_core`` without its tp > 1 branches."""
    a = cfg.attention
    hd = a.head_dim
    b, s = x.shape[:2]
    q = local_linear(x, p["wq"], p.get("bq")).reshape(b, s, a.num_heads, hd)
    k = local_linear(x, p["wk"], p.get("bk")).reshape(b, s, a.num_kv_heads, hd)
    v = local_linear(x, p["wv"], p.get("bv")).reshape(b, s, a.num_kv_heads, hd)
    q = rope(q, positions, a.rope_theta)
    k = rope(k, positions, a.rope_theta)

    o = flash_attention(q, k, v, window=a.layer_window(layer_idx),
                        logit_softcap=a.softcap)
    out = local_linear(o.reshape(b, s, a.num_heads * hd), p["wo"])

    cache = None
    if want_cache:
        if kv_dtype == "int8":
            kq, ks = quantize_kv(k)
            vq, vs = quantize_kv(v)
            cache = {"k": kq, "k_scale": ks, "v": vq, "v_scale": vs}
        else:
            cache = {"k": k, "v": v}
    return out, cache


def gqa_decode(p, x: torch.Tensor, cache, pos: int, cfg: ModelConfig,
               layer_idx: int, plan: ShardingPlan,
               kv_dtype: str = "bfloat16"):
    """x: (B, 1, D) at absolute position ``pos``; cache k / v
    (B, S_cache, KV, hd), a ring buffer on local layers (token p in slot
    ``p % ring``).  Returns ((B, 1, D), updated cache); the cache is
    updated in place (the reference returns a new one)."""
    a = cfg.attention
    hd = a.head_dim
    b = x.shape[0]
    h, kvh = a.num_heads, a.num_kv_heads

    q = local_linear(x, p["wq"], p.get("bq")).reshape(b, 1, h, hd)
    k_new = local_linear(x, p["wk"], p.get("bk")).reshape(b, 1, kvh, hd)
    v_new = local_linear(x, p["wv"], p.get("bv")).reshape(b, 1, kvh, hd)
    posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q = rope(q, posv, a.rope_theta)
    k_new = rope(k_new, posv, a.rope_theta)

    window = a.layer_window(layer_idx)
    s_max = cache["k"].shape[1]
    slot = pos if window is None else pos % _ring_len(window, s_max)
    if kv_dtype == "int8":
        kq, ks = quantize_kv(k_new)
        vq, vs = quantize_kv(v_new)
        cache["k"][:, slot] = kq[:, 0]
        cache["v"][:, slot] = vq[:, 0]
        cache["k_scale"][:, slot] = ks[:, 0]
        cache["v_scale"][:, slot] = vs[:, 0]
        k_all = dequantize_kv(cache["k"], cache["k_scale"], x.dtype)
        v_all = dequantize_kv(cache["v"], cache["v_scale"], x.dtype)
    else:
        cache["k"][:, slot] = k_new[:, 0]
        cache["v"][:, slot] = v_new[:, 0]
        k_all, v_all = cache["k"], cache["v"]

    # query head h attends with kv head h // group: group the query heads
    # instead of repeating the cache
    group = h // kvh
    qg = q.reshape(b, kvh, group, hd)                    # (B, KV, G, hd)
    kt = k_all.to(q.dtype).permute(0, 2, 3, 1)           # (B, KV, hd, S)
    logits = torch.matmul(qg.float(), kt.float()) * hd ** -0.5
    logits = softcap(logits, a.softcap)                  # (B, KV, G, S)
    s_len = k_all.shape[1]
    span = torch.arange(s_len, device=x.device)
    if window is None:
        valid = span <= pos
    else:
        ring = _ring_len(window, s_max)
        age = (pos % ring) - span  # ring-buffer distance
        age = torch.where(age < 0, age + ring, age)
        valid = (age < window) & (span < min(pos + 1, ring))
    logits = torch.where(valid, logits, torch.full_like(logits, MASKED))
    probs = torch.softmax(logits, dim=-1).to(v_all.dtype)
    o = torch.matmul(probs, v_all.permute(0, 2, 1, 3))   # (B, KV, G, hd)
    out = local_linear(o.reshape(b, 1, h * hd), p["wo"])
    return out, cache


def _ring_len(window: int, s_max: int) -> int:
    """Sliding-window layers keep a ring buffer of window (+1 slot)."""
    return min(s_max, window + 1)


def gqa_cache_shape(cfg: ModelConfig, plan: ShardingPlan, batch: int,
                    s_max: int, layer_idx: int, kv_dtype: str):
    """{name: (shape, dtype)} of one layer's decode cache."""
    a = cfg.attention
    window = a.layer_window(layer_idx)
    s = s_max if window is None else _ring_len(window, s_max)
    dt = torch.int8 if kv_dtype == "int8" else torch.bfloat16
    kvh = a.num_kv_heads
    shapes = {
        "k": ((batch, s, kvh, a.head_dim), dt),
        "v": ((batch, s, kvh, a.head_dim), dt),
    }
    if kv_dtype == "int8":
        shapes["k_scale"] = ((batch, s, kvh, 1), torch.float32)
        shapes["v_scale"] = ((batch, s, kvh, 1), torch.float32)
    return shapes
