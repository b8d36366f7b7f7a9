"""Attention on torch — the tp = 1 subset of ``repro/models/attention.py``.

GQA, for the dense stacks, granite-moe's and jamba's attention layers:
projections with optional QKV bias, RoPE, sliding windows and logit
soft caps; prefill through the sliding-window kernel, and one-token
decode against a bfloat16 / float or int8 KV cache kept as a ring
buffer on local layers.

MLA (DeepSeek-V3 latent attention): a low-rank q, a shared latent c
(kv_lora wide) and one rope key per token; prefill decompresses per-head
keys and values from c and runs the same kernel with q / k at
``head_dim + qk_rope_head_dim`` against v at ``v_head_dim`` (deepseek-v3:
192 against 128); decode keeps only ``[c ‖ k_rope]`` per token and runs
the reference's absorbed products against it.

The sequence-sharded decode of tp > 1 is not ported (ROADMAP Queue 1
item 15).
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
    resolve_w,
    rms_norm,
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
                want_cache: bool = False, kv_dtype: str = "bfloat16",
                causal: bool = True):
    """x: (B, S, D) -> (out (B, S, D), cache | None).  ``layer_idx`` is
    the layer's index into the attention pattern (window selection);
    ``causal=False`` is the encoder's bidirectional self-attention.  The
    reference's ``_gqa_core`` without its tp > 1 branches."""
    a = cfg.attention
    hd = a.head_dim
    b, s = x.shape[:2]
    q = local_linear(x, p["wq"], p.get("bq")).reshape(b, s, a.num_heads, hd)
    k = local_linear(x, p["wk"], p.get("bk")).reshape(b, s, a.num_kv_heads, hd)
    v = local_linear(x, p["wv"], p.get("bv")).reshape(b, s, a.num_kv_heads, hd)
    q = rope(q, positions, a.rope_theta)
    k = rope(k, positions, a.rope_theta)

    o = flash_attention(q, k, v, causal=causal,
                        window=a.layer_window(layer_idx),
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
    if kv_dtype != "int8" and cache["k"].dtype != k_new.dtype:
        # the reference's dynamic_update_slice refuses the mix (a float32
        # cache from a prefill over float32 patch embeddings, and a
        # bfloat16 decode stream); the port does not cast it away
        raise ValueError(
            f"a {cache['k'].dtype} KV cache cannot take a {k_new.dtype} "
            "key: the prefill's stream and the decode stream differ in "
            "dtype")
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


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3)
# ---------------------------------------------------------------------------


def _mla_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(nope, rope, v head dims, kv latent width) of ``cfg``'s MLA."""
    a = cfg.attention
    return (a.head_dim, a.qk_rope_head_dim, a.v_head_dim or a.head_dim,
            a.kv_lora_rank)


def init_mla(gen: torch.Generator, cfg: ModelConfig, plan: ShardingPlan,
             dtype) -> Dict[str, torch.Tensor]:
    a = cfg.attention
    d, h = cfg.d_model, a.num_heads
    dn, dr, dv, dc = _mla_dims(cfg)
    ql = a.q_lora_rank or d
    dev = gen.device
    return {
        "w_dq": dense_init(gen, d, (d, ql), dtype),
        "q_norm": torch.zeros((ql,), dtype=dtype, device=dev),
        "w_uq": dense_init(gen, ql, (ql, h * (dn + dr)), dtype),
        "w_dkv": dense_init(gen, d, (d, dc + dr), dtype),
        "kv_norm": torch.zeros((dc,), dtype=dtype, device=dev),
        "w_uk": dense_init(gen, dc, (dc, h * dn), dtype),
        "w_uv": dense_init(gen, dc, (dc, h * dv), dtype),
        "wo": dense_init(gen, h * dv, (h * dv, d), dtype),
    }


def mla_forward(p, x: torch.Tensor, cfg: ModelConfig, layer_idx: int,
                plan: ShardingPlan, positions: torch.Tensor,
                want_cache: bool = False, kv_dtype: str = "bfloat16"):
    """x: (B, S, D) -> (out (B, S, D), cache | None).  Per-head keys
    ``[c w_uk ‖ rope(k_rope)]`` and values ``c w_uv`` go through the
    kernel, full causal, one kv head per query head; the cache is the
    (B, S, kv_lora + rope) payload ``[c ‖ rope(k_rope)]``, or its int8
    codes and a float32 scale per position."""
    a = cfg.attention
    h = a.num_heads
    dn, dr, dv, dc = _mla_dims(cfg)
    b, s = x.shape[:2]

    cq = rms_norm(local_linear(x, p["w_dq"]), p["q_norm"], cfg.norm_eps)
    q = local_linear(cq, p["w_uq"]).reshape(b, s, h, dn + dr)
    ckv = local_linear(x, p["w_dkv"])
    c = rms_norm(ckv[..., :dc], p["kv_norm"], cfg.norm_eps)
    q_rope = rope(q[..., dn:], positions, a.rope_theta)
    k_rope = rope(ckv[..., None, dc:], positions, a.rope_theta)  # (B,S,1,dr)

    k_nope = local_linear(c, p["w_uk"]).reshape(b, s, h, dn)
    v = local_linear(c, p["w_uv"]).reshape(b, s, h, dv)
    q_full = torch.cat([q[..., :dn], q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope.expand(b, s, h, dr)], dim=-1)

    o = flash_attention(q_full, k_full, v)
    out = local_linear(o.reshape(b, s, h * dv), p["wo"])

    cache = None
    if want_cache:
        payload = torch.cat([c, k_rope[:, :, 0]], dim=-1)
        if kv_dtype == "int8":
            cq_, cs = quantize_kv(payload)
            cache = {"c": cq_, "c_scale": cs}
        else:
            cache = {"c": payload}
    return out, cache


def mla_decode(p, x: torch.Tensor, cache, pos: int, cfg: ModelConfig,
               layer_idx: int, plan: ShardingPlan,
               kv_dtype: str = "bfloat16"):
    """x: (B, 1, D) at absolute position ``pos``; cache ``c``
    (B, S_cache, kv_lora + rope), linear in the position (MLA has no
    window).  The reference's absorbed products, in its rounding order:
    ``q_nope w_uk^T`` summed in float32 and rounded to x's dtype, its
    product with c plus the rope logits in float32, scaled by
    ``(nope + rope)^-0.5`` and masked at -1e30 past ``pos``; the softmax,
    ``p c`` in float32, then ``w_uv`` and ``wo``.  Returns ((B, 1, D),
    cache); the cache is updated in place."""
    a = cfg.attention
    h = a.num_heads
    dn, dr, dv, dc = _mla_dims(cfg)
    b = x.shape[0]

    cq = rms_norm(local_linear(x, p["w_dq"]), p["q_norm"], cfg.norm_eps)
    q = local_linear(cq, p["w_uq"]).reshape(b, h, dn + dr)
    posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q_nope = q[..., :dn]
    q_rope = rope(q[:, None, :, dn:], posv, a.rope_theta)[:, 0]  # (B,H,dr)

    ckv = local_linear(x, p["w_dkv"])[:, 0]  # (B, dc + dr)
    c_new = rms_norm(ckv[..., :dc], p["kv_norm"], cfg.norm_eps)
    kr_new = rope(ckv[:, None, None, dc:], posv, a.rope_theta)[:, 0, 0]
    payload = torch.cat([c_new, kr_new], dim=-1)  # (B, dc + dr)
    if kv_dtype == "int8":
        pq, ps = quantize_kv(payload)
        cache["c"][:, pos] = pq
        cache["c_scale"][:, pos] = ps
        stored = dequantize_kv(cache["c"], cache["c_scale"], x.dtype)
    else:
        cache["c"][:, pos] = payload
        stored = cache["c"]
    c_all, kr_all = stored[..., :dc], stored[..., dc:]

    # absorb w_uk into q: (B, H, dn) x (H, dn, dc), float32 sums
    w_uk = resolve_w(p["w_uk"], x).reshape(dc, h, dn).to(q.dtype)
    q_abs = torch.matmul(q_nope.float().transpose(0, 1),
                         w_uk.float().permute(1, 2, 0)).transpose(0, 1)
    logits = torch.matmul(q_abs.to(x.dtype).float(),
                          c_all.float().transpose(1, 2))          # (B,H,S)
    logits = logits + torch.matmul(q_rope.float(),
                                   kr_all.to(q_rope.dtype).float()
                                   .transpose(1, 2))
    logits = logits * (dn + dr) ** -0.5
    valid = torch.arange(c_all.shape[1], device=x.device) <= pos
    logits = torch.where(valid, logits, torch.full_like(logits, MASKED))
    probs = torch.softmax(logits, dim=-1)
    ctx = torch.matmul(probs.to(x.dtype).float(), c_all.float())  # (B,H,dc)
    w_uv = resolve_w(p["w_uv"], x).reshape(dc, h, dv).float()
    o = torch.matmul(ctx.transpose(0, 1), w_uv.permute(1, 0, 2))  # (H,B,dv)
    o = o.transpose(0, 1).reshape(b, 1, h * dv).to(x.dtype)
    return local_linear(o, p["wo"]), cache


def mla_cache_shape(cfg: ModelConfig, plan: ShardingPlan, batch: int,
                    s_max: int, kv_dtype: str):
    """{name: (shape, dtype)} of one MLA layer's decode cache: the
    ``[c ‖ k_rope]`` payload per position (+ its float32 scale when
    int8)."""
    _, dr, _, dc = _mla_dims(cfg)
    dt = torch.int8 if kv_dtype == "int8" else torch.bfloat16
    shapes = {"c": ((batch, s_max, dc + dr), dt)}
    if kv_dtype == "int8":
        shapes["c_scale"] = ((batch, s_max, 1), torch.float32)
    return shapes
