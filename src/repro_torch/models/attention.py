"""Attention on torch (``repro/models/attention.py``).

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

At tp > 1 the reference's head sharding rules hold, per rank:

* ``plan.attn_sharded`` (H % tp == 0): query heads sharded over tp, the
  projections through ``up`` / ``down`` (Domino's ring or the
  baseline); the kernel runs at the rank's head count.
* ``plan.kv_sharded`` (KV % tp == 0): kv heads sharded too; otherwise
  the group trick: each rank computes the full (small) KV projection and
  keeps its group's head (:func:`_group_slice`), and its cache holds
  just that head.
* not attn_sharded: the stream is all-gathered and attention runs
  replicated, then each rank keeps its sequence chunk.  With
  ``plan.seq_cache`` the global layers' KV caches are sharded over
  their sequence dim (padded to a multiple of tp): the owning rank
  writes a decode step's key, and :func:`_seq_sharded_decode_attention`
  merges the ranks' partial softmax by log-sum-exp.
* decode psums the output projection's partial sums over the model axis
  where heads are sharded; MLA's too.

Training at tp > 1 differentiates the same per-rank program: the ring
matmuls' backward is the transposed ring, the replicated weights (the
group trick's kv projection, replicated attention, MLA's down
projections) get partial gradients that the train step sums over the
model axis, and the backward kernel runs at the rank's heads (MLA's
(192, 128) pair included).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import dataflow
from repro_torch.models.common import (
    ShardingPlan,
    dense_init,
    down,
    flash_attention,
    local_linear,
    psum_if,
    resolve_w,
    rms_norm,
    rope,
    softcap,
    up,
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
    hl = plan.heads_local(cfg)
    kv = plan.kv_local(cfg) if plan.kv_sharded else a.num_kv_heads
    p = {
        "wq": dense_init(gen, d, (d, hl * hd), dtype),
        "wk": dense_init(gen, d, (d, kv * hd), dtype),
        "wv": dense_init(gen, d, (d, kv * hd), dtype),
        "wo": dense_init(gen, hl * hd, (hl * hd, d), dtype),
    }
    if a.qkv_bias:
        for name, width in (("bq", hl * hd), ("bk", kv * hd),
                            ("bv", kv * hd)):
            p[name] = torch.zeros((width,), dtype=dtype, device=gen.device)
    return p


def stored_kv_heads(cfg: ModelConfig, plan: ShardingPlan) -> int:
    """KV heads held per rank (what its queries attend with)."""
    a = cfg.attention
    if not plan.attn_sharded:
        return a.num_kv_heads
    if plan.kv_sharded:
        return a.num_kv_heads if plan.global_shapes \
            else a.num_kv_heads // plan.tp
    # group trick: each rank keeps its group's head; globally the cache
    # is the tp-way group-repeated layout
    return plan.tp if plan.global_shapes else 1


def _group_slice(k_full: torch.Tensor, cfg: ModelConfig,
                 plan: ShardingPlan, hd: int) -> torch.Tensor:
    """This rank's kv group head out of the full KV projection."""
    a = cfg.attention
    hl = plan.heads_local(cfg)
    group = (plan.tp_index() * hl) // (a.num_heads // a.num_kv_heads)
    return k_full[..., group * hd:(group + 1) * hd]


def _bias_tail(p, name):
    """The reference's ``lambda t: t + p[name]`` on the float32 product
    (None without the bias)."""
    if name not in p:
        return None
    bias = p[name]
    return lambda t: t + bias


def gqa_forward(p, x: torch.Tensor, cfg: ModelConfig, layer_idx: int,
                plan: ShardingPlan, positions: torch.Tensor,
                want_cache: bool = False, kv_dtype: str = "bfloat16",
                causal: bool = True):
    """x: (B, S_local, D), sequence-sharded at tp > 1 -> (out, same
    shape; cache over the whole sequence | None).  ``layer_idx`` is the
    layer's index into the attention pattern (window selection);
    ``causal=False`` is the encoder's bidirectional self-attention.
    Without sharded heads at tp > 1 the stream is all-gathered, attention
    runs replicated and each rank keeps its sequence chunk."""
    if not plan.attn_sharded and plan.tp > 1:
        xg = dataflow.all_gather(x, plan.axis, dim=1)
        out, cache = _gqa_core(p, xg, cfg, layer_idx, plan, positions,
                               want_cache, kv_dtype, True, causal)
        chunk = out.shape[1] // plan.tp
        i = plan.tp_index()
        return out[:, i * chunk:(i + 1) * chunk].contiguous(), cache
    return _gqa_core(p, x, cfg, layer_idx, plan, positions, want_cache,
                     kv_dtype, False, causal)


def _gqa_core(p, x, cfg: ModelConfig, layer_idx: int, plan: ShardingPlan,
              positions, want_cache: bool, kv_dtype: str, replicated: bool,
              causal: bool):
    a = cfg.attention
    hd = a.head_dim
    b = x.shape[0]
    hl = plan.heads_local(cfg)
    kv_store = stored_kv_heads(cfg, plan)
    local = replicated or plan.tp == 1
    if local:
        q = local_linear(x, p["wq"], p.get("bq"))
        k = local_linear(x, p["wk"], p.get("bk"))
        v = local_linear(x, p["wv"], p.get("bv"))
    else:
        q = up(x, p["wq"], plan, tail=_bias_tail(p, "bq"))
        k = up(x, p["wk"], plan, tail=_bias_tail(p, "bk"))
        v = up(x, p["wv"], plan, tail=_bias_tail(p, "bv"))
        if not plan.kv_sharded:  # group trick: keep only our kv head
            k = _group_slice(k, cfg, plan, hd)
            v = _group_slice(v, cfg, plan, hd)
    s = q.shape[1]
    q = rope(q.reshape(b, s, hl, hd), positions, a.rope_theta)
    k = rope(k.reshape(b, s, kv_store, hd), positions, a.rope_theta)
    v = v.reshape(b, s, kv_store, hd)

    o = flash_attention(q, k, v, causal=causal,
                        window=a.layer_window(layer_idx),
                        logit_softcap=a.softcap).reshape(b, s, hl * hd)
    out = local_linear(o, p["wo"]) if local else down(o, p["wo"], plan)

    cache = None
    if want_cache:
        if kv_dtype == "int8":
            kq, ks = quantize_kv(k)
            vq, vs = quantize_kv(v)
            cache = {"k": kq, "k_scale": ks, "v": vq, "v_scale": vs}
        else:
            cache = {"k": k, "v": v}
    return out, cache


def _write(cache, names_values, slot: int) -> None:
    for name, val in names_values:
        cache[name][:, slot] = val[:, 0]


def gqa_decode(p, x: torch.Tensor, cache, pos: int, cfg: ModelConfig,
               layer_idx: int, plan: ShardingPlan,
               kv_dtype: str = "bfloat16"):
    """x: (B, 1, D) at absolute position ``pos``, replicated over the
    model axis; cache k / v (B, S_cache, KV_store, hd), a ring buffer on
    local layers (token p in slot ``p % ring``), or this rank's sequence
    chunk of a sequence-sharded cache.  Returns ((B, 1, D) fully
    reduced, updated cache); the cache is updated in place (the
    reference returns a new one)."""
    a = cfg.attention
    hd = a.head_dim
    b = x.shape[0]
    hl = plan.heads_local(cfg)
    kv_store = stored_kv_heads(cfg, plan)

    q = local_linear(x, p["wq"], p.get("bq")).reshape(b, 1, hl, hd)
    k_new = local_linear(x, p["wk"], p.get("bk"))
    v_new = local_linear(x, p["wv"], p.get("bv"))
    if plan.attn_sharded and not plan.kv_sharded and plan.tp > 1:
        k_new = _group_slice(k_new, cfg, plan, hd)
        v_new = _group_slice(v_new, cfg, plan, hd)
    k_new = k_new.reshape(b, 1, kv_store, hd)
    v_new = v_new.reshape(b, 1, kv_store, hd)
    posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q = rope(q, posv, a.rope_theta)
    k_new = rope(k_new, posv, a.rope_theta)

    window = a.layer_window(layer_idx)
    if kv_dtype != "int8" and cache["k"].dtype != k_new.dtype:
        # the reference's dynamic_update_slice refuses the mix (a float32
        # cache from a prefill over float32 patch embeddings, and a
        # bfloat16 decode stream); the port does not cast it away
        raise ValueError(
            f"a {cache['k'].dtype} KV cache cannot take a {k_new.dtype} "
            "key: the prefill's stream and the decode stream differ in "
            "dtype")
    seq_sharded = use_seq_cache(cfg, plan, window)
    s_max = cache["k"].shape[1]
    if seq_sharded:
        # only the chunk that owns ``pos`` writes it
        owner, slot = divmod(pos, s_max)
        write = owner == plan.tp_index()
    else:
        slot = pos if window is None else pos % _ring_len(window, s_max)
        write = True
    if kv_dtype == "int8":
        kq, ks = quantize_kv(k_new)
        vq, vs = quantize_kv(v_new)
        if write:
            _write(cache, (("k", kq), ("v", vq), ("k_scale", ks),
                           ("v_scale", vs)), slot)
        k_all = dequantize_kv(cache["k"], cache["k_scale"], x.dtype)
        v_all = dequantize_kv(cache["v"], cache["v_scale"], x.dtype)
    else:
        if write:
            _write(cache, (("k", k_new), ("v", v_new)), slot)
        k_all, v_all = cache["k"], cache["v"]

    if seq_sharded:
        o = _seq_sharded_decode_attention(q, k_all, v_all, pos, plan, hd,
                                          a.softcap)
        # weights replicated: no psum
        return local_linear(o.reshape(b, 1, hl * hd), p["wo"]), cache

    # query head h attends with kv head h // group: group the query heads
    # instead of repeating the cache
    group = hl // kv_store
    qg = q.reshape(b, kv_store, group, hd)               # (B, KV, G, hd)
    kt = k_all.to(q.dtype).permute(0, 2, 3, 1)           # (B, KV, hd, S)
    logits = torch.matmul(qg.float(), kt.float()) * hd ** -0.5
    logits = softcap(logits, a.softcap)                  # (B, KV, G, S)
    span = torch.arange(s_max, device=x.device)
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
    out = local_linear(o.reshape(b, 1, hl * hd), p["wo"])
    if plan.tp > 1 and plan.attn_sharded:
        out = psum_if(out, plan)
    return out, cache


def _ring_len(window: int, s_max: int) -> int:
    """Sliding-window layers keep a ring buffer of window (+1 slot)."""
    return min(s_max, window + 1)


def use_seq_cache(cfg: ModelConfig, plan: ShardingPlan, window) -> bool:
    """Sequence-shard the cache when heads cannot shard and the layer is
    global-attention (window ring buffers stay replicated: small)."""
    return (plan.seq_cache and plan.tp > 1 and not plan.attn_sharded
            and window is None)


def _pad_to(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


def gqa_cache_shape(cfg: ModelConfig, plan: ShardingPlan, batch: int,
                    s_max: int, layer_idx: int, kv_dtype: str):
    """{name: (shape, dtype)} of one layer's decode cache on one rank
    (the global one with ``plan.global_shapes``)."""
    a = cfg.attention
    kv_store = stored_kv_heads(cfg, plan)
    window = a.layer_window(layer_idx)
    s = s_max if window is None else _ring_len(window, s_max)
    if use_seq_cache(cfg, plan, window):
        s = _pad_to(s_max, plan.tp)
        if not plan.global_shapes:
            s //= plan.tp  # this rank's sequence chunk
    dt = torch.int8 if kv_dtype == "int8" else torch.bfloat16
    shapes = {
        "k": ((batch, s, kv_store, a.head_dim), dt),
        "v": ((batch, s, kv_store, a.head_dim), dt),
    }
    if kv_dtype == "int8":
        shapes["k_scale"] = ((batch, s, kv_store, 1), torch.float32)
        shapes["v_scale"] = ((batch, s, kv_store, 1), torch.float32)
    return shapes


def _seq_sharded_decode_attention(q: torch.Tensor, k_all: torch.Tensor,
                                  v_all: torch.Tensor, pos: int,
                                  plan: ShardingPlan, hd: int, cap
                                  ) -> torch.Tensor:
    """Flash-decode over the sequence-sharded cache: local partial
    attention, then the log-sum-exp merge over the model axis (the
    softmax analogue of Domino's group-sum merge).  q: (B, 1, H, hd);
    k / v: (B, chunk, KV, hd), this rank's chunk.  Returns (B, 1, H, hd)
    merged (replicated).  The reference's order of roundings: k cast to
    q's dtype, float32 logits; the probabilities in v's dtype against v,
    the float32 numerator and denominator scaled by ``exp(m_local -
    m_global)`` and summed over the axis."""
    b, _, hl, _ = q.shape
    kv_store = k_all.shape[2]
    chunk = k_all.shape[1]
    group = hl // kv_store
    qg = q.reshape(b, kv_store, group, hd)
    kt = k_all.to(q.dtype).permute(0, 2, 3, 1)
    logits = softcap(torch.matmul(qg.float(), kt.float()) * hd ** -0.5, cap)
    span = plan.tp_index() * chunk + torch.arange(chunk, device=q.device)
    valid = span <= pos
    logits = torch.where(valid, logits,
                         torch.full_like(logits, float("-inf")))
    m_local = torch.amax(logits, dim=-1, keepdim=True)   # (B, KV, G, 1)
    m_local = torch.where(torch.isfinite(m_local), m_local,
                          torch.full_like(m_local, -1e30))
    pr = torch.where(valid, torch.exp(logits - m_local),
                     torch.zeros_like(logits))
    num = torch.matmul(pr.to(v_all.dtype),
                       v_all.permute(0, 2, 1, 3)).float()  # (B, KV, G, hd)
    den = torch.sum(pr, dim=-1)                            # (B, KV, G)
    m_global = dataflow.pmax(m_local, plan.axis)
    corr = torch.exp(m_local - m_global)
    num = dataflow.psum(num * corr, plan.axis)
    den = dataflow.psum(den * corr[..., 0], plan.axis)
    out = num / torch.clamp_min(den, 1e-30)[..., None]
    return out.reshape(b, 1, hl, hd).to(q.dtype)


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
    d, h = cfg.d_model, plan.heads_local(cfg)
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
    """x: (B, S_local, D), sequence-sharded at tp > 1 -> (out, same
    shape; cache | None).  Per-head keys ``[c w_uk ‖ rope(k_rope)]`` and
    values ``c w_uv`` go through the kernel, full causal, one kv head per
    query head, at the rank's heads; the cache is the (B, S, kv_lora +
    rope) payload ``[c ‖ rope(k_rope)]`` (whole on every rank), or its
    int8 codes and a float32 scale per position."""
    a = cfg.attention
    h = plan.heads_local(cfg)
    dn, dr, dv, dc = _mla_dims(cfg)
    b = x.shape[0]
    sharded = plan.tp > 1

    # the low-rank down-projections are small and computed whole on
    # every rank (over the gathered sequence at tp > 1)
    cq = up(x, p["w_dq"], plan) if sharded else local_linear(x, p["w_dq"])
    cq = rms_norm(cq, p["q_norm"], cfg.norm_eps)
    s = cq.shape[1]
    q = local_linear(cq, p["w_uq"]).reshape(b, s, h, dn + dr)
    ckv = up(x, p["w_dkv"], plan) if sharded \
        else local_linear(x, p["w_dkv"])
    c = rms_norm(ckv[..., :dc], p["kv_norm"], cfg.norm_eps)
    q_rope = rope(q[..., dn:], positions, a.rope_theta)
    k_rope = rope(ckv[..., None, dc:], positions, a.rope_theta)  # (B,S,1,dr)

    k_nope = local_linear(c, p["w_uk"]).reshape(b, s, h, dn)
    v = local_linear(c, p["w_uv"]).reshape(b, s, h, dv)
    q_full = torch.cat([q[..., :dn], q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope.expand(b, s, h, dr)], dim=-1)

    o = flash_attention(q_full, k_full, v).reshape(b, s, h * dv)
    out = down(o, p["wo"], plan) if sharded else local_linear(o, p["wo"])

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
    ``p c`` in float32, then ``w_uv`` and ``wo`` at the rank's heads,
    whose partial sums are summed over the model axis at tp > 1.
    Returns ((B, 1, D), cache); the cache is updated in place."""
    a = cfg.attention
    h = plan.heads_local(cfg)
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
    return psum_if(local_linear(o, p["wo"]), plan), cache


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
