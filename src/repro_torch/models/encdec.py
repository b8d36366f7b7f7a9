"""Encoder-decoder transformer on torch (seamless-m4t-large-v2's
backbone, ``repro/models/encdec.py``).

The speech frontend is a stub: the caller hands in precomputed frame
embeddings (B, T, embed_dim).  The model owns ``frontend_proj``, the
bidirectional encoder and the decoder, whose layers run causal
self-attention (the sliding-window kernel at ``window = S``), then
cross-attention over the encoder's output (the "memory"), then the MLP.
The memory is computed once per prompt; cross-attention's K / V are
projected from it at prefill and cached (Domino's weight-stationary
discipline).  Neither the encoder's self-attention nor cross-attention
is causal, and no TPU kernel computes them: both run the reference's
plain blocks (``models/common.py::bidirectional_attention``); decode's
cross-attention is the reference's plain products.

Params: ``{"embed": (V, D), "frontend_proj": (embed_dim, D), "enc_norm",
"dec_norm": (D,), ["head": (D, V)], "encoder": [{"norm1", "attn",
"norm2", "mlp"}, ...], "decoder": [{"norm1", "attn", "norm_cross",
"cross": {wq, wk, wv, wo}, "norm2", "mlp"}, ...]}``: one dict per layer,
where the reference stacks each stack's leaves.  Caches: ``(self,
cross)``, each a list with one dict per decoder layer; self ``k`` / ``v``
(B, s_max, KV, hd) (+ ``k_scale`` / ``v_scale`` when int8), cross ``k``
/ ``v`` (B, T, KV, hd) in the memory's dtype, never int8.

At tp > 1 each rank runs the reference's per-device program: the
encoder's stream is sequence-sharded after ``frontend_proj`` and
all-gathered after ``enc_norm`` (the memory is whole on every rank);
the decoder's self-attention and MLP shard as the decoder-only stack's
(``models/transformer.py``); cross-attention's queries come through
``up`` and its output through ``down``, its K / V projected from the
whole memory at the rank's kv heads (the group trick where they do not
shard), and decode psums its output projection's partial sums.  The
last token comes from the last shard, and the logits are masked past
the vocabulary and all-gathered (the reference's encoder-decoder skips
the mask; its padded columns would hold the padded embedding rows'
logits, here they read -1e30 as the decoder-only stack's do).

Dtypes follow the reference's promotion.  With bfloat16 params, float32
frames make a float32 memory, which turns the decoder stream float32 at
the first cross-attention; the reference's ``lax.scan`` then refuses the
layer (its carry changes dtype), and so does the port, with a
``ValueError``.

Training: :func:`encdec_loss` is the reference's, at tp = 1 and over a
mesh (the encoder, the decoder stack and the chunked cross-entropy over
the tied head; every collective has its gradient).
Its params keep the reference's layout (:func:`stack_layers`):
``"encoder"`` and ``"decoder"`` each one dict whose leaves are stacked
over the layers, as the reference's ``vmap``-ed init gives them, so the
optimizer sees the reference's leaves.  :func:`encode` and
:func:`_decoder_stack` take either layout; with grad enabled each layer
runs under ``torch.utils.checkpoint`` as the reference's ``remat`` policy
over its scanned layer says.  Neither stack's self-attention nor the
cross-attention is causal, so autograd differentiates their plain
blocks; the decoder's causal self-attention goes through the attention
kernel and its backward kernel.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import transformer as tfm
from repro_torch.core import dataflow
from repro_torch.models.common import (
    ShardingPlan,
    all_gather_seq,
    dense_init,
    down,
    embed_lookup,
    flash_attention,
    last_shard_row,
    local_linear,
    pmean_dp,
    psum_if,
    rms_norm,
    up,
)
from repro_torch.tree import leaves

# ---------------------------------------------------------------------------
# Cross-attention
# ---------------------------------------------------------------------------


def init_cross_attn(gen: torch.Generator, cfg: ModelConfig,
                    plan: ShardingPlan, dtype) -> Dict[str, torch.Tensor]:
    return attn_mod.init_gqa(gen, cfg, plan, dtype)


def cross_attn_forward(p, x: torch.Tensor, memory: torch.Tensor,
                       cfg: ModelConfig, plan: ShardingPlan,
                       want_cache: bool = False):
    """x: (B, S_local, D) decoder stream (sequence-sharded at tp > 1);
    memory: (B, T, D) encoder output, whole.  No positions
    (cross-attention carries none).  Returns (out, cache | None); the
    cache is the projected memory, this rank's kv heads, in its own
    dtype."""
    a = cfg.attention
    hd = a.head_dim
    b = x.shape[0]
    t = memory.shape[1]
    hl = plan.heads_local(cfg)
    kv_store = attn_mod.stored_kv_heads(cfg, plan)
    sharded = plan.tp > 1
    q = up(x, p["wq"], plan) if sharded else local_linear(x, p["wq"])
    k = local_linear(memory, p["wk"])
    v = local_linear(memory, p["wv"])
    if plan.attn_sharded and not plan.kv_sharded and sharded:
        k = attn_mod._group_slice(k, cfg, plan, hd)
        v = attn_mod._group_slice(v, cfg, plan, hd)
    s = q.shape[1]
    q = q.reshape(b, s, hl, hd)
    k = k.reshape(b, t, kv_store, hd)
    v = v.reshape(b, t, kv_store, hd)
    o = flash_attention(q, k, v, causal=False).reshape(b, s, hl * hd)
    out = down(o, p["wo"], plan) if sharded else local_linear(o, p["wo"])
    return out, ({"k": k, "v": v} if want_cache else None)


def cross_attn_decode(p, x: torch.Tensor, cache, cfg: ModelConfig,
                      plan: ShardingPlan) -> torch.Tensor:
    """x: (B, 1, D) against the cached cross K / V (B, T, KV, hd): the
    reference's products, float32 logits of the upcast operands times
    ``hd^-0.5``, a float32 softmax, the probabilities in v's dtype; at
    the rank's heads, psummed over the model axis where they shard."""
    a = cfg.attention
    hd = a.head_dim
    b = x.shape[0]
    h, kvh = plan.heads_local(cfg), cache["k"].shape[2]
    q = local_linear(x, p["wq"]).reshape(b, kvh, h // kvh, hd)
    kt = cache["k"].float().permute(0, 2, 3, 1)          # (B, KV, hd, T)
    logits = torch.matmul(q.float(), kt) * hd ** -0.5     # (B, KV, G, T)
    probs = torch.softmax(logits, dim=-1).to(cache["v"].dtype)
    o = torch.matmul(probs, cache["v"].permute(0, 2, 1, 3))  # (B,KV,G,hd)
    out = local_linear(o.reshape(b, 1, h * hd), p["wo"])
    if plan.tp > 1 and plan.attn_sharded:
        out = psum_if(out, plan)
    return out


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, plan: ShardingPlan, gen: torch.Generator,
                dtype=None, shard_fn=None) -> Dict[str, Any]:
    """Random params on ``gen``'s device, drawn as
    ``transformer.init_params`` draws them (norms zero); the draws
    differ from the reference's, and parity tests carry the reference's
    params across (``convert.encdec_params_from_reference``).
    ``shard_fn(path, tree)`` replaces each top-level leaf and each layer
    (paths ``("encoder", l)``, ``("decoder", l)``) as soon as it is
    drawn."""
    dtype = dtype or getattr(torch, cfg.dtype)
    keep = shard_fn or tfm._no_shard
    dev = gen.device
    spec = tfm.layer_spec(cfg, 0)
    d, e = cfg.d_model, cfg.frontend.embed_dim

    def dec_layer():
        p = tfm.init_layer(gen, spec, cfg, plan, dtype)
        p["cross"] = init_cross_attn(gen, cfg, plan, dtype)
        p["norm_cross"] = torch.zeros((d,), dtype=dtype, device=dev)
        return p

    params: Dict[str, Any] = {
        "embed": keep(("embed",), tfm.vocab_leaf(gen, cfg, plan, dtype)),
        "frontend_proj": dense_init(gen, e, (e, d), dtype),
        "enc_norm": torch.zeros((d,), dtype=dtype, device=dev),
        "dec_norm": torch.zeros((d,), dtype=dtype, device=dev),
        "encoder": [keep(("encoder", l),
                         tfm.init_layer(gen, spec, cfg, plan, dtype))
                    for l in range(cfg.encoder_layers)],
        "decoder": [keep(("decoder", l), dec_layer())
                    for l in range(cfg.num_layers)],
    }
    if not cfg.tie_embeddings:
        params["head"] = keep(("head",), tfm.vocab_leaf(gen, cfg, plan,
                                                        dtype, head=True))
    return params


def stack_layers(params) -> Dict[str, Any]:
    """Params with ``"encoder"`` and ``"decoder"`` as lists (one dict per
    layer) in the reference's training layout: each one dict whose
    leaves are stacked over its layers (a copy)."""
    out = dict(params)
    for name in ("encoder", "decoder"):
        out[name] = tfm._stack(params[name])
    return out


def _layers(stack) -> List[Any]:
    """A stack's layers: the list itself, or a stacked dict as
    ``torch.unbind`` views, one per layer (whose backward stacks the
    gradients onto the stacked leaves)."""
    if isinstance(stack, list):
        return stack
    return tfm._unbind(stack, leaves(stack)[0].shape[0])


def _run_layers(layer_fn, x: torch.Tensor, layers, remat: str):
    """``x = layer_fn(x, lp)`` over the layers, each under
    ``torch.utils.checkpoint`` with the ``remat`` policy when grad is
    enabled (the reference checkpoints each layer of its scan)."""
    context = tfm._remat_context(remat)
    for lp in layers:
        if context is not None and torch.is_grad_enabled():
            x = checkpoint(layer_fn, x, lp, use_reentrant=False,
                           context_fn=context)
        else:
            x = layer_fn(x, lp)
    return x


# ---------------------------------------------------------------------------
# Encoder / decoder stacks
# ---------------------------------------------------------------------------


def _same_dtype(x_in: torch.Tensor, x_out: torch.Tensor, where: str
                ) -> torch.Tensor:
    """The reference scans each stack, and a scan's carry keeps its
    dtype: a layer that changes the stream's dtype is refused there, and
    here."""
    if x_out.dtype != x_in.dtype:
        raise ValueError(
            f"the {where} stream enters a layer as {x_in.dtype} and leaves "
            f"it as {x_out.dtype}; the reference's layer scan refuses this "
            "(with bfloat16 params, pass the frames in bfloat16)")
    return x_out


def encode(params, frames: torch.Tensor, cfg: ModelConfig,
           plan: ShardingPlan, remat: str = "full") -> torch.Tensor:
    """frames: (B, T, embed_dim) -> memory (B, T, D), in the frames'
    dtype: ``frontend_proj``, the bidirectional layers (rope on the
    frames' positions), ``enc_norm``; at tp > 1 the stream is this
    rank's sequence chunk in between, and the memory is all-gathered.
    ``remat``: each layer's policy when grad is enabled ("none", "full"
    or "dots")."""
    x = tfm.seq_chunk(local_linear(frames, params["frontend_proj"]), plan)
    positions = torch.arange(frames.shape[1], device=frames.device)

    def layer(x, lp):
        h = rms_norm(x, lp["norm1"], cfg.norm_eps)
        o, _ = attn_mod.gqa_forward(lp["attn"], h, cfg, 0, plan, positions,
                                    causal=False)
        y = x + o
        h = rms_norm(y, lp["norm2"], cfg.norm_eps)
        return _same_dtype(x, y + tfm.mlp_forward(lp["mlp"], h, cfg, plan),
                           "encoder")

    x = _run_layers(layer, x, _layers(params["encoder"]), remat)
    x = rms_norm(x, params["enc_norm"], cfg.norm_eps)
    if plan.tp > 1 and plan.seq_shard:
        x = dataflow.all_gather(x, plan.axis, dim=1)
    return x


def _decoder_stack(params, x: torch.Tensor, memory: torch.Tensor,
                   cfg: ModelConfig, plan: ShardingPlan,
                   positions: torch.Tensor, *, want_caches: bool = False,
                   kv_dtype: str = "bfloat16", remat: str = "full"):
    """-> (hidden after ``dec_norm``, (self caches, cross caches) | None).
    ``remat``: each layer's policy when grad is enabled and no caches are
    asked for."""
    self_c: List[Any] = []
    cross_c: List[Any] = []

    def layer(x, lp):
        h = rms_norm(x, lp["norm1"], cfg.norm_eps)
        o, sc = attn_mod.gqa_forward(lp["attn"], h, cfg, 0, plan, positions,
                                     want_cache=want_caches,
                                     kv_dtype=kv_dtype)
        y = x + o
        h = rms_norm(y, lp["norm_cross"], cfg.norm_eps)
        o, cc = cross_attn_forward(lp["cross"], h, memory, cfg, plan,
                                   want_cache=want_caches)
        y = y + o
        h = rms_norm(y, lp["norm2"], cfg.norm_eps)
        if want_caches:
            self_c.append(sc)
            cross_c.append(cc)
        return _same_dtype(x, y + tfm.mlp_forward(lp["mlp"], h, cfg, plan),
                           "decoder")

    x = _run_layers(layer, x, _layers(params["decoder"]),
                    "none" if want_caches else remat)
    x = rms_norm(x, params["dec_norm"], cfg.norm_eps)
    return x, ((self_c, cross_c) if want_caches else None)


def encdec_loss(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                plan: ShardingPlan, remat: str = "full",
                xent_chunk: int = 1024) -> torch.Tensor:
    """batch: ``{"frames": (B, T, embed_dim), "tokens": (B, S),
    "labels": (B, S)}`` (a label < 0 is not counted) -> the scalar mean
    cross-entropy of the decoder's next tokens, float32: the reference's
    ``encdec_loss`` (no aux loss).  At tp > 1 the decoder's stream is
    this rank's sequence chunk, all-gathered for the head; the loss is
    averaged over the data axes."""
    memory = encode(params, batch["frames"], cfg, plan, remat=remat)
    tokens, labels = batch["tokens"], batch["labels"]
    x = tfm.seq_chunk(embed_lookup(params["embed"], tokens, plan), plan)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    h, _ = _decoder_stack(params, x, memory, cfg, plan, positions,
                          remat=remat)
    return pmean_dp(tfm._chunked_xent(
        all_gather_seq(h, plan), labels, tfm._head_weight(params, cfg), cfg,
        plan, xent_chunk), plan)


def prefill(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            plan: ShardingPlan, kv_dtype: str = "bfloat16",
            s_max: Optional[int] = None):
    """batch: ``{"frames": (B, T, embed_dim), "tokens": (B, S)}`` ->
    (last-token logits (B, V_pad) float32, (self, cross) caches); the
    self caches grown to ``s_max`` positions (the layers are global, so
    the reference's ring layout is a zero pad)."""
    memory = encode(params, batch["frames"], cfg, plan, remat="none")
    tokens = batch["tokens"]
    s = tokens.shape[1]
    x = tfm.seq_chunk(embed_lookup(params["embed"], tokens, plan), plan)
    positions = torch.arange(s, device=tokens.device)
    h, (self_c, cross_c) = _decoder_stack(
        params, x, memory, cfg, plan, positions, want_caches=True,
        kv_dtype=kv_dtype)
    if s_max is not None and s_max != s:
        self_c = [{name: tfm._to_ring(arr, 1, s, s_max)
                   for name, arr in c.items()} for c in self_c]
    last = last_shard_row(h, plan)[:, None]
    logits = tfm.lm_logits_local(params, last, cfg, plan)[:, 0]
    return tfm.gather_logits(logits, cfg, plan), (self_c, cross_c)


def init_cache(cfg: ModelConfig, plan: ShardingPlan, batch: int, s_max: int,
               t_enc: int, kv_dtype: str = "bfloat16", device=None
               ) -> Tuple[List[Dict[str, torch.Tensor]],
                          List[Dict[str, torch.Tensor]]]:
    """Zero (self, cross) caches on ``device`` (``None`` = the card),
    with the shapes and dtypes the reference declares: the cross cache
    in bfloat16 whatever ``kv_dtype`` (a prefill's holds the memory's
    dtype)."""
    a = cfg.attention
    dev = resolve_device(device)
    shapes = attn_mod.gqa_cache_shape(cfg, plan, batch, s_max, 0, kv_dtype)
    cross_shape = (batch, t_enc, attn_mod.stored_kv_heads(cfg, plan),
                   a.head_dim)
    self_c = [{k: torch.zeros(sh, dtype=dt, device=dev)
               for k, (sh, dt) in shapes.items()}
              for _ in range(cfg.num_layers)]
    cross_c = [{k: torch.zeros(cross_shape, dtype=torch.bfloat16,
                               device=dev) for k in ("k", "v")}
               for _ in range(cfg.num_layers)]
    return self_c, cross_c


def decode_step(params, token: torch.Tensor, caches, pos: int,
                cfg: ModelConfig, plan: ShardingPlan,
                kv_dtype: str = "bfloat16"):
    """token: (B,) ids at absolute position ``pos`` -> (logits (B, V_pad)
    float32, caches).  The self caches are updated in place; the cross
    caches are read."""
    self_c, cross_c = caches
    x = embed_lookup(params["embed"], token[:, None], plan)  # (B, 1, D)
    new_self = []
    for lp, sc, cc in zip(params["decoder"], self_c, cross_c):
        x_in = x
        h = rms_norm(x, lp["norm1"], cfg.norm_eps)
        o, sc = attn_mod.gqa_decode(lp["attn"], h, sc, pos, cfg, 0, plan,
                                    kv_dtype=kv_dtype)
        x = x + o
        h = rms_norm(x, lp["norm_cross"], cfg.norm_eps)
        x = x + cross_attn_decode(lp["cross"], h, cc, cfg, plan)
        h = rms_norm(x, lp["norm2"], cfg.norm_eps)
        x = _same_dtype(x_in, x + tfm.mlp_forward(lp["mlp"], h, cfg, plan),
                        "decoder")
        new_self.append(sc)
    x = rms_norm(x, params["dec_norm"], cfg.norm_eps)
    logits = tfm.lm_logits_local(params, x, cfg, plan)[:, 0]
    return tfm.gather_logits(logits, cfg, plan), (new_self, cross_c)
