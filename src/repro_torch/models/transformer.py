"""Decoder-only LM on torch (``repro/models/transformer.py``): dense GQA stacks (gemma, qwen2,
minitron), MoE stacks (granite-moe), attention-free Mamba stacks
(falcon-mamba), the Mamba + attention + MoE hybrid (jamba), the MLA +
MoE stack of deepseek-v3, and the vision-language internvl2, whose
``vit_stub`` frontend hands in precomputed patch embeddings that
``frontend_proj`` maps over the prompt's first positions.  The
encoder-decoder (seamless-m4t) is ``models/encdec.py``.

The reference groups layers into segments (maximal runs of a repeating
layer cycle), stacks each segment's parameters over its repeat count and
runs it with ``lax.scan``.  Here the parameters are a plain list with
one dict per layer, in layer order, and the scan is a Python loop;
``build_segments`` is kept because it fixes the reference's layout
(``convert.lm_params_from_reference`` un-stacks along it) and its
int8-quantization decisions (``runtime/serve_loop.quantize_decisions``).

Params: ``{"embed": (V, D), "final_norm": (D,), ["head": (D, V)],
["frontend_proj": (embed_dim, D)],
"layers": [{"norm1", "attn": {wq, wk, wv, wo, [bq, bk, bv]} | {w_dq,
q_norm, w_uq, w_dkv, kv_norm, w_uk, w_uv, wo} (MLA) | "mamba": {w_in_x,
w_in_z, conv_w, conv_b, x_proj, dt_proj, dt_bias, A_log, D, w_out},
["norm2"], ["mlp": {w_in, [w_gate], w_out}] | ["moe": {router, w_in,
[w_gate], w_out, [shared_in, shared_gate, shared_out]} (experts stacked
on axis 0)]}, ...], ["mtp": {"layer", "proj" (2 D, D)}]}``; any matmul
weight may be a ``{"q", "s"}`` int8 leaf.  Caches: one dict per layer;
GQA ``k`` / ``v`` (B, S, KV, hd) (+ ``k_scale`` / ``v_scale``
(B, S, KV, 1) when int8), MLA ``c`` (B, S, kv_lora + rope) (+
``c_scale`` (B, S, 1)), mamba ``h`` (B, d_inner, d_state) float32 and
``conv`` (B, d_conv - 1, d_inner).

Multi-token prediction (deepseek-v3's ``mtp_depth``): its parameters
are built, converted and quantized as the reference's; serving never
reads them, and :func:`lm_loss` adds its term (:func:`mtp_loss`).

Serving and training at tp > 1 run the reference's per-device program
on each rank of the model axis (``models/common.py::ShardingPlan``
holds the axis):
the embedding is vocab-sharded (a masked gather summed over the axis),
the residual stream is sequence-sharded after it, attention, MLP, MoE
and Mamba layers shard heads, features, experts and channels, prefill's
last token comes from the last shard by a masked psum, and the
vocab-sharded head's logits are masked past the vocabulary and
all-gathered, so every rank returns (B, V_pad) logits (V_pad: the
vocabulary padded to a multiple of tp, :func:`padded_vocab`).
``init_params`` builds a rank's local shapes, or the global ones with
``plan.global_shapes``; ``shard_fn`` cuts each layer (and each top-level
leaf) as soon as it is drawn, so a rank that draws the global weights
holds one global layer at a time.

Training keeps the reference's layout: ``"segments"`` in place of
``"layers"``, one list per segment with one dict per position of its
layer cycle, each leaf stacked over the segment's repeat count when it
exceeds 1 (:func:`stack_layers`).  :func:`forward` takes either layout;
on the stacked one it hands each cycle ``torch.unbind`` views, whose
backward stacks the gradients onto the reference's leaves, and with
grad enabled it runs each cycle of a repeated segment under
``torch.utils.checkpoint`` as the reference's ``remat`` policy says.
:func:`lm_loss` is the reference's loss (the cross-entropy plus the MoE
aux loss) for every decoder-only config, at tp = 1 and on a mesh (the
stream all-gathered for the vocab-sharded head; every collective
differentiates as its transpose, ``core/dataflow.py``): the dense
family, the
MoE (granite-moe), Mamba (falcon-mamba) and hybrid (jamba) stacks, whose
scan differentiates through its own backward kernel
(``kernels/selective_scan.py``), MLA with multi-token prediction
(deepseek-v3, its attention differentiated by the backward kernel at the
(192, 128) pair) and the vit_stub frontend (internvl2, whose batch
carries ``patch_embeds``).  The encoder-decoder's loss is
``models/encdec.py::encdec_loss``.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.core import dataflow
from repro_torch.models.common import (
    ACT,
    ShardingPlan,
    _mask_pad_vocab,
    dense_init,
    down,
    embed_init,
    embed_lookup,
    gated_act,
    last_shard_row,
    Zero3,
    all_gather_seq,
    local_linear,
    pmean_dp,
    resolve_w,
    rms_norm,
    sharded_softmax_xent,
    softcap,
    up,
)

# ---------------------------------------------------------------------------
# Segment structure
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LayerSpec:
    kind: str          # "attn" | "mamba"
    mlp: str           # "dense" | "moe" | "none"
    pattern_idx: int   # index into attention.pattern (window selection)


@dataclass(frozen=True)
class Segment:
    cycle: Tuple[LayerSpec, ...]
    count: int


def _lcm(*xs: int) -> int:
    out = 1
    for x in xs:
        out = out * x // math.gcd(out, x)
    return out


def layer_spec(cfg: ModelConfig, l: int) -> LayerSpec:
    kind = cfg.layer_kind(l)
    if cfg.moe is not None and cfg.moe.is_moe_layer(l):
        mlp = "moe"
    elif cfg.d_ff > 0 and kind != "mamba" or (kind == "mamba" and cfg.d_ff > 0
                                              and cfg.family == "hybrid"):
        mlp = "dense"
    else:
        mlp = "none"
    # jamba: every layer (incl. mamba) has an MLP/MoE; falcon-mamba: none
    if kind == "mamba" and cfg.family == "ssm":
        mlp = "none"
    pat = 0
    if cfg.attention is not None:
        pat = l % len(cfg.attention.pattern)
    return LayerSpec(kind=kind, mlp=mlp, pattern_idx=pat)


def build_segments(cfg: ModelConfig) -> List[Segment]:
    pat_len = len(cfg.attention.pattern) if cfg.attention else 1
    moe_p = cfg.moe.period if cfg.moe else 1
    cycle_len = _lcm(len(cfg.layer_cycle), pat_len, moe_p)
    cycle_len = min(cycle_len, cfg.num_layers)
    descs = [layer_spec(cfg, l) for l in range(cfg.num_layers)]
    chunks: List[Tuple[LayerSpec, ...]] = []
    for i in range(0, cfg.num_layers, cycle_len):
        chunks.append(tuple(descs[i:i + cycle_len]))
    segments: List[Segment] = []
    for ch in chunks:
        if segments and segments[-1].cycle == ch:
            segments[-1] = Segment(ch, segments[-1].count + 1)
        else:
            segments.append(Segment(ch, 1))
    return segments


def _decoder_only(cfg: ModelConfig) -> None:
    if cfg.is_encdec:
        raise ValueError(f"{cfg.name} is an encoder-decoder: models/"
                         "encdec.py builds and runs it")


def _is_mla(cfg: ModelConfig) -> bool:
    return cfg.attention is not None and cfg.attention.kind == "mla"


# ---------------------------------------------------------------------------
# Single layer
# ---------------------------------------------------------------------------


def init_layer(gen: torch.Generator, spec: LayerSpec, cfg: ModelConfig,
               plan: ShardingPlan, dtype) -> Dict[str, Any]:
    dev = gen.device
    p: Dict[str, Any] = {
        "norm1": torch.zeros((cfg.d_model,), dtype=dtype, device=dev)}
    if spec.kind == "attn":
        init = attn_mod.init_mla if _is_mla(cfg) else attn_mod.init_gqa
        p["attn"] = init(gen, cfg, plan, dtype)
    else:
        p["mamba"] = ssm_mod.init_mamba(gen, cfg, plan, dtype)
    if spec.mlp != "none":
        p["norm2"] = torch.zeros((cfg.d_model,), dtype=dtype, device=dev)
    if spec.mlp == "dense":
        d, f = cfg.d_model, cfg.d_ff
        fl = plan.shard(f) if plan.tp > 1 else f
        p["mlp"] = {"w_in": dense_init(gen, d, (d, fl), dtype),
                    "w_out": dense_init(gen, f, (fl, d), dtype)}
        if gated_act(cfg.activation):
            p["mlp"]["w_gate"] = dense_init(gen, d, (d, fl), dtype)
    elif spec.mlp == "moe":
        p["moe"] = moe_mod.init_moe(gen, cfg, plan, dtype)
    return p


def mlp_forward(p, x: torch.Tensor, cfg: ModelConfig, plan: ShardingPlan
                ) -> torch.Tensor:
    """The dense MLP; at tp > 1 its features are sharded: ``up`` in (the
    gate's activation on its float32 product), ``down`` out."""
    act = ACT[cfg.activation]
    if plan.tp > 1:
        h = up(x, p["w_in"], plan)
        if "w_gate" in p:
            g = up(x, p["w_gate"], plan, tail=act)
            h = (g.float() * h.float()).to(x.dtype)
        else:
            h = act(h.float()).to(x.dtype)
        return down(h, p["w_out"], plan)
    h = local_linear(x, p["w_in"])
    if "w_gate" in p:
        h = (act(local_linear(x, p["w_gate"]).float()) * h.float()
             ).to(x.dtype)
    else:
        h = act(h.float()).to(x.dtype)
    return local_linear(h, p["w_out"])


def _mlp_block(p, x: torch.Tensor, spec: LayerSpec, cfg: ModelConfig,
               plan: ShardingPlan):
    """The residual's second half: norm2 and the dense MLP or the MoE.
    Returns (x, the MoE's aux loss or None)."""
    if spec.mlp == "none":
        return x, None
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    if spec.mlp == "dense":
        return x + mlp_forward(p["mlp"], h, cfg, plan), None
    out, aux = moe_mod.moe_forward(p["moe"], h, cfg, plan)
    return x + out, aux


def apply_layer(p, x: torch.Tensor, spec: LayerSpec, cfg: ModelConfig,
                plan: ShardingPlan, positions: torch.Tensor, *,
                want_cache: bool = False, kv_dtype: str = "bfloat16"):
    """Pre-norm residual layer.  Returns (x, cache, aux loss or None)."""
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if spec.kind == "attn":
        fwd = attn_mod.mla_forward if _is_mla(cfg) else attn_mod.gqa_forward
        o, cache = fwd(p["attn"], h, cfg, spec.pattern_idx, plan, positions,
                       want_cache=want_cache, kv_dtype=kv_dtype)
    else:
        o, cache = ssm_mod.mamba_forward(p["mamba"], h, cfg, plan,
                                         want_cache=want_cache)
    x, aux = _mlp_block(p, x + o, spec, cfg, plan)
    return x, cache, aux


def decode_layer(p, x: torch.Tensor, cache, pos: int, spec: LayerSpec,
                 cfg: ModelConfig, plan: ShardingPlan,
                 kv_dtype: str = "bfloat16"):
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if spec.kind == "attn":
        dec = attn_mod.mla_decode if _is_mla(cfg) else attn_mod.gqa_decode
        o, cache = dec(p["attn"], h, cache, pos, cfg, spec.pattern_idx,
                       plan, kv_dtype=kv_dtype)
    else:
        o, cache = ssm_mod.mamba_decode(p["mamba"], h, cache, cfg, plan)
    return _mlp_block(p, x + o, spec, cfg, plan)[0], cache


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------


def layer_specs(cfg: ModelConfig) -> List[LayerSpec]:
    """One spec per layer, in layer order."""
    return [layer_spec(cfg, l) for l in range(cfg.num_layers)]


def padded_vocab(cfg: ModelConfig, plan: ShardingPlan) -> int:
    """The vocabulary rounded up to a multiple of tp."""
    return ((cfg.vocab_size + plan.tp - 1) // plan.tp) * plan.tp


def vocab_local(cfg: ModelConfig, plan: ShardingPlan) -> int:
    v = padded_vocab(cfg, plan)
    return v if plan.global_shapes else v // plan.tp


def _no_shard(path, tree):
    return tree


def vocab_leaf(gen: torch.Generator, cfg: ModelConfig, plan: ShardingPlan,
               dtype, head: bool = False) -> torch.Tensor:
    """The embedding (V, D), or the head (D, V).  A global tree of a
    padded vocabulary draws it at the real vocabulary and pads it with
    zeros to :func:`padded_vocab`, so every tp draws the weights of
    tp = 1; a rank's tree draws its :func:`vocab_local` shape."""
    d, v = cfg.d_model, cfg.vocab_size
    drawn = v if plan.global_shapes else vocab_local(cfg, plan)
    pad = padded_vocab(cfg, plan) - v if plan.global_shapes else 0
    if head:
        w = dense_init(gen, d, (d, drawn), dtype)
        return F.pad(w, (0, pad)) if pad else w
    w = embed_init(gen, (drawn, d), dtype)
    return F.pad(w, (0, 0, 0, pad)) if pad else w


def init_params(cfg: ModelConfig, plan: ShardingPlan,
                gen: torch.Generator, dtype=None,
                shard_fn: Optional[Callable] = None) -> Dict[str, Any]:
    """Random params on ``gen``'s device: normal draws from ``gen`` in
    float32 (``dense_init``: / sqrt(fan_in); embedding: * 0.02), norms
    zero, biases zero, cast to ``dtype`` (``cfg.dtype`` by default).
    With ``cfg.mtp_depth`` the multi-token-prediction block ``"mtp"``
    (a copy of the last layer's kind and a (2 D, D) ``proj``) is built
    as the reference builds it; serving does not read it.  The draws
    differ from the reference's ``jax.random`` ones; parity tests carry
    the reference's params across instead.  A modality frontend gets its
    ``frontend_proj``.  The embedding and head are
    :func:`vocab_leaf`'s.
    ``shard_fn(path, tree)``, when given, replaces each top-level leaf
    (path ``("embed",)``), each layer (``("layers", l)``) and the MTP
    block (``("mtp",)``) as soon as it is drawn."""
    _decoder_only(cfg)
    dtype = dtype or getattr(torch, cfg.dtype)
    keep = shard_fn or _no_shard
    dev = gen.device
    d = cfg.d_model
    params: Dict[str, Any] = {
        "embed": keep(("embed",), vocab_leaf(gen, cfg, plan, dtype)),
        "final_norm": torch.zeros((d,), dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = keep(("head",), vocab_leaf(gen, cfg, plan, dtype,
                                                    head=True))
    if has_frontend(cfg):
        e = cfg.frontend.embed_dim
        params["frontend_proj"] = dense_init(gen, e, (e, d), dtype)
    params["layers"] = [keep(("layers", l), init_layer(gen, spec, cfg,
                                                       plan, dtype))
                        for l, spec in enumerate(layer_specs(cfg))]
    if cfg.mtp_depth > 0:
        params["mtp"] = keep(("mtp",), {
            "layer": init_layer(gen, layer_spec(cfg, cfg.num_layers - 1),
                                cfg, plan, dtype),
            "proj": dense_init(gen, 2 * d, (2 * d, d), dtype),
        })
    return params


def has_frontend(cfg: ModelConfig) -> bool:
    """Whether ``cfg`` has a modality frontend (a stub that hands in
    precomputed embeddings)."""
    return cfg.frontend is not None and cfg.frontend.kind != "none"


def embed_tokens(params, tokens: torch.Tensor, cfg: ModelConfig,
                 plan: ShardingPlan, extras=None) -> torch.Tensor:
    """tokens: (B, S) ids -> (B, S, D), or this rank's sequence chunk
    (B, S/k, D) at tp > 1.  ``extras["patch_embeds"]``
    (B, N, embed_dim), with a ``frontend_proj``, replaces the first N
    positions by their projection.  The result takes the dtype both
    promote to, as the reference's ``jnp.where`` does: float32 patch
    embeddings turn a bfloat16 model's stream into float32.  N > S
    raises, as the reference's negative pad does."""
    x = embed_lookup(params["embed"], tokens, plan)
    if extras and "patch_embeds" in extras and "frontend_proj" in params:
        img = local_linear(extras["patch_embeds"], params["frontend_proj"])
        n_img, s = img.shape[1], x.shape[1]
        if n_img > s:
            raise ValueError(f"{n_img} patch embeddings for a prompt of "
                             f"{s} tokens: the prompt must hold them")
        dt = torch.promote_types(img.dtype, x.dtype)
        x = torch.cat([img.to(dt), x[:, n_img:].to(dt)], dim=1)
    return seq_chunk(x, plan)


def seq_chunk(x: torch.Tensor, plan: ShardingPlan) -> torch.Tensor:
    """This rank's chunk of dim 1 of a replicated (B, S, ...) tensor at
    tp > 1 (the whole tensor at tp = 1)."""
    if plan.tp == 1 or not plan.seq_shard:
        return x
    s = x.shape[1]
    if s % plan.tp:
        raise ValueError(f"a sequence of {s} does not shard {plan.tp} ways")
    chunk = s // plan.tp
    i = plan.tp_index()
    return x[:, i * chunk:(i + 1) * chunk].contiguous()


def stack_layers(params, cfg: ModelConfig) -> Dict[str, Any]:
    """Params with ``"layers"`` (one dict per layer) in the reference's
    training layout: ``"segments"``, each leaf of a segment whose count
    exceeds 1 stacked over that count (a copy)."""
    layers = iter(params["layers"])
    segments = []
    for seg in build_segments(cfg):
        cycles = [[next(layers) for _ in seg.cycle]
                  for _ in range(seg.count)]
        if seg.count == 1:
            segments.append(cycles[0])
        else:
            segments.append([_stack([c[i] for c in cycles])
                             for i in range(len(seg.cycle))])
    out = {k: v for k, v in params.items() if k != "layers"}
    out["segments"] = segments
    return out


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _unbind(tree, n: int) -> List[Any]:
    """A tree whose leaves are stacked over ``n`` as ``n`` trees of
    ``torch.unbind`` views (one autograd node per leaf, whose backward
    stacks the gradients)."""
    if isinstance(tree, dict):
        parts = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: parts[k][r] for k in tree} for r in range(n)]
    if isinstance(tree, list):
        parts = [_unbind(v, n) for v in tree]
        return [[p[r] for p in parts] for r in range(n)]
    if isinstance(tree, Zero3):
        return tree.unbind()
    return list(torch.unbind(tree, 0))


def segment_cycles(params, cfg: ModelConfig):
    """(segment, its cycles: per repeat a list of per-position layer
    dicts) for either params layout (``"layers"`` or ``"segments"``)."""
    segments = build_segments(cfg)
    if "segments" not in params:
        layers = iter(params["layers"])
        return [(seg, [[next(layers) for _ in seg.cycle]
                       for _ in range(seg.count)]) for seg in segments]
    return [(seg, [seg_p] if seg.count == 1 else _unbind(seg_p, seg.count))
            for seg, seg_p in zip(segments, params["segments"])]


#: the products ``remat="dots"`` keeps (``checkpoint_dots``)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_context(remat: str):
    """The ``context_fn`` of a checkpointed cycle for the reference's
    policies: ``"full"`` saves nothing (``nothing_saveable``), ``"dots"``
    the matmul outputs (``checkpoint_dots``); ``"none"`` checkpoints
    nothing (None)."""
    if remat not in ("none", "full", "dots"):
        raise ValueError(f"remat must be none, full or dots: {remat!r}")
    if remat == "dots":
        return functools.partial(create_selective_checkpoint_contexts,
                                 _save_dots)
    return None if remat == "none" else noop_context_fn


def forward(params, tokens: torch.Tensor, cfg: ModelConfig,
            plan: ShardingPlan, extras=None, *, want_caches: bool = False,
            kv_dtype: str = "bfloat16", remat: str = "full"):
    """-> (hidden (B, S_local, D) after the final norm, sequence-sharded
    at tp > 1, per-layer caches | None, aux loss (0 for a dense
    stack)).  ``extras``: the frontend's inputs (:func:`embed_tokens`).  With grad enabled and no caches
    asked for, each cycle of a segment repeated more than once runs
    under ``torch.utils.checkpoint`` unless ``remat="none"``; a segment
    of count 1 never does, as in the reference."""
    _decoder_only(cfg)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = embed_tokens(params, tokens, cfg, plan, extras)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    context = _remat_context(remat)
    caches = []

    def cycle_fn(x, layer_params, specs):
        aux_c, cs = None, []
        for lp, spec in zip(layer_params, specs):
            x, cache, a = apply_layer(lp, x, spec, cfg, plan, positions,
                                      want_cache=want_caches,
                                      kv_dtype=kv_dtype)
            cs.append(cache)
            if a is not None:
                aux_c = a if aux_c is None else aux_c + a
        return x, cs, aux_c

    for seg, cycles in segment_cycles(params, cfg):
        remat_seg = (context is not None and seg.count > 1
                     and torch.is_grad_enabled() and not want_caches)
        for layer_params in cycles:
            if remat_seg:
                x, cs, aux_c = checkpoint(cycle_fn, x, layer_params,
                                          seg.cycle, use_reentrant=False,
                                          context_fn=context)
            else:
                x, cs, aux_c = cycle_fn(x, layer_params, seg.cycle)
            caches += cs
            if aux_c is not None:
                aux = aux + aux_c
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, (caches if want_caches else None), aux


# ---------------------------------------------------------------------------
# Head
# ---------------------------------------------------------------------------


def _head_weight(params, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T  # (D, V)
    return resolve_w(params["head"])


def lm_logits_local(params, h: torch.Tensor, cfg: ModelConfig,
                    plan: ShardingPlan) -> torch.Tensor:
    """h: (B, n, D) -> (B, n, V) float32 logits."""
    logits = torch.matmul(h.float(), _head_weight(params, cfg).float())
    return softcap(logits, cfg.final_softcap)


# ---------------------------------------------------------------------------
# Training loss
# ---------------------------------------------------------------------------


def _chunk_loss(hc, lc, w, cfg: ModelConfig, plan: ShardingPlan):
    """(loss x count (1,), count (1,)) of one sequence chunk, summed over
    the vocab shards (not averaged over the data axes: the caller
    does)."""
    vm = lc >= 0
    logits = torch.matmul(hc.float(), w.float())
    logits = softcap(logits, cfg.final_softcap)
    logits = _mask_pad_vocab(logits, cfg, plan, w.shape[1])
    loss = sharded_softmax_xent(logits, torch.clamp_min(lc, 0), plan,
                                valid=vm)
    cnt = torch.sum(vm.float()).reshape(1)
    return loss.reshape(1) * cnt, cnt


def _chunked_xent(h: torch.Tensor, labels: torch.Tensor, w: torch.Tensor,
                  cfg: ModelConfig, plan: ShardingPlan,
                  xent_chunk: int) -> torch.Tensor:
    """Sequence-chunked cross-entropy, the reference's: the chunk count
    is ``S // min(xent_chunk, S)``, lowered until it divides S, and the
    loss is the count-weighted sum over chunks over the valid positions.
    With grad enabled each chunk runs under ``torch.utils.checkpoint``,
    so only one chunk's (B, n, V) float32 logits live at a time, in the
    forward and again in the backward."""
    s = h.shape[1]
    n_chunks = max(1, s // min(xent_chunk, s))
    while s % n_chunks:
        n_chunks -= 1
    n = s // n_chunks
    plan = replace(plan, dp_axes=(), dp_axis=None)
    total = torch.zeros((1,), dtype=torch.float32, device=h.device)
    count = torch.zeros((1,), dtype=torch.float32, device=h.device)
    for i in range(n_chunks):
        hc, lc = h[:, i * n:(i + 1) * n], labels[:, i * n:(i + 1) * n]
        if torch.is_grad_enabled():
            part, cnt = checkpoint(_chunk_loss, hc, lc, w, cfg, plan,
                                   use_reentrant=False)
        else:
            part, cnt = _chunk_loss(hc, lc, w, cfg, plan)
        total = total + part
        count = count + cnt
    return (total / torch.clamp_min(count, 1.0))[0]


def mtp_loss(params, h: torch.Tensor, labels: torch.Tensor,
             w: torch.Tensor, cfg: ModelConfig, plan: ShardingPlan,
             xent_chunk: int = 1024) -> torch.Tensor:
    """The multi-token-prediction term of the reference's ``lm_loss``
    (deepseek-v3): ``proj`` over ``[h ‖ emb(max(labels, 0))]`` (h the
    stack's output after the final norm, this rank's sequence chunk at
    tp > 1, the embedding cast to h's dtype), one layer of kind
    ``layer_spec(cfg, num_layers - 1)`` at positions ``arange(S)``, not
    checkpointed, its MoE aux loss dropped, then the head over its
    output (all-gathered over the model axis at tp > 1) with no final
    norm, against ``labels[:, 2:]`` padded with two -1s on the right
    (the reference's offset, as it is), averaged over the data axes."""
    s = labels.shape[1]
    emb_next = seq_chunk(embed_lookup(params["embed"],
                                      torch.clamp_min(labels, 0), plan),
                         plan)
    hm = local_linear(torch.cat([h, emb_next.to(h.dtype)], dim=-1),
                      params["mtp"]["proj"])
    hm, _, _ = apply_layer(params["mtp"]["layer"], hm,
                           layer_spec(cfg, cfg.num_layers - 1), cfg, plan,
                           torch.arange(s, device=h.device))
    mtp_labels = torch.cat([labels[:, 2:],
                            labels.new_full((labels.shape[0], 2), -1)],
                           dim=1)
    return pmean_dp(_chunked_xent(all_gather_seq(hm, plan), mtp_labels, w,
                                  cfg, plan, xent_chunk), plan)


def lm_loss(params, batch, cfg: ModelConfig, plan: ShardingPlan,
            remat: str = "full", xent_chunk: int = 1024) -> torch.Tensor:
    """batch: {tokens (B, S), labels (B, S), [patch_embeds (B, N, e)]}
    (a label < 0 is not counted) -> the scalar mean cross-entropy plus
    0.1 times the multi-token-prediction loss (:func:`mtp_loss`, where
    ``cfg.mtp_depth`` and the params have it) plus the aux loss,
    float32: the reference's ``lm_loss``, for every decoder-only config.
    At tp > 1 the sequence-sharded output is all-gathered over the model
    axis and each rank's vocab shard of the head runs over the whole
    sequence; the cross-entropy and the aux loss are averaged over the
    data axes.  The aux loss is this rank's, over its own tokens, as the
    reference defines it: ranks of one data row may hold other totals."""
    tokens, labels = batch["tokens"], batch["labels"]
    h, _, aux = forward(params, tokens, cfg, plan, extras=batch,
                        remat=remat)
    w = _head_weight(params, cfg)
    loss = pmean_dp(_chunked_xent(all_gather_seq(h, plan), labels, w, cfg,
                                  plan, xent_chunk), plan)
    aux = pmean_dp(aux, plan)
    if cfg.mtp_depth > 0 and "mtp" in params:
        loss = loss + 0.1 * mtp_loss(params, h, labels, w, cfg, plan,
                                     xent_chunk)
    return loss + aux


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------


def _to_ring(arr: torch.Tensor, seq_axis: int, s: int, ring: int
             ) -> torch.Tensor:
    """Re-layout a linear [0, s) cache into the decode ring buffer of
    length ``ring`` (slot of token p = p % ring)."""
    if s <= ring:
        pad = list(arr.shape)
        pad[seq_axis] = ring - s
        return torch.cat([arr, arr.new_zeros(pad)], dim=seq_axis)
    seg = arr.narrow(seq_axis, s - ring, ring)
    return torch.roll(seg, (s - ring) % ring, dims=seq_axis)


def prepare_decode_caches(caches, cfg: ModelConfig, plan: ShardingPlan,
                          s: int, s_max: int):
    """Grow prefill caches (length s) to decode capacity (s_max), turning
    sliding-window layers into their ring-buffer layout (MLA has no
    window: its ``c`` caches grow along the sequence).  A layer whose
    cache is sequence-sharded (``attention.use_seq_cache``) grows to
    s_max padded to a multiple of tp, of which this rank keeps its
    chunk (the replicated prefill computed all of it)."""
    out = []
    for spec, c in zip(layer_specs(cfg), caches):
        if spec.kind == "mamba":  # O(1) state: nothing grows
            out.append(c)
            continue
        window = (None if _is_mla(cfg)
                  else cfg.attention.layer_window(spec.pattern_idx))
        target = s_max if window is None else attn_mod._ring_len(window,
                                                                 s_max)
        chunked = not _is_mla(cfg) and attn_mod.use_seq_cache(cfg, plan,
                                                              window)
        if chunked:
            target = attn_mod._pad_to(s_max, plan.tp)
        grown = {name: _to_ring(arr, 1, s, target)
                 for name, arr in c.items()}
        if chunked:
            grown = {name: seq_chunk(arr, plan) for name, arr in grown.items()}
        out.append(grown)
    return out


def gather_logits(logits_local: torch.Tensor, cfg: ModelConfig,
                  plan: ShardingPlan) -> torch.Tensor:
    """(B, V_local) logits of this rank's vocab shard -> (B, V_pad): the
    columns past the vocabulary at -1e30, then all-gathered over the
    model axis (the logits as they are at tp = 1)."""
    if plan.tp == 1:
        return logits_local
    masked = _mask_pad_vocab(logits_local[:, None], cfg, plan,
                             logits_local.shape[-1])[:, 0]
    return dataflow.all_gather(masked, plan.axis, dim=1)


def prefill(params, tokens: torch.Tensor, cfg: ModelConfig,
            plan: ShardingPlan, extras=None, kv_dtype: str = "bfloat16",
            s_max: Optional[int] = None):
    """-> (last-token logits (B, V_pad) float32, caches ready for decode
    up to s_max positions).  At tp > 1 the last token's row comes from
    the last sequence shard (:func:`common.last_shard_row`)."""
    h, caches, _ = forward(params, tokens, cfg, plan, extras,
                           want_caches=True, kv_dtype=kv_dtype)
    if s_max is not None and s_max != tokens.shape[1]:
        caches = prepare_decode_caches(caches, cfg, plan, tokens.shape[1],
                                       s_max)
    last = last_shard_row(h, plan)[:, None]
    logits = lm_logits_local(params, last, cfg, plan)[:, 0]
    return gather_logits(logits, cfg, plan), caches


def decode_step(params, token: torch.Tensor, caches, pos: int,
                cfg: ModelConfig, plan: ShardingPlan,
                kv_dtype: str = "bfloat16"):
    """token: (B,) ids at absolute position ``pos`` -> (logits (B, V_pad)
    float32, caches).  The caches are updated in place."""
    x = embed_lookup(params["embed"], token[:, None], plan)  # (B, 1, D)
    new_caches = []
    for p, spec, c in zip(params["layers"], layer_specs(cfg), caches):
        x, c = decode_layer(p, x, c, pos, spec, cfg, plan, kv_dtype=kv_dtype)
        new_caches.append(c)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = lm_logits_local(params, x, cfg, plan)[:, 0]
    return gather_logits(logits, cfg, plan), new_caches


def init_cache(cfg: ModelConfig, plan: ShardingPlan, batch: int, s_max: int,
               kv_dtype: str = "bfloat16", device=None
               ) -> List[Dict[str, torch.Tensor]]:
    """Zero decode caches, one dict per layer, on ``device`` (``None`` =
    the card): a rank's shapes under ``plan`` (the global ones with
    ``plan.global_shapes``)."""
    _decoder_only(cfg)
    dev = resolve_device(device)
    out = []
    for spec in layer_specs(cfg):
        if spec.kind == "mamba":
            shapes = ssm_mod.mamba_cache_shape(cfg, plan, batch)
        elif _is_mla(cfg):
            shapes = attn_mod.mla_cache_shape(cfg, plan, batch, s_max,
                                              kv_dtype)
        else:
            shapes = attn_mod.gqa_cache_shape(cfg, plan, batch, s_max,
                                              spec.pattern_idx, kv_dtype)
        out.append({k: torch.zeros(sh, dtype=dt, device=dev)
                    for k, (sh, dt) in shapes.items()})
    return out
