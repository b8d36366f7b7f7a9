"""LM model foundations on torch (``repro/models/common.py``): the
sharding plan, the plan-aware linear dispatchers, norms, activations,
RoPE, soft caps, the vocab-sharded embedding lookup, the cross-entropy
over the head's logits, initializers, the quantized-weight leaf path and
flash attention (with its gradient on the card: ``grouped_local_attention``
takes ``LocalAttentionFn`` when an input requires grad).

The reference writes these as per-device functions inside one
``shard_map``.  Here each is a per-rank function: at tp = 1 every
collective is local math, and at tp > 1 the plan holds the mesh axis
(``launch/mesh.py::MeshAxis``) over which :func:`up` and :func:`down`
run the Domino ring matmuls or the all-reduce baseline
(``core/dataflow.py``), :func:`psum_if` reduces partial sums and
:func:`embed_lookup` merges the vocab shards' gathers.  Every collective
there has its gradient (the collective's transpose), so the same
functions train at tp > 1: :func:`sharded_softmax_xent` merges the
vocab shards' log-sum-exp and label picks over the model axis and
averages over the data axes (``plan.dp_axis``), and a :class:`Zero3`
leaf (ZeRO-3: a weight split over the data axes too) is all-gathered by
:func:`resolve_w` at its use, its gradient reduce-scattered back.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import dataflow
from repro_torch.core.engine import is_quantized_leaf
from repro_torch.kernels import local_attention as attention_kernel

# ---------------------------------------------------------------------------
# Sharding plan
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShardingPlan:
    """Static parallel layout decisions for one (arch, mesh) pair, the
    reference's fields, plus the mesh axis the model axis runs on
    (``axis``; None where no collective runs: tp = 1, or shapes only)."""

    tp: int = 1                      # model-axis size
    tp_axis: str = "model"
    dp_axes: Tuple[str, ...] = ()    # data axes
    reduction: str = "ring"          # "ring" (Domino) | "allreduce"
    attn_sharded: bool = True        # query heads sharded over tp?
    kv_sharded: bool = True          # kv heads sharded too?
    experts_pad: int = 0             # experts padded to a multiple of tp
    seq_shard: bool = True           # residual stream sequence-sharded
    #: global-attention KV caches sharded over their sequence dim when
    #: heads cannot shard (H % tp != 0), merged by log-sum-exp
    seq_cache: bool = False
    #: init functions produce global (unsharded) shapes
    global_shapes: bool = False
    axis: Any = field(default=None, compare=False, repr=False)
    #: the mesh axis over the data axes (``launch/mesh.py``: the data
    #: axis, or both axes under ``dp_only``), over which the loss is
    #: averaged; None on one rank's data
    dp_axis: Any = field(default=None, compare=False, repr=False)

    def __post_init__(self):
        if self.reduction not in ("ring", "allreduce"):
            raise ValueError(f"reduction must be ring or allreduce: "
                             f"{self.reduction!r}")
        if self.axis is not None and self.axis.size != self.tp:
            raise ValueError(f"a plan at tp={self.tp} on a mesh axis of "
                             f"size {self.axis.size}")

    def as_global(self) -> "ShardingPlan":
        return replace(self, global_shapes=True)

    @staticmethod
    def for_model(cfg: ModelConfig, tp: int = 1,
                  dp_axes: Tuple[str, ...] = (),
                  reduction: str = "ring", axis=None,
                  dp_axis=None) -> "ShardingPlan":
        a = cfg.attention
        attn_sharded = a is not None and a.num_heads % tp == 0
        kv_sharded = attn_sharded and a.num_kv_heads % tp == 0
        pad = (-cfg.moe.num_experts) % tp if cfg.moe is not None else 0
        return ShardingPlan(
            tp=tp, dp_axes=dp_axes, reduction=reduction,
            attn_sharded=attn_sharded, kv_sharded=kv_sharded,
            experts_pad=pad, axis=axis, dp_axis=dp_axis)

    # -- local shard sizes ---------------------------------------------------

    def heads_local(self, cfg: ModelConfig) -> int:
        h = cfg.attention.num_heads
        if self.global_shapes:
            return h
        return h // self.tp if self.attn_sharded else h

    def kv_local(self, cfg: ModelConfig) -> int:
        kv = cfg.attention.num_kv_heads
        if self.global_shapes:
            return kv
        return kv // self.tp if self.kv_sharded else kv

    def shard(self, n: int) -> int:
        """This rank's share of ``n`` (all of it with global shapes)."""
        if self.global_shapes:
            return n
        if n % self.tp:
            raise ValueError(f"{n} does not shard {self.tp} ways")
        return n // self.tp

    def tp_index(self) -> int:
        """This rank's index on the model axis."""
        if self.tp == 1:
            return 0
        if self.axis is None:
            raise RuntimeError("a tp > 1 plan without a mesh axis runs no "
                               "collective (build it with axis=)")
        return self.axis.index


# ---------------------------------------------------------------------------
# Weight residency
# ---------------------------------------------------------------------------


class Zero3:
    """A ZeRO-3 leaf: this rank's ``shard`` of a weight split over the
    data axes (the mesh axis ``axis``) on ``dim``, the reference's
    ``Zero3``; :func:`resolve_w` all-gathers it at each use, so a rank
    holds one layer's whole weight at a time (under checkpointing the
    recompute gathers it again).  The gradient goes to ``sink``, a
    float32 leaf of the shard's shape (a zero-stride expand: no memory),
    not to the shard: the gather's backward reduce-scatters the whole
    weight's gradient in float32 over the data axes, and the sink keeps
    that sum unrounded, as the other leaves' data sums are kept."""

    def __init__(self, shard: torch.Tensor, dim: int, axis, sink=None):
        self.shard, self.dim, self.axis, self.sink = shard, dim, axis, sink

    @property
    def shape(self):
        return self.shard.shape

    def unbind(self):
        """One :class:`Zero3` per entry of a stacked shard's first dim
        (``dim`` is in the entries' coordinates)."""
        sinks = (torch.unbind(self.sink, 0) if self.sink is not None
                 else [None] * self.shard.shape[0])
        return [Zero3(s, self.dim, self.axis, k)
                for s, k in zip(torch.unbind(self.shard, 0), sinks)]


class _Zero3Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, sink, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return dataflow._all_gather(shard, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (None, dataflow._psum_scatter(g.float(), ctx.axis, ctx.dim),
                None, None)


def _gather_zero3(w: Zero3) -> torch.Tensor:
    if w.sink is not None and torch.is_grad_enabled():
        return _Zero3Gather.apply(w.shard, w.sink, w.axis, w.dim)
    return dataflow.all_gather(w.shard, w.axis, w.dim)


def resolve_w(w, like: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weights may arrive as ``{"q": int8, "s": scale}`` (CIM-resident
    serving mode): dequantize on use, in float32 and then to ``like``'s
    dtype (bfloat16 without ``like``, as the reference does).  The scale
    is applied in place: one float32 copy of the weight, not two (a
    deepseek-v3 expert stack is 15 GB in float32).  A :class:`Zero3`
    leaf is all-gathered over its data axes first."""
    if isinstance(w, Zero3):
        return resolve_w(_gather_zero3(w), like)
    if is_quantized_leaf(w):
        dtype = like.dtype if like is not None else torch.bfloat16
        return w["q"].to(torch.float32).mul_(w["s"]).to(dtype)
    return w


def local_linear(x: torch.Tensor, w, bias=None) -> torch.Tensor:
    """``x @ w`` (+ bias) in x's dtype.  The reference accumulates in
    float32 and rounds once; in bfloat16 the product here is rounded once
    before a float32 bias add.  Operands of two dtypes multiply in the
    promoted one, as the reference's einsum promotes them (a float32
    frame against a bfloat16 weight), and the result is rounded to x's
    dtype."""
    w = resolve_w(w, x)
    if w.dtype != x.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        y = torch.matmul(x.to(dt), w.to(dt))
    else:
        y = torch.matmul(x, w)
    if bias is None:
        return y.to(x.dtype)
    return (y.float() + bias).to(x.dtype)


def up(x: torch.Tensor, w, plan: ShardingPlan, tail=None) -> torch.Tensor:
    """Sequence-sharded in -> (full sequence, local features) out: the
    ring all-gather matmul or the all-gather baseline by
    ``plan.reduction``; ``tail`` runs on the float32 product.  At
    tp > 1 only: at tp = 1 the callers take :func:`local_linear`."""
    w = resolve_w(w, x)
    return dataflow.up_matmul(x, w, axis=plan.axis,
                              reduction=plan.reduction, tail=tail)


def down(x: torch.Tensor, w, plan: ShardingPlan, tail=None) -> torch.Tensor:
    """(full sequence, local features) in -> sequence-sharded, fully
    reduced out: the ring reduce-scatter matmul or the all-reduce
    baseline.  At tp > 1 only, as :func:`up`."""
    w = resolve_w(w, x)
    return dataflow.down_matmul(x, w, axis=plan.axis,
                                reduction=plan.reduction, tail=tail)


def psum_if(x: torch.Tensor, plan: ShardingPlan) -> torch.Tensor:
    """Sum over the model axis at tp > 1."""
    if plan.tp == 1:
        return x
    return dataflow.psum(x, plan.axis)


def all_gather_seq(h: torch.Tensor, plan: ShardingPlan) -> torch.Tensor:
    """The whole sequence (B, S, ...) from the sequence-sharded stream
    (B, S/k, ...) at tp > 1: all-gathered over the model axis (its
    gradient reduce-scatters); as it is otherwise."""
    if plan.tp == 1 or not plan.seq_shard:
        return h
    return dataflow.all_gather(h, plan.axis, dim=1)


def last_shard_row(h: torch.Tensor, plan: ShardingPlan) -> torch.Tensor:
    """h[:, -1] of the whole sequence from a sequence-sharded h
    (B, S/k, D): the last shard's row, others zero, summed over the
    model axis (the reference's masked psum)."""
    last = h[:, -1]
    if plan.tp == 1 or not plan.seq_shard:
        return last
    if plan.tp_index() != plan.tp - 1:
        last = torch.zeros_like(last)
    return psum_if(last, plan)


# ---------------------------------------------------------------------------
# Norms / activations / RoPE
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMS norm with a zero-centred scale: ``x / rms(x) * (1 + scale)``,
    in float32."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * (1.0 + scale.float())
            ).to(x.dtype)


def _relu2(v: torch.Tensor) -> torch.Tensor:
    return torch.square(F.relu(v))


def _gelu_tanh(v: torch.Tensor) -> torch.Tensor:
    return F.gelu(v, approximate="tanh")


ACT = {
    "silu": F.silu,
    "gelu": _gelu_tanh,
    "relu2": _relu2,
    "relu": F.relu,
}


def gated_act(name: str) -> bool:
    return name in ("silu", "gelu")


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: (B, S, H, D) with D even; positions: (S,) or (B, S).  Rotates
    the two halves of D (split-halves convention) by float32 angles."""
    d = x.shape[-1]
    if d % 2:
        raise ValueError(f"rope needs an even head dim: {d}")
    # a Python scalar times a float32 tensor multiplies in float32, as
    # the reference's weakly typed scalar does, with no host-to-device
    # copy (which would wait for the card)
    freqs = torch.exp(-math.log(theta) * torch.arange(
        0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = positions.to(torch.float32)[..., None] * freqs  # (..., S, D/2)
    if ang.dim() == 2:  # (S, D/2) -> broadcast over batch
        ang = ang[None]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


# ---------------------------------------------------------------------------
# Flash attention (the sliding-window kernel; plain bidirectional blocks)
# ---------------------------------------------------------------------------

#: query rows per block of the bidirectional attention, as the
#: reference's ``block_q``: one block's float32 scores are (B, H, 512,
#: S_kv), 268 MB at batch 4, 16 heads and 2048 keys
BLOCK_Q = 512


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    logit_softcap: Optional[float] = None) -> torch.Tensor:
    """Attention of q (B, S, H, DQK) over k (B, S_kv, KV, DQK) and v
    (B, S_kv, KV, DV), H a multiple of KV; the output is (B, S, H, DV),
    scaled by ``DQK^-0.5`` as the reference's (MLA's v head dim differs
    from its q/k one).

    Causal self-attention goes through the sliding-window kernel
    (``kernels/local_attention.py``): a local layer passes its window; a
    global layer (``window=None``) runs it with ``window = S``, which is
    full causal attention.  ``causal=False`` (the encoder's
    self-attention and cross-attention over the encoder's memory) has no
    TPU kernel (the Pallas kernel always masks ``k <= q``): it runs
    :func:`bidirectional_attention`, the reference's plain blocks."""
    if not causal:
        if window is not None:
            raise ValueError(
                "bidirectional attention with a window: the reference "
                "slices window + block_q keys per block, which no config "
                "uses and the port does not mirror")
        return bidirectional_attention(q, k, v, logit_softcap=logit_softcap)
    return attention_kernel.grouped_local_attention(
        q, k, v, window=k.shape[1] if window is None else window,
        softcap=logit_softcap)


def bidirectional_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *,
                            logit_softcap: Optional[float] = None
                            ) -> torch.Tensor:
    """The reference's ``flash_attention(causal=False)`` step by step, in
    plain PyTorch: for each block of ``BLOCK_Q`` query rows, float32
    logits of the upcast operands times ``DQK^-0.5``, the soft cap, no
    mask, a float32 softmax, the probabilities cast to v's dtype and
    ``p . v`` in v's dtype.  q, k and v may hold two dtypes (a bfloat16
    decoder stream against a float32 memory); the output takes v's.
    Query head h reads kv head ``h // (H / KV)``."""
    b, s, h, d = q.shape
    kvh, dv = k.shape[2], v.shape[3]
    group = h // kvh
    kt = k.float().permute(0, 2, 3, 1).unsqueeze(2)      # (B, KV, 1, D, T)
    vg = v.permute(0, 2, 1, 3).unsqueeze(2)              # (B, KV, 1, T, DV)
    outs = []
    for start in range(0, s, BLOCK_Q):
        qb = q[:, start:start + BLOCK_Q].float()
        n = qb.shape[1]
        qg = qb.reshape(b, n, kvh, group, d).permute(0, 2, 3, 1, 4)
        logits = softcap(torch.matmul(qg, kt) * d ** -0.5, logit_softcap)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)  # (B,KV,G,n,T)
        o = torch.matmul(probs, vg)                         # (B,KV,G,n,DV)
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(b, n, h, dv))
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# Embedding and cross-entropy
# ---------------------------------------------------------------------------


def embed_lookup(table: torch.Tensor, ids: torch.Tensor,
                 plan: ShardingPlan) -> torch.Tensor:
    """table: (V_local, D), this rank's vocab shard; ids: (B, S) global
    ids -> (B, S, D).  At tp > 1 a masked local gather (ids outside the
    shard read zero) summed over the model axis."""
    if plan.tp == 1:
        return table[ids]
    v_local = table.shape[0]
    lo = plan.tp_index() * v_local
    hit = (ids >= lo) & (ids < lo + v_local)
    emb = table[torch.clamp(ids - lo, 0, v_local - 1)]
    emb = torch.where(hit[..., None], emb, torch.zeros((), dtype=emb.dtype,
                                                       device=emb.device))
    return psum_if(emb, plan)


class _SumExpAndPick(torch.autograd.Function):
    """(sum over the vocab of ``exp(x - m)``, ``x`` at ``local`` where
    ``hit`` and 0 elsewhere) of float32 logits ``x`` (B, S, V).  Its
    backward forms dx in one buffer: ``exp(x - m) * g_sum``, then the
    picked positions' gradient added in place.  Autograd's own graph
    (exp, sum, gather) gives the same values, but its gather backward
    scatters into a second (B, S, V) buffer and then adds the two: in
    place where nothing else references them, out of place under a
    Python dispatch mode (``analysis/op_stats.py``, a dry run), so the
    step's peak would depend on whether it is being counted."""

    @staticmethod
    def forward(ctx, x, m, local, hit):
        e = torch.exp(x - m[..., None])
        picked = torch.gather(x, -1, local[..., None])[..., 0]
        ctx.save_for_backward(e, local, hit)
        return (torch.sum(e, dim=-1),
                torch.where(hit, picked, torch.zeros_like(picked)))

    @staticmethod
    def backward(ctx, g_sum, g_pick):
        e, local, hit = ctx.saved_tensors
        dx = e * g_sum[..., None]
        dx.scatter_add_(-1, local[..., None], torch.where(
            hit, g_pick, torch.zeros_like(g_pick))[..., None])
        return dx, None, None, None


def sharded_softmax_xent(logits_local: torch.Tensor, labels: torch.Tensor,
                         plan: ShardingPlan,
                         valid: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Mean cross-entropy of vocab-sharded logits (B, S, V_local)
    against global label ids (B, S), over the ``valid`` positions (all
    without it), in float32; the reference's.  The max shift is
    detached before its ``pmax`` over the model axis (the reference's
    ``stop_gradient``: it has no gradient), the log-sum-exp is ``m +
    log(psum(sum(exp(x - m))))``, and the label's logit is picked on the
    rank whose shard ``[lo, lo + V_local)`` holds it and psummed (a label
    outside the vocabulary picks 0).  With ``plan.dp_axes`` the loss is
    averaged over ``plan.dp_axis``."""
    v_local = logits_local.shape[-1]
    lo = plan.tp_index() * v_local
    x = logits_local.float()
    m = torch.amax(x, dim=-1).detach()
    if plan.tp > 1:
        m = dataflow.pmax(m, plan.axis)
    hit = (labels >= lo) & (labels < lo + v_local)
    local = torch.clamp(labels - lo, 0, v_local - 1).long()
    sumexp, picked = _SumExpAndPick.apply(x, m, local, hit)
    lse = m + torch.log(psum_if(sumexp, plan))
    picked = psum_if(picked, plan)
    nll = lse - picked
    valid = torch.ones_like(nll) if valid is None else valid.float()
    loss = torch.sum(nll * valid) / torch.clamp_min(torch.sum(valid), 1.0)
    return pmean_dp(loss, plan)


def pmean_dp(x: torch.Tensor, plan: ShardingPlan) -> torch.Tensor:
    """``x`` averaged over the data axes (the reference's ``lax.pmean``
    over ``plan.dp_axes``); as it is without them or on one rank's
    data."""
    if not plan.dp_axes or plan.dp_axis is None:
        return x
    return dataflow.pmean(x, plan.dp_axis)


def _mask_pad_vocab(logits_local: torch.Tensor, cfg: ModelConfig,
                    plan: ShardingPlan, v_local: int) -> torch.Tensor:
    """Columns past the vocabulary at ``-1e30``: this rank's vocab shard
    starts at ``tp_index * v_local``.  Where every column is a real id
    the logits come back as they are (the reference's ``where`` with an
    all-true mask)."""
    lo = plan.tp_index() * v_local
    if lo + v_local <= cfg.vocab_size:
        return logits_local
    col = lo + torch.arange(v_local, device=logits_local.device)
    return torch.where((col < cfg.vocab_size)[None, None, :], logits_local,
                       torch.full_like(logits_local, -1e30))


# ---------------------------------------------------------------------------
# Initializers (explicit generator, device and dtype)
# ---------------------------------------------------------------------------


def randn(gen, shape) -> torch.Tensor:
    """Normal float32 draws from ``gen`` on its device; on the ``meta``
    device (``runtime/partition.py::META``) only the shape."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device)


def rand(gen, shape) -> torch.Tensor:
    """Uniform [0, 1) float32 draws, as :func:`randn`."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.rand(shape, generator=gen, dtype=torch.float32,
                      device=gen.device)


def dense_init(gen, fan_in: int, shape, dtype) -> torch.Tensor:
    """Normal draws in float32 / sqrt(fan_in), cast to ``dtype``; the
    division in place, so one float32 copy is made, not two."""
    return randn(gen, shape).div_(math.sqrt(fan_in)).to(dtype)


def embed_init(gen, shape, dtype) -> torch.Tensor:
    return (randn(gen, shape) * 0.02).to(dtype)
