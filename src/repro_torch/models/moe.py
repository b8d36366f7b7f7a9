"""Expert-parallel Mixture-of-Experts on torch (``repro/models/moe.py``:
jamba 16e/top-2, granite 40e/top-8, deepseek-v3 256e/top-8 + shared
experts).

Experts are sharded over the model axis; tokens are already sharded on
the same axis (the sequence-parallel stream), so the dispatch is one
tiled ``all_to_all`` each way: ``(E_total, cap, D) -> (e_local, tp * cap,
D)`` and back (Domino's view: tokens travel to the tiles that hold their
weights).  At tp = 1 the exchange is a reshape.  ``E_total`` is
``num_experts + plan.experts_pad``; the padded experts' router columns
read ``-1e30``, so no token picks them.  Routing, the capacity (from the
rank's own tokens) and the dropping are per rank, as in the reference:
capacity-sliced, Switch-style token dropping.  The (token, k) pairs are
sorted stably by expert, each keeps its position within its expert's
group, and a pair whose position reaches the capacity is dropped.

One departure, in the combine: the reference scatter-adds each token's
K contributions in float32.  On the card ``index_add_`` adds them
through atomics in no fixed order, which moves the last bits from run to
run (and with them a bfloat16 rounding, and a greedy token).  Here each
token's K contributions are gathered into (T, K, D), dropped pairs zero,
and summed over k by one fixed-order reduction: two runs on the same
inputs give the same bits.  The backward of the dispatch and of the
combine gathers too (:class:`_GatherRows`): a token's gradient is its K
slots' gradients summed over k, and a slot's is its one pair's, where
autograd's scatter-add would sum through atomics.

In training each all_to_all's gradient is the all_to_all with its two
dims swapped (``core/dataflow.py``), and the aux loss is each rank's,
over its own tokens, as the reference defines it (per-device balance is
what the capacity limit acts on): at tp > 1 it is not tp = 1's.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import dataflow
from repro_torch.models.common import (
    ACT,
    ShardingPlan,
    dense_init,
    gated_act,
    resolve_w,
)


def init_moe(gen: torch.Generator, cfg: ModelConfig, plan: ShardingPlan,
             dtype):
    m = cfg.moe
    d, f = cfg.d_model, m.d_ff_expert
    e_local = plan.shard(m.num_experts + plan.experts_pad)
    p = {
        "router": dense_init(gen, d, (d, m.num_experts), torch.float32),
        "w_in": dense_init(gen, d, (e_local, d, f), dtype),
        "w_out": dense_init(gen, f, (e_local, f, d), dtype),
    }
    if gated_act(cfg.activation):
        p["w_gate"] = dense_init(gen, d, (e_local, d, f), dtype)
    if m.num_shared_experts:
        fs = f * m.num_shared_experts
        p["shared_in"] = dense_init(gen, d, (d, fs), dtype)
        p["shared_out"] = dense_init(gen, fs, (fs, d), dtype)
        if gated_act(cfg.activation):
            p["shared_gate"] = dense_init(gen, d, (d, fs), dtype)
    return p


def capacity(t: int, cfg: ModelConfig, plan: ShardingPlan) -> int:
    """Slots per expert for ``t`` tokens: the reference's expression
    (``repro/models/moe.py:82``), at least 1."""
    m = cfg.moe
    e_total = m.num_experts + plan.experts_pad
    return max(int(math.ceil(t * m.top_k / e_total * m.capacity_factor)), 1)


def route(p, xt: torch.Tensor, cfg: ModelConfig, plan: ShardingPlan):
    """Router of (T, D) tokens -> (gate weights (T, K) float32, each
    (token, k) pair's slot in the (E * cap) table or -1 when dropped
    (T, K), cap, aux loss)."""
    m = cfg.moe
    t = xt.shape[0]
    e_total = m.num_experts + plan.experts_pad
    logits = torch.matmul(xt.float(), p["router"].float())  # (T, E_real)
    if plan.experts_pad:
        logits = torch.cat([logits, logits.new_full(
            (t, plan.experts_pad), -1e30)], dim=1)
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_e = torch.topk(probs, m.top_k, dim=-1)      # descending
    gate_w = gate_w / torch.clamp_min(gate_w.sum(-1, keepdim=True), 1e-9)

    # load-balance aux loss (Switch): E * sum_e f_e * P_e
    me = torch.mean(probs, dim=0)
    # a fixed-length count (``bincount``'s length depends on the data)
    flat = gate_e.reshape(-1)
    counts = torch.zeros(e_total, dtype=torch.int64, device=flat.device
                         ).scatter_add_(0, flat, torch.ones_like(flat))
    ce_frac = counts.float() / (t * m.top_k)
    aux = m.num_experts * torch.sum(me * ce_frac) * m.aux_loss_coef

    # dispatch: sort (token, k) pairs by expert (stable), slice capacity
    cap = capacity(t, cfg, plan)
    flat_e = gate_e.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]
    pos_in_e = (torch.arange(t * m.top_k, device=xt.device)
                - torch.searchsorted(sorted_e, sorted_e, side="left"))
    slot_sorted = torch.where(pos_in_e < cap, sorted_e * cap + pos_in_e,
                              torch.full_like(pos_in_e, -1))
    slot = torch.empty_like(slot_sorted)
    slot[order] = slot_sorted
    return gate_w, slot.reshape(t, m.top_k), cap, aux


class _GatherRows(torch.autograd.Function):
    """``cat([src, zero row])[index]`` whose backward gathers as well:
    ``inverse`` maps each row of ``src`` to the output rows it went to
    (the output's row count where none), one per row or K per row (then
    summed over k, in k order)."""

    @staticmethod
    def forward(ctx, src, index, inverse):
        ctx.save_for_backward(inverse)
        return torch.cat([src, src.new_zeros((1, src.shape[1]))])[index]

    @staticmethod
    def backward(ctx, grad):
        inverse, = ctx.saved_tensors
        flat = grad.reshape(-1, grad.shape[-1])
        back = torch.cat([flat, flat.new_zeros((1, flat.shape[1]))])[inverse]
        if inverse.dim() == 2:
            back = back.float().sum(dim=1).to(grad.dtype)
        return back, None, None


def moe_forward(p, x: torch.Tensor, cfg: ModelConfig, plan: ShardingPlan
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S_local, D) -> (same shape, aux loss scalar).  At tp > 1
    this rank routes its own tokens; the experts it holds run on every
    rank's tokens for them."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    e_total = m.num_experts + plan.experts_pad
    act = ACT[cfg.activation]

    gate_w, slot, cap, aux = route(p, xt, cfg, plan)
    n_pairs, n_slots = t * m.top_k, e_total * cap
    # slot table: each slot's (token, k) pair (n_pairs where empty) and
    # token (t, the zero row, where empty); each pair's slot (n_slots,
    # the zero row, where dropped)
    flat = slot.reshape(-1)
    # a dropped pair writes to one more slot, cut off after: a shape
    # that does not depend on the data
    dest = torch.where(flat >= 0, flat, torch.full_like(flat, n_slots))
    slot_pair = torch.full((n_slots + 1,), n_pairs, dtype=torch.long,
                           device=x.device).scatter_(
        0, dest, torch.arange(n_pairs, device=x.device))[:n_slots]
    slot_tok = torch.where(slot_pair < n_pairs,
                           torch.div(slot_pair, m.top_k,
                                     rounding_mode="floor"),
                           torch.full_like(slot_pair, t))
    rows = torch.where(slot >= 0, slot, torch.full_like(slot, n_slots))
    dispatched = _GatherRows.apply(xt, slot_tok, rows).reshape(
        e_total, cap, d)
    if plan.tp > 1:
        # tokens -> the ranks holding their experts: (e_local, tp * cap,
        # D), sender-major rows
        dispatched = dataflow.all_to_all(dispatched, plan.axis,
                                         split_axis=0, concat_axis=1)

    # expert FFN, batched over the local experts, in x's dtype
    h = torch.bmm(dispatched, resolve_w(p["w_in"], x))
    if "w_gate" in p:
        g = torch.bmm(dispatched, resolve_w(p["w_gate"], x))
        h = (act(g.float()) * h.float()).to(x.dtype)
    else:
        h = act(h.float()).to(x.dtype)
    y = torch.bmm(h, resolve_w(p["w_out"], x))
    if plan.tp > 1:
        # results back to their senders: (E_total, cap, D)
        y = dataflow.all_to_all(y, plan.axis, split_axis=1, concat_axis=0)
    y = y.reshape(n_slots, d)

    # combine: each token's K contributions (dropped pairs zero), summed
    # over k in one fixed-order reduction
    contrib = _GatherRows.apply(y, rows, slot_pair).float() * torch.where(
        slot >= 0, gate_w, torch.zeros_like(gate_w))[..., None]  # (T, K, D)
    out = contrib.sum(dim=1).to(x.dtype)

    # shared experts (dense, always on), float32 products
    if "shared_in" in p:
        hs = torch.matmul(xt.float(), resolve_w(p["shared_in"], x).float())
        if "shared_gate" in p:
            gs = torch.matmul(xt.float(),
                              resolve_w(p["shared_gate"], x).float())
            hs = act(gs) * hs
        else:
            hs = act(hs)
        out = out + torch.matmul(
            hs.to(x.dtype).float(),
            resolve_w(p["shared_out"], x).float()).to(x.dtype)
    return out.reshape(b, s, d), aux


def dropped_pairs(p, x: torch.Tensor, cfg: ModelConfig, plan: ShardingPlan
                  ) -> Tuple[int, int]:
    """(dropped (token, k) pairs, capacity) of ``moe_forward`` on x."""
    _, slot, cap, _ = route(p, x.reshape(-1, x.shape[-1]), cfg, plan)
    return int((slot < 0).sum()), cap
