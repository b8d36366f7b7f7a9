"""Mamba-1 selective-SSM block on torch (``repro/models/ssm.py``:
falcon-mamba, jamba's mamba layers).

The d_inner channels are sharded over the model axis: the conv and the
scan are independent across channels, so each rank runs them on its
``d_inner / tp`` channels; only the small x_proj that produces dt / B /
C needs a sum over the axis (a Domino-style partial sum of a
``dt_rank + 2 d_state`` wide vector).  The in projections ride the ring
(``up``) and the out projection comes back through ``down``; decode
psums the out projection's partial sums.  Prefill runs the causal
depthwise conv, the dt / B / C projections, and the scan through the
selective-scan kernel (``kernels/selective_scan.py``; the reference's
``lax.associative_scan``); decode is the O(1) recurrent step on the
carried (conv, ssm) state, in plain PyTorch.  In training at tp > 1 the
x_proj psum's gradient is a psum (its transpose), and the scan's
backward kernel runs at the rank's channels.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import selective_scan as scan_kernel
from repro_torch.models.common import (
    ShardingPlan,
    dense_init,
    down,
    local_linear,
    psum_if,
    rand,
    resolve_w,
    up,
)


def _dims(cfg: ModelConfig, plan: ShardingPlan):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    return s, d_in, plan.shard(d_in), s.resolved_dt_rank(cfg.d_model)


def init_mamba(gen: torch.Generator, cfg: ModelConfig, plan: ShardingPlan,
               dtype):
    s, _, dl, dt_rank = _dims(cfg, plan)
    d = cfg.d_model
    dev = gen.device
    # S4D-real initialization for A; dt bias ~ softplus-inverse of
    # [1e-3, 0.1]
    a_init = torch.log(torch.arange(1, s.d_state + 1, dtype=torch.float32,
                                    device=dev))[None, :].repeat(dl, 1)
    u = rand(gen, (dl,))
    dt_init = torch.exp(u * (math.log(0.1) - math.log(1e-3))
                        + math.log(1e-3))
    dt_bias = dt_init + torch.log(-torch.expm1(-dt_init))
    return {
        "w_in_x": dense_init(gen, d, (d, dl), dtype),
        "w_in_z": dense_init(gen, d, (d, dl), dtype),
        "conv_w": dense_init(gen, s.d_conv, (dl, s.d_conv), dtype),
        "conv_b": torch.zeros((dl,), dtype=dtype, device=dev),
        "x_proj": dense_init(gen, dl, (dl, dt_rank + 2 * s.d_state), dtype),
        "dt_proj": dense_init(gen, dt_rank, (dt_rank, dl), dtype),
        "dt_bias": dt_bias,
        "A_log": a_init,
        "D": torch.ones((dl,), dtype=torch.float32, device=dev),
        "w_out": dense_init(gen, dl, (dl, d), dtype),
    }


def _softplus(v: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(v, 0)``), with no threshold."""
    return torch.clamp_min(v, 0.0) + torch.log1p(torch.exp(-torch.abs(v)))


def _ssm_params(p, xc: torch.Tensor, cfg: ModelConfig, plan: ShardingPlan):
    """dt, B, C (float32) from the conv output; the x_proj partial sums
    of this rank's channels summed over the model axis.  x_proj and
    dt_proj resolve with no ``like``, as in the reference: an int8 leaf
    dequantizes through bfloat16 before the float32 product."""
    s = cfg.ssm
    dt_rank = s.resolved_dt_rank(cfg.d_model)
    proj = psum_if(torch.matmul(xc.float(), resolve_w(p["x_proj"]).float()),
                   plan)
    dt_in = proj[..., :dt_rank]
    b_mat = proj[..., dt_rank:dt_rank + s.d_state]
    c_mat = proj[..., dt_rank + s.d_state:]
    dt = _softplus(torch.matmul(dt_in, resolve_w(p["dt_proj"]).float())
                   + p["dt_bias"])
    return dt, b_mat, c_mat


def mamba_forward(p, x: torch.Tensor, cfg: ModelConfig, plan: ShardingPlan,
                  want_cache: bool = False):
    """x: (B, S_local, D), sequence-sharded at tp > 1 -> (same shape,
    cache | None); the cache is ``{"h": (B, d_inner_local, d_state)
    float32, "conv": (B, d_conv - 1, d_inner_local) in x's dtype}``."""
    s, _, dl, _ = _dims(cfg, plan)
    if plan.tp > 1:
        xb, zb = up(x, p["w_in_x"], plan), up(x, p["w_in_z"], plan)
    else:
        xb, zb = local_linear(x, p["w_in_x"]), local_linear(x, p["w_in_z"])
    bsz, seq = xb.shape[0], xb.shape[1]

    # causal depthwise conv along the sequence, tap by tap
    pad = s.d_conv - 1
    xp = F.pad(xb, (0, 0, pad, 0)).float()
    w = p["conv_w"].float()
    xc = xp[:, 0:seq] * w[:, 0]
    for k in range(1, s.d_conv):
        xc = xc + xp[:, k:k + seq] * w[:, k]
    xc = F.silu(xc + p["conv_b"].float())

    dt, b_mat, c_mat = _ssm_params(p, xc, cfg, plan)
    a = -torch.exp(p["A_log"].float())  # (dl, n)
    y, h_last = scan_kernel.selective_scan(
        dt, xc, b_mat.contiguous(), c_mat.contiguous(), a, p["D"].float())
    y = (y * F.silu(zb.float())).to(x.dtype)
    out = down(y, p["w_out"], plan) if plan.tp > 1 \
        else local_linear(y, p["w_out"])

    cache = None
    if want_cache:
        cache = {
            "h": h_last,                                   # (B, dl, n)
            "conv": (xb[:, -pad:].to(x.dtype) if pad else
                     x.new_zeros((bsz, 0, dl))),           # (B, d_conv-1, dl)
        }
    return out, cache


def mamba_decode(p, x: torch.Tensor, cache, cfg: ModelConfig,
                 plan: ShardingPlan):
    """x: (B, 1, D), replicated over the model axis -> ((B, 1, D) fully
    reduced, new cache).  O(1) per step."""
    s, _, dl, _ = _dims(cfg, plan)
    xb = local_linear(x, p["w_in_x"])[:, 0]  # (B, dl)
    zb = local_linear(x, p["w_in_z"])[:, 0]

    conv_hist = torch.cat([cache["conv"], xb[:, None, :]], dim=1)
    hist = conv_hist if conv_hist.shape[1] == s.d_conv else F.pad(
        conv_hist, (0, 0, s.d_conv - conv_hist.shape[1], 0))
    hist = hist.float()
    w = p["conv_w"].float()
    xc = hist[:, 0] * w[:, 0]
    for k in range(1, s.d_conv):
        xc = xc + hist[:, k] * w[:, k]
    xc = F.silu(xc + p["conv_b"].float())

    dt, b_mat, c_mat = _ssm_params(p, xc[:, None, :], cfg, plan)
    dt, b_mat, c_mat = dt[:, 0], b_mat[:, 0], c_mat[:, 0]
    a = -torch.exp(p["A_log"].float())
    decay = torch.exp(dt[..., None] * a[None])
    h = decay * cache["h"] + dt[..., None] * b_mat[:, None, :] * xc[..., None]
    y = torch.einsum("bdn,bn->bd", h, c_mat) + p["D"] * xc
    y = (y * F.silu(zb.float())).to(x.dtype)[:, None, :]
    out = psum_if(local_linear(y, p["w_out"]), plan)
    new_cache = {"h": h, "conv": conv_hist[:, -(s.d_conv - 1):]
                 if s.d_conv > 1 else conv_hist[:, :0]}
    return out, new_cache


def mamba_cache_shape(cfg: ModelConfig, plan: ShardingPlan, batch: int):
    """{name: (shape, dtype)} of one mamba layer's decode cache."""
    s, _, dl, _ = _dims(cfg, plan)
    return {
        "h": ((batch, dl, s.d_state), torch.float32),
        "conv": ((batch, s.d_conv - 1, dl), torch.bfloat16),
    }
