"""The training step at tp = 1: the reference's
``repro/runtime/train_loop.py::build_train_program`` on one device.

``step_fn`` follows the reference's ``step_fn_py``: the gradient of the
config's loss by autograd (every attention and selective-scan call on
the card runs its forward kernel, and its backward its backward
kernel), microbatches accumulated in float32 and divided by their
count, the loss the mean of the microbatch losses, optional int8
gradient compression with error feedback, then ``apply_updates``.  The
loss and the init are the reference's ``loss_for`` / ``init_for``:
``encdec.encdec_loss`` and ``encdec.init_params`` for the
encoder-decoder (seamless-m4t), ``transformer.lm_loss`` and
``transformer.init_params`` for every other config (MLA with
multi-token prediction and the vit_stub frontend included).  Params
and optimizer state are the reference's trees (``"segments"`` stacked
over each segment's count; the encoder-decoder's ``"encoder"`` and
``"decoder"`` stacked over their layers), and a step is functional: it
returns new trees and leaves its inputs as they are, so two steps from
one state are bit-equal.  With
``donate=True`` a step writes its new params and moments into the trees
it was given and returns them, as the reference's jitted step donates
its arguments: one copy of the training state lives on the device
(granite-moe-3b-a800m's 3.3 G parameters take 40 GB of params and AdamW
moments, and a functional step would hold two).

The ``ParallelConfig`` fields that only move data between devices have
no effect on one device, as in the reference's tp = 1 plan:
``reduction``, ``zero_axes``, ``seq_sharded_cache`` (and the serving
fields).  ``zero3`` and ``dp_only`` shard or replicate over a mesh, and
training at tp > 1 needs the sharded cross-entropy's and the ring
matmuls' gradients: ROADMAP Queue 1 item 15(b) (serving at tp > 1 is
``runtime/serve_loop.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict

import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig, TrainConfig
from repro_torch.core.cim import divide
from repro_torch.device import resolve_device
from repro_torch.models import encdec as ED
from repro_torch.models import transformer as T
from repro_torch.models.common import ShardingPlan
from repro_torch.optim import optimizer as opt
from repro_torch.tree import leaves, tree_map, unflatten


@dataclass
class TrainProgram:
    """What the launcher needs: the model, its plan and device, and the
    two functions."""

    cfg: ModelConfig
    plan: ShardingPlan
    device: torch.device
    init_fn: Callable           # (seed) -> (params, opt_state)
    step_fn: Callable           # (params, opt_state, batch) -> (..., metrics)
    loss_fn: Callable           # (params, batch) -> scalar loss


def value_and_grad(loss_fn: Callable, params, *args):
    """(loss, gradients in ``params``' structure) of ``loss_fn(params,
    *args)``, as ``jax.value_and_grad``: a leaf the loss does not reach
    gets a zero gradient."""
    flat = [p.detach().requires_grad_() for p in leaves(params)]
    loss = loss_fn(unflatten(params, flat), *args)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    return loss.detach(), unflatten(params, [
        torch.zeros_like(p) if g is None else g
        for p, g in zip(flat, grads)])


def loss_for(cfg: ModelConfig) -> Callable:
    """The config's training loss, as the reference's ``loss_for``."""
    return ED.encdec_loss if cfg.is_encdec else T.lm_loss


def init_for(cfg: ModelConfig) -> Callable:
    """(cfg, plan, generator) -> params in the training layout, as the
    reference's ``init_for`` (its trees stacked as the reference's)."""
    if cfg.is_encdec:
        return lambda c, plan, gen: ED.stack_layers(
            ED.init_params(c, plan, gen))
    return lambda c, plan, gen: T.stack_layers(T.init_params(c, plan, gen),
                                               c)


def build_train_program(cfg: ModelConfig, pcfg: ParallelConfig,
                        tcfg: TrainConfig, device=None,
                        donate: bool = False, mesh=None) -> TrainProgram:
    """The train program of ``cfg`` on ``device`` (``None`` = the card);
    ``donate``: each step updates the params and optimizer state it is
    given in place.  ``mesh`` (``launch/mesh.py``) must have a model
    axis of 1: training at tp > 1 raises."""
    if mesh is not None and (mesh.model.size > 1 or mesh.data.size > 1):
        raise NotImplementedError(
            f"training on a {mesh.shape} mesh (tp > 1, or data parallel "
            "over ranks) is not ported: ROADMAP Queue 1 item 15(b)")
    if pcfg.zero3 or pcfg.dp_only:
        raise NotImplementedError(
            "zero3 and dp_only shard params over a mesh: ROADMAP Queue 1 "
            "item 15(b)")
    dev = resolve_device(device)
    plan = ShardingPlan.for_model(cfg, tp=1)
    init, loss = init_for(cfg), loss_for(cfg)

    def init_fn(seed: int):
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = init(cfg, plan, gen)
        return params, opt.init_opt_state(params, tcfg,
                                          pcfg.grad_compression)

    def loss_fn(params, batch):
        return loss(params, batch, cfg, plan, remat=pcfg.remat)

    def step_fn(params, opt_state: opt.OptState, batch: Dict[str, Any]):
        if pcfg.microbatches > 1:
            n = pcfg.microbatches
            micro = [{k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
                      for k, v in batch.items()} for i in range(n)]
            gsum = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params)
            losses = []
            for mb in micro:
                loss, g = value_and_grad(loss_fn, params, mb)
                gsum = tree_map(lambda a, gg: a + gg.float(), gsum, g)
                losses.append(loss)
            grads = tree_map(lambda g: divide(g, float(n)), gsum)
            loss = torch.mean(torch.stack(losses))
        else:
            loss, grads = value_and_grad(loss_fn, params, batch)
        if pcfg.grad_compression:
            qs, scales, new_err = opt.compress_gradients(grads,
                                                         opt_state.err)
            grads = opt.decompress_gradients(qs, scales)
            opt_state = opt_state._replace(err=new_err)
        new_params, new_state, metrics = opt.apply_updates(
            params, grads, opt_state, tcfg, donate=donate)
        metrics["loss"] = loss
        return new_params, new_state, metrics

    return TrainProgram(cfg=cfg, plan=plan, device=dev, init_fn=init_fn,
                        step_fn=step_fn, loss_fn=loss_fn)
