"""The training step: the reference's
``repro/runtime/train_loop.py::build_train_program`` on one device, or
as one rank's part of it on a ``(data, model)`` mesh of ranks.

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

On one device the ``ParallelConfig`` fields that move data between
devices have no effect, as in the reference's tp = 1 plan:
``reduction``, ``zero_axes``, ``seq_sharded_cache``, ``zero3`` and
``dp_only`` (and the serving fields).

On a mesh (``launch/mesh.py``) each rank runs the reference's
per-device program (:func:`make_plan`; Domino's ring matmuls or the
all-reduce baseline by ``pcfg.reduction``) and the collectives'
transposes give its gradients.  The rules, which the CPU tests hold
against the reference at tp = 1:

* every rank seeds its loss with ``1 / ranks``: the reference's
  ``shard_map`` (``check=False``) differentiates the mean over its
  devices of their losses, which is the loss itself where every rank
  holds it, and the mean of the per-rank aux losses where they differ;
* a leaf's gradient is summed over the mesh axes its spec
  (``partition.derive_specs``) does not split, data first, then model:
  over an axis that its ZeRO spec (``optim.zero_spec_for`` over
  ``pcfg.zero_axes``) splits, by a reduce-scatter onto the rank's slice,
  else by a psum; in float32;
* microbatches accumulate the float32 slices; then compression (the
  global leaf's amax), ``apply_updates`` on the slices (the global norm
  over the mesh), and the new slices are all-gathered back into each
  rank's shard;
* ``pcfg.zero3``: a QUANTIZABLE leaf of at least ``zero3_min_size``
  elements is split over the data axes too (:func:`_zero3_plan`) and
  all-gathered at each use (``models/common.py::Zero3``), its gradient
  reduce-scattered in the gather's backward; ``pcfg.dp_only``: every
  axis is a data axis and tp = 1.

Each rank's params are its shard of the global draws of a tp = 1
program with the same seed (``init_fn``), so a mesh trains the model a
tp = 1 program trains.
"""
from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig, TrainConfig
from repro_torch.core import dataflow
from repro_torch.core.cim import divide
from repro_torch.device import resolve_device
from repro_torch.models import encdec as ED
from repro_torch.models import transformer as T
from repro_torch.models.common import ShardingPlan, Zero3
from repro_torch.optim import optimizer as opt
from repro_torch.runtime import partition
from repro_torch.runtime.partition import Spec
from repro_torch.tree import leaves, leaves_with_paths, tree_map, unflatten


@dataclass
class TrainProgram:
    """What the launcher needs: the model, its plan and device, and the
    functions.  On a mesh also the specs (the global leaves' ``Spec``
    per param and per optimizer-state leaf), each param's ``Layout`` and
    the ZeRO-3 leaves (path -> (dim, dim in the consumed leaf));
    ``grad_fn(params, batch)`` -> (loss, the reduced float32 gradient
    slices) is the step before its update, and ``update_fn(params,
    opt_state, loss, grads)`` the rest of it (``step_fn`` is the two);
    ``init_state(params)`` is the zero optimizer state of this rank's
    slices."""

    cfg: ModelConfig
    plan: ShardingPlan
    device: torch.device
    init_fn: Callable           # (seed) -> (params, opt_state)
    step_fn: Callable           # (params, opt_state, batch) -> (..., metrics)
    loss_fn: Callable           # (params, batch) -> scalar loss
    mesh: Any = None
    param_specs: Any = None
    opt_specs: Any = None
    layouts: Any = None
    zero3: Optional[Dict[str, Any]] = None
    grad_fn: Optional[Callable] = None
    update_fn: Optional[Callable] = None
    init_state: Optional[Callable] = None
    microbatches: int = 1

    def shard_batch(self, batch: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """This rank's rows of a global batch (all of them where the
        batch does not divide the data axes).  With microbatches, rank
        d's rows of each microbatch in turn, so that microbatch i of the
        step is the reference's microbatch i on this rank."""
        if self.mesh is None:
            return batch
        dp = _dp_size(self.mesh, self.plan)
        n = self.microbatches
        out = {}
        for k, v in batch.items():
            if v.shape[0] % (dp * n):
                out[k] = v
                continue
            idx = self.mesh.coords_dict()
            spec = partition.batch_specs({k: v}, self.plan.dp_axes, dp)[k]
            micro = v.reshape(n, v.shape[0] // n, *v.shape[1:])
            parts = [partition.shard_leaf(micro[i], spec, idx)
                     for i in range(n)]
            out[k] = torch.cat(parts) if n > 1 else parts[0]
        return out


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


def make_plan(cfg: ModelConfig, mesh, pcfg: ParallelConfig
              ) -> ShardingPlan:
    """The reference's ``make_plan`` on a mesh of ranks: tp the model
    axis' size and ``("data",)`` the data axes, ``seq_cache`` from
    ``pcfg.seq_sharded_cache``; with ``dp_only`` every axis is a data
    axis, tp = 1 and ``seq_cache`` off.  ``zero3`` has no effect on the
    plan."""
    if pcfg.dp_only:
        plan = ShardingPlan.for_model(
            cfg, tp=1, dp_axes=tuple(mesh.axis_names),
            reduction=pcfg.reduction,
            dp_axis=mesh.both if mesh.size > 1 else None)
        return dataclasses.replace(plan, seq_cache=False)
    plan = ShardingPlan.for_model(
        cfg, tp=mesh.model.size, dp_axes=("data",), reduction=pcfg.reduction,
        axis=mesh.model, dp_axis=mesh.data if mesh.data.size > 1 else None)
    return dataclasses.replace(plan, seq_cache=pcfg.seq_sharded_cache)


def _dp_size(mesh, plan: ShardingPlan) -> int:
    sizes = {"data": mesh.data.size, "model": mesh.model.size}
    n = 1
    for a in plan.dp_axes:
        n *= sizes[a]
    return n


def _path_keys(path: str):
    """A leaf path (``['segments']/[0]/[1]/['attn']/['wq']``) as its keys
    (``segments``, 0, 1, ``attn``, ``wq``)."""
    out = []
    for part in path.split("/"):
        inner = part[1:-1]
        out.append(int(inner) if inner.isdigit() else inner.strip("'\""))
    return out


def _zero3_plan(cfg: ModelConfig, g_shapes, param_specs, dp_size: int,
                min_size: int = 1 << 22) -> Dict[str, Any]:
    """path -> (the gather dim in the global leaf, in the consumed leaf)
    for the ZeRO-3 leaves: the reference's ``_zero3_plan``.  A
    QUANTIZABLE leaf of at least ``min_size`` elements is split over the
    data axes on its largest dim that its spec leaves whole and
    ``dp_size`` divides.  A leaf stacked over a segment's repeats is
    consumed a repeat at a time, so its dim counts from the second.  The
    encoder-decoder's stacks are consumed a layer at a time too; the
    reference counts their dim as in the global leaf, which its layer
    scan then gathers one dim too far (ROADMAP R6), and here it counts
    from the second as for a segment."""
    from repro_torch.runtime.serve_loop import QUANTIZABLE

    seg_counts = {}
    if not cfg.is_encdec:
        seg_counts = {i: seg.count
                      for i, seg in enumerate(T.build_segments(cfg))}
    out = {}
    for (name, leaf), spec in zip(leaves_with_paths(g_shapes),
                                  leaves(param_specs)):
        keys = _path_keys(name)
        last = re.sub(r"[^\w]", "", str(keys[-1]))
        if last not in QUANTIZABLE or leaf.numel() < min_size:
            continue
        stacked = (keys[0] == "segments" and len(keys) >= 2
                   and seg_counts.get(keys[1], 1) > 1)
        layered = cfg.is_encdec and keys[0] in ("encoder", "decoder")
        start = 1 if stacked or layered else 0
        used = list(spec) + [None] * (leaf.dim() - len(spec))
        cands = [d for d in range(start, leaf.dim())
                 if used[d] is None and leaf.shape[d] % dp_size == 0]
        if not cands:
            continue
        dim = max(cands, key=lambda d: leaf.shape[d])
        out[name] = (dim, dim - 1 if stacked or layered else dim)
    return out


def build_train_program(cfg: ModelConfig, pcfg: ParallelConfig,
                        tcfg: TrainConfig, device=None,
                        donate: bool = False, mesh=None) -> TrainProgram:
    """The train program of ``cfg`` on ``device`` (``None`` = the card);
    ``donate``: each step updates the params and optimizer state it is
    given in place.  With ``mesh`` (``launch/mesh.py``) of more than one
    rank, this rank's part of the sharded program (module docstring):
    its params, optimizer state and batch are its shards
    (``init_fn``, ``shard_batch``)."""
    dev = resolve_device(device)
    if mesh is not None and mesh.size > 1:
        return _build_on_mesh(cfg, pcfg, tcfg, dev, donate, mesh)
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


def train_specs(cfg: ModelConfig, plan: ShardingPlan, pcfg: ParallelConfig,
                tcfg: TrainConfig, axis_sizes: Dict[str, int]):
    """(param specs, optimizer-state specs, layouts, ZeRO-3 plan, the
    global params' meta tree) of ``cfg`` under ``plan`` on a mesh of
    ``axis_sizes``: the reference's specs (``derive_specs`` of the
    global and local meta trees in the training layout, ZeRO-3's data
    split patched in, ``zero_spec_for`` over ``pcfg.zero_axes``).  No
    collective runs."""
    init = init_for(cfg)
    g_meta = init(cfg, plan.as_global(), partition.META)
    l_meta = init(cfg, plan, partition.META)
    specs = partition.derive_specs(g_meta, l_meta, plan.tp, plan.tp_axis)
    z3 = {}
    dp = 1
    for a in plan.dp_axes:
        dp *= axis_sizes[a]
    if pcfg.zero3 and plan.dp_axes and dp > 1:
        z3 = _zero3_plan(cfg, g_meta, specs, dp, pcfg.zero3_min_size)
        entry = plan.dp_axes if len(plan.dp_axes) > 1 else plan.dp_axes[0]
        flat = []
        for (name, leaf), spec in zip(leaves_with_paths(g_meta),
                                      leaves(specs)):
            dims = list(spec.dims) + [None] * (leaf.dim() - len(spec))
            if name in z3:
                dims[z3[name][0]] = entry
            flat.append(Spec(tuple(dims)))
        specs = unflatten(specs, flat)
    layouts = tree_map(lambda g, s: opt.Layout(
        tuple(g.shape), s, opt.zero_spec_for(s, tuple(g.shape),
                                             pcfg.zero_axes, axis_sizes)),
        g_meta, specs)
    zs = tree_map(lambda lay: lay.zspec, layouts)
    o_meta = opt.init_opt_state(g_meta, tcfg, pcfg.grad_compression)

    def free(t):
        return opt.zero_spec_for(None, tuple(t.shape), pcfg.zero_axes,
                                 axis_sizes)

    opt_specs = opt.OptState(
        step=Spec(()),
        m=zs if o_meta.m != () else (),
        v=(() if o_meta.v == () else zs if tcfg.optimizer == "adamw"
           else tree_map(free, o_meta.v)),
        err=zs if o_meta.err != () else ())
    return specs, opt_specs, layouts, z3, g_meta


def _build_on_mesh(cfg, pcfg, tcfg, dev, donate, mesh) -> TrainProgram:
    plan = make_plan(cfg, mesh, pcfg)
    loss_model = loss_for(cfg)
    coords = mesh.coords_dict()
    axis_sizes = {"data": mesh.data.size, "model": mesh.model.size}
    param_specs, opt_specs, layouts, z3, _ = train_specs(
        cfg, plan, pcfg, tcfg, axis_sizes)
    z3_axis = mesh.axis(plan.dp_axes) if z3 else None
    paths = [p for p, _ in leaves_with_paths(param_specs)]
    seed_value = 1.0 / mesh.size

    def init_fn(seed: int):
        """This rank's shard of the global draws of a tp = 1 program
        seeded with ``seed`` (each layer cut as it is drawn), and its
        slices of the zero optimizer state."""
        model = ED if cfg.is_encdec else T
        gen = torch.Generator(device=dev).manual_seed(seed)
        g_serve = model.init_params(cfg, plan.as_global(), partition.META)
        l_serve = model.init_params(cfg, plan, partition.META)
        serve_specs = partition.derive_specs(g_serve, l_serve, plan.tp,
                                             plan.tp_axis)

        def keep(path, tree):
            spec = serve_specs
            for key in path:
                spec = spec[key]
            return partition.shard_tree(tree, spec, coords)

        drawn = model.init_params(cfg, plan.as_global(), gen, shard_fn=keep)
        params = (ED.stack_layers(drawn) if cfg.is_encdec
                  else T.stack_layers(drawn, cfg))
        del drawn
        # ZeRO-3 leaves: the data split on top of the model shard
        params = tree_map(lambda p, lay: partition.narrow_to(
            p, _model_only(lay.pspec), lay.pspec, coords).clone()
            if partition.added_dim(_model_only(lay.pspec), lay.pspec)
            is not None else p, params, layouts)
        return params, init_state(params)

    def init_state(params):
        return _init_state(params, tcfg, pcfg, layouts, opt_specs, coords)

    def wrap(params):
        """(the params the loss reads, the leaves to differentiate):
        each ZeRO-3 leaf a ``Zero3`` whose gradient goes to its sink."""
        flat, inputs = [], []
        for path, p in zip(paths, leaves(params)):
            if path in z3:
                sink = torch.zeros((), dtype=torch.float32,
                                   device=p.device).expand(p.shape)
                sink.requires_grad_()
                flat.append(Zero3(p.detach(), z3[path][1], z3_axis, sink))
                inputs.append(sink)
            else:
                leaf = p.detach().requires_grad_()
                flat.append(leaf)
                inputs.append(leaf)
        return unflatten(params, flat), inputs

    def loss_fn(params, batch):
        wrapped, _ = wrap(params)
        return loss_model(wrapped, batch, cfg, plan, remat=pcfg.remat)

    def reduce(g: torch.Tensor, lay: opt.Layout) -> torch.Tensor:
        """A leaf's gradient summed over the axes its spec does not
        split, data first: reduce-scattered onto the ZeRO slice over the
        axes its ZeRO spec adds, psummed over the others; float32."""
        g = g.float()
        zd = partition.added_dim(lay.pspec, lay.zspec)
        zaxes = partition.entry_axes(lay.zspec.dims[zd]) if zd is not None \
            else ()
        for name in partition.replicated_axes(lay.pspec):
            axis = mesh.axis(name)
            if name in zaxes:
                g = dataflow.psum_scatter(g, axis, zd)
            else:
                g = dataflow.psum(g, axis)
        return g

    def grads_of(params, batch):
        wrapped, inputs = wrap(params)
        loss = loss_model(wrapped, batch, cfg, plan, remat=pcfg.remat)
        got = torch.autograd.grad(loss, inputs,
                                  grad_outputs=torch.full_like(loss,
                                                               seed_value),
                                  allow_unused=True)
        out = []
        for g, x, lay in zip(got, inputs, leaves(layouts)):
            if g is None:
                g = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
            out.append(reduce(g, lay))
        return loss.detach(), unflatten(params, out)

    def grad_fn(params, batch):
        n = pcfg.microbatches
        if n == 1:
            return grads_of(params, batch)
        micro = [{k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
                  for k, v in batch.items()} for i in range(n)]
        gsum, losses = None, []
        for mb in micro:
            loss, g = grads_of(params, mb)
            gsum = g if gsum is None else tree_map(torch.add, gsum, g)
            losses.append(loss)
        return (torch.mean(torch.stack(losses)),
                tree_map(lambda g: divide(g, float(n)), gsum))

    def step_fn(params, opt_state: opt.OptState, batch: Dict[str, Any]):
        return update_fn(params, opt_state, *grad_fn(params, batch))

    def update_fn(params, opt_state: opt.OptState, loss, grads):
        if pcfg.grad_compression:
            qs, scales, new_err = opt.compress_gradients(
                grads, opt_state.err, axis=mesh.both)
            grads = opt.decompress_gradients(qs, scales)
            opt_state = opt_state._replace(err=new_err)
        slices = tree_map(lambda p, lay: partition.narrow_to(
            p, lay.pspec, lay.zspec, coords), params, layouts)
        new_slices, new_state, metrics = opt.apply_updates(
            slices, grads, opt_state, tcfg, donate=donate, mesh=mesh,
            layouts=layouts, state_specs=opt_specs.v)

        def back(p, s, lay):
            full = partition.gather_leaf(s, lay.zspec, mesh, base=lay.pspec)
            if donate:
                with torch.no_grad():
                    p.copy_(full)
                return p
            return full

        new_params = tree_map(back, params, new_slices, layouts)
        metrics["loss"] = loss
        return new_params, new_state, metrics

    return TrainProgram(cfg=cfg, plan=plan, device=dev, init_fn=init_fn,
                        step_fn=step_fn, loss_fn=loss_fn, mesh=mesh,
                        param_specs=param_specs, opt_specs=opt_specs,
                        layouts=layouts, zero3=z3, grad_fn=grad_fn,
                        update_fn=update_fn, init_state=init_state,
                        microbatches=pcfg.microbatches)


def _model_only(spec: Spec) -> Spec:
    """``spec`` with every entry but the model axis' dropped: the split
    a param has before ZeRO-3 adds the data axes."""
    return Spec(tuple(e if e == "model" else None for e in spec))


def _init_state(params, tcfg: TrainConfig, pcfg: ParallelConfig, layouts,
                opt_specs, coords) -> opt.OptState:
    """Zero optimizer state of this rank's slices: moments and the
    compression residual at each param's ZeRO slice, Adafactor's
    factored states at their own specs' slices of the global shapes."""
    mdt = getattr(torch, tcfg.moment_dtype)
    dev = leaves(params)[0].device

    def zslice(p, lay):
        shape = [s // _parts(e, coords) for s, e in zip(lay.shape,
                                                         lay.zspec)]
        return torch.zeros(shape, dtype=mdt, device=dev)

    def factored(lay, specs):
        full = opt._adafactor_init(torch.empty(lay.shape, device="meta"))
        return {k: torch.zeros(
            [s // _parts(e, coords) for s, e in zip(v.shape, specs[k])],
            dtype=torch.float32, device=dev) for k, v in full.items()}

    if tcfg.optimizer == "adamw":
        m, v = (tree_map(zslice, params, layouts),
                tree_map(zslice, params, layouts))
    elif tcfg.optimizer == "adafactor":
        m = ()
        v = tree_map(lambda p, lay, sp: factored(lay, sp), params, layouts,
                     opt_specs.v)
    elif tcfg.optimizer == "sgd":
        m, v = tree_map(zslice, params, layouts), ()
    else:
        raise ValueError(tcfg.optimizer)
    err = tree_map(zslice, params, layouts) if pcfg.grad_compression else ()
    return opt.OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                        m=m, v=v, err=err)


def _parts(entry, coords) -> int:
    n = 1
    for a in partition.entry_axes(entry):
        n *= coords[a][1]
    return n
