"""Optimizers from scratch, the reference's ``repro/optim/optimizer.py``
on torch, on one device or on a mesh's ZeRO slices:

* **AdamW** — float32 or bfloat16 moments (``moment_dtype``), decoupled
  decay on leaves of two or more dimensions;
* **Adafactor** — factored second moment (rows and columns of each
  leaf of two or more dimensions), no momentum, relative update clip;
* **SGD** with momentum 0.9;

the warmup-cosine ``lr_schedule``, the global-norm clip and int8
gradient compression with error feedback.

The arithmetic is the reference's, op for op, in float32, leaf by leaf
over the reference's leaves (the stacked segments of
``models/transformer.py``'s training layout: a norm scale stacked as
(count, D) has two dimensions, so it is decayed and factored, as there).
Every division by a Python number goes through ``core/cim.py::divide``:
the card turns a division by a Python number into a multiply by its
reciprocal.  Updates are functional: new tensors, the old ones left as
they are; or, with ``donate=True`` (the reference's jitted step donates
its params and optimizer state), written into the old tensors leaf by
leaf and, for the elementwise optimizers, ``DONATE_CHUNK`` elements at a
time along each leaf's first axis, so that a step holds one copy of the
params and moments (the same arithmetic, the same bits).

On a mesh (``mesh=`` and ``layouts=``, one :class:`Layout` per param
leaf) each rank updates its ZeRO slice: the gradient, the moments and
the compression residual of a leaf are its slice under
:func:`zero_spec_for` of the param's spec (the reference's ZeRO-1
specs), and the param's slice is a view of the rank's shard.  What the
reference computes over a whole leaf is computed over the whole leaf
here too: the global norm sums every slice once (a replicated slice on
one of its replicas) over the mesh, Adafactor's row and column means
and its update RMS are global sums, and compression's amax is a
``pmax`` over the mesh.  Adafactor's factored states keep the
reference's specs (:func:`zero_spec_for` of no param spec); their
update runs on the global vectors, of which each rank keeps its slice.
The caller all-gathers the new param slices back into the shards
(``runtime/train_loop.py``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core.cim import divide
from repro_torch.runtime.partition import (
    Spec,
    global_sum,
    owns,
    slice_starts,
)
from repro_torch.tree import leaves, tree_map, unflatten


#: elements of a leaf updated at once by a donated AdamW or SGD step
DONATE_CHUNK = 1 << 25


class OptState(NamedTuple):
    step: torch.Tensor  # int32, 0-d
    m: Any          # first moment (AdamW / SGD momentum; () for adafactor)
    v: Any          # second moment (AdamW) / factored pair (adafactor)
    err: Any        # error-feedback residual of gradient compression (())


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------


def lr_schedule(cfg: TrainConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """step (int tensor) -> float32 learning rate: linear warmup over
    ``warmup_steps``, then a cosine from 1 to 0.1 of ``lr`` by
    ``total_steps``."""
    def fn(step: torch.Tensor) -> torch.Tensor:
        warm = torch.clamp_max(
            divide(step.float(), float(max(cfg.warmup_steps, 1))), 1.0)
        prog = torch.clamp(
            divide((step - cfg.warmup_steps).float(),
                   float(max(cfg.total_steps - cfg.warmup_steps, 1))),
            0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * prog))
        return cfg.lr * warm * (0.1 + 0.9 * cos)
    return fn


# ---------------------------------------------------------------------------
# Init / update
# ---------------------------------------------------------------------------


def init_opt_state(params, cfg: TrainConfig,
                   compression: bool = False) -> OptState:
    """Zero state for ``params`` on their device: moments in
    ``cfg.moment_dtype``, adafactor's row and column sums in float32,
    and the compression residual when ``compression``."""
    mdt = getattr(torch, cfg.moment_dtype)

    def zeros(p):
        return torch.zeros_like(p, dtype=mdt)

    if cfg.optimizer == "adamw":
        m, v = tree_map(zeros, params), tree_map(zeros, params)
    elif cfg.optimizer == "adafactor":
        m, v = (), tree_map(_adafactor_init, params)
    elif cfg.optimizer == "sgd":
        m, v = tree_map(zeros, params), ()
    else:
        raise ValueError(cfg.optimizer)
    err = tree_map(zeros, params) if compression else ()
    dev = leaves(params)[0].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    m=m, v=v, err=err)


def _adafactor_init(p: torch.Tensor):
    f32 = dict(dtype=torch.float32, device=p.device)
    if p.dim() >= 2:
        return {"row": torch.zeros(p.shape[:-1], **f32),
                "col": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
    return {"full": torch.zeros(p.shape, **f32)}


def _clip_scale(grads, max_norm: float, mesh=None, layouts=None):
    """(min(1, max_norm / |g|), |g|): the norm over every leaf in float32,
    summed leaf after leaf in the reference's order.  On a mesh each
    rank sums its slices (a replicated slice on one replica,
    ``partition.owns``) and the sum is psummed over the mesh."""
    gl = leaves(grads)
    gsq = torch.zeros((), dtype=torch.float32, device=gl[0].device)
    if mesh is None:
        for g in gl:
            gsq = gsq + torch.sum(torch.square(g.float()))
    else:
        from repro_torch.core import dataflow

        coords = mesh.coords_dict()
        for g, lay in zip(gl, leaves(layouts)):
            if owns(lay.zspec, coords):
                gsq = gsq + torch.sum(torch.square(g.float()))
        gsq = dataflow.psum(gsq, mesh.both)
    gnorm = torch.sqrt(gsq)
    scale = torch.clamp_max(
        torch.full_like(gnorm, max_norm) / torch.clamp_min(gnorm, 1e-9), 1.0)
    return scale, gnorm


def _clipped(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (g.float() * scale).to(g.dtype)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / |g|), |g|): the norm over every
    leaf in float32, summed leaf after leaf in the reference's order."""
    scale, gnorm = _clip_scale(grads, max_norm)
    return tree_map(lambda g: _clipped(g, scale), grads), gnorm


def _donated(upd, params, grads, slots, scale, chunked: bool) -> None:
    """``upd(p, g, *slot entries)`` written in place into each param
    leaf and its entries of the ``slots`` trees (a tensor, or adafactor's
    ``{"row", "col"}`` / ``{"full"}``), each gradient clipped by
    ``scale`` as it is read; ``chunked``: in pieces of about
    ``DONATE_CHUNK`` elements along the leaf's first axis (elementwise
    updates only)."""
    per_leaf = []
    tree_map(lambda *xs: per_leaf.append(xs), params, grads, *slots)

    def part(x, i, n):
        if isinstance(x, dict):
            return {k: v[i:i + n] for k, v in x.items()}
        return x[i:i + n]

    with torch.no_grad():
        for p, g, *st in per_leaf:
            split = chunked and p.dim() > 0
            rows = p.shape[0] if split else 1
            n = max(1, DONATE_CHUNK // max(1, p.numel() // rows))
            for i in range(0, rows, n):
                targets = [part(x, i, n) if split else x for x in (p, *st)]
                out = upd(targets[0], _clipped(
                    part(g, i, n) if split else g, scale), *targets[1:])
                for dst, src in zip(targets, out):
                    for k in (dst if isinstance(dst, dict) else [None]):
                        (dst if k is None else dst[k]).copy_(
                            src if k is None else src[k])


def apply_updates(params, grads, state: OptState, cfg: TrainConfig,
                  donate: bool = False, mesh=None, layouts=None,
                  state_specs=None
                  ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One step of ``cfg.optimizer``: clip, then update each leaf.
    Returns (new params, new state, {"lr", "grad_norm", "step"}).  With
    ``donate`` the new values are written into ``params`` and
    ``state``'s moments, which are returned (the old values are gone).

    On a ``mesh``: ``params``, ``grads`` and the moments are this rank's
    slices under each leaf's ``layouts`` entry's ZeRO spec, and
    ``state_specs`` (Adafactor) the specs of its factored states; the
    new params returned are the new slices."""
    if donate or mesh is not None:
        scale, gnorm = _clip_scale(grads, cfg.grad_clip, mesh, layouts)
        if not donate:
            grads = tree_map(lambda g: _clipped(g, scale), grads)
    else:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state.step + 1
    lr = lr_schedule(cfg)(step)
    mdt = getattr(torch, cfg.moment_dtype)

    if cfg.optimizer == "adamw":
        bc1 = 1 - torch.pow(cfg.b1, step.float())
        bc2 = 1 - torch.pow(cfg.b2, step.float())

        def upd(p, g, m, v):
            g32 = g.float()
            m_new = cfg.b1 * m.float() + (1 - cfg.b1) * g32
            v_new = cfg.b2 * v.float() + (1 - cfg.b2) * (g32 * g32)
            mhat = m_new / bc1
            vhat = v_new / bc2
            delta = mhat / (torch.sqrt(vhat) + 1e-8)
            if p.dim() >= 2:  # decoupled decay on matrices only
                delta = delta + cfg.weight_decay * p.float()
            p_new = p.float() - lr * delta
            return p_new.to(p.dtype), m_new.to(mdt), v_new.to(mdt)

        slots, elementwise = (state.m, state.v), True

        def new_state(m, v):
            return OptState(step, m, v, state.err)

    elif cfg.optimizer == "adafactor":
        decay = 1.0 - torch.pow(step.float(), -0.8)

        def upd(p, g, vf):
            g32 = g.float()
            sq = g32 * g32 + 1e-30
            if p.dim() >= 2:
                row = decay * vf["row"] + (1 - decay) * torch.mean(sq, -1)
                col = decay * vf["col"] + (1 - decay) * torch.mean(sq, -2)
                vhat = (row[..., None] * col[..., None, :]
                        / torch.clamp_min(torch.mean(
                            row, -1, keepdim=True)[..., None], 1e-30))
                new_vf = {"row": row, "col": col}
            else:
                full = decay * vf["full"] + (1 - decay) * sq
                vhat = full
                new_vf = {"full": full}
            delta = g32 / torch.clamp_min(torch.sqrt(vhat), 1e-30)
            # relative update clipping (Adafactor d = 1.0)
            rms = torch.sqrt(torch.mean(delta * delta) + 1e-30)
            delta = delta / torch.clamp_min(rms, 1.0)
            if p.dim() >= 2:
                delta = delta + cfg.weight_decay * p.float()
            p_new = p.float() - lr * delta
            return p_new.to(p.dtype), new_vf

        if mesh is not None:
            upd = _sharded_adafactor(decay, lr, cfg, params, layouts,
                                     state_specs, mesh)

        # tree_map hands upd each param leaf's {"row", "col"} / {"full"}
        slots, elementwise = (state.v,), False

        def new_state(v):
            return OptState(step, (), v, state.err)

    elif cfg.optimizer == "sgd":
        def upd(p, g, m):
            m_new = 0.9 * m.float() + g.float()
            p_new = p.float() - lr * m_new
            return p_new.to(p.dtype), m_new.to(mdt)

        slots, elementwise = (state.m,), True

        def new_state(m):
            return OptState(step, m, (), state.err)
    else:
        raise ValueError(cfg.optimizer)

    if donate:
        _donated(upd, params, grads, slots, scale, elementwise)
        new_params, new_slots = params, slots
    else:
        out = tree_map(upd, params, grads, *slots)
        new_params = _select(params, out, 0)
        new_slots = [_select(params, out, i + 1) for i in range(len(slots))]
    return new_params, new_state(*new_slots), {"lr": lr, "grad_norm": gnorm,
                                               "step": step}


def _sharded_adafactor(decay, lr, cfg: TrainConfig, params, layouts,
                       state_specs, mesh):
    """Adafactor's update of one rank's slices: the row and column means
    of the squared gradient and the update's RMS summed over the whole
    leaf (``partition.global_sum``), the factored states updated as
    global vectors (each rank's slice gathered first) of which the rank
    keeps its slice."""
    from repro_torch.core import dataflow
    from repro_torch.runtime.partition import gather_leaf

    coords = mesh.coords_dict()
    lay = {id(p): (l, sp) for p, l, sp in zip(
        leaves(params), leaves(layouts), _per_param(params, state_specs))}

    def upd(p, g, vf):
        layout, specs = lay[id(p)]
        shape, zdims = layout.shape, layout.zspec.dims
        at = slice_starts(layout.zspec, shape, coords)
        g32 = g.float()
        sq = g32 * g32 + 1e-30
        if p.dim() >= 2:
            row_sum = global_sum(torch.sum(sq, -1), Spec(zdims[:-1]),
                                 shape[:-1], mesh, layout.zspec)
            col_sum = global_sum(torch.sum(sq, -2),
                                 Spec(zdims[:-2] + zdims[-1:]),
                                 shape[:-2] + shape[-1:], mesh, layout.zspec)
            row = (decay * gather_leaf(vf["row"], specs["row"], mesh)
                   + (1 - decay) * divide(row_sum, float(shape[-1])))
            col = (decay * gather_leaf(vf["col"], specs["col"], mesh)
                   + (1 - decay) * divide(col_sum, float(shape[-2])))
            den = torch.clamp_min(torch.mean(row, -1, keepdim=True)[
                ..., None], 1e-30)
            vhat = (row[at[:-1]][..., None] * col[at[:-2] + at[-1:]][
                ..., None, :] / den[at[:-2]])
            new_vf = {"row": row, "col": col}
        else:
            full = (decay * gather_leaf(vf["full"], specs["full"], mesh)
                    + (1 - decay) * global_sum(sq, layout.zspec, shape,
                                               mesh))
            vhat = full[at]
            new_vf = {"full": full}
        new_vf = {k: v[slice_starts(specs[k], tuple(v.shape), coords)]
                  for k, v in new_vf.items()}
        delta = g32 / torch.clamp_min(torch.sqrt(vhat), 1e-30)
        dsq = torch.sum(delta * delta)
        if not owns(layout.zspec, coords):
            dsq = torch.zeros_like(dsq)
        n = float(math.prod(shape))
        rms = torch.sqrt(divide(dataflow.psum(dsq, mesh.both), n) + 1e-30)
        delta = delta / torch.clamp_min(rms, 1.0)
        if p.dim() >= 2:
            delta = delta + cfg.weight_decay * p.float()
        p_new = p.float() - lr * delta
        return p_new.to(p.dtype), new_vf

    return upd


def _per_param(params, specs):
    """``specs`` (a tree in the params' structure with a dict per param
    leaf) as a list in the params' leaf order."""
    by_id = {}
    tree_map(lambda p, sp: by_id.__setitem__(id(p), sp), params, specs)
    return [by_id[id(p)] for p in leaves(params)]


def _select(params, out, i):
    """From a tree of tuples in ``params``' structure (one per param
    leaf), the tree of each tuple's ``i``-th entry."""
    if isinstance(params, dict):
        return {k: _select(params[k], out[k], i) for k in params}
    if isinstance(params, (list, tuple)):
        return type(params)(_select(a, b, i) for a, b in zip(params, out))
    return out[i]


# ---------------------------------------------------------------------------
# ZeRO sharding specs
# ---------------------------------------------------------------------------


def zero_spec_for(p_spec: Optional[Spec], shape: Tuple[int, ...],
                  zero_axes: Tuple[str, ...], axis_sizes: Dict[str, int]
                  ) -> Spec:
    """The reference's ``zero_spec_for``: an optimizer-state leaf split
    over ``zero_axes`` on its largest dim that the param's spec leaves
    whole (ZeRO-1), the axes the param already splits over dropped; the
    param's own spec where no dim is free or the free dim does not
    divide the axes' product.  ``axis_sizes``: axis name -> size (the
    reference reads them from module state set by ``set_axis_sizes``;
    an axis missing here counts 1, as there)."""
    base = list(p_spec) if p_spec is not None else [None] * len(shape)
    while len(base) < len(shape):
        base.append(None)
    used = set()
    for entry in base:
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            used.add(a)
    avail = tuple(a for a in zero_axes if a not in used)
    if not avail or not shape:
        return Spec(tuple(base))
    free = [i for i, e in enumerate(base) if e is None and shape[i] > 1]
    if not free:
        return Spec(tuple(base))
    target = max(free, key=lambda i: shape[i])
    n = 1
    for a in avail:
        n *= axis_sizes.get(a, 1)
    if shape[target] % n:
        return Spec(tuple(base))
    base[target] = avail if len(avail) > 1 else avail[0]
    return Spec(tuple(base))


@dataclass(frozen=True)
class Layout:
    """One param leaf on a mesh: the global leaf's shape, the param's
    spec (tensor parallelism, ZeRO-3) and its gradient's and moments'
    ZeRO spec (:func:`zero_spec_for`)."""

    shape: Tuple[int, ...]
    pspec: Spec
    zspec: Spec


# ---------------------------------------------------------------------------
# int8 gradient compression with error feedback
# ---------------------------------------------------------------------------


def compress_gradients(grads, err, axis=None):
    """(int8 grads, float32 scales, new residual): ``q = Q(g + err)``
    with a per-leaf scale amax / 127, and ``err' = (g + err) - deQ(q)``,
    so the compression error re-enters the next step.  With ``axis``
    (a mesh axis over every rank) ``grads`` and ``err`` are each rank's
    slices of the global leaves, and each leaf's amax is the global
    one: every leaf's slice amax in one ``pmax`` over ``axis``."""
    from repro_torch.core import dataflow

    flat = [g.float() + e.float()
            for g, e in zip(leaves(grads), leaves(err))]
    amaxes = torch.stack([torch.amax(torch.abs(g)) for g in flat])
    if axis is not None:
        amaxes = dataflow.pmax(amaxes, axis)
    qs, scales, errs = [], [], []
    for g32, e, amax in zip(flat, leaves(err), amaxes):
        scale = divide(torch.clamp_min(amax, 1e-12), 127.0)
        q = torch.clamp(torch.round(g32 / scale), -128, 127).to(torch.int8)
        qs.append(q)
        scales.append(scale)
        errs.append((g32 - q.float() * scale).to(e.dtype))
    return (unflatten(grads, qs), unflatten(grads, scales),
            unflatten(grads, errs))


def decompress_gradients(qs, scales, dtype=torch.float32):
    return tree_map(lambda q, s: (q.float() * s).to(dtype), qs, scales)
