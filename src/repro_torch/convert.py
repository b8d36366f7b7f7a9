"""Carrying weights, caches and calibration across from the JAX
reference.

The reference keeps CNN params as numpy / jax arrays (name -> HWIO conv
kernel or (C_in, C_out) FC matrix, or a ``{"q", "s"}`` quantized leaf);
the port keeps the same layout as tensors on a device.  LM params and
caches are segment-stacked in the reference and a per-layer list in the
port (``models/transformer.py``); an encoder-decoder's stacks and caches
likewise (``models/encdec.py``).  Training keeps the reference's stacked
layout, and the optimizer state crosses as it is.  At tp > 1 a rank
takes its shard of those global params or caches
(:func:`shard_lm_params`, :func:`shard_lm_caches`).  Nothing here
imports the reference: it reads plain arrays and duck-typed engines.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.device import resolve_device


def params_from_reference(params: Dict[str, Any], device=None
                          ) -> Dict[str, Any]:
    """The reference's CNN params (arrays, or ``{"q", "s"}`` leaves) as
    the port's tensors on ``device`` (``None`` = the card), same layout
    and dtypes."""
    dev = resolve_device(device)

    def one(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a)).to(dev)

    return {name: ({"q": one(leaf["q"]), "s": one(leaf["s"])}
                   if isinstance(leaf, dict) else one(leaf))
            for name, leaf in params.items()}


def _tensors(tree, dev: torch.device, index=None):
    """Nested dicts / lists of arrays as tensors on ``dev``, each array
    taken at ``[index]`` when given (one layer of a stacked segment)."""
    if isinstance(tree, dict):
        return {k: _tensors(v, dev, index) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tensors(v, dev, index) for v in tree]
    a = np.array(tree if index is None else tree[index])
    if a.dtype.name == "bfloat16":  # ml_dtypes: torch reads the bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(a).to(dev)


def _unstack(segment_trees, cfg, dev: torch.device) -> List[Any]:
    """The reference's per-segment lists (leaves stacked over the
    segment's repeat count when it exceeds 1) as one entry per layer,
    in layer order."""
    from repro_torch.models.transformer import build_segments

    layers = []
    for seg, trees in zip(build_segments(cfg), segment_trees):
        for r in range(seg.count):
            for tree in trees:
                layers.append(_tensors(tree, dev,
                                       r if seg.count > 1 else None))
    if len(layers) != cfg.num_layers:
        raise ValueError(f"{len(layers)} layers for {cfg.num_layers}")
    return layers


def lm_params_from_reference(params_np: Dict[str, Any], cfg, device=None
                             ) -> Dict[str, Any]:
    """The reference's LM params for ``cfg`` at tp = 1 (numpy leaves,
    ``{"q", "s"}`` leaves included) in the port's layout on ``device``
    (``None`` = the card): ``"segments"`` becomes ``"layers"``, one dict
    per layer, same dtypes."""
    dev = resolve_device(device)
    out = {k: _tensors(v, dev) for k, v in params_np.items()
           if k != "segments"}
    out["layers"] = _unstack(params_np["segments"], cfg, dev)
    return out


def lm_train_params_from_reference(params_np: Dict[str, Any], cfg,
                                   device=None) -> Dict[str, Any]:
    """The reference's LM params as tensors on ``device`` in the
    reference's own layout, the training layout of
    ``models/transformer.py``: ``"segments"`` kept, each leaf of a
    repeated segment stacked over its count, same dtypes; deepseek-v3's
    multi-token-prediction block ``"mtp"`` (one layer and ``proj``, not
    stacked) carried as it is.  The optimizer then sees the reference's
    leaves (it decays, factors, clips and compresses per leaf)."""
    from repro_torch.models.transformer import build_segments

    out = _tensors(params_np, resolve_device(device))
    n = len(build_segments(cfg))
    if len(out["segments"]) != n:
        raise ValueError(f"{len(out['segments'])} segments for {n}")
    return out


def opt_state_from_reference(state, device=None):
    """The reference's ``OptState`` (step, m, v, err; ``()`` where an
    optimizer keeps none) as the port's, tensors on ``device``."""
    from repro_torch.optim.optimizer import OptState

    dev = resolve_device(device)
    return OptState(*(() if isinstance(t, tuple) and not t
                      else _tensors(t, dev) for t in state))


def to_reference(tree):
    """A tree of tensors (params, an ``OptState``) as numpy arrays, same
    structure; bfloat16 leaves as ``ml_dtypes.bfloat16`` arrays, which
    jax reads as bfloat16 (the inverse of :func:`_tensors`)."""
    from repro_torch.tree import tree_map

    def one(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            import ml_dtypes

            return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()

    return tree_map(one, tree)



def lm_caches_from_reference(caches_np, cfg, device=None) -> List[Any]:
    """The reference's LM caches (per segment, per cycle position,
    stacked over the repeat count) as the port's per-layer list."""
    return _unstack(caches_np, cfg, resolve_device(device))


def _layers(stacked, n: int, dev: torch.device) -> List[Any]:
    """A tree whose leaves are stacked over ``n`` layers as ``n`` trees,
    one per layer."""
    return [_tensors(stacked, dev, i) for i in range(n)]


def encdec_params_from_reference(params_np: Dict[str, Any], cfg,
                                 device=None) -> Dict[str, Any]:
    """The reference's encoder-decoder params (``models/encdec.py``,
    numpy or ``{"q", "s"}`` leaves) in the port's layout on ``device``:
    the stacked ``"encoder"`` and ``"decoder"`` become lists with one
    dict per layer, same dtypes."""
    dev = resolve_device(device)
    out = {k: _tensors(v, dev) for k, v in params_np.items()
           if k not in ("encoder", "decoder")}
    out["encoder"] = _layers(params_np["encoder"], cfg.encoder_layers, dev)
    out["decoder"] = _layers(params_np["decoder"], cfg.num_layers, dev)
    return out


def encdec_train_params_from_reference(params_np: Dict[str, Any], cfg,
                                       device=None) -> Dict[str, Any]:
    """The reference's encoder-decoder params as tensors on ``device`` in
    the reference's own layout, the training layout of
    ``models/encdec.py``: ``"encoder"`` and ``"decoder"`` each one dict
    whose leaves are stacked over the layers, same dtypes."""
    from repro_torch.tree import leaves

    out = _tensors(params_np, resolve_device(device))
    for name, n in (("encoder", cfg.encoder_layers),
                    ("decoder", cfg.num_layers)):
        got = leaves(out[name])[0].shape[0]
        if got != n:
            raise ValueError(f"{name} stacked over {got} layers for {n}")
    return out


def encdec_caches_from_reference(caches_np, cfg, device=None):
    """The reference's ``(self, cross)`` encoder-decoder caches, each
    stacked over the decoder layers, as the port's ``(self, cross)``
    per-layer lists."""
    dev = resolve_device(device)
    self_c, cross_c = caches_np
    return (_layers(self_c, cfg.num_layers, dev),
            _layers(cross_c, cfg.num_layers, dev))


def copy_calibration(ref_engine, engine):
    """Give ``engine`` (a port ``CIMEngine``) the per-layer calibration of
    ``ref_engine`` (a reference or port ``CIMEngine``): each layer's
    ``(a_scale, gain)`` through ``set_layer``.  Calibration runs a float
    forward whose convolutions differ between frameworks and devices by
    an ulp, and an ulp can move an ADC code; copying it makes the two
    engines convert identically."""
    for name, cal in ref_engine.calib.items():
        engine.set_layer(name, a_scale=cal.a_scale, gain=cal.gain)
    return engine


def shard_lm_params(global_params, specs, coords):
    """One rank's shard of the global params that
    :func:`lm_params_from_reference` or :func:`encdec_params_from_reference`
    give (padded experts included: the reference's params under
    ``ShardingPlan(tp=1, experts_pad=...)``).  ``specs``: a serve
    program's ``param_specs``; ``coords``: its mesh's ``coords_dict()``.
    The shard computes what the reference's shard_map device computes."""
    from repro_torch.runtime.partition import shard_tree

    return shard_tree(global_params, specs, coords)


def shard_lm_caches(global_caches, specs, coords):
    """One rank's shard of global caches (the port's layout, e.g. from
    :func:`lm_caches_from_reference`) by a serve program's
    ``cache_specs``."""
    from repro_torch.runtime.partition import shard_tree

    return shard_tree(global_caches, specs, coords)


def shard_train_state(prog, params, opt_state):
    """This rank's training state on a train program's mesh from the
    global params and optimizer state (the reference's trees, e.g. from
    :func:`lm_train_params_from_reference` and
    :func:`opt_state_from_reference`): each param cut by its spec (a
    ZeRO-3 leaf over the data axes too), each moment, residual and
    Adafactor state to its ZeRO slice.  Off a mesh, as they are."""
    from repro_torch.runtime.partition import shard_tree

    if prog.mesh is None:
        return params, opt_state
    coords = prog.mesh.coords_dict()
    return (shard_tree(params, prog.param_specs, coords),
            shard_tree(opt_state, prog.opt_specs, coords))


def gather_train_state(prog, params, opt_state):
    """The global params and optimizer state from every rank's training
    state on a train program's mesh (all-gathers: every rank of the mesh
    calls it).  Off a mesh, as they are."""
    from repro_torch.runtime.partition import gather_leaf
    from repro_torch.tree import tree_map

    if prog.mesh is None:
        return params, opt_state
    gather = lambda t, s: gather_leaf(t, s, prog.mesh)  # noqa: E731
    return (tree_map(gather, params, prog.param_specs),
            tree_map(gather, opt_state, prog.opt_specs))
