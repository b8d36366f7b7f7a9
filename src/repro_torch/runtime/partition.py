"""Automatic partition specs, and the slicing of one rank's shard.

The reference (``repro/runtime/partition.py``) evaluates one init
function twice, with global and with per-device shapes, and derives
every leaf's spec from the dim-wise ratio: ``global == tp * local`` is
sharded over the model axis, equal dims are replicated.  One rule covers
params and KV caches of every architecture.  Here the two trees are
built on the ``meta`` device (:func:`eval_shape_pair`), and
:func:`shard_tree` cuts one rank's leaves out of a global tree by the
specs; that is how weights and caches reach the ranks.

A spec is a :class:`Spec`: per dim, None (replicated) or the mesh axis
name it is split over.  Training reads more from the specs: the axes a
leaf is replicated on (:func:`replicated_axes`: its gradient is summed
over them), whether this rank is the one of its replicas that counts a
slice in a global sum (:func:`owns`), the dim a ZeRO spec adds
(:func:`added_dim`), and the collectives that move a leaf between two
specs: :func:`gather_leaf` (all-gathers) and :func:`global_sum` (a
slice's partial sums placed in the global shape and summed over the
mesh).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.tree import tree_map


@dataclass(frozen=True)
class Spec:
    """The reference's ``PartitionSpec``: per dim, None or an axis name
    (or a tuple of axis names, split over their product)."""

    dims: Tuple[Any, ...]

    def __iter__(self):
        return iter(self.dims)

    def __len__(self):
        return len(self.dims)


class MetaGenerator:
    """Stands in for a ``torch.Generator`` when params are built on the
    ``meta`` device: the models' init functions draw nothing from it
    (``models/common.py::randn``)."""

    device = torch.device("meta")


META = MetaGenerator()


def derive_specs(global_tree: Any, local_tree: Any, tp: int,
                 tp_axis: str = "model") -> Any:
    """Trees of tensors (meta or real) -> tree of :class:`Spec`."""

    def one(g, l):
        gs, ls = tuple(g.shape), tuple(l.shape)
        if len(gs) != len(ls):
            raise ValueError(f"rank mismatch {gs} vs {ls}")
        spec = []
        for gd, ld in zip(gs, ls):
            if gd == ld:
                spec.append(None)
            elif gd == tp * ld:
                spec.append(tp_axis)
            else:
                raise ValueError(f"unshardable dim pair {gd} vs {ld} "
                                 f"(tp={tp})")
        return Spec(tuple(spec))

    return tree_map(one, global_tree, local_tree)


def eval_shape_pair(init_fn: Callable, plan, *args) -> Tuple[Any, Any]:
    """(global tree, local tree) of ``init_fn(plan, *args)`` evaluated
    with ``plan.as_global()`` and with ``plan``; pass :data:`META` as the
    generator (or ``device="meta"``) so nothing is allocated."""
    return init_fn(plan.as_global(), *args), init_fn(plan, *args)


def batch_specs(batch_shapes: Dict[str, Any], dp_axes: Tuple[str, ...],
                dp_size: Optional[int] = None) -> Dict[str, Spec]:
    """The batch dim over the data axes, unless it does not divide them
    (the reference's ``_batch_pspec``: then it is replicated)."""
    dp = dp_axes if len(dp_axes) != 1 else (dp_axes[0] if dp_axes else None)
    out = {}
    for k, v in batch_shapes.items():
        shape = tuple(v.shape) if hasattr(v, "shape") else tuple(v)
        use = dp is not None and (dp_size is None or shape[0] % dp_size == 0)
        out[k] = Spec((dp if use else None,) + (None,) * (len(shape) - 1))
    return out


def _index(entry, coords: Dict[str, Tuple[int, int]]) -> Tuple[int, int]:
    """(this rank's part, the number of parts) for one spec entry."""
    names = entry if isinstance(entry, tuple) else (entry,)
    idx, n = 0, 1
    for name in names:
        i, size = coords[name]
        idx, n = idx * size + i, n * size
    return idx, n


def shard_leaf(t: torch.Tensor, spec: Spec,
               coords: Dict[str, Tuple[int, int]]) -> torch.Tensor:
    """This rank's part of the global tensor ``t`` (a copy, so the
    global can be freed)."""
    if len(spec) != t.dim():
        raise ValueError(f"spec {spec.dims} for a {t.dim()}-dim tensor")
    out = t
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        idx, n = _index(entry, coords)
        size = t.shape[d]
        if size % n:
            raise ValueError(f"dim {d} of {tuple(t.shape)} does not split "
                             f"{n} ways")
        out = out.narrow(d, idx * (size // n), size // n)
    return out.clone() if out is not t else t


def shard_tree(global_tree: Any, specs: Any,
               coords: Dict[str, Tuple[int, int]]) -> Any:
    """One rank's leaves of a global tree: each leaf cut by its spec at
    this rank's ``coords`` (axis name -> (index, size))."""
    return tree_map(lambda t, s: shard_leaf(t, s, coords), global_tree,
                    specs)


# ---------------------------------------------------------------------------
# Specs on a mesh (training)
# ---------------------------------------------------------------------------


def entry_axes(entry) -> Tuple[str, ...]:
    """The axis names of one spec entry (none for None)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """Every axis name a spec splits over."""
    return tuple(a for e in spec for a in entry_axes(e))


def replicated_axes(spec: Spec, axis_names=("data", "model")
                    ) -> Tuple[str, ...]:
    """The mesh axes ``spec`` does not split over: a leaf holds the same
    slice on every rank of them, and its gradient there is a partial sum
    (the leaf's gradient is the sum over them)."""
    used = spec_axes(spec)
    return tuple(a for a in axis_names if a not in used)


def owns(spec: Spec, coords: Dict[str, Tuple[int, int]]) -> bool:
    """Whether this rank is index 0 on every axis ``spec`` is replicated
    on: the one replica of its slice that a global sum counts."""
    return all(coords[a][0] == 0 for a in replicated_axes(spec, coords))


def added_dim(base: Spec, spec: Spec) -> Optional[int]:
    """The dim where ``spec`` splits and ``base`` does not (a ZeRO spec
    over its param's), or None where they are equal.  They may differ
    at one dim only."""
    dims = [d for d, (a, b) in enumerate(zip(base, spec)) if a != b]
    if not dims:
        return None
    if len(dims) > 1 or base.dims[dims[0]] is not None:
        raise ValueError(f"{spec.dims} does not add one split to "
                         f"{base.dims}")
    return dims[0]


def narrow_to(t: torch.Tensor, base: Spec, spec: Spec,
              coords: Dict[str, Tuple[int, int]]) -> torch.Tensor:
    """This rank's part under ``spec`` of ``t``, its part under ``base``
    (a view: the one dim :func:`added_dim` is cut)."""
    d = added_dim(base, spec)
    if d is None:
        return t
    idx, n = _index(spec.dims[d], coords)
    size = t.shape[d] // n
    return t.narrow(d, idx * size, size)


def gather_leaf(t: torch.Tensor, spec: Spec, mesh,
                base: Optional[Spec] = None) -> torch.Tensor:
    """``t``, this rank's part under ``spec``, all-gathered to its part
    under ``base`` (the global leaf without it): over each split of
    ``spec`` that ``base`` lacks, the dim's axis all-gathered (a tuple
    entry over ``mesh.axis`` of the tuple, its first axis major)."""
    from repro_torch.core import dataflow

    base = base or Spec((None,) * t.dim())
    for d, (a, b) in enumerate(zip(spec, base)):
        if a != b:
            if b is not None:
                raise ValueError(f"cannot gather {spec.dims} to "
                                 f"{base.dims}")
            t = dataflow.all_gather(t, mesh.axis(a), d)
    return t


def slice_starts(spec: Spec, shape: Tuple[int, ...],
                 coords: Dict[str, Tuple[int, int]]) -> Tuple[slice, ...]:
    """The index of this rank's part under ``spec`` in the global leaf
    of ``shape``."""
    out = []
    for size, entry in zip(shape, spec):
        if entry is None:
            out.append(slice(None))
            continue
        idx, n = _index(entry, coords)
        out.append(slice(idx * (size // n), (idx + 1) * (size // n)))
    return tuple(out)


def global_sum(t: torch.Tensor, spec: Spec, shape: Tuple[int, ...], mesh,
               source: Optional[Spec] = None) -> torch.Tensor:
    """The global tensor of ``shape`` in which every rank's ``t`` (its
    part under ``spec``: partial sums, or values) is added at its
    slice, on every rank: one psum over the whole mesh.  ``t`` comes
    from the rank's part under ``source`` (``spec`` by default; a row
    sum of a slice split on its columns too): ranks that hold the same
    part under ``source`` count it once (:func:`owns`)."""
    from repro_torch.core import dataflow

    coords = mesh.coords_dict()
    out = torch.zeros(shape, dtype=t.dtype, device=t.device)
    if owns(source or spec, coords):
        out[slice_starts(spec, shape, coords)] = t
    return dataflow.psum(out, mesh.both)
