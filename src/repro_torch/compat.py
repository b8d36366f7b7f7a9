"""Shims for the torch API surface the port depends on where that
surface is private or has moved between releases.

The reference's ``repro/compat.py`` holds four shims for jax, and none
has a torch counterpart here:

* ``shard_map`` and ``axis_size``: the port runs one process per
  device, so a mesh axis is a process group and its size a number
  (``launch/mesh.py``, ``MeshAxis.size``);
* ``make_mesh``'s ``AxisType``: torch has no mesh axis types;
* ``partitionable_rng``: the port draws every param at its global shape
  and then keeps its shard (``ServeProgram.init_params``), so the draws
  do not depend on the sharding.

What the port needs instead is the dry run's (``launch/dryrun_lib.py``):
a process group that moves no data, so one process can run one rank's
program of a mesh of any size, and a test for the tensors that have no
storage.  Both live in private torch modules, which have moved before;
they are reached through here only.
"""
from __future__ import annotations

import torch


def init_fake_process_group(rank: int, world_size: int) -> None:
    """Make this process rank ``rank`` of a world of ``world_size`` over
    torch's fake backend: every collective returns at once, moving no
    data, and ``new_group(..., backend="fake")`` builds groups of it.
    Importing ``fake_pg`` registers the backend."""
    import torch.distributed as dist

    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:  # pragma: no cover - a torch that moved it
        raise RuntimeError(
            "this torch has no fake process group at torch.testing."
            "_internal.distributed.fake_pg; the dry run needs one") from e
    if dist.is_initialized():
        raise RuntimeError("a process group is initialized already: the "
                           "dry run builds its own fake world")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)


def fake_tensor_mode():
    """A new ``FakeTensorMode``: tensors made under it carry shape,
    dtype and device (``"cuda"`` too, with no card) and no storage.
    While it is active it holds ``op_stats.FAKE`` on the counter stack,
    so a kernel wrapper given its tensors with no ``OpStats`` active
    raises (``analysis/op_stats.py``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.analysis import op_stats

    class _Mode(FakeTensorMode):
        def __enter__(self):
            op_stats.ACTIVE.append(op_stats.FAKE)
            return super().__enter__()

        def __exit__(self, *exc):
            op_stats.pop(op_stats.FAKE)
            return super().__exit__(*exc)

    return _Mode()


def fake_mode_active() -> bool:
    """Whether a ``FakeTensorMode`` is active: tensors made now are fake,
    so a ``"cuda"`` device needs no card."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    return any(isinstance(m, FakeTensorMode)
               for m in _get_current_dispatch_mode_stack())


def is_fake(t: torch.Tensor) -> bool:
    """Whether ``t`` is a fake tensor (no storage to launch a kernel
    on)."""
    from torch._subclasses.fake_tensor import is_fake as _is_fake

    return _is_fake(t)
