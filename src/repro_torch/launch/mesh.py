"""Meshes of ``torch.distributed`` ranks, and the spawn that starts them.

The reference lays its devices out on a ``jax`` mesh with the axes
``("data", "model")`` (``launch/mesh.py::make_host_mesh``) and runs each
model as one ``shard_map`` over it.  Here every device is a process (a rank): a
:class:`Mesh` names this rank's coordinates on the two axes and holds
one process group per axis, over which ``core/dataflow.py`` runs its
collectives.  Rank ``ranks[d * model + m]`` sits at (d, m).

Three transports:

* ``backend="nccl"``: one card per rank; CUDA tensors go to NCCL as
  they are.
* ``backend="gloo"``: CPU tensors go to gloo as they are.  Gloo takes
  CUDA tensors for ``all_reduce`` and ``broadcast`` only, so a run on the
  card must ask for ``host_copies=True``: every collective then copies
  its CUDA tensor to a host buffer and back (``core/dataflow.py`` counts
  the copies).  This is how several ranks share one card, where NCCL
  refuses two ranks on one device.  Without ``host_copies`` a CUDA
  tensor on a gloo mesh raises.
* ``backend="fake"``: the dry run's (``launch/dryrun_lib.py``): one
  process is one rank of a world of any size over torch's fake process
  group (``compat.init_fake_process_group``), whose collectives move no
  data.  :func:`make_mesh` takes it; :func:`spawn` does not.

:func:`make_production_mesh` is the reference's production mesh on the
fake backend.  The reference's multi-pod mesh has three axes, (2, 16,
16) over ``("pod", "data", "model")``; a :class:`Mesh` here has two, so
it folds the pod axis into the data axis, (32, 16) over ``("data",
"model")``: ``ParallelConfig.zero_axes`` = ``("data", "model")`` then
spans the same 512 ranks as the reference's three axes, and the data
axis carries what ``("pod", "data")`` carries there.

:func:`spawn` starts ``world`` ranks, joins them through a file in a
directory the caller names (never a fixed port), and returns what each
rank's function returned.  A rank that raises fails the whole spawn:
``torch.multiprocessing`` stops the other ranks, and the caller gets a
:class:`SpawnError` with every rank's error.
"""
from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

AXES = ("data", "model")
#: the transports ``spawn`` starts ranks on
BACKENDS = ("nccl", "gloo")
#: the reference's production meshes (``make_production_mesh``) as
#: (data, model) sizes, by the dry run's names; the multi-pod mesh's pod
#: axis folded into the data axis
PRODUCTION_MESHES = {"pod16x16": (16, 16), "2xpod16x16": (32, 16)}


@dataclass(frozen=True)
class MeshAxis:
    """One axis of a mesh as seen from one rank: its name, size, this
    rank's index on it, the global ranks along it in index order, and
    the process group over them."""

    name: str
    size: int
    index: int
    ranks: Tuple[int, ...]
    backend: str
    host_copies: bool
    group: Any = field(default=None, compare=False, repr=False)


@dataclass(frozen=True)
class Mesh:
    """A (data, model) mesh of ranks, as seen from one of them."""

    shape: Tuple[int, int]
    coords: Tuple[int, int]
    data: MeshAxis
    model: MeshAxis
    backend: str
    host_copies: bool
    axis_names: Tuple[str, str] = AXES
    #: both axes as one, index ``d * model + m``: the ranks a spec entry
    #: ``("data", "model")`` splits over (ZeRO over the whole mesh,
    #: ``dp_only``'s data axes)
    both: Optional[MeshAxis] = None

    def coords_dict(self) -> Dict[str, Tuple[int, int]]:
        """axis name -> (this rank's index, the axis size)."""
        return {a.name: (a.index, a.size) for a in (self.data, self.model)}

    @property
    def size(self) -> int:
        return self.data.size * self.model.size

    @property
    def rank_index(self) -> int:
        """This rank's index on the mesh, ``d * model + m``."""
        return self.coords[0] * self.model.size + self.coords[1]

    def axis(self, entry) -> MeshAxis:
        """The axis a spec entry names: ``"data"``, ``"model"``, or a
        tuple of names (split over their product, the first major):
        ``("data", "model")`` is :attr:`both`.  An axis name in a tuple
        of one stands for itself."""
        names = entry if isinstance(entry, tuple) else (entry,)
        if len(names) == 1:
            return {"data": self.data, "model": self.model}[names[0]]
        if tuple(names) == AXES:
            return self.both
        raise ValueError(f"no process group for the axes {names}: a "
                         f"tuple entry must be {AXES}")


def make_mesh(data: int, model: int, *, backend: str,
              host_copies: bool = False,
              ranks: Optional[Sequence[int]] = None) -> Optional[Mesh]:
    """A (data, model) mesh over ``ranks`` (the first ``data * model``
    ranks of the world by default).  Every rank of the world must call
    it with the same arguments (``new_group`` is collective over the
    world); a rank outside ``ranks`` gets None."""
    import torch.distributed as dist

    if backend not in BACKENDS + ("fake",):
        raise ValueError(f"backend must be one of {BACKENDS + ('fake',)}: "
                         f"{backend!r}")
    if host_copies and backend != "gloo":
        raise ValueError("host copies are the gloo transport's; nccl takes "
                         "CUDA tensors as they are")
    n = data * model
    ranks = tuple(range(n)) if ranks is None else tuple(int(r) for r in ranks)
    if len(ranks) != n or list(ranks) != sorted(set(ranks)):
        raise ValueError(f"a ({data}, {model}) mesh needs {n} distinct "
                         f"ranks in increasing order: {ranks}")
    if max(ranks) >= dist.get_world_size():
        raise ValueError(f"ranks {ranks} outside a world of "
                         f"{dist.get_world_size()}")
    me = dist.get_rank()
    rows = [ranks[d * model:(d + 1) * model] for d in range(data)]
    cols = [tuple(rows[d][m] for d in range(data)) for m in range(model)]
    # every rank creates every group, in the same order
    model_groups = [dist.new_group(list(r), backend=backend) for r in rows]
    data_groups = [dist.new_group(list(c), backend=backend) for c in cols]
    both_group = dist.new_group(list(ranks), backend=backend)
    if me not in ranks:
        return None
    pos = ranks.index(me)
    d, m = divmod(pos, model)
    return Mesh(
        shape=(data, model), coords=(d, m), backend=backend,
        host_copies=host_copies,
        data=MeshAxis("data", data, d, cols[m], backend, host_copies,
                      data_groups[m]),
        model=MeshAxis("model", model, m, rows[d], backend, host_copies,
                       model_groups[d]),
        both=MeshAxis("data,model", n, pos, ranks, backend, host_copies,
                      both_group))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """This rank's part of the reference's production mesh, (16, 16) or
    the multi-pod (2, 16, 16) folded into (32, 16) (module docstring), on
    the fake backend: the world must be a fake one of that size
    (``compat.init_fake_process_group``)."""
    name = "2xpod16x16" if multi_pod else "pod16x16"
    return make_mesh(*PRODUCTION_MESHES[name], backend="fake")


def _rank_main(rank: int, fn: Callable, world: int, args: tuple,
               rdv: str, backend: str, timeout_s: float, out_dir: str
               ) -> None:
    import torch.distributed as dist

    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"file://{rdv}", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(rank, world, *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        # the caller reports every rank's error, the first one first
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


class SpawnError(RuntimeError):
    """A spawned rank failed.  ``errors``: rank -> its traceback, for
    every rank that recorded one, the first to fail first (a rank that
    was waiting on the failed one in a collective fails after it)."""

    def __init__(self, errors: Dict[int, str], cause: BaseException):
        self.errors = errors
        text = "\n".join(f"-- rank {r}:\n{tb}" for r, tb in errors.items())
        super().__init__(f"{len(errors)} rank(s) failed, first rank "
                         f"{next(iter(errors), '?')}:\n{text or cause}")


def spawn(fn: Callable, world: int, *args, tmp_dir: str,
          backend: str = "gloo", timeout_s: float = 600.0) -> List[Any]:
    """Run ``fn(rank, world, *args)`` in ``world`` new processes joined
    as one ``torch.distributed`` world on ``backend``, and return each
    rank's result in rank order.  ``fn`` must be importable by name (a
    module-level function); results travel by pickle, so return CPU
    tensors.  Rendezvous is a file in a fresh directory under
    ``tmp_dir``.  If any rank raises or dies, the others are stopped and
    this raises :class:`SpawnError` with every rank's recorded error, the
    first to fail first."""
    import torch.multiprocessing as mp

    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}: {backend!r}")
    os.makedirs(tmp_dir, exist_ok=True)
    run_dir = tempfile.mkdtemp(prefix="spawn-", dir=tmp_dir)
    rdv = os.path.join(run_dir, "rendezvous")
    try:
        mp.spawn(_rank_main, args=(fn, world, args, rdv, backend, timeout_s,
                                   run_dir), nprocs=world, join=True)
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
        paths = sorted((os.path.getmtime(p), r, p) for r in range(world)
                       for p in [os.path.join(run_dir, f"rank{r}.err")]
                       if os.path.isfile(p))
        errors = {}
        for _, r, p in paths:
            with open(p) as f:
                errors[r] = f.read()
        raise SpawnError(errors, e) from e
    out = []
    for r in range(world):
        with open(os.path.join(run_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out
