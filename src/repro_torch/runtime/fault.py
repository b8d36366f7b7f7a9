"""Fault tolerance and straggler detection for long runs (the
reference's ``repro/runtime/fault.py``, host code copied):

* :class:`StepGuard` — wraps the training step; on a failure it waits
  out the backoff, calls the recovery callback (restore the latest
  checkpoint) and replays the step, whose batch is a pure function of
  (seed, step).  The card runs asynchronously, so the guard
  synchronizes the devices the step's outputs live on: a device fault
  surfaces inside the guard, as ``jax.block_until_ready`` makes it
  surface there in the reference.
* :class:`StragglerMonitor` — EWMA of step (or request) durations;
  flags those slower than ``threshold`` x the running mean.

* :func:`elastic_remesh` — the largest (data, model) mesh of the
  surviving ranks (:func:`remesh_shape`, the reference's rule), over
  which a job restores its last checkpoint (``checkpoint/manager.py``
  re-shards it).

On a mesh the guard also waits for every rank of it (a barrier), so a
step ends on all ranks together.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Sequence, Tuple

import torch

from repro_torch.tree import leaves

#: fault types :class:`StepGuard` retries.  A CUDA fault surfaces as
#: ``torch``'s ``RuntimeError`` (``torch.AcceleratorError`` is one),
#: filesystem flakiness as ``OSError`` (``ConnectionError`` and
#: ``TimeoutError`` are its subclasses).  Anything else propagates
#: immediately: retrying a programming error (``ValueError``,
#: ``TypeError``) just burns the backoff ladder, and ``KeyboardInterrupt``
#: / ``SystemExit`` are not Exceptions at all.
RETRYABLE_FAULTS: Tuple[type, ...] = (RuntimeError, OSError)


@dataclass
class StragglerMonitor:
    """EWMA of step (or request) durations; flags those slower than
    ``threshold`` x the running mean, and advises escalation after
    ``trip_limit`` consecutive flags."""

    alpha: float = 0.1           # EWMA coefficient
    threshold: float = 2.0       # flag steps slower than 2x the mean
    trip_limit: int = 3          # consecutive flags before escalation
    mean_s: float = 0.0
    trips: int = 0
    flagged_steps: List[int] = field(default_factory=list)

    def observe(self, step: int, duration_s: float) -> bool:
        """Returns True when escalation (reshard / evict) is advised."""
        if self.mean_s == 0.0:
            self.mean_s = duration_s
            return False
        slow = duration_s > self.threshold * self.mean_s
        if slow:
            self.trips += 1
            self.flagged_steps.append(step)
        else:
            self.trips = 0
            # slow steps don't poison the baseline
            self.mean_s = (1 - self.alpha) * self.mean_s + self.alpha * duration_s
        return self.trips >= self.trip_limit


def _synchronize(out) -> None:
    """Wait for every CUDA device that holds a tensor of ``out``."""
    devices = {t.device for t in leaves(out)
               if isinstance(t, torch.Tensor) and t.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)


@dataclass
class StepGuard:
    """Retry-with-recovery wrapper around the training step."""

    recover: Callable[[int], None]      # callback(last_good_step)
    max_retries: int = 3
    backoff_s: float = 1.0
    failures: int = 0
    retryable: Tuple[type, ...] = RETRYABLE_FAULTS
    #: the mesh the step runs on (``launch/mesh.py``), or None
    mesh: Any = None

    def run(self, step_fn: Callable, step: int, *args):
        for attempt in range(self.max_retries + 1):
            try:
                out = step_fn(*args)
                # synchronize so device-side failures surface *inside*
                # the guard, and on a mesh wait for its every rank
                _synchronize(out)
                if self.mesh is not None and self.mesh.size > 1:
                    import torch.distributed as dist

                    dist.barrier(group=self.mesh.both.group)
                return out
            except self.retryable:
                self.failures += 1
                if attempt == self.max_retries:
                    raise
                time.sleep(self.backoff_s * (2 ** attempt))
                self.recover(step - 1)
            # everything else — including KeyboardInterrupt/SystemExit,
            # which are not even Exceptions — propagates uncaught
        raise RuntimeError("unreachable")


def remesh_shape(n: int, model_parallelism: int = 16) -> Tuple[int, int]:
    """(data, model) of the reference's ``elastic_remesh`` over ``n``
    devices: the model axis ``gcd(model_parallelism, n)`` (halved while
    it does not divide n), the data axis the rest."""
    model = math.gcd(model_parallelism, n)
    while model > 1 and n % model:
        model //= 2
    return n // model, model


def elastic_remesh(ranks: Sequence[int], model_parallelism: int = 16, *,
                   backend: str = "gloo", host_copies: bool = False):
    """The largest (data, model) mesh of the surviving ``ranks`` (global
    ranks, in order) by :func:`remesh_shape`, and the ranks left out:
    (mesh, dropped), the reference's ``elastic_remesh`` over ranks.
    Every rank of the world calls it (building a mesh is collective); a
    rank outside the new mesh gets None for it."""
    from repro_torch.launch.mesh import make_mesh

    ranks = list(ranks)
    data, model = remesh_shape(len(ranks), model_parallelism)
    usable = ranks[:data * model]
    mesh = make_mesh(data, model, backend=backend, host_copies=host_copies,
                     ranks=usable)
    return mesh, ranks[data * model:]
