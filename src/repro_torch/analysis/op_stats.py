"""What one rank's program computes, moves and holds, counted as it runs.

The counterpart of the reference's ``repro/analysis/hlo_stats.py``.  The
reference compiles a cell's program and parses the compiled HLO, with
each loop body multiplied by its trip count.  The port runs the program
eagerly (on fake tensors in a dry run, ``launch/dryrun_lib.py``; on real
ones anywhere), so every loop iteration runs and is counted: no trip
counts.  :class:`OpStats` is a ``TorchDispatchMode`` that sees every
aten op below autograd, forward and backward, and keeps the fields of
the reference's ``HloStats`` with the same definitions:

* ``flops``: 2·M·N·K of every product (:data:`PRODUCTS`), plus the
  operations each hand-written kernel reports for its launches;
  ``flops_by_dtype`` splits them by the dtype whose peak they run at
  (a product's operands', a kernel's own), for the roofline's compute
  term (``analysis/roofline.py``);
* ``hbm_bytes``: the operand and result bytes of those products, plus
  each kernel's bytes (each input read once, each output written once),
  plus the operand bytes of every collective;
* ``wire_bytes``, ``op_counts``, ``op_bytes``: the change of
  ``core/dataflow.py``'s ``TRAFFIC`` over the counted program: its
  collectives under the reference's HLO names, with the bytes this rank
  sends by the ring algorithm (``op_bytes`` per name, as the
  reference's).  ``TRAFFIC`` is not reset while a counter is active.

The kernels launch through ``ctypes``, so the dispatcher never sees
them; each wrapper reports its launch here (:func:`launch`) with its
module's work formula, the one ``chip_smoke.py`` bounds it by.  Per
kernel :attr:`OpStats.kernels` keeps calls, operations and bytes.

Memory: the storages the program makes while counted are tracked as
they are made and freed (a weakref finalizer on each), and
:attr:`OpStats.peak_bytes` is the peak of their sum; the storages of
the ``resident`` trees given (params, optimizer state, batch, caches)
count once, in :attr:`OpStats.resident_bytes`.  That is the analogue of
the reference's ``memory_analysis``: ``args_GB`` the resident bytes,
``temp_GB`` the peak.

With no ``OpStats`` active, a kernel wrapper pays one check (``if
ACTIVE``); nothing else changes.
"""
from __future__ import annotations

import math
import weakref
from typing import Any, Dict, Iterable, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.core import dataflow

#: the counters active in this process, innermost last; the kernel
#: wrappers report to the last one.  A fake-tensor mode made by
#: ``compat.fake_tensor_mode`` holds :data:`FAKE` here while it is active,
#: so a kernel wrapper that meets fake operands with no counter above it
#: raises instead of launching on tensors with no storage.
ACTIVE: List[Any] = []


class _NoCounter:
    """:data:`ACTIVE`'s entry for a fake-tensor mode: a kernel launch
    raises."""

    def kernel(self, name: str, ops: int, nbytes: int, dtype: str) -> None:
        raise RuntimeError(
            f"{name} met fake tensors with no OpStats active: a fake tensor "
            "has no storage to launch the kernel on")


FAKE = _NoCounter()

_aten = torch.ops.aten


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"``: the key of a device's peak."""
    return str(dtype).removeprefix("torch.")


def _numel(shape) -> int:
    return math.prod(int(d) for d in shape)


def _conv_flops(x, w, out, transposed: bool) -> int:
    """2 per multiply-add: each output element of a convolution reads
    ``C_in / groups · prod(kernel)`` products; a transposed one scatters
    each input element over ``C_out / groups · prod(kernel)``."""
    per = _numel(w.shape[1:])
    return 2 * (_numel(x.shape) if transposed else _numel(out.shape)) * per


def _product(func, args, out) -> Tuple[int, List[torch.Tensor]]:
    """(flops, the product's operands) of one product op."""
    p = func.overloadpacket
    if p in (_aten.mm, _aten._int_mm, _aten._scaled_mm):
        a, b = args[0], args[1]
        return 2 * a.shape[0] * a.shape[1] * b.shape[1], [a, b]
    if p is _aten.addmm:
        a, b = args[1], args[2]
        return 2 * a.shape[0] * a.shape[1] * b.shape[1], [a, b]
    if p is _aten.bmm:
        a, b = args[0], args[1]
        return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2], [a, b]
    if p in (_aten.baddbmm, _aten.addbmm):
        a, b = args[1], args[2]
        return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2], [a, b]
    if p in (_aten.dot, _aten.vdot):
        return 2 * args[0].numel(), [args[0], args[1]]
    if p is _aten.mv:
        a = args[0]
        return 2 * a.shape[0] * a.shape[1], [a, args[1]]
    if p is _aten.addmv:
        a = args[1]
        return 2 * a.shape[0] * a.shape[1], [a, args[2]]
    if p is _aten.convolution:
        x, w = args[0], args[1]
        return _conv_flops(x, w, out, bool(args[6])), [x, w]
    # convolution_backward(grad_out, input, weight, bias_sizes, stride,
    # padding, dilation, transposed, output_padding, groups, output_mask)
    g, x, w = args[0], args[1], args[2]
    mask = args[10]
    one = _conv_flops(x, w, g, bool(args[7]))
    return one * (int(mask[0]) + int(mask[1])), [g, x, w]


#: the aten products whose 2·M·N·K ``flops`` counts (``torch.matmul``,
#: ``einsum``, ``linear`` and ``F.conv*`` reach these below autograd)
PRODUCTS = frozenset({
    _aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm, _aten.addbmm,
    _aten._int_mm, _aten._scaled_mm, _aten.dot, _aten.vdot, _aten.mv,
    _aten.addmv, _aten.convolution, _aten.convolution_backward})


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> Iterable[torch.Tensor]:
    return (t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor))


def _storages(tree) -> Dict[int, Any]:
    """id -> storage of every tensor in ``tree``, each storage once."""
    out = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        out[id(st)] = st
    return out


def storage_bytes(tree) -> int:
    """Bytes of the storages ``tree``'s tensors hold, each once (what
    :class:`OpStats` counts as resident)."""
    return sum(st.nbytes() for st in _storages(tree).values())


class OpStats(TorchDispatchMode):
    """Counts one rank's program while active (``with OpStats(...)``,
    once): the fields of the reference's ``HloStats`` (module
    docstring), each kernel's reported ``calls`` / ``flops`` /
    ``bytes``, and the peak of the storages it makes.  ``resident``: trees of tensors that exist
    before (params, optimizer state, batch, caches), counted once in
    ``resident_bytes`` and never as made by the program."""

    def __init__(self, resident: Any = ()):
        super().__init__()
        self.flops = 0
        self.flops_by_dtype: Dict[str, int] = {}
        self.hbm_bytes = 0
        self.wire_bytes = 0
        self.op_counts: Dict[str, int] = {}
        self.op_bytes: Dict[str, int] = {}
        self.kernels: Dict[str, Dict[str, int]] = {}
        self._resident = _storages(resident)
        self.resident_bytes = sum(st.nbytes()
                                  for st in self._resident.values())
        self._live: Dict[int, int] = {}
        self.live_bytes = 0
        self.peak_bytes = 0

    def __enter__(self):
        self._traffic = dataflow.traffic_snapshot()
        ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        pop(self)
        self._resident = {}
        t0, t1 = self._traffic, dataflow.TRAFFIC
        self.wire_bytes = t1["bytes_sent"] - t0["bytes_sent"]
        self.hbm_bytes += t1["operand_bytes"] - t0["operand_bytes"]
        for op, n in t1["ops"].items():
            if n != t0["ops"].get(op, 0):
                self.op_counts[op] = n - t0["ops"].get(op, 0)
                self.op_bytes[op] = (t1["op_bytes"][op]
                                     - t0["op_bytes"].get(op, 0))
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket in PRODUCTS:
            flops, operands = _product(func, args, out)
            self._add_flops(flops, dtype_name(operands[0].dtype))
            self.hbm_bytes += sum(_nbytes(t) for t in operands) + sum(
                _nbytes(t) for t in _tensors(out))
        for t in _tensors(out):
            self._track(t.untyped_storage())
        return out

    def _track(self, st) -> None:
        key = id(st)
        if key in self._live or key in self._resident:
            return
        n = st.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def _add_flops(self, flops: int, dtype: str) -> None:
        self.flops += flops
        self.flops_by_dtype[dtype] = self.flops_by_dtype.get(dtype, 0) + flops

    def kernel(self, name: str, ops: int, nbytes: int, dtype: str) -> None:
        """One launch of the hand-written kernel ``name`` doing ``ops``
        operations at ``dtype``'s peak and moving ``nbytes``."""
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0,
                                           "bytes": 0})
        k["calls"] += 1
        k["flops"] += int(ops)
        k["bytes"] += int(nbytes)
        self._add_flops(int(ops), dtype)
        self.hbm_bytes += int(nbytes)

    def calls(self) -> Dict[str, int]:
        """Launches reported per kernel."""
        return {name: k["calls"] for name, k in self.kernels.items()}


def pop(entry) -> None:
    """Drop ``entry``'s last occurrence from :data:`ACTIVE`."""
    for i in range(len(ACTIVE) - 1, -1, -1):
        if ACTIVE[i] is entry:
            del ACTIVE[i]
            return


def launch(name: str, work: Tuple[int, int], operand: torch.Tensor,
           dtype: torch.dtype) -> bool:
    """Report one launch of kernel ``name`` doing ``work`` (operations,
    bytes) at the peak of ``dtype`` to the active counter; True when
    ``operand`` is a fake tensor, where the wrapper returns its empty
    output in place of the launch.  Call it only under ``if ACTIVE``."""
    from repro_torch.compat import is_fake

    ACTIVE[-1].kernel(name, *work, dtype_name(dtype))
    return is_fake(operand)
