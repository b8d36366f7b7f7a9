"""Computing-on-the-move over ``torch.distributed`` (paper §5): the
reference's ``repro/core/dataflow.py`` with ranks in place of devices.

Domino's inter-memory computing replaces "compute partial products, then
collect them through an external accumulator" with "partial sums hop
tile to tile and are added on the way".  Between ranks that is a ring of
point-to-point sends whose adds ride the hops:

* :func:`ring_reducescatter_matmul`: the row-parallel (down)
  projection.  Partial sums of one sequence chunk accumulate hop by hop
  in float32; the output lands sequence-sharded, with ``tail`` applied
  on the last hop.  Each rank sends ``(k - 1) / k`` of the output, where
  an all-reduce sends twice that.
* :func:`ring_allgather_matmul`: the column-parallel (up) projection
  with the input streamed around the ring and consumed in place.
* :func:`allreduce_matmul`, :func:`allgather_matmul`: the conventional
  baselines.
* :func:`lse_merge_decode_attention`: one-token attention over a KV
  cache sharded on its sequence dim, merged by log-sum-exp.

Every function takes the mesh axis (``launch/mesh.py::MeshAxis``) it
runs over, not an axis name.  The collectives the models use are thin
functions here: :func:`ppermute` (a batched ``isend`` / ``irecv``),
:func:`psum`, :func:`pmean`, :func:`pmax`, :func:`all_gather` (tiled),
:func:`psum_scatter` (tiled, a ring of ppermutes, for ZeRO) and
:func:`all_to_all` (tiled).  On an axis of size 1 each is the identity.

Each has its gradient: an ``autograd.Function`` whose backward is the
collective's transpose (ppermute by ``-shift``, psum by psum, an
all-gather by a reduce-scatter and back, an all_to_all with its two
dims swapped), run through the same transport; :func:`pmax` has none
(its operand is detached, as the reference stops the gradient of its
max shift).  With these the gradient a rank computes from a loss seeded
with ``1 / ranks`` is the reference's ``shard_map`` gradient.  The four
matmuls differentiate as one function each, whose backward is itself a
ring (or the baseline's collectives) and keeps the partial products in
float32 until their sum is done, as the forward does.

The host-copy transport lives here and only here: on a gloo axis built
with ``host_copies=True``, each collective copies its CUDA operand to a
host buffer (pinned memory), runs on the host and copies the result
back (``TRAFFIC["host_copies"]`` counts the round trips).  A CUDA tensor on
a gloo axis without ``host_copies`` raises.  ``TRAFFIC["bytes_sent"]``
counts what this rank sends by the ring algorithm of each collective:
a ppermute its operand, an all-gather ``(k - 1)`` local parts, an
all-reduce ``2 (k - 1) / k`` of its operand, an all-to-all ``(k - 1) /
k`` of it.  These are the reference's ring factors
(``repro/analysis/roofline.py::_WIRE_FACTOR``).  ``TRAFFIC["collectives"]``
counts the transfers (a :func:`psum_scatter`'s ``k - 1`` hops each one, as
the host copies go); ``TRAFFIC["ops"]`` and ``TRAFFIC["op_bytes"]`` count
the collectives by the reference's HLO name (``all-reduce``,
``all-gather``, ``reduce-scatter``, ``all-to-all``,
``collective-permute``) with the bytes each sent, a psum_scatter one
``reduce-scatter``, and ``TRAFFIC["operand_bytes"]`` their operands'
bytes.  ``analysis/op_stats.py::OpStats`` reads this record's change
over the program it counts.

The products keep the reference's float32 output
(``preferred_element_type``): a bfloat16 partial product reaches the
ring's float32 sum unrounded, and only the finished sum is rounded to
the operands' dtype.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

Tail = Optional[Callable[[torch.Tensor], torch.Tensor]]

#: this process's transfers, the bytes it sent by the ring algorithm of
#: each, the host round trips of the gloo transport on CUDA tensors, and
#: its collectives by name: their count, bytes sent and operand bytes
TRAFFIC = {"collectives": 0, "bytes_sent": 0, "host_copies": 0,
           "ops": {}, "op_bytes": {}, "operand_bytes": 0}


def reset_traffic() -> None:
    for key, value in TRAFFIC.items():
        TRAFFIC[key] = {} if isinstance(value, dict) else 0


def traffic_snapshot() -> dict:
    """A copy of ``TRAFFIC``, to take a program's change against."""
    return {k: dict(v) if isinstance(v, dict) else v
            for k, v in TRAFFIC.items()}


def _to_wire(x: torch.Tensor, axis):
    """(the tensor the collective works on, the device to return to or
    None).  The wire tensor is always a fresh buffer, so in-place
    collectives leave ``x`` as it is."""
    if x.device.type == "cuda" and axis.backend == "gloo":
        if not axis.host_copies:
            raise RuntimeError(
                "a CUDA tensor on a gloo mesh: gloo takes CUDA tensors for "
                "all_reduce and broadcast only.  Build the mesh with "
                "host_copies=True to copy through the host, or use "
                "backend='nccl' with one card per rank")
        TRAFFIC["host_copies"] += 1
        wire = _host_like(x)
        wire.copy_(x)
        return wire, x.device
    return x.contiguous().clone(), None


def _host_like(x: torch.Tensor) -> torch.Tensor:
    """An empty contiguous host buffer of ``x``'s shape and dtype, in
    pinned memory when ``x`` is on the card or pinned itself (the copies
    in and out then run at the bus's rate, and the copy back to the card
    need not wait for the host); an ordinary one for a CPU tensor."""
    pin = x.device.type == "cuda" or x.is_pinned()
    return torch.empty(x.shape, dtype=x.dtype, pin_memory=pin)


def _recv_like(wire: torch.Tensor) -> torch.Tensor:
    """A receive buffer for ``wire``: on the host (pinned as ``wire``)
    for a host wire, on ``wire``'s device otherwise (nccl, and the fake
    backend's CUDA tensors)."""
    if wire.device.type == "cpu":
        return _host_like(wire)
    return torch.empty_like(wire, memory_format=torch.contiguous_format)


def _from_wire(t: torch.Tensor, dev) -> torch.Tensor:
    return t if dev is None else t.to(dev, non_blocking=t.is_pinned())


def _count(op: str, nbytes: float, operand: int, hops: int = 1) -> None:
    """One collective ``op`` of this rank (the reference's HLO name) in
    ``TRAFFIC``: ``hops`` transfers that sent ``nbytes`` in all by its
    ring algorithm, on an operand of ``operand`` bytes."""
    sent = int(nbytes)
    TRAFFIC["collectives"] += hops
    TRAFFIC["bytes_sent"] += sent
    TRAFFIC["ops"][op] = TRAFFIC["ops"].get(op, 0) + 1
    TRAFFIC["op_bytes"][op] = TRAFFIC["op_bytes"].get(op, 0) + sent
    TRAFFIC["operand_bytes"] += int(operand)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def _ppermute(x: torch.Tensor, axis, shift: int) -> torch.Tensor:
    if axis.size == 1:
        return x
    out = _hop(x, axis, shift)
    _count("collective-permute", _nbytes(x), _nbytes(x))
    return out


def _hop(x: torch.Tensor, axis, shift: int) -> torch.Tensor:
    """``x`` sent ``shift`` ranks along the ring, uncounted."""
    import torch.distributed as dist

    k = axis.size
    wire, dev = _to_wire(x, axis)
    out = _recv_like(wire)
    dst = axis.ranks[(axis.index + shift) % k]
    src = axis.ranks[(axis.index - shift) % k]
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, wire, dst, group=axis.group),
        dist.P2POp(dist.irecv, out, src, group=axis.group)])
    for req in reqs:
        req.wait()
    return _from_wire(out, dev)


def _all_reduce(x: torch.Tensor, axis, op) -> torch.Tensor:
    import torch.distributed as dist

    k = axis.size
    if k == 1:
        return x
    wire, dev = _to_wire(x, axis)
    dist.all_reduce(wire, op=op, group=axis.group)
    _count("all-reduce", 2 * (k - 1) / k * _nbytes(wire), _nbytes(wire))
    return _from_wire(wire, dev)


def _psum(x: torch.Tensor, axis) -> torch.Tensor:
    import torch.distributed as dist

    return _all_reduce(x, axis, dist.ReduceOp.SUM)


def _all_gather(x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    import torch.distributed as dist

    k = axis.size
    if k == 1:
        return x
    wire, dev = _to_wire(x, axis)
    parts = [torch.empty_like(wire) for _ in range(k)]
    dist.all_gather(parts, wire, group=axis.group)
    _count("all-gather", (k - 1) * _nbytes(wire), _nbytes(wire))
    return _from_wire(torch.cat(parts, dim=dim), dev)


def _all_to_all(x: torch.Tensor, axis, split_axis: int, concat_axis: int
                ) -> torch.Tensor:
    import torch.distributed as dist

    k = axis.size
    if k == 1:
        return x
    xs = x.movedim(split_axis, 0)
    n = xs.shape[0]
    if n % k:
        raise ValueError(f"all_to_all: dim {split_axis} of {tuple(x.shape)} "
                         f"does not split {k} ways")
    wire, dev = _to_wire(xs.reshape(k, n // k, *xs.shape[1:]), axis)
    out = _recv_like(wire)
    dist.all_to_all_single(out, wire, group=axis.group)
    _count("all-to-all", (k - 1) / k * _nbytes(wire), _nbytes(wire))
    out = _from_wire(out, dev)
    return torch.cat([out[j].movedim(0, split_axis) for j in range(k)],
                     dim=concat_axis)


def _psum_scatter(x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """The ring reduce-scatter: at step ``step`` rank i adds its part
    ``(i + step + 1) % k`` of ``x`` to the sum it holds and sends the
    sum left, as :func:`ring_reducescatter_matmul` does with its
    products; part i ends on rank i, its k terms added in ring order."""
    k, i = axis.size, axis.index
    if k == 1:
        return x
    n = x.shape[dim]
    if n % k:
        raise ValueError(f"psum_scatter: dim {dim} of {tuple(x.shape)} does "
                         f"not split {k} ways")
    chunk = n // k
    acc = None
    for step in range(k):
        part = x.narrow(dim, ((i + step + 1) % k) * chunk, chunk)
        acc = part.clone() if acc is None else acc + part
        if step != k - 1:
            acc = _hop(acc, axis, -1)
    _count("reduce-scatter", (k - 1) * _nbytes(acc), _nbytes(x), hops=k - 1)
    return acc


class _PPermute(torch.autograd.Function):
    """Its transpose is the permutation back: ``-shift``."""

    @staticmethod
    def forward(ctx, x, axis, shift):
        ctx.axis, ctx.shift = axis, shift
        return _ppermute(x, axis, shift)

    @staticmethod
    def backward(ctx, g):
        return _ppermute(g, ctx.axis, -ctx.shift), None, None


class _PSum(torch.autograd.Function):
    """Its transpose is itself: rank i's input reaches every rank's
    output, so its cotangent is the sum of theirs."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _psum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _psum(g, ctx.axis), None


class _AllGather(torch.autograd.Function):
    """Its transpose is the reduce-scatter along the gathered dim."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _psum_scatter(g, ctx.axis, ctx.dim), None, None


class _PSumScatter(torch.autograd.Function):
    """Its transpose is the all-gather along the scattered dim."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _psum_scatter(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.axis, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    """Its transpose is the all_to_all with the two dims swapped."""

    @staticmethod
    def forward(ctx, x, axis, split_axis, concat_axis):
        ctx.args = (axis, split_axis, concat_axis)
        return _all_to_all(x, axis, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        axis, split_axis, concat_axis = ctx.args
        return _all_to_all(g, axis, concat_axis, split_axis), None, None, None


def ppermute(x: torch.Tensor, axis, shift: int) -> torch.Tensor:
    """Each rank at index i sends ``x`` to index ``i + shift`` and
    returns what index ``i - shift`` sent (mod the axis size): the
    reference's ``lax.ppermute`` with ``perm = [(j, (j + shift) % k)]``."""
    if axis.size == 1:
        return x
    return _PPermute.apply(x, axis, shift)


def psum(x: torch.Tensor, axis) -> torch.Tensor:
    """Sum of ``x`` over the axis (``lax.psum``)."""
    if axis.size == 1:
        return x
    return _PSum.apply(x, axis)


def pmean(x: torch.Tensor, axis) -> torch.Tensor:
    """Mean of ``x`` over the axis (``lax.pmean``): :func:`psum` over
    the axis size."""
    from repro_torch.core.cim import divide

    if axis.size == 1:
        return x
    return divide(psum(x, axis), float(axis.size))


def pmax(x: torch.Tensor, axis) -> torch.Tensor:
    """Elementwise max of ``x`` over the axis (``lax.pmax``).  It has no
    gradient: ``x`` is detached first, as the reference stops the
    gradient of its max shift before the collective."""
    import torch.distributed as dist

    if axis.size == 1:
        return x.detach()
    return _all_reduce(x.detach(), axis, dist.ReduceOp.MAX)


def all_gather(x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in index order
    (``lax.all_gather(..., tiled=True)``)."""
    if axis.size == 1:
        return x
    return _AllGather.apply(x, axis, dim)


def psum_scatter(x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """``x`` summed over the axis, of which rank i keeps part i along
    ``dim`` (``lax.psum_scatter(..., tiled=True)``), by the ring of
    :func:`ppermute` hops: each rank sends ``(k - 1) / k`` of ``x``."""
    if axis.size == 1:
        return x
    return _PSumScatter.apply(x, axis, dim)


def all_to_all(x: torch.Tensor, axis, split_axis: int, concat_axis: int
               ) -> torch.Tensor:
    """``lax.all_to_all(..., tiled=True)``: ``x`` cut into k equal parts
    along ``split_axis``, part j sent to index j, and the parts received
    concatenated along ``concat_axis`` in sender order."""
    if axis.size == 1:
        return x
    return _AllToAll.apply(x, axis, split_axis, concat_axis)


# ---------------------------------------------------------------------------
# Ring collectives with fused compute
# ---------------------------------------------------------------------------


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("...sk,kn->...sn", preferred_element_type=float32)``:
    operands of two dtypes multiply in the promoted one, and the product
    is returned in float32, never rounded to bfloat16 (or half) on the
    way.  On the card that is one GEMM with a float32 output; elsewhere
    the operands are widened first (a product of two bfloat16 values is
    exact in float32)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    x, w = x.to(dt), w.to(dt)
    if dt not in (torch.bfloat16, torch.float16):
        return torch.matmul(x, w).float()
    if x.device.type != "cuda":
        return torch.matmul(x.float(), w.float())
    y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def _finish(acc: torch.Tensor, tail: Tail, dtype) -> torch.Tensor:
    if tail is not None:
        acc = tail(acc)
    return acc.to(dtype)


def _mm_t(g: torch.Tensor, wf: torch.Tensor) -> torch.Tensor:
    """``g @ wf.T``: the float32 cotangent against the float32 weight
    ``wf`` (widened once a backward by the caller), so a partial product
    reaches its sum unrounded.  The cotangent stays float32, as the
    reference's transpose of a ``preferred_element_type=float32``
    product: it carries the bias and activation tails' gradients, which
    bfloat16 does not hold."""
    return torch.matmul(g, wf.T)


def _wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``x.T @ g`` over every leading dim, in float32: (K, N).  ``x`` is
    one ring chunk, widened here, so no float32 copy of the whole
    activation is made."""
    return torch.matmul(x.reshape(-1, x.shape[-1]).float().T,
                        g.reshape(-1, g.shape[-1]))


def _seq_chunk_of(s: int, axis) -> int:
    if s % axis.size:
        raise ValueError(f"sequence dim {s} must divide the "
                         f"{axis.name!r} axis {axis.size}")
    return s // axis.size


def _ring_rs(x: torch.Tensor, w: torch.Tensor, axis) -> torch.Tensor:
    """The reduce-scatter ring's float32 sum of this rank's chunk."""
    k, i = axis.size, axis.index
    chunk = _seq_chunk_of(x.shape[-2], axis)
    acc = None
    for step in range(k):
        c = (i + step + 1) % k
        part = _mm(x[..., c * chunk:(c + 1) * chunk, :], w)
        acc = part if acc is None else acc + part
        if step != k - 1:
            acc = _ppermute(acc, axis, -1)
    return acc


def _ring_ag(x: torch.Tensor, w: torch.Tensor, axis, keep=None
             ) -> torch.Tensor:
    """The all-gather ring's float32 products over the whole sequence;
    ``keep`` (a list) receives the buffer of each step."""
    k, i = axis.size, axis.index
    chunk = x.shape[-2]
    out = torch.zeros((*x.shape[:-2], chunk * k, w.shape[-1]),
                      dtype=torch.float32, device=x.device)
    buf = x
    for step in range(k):
        src = (i - step) % k
        if keep is not None:
            keep.append(buf)
        out[..., src * chunk:(src + 1) * chunk, :] = _mm(buf, w)
        if step != k - 1:
            buf = _ppermute(buf, axis, 1)
    return out


class _RingReduceScatterMatmul(torch.autograd.Function):
    """Its backward is the transposed ring: the float32 cotangent of
    chunk i orbits right (i to i + 1), and at each step a rank forms the
    input gradient of the chunk it holds and adds to its weight
    gradient, both float32."""

    @staticmethod
    def forward(ctx, x, w, axis):
        ctx.axis = axis
        ctx.save_for_backward(x, w)
        return _ring_rs(x, w, axis)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        axis = ctx.axis
        k, i = axis.size, axis.index
        chunk = g.shape[-2]
        dx = torch.empty(x.shape, dtype=torch.float32, device=x.device)
        dw = None
        wf = w.float()
        buf = g.contiguous()
        for step in range(k):
            src = (i - step) % k
            dx[..., src * chunk:(src + 1) * chunk, :] = _mm_t(buf, wf)
            part = _wgrad(x[..., src * chunk:(src + 1) * chunk, :], buf)
            dw = part if dw is None else dw + part
            if step != k - 1:
                buf = _ppermute(buf, axis, 1)
        return dx.to(x.dtype), dw.to(w.dtype), None


class _RingAllGatherMatmul(torch.autograd.Function):
    """Its backward is the transposed ring: the input gradient's float32
    partial products of each chunk hop left and are summed on the way
    (a reduce-scatter ring, as :func:`ring_reducescatter_matmul`); the
    weight gradient sums the forward's buffers against their rows of
    the cotangent, in float32."""

    @staticmethod
    def forward(ctx, x, w, axis):
        ctx.axis = axis
        bufs = [] if any(ctx.needs_input_grad[:2]) else None
        out = _ring_ag(x, w, axis, keep=bufs)
        if bufs is not None:
            ctx.save_for_backward(w, *bufs)
        return out

    @staticmethod
    def backward(ctx, g):
        w, *bufs = ctx.saved_tensors
        axis = ctx.axis
        k, i = axis.size, axis.index
        chunk = bufs[0].shape[-2]
        dw = None
        for step, buf in enumerate(bufs):
            src = (i - step) % k
            part = _wgrad(buf, g[..., src * chunk:(src + 1) * chunk, :])
            dw = part if dw is None else dw + part
        acc = None
        wf = w.float()
        for step in range(k):
            c = (i + step + 1) % k
            part = _mm_t(g[..., c * chunk:(c + 1) * chunk, :], wf)
            acc = part if acc is None else acc + part
            if step != k - 1:
                acc = _ppermute(acc, axis, -1)
        return acc.to(bufs[0].dtype), dw.to(w.dtype), None


class _AllReduceMatmul(torch.autograd.Function):
    """matmul -> psum (-> this rank's chunk); its backward is the
    transposes in reverse: the chunk's cotangent zero-padded to the
    sequence, psummed (float32), then the two products."""

    @staticmethod
    def forward(ctx, x, w, axis, scatter_seq):
        ctx.axis, ctx.scatter_seq = axis, scatter_seq
        ctx.save_for_backward(x, w)
        full = _psum(_mm(x, w), axis)
        if scatter_seq:
            chunk = _seq_chunk_of(x.shape[-2], axis)
            full = full[..., axis.index * chunk:(axis.index + 1) * chunk, :]
        return full

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        axis = ctx.axis
        if ctx.scatter_seq:
            chunk = g.shape[-2]
            full = torch.zeros((*g.shape[:-2], x.shape[-2], g.shape[-1]),
                               dtype=torch.float32, device=g.device)
            full[..., axis.index * chunk:(axis.index + 1) * chunk, :] = g
        else:
            full = g.contiguous()
        full = _psum(full, axis)
        return (_mm_t(full, w.float()).to(x.dtype),
                _wgrad(x, full).to(w.dtype),
                None, None)


class _AllGatherMatmul(torch.autograd.Function):
    """all-gather(x) -> matmul; its backward: the gathered input's
    float32 gradient reduce-scattered (:func:`psum_scatter`), and the
    weight gradient over the gathered rows."""

    @staticmethod
    def forward(ctx, x, w, axis):
        ctx.axis = axis
        xg = _all_gather(x, axis, dim=x.dim() - 2)
        ctx.save_for_backward(xg, w)
        ctx.dtype = x.dtype
        return _mm(xg, w)

    @staticmethod
    def backward(ctx, g):
        xg, w = ctx.saved_tensors
        dx = _psum_scatter(_mm_t(g, w.float()), ctx.axis, dim=g.dim() - 2)
        return dx.to(ctx.dtype), _wgrad(xg, g).to(w.dtype), None


def ring_reducescatter_matmul(x: torch.Tensor, w: torch.Tensor, axis,
                              tail: Tail = None) -> torch.Tensor:
    """Row-parallel matmul with on-the-move reduction.

    Per-rank shapes: ``x (..., S, K_local)``, ``w (K_local, N)``; returns
    ``(..., S/k, N)``, this rank's sequence chunk fully reduced over the
    contraction dim, with ``tail`` applied on the final hop.  At step
    ``step`` rank i adds its partial product of chunk ``(i + step + 1) %
    k`` to the float32 sum it holds and sends the sum left (to i - 1),
    except after the last step; chunk i ends on rank i.  Its gradient
    is the transposed ring (:class:`_RingReduceScatterMatmul`)."""
    return _finish(_RingReduceScatterMatmul.apply(x, w, axis), tail, x.dtype)


def ring_allgather_matmul(x: torch.Tensor, w: torch.Tensor, axis,
                          tail: Tail = None) -> torch.Tensor:
    """Column-parallel matmul with the input streamed around the ring.

    Per-rank shapes: ``x (..., S/k, K)`` (sequence-sharded), ``w (K,
    N_local)``; returns ``(..., S, N_local)``.  The local chunk orbits
    right (i to i + 1); at step ``step`` the buffer holds the tokens of
    index ``(i - step) % k``, whose product lands at that chunk.  Its
    gradient is the transposed ring (:class:`_RingAllGatherMatmul`)."""
    return _finish(_RingAllGatherMatmul.apply(x, w, axis), tail, x.dtype)


# ---------------------------------------------------------------------------
# Conventional baselines (the external accumulator the paper replaces)
# ---------------------------------------------------------------------------


def allreduce_matmul(x: torch.Tensor, w: torch.Tensor, axis,
                     tail: Tail = None, scatter_seq: bool = True
                     ) -> torch.Tensor:
    """matmul -> psum (-> this rank's sequence chunk): the conventional
    row-parallel linear."""
    return _finish(_AllReduceMatmul.apply(x, w, axis, scatter_seq), tail,
                   x.dtype)


def allgather_matmul(x: torch.Tensor, w: torch.Tensor, axis,
                     tail: Tail = None) -> torch.Tensor:
    """all-gather(x) -> matmul: the conventional column-parallel linear."""
    return _finish(_AllGatherMatmul.apply(x, w, axis), tail, x.dtype)


def up_matmul(x, w, *, axis, reduction: str, tail: Tail = None):
    """Column-parallel (sequence-sharded in, feature-sharded out)."""
    fn = ring_allgather_matmul if reduction == "ring" else allgather_matmul
    return fn(x, w, axis, tail=tail)


def down_matmul(x, w, *, axis, reduction: str, tail: Tail = None):
    """Row-parallel (feature-sharded in, sequence-sharded out)."""
    fn = ring_reducescatter_matmul if reduction == "ring" \
        else allreduce_matmul
    return fn(x, w, axis, tail=tail)


# ---------------------------------------------------------------------------
# Decode attention over a sharded KV cache: the group-sum merge for softmax
# ---------------------------------------------------------------------------


def lse_merge_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, valid: torch.Tensor,
                               axis, softcap: Optional[float] = None
                               ) -> torch.Tensor:
    """One-token attention against a KV cache sharded on its sequence
    dim over ``axis``; the partial softmax statistics merge by the
    log-sum-exp trick (flash-decode).

    q: (B, H, D); k_cache / v_cache: (B, H, S_local, D); valid:
    (B, S_local) bool, the filled slots.  Returns (B, H, D) in q's
    dtype.  A shard with no valid slot contributes nothing."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhd,bhsd->bhs", q.float(), k_cache.float()) * scale
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    mask = valid[:, None, :]
    s = torch.where(mask, s, torch.full_like(s, float("-inf")))
    m_local = torch.amax(s, dim=-1, keepdim=True)
    m_local = torch.where(torch.isfinite(m_local), m_local,
                          torch.full_like(m_local, -1e30))
    p = torch.where(mask, torch.exp(s - m_local), torch.zeros_like(s))
    num = torch.einsum("bhs,bhsd->bhd", p, v_cache.float())
    den = torch.sum(p, dim=-1)
    m_global = pmax(m_local, axis)
    corr = torch.exp(m_local - m_global)
    num = psum(num * corr, axis)
    den = psum(den * corr[..., 0], axis)
    return (num / torch.clamp_min(den, 1e-30)[..., None]).to(q.dtype)
