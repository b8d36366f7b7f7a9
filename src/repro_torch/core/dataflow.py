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
:func:`psum`, :func:`pmax`, :func:`all_gather` (tiled) and
:func:`all_to_all` (tiled).  On an axis of size 1 each is the identity.

The host-copy transport lives here and only here: on a gloo axis built
with ``host_copies=True``, each collective copies its CUDA operand to a
host buffer (pinned memory), runs on the host and copies the result
back (``TRAFFIC["host_copies"]`` counts the round trips).  A CUDA tensor on
a gloo axis without ``host_copies`` raises.  ``TRAFFIC["bytes_sent"]``
counts what this rank sends by the ring algorithm of each collective:
a ppermute its operand, an all-gather ``(k - 1)`` local parts, an
all-reduce ``2 (k - 1) / k`` of its operand, an all-to-all ``(k - 1) /
k`` of it.

The products keep the reference's float32 output
(``preferred_element_type``): a bfloat16 partial product reaches the
ring's float32 sum unrounded, and only the finished sum is rounded to
the operands' dtype.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

Tail = Optional[Callable[[torch.Tensor], torch.Tensor]]

#: this process's collectives, the bytes it sent by the ring algorithm of
#: each, and the host round trips of the gloo transport on CUDA tensors
TRAFFIC = {"collectives": 0, "bytes_sent": 0, "host_copies": 0}


def reset_traffic() -> None:
    for key in TRAFFIC:
        TRAFFIC[key] = 0


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


def _from_wire(t: torch.Tensor, dev) -> torch.Tensor:
    return t if dev is None else t.to(dev, non_blocking=t.is_pinned())


def _count(nbytes: float) -> None:
    TRAFFIC["collectives"] += 1
    TRAFFIC["bytes_sent"] += int(nbytes)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def ppermute(x: torch.Tensor, axis, shift: int) -> torch.Tensor:
    """Each rank at index i sends ``x`` to index ``i + shift`` and
    returns what index ``i - shift`` sent (mod the axis size): the
    reference's ``lax.ppermute`` with ``perm = [(j, (j + shift) % k)]``."""
    import torch.distributed as dist

    k = axis.size
    if k == 1:
        return x
    wire, dev = _to_wire(x, axis)
    out = _host_like(wire)
    dst = axis.ranks[(axis.index + shift) % k]
    src = axis.ranks[(axis.index - shift) % k]
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, wire, dst, group=axis.group),
        dist.P2POp(dist.irecv, out, src, group=axis.group)])
    for req in reqs:
        req.wait()
    _count(_nbytes(wire))
    return _from_wire(out, dev)


def _all_reduce(x: torch.Tensor, axis, op) -> torch.Tensor:
    import torch.distributed as dist

    k = axis.size
    if k == 1:
        return x
    wire, dev = _to_wire(x, axis)
    dist.all_reduce(wire, op=op, group=axis.group)
    _count(2 * (k - 1) / k * _nbytes(wire))
    return _from_wire(wire, dev)


def psum(x: torch.Tensor, axis) -> torch.Tensor:
    """Sum of ``x`` over the axis (``lax.psum``)."""
    import torch.distributed as dist

    return _all_reduce(x, axis, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, axis) -> torch.Tensor:
    """Elementwise max of ``x`` over the axis (``lax.pmax``)."""
    import torch.distributed as dist

    return _all_reduce(x, axis, dist.ReduceOp.MAX)


def all_gather(x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in index order
    (``lax.all_gather(..., tiled=True)``)."""
    import torch.distributed as dist

    k = axis.size
    if k == 1:
        return x
    wire, dev = _to_wire(x, axis)
    parts = [torch.empty_like(wire) for _ in range(k)]
    dist.all_gather(parts, wire, group=axis.group)
    _count((k - 1) * _nbytes(wire))
    return _from_wire(torch.cat(parts, dim=dim), dev)


def all_to_all(x: torch.Tensor, axis, split_axis: int, concat_axis: int
               ) -> torch.Tensor:
    """``lax.all_to_all(..., tiled=True)``: ``x`` cut into k equal parts
    along ``split_axis``, part j sent to index j, and the parts received
    concatenated along ``concat_axis`` in sender order."""
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
    out = _host_like(wire)
    dist.all_to_all_single(out, wire, group=axis.group)
    _count((k - 1) / k * _nbytes(wire))
    out = _from_wire(out, dev)
    return torch.cat([out[j].movedim(0, split_axis) for j in range(k)],
                     dim=concat_axis)


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


def ring_reducescatter_matmul(x: torch.Tensor, w: torch.Tensor, axis,
                              tail: Tail = None) -> torch.Tensor:
    """Row-parallel matmul with on-the-move reduction.

    Per-rank shapes: ``x (..., S, K_local)``, ``w (K_local, N)``; returns
    ``(..., S/k, N)``, this rank's sequence chunk fully reduced over the
    contraction dim, with ``tail`` applied on the final hop.  At step
    ``step`` rank i adds its partial product of chunk ``(i + step + 1) %
    k`` to the float32 sum it holds and sends the sum left (to i - 1),
    except after the last step; chunk i ends on rank i."""
    k, i = axis.size, axis.index
    s = x.shape[-2]
    if s % k:
        raise ValueError(f"sequence dim {s} must divide the "
                         f"{axis.name!r} axis {k}")
    chunk = s // k
    acc = None
    for step in range(k):
        c = (i + step + 1) % k
        part = _mm(x[..., c * chunk:(c + 1) * chunk, :], w)
        acc = part if acc is None else acc + part
        if step != k - 1:
            acc = ppermute(acc, axis, -1)
    return _finish(acc, tail, x.dtype)


def ring_allgather_matmul(x: torch.Tensor, w: torch.Tensor, axis,
                          tail: Tail = None) -> torch.Tensor:
    """Column-parallel matmul with the input streamed around the ring.

    Per-rank shapes: ``x (..., S/k, K)`` (sequence-sharded), ``w (K,
    N_local)``; returns ``(..., S, N_local)``.  The local chunk orbits
    right (i to i + 1); at step ``step`` the buffer holds the tokens of
    index ``(i - step) % k``, whose product lands at that chunk."""
    k, i = axis.size, axis.index
    chunk = x.shape[-2]
    out = torch.zeros((*x.shape[:-2], chunk * k, w.shape[-1]),
                      dtype=torch.float32, device=x.device)
    buf = x
    for step in range(k):
        src = (i - step) % k
        out[..., src * chunk:(src + 1) * chunk, :] = _mm(buf, w)
        if step != k - 1:
            buf = ppermute(buf, axis, 1)
    return _finish(out, tail, x.dtype)


# ---------------------------------------------------------------------------
# Conventional baselines (the external accumulator the paper replaces)
# ---------------------------------------------------------------------------


def allreduce_matmul(x: torch.Tensor, w: torch.Tensor, axis,
                     tail: Tail = None, scatter_seq: bool = True
                     ) -> torch.Tensor:
    """matmul -> psum (-> this rank's sequence chunk): the conventional
    row-parallel linear."""
    k, i = axis.size, axis.index
    full = psum(_mm(x, w), axis)
    if scatter_seq:
        s = x.shape[-2]
        if s % k:
            raise ValueError(f"sequence dim {s} must divide the "
                             f"{axis.name!r} axis {k}")
        chunk = s // k
        full = full[..., i * chunk:(i + 1) * chunk, :]
    return _finish(full, tail, x.dtype)


def allgather_matmul(x: torch.Tensor, w: torch.Tensor, axis,
                     tail: Tail = None) -> torch.Tensor:
    """all-gather(x) -> matmul: the conventional column-parallel linear."""
    xg = all_gather(x, axis, dim=x.dim() - 2)
    return _finish(_mm(xg, w), tail, x.dtype)


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
