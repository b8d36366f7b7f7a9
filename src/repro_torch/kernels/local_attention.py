"""Sliding-window (local) causal flash attention on Hopper.

Replaces ``src/repro/kernels/local_attention.py::_attn_kernel`` (reached
through ``local_attention``): token i attends to keys (i - window, i],
scores ``q . k * DQK^-0.5`` with an optional ``tanh(s / cap) * cap``, an
online softmax in float32 with ``p`` rounded to v's type before
``p . v``, and the output in q's type.  A global (full causal) layer
is the case ``window = S``.  q and k share a head dim DQK; v's, DV, may
differ (MLA: DQK = 128 + 64 rope dims, DV = 128), and the output is DV
wide.

Two kernels, chosen by dtype (a dispatch, not a fallback: a failed
build or launch of either raises):

* bfloat16 — tensor cores (``wgmma`` bf16 with f32 accumulators for
  both products), K/V streamed by TMA through a shared-memory ring, key
  tiles and chunks that hold no unmasked pair skipped, the heaviest
  query tiles launched first; ``LAUNCHES["local_attention"]``;
* float32 — CUDA cores (float32 FMAs, so it holds the plain version to
  2e-5): float4 register tiles, K/V copied by ``cp.async`` under the
  products, tiles with no masked pair left unmasked;
  ``LAUNCHES["local_attention_f32"]``.

Two entry points launch them:

* :func:`local_attention` — q, k, v (BH, S, D), the reference wrapper's
  layout (the GQA repeat done by the caller);
* :func:`grouped_local_attention` — q (B, S, H, DQK) with k
  (B, S, KV, DQK), v (B, S, KV, DV) and H a multiple of KV, the model's
  layout: head h reads kv head ``h // (H // KV)`` through strides, so no
  repeated or transposed copy is made.  Output (B, S, H, DV).

The CUDA source is ``csrc/local_attention.cu`` (its header notes what
bounds the kernels on the H100 and what each design does about it),
built with ``nvcc`` for ``sm_90a`` at first use
(``kernels/_build.py``) and loaded with ``ctypes``.  On a CPU tensor
the wrappers compute :func:`grouped_local_attention_plain`, a dense
masked softmax in plain PyTorch that autograd differentiates; on a CUDA
tensor they launch the kernel or raise; a (DQK, DV) pair the source
does not instantiate (``HEAD_DIM_PAIRS``) raises before any launch.
Under an active ``analysis/op_stats.py::OpStats`` each launch on a CUDA
tensor also reports its work (:func:`attn_work`; the backward's
:func:`bwd_work` and :func:`bwd_bytes`: the formulas ``chip_smoke.py``
bounds the kernels by); on fake CUDA tensors (a dry run,
``launch/dryrun_lib.py``) the wrappers return the empty outputs in place
of the launch, and with no counter active a fake tensor raises.

The gradient.  When grad is enabled and q, k or v requires it, a CUDA
call goes through :class:`LocalAttentionFn`: its forward launches the
same kernel, and its backward launches :func:`local_attention_bwd`
(``csrc/local_attention_bwd.cu``, ``LAUNCHES["local_attention_bwd"]``
once per backward), which recomputes each row's log-sum-exp and gives
dq, dk and dv.  It is built for the (q/k, v) head-dim pairs
``BWD_HEAD_DIM_PAIRS`` (those of the forward: (D, D) for ``HEAD_DIMS``
and MLA's (192, 128)) on one of two routes, which :func:`bwd_route`
chooses by (dtype, pair): bfloat16 at (64, 64), (128, 128), (256, 256)
and (192, 128) on the tensor cores (``wgmma``, TMA), float32 at every
pair and bfloat16 at (16, 16) on the CUDA cores.  A call that needs the
gradient at another pair raises before any launch rather than return an
output with no ``grad_fn``.
:func:`local_attention_bwd_plain` and
:func:`local_attention_row_stats_plain` are its plain versions.

:func:`tile_schedule` counts what a kernel visits, skips and computes at
a given (S, window): the bfloat16 kernel's tiles by default, the
float32 kernel's with ``F32_TILES``; :func:`bwd_tile_schedule` lists the
tensor-core backward's tile walks, :func:`bwd_cc_schedule` the CUDA-core
backward's, which :func:`bwd_cc_parts` splits over clusters and
:func:`bwd_cc_deal` deals to them.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.analysis import op_stats
from repro_torch.kernels import _build

SOURCE = _build.CSRC / "local_attention.cu"
#: head dims the kernel is instantiated for: the reduced configs' 16 and
#: the served models' 64 (qwen2), 128 (gemma2, minitron), 256 (gemma3)
HEAD_DIMS = (16, 64, 128, 256)
#: the (q/k, v) head-dim pairs built: each of HEAD_DIMS with itself, and
#: deepseek-v3's MLA, q and k 128 + 64 rope dims wide against v's 128
HEAD_DIM_PAIRS = tuple((d, d) for d in HEAD_DIMS) + ((192, 128),)
DTYPES = (torch.float32, torch.bfloat16)
MASKED = -1e30
#: kernel launches by kernel (bfloat16 tensor cores, float32 CUDA
#: cores); the wrapper adds one where it launches, and nowhere else
LAUNCHES = {"local_attention": 0, "local_attention_f32": 0,
            "local_attention_bwd": 0}
BWD_SOURCE = _build.CSRC / "local_attention_bwd.cu"
#: the (q/k, v) head-dim pairs the backward kernel is built for: the
#: forward's, each of HEAD_DIMS with itself and MLA's (192, 128)
BWD_HEAD_DIM_PAIRS = tuple((d, d) for d in HEAD_DIMS) + ((192, 128),)
#: what a call that needs a gradient the card cannot give raises with
NO_BWD = ("the attention backward kernel is built for the (q/k, v) "
          f"head-dim pairs {BWD_HEAD_DIM_PAIRS}")
#: the bfloat16 kernel's tiling (``tc::`` in the CUDA source): query rows
#: per block, keys per tile, rows per warpgroup, keys per chunk of P V
TC_BLOCK_Q, TC_BLOCK_K, TC_ROWS, TC_CHUNK = 128, 64, 64, 16
#: the float32 kernel's (``simt::``) in :func:`tile_schedule`'s terms:
#: 64 query rows per block, 64 keys per tile, classified per warp of 8
#: rows, which runs P V on the groups of 4 keys that hold a pair of its
#: rows' windows
F32_BLOCK_Q, F32_BLOCK_K = 64, 64
F32_TILES = dict(block_q=F32_BLOCK_Q, block_k=F32_BLOCK_K, rows=8, chunk=4)
#: the tensor-core backward's query rows and keys per tile (``tcb`` in
#: the CUDA source)
BWD_TC_TILE = 64
#: head-dim pairs at which a bfloat16 backward runs on the tensor cores
BWD_TC_HEAD_DIM_PAIRS = ((64, 64), (128, 128), (256, 256), (192, 128))
#: the CUDA-core backward's query rows and keys per tile (``simt`` in the
#: CUDA source), and the most blocks a cluster splits a tile's walk over
BWD_CC_TILE, BWD_CC_MAX_PARTS = 32, 8
#: each backward route's three kernels, as the profiler names them
#: (statistics, dk / dv, dq)
BWD_KERNELS = {"tensor_cores": ("tc_stats", "tc_dkdv", "tc_dq"),
               "cuda_cores": ("cc_stats", "cc_dkdv", "cc_dq")}


class TileSchedule(NamedTuple):
    """What a kernel does for one (batch, head) at (S, window).
    ``visited``: (query tile, key tile) pairs the blocks walk.  Per group
    of rows that classifies together (a warpgroup of 64 in the bfloat16
    kernel, a warp's 8 in the float32 one) and visited key tile:
    ``skipped`` (no chunk of P V can hold an unmasked pair: neither
    product runs), ``full`` (no masked pair: the mask is not applied)
    and ``partial``.  ``s_pairs``: (row, key) pairs of Q K^T, rows x
    keys per tile not skipped; ``pv_pairs``: pairs of P V, rows x chunk
    per live chunk; ``unmasked_pairs``: the pairs the function needs."""
    visited: int
    full: int
    partial: int
    skipped: int
    s_pairs: int
    pv_pairs: int
    unmasked_pairs: int

    def operations(self, dqk: int, dv: Optional[int] = None) -> int:
        """Multiply-add operations (2 each) the two products run at q/k
        head dim ``dqk`` (Q K^T) and v head dim ``dv`` (P V; ``dqk`` when
        not given)."""
        return 2 * (dqk * self.s_pairs
                    + (dqk if dv is None else dv) * self.pv_pairs)


def tile_schedule(s: int, window: int, block_q: int = TC_BLOCK_Q,
                  block_k: int = TC_BLOCK_K, rows: int = TC_ROWS,
                  chunk: int = TC_CHUNK) -> TileSchedule:
    """A kernel's tile classification, made as the CUDA source makes it,
    counted for one (batch, head): query rows per block, keys per tile,
    rows that classify together, keys per chunk of P V.  The defaults are
    the bfloat16 kernel's; ``tile_schedule(s, window, **F32_TILES)`` is
    the float32 kernel's."""
    window = min(int(window), s)
    visited = full = partial = skipped = s_pairs = pv_pairs = 0
    for q_lo in range(0, s, block_q):
        q_hi = min(q_lo + block_q, s) - 1
        for t in range(max(0, q_lo - window + 1) // block_k,
                       q_hi // block_k + 1):
            visited += 1
            k_lo = t * block_k
            for r_lo in range(q_lo, min(q_lo + block_q, s), rows):
                r_hi = min(r_lo + rows - 1, s - 1)
                live = sum(1 for c in range(k_lo, k_lo + block_k, chunk)
                           if c <= r_hi and c + chunk - 1 > r_lo - window)
                if not live:
                    skipped += 1
                    continue
                if (k_lo + block_k - 1 <= r_lo
                        and k_lo > r_lo + rows - 1 - window):
                    full += 1
                else:
                    partial += 1
                s_pairs += rows * block_k
                pv_pairs += rows * chunk * live
    unmasked = window * (window + 1) // 2 + (s - window) * window
    return TileSchedule(visited, full, partial, skipped, s_pairs, pv_pairs,
                        unmasked)


def bwd_route(dtype: torch.dtype, d: int, dv: Optional[int] = None) -> str:
    """The backward kernels a CUDA call at (dtype, q/k head dim ``d``, v
    head dim ``dv``, ``d`` when not given) launches: ``"tensor_cores"``
    for bfloat16 at a pair of ``BWD_TC_HEAD_DIM_PAIRS``, ``"cuda_cores"``
    for float32 and for bfloat16 at (16, 16) (reduced configs only).
    The C entry point dispatches by the same rule; this is the one place
    the wrappers ask, before any launch.  Raises RuntimeError
    (``NO_BWD``) at a pair with no backward: any (DQK, DV) not in
    ``BWD_HEAD_DIM_PAIRS``."""
    dv = d if dv is None else dv
    if (d, dv) not in BWD_HEAD_DIM_PAIRS:
        raise RuntimeError(f"head dims (q/k {d}, v {dv}) need a gradient: "
                           f"{NO_BWD}")
    if dtype == torch.bfloat16 and (d, dv) in BWD_TC_HEAD_DIM_PAIRS:
        return "tensor_cores"
    return "cuda_cores"


def dkdv_parts(blocks: int, sms: int, s: int, window: int) -> int:
    """Blocks per key tile of ``tc_dkdv``, as the CUDA source picks them:
    2 (a cluster that splits the key tile's walk) when the grid of
    ``blocks`` (batch x kv heads x key tiles) fits the card's ``sms`` in
    one wave and the window covers more than half of S, else 1."""
    return 2 if blocks <= sms and 2 * min(int(window), s) > s else 1


class BwdTileSchedule(NamedTuple):
    """The tensor-core backward's tile walks for one (batch, kv head) at
    (S, window, group), tiles of ``BWD_TC_TILE``.  ``rows``: the (query
    tile, key tile) pairs that ``tc_stats`` and ``tc_dq`` visit, a block
    per query tile, in launch order (query tiles in reverse) and each
    block's key tiles in order; per query head.  ``keys``: the (key tile,
    block, head of the group, query tile) steps of ``tc_dkdv``: per key
    tile a cluster of ``parts`` blocks (:func:`dkdv_parts`) shares the
    walk over the group's heads, each over its query tiles in order, in
    consecutive shares, and block 0 adds block 1's partial sums to its
    own.  ``full``: the (query tile, key tile) pairs of ``rows`` that
    hold no masked pair (the kernels skip the mask there); ``partial``:
    the others."""
    rows: list
    keys: list
    full: int
    partial: int


def bwd_tile_schedule(s: int, window: int, group: int = 1, parts: int = 1,
                      tile: int = BWD_TC_TILE) -> BwdTileSchedule:
    """The walks of ``tc_stats`` / ``tc_dq`` and ``tc_dkdv``, made as the
    CUDA source makes them (see :class:`BwdTileSchedule`)."""
    window = min(int(window), s)
    n = -(-s // tile)
    rows, keys = [], []
    full = 0
    for qt in reversed(range(n)):
        q0 = qt * tile
        for kt in range(max(0, q0 - window + 1) // tile,
                        min(q0 + tile - 1, s - 1) // tile + 1):
            rows.append((qt, kt))
            k0 = kt * tile
            full += (k0 + tile - 1 <= q0 and q0 + tile - 1 - k0 < window
                     and q0 + tile - 1 < s)
    for kt in range(n):
        last = min(s - 1, kt * tile + tile - 2 + window) // tile
        nq = last - kt + 1
        steps = group * nq
        for part in range(parts):
            keys += [(kt, part, i // nq, kt + i % nq)
                     for i in range(steps * part // parts,
                                    steps * (part + 1) // parts)]
    return BwdTileSchedule(rows, keys, full, len(rows) - full)


def bwd_cc_parts(tiles: int, sms: int) -> int:
    """Blocks a tile's walk is split over in the CUDA-core backward, as
    ``walk_parts`` in the CUDA source picks them: while ``tiles``, one
    block each (batch x heads x query tiles for ``cc_stats`` and
    ``cc_dq``, batch x kv heads x key tiles for ``cc_dkdv``), leave some
    of the card's ``sms`` idle, the fewest that fill them rounded up to a
    power of two, up to ``BWD_CC_MAX_PARTS``; else 1."""
    parts = 1
    while parts < BWD_CC_MAX_PARTS and parts * tiles < sms:
        parts *= 2
    return parts


def bwd_cc_deal(tiles: int, clusters: int) -> list:
    """The tiles each cluster of a CUDA-core backward launch walks, as
    ``dealt`` in the CUDA source deals them: the grid holds ``clusters``
    (as many as the card holds at once, at most one a tile), and tile r
    x clusters + c of the heaviest-first order goes to cluster c on even
    rounds r and to cluster clusters - 1 - c on odd ones.  The kernels'
    heaviest-first order: query tiles in reverse, each over every
    (batch, head), for ``cc_stats`` and ``cc_dq``; key tiles in order,
    each over every (batch, kv head), for ``cc_dkdv``."""
    clusters = min(clusters, tiles)
    out = [[] for _ in range(clusters)]
    for tile in range(tiles):
        r, c = divmod(tile, clusters)
        out[c if r % 2 == 0 else clusters - 1 - c].append(tile)
    return out


class BwdCcSchedule(NamedTuple):
    """The CUDA-core backward's walks for one (batch, kv head) at (S,
    window, group), tiles of ``BWD_CC_TILE``, per query head where a
    walk is per head.  ``stats``: the (query tile, block, team, key tile)
    steps of ``cc_stats``; ``dq``: the (query tile, block, key tile)
    steps of ``cc_dq``: a block (or a cluster of ``row_parts``) per query
    tile, query tiles in reverse, the cluster's blocks walking
    consecutive shares of the tile's key tiles, in order, and in
    ``cc_stats`` the block's two teams taking every other key tile of its
    share.  ``keys``: the (key tile, block, head of the group, query
    tile) steps of ``cc_dkdv``: a cluster of ``key_parts`` blocks per key
    tile shares the walk over the group's heads, each over its query
    tiles in order.  A cluster's partial sums are added in block order
    (block 0's first).  ``full``: the (query tile, key tile)
    pairs of the row walk that hold no masked pair (the kernels skip the
    mask there); ``partial``: the others."""
    stats: list
    dq: list
    keys: list
    full: int
    partial: int


def _shares(steps: int, parts: int, tile: int):
    """Each block's consecutive share of the walk of ``steps`` of the
    tile at ``tile`` in the heaviest-first order, in block order, as the
    CUDA source's ``share`` deals them: block p takes share (p + tile) %
    parts."""
    return [range(steps * ((p + tile) % parts) // parts,
                  steps * ((p + tile) % parts + 1) // parts)
            for p in range(parts)]


def bwd_cc_schedule(s: int, window: int, group: int = 1, row_parts: int = 1,
                    key_parts: int = 1, seq: int = 0, seqs: int = 1,
                    tile: int = BWD_CC_TILE) -> BwdCcSchedule:
    """The walks of ``cc_stats``, ``cc_dkdv`` and ``cc_dq``, made as the
    CUDA source makes them (see :class:`BwdCcSchedule`), for sequence
    ``seq`` of ``seqs`` (the (batch, head) of the row walks and the
    (batch, kv head) of the key walk, in the kernels' order: which block
    of a cluster takes which share turns with the tile's place in the
    heaviest-first order of all sequences' tiles)."""
    window = min(int(window), s)
    n = -(-s // tile)
    stats, dq, keys = [], [], []
    full = partial = 0
    for qt in reversed(range(n)):
        q0 = qt * tile
        t0 = max(0, q0 - window + 1) // tile
        nk = min(q0 + tile - 1, s - 1) // tile - t0 + 1
        for kt in range(t0, t0 + nk):
            k0 = kt * tile
            if (k0 + tile - 1 <= q0 and q0 + tile - 1 - k0 < window
                    and q0 + tile - 1 < s):
                full += 1
            else:
                partial += 1
        for part, steps in enumerate(
                _shares(nk, row_parts, (n - 1 - qt) * seqs + seq)):
            dq += [(qt, part, t0 + i) for i in steps]
            stats += [(qt, part, j % 2, t0 + i)
                      for j, i in enumerate(steps)]
    for kt in range(n):
        nq = min(s - 1, kt * tile + tile - 2 + window) // tile - kt + 1
        for part, steps in enumerate(
                _shares(group * nq, key_parts, kt * seqs + seq)):
            keys += [(kt, part, i // nq, kt + i % nq) for i in steps]
    return BwdCcSchedule(stats, dq, keys, full, partial)


def build() -> Tuple[Path, str]:
    """Compile the kernel library if this source has not been built yet.

    Returns (library path, compiler log)."""
    return _build.build(SOURCE)


def build_bwd() -> Tuple[Path, str]:
    """Compile the backward kernel's library if this source has not been
    built yet.  Returns (library path, compiler log)."""
    return _build.build(BWD_SOURCE)


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = ctypes.CDLL(str(build()[0]))
    fn = lib.local_attention_launch
    ptr, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_float)
    fn.argtypes = ([ptr, i64, i64, i64] * 4
                   + [i32] * 7 + [f32, f32, i32, ptr])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_launcher():
    lib = ctypes.CDLL(str(build_bwd()[0]))
    fn = lib.local_attention_bwd_launch
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [ptr] * 10 + [i32] * 7 + [f32, f32, i32, ptr]
    fn.restype = ctypes.c_int
    return fn


def _pairs(s: int, window: int) -> int:
    """Unmasked (query, key) pairs of one head at sequence length ``s``."""
    w = min(int(window), s)
    return w * (w + 1) // 2 + (s - w) * w


def attn_work(q, k, v, window) -> Tuple[int, int]:
    """(operations, bytes) one forward call must do: 2 * (DQK + DV) per
    unmasked (query, key) pair (Q K^T at q's head dim, P V at v's); q, k,
    v read once, the (B, S, H, DV) output written once.  The kernel's
    bound (``chip_smoke.py``) and its report to an active
    ``analysis/op_stats.py::OpStats`` both use it."""
    b, s, h, d = q.shape
    dv = v.shape[3]
    nbytes = (q.numel() + k.numel() + v.numel() + b * s * h * dv
              ) * q.element_size()
    return 2 * (d + dv) * _pairs(s, window) * b * h, nbytes


def bwd_work(q, window, dv=None) -> int:
    """Operations of one backward call at q (B, S, H, DQK) and v head dim
    ``dv`` (DQK when not given): per unmasked pair 2 DQK for each of the
    statistics' and the gradient's Q K^T, dK and dQ, and 2 DV for dP and
    dV (12 D at DQK = DV)."""
    b, s, h, d = q.shape
    dv = d if dv is None else dv
    return (8 * d + 4 * dv) * _pairs(s, window) * b * h


def bwd_bytes(q, k, v) -> int:
    """Bytes one backward call must move: q, k, v, o and dO read once, dq,
    dk and dv written once (o and dO as wide as v)."""
    o = q.numel() // q.shape[3] * v.shape[3]
    return q.element_size() * (2 * q.numel() + 2 * k.numel()
                               + 2 * v.numel() + 2 * o)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int,
           softcap: Optional[float]) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(
            f"q (B, S, H, DQK), k (B, S, KV, DQK) and v (B, S, KV, DV): "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    if k.shape[:3] != v.shape[:3] or k.shape[0] != b or k.shape[1] != s \
            or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} vs k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if k.shape[2] < 1 or h % k.shape[2]:
        raise ValueError(f"{h} query heads on {k.shape[2]} kv heads")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must all be float32 or bfloat16: "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    if int(window) != window or window < 1:
        raise ValueError(f"window must be a positive integer: {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be positive or None: {softcap}")


def grouped_local_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, *, window: int,
                                  softcap: Optional[float] = None
                                  ) -> torch.Tensor:
    """The plain PyTorch version of :func:`grouped_local_attention`: a
    dense (S, S) float32 score matrix per head scaled by ``DQK^-0.5``,
    the window mask at ``-1e30``, a softmax, the probabilities rounded to
    v's type, and ``p . v`` in v's type at v's width."""
    _check(q, k, v, window, softcap)
    b, s, h, d = q.shape
    dv = v.shape[3]
    kvh = k.shape[2]
    qg = q.float().reshape(b, s, kvh, h // kvh, d).permute(0, 2, 3, 1, 4)
    kg = k.float().permute(0, 2, 1, 3).unsqueeze(2)     # (B, KV, 1, S, D)
    scores = torch.matmul(qg, kg.transpose(-1, -2)) * d ** -0.5
    if softcap is not None:
        scores = torch.tanh(scores / softcap) * softcap
    pos = torch.arange(s, device=q.device)
    keep = (pos[None, :] <= pos[:, None]) & (
        pos[None, :] > pos[:, None] - window)
    scores = torch.where(keep, scores, torch.full_like(scores, MASKED))
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.matmul(p, v.permute(0, 2, 1, 3).unsqueeze(2))  # (B,KV,G,S,DV)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, dv).to(q.dtype)


def grouped_local_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, window: int,
                            softcap: Optional[float] = None) -> torch.Tensor:
    """(B, S, H, DV) attention output of q (B, S, H, DQK) over k
    (B, S, KV, DQK) and v (B, S, KV, DV), causal within ``window``.

    CPU tensors take :func:`grouped_local_attention_plain`.  CUDA
    tensors launch the bfloat16 or the float32 kernel, by dtype
    (``LAUNCHES`` counts each); nothing falls back to the plain version
    on the card.  With grad enabled and an input that requires it, the
    launch goes through :class:`LocalAttentionFn`, whose backward is the
    backward kernel."""
    _check(q, k, v, window, softcap)
    if q.device.type == "cpu":
        return grouped_local_attention_plain(q, k, v, window=window,
                                             softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"local attention runs on cpu or cuda, not "
                         f"{q.device}")
    d, dv = q.shape[3], v.shape[3]
    if (d, dv) not in HEAD_DIM_PAIRS:
        raise ValueError(f"head dims (q/k {d}, v {dv}) not among the "
                         f"kernel's {HEAD_DIM_PAIRS}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        bwd_route(q.dtype, d, dv)  # raises where there is no backward
        return LocalAttentionFn.apply(q, k, v, window, softcap)
    return _launch(q, k, v, window, softcap)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int,
            softcap: Optional[float]) -> torch.Tensor:
    """One launch of the forward kernel of q's dtype on checked operands."""
    b, s, h, d = q.shape
    dv = v.shape[3]
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("q, k and v need unit stride along the head dim")
    bf16 = q.dtype == torch.bfloat16
    if -(-s // (TC_BLOCK_Q if bf16 else F32_BLOCK_Q)) > 65535:
        raise ValueError(f"(B, S, H) = ({b}, {s}, {h}) exceeds the kernel's "
                         f"grid")
    out = torch.empty((b, s, h, dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    name = "local_attention" if bf16 else "local_attention_f32"
    if op_stats.ACTIVE and op_stats.launch(name, attn_work(q, k, v, window),
                                           q, q.dtype):
        return out
    # both kernels copy rows in 16-byte pieces (TMA, cp.async), so rows
    # must start on 16 bytes: a view whose rows do not is copied once
    per16 = 16 // q.element_size()
    q, k, v = (t if t.data_ptr() % 16 == 0
               and all(st % per16 == 0 for st in t.stride()[:3])
               else t.clone(memory_format=torch.contiguous_format)
               for t in (q, k, v))
    launch = _launcher()
    operands = []  # pointer and (batch, seq, head) strides of each
    for t in (q, k, v, out):
        operands += [t.data_ptr(), t.stride(0), t.stride(1), t.stride(2)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(*operands, b, s, h, h // k.shape[2], d, dv,
                     min(int(window), s), d ** -0.5,
                     0.0 if softcap is None else float(softcap),
                     int(bf16), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    return out


class LocalAttentionFn(torch.autograd.Function):
    """The sliding-window attention on the card with its gradient: the
    forward kernel of q's dtype, then :func:`local_attention_bwd` from
    q, k, v, the output and its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, window, softcap):
        o = _launch(q, k, v, window, softcap)
        ctx.save_for_backward(q, k, v, o)
        ctx.window, ctx.softcap = window, softcap
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv = local_attention_bwd(q, k, v, o, do, window=ctx.window,
                                         softcap=ctx.softcap)
        return dq, dk, dv, None, None


def _heads_first(t: torch.Tensor, kvh: int) -> torch.Tensor:
    """(B, S, H, D) as float32 (B, KV, H / KV, S, D)."""
    b, s, h, d = t.shape
    return t.float().reshape(b, s, kvh, h // kvh, d).permute(0, 2, 3, 1, 4)


def _scores_plain(q, k, window, softcap):
    """(scores after the scale and the cap (B, KV, G, S, S), tanh's value
    or None, the window's mask (S, S)) in float32."""
    s = q.shape[1]
    d = q.shape[3]
    kvh = k.shape[2]
    kg = k.float().permute(0, 2, 1, 3).unsqueeze(2)     # (B, KV, 1, S, D)
    scores = torch.matmul(_heads_first(q, kvh), kg.transpose(-1, -2)) \
        * d ** -0.5
    t = None
    if softcap is not None:
        t = torch.tanh(scores / softcap)
        scores = t * softcap
    pos = torch.arange(s, device=q.device)
    keep = (pos[None, :] <= pos[:, None]) & (
        pos[None, :] > pos[:, None] - window)
    return scores, t, keep


def local_attention_row_stats_plain(q: torch.Tensor, k: torch.Tensor,
                                    o: torch.Tensor, do: torch.Tensor, *,
                                    window: int,
                                    softcap: Optional[float] = None
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel's statistics in plain PyTorch: each row's
    log-sum-exp over its window (masked scores at ``-1e30``) and
    ``D = dO . o``, both float32 (B, H, S)."""
    b, s, h, _ = q.shape
    scores, _, keep = _scores_plain(q, k, window, softcap)
    lse = torch.logsumexp(
        torch.where(keep, scores, torch.full_like(scores, MASKED)), dim=-1)
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1)   # (B, H, S)
    return lse.reshape(b, h, s), delta


def local_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              do: torch.Tensor, *, window: int,
                              softcap: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The plain version of :func:`local_attention_bwd`: the closed-form
    gradient, dense (S, S) per head in float32.  ``p = exp(s - lse)``,
    rounded to v's type for ``dV = p^T dO``; ``dS = p (dO V^T - D)``,
    times ``1 - tanh^2(s / cap)`` under a soft cap, then the scale; dQ
    = dS K and dK = dS^T Q, a kv head's group summed.  Outputs in the
    operands' types: dq (B, S, H, DQK), dk (B, S, KV, DQK) and dv (B, S,
    KV, DV).  The heads are independent: a call on a slice of them gives
    that slice of the gradients (``chip_smoke.py`` runs a wide call head
    slice by head slice)."""
    _check(q, k, v, window, softcap)
    b, s, h, d = q.shape
    kvh = k.shape[2]
    scores, t, keep = _scores_plain(q, k, window, softcap)
    lse, delta = local_attention_row_stats_plain(q, k, o, do, window=window,
                                                 softcap=softcap)
    g = h // kvh
    lse = lse.reshape(b, kvh, g, s, 1)
    delta = delta.reshape(b, kvh, g, s, 1)
    zero = torch.zeros((), device=q.device)
    p = torch.where(keep, torch.exp(scores - lse), zero)
    dog = _heads_first(do, kvh)                           # (B, KV, G, S, D)
    vg = v.float().permute(0, 2, 1, 3).unsqueeze(2)       # (B, KV, 1, S, D)
    ds = p * (torch.matmul(dog, vg.transpose(-1, -2)) - delta)
    if t is not None:
        ds = ds * (1.0 - t * t)
    ds = torch.where(keep, ds * d ** -0.5, zero)
    p = p.to(v.dtype).float()
    dv = torch.matmul(p.transpose(-1, -2), dog).sum(2)    # (B, KV, S, D)
    dk = torch.matmul(ds.transpose(-1, -2), _heads_first(q, kvh)).sum(2)
    dq = torch.matmul(ds, k.float().permute(0, 2, 1, 3).unsqueeze(2))
    return (dq.permute(0, 3, 1, 2, 4).reshape(b, s, h, d).to(q.dtype),
            dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


def local_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, *, window: int,
                        softcap: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`grouped_local_attention` at q (B, S, H,
    DQK), k (B, S, KV, DQK), v (B, S, KV, DV), its output o and the
    output's gradient do (B, S, H, DV).

    CPU tensors take :func:`local_attention_bwd_plain`.  CUDA tensors
    launch the three kernels of the route :func:`bwd_route` names for
    (dtype, DQK, DV) (``LAUNCHES["local_attention_bwd"]`` counts each
    call), at the pairs of ``BWD_HEAD_DIM_PAIRS``; another pair raises
    before any launch."""
    _check(q, k, v, window, softcap)
    if o.shape != q.shape[:3] + v.shape[3:] or do.shape != o.shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must "
                         f"be (B, S, H, DV) for q {tuple(q.shape)}")
    if q.device.type == "cpu":
        return local_attention_bwd_plain(q, k, v, o, do, window=window,
                                         softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"local attention runs on cpu or cuda, not "
                         f"{q.device}")
    b, s, h, d = q.shape
    dv_dim = v.shape[3]
    bwd_route(q.dtype, d, dv_dim)  # raises where there is no backward
    if b * h > 65535:
        raise ValueError(f"(B, S, H) = ({b}, {s}, {h}) exceeds the backward "
                         f"kernel's grid")
    if o.dtype != q.dtype or do.dtype != q.dtype:
        raise TypeError(f"o and do must be {q.dtype}: {o.dtype}, {do.dtype}")
    fake = bool(q.numel()) and bool(op_stats.ACTIVE) and op_stats.launch(
        "local_attention_bwd", (bwd_work(q, window, dv_dim),
                                bwd_bytes(q, k, v)), q, q.dtype)
    if not fake:
        # both routes copy rows in 16-byte pieces (TMA, cp.async), so
        # rows must start on 16 bytes: a view whose rows do not is copied
        # once
        q, k, v, o, do = (t if t.is_contiguous() and t.data_ptr() % 16 == 0
                          else t.clone(memory_format=torch.contiguous_format)
                          for t in (q, k, v, o, do))
    dq, dk, dv = (torch.empty_like(t, memory_format=torch.contiguous_format)
                  for t in (q, k, v))
    if q.numel() == 0:
        return dq, dk, dv
    # scratch rows padded to 64 (the tensor-core tile; both routes read
    # the statistics of whole tiles)
    sp = -(-s // BWD_TC_TILE) * BWD_TC_TILE
    lse = torch.empty((b, h, sp), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    if fake:
        return dq, dk, dv
    launch = _bwd_launcher()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(*(t.data_ptr() for t in (q, k, v, o, do, dq, dk, dv,
                                              lse, delta)),
                     b, s, h, h // k.shape[2], d, dv_dim,
                     min(int(window), s), d ** -0.5,
                     0.0 if softcap is None else float(softcap),
                     int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"local_attention_bwd launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["local_attention_bwd"] += 1
    return dq, dk, dv


def local_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, window: int, softcap: Optional[float] = None
                          ) -> torch.Tensor:
    """The plain version of :func:`local_attention` (BH, S, D)."""
    return grouped_local_attention_plain(
        q.unsqueeze(2), k.unsqueeze(2), v.unsqueeze(2), window=window,
        softcap=softcap).squeeze(2)


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int, softcap: Optional[float] = None
                    ) -> torch.Tensor:
    """q, k, v (BH, S, D), batch and heads flattened (the reference
    wrapper's layout) -> (BH, S, D); causal, attends to (i - window, i].
    The same kernel as :func:`grouped_local_attention`, with one head
    per row of BH."""
    if q.dim() != 3:
        raise ValueError(f"q, k, v must be (BH, S, D): {tuple(q.shape)}")
    return grouped_local_attention(
        q.unsqueeze(2), k.unsqueeze(2), v.unsqueeze(2), window=window,
        softcap=softcap).squeeze(2)
