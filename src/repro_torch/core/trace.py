"""Trace compiler and executor on torch tensors — the port of
``repro/core/trace.py``.

:func:`compile_trace` (host numpy, copied from the reference) decodes
each tile's periodic instruction table into gather indices, gate masks,
the chain/group segments and the analytic event counts.
:class:`TraceExecutor` runs the plan on the engine's device:

* quantized engines take the fused integer-native lowering: the stream
  is quantized to int8 once, ONE batched gather per fire chunk builds
  the zero-padded (T, rows, kc) patch tensor (indices uploaded once per
  executor; a zero sentinel pixel stands in for the padding), the
  engine's batch-of-tiles MAC runs one CIM kernel call (T subarray dots,
  T ADC conversions, the code sum over tiles), then the block tail.
  Codes are integers, so gather, chunking and association order cannot
  change a bit: the result equals the reference's ``engine="cim"``
  trace by value.  ``fused=False`` keeps the per-tile fold (one kernel
  call per tile) for the equality tests;
* the exact engine runs the per-tile fold in the interpreter's
  association order (allclose to the reference: torch's float64
  reduction order differs from the reference's padded BLAS).

``use_jax=True`` selects the counterparts of the reference's jitted
flavors (the name is kept for signature parity):

* on the exact engine, the reference's float32 flavor: each tile group
  is ONE im2col gemm (patches of the group's tiles side by side, their
  packed-tap weights stacked), the group fold a sum, then the float32
  tail — allclose to the float64 path, not equal;
* on a quantized engine, the fused integer path captured once per input
  shape into a CUDA graph (quantize, pad, gather, one kernel call per
  chunk, the tail) and replayed: a call copies its input into the
  graph's static input, replays, and returns a clone of the static
  output.  The same ops as the eager path, so equal to it by value.  On
  a CPU tensor the flavor runs the eager path.  Each graph has its own
  memory pool, so graphs replay in any order.  :data:`GRAPHS` counts
  captures and replays, :data:`REPLAYED` the CIM kernel launches the
  replays ran (``kernels/cim_matmul.py::LAUNCHES`` counts the launches
  the wrapper runs, not those a capture records).

``SimCounters``/``TrafficCounters`` are derived analytically from the
plan through the shared transport (``_account``, copied verbatim).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.instructions import BUF_PUSH, FROM_PE, Instruction, Port
from repro_torch.core.schedule import BlockSchedule
from repro_torch.core.simulator import SimCounters, _standalone_transport
from repro_torch.core.transport import CHAIN, GROUP, PSUM_BYTES, NoCTransport
from repro_torch.telemetry.spans import span

#: captured CUDA graphs of the quantized ``use_jax`` flavor: graphs
#: captured and replays run, over every executor
GRAPHS = {"captures": 0, "replays": 0}
#: CIM kernel launches run by graph replays, by variant (the captured
#: launches of each graph, added at each of its replays)
REPLAYED = {"cim_codes": 0, "cim_codes_var": 0}


@dataclass(frozen=True)
class TileTrace:
    """One tile's vectorized execution record, lowered from its table."""

    tile_id: int
    pack: int
    c_lo: int
    c_hi: int                     # resolved (never None)
    gather: np.ndarray            # (pack, E*F) int32 flat padded-pixel idx
    # the dense gate masks the gather arrays were built from — kept on
    # the plan so tests and tooling can inspect the lowering
    row_mask: np.ndarray          # (Hp,) bool — Rifm positional row gate
    phase_mask: np.ndarray        # (period,) bool — MAC column phases
    has_north_buf: bool           # group tail folding a BUF_PUSH/POP pair
    dst_east: Optional[int]       # chain psum target (tx E), local id
    dst_south: Optional[int]      # group-sum target (tx S), local id


@dataclass(frozen=True)
class TracePlan:
    """A BlockSchedule lowered to gather/gemm form + analytic counters."""

    sched: BlockSchedule
    tiles: Tuple[TileTrace, ...]
    segments: Tuple[Tuple[int, int], ...]  # per-group [start, end) tile runs
    fires: int                    # MAC/send events per tile = E*F
    macs_per_fire: int            # sum over tiles of pack * C_slice * M
    n_pix: int                    # padded raster stream length Hp*Wp
    drain_cycles: int             # interpreter run length n_pix + 2*chain


def compile_trace(sched: BlockSchedule) -> TracePlan:
    """Lower a compiled schedule into a trace plan.

    Everything is derived from the schedule alone: MAC phases and send
    directions are *decoded from the emitted instruction words*, the row
    gate from the Rifm controller — so the plan executes the tables, not
    a re-derivation of the convolution.
    """
    s = sched
    e, f, wp, hp = s.e, s.f, s.wp, s.hp
    tiles: List[TileTrace] = []
    macs_per_fire = 0
    for prog in s.tiles:
        decoded = [Instruction.decode(wd) for wd in prog.table]
        phases = [ph for ph, ins in enumerate(decoded) if ins.has(FROM_PE)]
        assert len(phases) == f, (s.layer_name, prog.tile_id)
        phase_mask = np.zeros(wp, bool)
        phase_mask[phases] = True
        row_mask = np.fromiter(
            (prog.gate.row_active(r) for r in range(hp)), bool, hp)
        rows = np.flatnonzero(row_mask)          # the E gated padded rows
        assert rows.size == e, (s.layer_name, prog.tile_id)
        cols = np.asarray(phases, np.int64)      # the F MAC column phases
        # tap d reads the pixel `pack-1-d` slots back in the shift buffer
        gather = np.stack([
            (rows[:, None] * wp + (cols[None, :] - prog.pack + 1 + d)).ravel()
            for d in range(prog.pack)
        ]).astype(np.int32)
        c_hi = prog.c_hi if prog.c_hi is not None else s.c_in
        macs_per_fire += prog.pack * (c_hi - prog.c_lo) * s.c_out
        tiles.append(TileTrace(
            tile_id=prog.tile_id, pack=prog.pack, c_lo=prog.c_lo, c_hi=c_hi,
            gather=gather, row_mask=row_mask, phase_mask=phase_mask,
            has_north_buf=any(ins.has(BUF_PUSH) for ins in decoded),
            dst_east=prog.dst_east if any(
                ins.tx_to(Port.E) for ins in decoded) else None,
            dst_south=prog.dst_south if any(
                ins.tx_to(Port.S) for ins in decoded) else None,
        ))
    gs = s.group_size
    segments = tuple((g * gs, (g + 1) * gs) for g in range(s.k))
    hand = s.handoff
    return TracePlan(
        sched=s, tiles=tuple(tiles), segments=segments, fires=hand.out_elems,
        macs_per_fire=macs_per_fire, n_pix=hand.stream_len,
        drain_cycles=hand.stream_len + hand.drain,
    )


@dataclass
class _Graph:
    """One captured replay of the fused quantized path at one input
    shape: the graph, its static input and output, the kernel launches
    it holds (by variant), and the engine handle whose tensors it reads
    (kept alive with it)."""

    graph: "torch.cuda.CUDAGraph"
    x: torch.Tensor
    out: torch.Tensor
    launches: Dict[str, int]
    handle: object


class TraceExecutor:
    """Runs one compiled block on the engine's device.

    No per-cycle state, so one executor serves many runs
    (``transport``/``counters`` may be reassigned between runs, and
    ``handle`` swapped by a device-variation change — the gather indices
    depend on the tiling only).
    """

    def __init__(self, sched: BlockSchedule, weights: torch.Tensor,
                 bias: Optional[torch.Tensor] = None,
                 transport: Optional[NoCTransport] = None,
                 counters: Optional[SimCounters] = None,
                 plan: Optional[TracePlan] = None,
                 use_jax: bool = False,
                 engine=None, handle=None,
                 fused: bool = True):
        from repro_torch.core.engine import ExactEngine, conv_tile_slices

        k = sched.k
        assert weights.shape[:2] == (k, k)
        self.sched = sched
        self.bias = bias
        self.engine = engine if engine is not None \
            else ExactEngine(weights.device)
        self.handle = handle if handle is not None else \
            self.engine.conv_handle(sched.layer_name, weights,
                                    conv_tile_slices(sched))
        self.counters = counters if counters is not None else SimCounters()
        self.transport = transport if transport is not None \
            else _standalone_transport(sched.chain_len)
        self.plan = plan if plan is not None else compile_trace(sched)
        self.use_jax = use_jax
        # quantized engines ride the fused batch-of-tiles lowering;
        # fused=False pins the per-tile reference fold
        self.fused = fused and hasattr(self.engine, "tiles_mac")
        if use_jax and self.engine.name != "exact" and not self.fused:
            raise ValueError(
                f"use_jax=True on the {self.engine.name!r} engine is the "
                "fused integer jit flavor — it has no per-tile form "
                "(fused=False)")
        self._psum_bytes = sched.c_out * PSUM_BYTES
        dev = self.engine.device
        if self.fused:
            self._gidx = torch.as_tensor(self._gather_index(self.handle.kc),
                                         device=dev)
            self._gathers = None
        else:
            self._gidx = None
            self._gathers = [torch.as_tensor(tt.gather.astype(np.int64),
                                             device=dev)
                             for tt in self.plan.tiles]
        #: the quantized flavor's captured graphs, by input shape
        self._graphs: Dict[Tuple[int, ...], _Graph] = {}
        #: the exact flavor's per-group gather indices and float32 weights
        self._f32: Optional[Tuple[list, list]] = None

    def set_handle(self, handle) -> None:
        """Swap the engine handle (a device-variation change): the
        captured graphs and the float32 weights read the old handle's
        tensors, so they are dropped and rebuilt at the next call."""
        self.handle = handle
        self._graphs.clear()
        self._f32 = None

    # -- execution -----------------------------------------------------------

    def run(self, ifm: torch.Tensor, account: bool = True) -> torch.Tensor:
        """ifm: (H, W, C) or (B, H, W, C) float64 -> OFM (..., E, F, M).

        ``account=False`` runs the math only — no ``SimCounters``
        increments and no routed transport records (the streaming
        numerics pass; its accounting is replayed via :meth:`_account`).
        """
        s = self.sched
        squeeze = ifm.dim() == 3
        if squeeze:
            ifm = ifm[None]
        assert tuple(ifm.shape[1:]) == (s.h, s.w, s.c_in), ifm.shape
        if self.fused:
            if self.use_jax and ifm.device.type == "cuda":
                out = self._replay(ifm)
            else:
                out = self._execute_quant(ifm)
        elif self.use_jax:
            out = self._run_f32(ifm)
        else:
            b = ifm.shape[0]
            padded = torch.zeros((b, s.hp, s.wp, s.c_in), dtype=torch.float64,
                                 device=ifm.device)
            padded[:, s.pad:s.pad + s.h, s.pad:s.pad + s.w] = ifm
            out = self._execute_np(padded.reshape(b, -1, s.c_in))
        if account:
            self._account()
        return out[0] if squeeze else out

    def _execute_np(self, stream: torch.Tensor) -> torch.Tensor:
        """Gathers + per-tile MACs + the segment fold, in the
        interpreter's association order: the exact engine's path, and
        the quantized engines' per-tile reference fold (``fused=False``;
        the stream is quantized once, then one kernel call per tile)."""
        s, plan = self.sched, self.plan
        engine, handle = self.engine, self.handle
        stream = engine.quant_stream(handle, stream)
        b = stream.shape[0]
        ef = plan.fires
        gsum: Optional[torch.Tensor] = None
        for lo, hi in plan.segments:
            acc: Optional[torch.Tensor] = None
            for t in range(lo, hi):
                tt = plan.tiles[t]
                g = self._gathers[t]
                taps = []
                for d in range(tt.pack):
                    patch = stream[:, g[d]]
                    if tt.c_lo != 0 or tt.c_hi != s.c_in:
                        patch = patch[:, :, tt.c_lo:tt.c_hi]
                    taps.append(patch.reshape(b * ef, -1))
                m = engine.tile_mac(handle, t, taps).reshape(b, ef, s.c_out)
                # chain: own MAC + west psum (acc = mac; acc += west)
                acc = m if acc is None else m + acc
            # group fold: chain total + running group-sum from the north
            gsum = acc if gsum is None else acc + gsum
        assert gsum is not None
        return self._tail(gsum.reshape(b, s.e, s.f, s.c_out))

    #: fused-path working-set cap: elements allowed in the largest
    #: intermediate ((T, rows, kc) patches / (T, rows, M) dots) per chunk
    _QCHUNK_ELEMS = 1 << 23

    def _gather_index(self, kcs: Sequence[int]) -> np.ndarray:
        """(T, E*F, max kc) int64 flat indices into one frame's padded
        stream (Hp*Wp*C values plus a trailing zero sentinel): entry
        (t, f, j) is tap ``j // Cs``, channel ``c_lo + j % Cs`` of tile
        t's fire f — the columns the reference's per-tile gathers stack
        (tap-major, then channel); columns past the tile's depth
        ``kcs[t]`` read the sentinel."""
        s, plan = self.sched, self.plan
        c = s.c_in
        sentinel = s.hp * s.wp * c
        idx = np.full((len(plan.tiles), plan.fires, max(kcs)), sentinel,
                      np.int64)
        for i, tt in enumerate(plan.tiles):
            g = (tt.gather.astype(np.int64)[:, :, None] * c
                 + np.arange(tt.c_lo, tt.c_hi)[None, None, :])
            idx[i, :, :kcs[i]] = g.transpose(1, 0, 2).reshape(plan.fires,
                                                              kcs[i])
        return idx

    def _quant_chunks(self, ef: int, b: int):
        """Fire-axis chunking for the fused path: bounds the patch / dot
        working set.  Chunk boundaries cannot change a bit — conversion
        is elementwise and every accumulation is an exact integer sum."""
        t = len(self.plan.tiles)
        kcs = self.handle.kc
        width = max(1, t * b * max(max(kcs), self.sched.c_out))
        chunk = max(1, min(ef, self._QCHUNK_ELEMS // width))
        return [(lo, min(ef, lo + chunk)) for lo in range(0, ef, chunk)]

    def _execute_quant(self, ifm: torch.Tensor) -> torch.Tensor:
        """The fused integer-native path: quantize once (int8), one
        batched gather per chunk, one CIM kernel call per chunk, the
        block tail.  Quantization maps the zero padding to zero codes, so
        quantizing before padding changes nothing.  Nothing here copies
        host data to the device or reads device data back, so the path
        captures into a CUDA graph as it is (:meth:`_replay`)."""
        s = self.sched
        engine, handle = self.engine, self.handle
        qs = engine.quant_stream(handle, ifm)          # (B, H, W, C) int8
        b, ef, m = qs.shape[0], self.plan.fires, s.c_out
        n_flat = s.hp * s.wp * s.c_in
        flat = torch.zeros((b, n_flat + 1), dtype=torch.int8,
                           device=qs.device)
        flat[:, :n_flat].view(b, s.hp, s.wp, s.c_in)[
            :, s.pad:s.pad + s.h, s.pad:s.pad + s.w] = qs
        t_n, kcm = self._gidx.shape[0], self._gidx.shape[2]
        out = torch.empty((b, ef, m), dtype=torch.float64, device=qs.device)
        for lo, hi in self._quant_chunks(ef, b):
            px = flat[:, self._gidx[:, lo:hi]]       # (B, T, rows, kc)
            px = px.transpose(0, 1).reshape(t_n, b * (hi - lo), kcm)
            codes = engine.tiles_mac(handle, px)     # (B*rows, M) code sums
            out[:, lo:hi] = codes.reshape(b, hi - lo, m)
        return self._tail(out.reshape(b, s.e, s.f, m))

    # -- the quantized flavor on the card: a captured replay ---------------

    def _replay(self, ifm: torch.Tensor) -> torch.Tensor:
        """The fused path through this input shape's captured graph
        (captured at the first call): copy the input into the static
        input, replay, return a clone of the static output — the next
        replay overwrites it, and callers keep what they were given."""
        g = self._graphs.get(tuple(ifm.shape))
        if g is None:
            with span(f"graph_capture:{self.sched.layer_name}", cat="jit"):
                g = self._capture(ifm)
            self._graphs[tuple(ifm.shape)] = g
        g.x.copy_(ifm)
        g.graph.replay()
        GRAPHS["replays"] += 1
        for k, v in g.launches.items():
            REPLAYED[k] += v
        return g.out.clone()

    def _capture(self, ifm: torch.Tensor) -> _Graph:
        """Capture :meth:`_execute_quant` at ``ifm``'s shape into a CUDA
        graph with its own memory pool.  One warm-up run on a side stream
        comes first (PyTorch's recipe): it builds and loads the kernel
        library and sets each kernel variant's attributes outside the
        capture.  A failed capture raises; nothing falls back to the
        eager path.  The kernel wrapper's launch plan and its alignment
        choices (``x.data_ptr()``) are taken here, on the host; they stay
        valid because the graph's pool keeps every address."""
        dev = ifm.device
        x = torch.empty(ifm.shape, dtype=ifm.dtype, device=dev)
        x.copy_(ifm)
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._execute_quant(x)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = self._execute_quant(x)
        # one kernel call per fire chunk, of the handle's variant
        kname = "cim_codes" if self.handle.adc is None else "cim_codes_var"
        launches = {kname: len(self._quant_chunks(self.plan.fires,
                                                  ifm.shape[0]))}
        GRAPHS["captures"] += 1
        return _Graph(graph, x, out, launches, self.handle)

    # -- the exact engine's float32 flavor ------------------------------------

    def _build_f32(self) -> Tuple[list, list]:
        """Per tile group: the flat gather indices of its tiles' patch
        columns side by side ((E*F, K_group), tile, then tap, then
        channel) and the matching float32 weight rows (K_group, M).
        Within a group the (tile, tap) pairs cover a slice of the K*K*C
        contraction exactly once each, so a group is ONE gemm."""
        plan, h = self.plan, self.handle
        kcs = [tt.pack * (tt.c_hi - tt.c_lo) for tt in plan.tiles]
        idx = self._gather_index(kcs)
        dev = self.engine.device
        gidx, wcats = [], []
        for lo, hi in plan.segments:
            gidx.append(torch.as_tensor(np.concatenate(
                [idx[t, :, :kcs[t]] for t in range(lo, hi)], axis=1),
                device=dev))
            wcats.append(torch.cat(
                [h.tile_w[t][d] for t in range(lo, hi)
                 for d in range(h.tile_w[t].shape[0])]).to(torch.float32))
        return gidx, wcats

    def _run_f32(self, ifm: torch.Tensor) -> torch.Tensor:
        """The reference's float32 flavor of the exact engine: one im2col
        gemm per tile group, the group fold a sum, the float32 tail.
        Allclose to the float64 path (another summation order), not
        equal; counters are identical.  TF32 is pinned off on the card:
        it would keep about three decimal digits."""
        torch.backends.cuda.matmul.allow_tf32 = False
        if self._f32 is None:
            self._f32 = self._build_f32()
        s = self.sched
        b, ef, m = ifm.shape[0], self.plan.fires, s.c_out
        padded = torch.zeros((b, s.hp, s.wp, s.c_in), dtype=torch.float32,
                             device=ifm.device)
        padded[:, s.pad:s.pad + s.h, s.pad:s.pad + s.w] = ifm
        flat = padded.reshape(b, -1)
        gsum = None
        for gidx, wcat in zip(*self._f32):
            g = (flat[:, gidx].reshape(b * ef, -1) @ wcat).reshape(b, ef, m)
            gsum = g if gsum is None else g + gsum
        out = gsum.reshape(b, s.e, s.f, m)
        if self.bias is not None:
            out = out + self.bias.to(torch.float32)
        if s.tail.activation == "relu":
            out = torch.clamp_min(out, 0.0)
        ps = s.tail.pool_s
        if ps:
            out = out.reshape(b, s.e // ps, ps, s.f // ps, ps, m).amax(
                dim=(2, 4))
        return out.to(torch.float64)

    def _tail(self, out: torch.Tensor) -> torch.Tensor:
        """Block-tail M-type program: dequantization (quantized engine),
        bias, activation, Fig. 9 pooling — each fold in the
        interpreter's operand order (max is exact, so order is moot for
        the bits, but kept)."""
        s = self.sched
        b = out.shape[0]
        out = self.engine.finalize_conv(self.handle, out)
        if self.bias is not None:
            out = out + self.bias
        if s.tail.activation == "relu":
            out = torch.clamp_min(out, 0.0)
        ps = s.tail.pool_s
        if ps:
            assert s.e % ps == 0 and s.f % ps == 0, (
                f"pooling {ps} does not tile the {s.e}x{s.f} OFM")
            win = out.reshape(b, s.e // ps, ps, s.f // ps, ps, s.c_out)
            row = win[:, :, :, :, 0]
            for y in range(1, ps):
                row = torch.maximum(row, win[:, :, :, :, y])
            res = row[:, :, 0]
            for x in range(1, ps):
                res = torch.maximum(res, row[:, :, x])
            out = res
        return out

    # -- analytic counters (same events the interpreter tallies per cycle) ---

    def _account(self) -> None:
        s, plan = self.sched, self.plan
        fires = plan.fires
        cnt = self.counters
        transport = self.transport
        cnt.cycles += plan.drain_cycles
        cnt.instr_fetches += s.chain_len * plan.n_pix
        cnt.macs += fires * plan.macs_per_fire
        north_tiles = sum(1 for tt in plan.tiles if tt.has_north_buf)
        cnt.buf_push += north_tiles * fires
        cnt.buf_pop += north_tiles * fires
        if s.tail.activation:
            cnt.act_ops += fires * s.c_out
        ps = s.tail.pool_s
        if ps:
            cnt.pool_ops += s.e * (s.f - s.f // ps) * s.c_out
        for tt in plan.tiles:
            if tt.dst_east is not None:
                h = transport.record_bulk(tt.tile_id, tt.dst_east, CHAIN,
                                          self._psum_bytes, fires)
                cnt.chain_hops += fires * max(1, h)  # 1 cycle/hop latency
            if tt.dst_south is not None:
                h = transport.record_bulk(tt.tile_id, tt.dst_south, GROUP,
                                          self._psum_bytes, fires)
                cnt.group_hops += fires * max(1, h)


def simulate_block_trace(sched: BlockSchedule, weights: torch.Tensor,
                         ifm: torch.Tensor,
                         bias: Optional[torch.Tensor] = None,
                         **kw) -> torch.Tensor:
    """One-shot convenience: compile + execute a block on the fast path."""
    return TraceExecutor(sched, weights, bias=bias, **kw).run(ifm)
