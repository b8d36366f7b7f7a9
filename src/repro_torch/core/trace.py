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
  trace by value;
* the exact engine runs the per-tile fold in the interpreter's
  association order (allclose to the reference: torch's float64
  reduction order differs from the reference's padded BLAS).

``SimCounters``/``TrafficCounters`` are derived analytically from the
plan through the shared transport (``_account``, copied verbatim).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.instructions import BUF_PUSH, FROM_PE, Instruction, Port
from repro_torch.core.schedule import BlockSchedule
from repro_torch.core.simulator import SimCounters, _standalone_transport
from repro_torch.core.transport import CHAIN, GROUP, PSUM_BYTES, NoCTransport


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
                 engine=None, handle=None):
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
        self._psum_bytes = sched.c_out * PSUM_BYTES
        dev = self.engine.device
        if hasattr(self.engine, "tiles_mac"):
            self._gidx = torch.as_tensor(self._gather_index(), device=dev)
            self._gathers = None
        else:
            self._gidx = None
            self._gathers = [torch.as_tensor(tt.gather.astype(np.int64),
                                             device=dev)
                             for tt in self.plan.tiles]

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
        if self._gidx is not None:
            out = self._execute_quant(ifm)
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
        """The exact engine: gathers + per-tile MACs + the segment fold,
        in the interpreter's association order."""
        s, plan = self.sched, self.plan
        engine, handle = self.engine, self.handle
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

    def _gather_index(self) -> np.ndarray:
        """(T, E*F, max kc) int64 flat indices into one frame's padded
        int8 stream (Hp*Wp*C values plus a trailing zero sentinel):
        entry (t, f, j) is tap ``j // Cs``, channel ``c_lo + j % Cs`` of
        tile t's fire f — the columns the reference's per-tile gathers
        stack (tap-major, then channel); columns past the tile's depth
        read the sentinel."""
        s, plan = self.sched, self.plan
        kcs = self.handle.kc
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
        quantizing before padding changes nothing."""
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
