"""Functional cycle-level simulator of a Domino block on torch tensors —
the port of ``repro/core/simulator.py``.

:class:`BlockSimulator` executes a convolution strictly from its
compiled instruction tables (``core/schedule.py``): each cycle it
decodes every tile's periodic C-type word, applies the Rifm row gate,
moves the chain psums and group sums as routed packets over the NoC
transport (``core/transport.py``), and lets the block tail's M-type
program run activation and pooling.  The per-cycle control is host code
copied from the reference: the cycle loop, the Rifm shift buffer
(``deque(maxlen=pack)``, cleared at a row restart), instruction decode,
the row gate, BUF_PUSH / FROM_PE / SUM_ADD / BUF_POP, ``send`` /
``deliver``, the tail's emit and compare-on-the-move pooling.  The
values are tensors on the engine's device: the padded stream, the
``(B, C)`` packets, the psums, the OFM.  Each firing tile-cycle is one
engine ``tile_mac`` call — on a quantized engine one CIM kernel call
(``kernels/cim_matmul.py::cim_codes``).  The loop reads nothing back
from the device; only the caller reads the OFM.

Batching: packets are ``(B, C)`` tensors — one simulated pass moves a
batch through the chain with each MAC batched over B.  Counters stay
per inference: a batched packet is one routed packet.

``SimCounters`` and the standalone transport are host code copied from
the reference.  :func:`simulate_fc` walks the same ``compile_fc_block``
instruction words for the counters and traffic; the exact engine MACs
each grid tile and accumulates the column chain on the device, a
quantized engine computes the whole layer's code sums in one kernel
call.
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from repro_torch.core.instructions import (
    ACT_EN,
    BUF_POP,
    BUF_PUSH,
    FROM_PE,
    POOL_MAX,
    POOL_OUT,
    POOL_STORE,
    SUM_ADD,
    Instruction,
    Opcode,
    Port,
)
from repro_torch.core.noc import MeshNoC
from repro_torch.core.schedule import (
    BlockSchedule,
    TileProgram,
    compile_fc_block,
)
from repro_torch.core.transport import (
    CHAIN,
    GROUP,
    SPLIT,
    PSUM_BYTES,
    NoCTransport,
)


@dataclass
class SimCounters:
    macs: int = 0
    chain_hops: int = 0       # routed hops of psum packets within a group
    group_hops: int = 0       # routed hops of group-sum packets (tail->tail)
    buf_push: int = 0
    buf_pop: int = 0
    act_ops: int = 0
    pool_ops: int = 0
    cycles: int = 0
    instr_fetches: int = 0


_ACT = {
    None: lambda v: v,
    "relu": lambda v: torch.clamp_min(v, 0.0),
    "identity": lambda v: v,
}


def gemm_rows(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """2-D float64 product of the exact engine.  The reference pads
    BLAS remainder row blocks so a row's bits never depend on its batch
    neighbours; torch's reduction order is not held to that, so the
    exact engine is allclose to the reference, not bitwise."""
    return torch.matmul(a, w)


def _standalone_transport(chain_len: int) -> NoCTransport:
    """A lone block gets its own square mesh, snake-placed from tile 0."""
    side = max(1, math.ceil(math.sqrt(chain_len)))
    return NoCTransport(MeshNoC(rows=side, cols=side), base=0)


class _Tile:
    def __init__(self, prog: TileProgram, index: int, pack_span: int,
                 c_in: int):
        self.prog = prog
        self.index = index  # position in the chain == engine handle slot
        self.fifo_w: deque = deque()  # chain psums from the west
        self.fifo_n: deque = deque()  # running group-sums from the north
        self.buffer: deque = deque()  # the Rofm buffer
        self.shift_buf: deque = deque(maxlen=pack_span)  # Rifm in-buffer shift
        # decode the periodic table once (the hardware decodes per fetch;
        # decoding per simulated cycle only burns wall time)
        self.decoded: Tuple[Instruction, ...] = tuple(
            Instruction.decode(wd) for wd in prog.table
        )
        # full-depth tiles skip the per-MAC channel slice of the pixel;
        # the engine handle's weights are already sliced at construction
        c_hi = prog.c_hi if prog.c_hi is not None else c_in
        self.c_width = c_hi - prog.c_lo
        self.needs_cslice = not (prog.c_lo == 0 and c_hi >= c_in)


def mac_slots(sched: BlockSchedule) -> int:
    """The engine MACs one :class:`BlockSimulator` run of ``sched`` makes
    (one CIM kernel call each on a quantized engine), counted from the
    decoded tables alone: the (tile, pixel) slots whose word is not a
    nop, holds FROM_PE, and falls on a row the tile's gate opens."""
    n = 0
    for prog in sched.tiles:
        words = [Instruction.decode(wd) for wd in prog.table]
        for q in range(sched.hp * sched.wp):
            r, c = divmod(q, sched.wp)
            instr = words[c % prog.period]
            if not instr.is_nop and instr.has(FROM_PE) and \
                    prog.gate.row_active(r):
                n += 1
    return n


class BlockSimulator:
    """Simulates one compiled CONV block on a (batch of) IFM(s).

    Unlike the reference, the batch is not padded to a BLAS row block:
    the reference pads so a lane's bits never depend on its neighbours
    under OpenBLAS, which :func:`gemm_rows` does not claim (quantized
    engines are integer codes, so the batch cannot move them)."""

    def __init__(self, sched: BlockSchedule, weights: torch.Tensor,
                 bias: Optional[torch.Tensor] = None,
                 transport: Optional[NoCTransport] = None,
                 counters: Optional[SimCounters] = None,
                 engine=None, handle=None):
        """weights: (K, K, C, M) float; bias: (M,).

        ``transport`` places the block on a shared mesh and ``counters``
        aggregates events across blocks (whole-network simulation); by
        default the block lives alone on its own mesh.  ``engine``
        selects the PE numerics (``core/engine.py``; default exact
        float64 on the weights' device); ``handle`` supplies a prebuilt
        per-layer engine state (the whole-network simulator shares one
        across strips), else it is built here from ``weights``.
        """
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
        self.tiles: List[_Tile] = [
            _Tile(prog, t, pack_span=prog.pack, c_in=sched.c_in)
            for t, prog in enumerate(sched.tiles)
        ]
        self._psum_bytes = sched.c_out * PSUM_BYTES
        # tail pooling state
        self._pool_tmp: Optional[torch.Tensor] = None
        self._pool_row: dict = {}
        self._outputs: List[torch.Tensor] = []
        self._pooled: List[torch.Tensor] = []

    # -- PE ------------------------------------------------------------------

    def _pe_mac(self, tile: _Tile) -> torch.Tensor:
        """MAC over the packed taps against the Rifm shift buffer; the
        pixel is ``(B, C)`` and the MAC is batched over B.

        The shift buffer's maxlen == pack, so its contents are the
        packed-tap window — fewer taps after a row restart, which the
        engine meets with the tile's first weight taps, as the
        reference does."""
        prog = tile.prog
        if tile.needs_cslice:
            c_lo, c_hi = prog.c_lo, prog.c_hi
            taps = [px[:, c_lo:c_hi] for px in tile.shift_buf]
        else:
            taps = list(tile.shift_buf)
        acc = self.engine.tile_mac(self.handle, tile.index, taps)
        self.counters.macs += len(taps) * tile.c_width * self.sched.c_out
        return acc

    # -- main loop -----------------------------------------------------------

    def run(self, ifm: torch.Tensor) -> torch.Tensor:
        """ifm: (H, W, C) or (B, H, W, C) -> OFM (..., E, F, M) after
        activation (+pooling); the batch axis is preserved if given."""
        s = self.sched
        squeeze = ifm.dim() == 3
        if squeeze:
            ifm = ifm[None]
        b = ifm.shape[0]
        assert tuple(ifm.shape[1:]) == (s.h, s.w, s.c_in), ifm.shape
        padded = torch.zeros((b, s.hp, s.wp, s.c_in), dtype=torch.float64,
                             device=ifm.device)
        padded[:, s.pad:s.pad + s.h, s.pad:s.pad + s.w] = ifm
        stream = padded.reshape(b, -1, s.c_in)  # raster order, batched
        # engine input domain, once per run (identity for exact; static
        # per-layer int quantization for CIM — elementwise, so it
        # commutes with the Rifm pipeline's latching and slicing)
        stream = self.engine.quant_stream(self.handle, stream)
        n_pix = stream.shape[1]
        chain = len(self.tiles)
        total_cycles = n_pix + chain + chain  # drain margin
        transport = self.transport
        counters = self.counters
        self._outputs.clear()
        self._pooled.clear()

        for cyc in range(total_cycles):
            counters.cycles += 1
            # deliver packets routed to arrive this cycle
            for tid, tile in enumerate(self.tiles):
                tile.fifo_w.extend(transport.deliver(cyc, tid, "W"))
                tile.fifo_n.extend(transport.deliver(cyc, tid, "N"))

            for tid, tile in enumerate(self.tiles):
                q = cyc - tid  # pixel index currently at this tile
                if not (0 <= q < n_pix):
                    continue
                r, c = divmod(q, s.wp)
                px = stream[:, q]
                tile.shift_buf.append(px)  # Rifm pipeline latch
                if c == 0:
                    # row restart: in-buffer shift state resets with the row
                    tile.shift_buf.clear()
                    tile.shift_buf.append(px)

                instr = tile.decoded[c % tile.prog.period]
                counters.instr_fetches += 1
                if instr.is_nop:
                    continue

                gate = tile.prog.gate.row_active(r)
                acc = None
                prog = tile.prog

                if instr.has(BUF_PUSH) and tile.fifo_n:
                    tile.buffer.append(tile.fifo_n.popleft())
                    counters.buf_push += 1

                if gate:
                    if instr.has(FROM_PE):
                        acc = self._pe_mac(tile)
                    if instr.has(SUM_ADD) and tile.fifo_w:
                        west = tile.fifo_w.popleft()
                        acc = west if acc is None else acc + west
                    if instr.has(BUF_POP) and tile.buffer:
                        head = tile.buffer.popleft()
                        counters.buf_pop += 1
                        acc = head if acc is None else acc + head

                if acc is None:
                    continue

                if instr.tx_to(Port.E):
                    hops = transport.send(cyc, tid, prog.dst_east, "W", acc,
                                          CHAIN, self._psum_bytes) - cyc
                    counters.chain_hops += hops
                elif instr.tx_to(Port.S):
                    hops = transport.send(cyc, tid, prog.dst_south, "N", acc,
                                          GROUP, self._psum_bytes) - cyc
                    counters.group_hops += hops
                elif prog.is_block_tail:
                    self._emit(acc)

        out = torch.stack(self._outputs, dim=1).reshape(
            b, s.e, s.f, s.c_out)
        if self.sched.tail.pool_s:
            ps = self.sched.tail.pool_s
            assert s.e % ps == 0 and s.f % ps == 0, (
                f"pooling {ps} does not tile the {s.e}x{s.f} OFM")
            out = torch.stack(self._pooled, dim=1).reshape(
                b, s.e // ps, s.f // ps, s.c_out)
        return out[0] if squeeze else out

    # -- tail unit (M-type program) ------------------------------------------

    def _emit(self, val: torch.Tensor) -> None:
        s = self.sched
        idx = len(self._outputs)
        x, y = divmod(idx, s.f)
        instr = s.tail.instr_at(x, y)
        assert instr.opcode == Opcode.M
        # quantized engines: the accumulated ADC codes leave the digital
        # domain here, before bias / activation / pooling (exact: no-op)
        val = self.engine.finalize_conv(self.handle, val)
        if self.bias is not None:
            val = val + self.bias
        if instr.has(ACT_EN):
            val = _ACT[s.tail.activation](val)
            self.counters.act_ops += val.shape[-1]
        self._outputs.append(val)
        if s.tail.pool_s:
            self._pool_step(instr, x, y, val)

    def _pool_step(self, instr: Instruction, x: int, y: int,
                   val: torch.Tensor) -> None:
        """Fig. 9(c): compare-on-the-move max pooling in the tail Rofm,
        generalized to the schedule's actual pool stride (K_p == S_p)."""
        ps = self.sched.tail.pool_s
        if instr.has(POOL_STORE) and not instr.has(POOL_MAX):
            self._pool_tmp = val  # start of a window row
            return
        if instr.has(POOL_MAX):
            self.counters.pool_ops += val.shape[-1]
            self._pool_tmp = torch.maximum(self._pool_tmp, val)  # running max
            col = y // ps  # pooled-output column this window lands in
            if instr.has(POOL_STORE):
                prev = self._pool_row.get(col)
                self._pool_row[col] = self._pool_tmp if prev is None \
                    else torch.maximum(prev, self._pool_tmp)
            elif instr.has(POOL_OUT):
                self._pooled.append(
                    torch.maximum(self._pool_row.pop(col), self._pool_tmp))


# ---------------------------------------------------------------------------
# FC block simulation (paper Fig. 4)
# ---------------------------------------------------------------------------


def simulate_fc(x: torch.Tensor, w: torch.Tensor, n_c: int, n_m: int,
                activation: Optional[str] = None,
                counters: Optional[SimCounters] = None,
                transport: Optional[NoCTransport] = None,
                engine=None, handle=None,
                account_only: bool = False) -> torch.Tensor:
    """Partitioned MVM on an m_t x m_a tile grid, psums added down columns.

    x: (c_in,) or (B, c_in); w: (c_in, c_out) (its shape drives the grid;
    the engine handle holds the resident weights).  Each grid tile holds
    one ``<= n_c``-row weight slice; the column chain accumulates
    digitally (ADC codes under quantization).  The exact engine MACs
    each tile in its own call, in the chain's order.  A quantized engine
    computes the whole layer's code sums in one kernel call before the
    walk (``fc_layer_mac``): codes are integers, so a column's sum is the
    chain's whatever the order.  That needs every grid tile to MAC and
    every non-head tile to add its north neighbour's psum, and grid rows
    of whole ``n_c``-row subarrays; anything else raises.

    ``account_only=True`` walks the same grid and emits every
    counter/transport increment — all value- and batch-independent — but
    skips the engine arithmetic and returns zeros.
    """
    if engine is None:
        from repro_torch.core.engine import ExactEngine

        engine = ExactEngine(x.device)
    if handle is None:
        handle = engine.fc_handle("fc", w)
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None]
    c_in, c_out = w.shape
    codes = None
    if not account_only:
        x = engine.quant_stream(handle, x)  # engine input domain, once
        if hasattr(engine, "fc_layer_mac"):
            if n_c % handle.spec.n_c:
                raise ValueError(
                    f"FC grid rows of {n_c} weight rows do not hold whole "
                    f"{handle.spec.n_c}-row subarrays")
            codes = engine.fc_layer_mac(handle, x)  # (B, c_out), one call
    per_tile = not account_only and codes is None
    m_t, m_a, tables = compile_fc_block("fc", c_in, c_out, n_c, n_m, activation)
    cnt = counters if counters is not None else SimCounters()
    out = torch.zeros((x.shape[0], c_out), dtype=torch.float64,
                      device=x.device)
    for j in range(m_a):  # columns compute in parallel; python loop for sim
        n0, n1 = j * n_m, min((j + 1) * n_m, c_out)
        psum = torch.zeros((x.shape[0], n1 - n0), dtype=torch.float64,
                           device=x.device) if per_tile else None
        act_fired = False
        for i in range(m_t):
            instr = Instruction.decode(tables[i][j][0])
            k0, k1 = i * n_c, min((i + 1) * n_c, c_in)
            if codes is not None and not (instr.has(FROM_PE) and
                                          instr.rx_from(Port.N) == (i > 0)):
                raise ValueError(
                    f"grid tile ({i}, {j}) is not a MAC plus chain-add: the "
                    "layer's codes are not its column sums")
            if per_tile:
                acc = torch.zeros_like(psum)
                if instr.has(FROM_PE):
                    acc += engine.fc_mac(handle, x[:, k0:k1], k0, k1, n0, n1)
                if instr.rx_from(Port.N):
                    # chain-add: the upstream psum received from the north
                    # (encoded in rx — set only for non-head grid rows)
                    acc += psum
                psum = acc
            if instr.has(FROM_PE):
                cnt.macs += (k1 - k0) * (n1 - n0)
            if i < m_t - 1:
                # grid tile (i, j) -> (i+1, j): column-major placement puts
                # them m_a tiles apart in the snake chain
                if transport is not None:
                    src, dst = i * m_a + j, (i + 1) * m_a + j
                    cnt.chain_hops += transport.record(
                        src, dst, SPLIT, (n1 - n0) * PSUM_BYTES)
                else:
                    cnt.chain_hops += 1
            if instr.has(ACT_EN):
                act_fired = True  # column tail: activation after dequant
        if act_fired:
            cnt.act_ops += n1 - n0
        if account_only:
            continue
        if codes is not None:
            psum = codes[:, n0:n1]
        psum = engine.finalize_fc(handle, psum, n0, n1)
        if act_fired:
            psum = _ACT[activation or "identity"](psum)
        out[:, n0:n1] = psum
    return out[0] if squeeze else out
