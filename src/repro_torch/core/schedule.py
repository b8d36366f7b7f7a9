"""Schedule-table compiler (paper §6.2).

Compiles a layer + mapping into *periodic per-tile instruction tables*.
During convolution the Rofm behaviour is periodic in the padded image
width: we emit one C-type instruction per column phase (period
``p = W + 2P``; the paper quotes ``2(P+W)`` because its NoC moves two
64-bit flits per pixel slot — one IFM, one psum — at the 640 MHz link
clock; at the 10 MHz instruction clock both land in the same table slot).
Row-boundary gating is done by the Rifm counter/controller (paper §4.3),
which is positional, not periodic — the compiler emits it as a per-group
row gate.

The tables drive ``core/simulator.py`` *literally*: the simulator has no
knowledge of convolution; it only executes decoded instructions.  Tests
prove compiled tables + tiles == ``jax.lax.conv`` exactly.

Timing model (derived in the paper's Fig. 5/6 and re-derived here):

* the pixel stream enters the chain in raster order, one pixel / cycle,
  advancing one tile / cycle (systolic Rifm chain);
* tile ``t`` with packed taps ``(i, j..j+pack-1)`` MAC-fires for output
  column ``y`` at phase ``φ = y*s + j + pack - 1`` (it holds the earlier
  pixels of the pack in its Rifm shift buffer — the paper's "in-buffer
  shifting");
* a chain psum sent by tile ``t`` is consumed by tile ``t+1`` exactly
  ``pack`` cycles after arrival -> it waits in the W-input register queue;
* a completed group-sum travels south to the next group's tail and waits
  ``s * (W+2P)`` cycles in the Rofm buffer (the paper's "U1 waits in the
  third tile until U2 is generated") -> BUF_PUSH on arrival, BUF_POP +
  SUM_ADD on the completion phase.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from repro_torch.core.instructions import (
    ACT_EN,
    BUF_POP,
    BUF_PUSH,
    FC_MODE,
    FROM_PE,
    NOP,
    POOL_MAX,
    POOL_OUT,
    POOL_STORE,
    SUM_ADD,
    TABLE_CAPACITY,
    Instruction,
    Opcode,
    Port,
)


@dataclass(frozen=True)
class RifmGate:
    """The Rifm controller's positional MAC gate for one tile group.

    MAC is enabled for padded row r iff (r - i) is a valid output row
    stride multiple: (r-i) % s == 0 and 0 <= (r-i)//s < E.
    """

    tap_row: int
    stride: int
    e: int  # output height

    def row_active(self, r: int) -> bool:
        d = r - self.tap_row
        return d >= 0 and d % self.stride == 0 and d // self.stride < self.e


@dataclass(frozen=True)
class TileProgram:
    tile_id: int
    tap_row: int          # i
    tap_col: int          # first j of the packed taps
    pack: int             # taps packed into this tile (in-buffer shifting)
    chain_pos: int        # position along the block chain
    table: Tuple[int, ...]  # encoded C-type instructions, len == period
    period: int
    gate: RifmGate
    is_group_head: bool
    is_group_tail: bool
    is_block_tail: bool
    # explicit routed destinations (local tile ids) — the transport layer
    # resolves these to physical mesh routes; no hop math in the simulator
    dst_east: Optional[int] = None   # chain psum target (tx E)
    dst_south: Optional[int] = None  # group-sum target (tx S)
    # input-channel slice handled by this tile (C > N_c split chains)
    c_lo: int = 0
    c_hi: Optional[int] = None       # None = full input depth

    def instr_at(self, phase: int) -> Instruction:
        return Instruction.decode(self.table[phase % self.period])


@dataclass(frozen=True)
class TailProgram:
    """M-type program for the block-tail Rofm (activation + pooling).

    Indexed by output-pixel parity (x % pool_s, y % pool_s): period
    pool_s * pool_s events == the paper's p = 2 * S_p at two events/slot.
    """

    table: Tuple[int, ...]
    pool_k: int
    pool_s: int
    activation: Optional[str]

    def instr_at(self, x: int, y: int) -> Instruction:
        if self.pool_s == 0:
            return Instruction.decode(self.table[0])
        idx = (x % self.pool_s) * self.pool_s + (y % self.pool_s)
        return Instruction.decode(self.table[idx])


@dataclass(frozen=True)
class StageHandoff:
    """Inter-layer stream hand-off metadata of one compiled block — what
    the pipelined streaming executor (``core/network.py``) needs to
    advance overlapping frames through the layer pipeline: how many OFM
    pixels the block emits per frame, how long its padded pixel stream
    occupies the chain, and the chain fill/drain margin (one cycle per
    tile in, one out).  OFM *byte* volume is accounted by the network
    simulator from the layer plan (``LayerPlan.out_pixels * c_out``),
    which also covers FC stages that have no compiled schedule."""

    out_elems: int     # E*F output pixels emitted per frame (pre-pool)
    stream_len: int    # padded pixel stream occupancy, Hp*Wp cycles
    drain: int         # chain fill/drain margin, 2 * chain_len cycles


@dataclass(frozen=True)
class BlockSchedule:
    layer_name: str
    k: int
    stride: int
    pad: int
    c_in: int
    c_out: int
    h: int
    w: int
    pack: int
    tiles: Tuple[TileProgram, ...]
    tail: TailProgram
    c_splits: int = 1

    @property
    def group_size(self) -> int:
        """Tiles per filter-row group (tap packing x channel splits)."""
        return math.ceil(self.k / self.pack) * self.c_splits

    @property
    def chain_len(self) -> int:
        return len(self.tiles)

    @property
    def wp(self) -> int:
        return self.w + 2 * self.pad

    @property
    def hp(self) -> int:
        return self.h + 2 * self.pad

    @property
    def e(self) -> int:
        return (self.h + 2 * self.pad - self.k + self.stride) // self.stride

    @property
    def f(self) -> int:
        return (self.w + 2 * self.pad - self.k + self.stride) // self.stride

    @property
    def period(self) -> int:
        return self.wp

    @property
    def handoff(self) -> StageHandoff:
        """Stream hand-off metadata for the pipelined executor (strip
        schedules each carry their own; the network stage sums them)."""
        return StageHandoff(out_elems=self.e * self.f,
                            stream_len=self.hp * self.wp,
                            drain=2 * self.chain_len)


def _mac_phases(j0: int, pack: int, stride: int, f: int) -> List[int]:
    """Phases (padded column indices) at which the packed tile MAC-fires."""
    return [y * stride + j0 + pack - 1 for y in range(f)]


def compile_conv_block(
    name: str,
    h: int,
    w: int,
    c_in: int,
    c_out: int,
    k: int = 3,
    stride: int = 1,
    pad: int = 1,
    pack: int = 1,
    c_splits: int = 1,
    pool_k: int = 0,
    pool_s: int = 0,
    activation: Optional[str] = "relu",
) -> BlockSchedule:
    """Compile one CONV layer onto a chain of ``k * group_size`` tiles,
    ``group_size = ceil(k/pack) * c_splits``.

    ``pack`` taps (along the filter row) share one tile via Rifm in-buffer
    shifting (used when N_c > C); ``c_splits`` input-channel slices extend
    each group with split tiles chained east (used when C > N_c — every
    tile MACs only its ``[c_lo, c_hi)`` slice of the pixel).  Period =
    W + 2P must fit the 128-entry schedule table (Tab. 3) — checked here
    like a real compiler would.

    Every emitted :class:`TileProgram` carries its explicit destination
    tile ids (``dst_east`` / ``dst_south``); the simulator routes packets
    to those ids over the mesh transport layer instead of doing its own
    hop arithmetic.
    """
    assert 1 <= pack <= k
    assert c_splits >= 1
    if c_splits > 1:
        assert pack == 1, "tap packing and channel splitting are exclusive"
        assert c_splits <= c_in
    wp = w + 2 * pad
    f_out = (w + 2 * pad - k + stride) // stride
    e_out = (h + 2 * pad - k + stride) // stride
    period = wp
    if period > TABLE_CAPACITY:
        raise ValueError(
            f"{name}: schedule period {period} exceeds the 16b x "
            f"{TABLE_CAPACITY} Rofm table (paper Tab. 3); tile the IFM width"
        )

    tiles_per_row = math.ceil(k / pack)
    group_size = tiles_per_row * c_splits
    tiles: List[TileProgram] = []
    chain_len = k * group_size
    split_c = math.ceil(c_in / c_splits)

    for i in range(k):  # filter row == group
        for u in range(tiles_per_row):
            j0 = u * pack
            this_pack = min(pack, k - j0)
            for sc in range(c_splits):
                t = i * group_size + u * c_splits + sc
                is_head = u == 0 and sc == 0
                is_tail = u == tiles_per_row - 1 and sc == c_splits - 1
                is_block_tail = t == chain_len - 1
                c_lo = sc * split_c
                c_hi = min(c_in, (sc + 1) * split_c)

                table = [NOP] * period
                dst_east: Optional[int] = None
                dst_south: Optional[int] = None
                # C-type accumulate instructions at MAC phases
                for phase in _mac_phases(j0, this_pack, stride, f_out):
                    func = FROM_PE
                    rx = 1 << int(Port.W)  # pixels + psums arrive from west
                    tx = 0
                    if not is_head:
                        func |= SUM_ADD  # add the chain psum from the queue
                    if not is_tail:
                        tx |= 1 << int(Port.E)  # forward psum east
                        dst_east = t + 1
                    else:
                        # group tail: fold in the running group-sum from the
                        # north (previous groups), then send south
                        if i > 0:
                            func |= BUF_POP
                        if not is_block_tail:
                            tx |= 1 << int(Port.S)
                            dst_south = t + group_size
                    table[phase] = Instruction(Opcode.C, rx=rx, func=func, tx=tx)

                if is_tail and i > 0:
                    # arrival phases of the running group-sum from group i-1:
                    # it arrives `stride*wp` cycles before our completion
                    # phase, i.e. at the same column phase -> BUF_PUSH rides
                    # the same slot; encode rx from N + push.
                    for phase in _mac_phases(j0, this_pack, stride, f_out):
                        instr = table[phase]
                        table[phase] = Instruction(
                            Opcode.C,
                            rx=instr.rx | (1 << int(Port.N)),
                            func=instr.func | BUF_PUSH,
                            tx=instr.tx,
                        )

                tiles.append(
                    TileProgram(
                        tile_id=t,
                        tap_row=i,
                        tap_col=j0,
                        pack=this_pack,
                        chain_pos=t,
                        table=tuple(ins.encode() for ins in table),
                        period=period,
                        gate=RifmGate(tap_row=i, stride=stride, e=e_out),
                        is_group_head=is_head,
                        is_group_tail=is_tail,
                        is_block_tail=is_block_tail,
                        dst_east=dst_east,
                        dst_south=dst_south,
                        c_lo=c_lo,
                        c_hi=c_hi,
                    )
                )

    tail = compile_tail(pool_k, pool_s, activation)
    return BlockSchedule(
        layer_name=name, k=k, stride=stride, pad=pad, c_in=c_in, c_out=c_out,
        h=h, w=w, pack=pack, tiles=tuple(tiles), tail=tail, c_splits=c_splits,
    )


@dataclass(frozen=True)
class ConvStrip:
    """One vertical IFM strip of a width-tiled conv layer.

    ``f0:f1`` are the output columns this strip produces; ``lo:hi`` the
    padded input columns it streams (halo columns overlap between
    strips, exactly like re-streaming them on hardware).  ``sched`` is
    the strip's own compiled schedule (pad = 0 — the strip is cut from
    an explicitly pre-padded IFM)."""

    f0: int
    f1: int
    lo: int
    hi: int
    sched: BlockSchedule


def compile_conv_strips(
    name: str,
    h: int,
    w: int,
    c_in: int,
    c_out: int,
    k: int = 3,
    stride: int = 1,
    pad: int = 1,
    pack: int = 1,
    c_splits: int = 1,
    pool_k: int = 0,
    pool_s: int = 0,
    activation: Optional[str] = "relu",
    capacity: int = TABLE_CAPACITY,
) -> Tuple[ConvStrip, ...]:
    """Width-tile a layer whose period W + 2P exceeds the schedule table
    (the compiler's own suggested fix): split the output columns into
    strips narrow enough that each strip's period fits ``capacity``, and
    compile one schedule per strip.  The same physical tile chain runs
    the strips back to back with re-loaded tables; halo input columns are
    re-streamed at strip boundaries.

    Strips are cut in *padded* coordinates: output column y reads padded
    input columns [y*s, y*s + k), so callers pre-pad the IFM explicitly
    and slice ``[lo, hi)`` per strip (each strip schedule uses pad=0).
    Pooling constrains strip boundaries to multiples of the pool stride
    so no pooling window straddles a strip.
    """
    f_total = (w + 2 * pad - k + stride) // stride
    max_f = (capacity - k) // stride + 1
    if pool_s:
        if f_total % pool_s:
            raise ValueError(
                f"{name}: pooling {pool_s} does not tile the {f_total}-wide "
                "OFM; cannot width-strip")
        max_f -= max_f % pool_s
    if max_f < 1:
        raise ValueError(
            f"{name}: kernel {k} / stride {stride} / pool {pool_s} leave no "
            f"feasible strip width under the {capacity}-entry table")
    strips = []
    f0 = 0
    while f0 < f_total:
        f1 = min(f_total, f0 + max_f)
        lo = f0 * stride
        hi = (f1 - 1) * stride + k
        sched = compile_conv_block(
            f"{name}[{f0}:{f1}]", h=h + 2 * pad, w=hi - lo,
            c_in=c_in, c_out=c_out, k=k, stride=stride, pad=0,
            pack=pack, c_splits=c_splits, pool_k=pool_k, pool_s=pool_s,
            activation=activation)
        strips.append(ConvStrip(f0=f0, f1=f1, lo=lo, hi=hi, sched=sched))
        f0 = f1
    return tuple(strips)


def compile_tail(pool_k: int, pool_s: int,
                 activation: Optional[str]) -> TailProgram:
    """M-type table for the block tail: activation on every output, plus the
    paper's Fig. 9 max-pool compare/store pattern (period S_p * S_p events,
    the paper's p = 2*S_p at two events/slot).

    Generalized over the pool stride (the paper evaluates K_p = S_p = 2;
    any non-overlapping K_p == S_p >= 2 window compiles):

    * ``ypar == 0``        -> POOL_STORE: latch the window-row running max;
    * ``ypar  > 0``        -> POOL_MAX: fold the next column in;
    * row end (``ypar == S_p-1``), non-final row -> +POOL_STORE: merge the
      row max into the row buffer;
    * final event of the window -> +POOL_OUT: emit the pooled result.
    """
    act = ACT_EN if activation else 0
    if pool_s == 0:
        table = [Instruction(Opcode.M, func=act).encode()]
        return TailProgram(tuple(table), 0, 0, activation)
    if pool_k != pool_s:
        raise NotImplementedError(
            f"overlapping pooling (K_p={pool_k} != S_p={pool_s}) needs more "
            "than one pooling register (paper Fig. 9 covers K_p == S_p)")
    assert pool_s >= 2
    table = []
    for xpar in range(pool_s):
        for ypar in range(pool_s):
            func = act
            if ypar == 0:
                func |= POOL_STORE  # start this window-row's running max
            else:
                func |= POOL_MAX  # compare with the running row max
                if ypar == pool_s - 1:
                    if xpar < pool_s - 1:
                        func |= POOL_STORE  # row max into the row buffer
                    else:
                        func |= POOL_OUT  # emit pooled result
            table.append(Instruction(Opcode.M, func=func).encode())
    return TailProgram(tuple(table), pool_k, pool_s, activation)


def compile_fc_block(name: str, c_in: int, c_out: int, n_c: int, n_m: int,
                     activation: Optional[str] = None):
    """FC mapping (paper Fig. 4): m_t x m_a grid; psums add down columns.

    Returns (m_t, m_a, tables) where tables[i][j] is the encoded M-type
    table for grid tile (i, j): FC_MODE + FROM_PE, the psum chain-add
    encoded as the *rx* north-receive enable (set only for non-head
    rows, which are the only tiles with an upstream psum), activation at
    column tails only.

    Encoding note: the chain-add used to be emitted as the C-type
    ``SUM_ADD`` bit inside this M-type word — but func bit 0 means
    ``ACT_EN`` in the M-type namespace, so every non-head grid tile also
    decoded "apply activation", and ``simulate_fc`` ReLU-clipped
    *intermediate* partial sums whenever one went negative (diverging
    from the jax reference ``relu(x @ W)`` on deep chains — the
    VGG-16/19 FC heads).  The rx field says the same thing without the
    alias, and ``ACT_EN`` is now unambiguous.
    """
    m_t = math.ceil(c_in / n_c)
    m_a = math.ceil(c_out / n_m)
    tables = []
    for i in range(m_t):
        row = []
        for j in range(m_a):
            func = FC_MODE | FROM_PE
            rx = (1 << int(Port.N)) if i > 0 else 0
            tx = 0 if i == m_t - 1 else (1 << int(Port.S))
            instr = Instruction(Opcode.M, rx=rx, func=func, tx=tx)
            if i == m_t - 1 and activation:
                instr = instr.with_flags(ACT_EN)
            row.append((instr.encode(),))
        tables.append(row)
    return m_t, m_a, tables
