"""Domino instruction set (paper §6.1, Tab. 2).

16-bit instructions, two opcodes:

* **C-type** (convolution control): ``Rx Ctrl [15:11] | Sum/Buffer [10:5]
  | Tx Ctrl [4:1] | Opc [0]``
* **M-type** (miscellaneous: activation / pooling / FC): ``Rx Ctrl
  [15:11] | Func [10:5] | Tx Ctrl [4:1] | Opc [0]``

Packets on the Domino NoC carry *payload only* — no headers — so these
control words are the sole arbiter of what each Rofm does each cycle.
The schedule compiler (``core/schedule.py``) emits periodic tables of
these words; the functional simulator (``core/simulator.py``) executes
tiles *strictly from decoded instructions*, which is what the tests use
to prove the ISA is sufficient to run real convolutions.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from enum import IntEnum
from typing import List


class Opcode(IntEnum):
    C = 0  # convolution dataflow control
    M = 1  # miscellaneous: activation, pooling, FC control


class Port(IntEnum):
    N = 0
    E = 1
    S = 2
    W = 3
    LOCAL = 4  # Rifm shortcut / local PE


# --- Sum/Buffer field bits (C-type) ---------------------------------------
SUM_ADD = 1 << 0      # add incoming packet to the selected operand
FROM_PE = 1 << 1      # operand includes local PE output this cycle
BUF_PUSH = 1 << 2     # push result into Rofm buffer (wait for group peer)
BUF_POP = 1 << 3      # pop Rofm buffer head as second operand
SHORTCUT = 1 << 4     # take operand from the Rifm->Rofm shortcut (ResUnit)
EVICT = 1 << 5        # drop buffer head (group-sum no longer needed)

# --- Func field bits (M-type) ----------------------------------------------
ACT_EN = 1 << 0       # apply activation (last tile of a block)
POOL_MAX = 1 << 1     # max-pooling comparator
POOL_AVG = 1 << 2     # average pooling (multiplier + adder)
FC_MODE = 1 << 3      # FC layer control
POOL_STORE = 1 << 4   # store current value into pooling register
POOL_OUT = 1 << 5     # emit pooled result


@dataclass(frozen=True)
class Instruction:
    """One decoded 16-bit Domino instruction."""

    opcode: Opcode = Opcode.C
    rx: int = 0    # 5 bits: receive-enable per Port (N,E,S,W,LOCAL)
    func: int = 0  # 6 bits: SUM_*/BUF_* (C) or ACT/POOL/FC (M)
    tx: int = 0    # 4 bits: transmit-enable per direction (N,E,S,W)

    # -- encoding ------------------------------------------------------------

    def encode(self) -> int:
        assert 0 <= self.rx < 32 and 0 <= self.func < 64 and 0 <= self.tx < 16
        word = (self.rx << 11) | (self.func << 5) | (self.tx << 1) | int(self.opcode)
        assert 0 <= word < (1 << 16)
        return word

    @staticmethod
    def decode(word: int) -> "Instruction":
        assert 0 <= word < (1 << 16), f"not a 16-bit word: {word}"
        return Instruction(
            opcode=Opcode(word & 1),
            tx=(word >> 1) & 0xF,
            func=(word >> 5) & 0x3F,
            rx=(word >> 11) & 0x1F,
        )

    # -- convenience ----------------------------------------------------------

    def rx_from(self, port: Port) -> bool:
        return bool(self.rx & (1 << int(port)))

    def tx_to(self, port: Port) -> bool:
        return bool(self.tx & (1 << int(port)))

    def has(self, flag: int) -> bool:
        return bool(self.func & flag)

    def with_flags(self, *flags: int) -> "Instruction":
        f = self.func
        for fl in flags:
            f |= fl
        return replace(self, func=f)

    @property
    def is_nop(self) -> bool:
        return self.rx == 0 and self.func == 0 and self.tx == 0

    def __repr__(self) -> str:  # compact disassembly
        rx = "".join(p.name[0] for p in Port if self.rx_from(p))
        tx = "".join(p.name[0] for p in Port if p != Port.LOCAL and self.tx_to(p))
        if self.opcode == Opcode.C:
            names = ["ADD", "PE", "PUSH", "POP", "SC", "EV"]
        else:
            names = ["ACT", "PMAX", "PAVG", "FC", "PST", "POUT"]
        f = "+".join(n for i, n in enumerate(names) if self.func & (1 << i))
        return f"<{self.opcode.name} rx={rx or '-'} {f or 'nop'} tx={tx or '-'}>"


NOP = Instruction()


def assemble(instrs: List[Instruction]) -> List[int]:
    return [i.encode() for i in instrs]


def disassemble(words: List[int]) -> List[Instruction]:
    return [Instruction.decode(w) for w in words]


#: Rofm schedule-table capacity: 16b x 128 entries (Tab. 3)
TABLE_CAPACITY = 128
