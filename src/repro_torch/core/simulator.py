"""The FC grid of the Domino simulator on torch tensors — the parts of
``repro/core/simulator.py`` the trace backend runs.

``SimCounters`` and the standalone transport are host code copied from
the reference.  :func:`simulate_fc` walks the same ``compile_fc_block``
instruction words for the counters and traffic; the exact engine MACs
each grid tile and accumulates the column chain on the device, a
quantized engine computes the whole layer's code sums in one kernel
call.  The per-cycle
``BlockSimulator`` interpreter is not ported: it stays the oracle in
the reference package.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.core.instructions import ACT_EN, FROM_PE, Instruction, Port
from repro_torch.core.noc import MeshNoC
from repro_torch.core.schedule import compile_fc_block
from repro_torch.core.transport import SPLIT, PSUM_BYTES, NoCTransport


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
