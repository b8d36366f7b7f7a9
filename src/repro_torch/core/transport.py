"""Unified NoC transport layer (the paper's §3 mesh fabric, shared by the
cycle-level simulator and the analytic energy model).

Every packet the Domino dataflow moves — chain psums hopping east along a
group, group-sums travelling south between group tails, FC-split psums,
and inter-block OFM streams — is delivered through :class:`NoCTransport`,
which resolves the physical route via :meth:`MeshNoC.route` and accounts
byte-hops per traffic class.  The analytic side
(:func:`conv_block_traffic`) walks the *same* link list through the *same*
``MeshNoC`` hop function, so for any placed chain the simulator's
counters equal the energy model's counts **by construction** —
cross-validated for every benchmark geometry in
``tests/test_transport.py``.  (Network-wide, the energy model spreads
output pixels over all weight-duplicated copies at their own placed
bases, while the functional simulator drives copy 0 — CHAIN and OFM
totals still agree exactly because those links are snake-adjacent;
routed GROUP totals differ by the copies' differing bases.)

Payloads are ``(B, C)`` arrays: one routed packet carries the whole batch
lane-parallel (the serving direction), so hop/byte counters are
*per-inference* regardless of batch size.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple

from repro_torch.core.noc import MeshNoC

#: partial/group-sums are carried at 16b on the Domino NoC (Tab. 3)
PSUM_BYTES = 2

# traffic classes (the IFM pixel stream is accounted analytically in
# core/energy.py — every padded pixel makes one hop per chain tile)
CHAIN = "chain"    # psum tile -> next tile within a group (east)
GROUP = "group"    # group-sum tail -> next group tail (south)
SPLIT = "split"    # FC-grid psum columns (Fig. 4)
OFM = "ofm"        # block tail -> next block head (inter-layer stream)
RESIDUAL = "residual"  # ResNet shortcut stream (block input -> add site)
#: interposer hops of any flow crossing chiplets on a ChipletFabric —
#: a *level*, not a dataflow: a cross-chiplet OFM stream charges its
#: mesh hops under "ofm" and its gateway-to-gateway hops under "noi",
#: so per-class counters stay per-level exact.  Never charged on a flat
#: mesh (zero NoI hops keeps the counters dict identical).
NOI = "noi"


@dataclass
class TrafficCounters:
    """Per-class routed-traffic totals (all integers, per inference)."""

    byte_hops: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    packets: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    hops: Dict[str, int] = field(default_factory=lambda: defaultdict(int))

    def add(self, kind: str, hops: int, nbytes: int, count: int = 1) -> None:
        """Account ``count`` identical packets of ``nbytes`` over ``hops``."""
        self.packets[kind] += count
        self.hops[kind] += count * hops
        self.byte_hops[kind] += count * hops * nbytes


class NoCTransport:
    """Routed, latency-accurate packet delivery for one placed block.

    ``base`` maps the block's local tile ids onto the global mesh; several
    transports may share one :class:`MeshNoC` and one
    :class:`TrafficCounters` (whole-network simulation) while keeping
    private mailboxes.
    """

    def __init__(self, noc: MeshNoC, base: int = 0,
                 counters: Optional[TrafficCounters] = None,
                 recorder: Optional[Any] = None):
        self.noc = noc
        self.base = base
        self.counters = counters if counters is not None else TrafficCounters()
        # optional per-link telemetry hook (repro.telemetry.LinkRecorder):
        # called with global tile ids for every accounting record; the
        # default None keeps the hot path at a single identity test
        self.recorder = recorder
        # (cycle, local_dst, port) -> payload list, FIFO per link
        self._mail: Dict[Tuple[int, int, str], List[Any]] = defaultdict(list)

    def hops(self, src: int, dst: int) -> int:
        """Physical route length between two *local* tile ids."""
        return self.noc.hops(self.base + src, self.base + dst)

    def _account(self, src: int, dst: int, kind: str, nbytes: int,
                 count: int) -> int:
        """Shared two-level accounting: per-link traffic, per-class
        counters (intra-mesh hops under ``kind``, interposer hops under
        :data:`NOI`) and the telemetry record.  On a flat mesh the NoI
        level is identically zero, so nothing new is charged and the
        counters stay byte-identical to the single-level accounting.
        Returns the total route length."""
        gsrc, gdst = self.base + src, self.base + dst
        h_mesh, h_noi = self.noc.hop_levels(gsrc, gdst)
        self.noc.add_traffic(gsrc, gdst, nbytes * count)
        self.counters.add(kind, h_mesh, nbytes, count=count)
        if h_noi:
            self.counters.add(NOI, h_noi, nbytes, count=count)
        if self.recorder is not None:
            self.recorder.record(gsrc, gdst, kind, nbytes, count,
                                 h_mesh + h_noi)
        return h_mesh + h_noi

    def send(self, cycle: int, src: int, dst: int, port: str, payload: Any,
             kind: str, nbytes: int) -> int:
        """Route a packet; returns its arrival cycle (1 cycle / hop).

        The XY route over the snake-placed mesh is never longer than the
        logical chain distance (each snake step is one physical hop), so
        arrivals never miss their schedule-table rendezvous slot.
        """
        h = self._account(src, dst, kind, nbytes, 1)
        arrival = cycle + max(1, h)
        self._mail[(arrival, dst, port)].append(payload)
        return arrival

    def record(self, src: int, dst: int, kind: str, nbytes: int) -> int:
        """Account a routed bulk transfer without mailbox delivery (used
        for OFM/IFM streams between sequentially simulated blocks).
        Returns the route length."""
        return self._account(src, dst, kind, nbytes, 1)

    def record_bulk(self, src: int, dst: int, kind: str, nbytes: int,
                    count: int) -> int:
        """Account ``count`` identical routed packets of ``nbytes`` each in
        one call (the trace backend's whole-block accounting).  Equivalent
        to ``count`` :meth:`record` calls — counters and per-link traffic
        are additive.  Returns the route length."""
        return self._account(src, dst, kind, nbytes, count)

    def deliver(self, cycle: int, dst: int, port: str) -> Iterator[Any]:
        """Pop every packet arriving at (dst, port) this cycle."""
        key = (cycle, dst, port)
        if key in self._mail:
            yield from self._mail.pop(key)


# ---------------------------------------------------------------------------
# Analytic traffic (the energy model's side of the by-construction equality)
# ---------------------------------------------------------------------------


def conv_links(k: int, group_size: int) -> List[Tuple[int, int, str]]:
    """Logical link list of a compiled conv chain: ``k`` groups of
    ``group_size`` tiles; psums hop east within a group, the group tail
    forwards the running group-sum south to the next tail."""
    links: List[Tuple[int, int, str]] = []
    chain = k * group_size
    for t in range(chain):
        if (t + 1) % group_size != 0:
            links.append((t, t + 1, CHAIN))
        elif t != chain - 1:
            links.append((t, t + group_size, GROUP))
    return links


def conv_block_traffic(noc: MeshNoC, base: int, k: int, group_size: int,
                       fires: int, payload_bytes: int) -> TrafficCounters:
    """Analytic routed traffic of one placed conv chain.

    Every link carries one ``payload_bytes`` packet per output pixel
    (``fires`` = E*F), routed over the same mesh the simulator uses.
    """
    cnt = TrafficCounters()
    for src, dst, kind in conv_links(k, group_size):
        h = noc.hops(base + src, base + dst)
        cnt.packets[kind] += fires
        cnt.hops[kind] += fires * h
        cnt.byte_hops[kind] += fires * h * payload_bytes
    return cnt


def conv_block_byte_hops(noc: MeshNoC, base: int, k: int, group_size: int,
                         fires: float, payload_bytes: float
                         ) -> Dict[str, float]:
    """Float variant for the energy model (fires may be fractional when
    output pixels are spread over weight-duplicated copies).

    Every link — chain links included — is routed through the (memoized)
    ``MeshNoC.hops``, so the energy model tracks whatever tile-id curve
    the placement injected.  On the default snake curve consecutive ids
    are adjacent *by construction*, so chain links keep the constant-1
    fast path (the energy model builds a fresh mesh per call — cold
    lookups for every placed copy would dominate its wall time).
    """
    out = {CHAIN: 0.0, GROUP: 0.0}
    snake = noc.order is None
    for src, dst, kind in conv_links(k, group_size):
        h = 1 if (snake and kind == CHAIN) \
            else noc.hops(base + src, base + dst)
        out[kind] += fires * h * payload_bytes
    return out
