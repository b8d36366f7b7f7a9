"""Pluggable placement strategies (the DSE's spatial axis).

A *placement strategy* maps a :class:`~repro_torch.core.mapping.NetworkPlan`
onto a mesh by choosing the tile-id -> coordinate curve
(:attr:`MeshNoC.order`); block spans along the curve are fixed (tiles of
a block are consecutive ids — the simulator, schedule compiler and
energy model all rely on that), so the curve *is* the placement.

Every strategy here emits a **unit-step curve** (consecutive tile ids sit
on physically adjacent cells).  That is the correctness envelope: the
per-cycle interpreter's schedule-table rendezvous gives a chain psum
``pack + 1`` cycles of slack (1 cycle for channel-split links) and a
group-sum ``W + 2P + group_size`` cycles, so any unit-step curve keeps
every packet on time and the OFM bitwise-equal to the snake baseline —
placement changes hops and energy, never math.
:func:`validate_placement` checks the (conservative) slack bounds; the
DSE search drops any candidate that violates them.

Strategies:

* ``snake``          — the default baseline (row serpentine), any aspect;
* ``boustrophedon``  — serpentine over row *bands* of height ``band``
  (vertical zigzag inside each band), trading row-major locality for
  square-ish neighborhoods the size of a chain group;
* ``hilbert``        — generalized Hilbert curve for arbitrary
  rectangles (Červený's "gilbert" construction), maximal locality;
* ``greedy``         — traffic-aware self-avoiding walk: each next tile
  takes the free neighbor cell minimizing byte-weighted distance to its
  already-placed link partners (group peers, OFM producers), with a
  Warnsdorff tie-break to avoid walling itself in.
"""
from __future__ import annotations

import math
from collections import defaultdict, deque
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Protocol, Sequence, Tuple

from repro_torch.configs.cnn import CNNConfig, ConvLayer
from repro_torch.core.mapping import NetworkPlan
from repro_torch.core.noc import MeshNoC, Placement, block_spans
from repro_torch.core.transport import (
    CHAIN,
    GROUP,
    OFM,
    PSUM_BYTES,
    RESIDUAL,
    SPLIT,
    conv_links,
)

#: the IFM pixel stream flowing tile-to-tile along a chain (accounted
#: analytically in core/energy.py; a first-class link here because it
#: loads the physical links a placement routes over)
IFM = "ifm"


# ---------------------------------------------------------------------------
# Analytic link model: every (src, dst, bytes) the network moves per
# inference, on local-to-global consecutive tile ids.  Shared by the
# greedy strategy (placement cost) and the search scorer (byte-hops /
# hotspot metrics) — and consistent with what core/energy.py accounts.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Link:
    src: int
    dst: int
    kind: str
    nbytes: float  # byte volume per inference over this logical link


def network_links(plan: NetworkPlan,
                  cnn: Optional[CNNConfig] = None) -> List[Link]:
    """Whole-network logical links with per-inference byte volumes.

    Covers every duplicated copy and m-split chain (the energy model's
    accounting), the IFM stream along each chain, FC grid column links,
    and inter-block OFM streams.  Pass the ``cnn`` config to also derive
    ResNet shortcut (RESIDUAL) links, mirroring the
    ``core/network.py`` wiring convention exactly.
    """
    starts, ends = block_spans(plan)
    links: List[Link] = []
    for li, lp in enumerate(plan.layers):
        if lp.kind == "conv":
            group_size = lp.chain_len // lp.k
            fires = lp.out_pixels / lp.duplication
            ifm_bytes = (lp.in_pixels / lp.duplication) * lp.c_in
            for d in range(lp.duplication):
                for j in range(lp.m_splits):
                    base = (starts[li] + d * lp.tiles_per_copy
                            + j * lp.chain_len)
                    m_slice = min(plan.n_m, lp.c_out - j * plan.n_m)
                    psum = fires * m_slice * PSUM_BYTES
                    for s, t, kind in conv_links(lp.k, group_size):
                        links.append(Link(base + s, base + t, kind, psum))
                    for t in range(lp.chain_len - 1):
                        links.append(Link(base + t, base + t + 1, IFM,
                                          ifm_bytes))
        else:
            # FC grid (Fig. 4): m_t x m_a, psums add down columns
            m_t, m_a = lp.c_splits, lp.m_splits
            base = starts[li]
            for j in range(m_a):
                m_slice = min(plan.n_m, lp.c_out - j * plan.n_m)
                for i in range(m_t - 1):
                    links.append(Link(base + i * m_a + j,
                                      base + (i + 1) * m_a + j,
                                      SPLIT, m_slice * PSUM_BYTES))
    for li in range(len(plan.layers) - 1):
        nbytes = plan.layers[li].out_pixels * plan.layers[li].c_out
        links.append(Link(ends[li], starts[li + 1], OFM, nbytes))
    if cnn is not None:
        links.extend(_residual_links(plan, cnn, starts, ends))
    return links


def _residual_links(plan: NetworkPlan, cnn: CNNConfig,
                    starts: Sequence[int], ends: Sequence[int]
                    ) -> Iterator[Link]:
    """ResNet shortcut streams, following core/network.py: the block
    input saved at a ``*_a`` layer travels from its producer block's tail
    to the join site (identity) or through the ``*_sc`` projection block
    (two legs)."""
    layers = list(cnn.layers)
    save_src: Optional[int] = None  # layer idx producing the saved input
    prev: Optional[int] = None
    for li, layer in enumerate(layers):
        if not isinstance(layer, ConvLayer):
            prev = li
            continue
        if layer.name.endswith("_a"):
            save_src = prev
        if layer.residual_from is not None:
            # saved tensor is the *_a layer's input: H * W * C of the
            # layer named by residual_from
            a = next(l for l in layers if l.name == layer.residual_from)
            saved_bytes = a.h * a.w * a.c
            nxt = layers[li + 1] if li + 1 < len(layers) else None
            if isinstance(nxt, ConvLayer) and nxt.name.endswith("_sc"):
                lp_sc = plan.layers[li + 1]
                if save_src is not None:
                    yield Link(ends[save_src], starts[li + 1], RESIDUAL,
                               saved_bytes)
                yield Link(ends[li + 1], ends[li], RESIDUAL,
                           lp_sc.out_pixels * lp_sc.c_out)
            elif save_src is not None:
                yield Link(ends[save_src], ends[li], RESIDUAL, saved_bytes)
        if not layer.name.endswith("_sc"):
            # a projection runs beside its target block; what the next
            # *_a layer saves is the value leaving the *main* block's
            # tail (after the add) — mirroring _Stage.prev_li in
            # core/network.py, which never points at an _sc layer
            prev = li


# ---------------------------------------------------------------------------
# Curves
# ---------------------------------------------------------------------------


def _sgn(x: int) -> int:
    return (x > 0) - (x < 0)


def _gilbert(x: int, y: int, ax: int, ay: int, bx: int, by: int
             ) -> Iterator[Tuple[int, int]]:
    """Generalized Hilbert curve over the rectangle spanned by vectors
    (ax, ay) x (bx, by) from (x, y) — Červený's recursion; every step is
    a unit step for any rectangle size."""
    w, h = abs(ax + ay), abs(bx + by)
    dax, day = _sgn(ax), _sgn(ay)
    dbx, dby = _sgn(bx), _sgn(by)
    if h == 1:
        for _ in range(w):
            yield (x, y)
            x, y = x + dax, y + day
        return
    if w == 1:
        for _ in range(h):
            yield (x, y)
            x, y = x + dbx, y + dby
        return
    ax2, ay2 = ax // 2, ay // 2
    bx2, by2 = bx // 2, by // 2
    w2, h2 = abs(ax2 + ay2), abs(bx2 + by2)
    if 2 * w > 3 * h:
        if (w2 % 2) and (w > 2):
            ax2, ay2 = ax2 + dax, ay2 + day
        yield from _gilbert(x, y, ax2, ay2, bx, by)
        yield from _gilbert(x + ax2, y + ay2, ax - ax2, ay - ay2, bx, by)
    else:
        if (h2 % 2) and (h > 2):
            bx2, by2 = bx2 + dbx, by2 + dby
        yield from _gilbert(x, y, bx2, by2, ax2, ay2)
        yield from _gilbert(x + bx2, y + by2, ax, ay, bx - bx2, by - by2)
        yield from _gilbert(x + (ax - dax) + (bx2 - dbx),
                            y + (ay - day) + (by2 - dby),
                            -bx2, -by2, -(ax - ax2), -(ay - ay2))


def gilbert_curve(rows: int, cols: int) -> Tuple[Tuple[int, int], ...]:
    """(row, col) visit order of the generalized Hilbert curve."""
    if cols >= rows:
        pts = _gilbert(0, 0, cols, 0, 0, rows)
    else:
        pts = _gilbert(0, 0, 0, rows, cols, 0)
    return tuple((y, x) for x, y in pts)


def band_serpentine_curve(rows: int, cols: int, band: int
                          ) -> Tuple[Tuple[int, int], ...]:
    """Serpentine over row bands of height ``band``: vertical zigzag
    within a band, bands alternating left->right / right->left.  Unit-
    step requires an odd column count (so each band's last column runs
    downward into the next band) — callers widen the mesh to odd cols.
    """
    if cols % 2 == 0:
        raise ValueError("band serpentine needs an odd column count "
                         f"for a unit-step curve (got {cols})")
    curve: List[Tuple[int, int]] = []
    r0, right = 0, True
    while r0 < rows:
        b = min(band, rows - r0)
        cols_iter = range(cols) if right else range(cols - 1, -1, -1)
        down = True
        for c in cols_iter:
            rs = range(r0, r0 + b) if down else range(r0 + b - 1, r0 - 1, -1)
            curve.extend((r, c) for r in rs)
            down = not down
        r0 += b
        right = not right
    return tuple(curve)


# ---------------------------------------------------------------------------
# Strategies
# ---------------------------------------------------------------------------


def _mesh_shape(total: int, rows: Optional[int], cols: Optional[int]
                ) -> Tuple[int, int]:
    if rows is None and cols is None:
        side = math.ceil(math.sqrt(total))
        return side, side
    if rows is None:
        rows = math.ceil(total / cols)
    elif cols is None:
        cols = math.ceil(total / rows)
    if rows * cols < total:
        raise ValueError(f"{total} tiles do not fit a {rows}x{cols} mesh")
    return rows, cols


class PlacementStrategy(Protocol):
    """A deterministic NetworkPlan -> Placement mapper."""

    name: str

    def place(self, plan: NetworkPlan, rows: Optional[int] = None,
              cols: Optional[int] = None) -> Placement: ...


class SnakePlacement:
    """The default baseline: row-serpentine curve (MeshNoC's default)."""

    name = "snake"

    def place(self, plan: NetworkPlan, rows: Optional[int] = None,
              cols: Optional[int] = None) -> Placement:
        r, c = _mesh_shape(plan.total_tiles, rows, cols)
        return Placement(MeshNoC(rows=r, cols=c), *block_spans(plan),
                         strategy=self.name)


class BoustrophedonBlockPlacement:
    """Band serpentine: vertical zigzag in ``band``-row bands.  Keeps
    ids ``band`` apart adjacent (good when group_size ~ band), at the
    cost of one extra column when the requested width is even."""

    name = "boustrophedon"

    def __init__(self, band: int = 2):
        if band < 1:
            raise ValueError(f"band must be >= 1, got {band}")
        self.band = band

    def place(self, plan: NetworkPlan, rows: Optional[int] = None,
              cols: Optional[int] = None) -> Placement:
        r, c = _mesh_shape(plan.total_tiles, rows, cols)
        if c % 2 == 0:
            c += 1  # unit-step band transitions need odd width
        curve = band_serpentine_curve(r, c, self.band)
        noc = MeshNoC(rows=r, cols=c, order=curve)
        return Placement(noc, *block_spans(plan), strategy=self.name)


class HilbertPlacement:
    """Generalized Hilbert curve: consecutive ids adjacent, and ids a
    small gap apart stay physically close — the locality that shortens
    group-sum and shortcut routes."""

    name = "hilbert"

    def place(self, plan: NetworkPlan, rows: Optional[int] = None,
              cols: Optional[int] = None) -> Placement:
        r, c = _mesh_shape(plan.total_tiles, rows, cols)
        # the gilbert construction takes one diagonal step when the major
        # dimension is odd and the minor even — widen the major side to
        # even so the curve is strictly unit-step
        if max(r, c) % 2 and min(r, c) % 2 == 0:
            if r >= c:
                r += 1
            else:
                c += 1
        noc = MeshNoC(rows=r, cols=c, order=gilbert_curve(r, c))
        return Placement(noc, *block_spans(plan), strategy=self.name)


class GreedyTrafficPlacement:
    """Traffic-aware self-avoiding walk.

    Places tile ids in order; each id takes the free 4-neighbor of the
    previous id's cell that minimizes the byte-weighted Manhattan
    distance to its already-placed link partners (from
    :func:`network_links` — group peers, OFM/residual producers), with a
    Warnsdorff tie-break (fewest onward free neighbors first) so the
    walk doesn't wall itself in.  If the walk is ever trapped, the
    nearest free cell (BFS) continues it — that jump may break the
    rendezvous slack, which :func:`validate_placement` will flag and the
    search will then drop the candidate.
    """

    name = "greedy"

    def __init__(self, cnn: Optional[CNNConfig] = None):
        self.cnn = cnn  # optional: adds residual links to the cost

    def place(self, plan: NetworkPlan, rows: Optional[int] = None,
              cols: Optional[int] = None) -> Placement:
        r, c = _mesh_shape(plan.total_tiles, rows, cols)
        total = plan.total_tiles
        incoming: Dict[int, List[Tuple[int, float]]] = defaultdict(list)
        for ln in network_links(plan, self.cnn):
            lo, hi = min(ln.src, ln.dst), max(ln.src, ln.dst)
            if hi != lo + 1:  # adjacency to the previous id is free anyway
                incoming[hi].append((lo, ln.nbytes))
        pos: List[Tuple[int, int]] = []
        free = {(i, j) for i in range(r) for j in range(c)}

        def neighbors(cell: Tuple[int, int]) -> List[Tuple[int, int]]:
            i, j = cell
            return [n for n in ((i - 1, j), (i + 1, j), (i, j - 1),
                                (i, j + 1)) if n in free]

        for t in range(total):
            if t == 0:
                cell = (0, 0)
            else:
                cand = neighbors(pos[-1])
                if not cand:  # trapped: BFS to the nearest free cell
                    cell = self._bfs_nearest(pos[-1], free, r, c)
                else:
                    def cost(n: Tuple[int, int]) -> Tuple[float, int,
                                                          Tuple[int, int]]:
                        w = sum(
                            nb * (abs(n[0] - pos[u][0])
                                  + abs(n[1] - pos[u][1]))
                            for u, nb in incoming.get(t, ()))
                        return (w, len(neighbors(n)), n)
                    cell = min(cand, key=cost)
            pos.append(cell)
            free.discard(cell)
        # the curve must cover the whole mesh: unused cells follow in
        # deterministic scan order (no tile ever lands on them)
        order = tuple(pos) + tuple(sorted(free))
        noc = MeshNoC(rows=r, cols=c, order=order)
        return Placement(noc, *block_spans(plan), strategy=self.name)

    @staticmethod
    def _bfs_nearest(start: Tuple[int, int], free: set, r: int, c: int
                     ) -> Tuple[int, int]:
        seen = {start}
        q = deque([start])
        while q:
            i, j = q.popleft()
            for n in ((i - 1, j), (i + 1, j), (i, j - 1), (i, j + 1)):
                if not (0 <= n[0] < r and 0 <= n[1] < c) or n in seen:
                    continue
                if n in free:
                    return n
                seen.add(n)
                q.append(n)
        raise RuntimeError("no free cell left on the mesh")


def strategies(cnn: Optional[CNNConfig] = None, band: int = 2
               ) -> Dict[str, PlacementStrategy]:
    """The standard strategy set, keyed by name."""
    return {
        s.name: s for s in (
            SnakePlacement(),
            BoustrophedonBlockPlacement(band=band),
            HilbertPlacement(),
            GreedyTrafficPlacement(cnn=cnn),
        )
    }


# ---------------------------------------------------------------------------
# Feasibility: the rendezvous-slack validator
# ---------------------------------------------------------------------------


def validate_placement(plan: NetworkPlan, placement: Placement
                       ) -> List[str]:
    """Check a placement keeps every routed packet within the schedule
    tables' rendezvous slack; returns a list of violations (empty = ok).

    Conservative bounds (derived in core/schedule.py's timing model):

    * channel-split chain link (same tap, next slice): 1 hop;
    * tap-to-tap chain link: ``pack_next + 1`` hops;
    * group link (tail -> next tail): ``group_size`` hops (the true
      slack is ``W + 2P + group_size``; any unit-step curve already
      satisfies the tighter bound, so we don't need the layer width).

    Also checks the curve is a bijection onto the mesh and every tile id
    fits.

    Works unchanged on a two-level :class:`~repro_torch.core.noc.ChipletFabric`:
    every rendezvoused link is within one block, blocks never span
    chiplets (``shard_network`` cuts at stage boundaries), so ``hops``
    resolves on the owning chiplet's local snake mesh and the slack
    bounds apply as-is — only the bulk OFM/residual streams ever cross
    the interposer, and those are not rendezvoused.
    """
    errs: List[str] = []
    noc = placement.noc
    if noc.num_tiles < plan.total_tiles:
        errs.append(f"{plan.total_tiles} tiles on a {noc.rows}x{noc.cols} "
                    "mesh")
        return errs
    if noc.order is not None and len(set(noc.order)) != noc.num_tiles:
        errs.append("curve is not a bijection onto the mesh")
        return errs
    for li, lp in enumerate(plan.layers):
        if lp.kind != "conv":
            continue  # FC grid psums are bulk-recorded, not rendezvoused
        group_size = lp.chain_len // lp.k
        tiles_per_row = group_size // lp.c_splits
        for d in range(lp.duplication):
            for j in range(lp.m_splits):
                base = placement.chain_base(
                    li, d, j, tiles_per_copy=lp.tiles_per_copy,
                    chain_len=lp.chain_len)
                for i in range(lp.k):
                    g0 = base + i * group_size
                    for u in range(tiles_per_row):
                        for sc in range(lp.c_splits):
                            t = g0 + u * lp.c_splits + sc
                            if sc < lp.c_splits - 1:
                                slack = 1
                            elif u < tiles_per_row - 1:
                                pack_next = min(lp.pack,
                                                lp.k - (u + 1) * lp.pack)
                                slack = pack_next + 1
                            else:
                                break
                            h = noc.hops(t, t + 1)
                            if h > slack:
                                errs.append(
                                    f"{plan.model} L{li} chain link "
                                    f"{t}->{t + 1}: {h} hops > slack "
                                    f"{slack}")
                    if i < lp.k - 1:
                        tail = g0 + group_size - 1
                        h = noc.hops(tail, tail + group_size)
                        if h > group_size:
                            errs.append(
                                f"{plan.model} L{li} group link "
                                f"{tail}->{tail + group_size}: {h} hops > "
                                f"slack {group_size}")
    return errs
