"""NoC topology models: flat 2-D mesh and the two-level chiplet fabric.

The flat :class:`MeshNoC` (placement, XY routing, link accounting) is
used by the energy model (inter-block OFM traffic hops), the
whole-network simulator (shared routed transport) and the design-space
explorer (``repro/dse``), which injects alternative tile-id ->
coordinate curves (``MeshNoC.order``) instead of the default snake.

Scale-out composes meshes into a :class:`ChipletFabric`: per-chiplet
``MeshNoC`` instances joined by a :class:`NoITopology` — a
Network-on-Interposer described by a CHIPSIM-style adjacency-matrix CSV
(``src/repro_torch/configs/noi/``; ``mesh`` and ``floret`` ship).  The fabric
duck-types the full ``MeshNoC`` interface (``coord``/``hops``/``route``/
``add_traffic``/``link_traffic``/…), so :class:`Placement`, the routed
transport, the simulator and the DSE all work unchanged on either level;
:meth:`ChipletFabric.hop_levels` additionally splits any route into its
(intra-mesh, NoI) hop counts so traffic and energy can be charged per
level.  A 1x1-chiplet fabric delegates everything to its single mesh and
is bitwise-identical to the flat ``MeshNoC`` by construction.

Routes and hop counts are memoized per instance (the DSE inner loop asks
for the same few thousand routes over and over); the topology fields
(``rows``/``cols``/``order``, adjacency, chiplet assignment) must not be
mutated after construction.
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.mapping import NetworkPlan


@dataclass
class MeshNoC:
    rows: int
    cols: int
    link_traffic: Dict[Tuple[Tuple[int, int], Tuple[int, int]], int] = field(
        default_factory=dict
    )
    #: optional tile-id -> (row, col) curve covering the whole mesh; when
    #: None the default snake order applies.  Injected by placement
    #: strategies (repro/dse/placements.py) — must be a bijection onto the
    #: mesh cells and is treated as immutable.
    order: Optional[Tuple[Tuple[int, int], ...]] = None
    # per-instance memo tables (topology is immutable after construction)
    _hops_cache: Dict[Tuple[int, int], int] = field(
        default_factory=dict, repr=False, compare=False)
    _route_cache: Dict[Tuple[int, int], List[Tuple[int, int]]] = field(
        default_factory=dict, repr=False, compare=False)

    def __post_init__(self) -> None:
        if self.order is not None and len(self.order) != self.rows * self.cols:
            raise ValueError(
                f"order must cover all {self.rows * self.cols} mesh cells, "
                f"got {len(self.order)}")

    @property
    def num_tiles(self) -> int:
        return self.rows * self.cols

    def coord(self, tile_id: int) -> Tuple[int, int]:
        if self.order is not None:
            return self.order[tile_id]
        # snake order: even rows left->right, odd rows right->left, so
        # consecutive tiles are always physically adjacent (Domino chains)
        r = tile_id // self.cols
        c = tile_id % self.cols
        if r % 2 == 1:
            c = self.cols - 1 - c
        return r, c

    def hops(self, a: int, b: int) -> int:
        key = (a, b)
        h = self._hops_cache.get(key)
        if h is None:
            (r1, c1), (r2, c2) = self.coord(a), self.coord(b)
            h = abs(r1 - r2) + abs(c1 - c2)
            self._hops_cache[key] = h
        return h

    def route(self, a: int, b: int) -> List[Tuple[int, int]]:
        """XY route as a coordinate list (X first, then Y); memoized."""
        key = (a, b)
        path = self._route_cache.get(key)
        if path is not None:
            return path
        (r1, c1), (r2, c2) = self.coord(a), self.coord(b)
        path = [(r1, c1)]
        step = 1 if c2 > c1 else -1
        for c in range(c1 + step, c2 + step, step) if c2 != c1 else []:
            path.append((r1, c))
        step = 1 if r2 > r1 else -1
        for r in range(r1 + step, r2 + step, step) if r2 != r1 else []:
            path.append((r, c2))
        self._route_cache[key] = path
        return path

    def hop_levels(self, a: int, b: int) -> Tuple[int, int]:
        """(intra-mesh hops, NoI hops) — a flat mesh has no NoI level."""
        return self.hops(a, b), 0

    def add_traffic(self, a: int, b: int, nbytes: int) -> None:
        path = self.route(a, b)
        for u, v in zip(path, path[1:]):
            key = (u, v)
            self.link_traffic[key] = self.link_traffic.get(key, 0) + nbytes

    @property
    def max_link_bytes(self) -> int:
        return max(self.link_traffic.values(), default=0)

    @property
    def total_byte_hops(self) -> int:
        return sum(self.link_traffic.values())


@dataclass(frozen=True)
class Placement:
    """Blocks placed contiguously along the mesh's tile-id curve (tiles of
    one block are consecutive ids; consecutive blocks abut — Domino's
    'tiles placed closely').  The curve itself is the ``noc``'s: snake by
    default, or whatever a placement strategy injected via
    ``MeshNoC.order``."""

    noc: MeshNoC
    block_start: Tuple[int, ...]  # first tile id of each layer block
    block_end: Tuple[int, ...]    # last tile id (the block tail)
    strategy: str = "snake"       # the placement strategy that produced it

    def chain_base(self, layer: int, copy: int = 0, m_split: int = 0, *,
                   tiles_per_copy: int, chain_len: int) -> int:
        """First tile id of one (copy, m-split) chain inside a block:
        copies are laid out contiguously, each holding m_splits chains."""
        return (self.block_start[layer] + copy * tiles_per_copy
                + m_split * chain_len)


def block_spans(plan: NetworkPlan) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Per-layer (first, last) tile ids along the curve — placement-curve
    independent (ids are always consecutive per block)."""
    starts, ends = [], []
    cursor = 0
    for layer in plan.layers:
        starts.append(cursor)
        cursor += layer.total_tiles
        ends.append(cursor - 1)
    return tuple(starts), tuple(ends)


def place_network(plan: NetworkPlan, noc: Optional[MeshNoC] = None,
                  strategy: str = "snake") -> Placement:
    """Default placement: square mesh, snake curve.  Pass a pre-built
    ``noc`` (possibly with an injected ``order`` curve) to place the same
    block spans on a different fabric — the DSE strategies do."""
    if noc is None:
        side = math.ceil(math.sqrt(plan.total_tiles))
        noc = MeshNoC(rows=side, cols=side)
    elif noc.num_tiles < plan.total_tiles:
        raise ValueError(
            f"{plan.model}: {plan.total_tiles} tiles do not fit a "
            f"{noc.rows}x{noc.cols} mesh")
    starts, ends = block_spans(plan)
    return Placement(noc=noc, block_start=starts, block_end=ends,
                     strategy=strategy)


def inter_block_byte_hops_split(plan: NetworkPlan, bytes_per_output: int = 1,
                                placement: Placement | None = None
                                ) -> Tuple[int, int]:
    """Per-level (intra-mesh, NoI) byte-hops of the inter-block OFM
    streams: bytes x hops moving from each block's tail to the next
    block's head (adjacent blocks -> 1 mesh hop for any unit-step curve;
    the floor charges the mesh level, since co-located endpoints never
    touch the interposer).

    Pass an existing ``placement`` to account on a shared fabric (the
    whole-network simulator uses this so its routed OFM counters equal
    these analytic counts by construction)."""
    if placement is None:
        placement = place_network(plan)
    mesh_total = noi_total = 0
    for i in range(len(plan.layers) - 1):
        src = placement.block_end[i]
        dst = placement.block_start[i + 1]
        h_mesh, h_noi = placement.noc.hop_levels(src, dst)
        if h_mesh + h_noi == 0:
            h_mesh = 1
        out_elems = plan.layers[i].out_pixels
        nbytes = out_elems * plan.layers[i].c_out * bytes_per_output
        placement.noc.add_traffic(src, dst, nbytes)
        mesh_total += nbytes * h_mesh
        noi_total += nbytes * h_noi
    return mesh_total, noi_total


def inter_block_byte_hops(plan: NetworkPlan, bytes_per_output: int = 1,
                          placement: Placement | None = None) -> int:
    """Total (both levels) inter-block OFM byte-hops — the flat-mesh view
    of :func:`inter_block_byte_hops_split`, kept for the single-level
    callers (on a flat mesh the NoI share is identically zero)."""
    mesh_total, noi_total = inter_block_byte_hops_split(
        plan, bytes_per_output, placement)
    return mesh_total + noi_total


# ---------------------------------------------------------------------------
# Two-level fabric: per-chiplet meshes joined by a Network-on-Interposer
# ---------------------------------------------------------------------------

#: where the shipped CHIPSIM-style adjacency CSVs live
NOI_CONFIG_DIR = Path(__file__).resolve().parent.parent / "configs" / "noi"

#: empty interposer columns between adjacent chiplet grids in the
#: fabric's global coordinate frame (keeps chiplet cells disjoint, so a
#: link between cells of different chiplets is unambiguously NoI)
CHIPLET_GAP = 1


def mesh_adjacency(n: int) -> List[List[int]]:
    """Adjacency matrix of a near-square 2-D mesh over ``n`` chiplets
    (the CHIPSIM ``adj_matrix_*_mesh`` generator, any count)."""
    if n < 1:
        raise ValueError(f"need at least 1 chiplet, got {n}")
    rows = max(r for r in range(1, int(math.isqrt(n)) + 1) if n % r == 0)
    cols = n // rows
    adj = [[0] * n for _ in range(n)]
    for i in range(n):
        r, c = divmod(i, cols)
        if c + 1 < cols:
            adj[i][i + 1] = adj[i + 1][i] = 1
        if r + 1 < rows:
            adj[i][i + cols] = adj[i + cols][i] = 1
    return adj


def floret_adjacency(n: int) -> List[List[int]]:
    """Adjacency matrix of a floret NoI: a ring of chiplets with
    skip-2 petal chords (the CHIPSIM ``adj_matrix_*_floret`` shape),
    shortening inter-chiplet diameters vs the plain mesh."""
    if n < 1:
        raise ValueError(f"need at least 1 chiplet, got {n}")
    adj = [[0] * n for _ in range(n)]
    for i in range(n):
        for j in ((i + 1) % n, (i + 2) % n):
            if i != j:
                adj[i][j] = adj[j][i] = 1
    return adj


@dataclass
class NoITopology:
    """Network-on-Interposer: an undirected chiplet adjacency matrix
    (CHIPSIM's ``assets/NoI_topologies/*.csv`` convention — headerless
    0/1 CSV, ``matrix[i][j] = 1`` is a direct chiplet i <-> j link) with
    memoized BFS shortest-path routing, mirroring ``MeshNoC.route``."""

    name: str
    adj: Tuple[Tuple[int, ...], ...]
    _hops_cache: Dict[Tuple[int, int], int] = field(
        default_factory=dict, repr=False, compare=False)
    _route_cache: Dict[Tuple[int, int], List[int]] = field(
        default_factory=dict, repr=False, compare=False)

    def __post_init__(self) -> None:
        n = len(self.adj)
        if n < 1:
            raise ValueError(f"NoI '{self.name}': empty adjacency matrix")
        for i, row in enumerate(self.adj):
            if len(row) != n:
                raise ValueError(
                    f"NoI '{self.name}': adjacency matrix is not square "
                    f"(row {i} has {len(row)} entries, expected {n})")
            for j, v in enumerate(row):
                if v not in (0, 1):
                    raise ValueError(
                        f"NoI '{self.name}': entry [{i}][{j}] = {v!r} "
                        "(adjacency entries must be 0 or 1)")
            if row[i] != 0:
                raise ValueError(
                    f"NoI '{self.name}': chiplet {i} links to itself "
                    "(the diagonal must be 0)")
        for i in range(n):
            for j in range(i + 1, n):
                if self.adj[i][j] != self.adj[j][i]:
                    raise ValueError(
                        f"NoI '{self.name}': asymmetric adjacency "
                        f"[{i}][{j}]={self.adj[i][j]} but "
                        f"[{j}][{i}]={self.adj[j][i]} (interposer links "
                        "are bidirectional)")
        unreachable = [i for i, h in enumerate(self._bfs(0)) if h < 0]
        if unreachable:
            raise ValueError(
                f"NoI '{self.name}': disconnected topology — chiplets "
                f"{unreachable} are unreachable from chiplet 0")

    @property
    def n(self) -> int:
        return len(self.adj)

    @property
    def links(self) -> List[Tuple[int, int]]:
        """Undirected interposer links as sorted (i, j) pairs."""
        return [(i, j) for i in range(self.n) for j in range(i + 1, self.n)
                if self.adj[i][j]]

    def _bfs(self, src: int) -> List[int]:
        dist = [-1] * self.n
        dist[src] = 0
        q = deque([src])
        while q:
            u = q.popleft()
            for v, linked in enumerate(self.adj[u]):
                if linked and dist[v] < 0:
                    dist[v] = dist[u] + 1
                    q.append(v)
        return dist

    def hops(self, a: int, b: int) -> int:
        key = (a, b)
        h = self._hops_cache.get(key)
        if h is None:
            h = len(self.route(a, b)) - 1
            self._hops_cache[key] = h
        return h

    def route(self, a: int, b: int) -> List[int]:
        """Shortest chiplet-id path from ``a`` to ``b`` (BFS, lowest-id
        tie-break for determinism); memoized like ``MeshNoC.route``."""
        key = (a, b)
        path = self._route_cache.get(key)
        if path is not None:
            return path
        parent: Dict[int, int] = {a: a}
        q = deque([a])
        while q and b not in parent:
            u = q.popleft()
            for v, linked in enumerate(self.adj[u]):
                if linked and v not in parent:
                    parent[v] = u
                    q.append(v)
        path = [b]
        while path[-1] != a:
            path.append(parent[path[-1]])
        path.reverse()
        self._route_cache[key] = path
        return path

    def to_csv(self) -> str:
        """The CHIPSIM headerless adjacency-CSV form (round-trips
        through :meth:`from_csv_text`)."""
        return "\n".join(",".join(str(v) for v in row)
                         for row in self.adj) + "\n"

    @classmethod
    def from_csv_text(cls, text: str, name: str = "csv") -> "NoITopology":
        rows: List[Tuple[int, ...]] = []
        for ln, line in enumerate(text.splitlines()):
            line = line.strip()
            if not line:
                continue
            try:
                rows.append(tuple(int(v) for v in line.split(",")))
            except ValueError:
                raise ValueError(
                    f"NoI '{name}': line {ln + 1} is not a comma-separated "
                    f"integer row: {line!r}")
        return cls(name=name, adj=tuple(rows))

    @classmethod
    def from_csv(cls, path: "str | Path") -> "NoITopology":
        path = Path(path)
        return cls.from_csv_text(path.read_text(), name=path.stem)


def load_noi(name: str, n: int) -> NoITopology:
    """Resolve an NoI topology for ``n`` chiplets: the shipped
    ``configs/noi/{name}_{n}.csv`` when present (the CSV path CI
    exercises), else the matching generator (any chiplet count)."""
    path = NOI_CONFIG_DIR / f"{name}_{n}.csv"
    if path.exists():
        topo = NoITopology.from_csv(path)
        if topo.n != n:
            raise ValueError(
                f"{path.name}: adjacency is {topo.n}x{topo.n}, "
                f"expected {n} chiplets")
        return topo
    generators = {"mesh": mesh_adjacency, "floret": floret_adjacency}
    if name not in generators:
        shipped = sorted(p.stem for p in NOI_CONFIG_DIR.glob("*.csv"))
        raise ValueError(
            f"unknown NoI topology {name!r} for {n} chiplets: no "
            f"configs/noi/{name}_{n}.csv (shipped: {shipped}) and no "
            f"generator (have: {sorted(generators)})")
    return NoITopology(name=f"{name}_{n}",
                       adj=tuple(tuple(r) for r in generators[name](n)))


@dataclass
class ChipletFabric:
    """Two-level NoC: per-chiplet ``MeshNoC`` grids joined by an
    :class:`NoITopology`, presenting the flat ``MeshNoC`` interface.

    Global tile ids concatenate the chiplets' *assigned* tile ranges
    (``counts[k]`` tiles on chiplet ``k``), so ``block_spans`` ids work
    unchanged; global coordinates place chiplet ``k``'s grid at a column
    offset (``CHIPLET_GAP`` empty interposer columns apart), so per-link
    accounting and heatmaps keep the flat ``((r, c), (r, c))`` link type.

    Cross-chiplet routes go local mesh -> chiplet gateway (local cell
    (0, 0)) -> NoI gateway hops -> remote gateway -> remote mesh;
    :meth:`hop_levels` reports the (intra-mesh, NoI) split and
    :meth:`is_noi_link` classifies any route link, which is what lets
    the transport, energy model and telemetry charge the two levels
    separately while staying equal-by-construction.
    """

    chiplets: Tuple[MeshNoC, ...]
    noi: NoITopology
    counts: Tuple[int, ...]  # tiles assigned to each chiplet
    link_traffic: Dict[Tuple[Tuple[int, int], Tuple[int, int]], int] = field(
        default_factory=dict)
    _levels_cache: Dict[Tuple[int, int], Tuple[int, int]] = field(
        default_factory=dict, repr=False, compare=False)
    _route_cache: Dict[Tuple[int, int], List[Tuple[int, int]]] = field(
        default_factory=dict, repr=False, compare=False)

    def __post_init__(self) -> None:
        if not self.chiplets:
            raise ValueError("a fabric needs at least one chiplet")
        if not (len(self.chiplets) == len(self.counts) == self.noi.n):
            raise ValueError(
                f"fabric mismatch: {len(self.chiplets)} chiplets, "
                f"{len(self.counts)} tile counts, {self.noi.n}-chiplet "
                f"NoI '{self.noi.name}'")
        for k, (ch, cnt) in enumerate(zip(self.chiplets, self.counts)):
            if cnt < 1:
                raise ValueError(f"chiplet {k}: assigned {cnt} tiles")
            if cnt > ch.num_tiles:
                raise ValueError(
                    f"chiplet {k}: {cnt} tiles do not fit its "
                    f"{ch.rows}x{ch.cols} mesh")
        starts = [0]
        for cnt in self.counts:
            starts.append(starts[-1] + cnt)
        self._starts: Tuple[int, ...] = tuple(starts)
        offs = [0]
        for ch in self.chiplets[:-1]:
            offs.append(offs[-1] + ch.cols + CHIPLET_GAP)
        self._col_off: Tuple[int, ...] = tuple(offs)
        # per-chiplet NoI gateway: local cell (0, 0) in global coords —
        # deterministic and independent of any injected order curve
        self._gateways: Tuple[Tuple[int, int], ...] = tuple(
            (0, off) for off in self._col_off)
        self._gw_chiplet: Dict[Tuple[int, int], int] = {
            gw: k for k, gw in enumerate(self._gateways)}

    # -- flat MeshNoC interface ---------------------------------------------

    @property
    def num_tiles(self) -> int:
        return self._starts[-1]

    @property
    def rows(self) -> int:
        return max(ch.rows for ch in self.chiplets)

    @property
    def cols(self) -> int:
        return self._col_off[-1] + self.chiplets[-1].cols

    @property
    def order(self) -> Optional[Tuple[Tuple[int, int], ...]]:
        """None when every chiplet runs the default snake curve (the
        analytic chain fast path applies: consecutive ids of a block
        stay adjacent inside one chiplet); a global coordinate tuple of
        the assigned tiles otherwise."""
        if all(ch.order is None for ch in self.chiplets):
            return None
        return tuple(self.coord(t) for t in range(self.num_tiles))

    def tile_chiplet(self, tile_id: int) -> Tuple[int, int]:
        """Global tile id -> (chiplet index, local tile id)."""
        if not 0 <= tile_id < self.num_tiles:
            raise ValueError(
                f"tile {tile_id} outside the fabric's {self.num_tiles} "
                "assigned tiles")
        k = 0
        while self._starts[k + 1] <= tile_id:
            k += 1
        return k, tile_id - self._starts[k]

    def coord(self, tile_id: int) -> Tuple[int, int]:
        k, local = self.tile_chiplet(tile_id)
        r, c = self.chiplets[k].coord(local)
        return r, c + self._col_off[k]

    def gateway(self, chiplet: int) -> Tuple[int, int]:
        """Global coordinate of a chiplet's NoI gateway cell."""
        return self._gateways[chiplet]

    def is_noi_link(self, u: Tuple[int, int], v: Tuple[int, int]) -> bool:
        """True when a route link is an interposer hop (both endpoints
        are gateways of *different* chiplets — chiplet grids are
        coordinate-disjoint, so mesh links never qualify)."""
        ku = self._gw_chiplet.get(u)
        kv = self._gw_chiplet.get(v)
        return ku is not None and kv is not None and ku != kv

    def hop_levels(self, a: int, b: int) -> Tuple[int, int]:
        """(intra-mesh hops, NoI hops) of the a -> b route."""
        key = (a, b)
        hl = self._levels_cache.get(key)
        if hl is None:
            ka, la = self.tile_chiplet(a)
            kb, lb = self.tile_chiplet(b)
            if ka == kb:
                hl = (self.chiplets[ka].hops(la, lb), 0)
            else:
                (r1, c1) = self.coord(a)
                (r2, c2) = self.coord(b)
                (g1r, g1c) = self._gateways[ka]
                (g2r, g2c) = self._gateways[kb]
                mesh = (abs(r1 - g1r) + abs(c1 - g1c)
                        + abs(g2r - r2) + abs(g2c - c2))
                hl = (mesh, self.noi.hops(ka, kb))
            self._levels_cache[key] = hl
        return hl

    def hops(self, a: int, b: int) -> int:
        h_mesh, h_noi = self.hop_levels(a, b)
        return h_mesh + h_noi

    @staticmethod
    def _xy_path(src: Tuple[int, int], dst: Tuple[int, int]
                 ) -> List[Tuple[int, int]]:
        """Coordinate-level XY path (X first, then Y — the MeshNoC
        discipline), including both endpoints."""
        (r1, c1), (r2, c2) = src, dst
        path = [(r1, c1)]
        step = 1 if c2 > c1 else -1
        for c in range(c1 + step, c2 + step, step) if c2 != c1 else []:
            path.append((r1, c))
        step = 1 if r2 > r1 else -1
        for r in range(r1 + step, r2 + step, step) if r2 != r1 else []:
            path.append((r, c2))
        return path

    def route(self, a: int, b: int) -> List[Tuple[int, int]]:
        """Global coordinate route: local XY to the gateway, gateway
        hops across the interposer, local XY to the target —
        ``len(route) - 1 == hops(a, b)``, so per-link accounting stays
        equal-by-construction with the hop counters on both levels."""
        key = (a, b)
        path = self._route_cache.get(key)
        if path is not None:
            return path
        ka, la = self.tile_chiplet(a)
        kb, lb = self.tile_chiplet(b)
        if ka == kb:
            off = self._col_off[ka]
            path = [(r, c + off) for r, c in self.chiplets[ka].route(la, lb)]
        else:
            path = self._xy_path(self.coord(a), self._gateways[ka])
            for k in self.noi.route(ka, kb)[1:]:
                path.append(self._gateways[k])
            path.extend(self._xy_path(self._gateways[kb], self.coord(b))[1:])
        self._route_cache[key] = path
        return path

    def add_traffic(self, a: int, b: int, nbytes: int) -> None:
        path = self.route(a, b)
        for u, v in zip(path, path[1:]):
            key = (u, v)
            self.link_traffic[key] = self.link_traffic.get(key, 0) + nbytes

    @property
    def max_link_bytes(self) -> int:
        return max(self.link_traffic.values(), default=0)

    @property
    def total_byte_hops(self) -> int:
        return sum(self.link_traffic.values())

    # -- fabric-specific geometry (telemetry rendering) ---------------------

    def fabric_geometry(self) -> Dict[str, object]:
        """Rendering geometry: per-chiplet bounding boxes in global
        coordinates, the gateway cells, and the NoI link list."""
        boxes = [(0, off, ch.rows, ch.cols)
                 for ch, off in zip(self.chiplets, self._col_off)]
        return {
            "noi_name": self.noi.name,
            "boxes": boxes,
            "gateways": list(self._gateways),
            "noi_links": [(self._gateways[i], self._gateways[j])
                          for i, j in self.noi.links],
        }


def _chiplet_mesh_shape(total: int, aspect: float = 1.0) -> Tuple[int, int]:
    """rows x cols mesh fitting ``total`` tiles at ~``aspect`` =
    rows/cols.  At the default square aspect this is exactly
    ``place_network``'s ceil-sqrt square, so the 1x1-chiplet fabric
    reproduces the flat mesh's geometry bit for bit."""
    if aspect == 1.0:
        side = math.ceil(math.sqrt(total))
        return side, side
    rows = max(1, round(math.sqrt(total * aspect)))
    cols = math.ceil(total / rows)
    return rows, cols


def partition_layers(plan: NetworkPlan, chiplets: int,
                     cut: str = "balance") -> List[Tuple[int, int]]:
    """Split the layer sequence into ``chiplets`` contiguous segments at
    stage boundaries; returns per-segment (first, last) layer indices.

    ``cut="balance"`` minimizes the largest segment's tile count
    (contiguous-partition DP); ``cut="even"`` splits the layer list into
    equal-length runs.  Cuts never land before a ``*_sc`` projection
    layer — a projection executes inside its residual target's stage, so
    the pair stays on one chiplet.
    """
    n = len(plan.layers)
    if chiplets < 1:
        raise ValueError(f"need at least 1 chiplet, got {chiplets}")
    # boundary b = "cut between layer b-1 and layer b" is legal unless it
    # would orphan a projection from its residual target's stage
    legal = [b for b in range(1, n)
             if not plan.layers[b].name.endswith("_sc")]
    if chiplets - 1 > len(legal):
        raise ValueError(
            f"{plan.model}: cannot cut {n} layers into {chiplets} "
            f"chiplet segments ({len(legal)} legal stage boundaries)")
    if chiplets == 1:
        return [(0, n - 1)]
    if cut == "even":
        picks = sorted({min(legal, key=lambda b: (abs(b - round(
            s * n / chiplets)), b)) for s in range(1, chiplets)})
        while len(picks) < chiplets - 1:  # collisions: take free boundaries
            picks = sorted(picks + [next(b for b in legal
                                         if b not in picks)])
    elif cut == "balance":
        weights = [lp.total_tiles for lp in plan.layers]
        prefix = [0]
        for w in weights:
            prefix.append(prefix[-1] + w)

        def seg(a: int, b: int) -> int:  # tiles of layers [a, b)
            return prefix[b] - prefix[a]

        # DP over legal boundaries: best[j][k] = minimal max-segment tile
        # count splitting layers [0, bounds[j]) into k segments
        bounds = legal + [n]
        best: Dict[Tuple[int, int], Tuple[int, Tuple[int, ...]]] = {}
        for j, b in enumerate(bounds):
            best[j, 1] = (seg(0, b), ())
            for k in range(2, chiplets + 1):
                cand = None
                for i, c in enumerate(bounds[:j]):
                    if (i, k - 1) not in best:
                        continue
                    prev_cost, prev_cuts = best[i, k - 1]
                    cost = max(prev_cost, seg(c, b))
                    if cand is None or cost < cand[0]:
                        cand = (cost, prev_cuts + (c,))
                if cand is not None:
                    best[j, k] = cand
        picks = list(best[len(bounds) - 1, chiplets][1])
    else:
        raise ValueError(f"unknown cut strategy {cut!r} "
                         "(have: 'balance', 'even')")
    edges = [0] + picks + [n]
    return [(edges[i], edges[i + 1] - 1) for i in range(chiplets)]


def shard_network(plan: NetworkPlan, chiplets: int, noi: str = "mesh",
                  aspect: float = 1.0, cut: str = "balance",
                  strategy: str = "snake") -> Placement:
    """Place a plan on a ``chiplets``-way :class:`ChipletFabric`.

    The layer sequence is partitioned into contiguous per-chiplet
    segments at stage boundaries (see :func:`partition_layers`), each
    segment gets its own snake-curve mesh sized by ``aspect``, and the
    chiplets are joined by the named NoI topology.  Blocks never span
    chiplets, so chain/group/split traffic stays intra-chiplet; only the
    inter-stage OFM and residual streams cross the interposer.  With
    ``chiplets=1`` the degenerate fabric wraps the same square mesh
    ``place_network`` builds and is bitwise-identical to the flat path.
    """
    segments = partition_layers(plan, chiplets, cut=cut)
    counts = []
    meshes = []
    for lo, hi in segments:
        tiles = sum(lp.total_tiles for lp in plan.layers[lo:hi + 1])
        r, c = _chiplet_mesh_shape(tiles, aspect)
        counts.append(tiles)
        meshes.append(MeshNoC(rows=r, cols=c))
    fabric = ChipletFabric(chiplets=tuple(meshes), noi=load_noi(noi, chiplets),
                           counts=tuple(counts))
    starts, ends = block_spans(plan)
    return Placement(noc=fabric, block_start=starts, block_end=ends,
                     strategy=strategy)
