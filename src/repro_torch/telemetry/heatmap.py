"""Per-link NoC traffic accounting: recorder hook, heatmaps, conservation.

`TrafficCounters` keeps per-*class* byte-hop totals; this module
resolves them one level down to per-*link* loads.  A
:class:`LinkRecorder` attaches to the simulator (``sim.recorder = rec``)
and is invoked by every :class:`repro_torch.core.transport.NoCTransport`
accounting call with the *global* tile ids, packet class, payload and
hop count.  It walks the same memoized :meth:`MeshNoC.route` XY path
the energy model charges, crediting ``nbytes * count`` to every
directed link on the path — so per-class link sums equal the
``TrafficCounters`` byte-hop totals *by construction* (path length ==
the ``hops`` the counters were charged), extending the transport's
equal-by-construction guarantee from class totals to individual links.

:func:`check_conservation` closes the triangle against the analytic
side: ``repro_torch.core.energy.routed_byte_hops_per_class`` predicts the
functional simulator's routed traffic per class as exact integers, and
all three views (heatmap link sums, counters, analytic) must agree to
the byte.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

from repro_torch.core.noc import MeshNoC
from repro_torch.core.transport import CHAIN, GROUP, NOI, OFM, RESIDUAL, SPLIT

#: routed packet classes, in rendering order ("noi" is the interposer
#: *level* of cross-chiplet flows on a ChipletFabric, not a dataflow)
TRAFFIC_CLASSES: Tuple[str, ...] = (CHAIN, GROUP, SPLIT, OFM, RESIDUAL, NOI)

Link = Tuple[Tuple[int, int], Tuple[int, int]]  # ((r, c) -> (r, c))


@dataclass
class FlowStats:
    """Aggregate for one ``(src_tile, dst_tile, class)`` flow."""
    packets: int = 0
    bytes: int = 0
    byte_hops: int = 0


class LinkRecorder:
    """Attributes routed traffic to individual mesh links.

    The transport hot path pays a single ``is not None`` test when no
    recorder is attached; when attached, each accounting call walks the
    memoized XY route once per *flow record* (not per cycle — the
    transports already batch per-fire traffic), so recording overhead
    is proportional to the number of distinct sends, not cycles.
    """

    def __init__(self, noc: MeshNoC):
        self.noc = noc
        # ChipletFabric routes cross interposer links; those are credited
        # under the "noi" class so per-class link sums stay per-level
        # exact (a flat MeshNoC has no is_noi_link: every link is mesh)
        self._is_noi = getattr(noc, "is_noi_link", None)
        self.flows: Dict[Tuple[int, int, str], FlowStats] = {}
        self.link_bytes: Dict[str, Dict[Link, int]] = {}

    def record(self, src: int, dst: int, kind: str, nbytes: int,
               count: int, hops: int) -> None:
        """One accounting record: ``count`` packets of ``nbytes`` from
        global tile ``src`` to ``dst`` over ``hops`` total hops (both
        levels on a fabric)."""
        total = nbytes * count
        fs = self.flows.get((src, dst, kind))
        if fs is None:
            fs = self.flows[(src, dst, kind)] = FlowStats()
        fs.packets += count
        fs.bytes += total
        fs.byte_hops += total * hops
        path = self.noc.route(src, dst)
        for u, v in zip(path, path[1:]):
            k = NOI if (self._is_noi is not None
                        and self._is_noi(u, v)) else kind
            per_class = self.link_bytes.get(k)
            if per_class is None:
                per_class = self.link_bytes[k] = {}
            per_class[(u, v)] = per_class.get((u, v), 0) + total

    def clear(self) -> None:
        self.flows.clear()
        self.link_bytes.clear()

    def heatmap(self) -> "LinkHeatmap":
        geom = getattr(self.noc, "fabric_geometry", None)
        return LinkHeatmap(
            rows=self.noc.rows, cols=self.noc.cols,
            per_class={k: dict(v) for k, v in self.link_bytes.items()},
            geometry=geom() if geom is not None else None)


@dataclass
class LinkHeatmap:
    """Per-link byte loads on a rows x cols grid, split by class.

    ``geometry`` (``ChipletFabric.fabric_geometry()``) marks the
    per-chiplet bounding boxes, gateway cells and NoI links of a
    two-level fabric; ``None`` renders the flat single-mesh view."""
    rows: int
    cols: int
    per_class: Dict[str, Dict[Link, int]] = field(default_factory=dict)
    geometry: Optional[Dict[str, object]] = None

    def class_totals(self) -> Dict[str, int]:
        """Sum of link loads per class == per-class byte-hops."""
        return {k: sum(v.values()) for k, v in self.per_class.items()}

    def combined(self) -> Dict[Link, int]:
        out: Dict[Link, int] = {}
        for loads in self.per_class.values():
            for link, b in loads.items():
                out[link] = out.get(link, 0) + b
        return out

    def top_links(self, n: int = 10) -> List[Tuple[Link, int, Dict[str, int]]]:
        """The ``n`` hottest links: (link, total bytes, per-class split)."""
        comb = self.combined()
        ranked = sorted(comb.items(), key=lambda kv: (-kv[1], kv[0]))[:n]
        out = []
        for link, total in ranked:
            split = {k: v[link] for k, v in sorted(self.per_class.items())
                     if link in v}
            out.append((link, total, split))
        return out

    def to_csv(self) -> str:
        """``src_r,src_c,dst_r,dst_c,class,bytes`` rows, sorted."""
        lines = ["src_r,src_c,dst_r,dst_c,class,bytes"]
        for kind in sorted(self.per_class):
            for (u, v), b in sorted(self.per_class[kind].items()):
                lines.append(f"{u[0]},{u[1]},{v[0]},{v[1]},{kind},{b}")
        return "\n".join(lines) + "\n"

    def render(self) -> str:
        """Text heatmap: cells are ``+``; the glyph between / below
        cells scales 0-9 with the bidirectional link load.  On a
        multi-chiplet fabric the per-chiplet grids render side by side
        (gateway cells marked ``G``) with the NoI links listed below —
        they span the interposer, not a drawable grid edge."""
        comb = self.combined()
        if not comb:
            return "(no recorded traffic)\n"

        geom = self.geometry
        boxes = list(geom["boxes"]) if geom is not None else []
        if len(boxes) <= 1:
            return self._render_grid(
                comb, f"mesh {self.rows}x{self.cols}",
                cells={(r, c) for r in range(self.rows)
                       for c in range(self.cols)})

        cells = {(r0 + r, c0 + c)
                 for r0, c0, nr, nc in boxes
                 for r in range(nr) for c in range(nc)}
        gateways = set(geom["gateways"])
        noi_links = list(geom["noi_links"])
        shapes = " + ".join(f"{nr}x{nc}" for _r0, _c0, nr, nc in boxes)
        body = self._render_grid(
            comb, f"fabric {len(boxes)} chiplets ({shapes}), "
            f"noi {geom['noi_name']}", cells=cells, gateways=gateways)
        lines = [body.rstrip("\n"), "NoI links (G <-> G, bidirectional):"]
        for u, v in noi_links:
            b = comb.get((u, v), 0) + comb.get((v, u), 0)
            lines.append(f"  {u} <-> {v}: {b} B")
        return "\n".join(lines) + "\n"

    def _render_grid(self, comb: Dict[Link, int], title: str,
                     cells: set, gateways: Optional[set] = None) -> str:
        def load(a: Tuple[int, int], b: Tuple[int, int]) -> int:
            return comb.get((a, b), 0) + comb.get((b, a), 0)

        peak = max(load(u, v) for (u, v) in comb) or 1

        def glyph(x: int) -> str:
            if x == 0:
                return "."
            return str(min(9, 1 + (9 * x) // (peak + 1)))

        gws = gateways or set()
        lines = [f"{title}; glyphs scale 0-9 with link load "
                 f"(peak {peak} B, bidirectional)"]
        for r in range(self.rows):
            row = []
            for c in range(self.cols):
                if (r, c) not in cells:
                    row.append("  " if c + 1 < self.cols else " ")
                    continue
                row.append("G" if (r, c) in gws else "+")
                if c + 1 < self.cols:
                    row.append(glyph(load((r, c), (r, c + 1)))
                               if (r, c + 1) in cells else " ")
            lines.append("".join(row).rstrip())
            if r + 1 < self.rows:
                lines.append("".join(
                    (glyph(load((r, c), (r + 1, c)))
                     if (r, c) in cells and (r + 1, c) in cells else " ") + " "
                    for c in range(self.cols)).rstrip())
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Conservation: heatmap == counters == analytic, to the byte
# ---------------------------------------------------------------------------


def check_conservation(heatmap: LinkHeatmap, counters,
                       analytic: Optional[Mapping[str, int]] = None,
                       flows: Optional[Iterable[FlowStats]] = None,
                       ) -> List[str]:
    """Exact-integer conservation check; returns mismatches (empty = ok).

    Compares, per traffic class: the heatmap's per-link byte sums, the
    simulator's :class:`TrafficCounters` byte-hop totals, and (when
    given) the analytic per-class routed byte-hops from
    ``repro_torch.core.energy.routed_byte_hops_per_class``.

    On a :class:`~repro_torch.core.noc.ChipletFabric` this is a per-*level*
    assertion, not just the flat total: all three views account a
    cross-chiplet flow's intra-mesh hops under its own class and its
    interposer hops under the ``"noi"`` class (the recorder credits NoI
    links there, the transport splits via ``hop_levels``, the analytic
    walk mirrors it), so the sim == energy == heatmap equality is
    checked for the intra-mesh classes AND the NoI level separately —
    each as exact integers.
    """
    problems: List[str] = []
    hm = heatmap.class_totals()
    sim = {k: int(v) for k, v in counters.byte_hops.items() if v}
    for kind in sorted(set(hm) | set(sim)):
        if hm.get(kind, 0) != sim.get(kind, 0):
            problems.append(
                f"{kind}: heatmap link sum {hm.get(kind, 0)} != "
                f"counters byte-hops {sim.get(kind, 0)}")
    if analytic is not None:
        an = {k: int(v) for k, v in analytic.items() if v}
        for kind in sorted(set(an) | set(sim)):
            if an.get(kind, 0) != sim.get(kind, 0):
                problems.append(
                    f"{kind}: analytic byte-hops {an.get(kind, 0)} != "
                    f"counters byte-hops {sim.get(kind, 0)}")
    if flows is not None:
        per_flow = sum(f.byte_hops for f in flows)
        total = sum(sim.values())
        if per_flow != total:
            problems.append(
                f"flow byte-hop sum {per_flow} != counters total {total}")
    return problems


def record_run(sim, images):
    """Run ``sim`` on ``images`` with a fresh recorder attached.

    Returns ``(result, recorder)``; the recorder is detached afterwards
    so subsequent runs are back on the zero-overhead path.
    """
    rec = LinkRecorder(sim.placement.noc)
    prev = sim.recorder
    sim.recorder = rec
    try:
        res = sim.run(images)
    finally:
        sim.recorder = prev
    return res, rec
