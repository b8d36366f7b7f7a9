"""The mapping design space: what the DSE enumerates and mutates.

A :class:`MappingConfig` is one point: a placement strategy, a mesh
aspect ratio, the block-reuse depth and weight-duplication cap (the
paper's Fig. 7 knobs), plus optional per-layer duplication overrides —
and, for the robustness DSE, bit-scalable precision: a network-wide
``base_bits = (w_bits, a_bits, adc_bits)`` with optional per-layer
``precision`` overrides (the Princeton bit-scalable-CIM lever, threaded
to ``CIMEngine.set_layer_spec`` via :func:`layer_specs_for`).  Chiplet
scale-out adds a chiplet-count x NoI-topology x inter-chiplet-cut axis:
``chiplets > 1`` builds through :func:`repro_torch.core.noc.shard_network`
onto a two-level :class:`~repro_torch.core.noc.ChipletFabric` (snake curves
per chiplet; the aspect knob sizes each chiplet's mesh).
:class:`DesignSpace` enumerates the grid of points and *builds* them —
``plan_network`` is the feasibility oracle (a config whose plan fails to
build, whose tiles don't fit the mesh, or whose placement violates the
rendezvous slack is simply infeasible and skipped).  Precision never
changes geometry, so it multiplies the grid without re-planning cost.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, replace
from typing import Dict, Iterator, Optional, Tuple

from repro_torch.configs.cnn import CNNConfig, ConvLayer
from repro_torch.core.mapping import MAX_DUPLICATION, NetworkPlan, plan_network
from repro_torch.core.noc import Placement, shard_network
from repro_torch.dse.placements import (
    PlacementStrategy,
    strategies,
    validate_placement,
)

#: (w_bits, a_bits, adc_bits)
BitsTriple = Tuple[int, int, int]


@dataclass(frozen=True)
class MappingConfig:
    """One point of the design space (hashable, mutation-friendly)."""

    strategy: str = "snake"
    aspect: float = 1.0          # target mesh rows/cols ratio
    reuse: int = 1               # block-reuse depth (Fig. 7)
    dup_cap: int = MAX_DUPLICATION
    band: int = 2                # boustrophedon band height
    #: per-layer duplication caps, sorted name order (hashability)
    dup_overrides: Tuple[Tuple[str, int], ...] = ()
    #: network-wide (w_bits, a_bits, adc_bits)
    base_bits: BitsTriple = (8, 8, 8)
    #: per-layer (w, a, adc) overrides, sorted name order
    precision: Tuple[Tuple[str, BitsTriple], ...] = ()
    #: chiplet scale-out: >1 shards the plan over a ChipletFabric
    chiplets: int = 1
    noi: str = "mesh"            # NoI topology name (chiplets > 1 only)
    cut: str = "balance"         # stage-boundary partition ("balance"/"even")

    def describe(self) -> str:
        bits = [self.strategy, f"aspect={self.aspect:g}",
                f"reuse={self.reuse}", f"dup_cap={self.dup_cap}"]
        if self.strategy == "boustrophedon":
            bits.append(f"band={self.band}")
        if self.chiplets > 1:
            bits.append(f"chiplets={self.chiplets} noi={self.noi} "
                        f"cut={self.cut}")
        if self.dup_overrides:
            bits.append("dups={" + ",".join(
                f"{n}:{v}" for n, v in self.dup_overrides) + "}")
        if self.base_bits != (8, 8, 8):
            w, a, adc = self.base_bits
            bits.append(f"w{w}a{a}adc{adc}")
        if self.precision:
            bits.append("bits={" + ",".join(
                f"{n}:w{w}a{a}adc{c}" for n, (w, a, c) in self.precision)
                + "}")
        return " ".join(bits)

    @property
    def precision_key(self) -> Tuple:
        """The part of the config that determines *accuracy* (placement
        and duplication never change math) — the accuracy cache key."""
        return (self.base_bits, self.precision)


def layer_specs_for(cfg: MappingConfig, base_spec,
                    layer_names: Tuple[str, ...]) -> Dict[str, object]:
    """``{layer name: CIMSpec}`` realizing the config's precision point
    over ``base_spec`` (geometry/gain kept, bits swapped) — consumable
    by ``CIMEngine.set_layer_spec`` and ``analyze_plan(layer_specs=)``."""
    wb, ab, adcb = cfg.base_bits
    base = replace(base_spec, w_bits=wb, a_bits=ab, adc_bits=adcb)
    out = {name: base for name in layer_names}
    for name, (w, a, adc) in cfg.precision:
        out[name] = replace(base_spec, w_bits=w, a_bits=a, adc_bits=adc)
    return out


def mesh_shape_for(total: int, aspect: float) -> Tuple[int, int]:
    """Smallest rows x cols mesh fitting ``total`` tiles at ~``aspect``
    = rows/cols."""
    rows = max(1, round(math.sqrt(total * aspect)))
    cols = math.ceil(total / rows)
    return rows, cols


@dataclass
class Built:
    """A feasible, built configuration (what the scorer consumes)."""

    config: MappingConfig
    plan: NetworkPlan
    placement: Placement


class DesignSpace:
    """Enumerable grid of :class:`MappingConfig` for one model.

    ``build`` returns None for infeasible points; ``plan_network`` is
    the oracle (it raises on bad duplication/overrides), the mesh-fit
    and rendezvous-slack checks complete it.
    """

    def __init__(self, cnn: CNNConfig,
                 strategy_names: Tuple[str, ...] = (
                     "snake", "boustrophedon", "hilbert", "greedy"),
                 aspects: Tuple[float, ...] = (1.0, 2.0, 0.5),
                 reuses: Tuple[int, ...] = (1, 2, 4),
                 dup_caps: Tuple[int, ...] = (MAX_DUPLICATION,),
                 bands: Tuple[int, ...] = (2, 3),
                 n_c: int = 256, n_m: int = 256,
                 base_bits_choices: Tuple[BitsTriple, ...] = ((8, 8, 8),),
                 layer_bits_choices: Tuple[BitsTriple, ...] = (),
                 chiplet_counts: Tuple[int, ...] = (1,),
                 noi_names: Tuple[str, ...] = ("mesh",),
                 cuts: Tuple[str, ...] = ("balance",)):
        self.cnn = cnn
        self.strategy_names = strategy_names
        self.aspects = aspects
        self.reuses = reuses
        self.dup_caps = dup_caps
        self.bands = bands
        self.n_c, self.n_m = n_c, n_m
        #: chiplet scale-out axis; counts > 1 shard through
        #: ``shard_network`` (snake curves per chiplet), so they pair
        #: only with the snake strategy — other curves stay single-mesh
        self.chiplet_counts = chiplet_counts
        self.noi_names = noi_names
        self.cuts = cuts
        #: network-wide precision grid (enumerated); (8,8,8) is nominal
        self.base_bits_choices = base_bits_choices
        #: per-layer precision override values (mutation-only, like
        #: dup_overrides — enumerating them would be exponential)
        self.layer_bits_choices = layer_bits_choices
        self.conv_names: Tuple[str, ...] = tuple(
            l.name for l in cnn.layers if isinstance(l, ConvLayer))
        self.layer_names: Tuple[str, ...] = tuple(
            l.name for l in cnn.layers)
        self._strategies: Dict[int, Dict[str, PlacementStrategy]] = {}

    # -- enumeration --------------------------------------------------------

    def _fabric_variants(self, strat: str) -> Iterator[Dict[str, object]]:
        """The chiplet-axis kwargs each mapping point fans out to: the
        single-mesh point for ``chiplets == 1``, and (snake only — each
        chiplet carries its own snake curve) every NoI topology x cut
        for each multi-chiplet count."""
        for ch in self.chiplet_counts:
            if ch == 1:
                yield {}
            elif strat == "snake":
                for noi, cut in itertools.product(self.noi_names,
                                                  self.cuts):
                    yield {"chiplets": ch, "noi": noi, "cut": cut}

    def configs(self) -> Iterator[MappingConfig]:
        for strat, aspect, reuse, cap, bb in itertools.product(
                self.strategy_names, self.aspects, self.reuses,
                self.dup_caps, self.base_bits_choices):
            bands = self.bands if strat == "boustrophedon" \
                else (MappingConfig.band,)
            for band in bands:
                for fab in self._fabric_variants(strat):
                    yield MappingConfig(strategy=strat, aspect=aspect,
                                        reuse=reuse, dup_cap=cap,
                                        band=band, base_bits=bb, **fab)

    @property
    def size(self) -> int:
        multi = sum(len(self.noi_names) * len(self.cuts)
                    for ch in self.chiplet_counts if ch > 1)
        single = sum(1 for ch in self.chiplet_counts if ch == 1)
        n_strat = sum((len(self.bands) if s == "boustrophedon" else 1)
                      * (single + (multi if s == "snake" else 0))
                      for s in self.strategy_names)
        return n_strat * len(self.aspects) * len(self.reuses) \
            * len(self.dup_caps) * len(self.base_bits_choices)

    # -- mutation (the annealer's neighborhood) ------------------------------

    def mutate(self, cfg: MappingConfig, rng) -> MappingConfig:
        """One random neighbor of ``cfg`` (rng: ``random.Random``).

        ``band`` only exists for the boustrophedon strategy — it is
        never mutated elsewhere, and leaving boustrophedon resets it to
        the dataclass default, so configs differing only in a dead knob
        can't burn annealing budget as fake neighbors.  The chiplet
        knobs follow the same discipline: ``noi``/``cut`` mutate only
        while ``chiplets > 1``, dropping back to one chiplet (or leaving
        the snake strategy, which multi-chiplet sharding requires)
        resets them to the dataclass defaults."""
        knobs = ["strategy", "aspect", "reuse", "dup_cap", "dup_override"]
        if cfg.strategy == "boustrophedon":
            knobs.append("band")
        if len(self.base_bits_choices) > 1:
            knobs.append("base_bits")
        if self.layer_bits_choices:
            knobs.append("layer_bits")
        if len(self.chiplet_counts) > 1:
            knobs.append("chiplets")
        if cfg.chiplets > 1:
            if len(self.noi_names) > 1:
                knobs.append("noi")
            if len(self.cuts) > 1:
                knobs.append("cut")
        knob = rng.choice(knobs)
        if knob == "chiplets":
            ch = rng.choice(self.chiplet_counts)
            if ch == 1:
                return replace(cfg, chiplets=1, noi=MappingConfig.noi,
                               cut=MappingConfig.cut)
            # multi-chiplet sharding is snake-per-chiplet by construction
            return replace(cfg, chiplets=ch, strategy="snake",
                           band=MappingConfig.band)
        if knob == "noi":
            return replace(cfg, noi=rng.choice(self.noi_names))
        if knob == "cut":
            return replace(cfg, cut=rng.choice(self.cuts))
        if knob == "base_bits":
            return replace(cfg,
                           base_bits=rng.choice(self.base_bits_choices))
        if knob == "layer_bits":
            # toggle one layer's precision override (set or lift), the
            # same neighborhood shape as dup_override
            name = rng.choice(self.layer_names)
            prec = dict(cfg.precision)
            if name in prec:
                del prec[name]
            else:
                prec[name] = rng.choice(self.layer_bits_choices)
            return replace(cfg, precision=tuple(sorted(prec.items())))
        if knob == "strategy":
            strat = rng.choice(self.strategy_names)
            band = cfg.band if strat == "boustrophedon" \
                else MappingConfig.band
            out = replace(cfg, strategy=strat, band=band)
            if strat != "snake" and cfg.chiplets > 1:
                out = replace(out, chiplets=1, noi=MappingConfig.noi,
                              cut=MappingConfig.cut)
            return out
        if knob == "aspect":
            return replace(cfg, aspect=rng.choice(self.aspects))
        if knob == "reuse":
            return replace(cfg, reuse=rng.choice(self.reuses))
        if knob == "dup_cap":
            return replace(cfg, dup_cap=rng.choice(self.dup_caps))
        if knob == "band":
            return replace(cfg, band=rng.choice(self.bands))
        # toggle one layer's duplication cap: halve it, or lift an
        # existing override
        name = rng.choice(self.conv_names)
        overrides = dict(cfg.dup_overrides)
        if name in overrides:
            del overrides[name]
        else:
            overrides[name] = max(1, cfg.dup_cap // 2)
        return replace(cfg, dup_overrides=tuple(sorted(overrides.items())))

    # -- building ------------------------------------------------------------

    def strategy(self, cfg: MappingConfig) -> PlacementStrategy:
        by_band = self._strategies.setdefault(
            cfg.band, strategies(self.cnn, band=cfg.band))
        return by_band[cfg.strategy]

    def build(self, cfg: MappingConfig) -> Optional[Built]:
        if cfg.chiplets > 1 and cfg.strategy != "snake":
            return None  # sharding is snake-per-chiplet by construction
        try:
            plan = plan_network(self.cnn, n_c=self.n_c, n_m=self.n_m,
                                reuse=cfg.reuse, dup_cap=cfg.dup_cap,
                                dup_overrides=dict(cfg.dup_overrides))
            if cfg.chiplets > 1:
                placement = shard_network(plan, cfg.chiplets, noi=cfg.noi,
                                          aspect=cfg.aspect, cut=cfg.cut)
            else:
                rows, cols = mesh_shape_for(plan.total_tiles, cfg.aspect)
                placement = self.strategy(cfg).place(plan, rows, cols)
        except (ValueError, NotImplementedError):
            return None
        if validate_placement(plan, placement):
            return None  # rendezvous-slack violation: infeasible
        return Built(config=cfg, plan=plan, placement=placement)
