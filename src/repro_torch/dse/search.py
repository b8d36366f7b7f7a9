"""Mapping search: exhaustive sweeps for small spaces, seeded simulated
annealing for large ones.

Candidates are scored **analytically** — the Tab. 4 energy model
(``core/energy.py``, which now accounts routed links under the injected
placement) plus routed byte-hop / hotspot metrics from the shared
:func:`~repro_torch.dse.placements.network_links` model walked over
``MeshNoC`` routes.  No cycle-level simulation runs in the inner loop;
the winner is *validated* afterwards by running ``NetworkSimulator``
under the found placement and checking bitwise output equality with the
snake baseline (``repro_torch.dse.report`` / ``tests/test_dse.py``).
Quantized searches (``cim_spec=``) pair with ``run_dse(engine="cim")``:
validation then runs the fused integer-native trace lowering
(``core/trace.py``) — the compiled path the winning mapping would serve
on — whose ADC codes are placement-invariant by the same argument.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.configs.cnn import CNNConfig
from repro_torch.core.cim import CIMSpec  # noqa: F401  (annotation: cim_spec=)
from repro_torch.core.energy import analyze_plan
from repro_torch.core.mapping import NetworkPlan
from repro_torch.core.noc import Placement
from repro_torch.core.transport import NOI
from repro_torch.dse.placements import network_links
from repro_torch.dse.space import Built, DesignSpace, MappingConfig, layer_specs_for
from repro_torch.telemetry.spans import span


@dataclass(frozen=True)
class Score:
    """The Pareto axes (plus the scalar energy context they came from)."""

    tops_per_w: float       # compute efficiency (maximize)
    inf_per_s: float        # throughput (maximize)
    tiles: int              # chip cost (minimize)
    max_link_bytes: float   # NoC hotspot (minimize)
    total_byte_hops: float  # routed traffic volume x distance (minimize)
    energy_uj: float        # per-inference total, for the report
    adc_share: float = 0.0  # ADC fraction of total (precision-aware scoring)
    #: interposer-level byte-hops (routed, functional-execution view);
    #: 0 on a single-mesh mapping — the chiplet Pareto-shift axis
    noi_byte_hops: float = 0.0
    # robustness axes (None unless the search ran with an accuracy_fn —
    # a NaN sentinel would break Score equality): top-1 agreement vs the
    # float32 forward, nominal and Monte-Carlo mean under the sweep's
    # device-variation model
    acc_nominal: Optional[float] = None
    acc_noisy: Optional[float] = None

    def as_dict(self) -> Dict[str, float]:
        return {
            "tops_per_w": self.tops_per_w,
            "inf_per_s": self.inf_per_s,
            "tiles": self.tiles,
            "max_link_bytes": self.max_link_bytes,
            "total_byte_hops": self.total_byte_hops,
            "energy_uj": self.energy_uj,
            "adc_share": self.adc_share,
            "noi_byte_hops": self.noi_byte_hops,
            "acc_nominal": self.acc_nominal,
            "acc_noisy": self.acc_noisy,
        }


@dataclass(frozen=True)
class Candidate:
    config: MappingConfig
    plan: NetworkPlan
    placement: Placement
    score: Score


def routed_traffic(plan: NetworkPlan, placement: Placement,
                   cnn: Optional[CNNConfig] = None
                   ) -> Tuple[float, float]:
    """(total byte-hops, max per-physical-link bytes) of the whole
    network's analytic links routed over the placement's mesh."""
    noc = placement.noc
    per_link: Dict[Tuple[Tuple[int, int], Tuple[int, int]], float] = {}
    total = 0.0
    for ln in network_links(plan, cnn):
        path = noc.route(ln.src, ln.dst)
        total += ln.nbytes * (len(path) - 1)
        for u, v in zip(path, path[1:]):
            per_link[(u, v)] = per_link.get((u, v), 0.0) + ln.nbytes
    return total, max(per_link.values(), default=0.0)


def evaluate(cnn: CNNConfig, built: Built,
             cim_spec: "CIMSpec | None" = None,
             accuracy: Optional[Tuple[float, float]] = None) -> Candidate:
    """Score one built mapping.  ``cim_spec`` engages the precision-aware
    CIM energy model (``core/energy.py``) so the Pareto front reports
    *quantized* TOPS/W — ADC conversion energy scaling with ``adc_bits``
    over the mapping's actual subarray count — instead of the flat
    fully-utilized Tab. 4 anchor.  Configs carrying a non-nominal
    precision point (``base_bits``/per-layer overrides) are charged at
    their per-layer bits (TOPS/W-at-precision); ``accuracy`` is the
    ``(nominal, noisy)`` top-1-agreement pair measured for that
    precision point (the accuracy-under-variation axis)."""
    layer_specs = None
    if cim_spec is not None and (built.config.base_bits != (8, 8, 8)
                                 or built.config.precision):
        layer_specs = layer_specs_for(
            built.config, cim_spec, tuple(l.name for l in cnn.layers))
    rep = analyze_plan(cnn, built.plan, placement=built.placement,
                       cim_spec=cim_spec, layer_specs=layer_specs)
    byte_hops, max_link = routed_traffic(built.plan, built.placement, cnn)
    acc_nom, acc_noisy = (None, None) if accuracy is None else accuracy
    return Candidate(
        config=built.config, plan=built.plan, placement=built.placement,
        score=Score(
            tops_per_w=rep.ce_tops_per_w,
            inf_per_s=rep.inferences_per_s,
            tiles=built.plan.total_tiles,
            max_link_bytes=max_link,
            total_byte_hops=byte_hops,
            energy_uj=rep.e_total * 1e6,
            adc_share=rep.adc_share,
            noi_byte_hops=float(rep.routed_byte_hops.get(NOI, 0)),
            acc_nominal=acc_nom,
            acc_noisy=acc_noisy,
        ))


#: default scalar objective: minimize routed traffic (the paper's
#: locality headline); the Pareto front keeps the other axes honest
def byte_hop_objective(s: Score) -> float:
    return s.total_byte_hops


@dataclass
class SearchResult:
    model: str
    baseline: Candidate              # snake / square / reuse=1 reference
    candidates: List[Candidate]      # every feasible point evaluated
    evaluations: int
    mode: str                        # "exhaustive" | "anneal"

    def best(self, objective: Callable[[Score], float] = byte_hop_objective
             ) -> Candidate:
        return min(self.candidates, key=lambda c: objective(c.score))

    def winner(self) -> Candidate:
        """The best *placement* at the baseline plan: among candidates
        sharing the baseline's reuse/duplication (so byte-hop deltas are
        pure placement effects, apples-to-apples), the lowest total
        byte-hops whose hotspot (max link bytes) is no worse than the
        snake baseline's; falls back to the hotspot-unconstrained best
        of that pool (which includes the baseline itself)."""
        base_cfg, base = self.baseline.config, self.baseline.score
        pool = [c for c in self.candidates
                if c.config.reuse == base_cfg.reuse
                and c.config.dup_cap == base_cfg.dup_cap
                and not c.config.dup_overrides]
        ok = [c for c in pool
              if c.score.max_link_bytes <= base.max_link_bytes]
        return min(ok or pool, key=lambda c: c.score.total_byte_hops)


def baseline_config(dup_cap: int) -> MappingConfig:
    return MappingConfig(strategy="snake", aspect=1.0, reuse=1,
                         dup_cap=dup_cap)


def search(cnn: CNNConfig, space: Optional[DesignSpace] = None,
           budget: int = 128, seed: int = 0,
           dup_cap: Optional[int] = None,
           objective: Callable[[Score], float] = byte_hop_objective,
           cim_spec: "CIMSpec | None" = None,
           accuracy_fn: Optional[Callable[[MappingConfig],
                                          Tuple[float, float]]] = None
           ) -> SearchResult:
    """Explore ``space`` with at most ``budget`` evaluations.

    Small spaces sweep exhaustively; larger ones run seeded simulated
    annealing (restart hill-climb with a geometric temperature ladder).
    The snake baseline is always evaluated and included.  ``cim_spec``
    scores every candidate with the precision-aware quantized energy
    model (see :func:`evaluate`).

    ``accuracy_fn(config) -> (nominal, noisy)`` attaches measured top-1
    agreement (nominal quantized, and Monte-Carlo mean under variation)
    to every candidate.  Accuracy depends only on the config's
    *precision point* — placement and duplication move bytes, never
    math — so the (expensive: it runs the compiled quantized trace
    path) callback is invoked once per distinct ``precision_key`` and
    memoized across the whole search.
    """
    if space is None:
        space = DesignSpace(cnn)
    if dup_cap is None:
        dup_cap = max(space.dup_caps)

    acc_cache: Dict[Tuple, Tuple[float, float]] = {}

    def acc_of(cfg: MappingConfig) -> Optional[Tuple[float, float]]:
        if accuracy_fn is None:
            return None
        key = cfg.precision_key
        if key not in acc_cache:
            acc_cache[key] = accuracy_fn(cfg)
        return acc_cache[key]

    base_built = space.build(baseline_config(dup_cap))
    if base_built is None:
        raise ValueError(f"{cnn.name}: the snake baseline itself is "
                         "infeasible — space misconfigured")
    baseline = evaluate(cnn, base_built, cim_spec,
                        accuracy=acc_of(base_built.config))

    seen: Dict[MappingConfig, Candidate] = {baseline.config: baseline}
    evals = 1

    def score_of(cfg: MappingConfig) -> Optional[Candidate]:
        nonlocal evals
        if cfg in seen:
            return seen[cfg]
        if evals >= budget:
            return None
        with span(f"dse_eval:{cnn.name}", cat="dse", eval=evals):
            built = space.build(cfg)
            evals += 1
            if built is None:
                return None
            cand = evaluate(cnn, built, cim_spec, accuracy=acc_of(cfg))
        seen[cfg] = cand
        return cand

    if space.size <= budget:
        mode = "exhaustive"
        for cfg in space.configs():
            score_of(cfg)
    else:
        mode = "anneal"
        rng = random.Random(seed)
        cur = baseline
        cur_cost = objective(cur.score)
        t0 = max(1e-12, 0.05 * abs(cur_cost))  # ~5% uphill accepted early
        steps = max(1, budget - evals)
        step = 0
        # the step ceiling bounds the walk when mutations keep landing on
        # already-seen configs (cached hits don't burn budget)
        while evals < budget and step < 50 * budget:
            step += 1
            temp = t0 * (0.02 ** (step / steps))  # geometric cooling
            cand = score_of(space.mutate(cur.config, rng))
            if cand is None:
                continue
            delta = objective(cand.score) - cur_cost
            if delta <= 0 or rng.random() < _exp(-delta / max(temp, 1e-30)):
                cur, cur_cost = cand, objective(cand.score)

    return SearchResult(model=cnn.name, baseline=baseline,
                        candidates=list(seen.values()),
                        evaluations=evals, mode=mode)


def _exp(x: float) -> float:
    try:
        return math.exp(x)
    except OverflowError:
        return 0.0
