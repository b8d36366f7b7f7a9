"""Design-space exploration for Domino mappings.

Turns the mapping (placement curve, mesh aspect, weight duplication,
block reuse) from a constant into a searchable space:

* :mod:`repro_torch.dse.placements` — pluggable ``PlacementStrategy`` set
  (snake / boustrophedon / hilbert / greedy), the analytic link model,
  and the rendezvous-slack validator;
* :mod:`repro_torch.dse.space`      — ``MappingConfig`` / ``DesignSpace``
  enumeration with ``plan_network`` as the feasibility oracle;
* :mod:`repro_torch.dse.search`     — exhaustive sweep or seeded simulated
  annealing, scored by the analytic energy model + routed byte-hops;
* :mod:`repro_torch.dse.report`     — Pareto frontiers over (TOPS/W, inf/s,
  tiles, max link bytes) and markdown/JSON reports, plus the bitwise
  placement-invariance validation.

CLI: ``python -m repro_torch.dse --models vgg11-cifar10 resnet18-cifar10``.
"""
from repro_torch.dse.placements import (
    BoustrophedonBlockPlacement,
    GreedyTrafficPlacement,
    HilbertPlacement,
    PlacementStrategy,
    SnakePlacement,
    network_links,
    strategies,
    validate_placement,
)
from repro_torch.dse.report import (
    ModelReport,
    dominates,
    pareto_front,
    run_dse,
    to_json,
    to_markdown,
    validate_bitwise,
)
from repro_torch.dse.search import (
    Candidate,
    Score,
    SearchResult,
    evaluate,
    routed_traffic,
    search,
)
from repro_torch.dse.space import Built, DesignSpace, MappingConfig

__all__ = [
    "BoustrophedonBlockPlacement", "Built", "Candidate", "DesignSpace",
    "GreedyTrafficPlacement", "HilbertPlacement", "MappingConfig",
    "ModelReport", "PlacementStrategy", "Score", "SearchResult",
    "SnakePlacement", "dominates", "evaluate", "network_links",
    "pareto_front", "routed_traffic", "run_dse", "search", "strategies",
    "to_json", "to_markdown", "validate_bitwise", "validate_placement",
]
