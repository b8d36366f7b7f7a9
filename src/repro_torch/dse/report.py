"""Pareto frontiers and DSE reports (the shape of the paper's Tab. 4 /
Fig. 7 trade-off, per model).

The frontier is computed over four axes: compute efficiency (TOPS/W,
max), throughput (inferences/s, max), chip cost (tiles, min) and NoC
hotspot (max link bytes, min).  ``run_dse`` drives the whole flow —
search, winner selection, optional bitwise validation against the snake
baseline — and renders markdown / JSON.

The port of ``repro/dse/report.py``: the frontier, the report classes
and the writers are copied host code; the validation and the accuracy
probes run the port's ``NetworkSimulator`` on a device (``None`` = the
card).
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.cnn import CNN_BENCHMARKS, CNNConfig, ConvLayer
from repro_torch.device import resolve_device
from repro_torch.dse.search import Candidate, SearchResult, search
from repro_torch.dse.space import DesignSpace
from repro_torch.models.cnn import init_cnn
from repro_torch.telemetry.spans import span

#: (attribute, sense) — sense +1 maximizes, -1 minimizes
PARETO_AXES: Tuple[Tuple[str, int], ...] = (
    ("tops_per_w", +1),
    ("inf_per_s", +1),
    ("tiles", -1),
    ("max_link_bytes", -1),
)

#: the robustness DSE's frontier: TOPS/W-at-precision against
#: accuracy-under-variation (plus throughput / chip cost) — the
#: bit-scalable trade the Princeton CIM chip demonstrates
ROBUST_AXES: Tuple[Tuple[str, int], ...] = (
    ("tops_per_w", +1),
    ("acc_noisy", +1),
    ("inf_per_s", +1),
    ("tiles", -1),
)


def dominates(a, b, axes: Sequence[Tuple[str, int]] = PARETO_AXES) -> bool:
    """True iff ``a`` is no worse than ``b`` on every axis and strictly
    better on at least one (scores, or anything with the axis attrs)."""
    strict = False
    for attr, sense in axes:
        va, vb = getattr(a, attr) * sense, getattr(b, attr) * sense
        if va < vb:
            return False
        if va > vb:
            strict = True
    return strict


def pareto_front(items: Sequence, key: Callable = lambda c: c.score,
                 axes: Sequence[Tuple[str, int]] = PARETO_AXES) -> List:
    """Non-dominated subset of ``items`` (order-preserving)."""
    front = []
    for i, it in enumerate(items):
        si = key(it)
        dominated = False
        for j, other in enumerate(items):
            if j == i:
                continue
            so = key(other)
            if dominates(so, si, axes):
                dominated = True
                break
            # exact duplicates: keep only the first occurrence
            if j < i and all(getattr(so, a) == getattr(si, a)
                             for a, _ in axes):
                dominated = True
                break
        if not dominated:
            front.append(it)
    return front


# ---------------------------------------------------------------------------
# Per-model report
# ---------------------------------------------------------------------------


@dataclass
class ModelReport:
    model: str
    result: SearchResult
    winner: Candidate
    validated: Optional[bool]  # bitwise-vs-baseline; None = not run

    def row(self) -> Dict:
        base, win = self.result.baseline.score, self.winner.score
        return {
            "model": self.model,
            "strategy": self.winner.config.describe(),
            "byte_hops": win.total_byte_hops,
            "byte_hops_snake": base.total_byte_hops,
            "byte_hops_saving_pct":
                100.0 * (1 - win.total_byte_hops / base.total_byte_hops),
            "max_link_bytes": win.max_link_bytes,
            "max_link_bytes_snake": base.max_link_bytes,
            "tops_per_w": win.tops_per_w,
            "tops_per_w_snake": base.tops_per_w,
            "inf_per_s": win.inf_per_s,
            "tiles": win.tiles,
            "evaluations": self.result.evaluations,
            "mode": self.result.mode,
            "validated_bitwise": self.validated,
        }

    def pareto_rows(self) -> List[Dict]:
        rows = []
        for c in pareto_front(self.result.candidates):
            rows.append({"config": c.config.describe(),
                         **c.score.as_dict()})
        return sorted(rows, key=lambda r: -r["tops_per_w"])


def validate_bitwise(cnn: CNNConfig, winner: Candidate,
                     batch: int = 2, seed: int = 0,
                     engine: str = "exact", device=None) -> bool:
    """Run ``NetworkSimulator`` on ``device`` under the winner's
    placement and under the snake baseline of the *same plan* — outputs
    must be equal (placement changes hops, never math), compared by
    value (``-0.0 == 0.0``).  ``engine`` selects the PE numerics;
    quantized engines (``"cim"``/``"pallas"``) validate on the fused
    integer-native trace lowering through the CIM kernel — the path DSE
    winners would serve on — whose ADC codes are themselves invariant
    under placement."""
    from repro_torch.core.network import NetworkSimulator

    rng = np.random.default_rng(seed)
    params = {}
    for l in cnn.layers:
        if isinstance(l, ConvLayer):
            params[l.name] = rng.integers(
                -1, 2, (l.k, l.k, l.c, l.m)).astype(np.float64)
        else:
            params[l.name] = rng.integers(
                -1, 2, (l.c_in, l.c_out)).astype(np.float64)
    x = rng.integers(0, 2, (batch, cnn.input_hw, cnn.input_hw, 3)
                     ).astype(np.float64)
    cfg = winner.config
    kw = dict(reuse=cfg.reuse, dup_cap=cfg.dup_cap,
              dup_overrides=dict(cfg.dup_overrides), backend="trace",
              engine=engine, device=resolve_device(device))
    base = NetworkSimulator(cnn, params, **kw).run(x)
    opt = NetworkSimulator(cnn, params, placement=winner.placement,
                           **kw).run(x)
    return bool(torch.equal(base.logits + 0.0, opt.logits + 0.0))


def run_dse(models: Sequence[str], budget: int = 128, seed: int = 0,
            validate: str = "cifar10",
            space_factory: Optional[Callable[[CNNConfig], DesignSpace]]
            = None, cim_spec=None,
            engine: str = "exact", device=None) -> List[ModelReport]:
    """Search each model's space and assemble reports.

    ``validate``: "none", "cifar10" (default: bitwise-check winners of
    simulable CIFAR-sized models only) or "all".  ``cim_spec`` (a
    ``CIMSpec``) scores candidates with the precision-aware quantized
    energy model, so the Pareto fronts report quantized TOPS/W.
    ``engine`` selects the PE numerics winners are validated under;
    quantized engines run the compiled integer-native trace path, so a
    quantized DSE (``cim_spec`` + ``engine="cim"``) both scores and
    validates the configuration it would actually serve.  Validation
    runs on ``device`` (``None`` = the card); search and scoring are
    host code.
    """
    reports = []
    for name in models:
        cnn = CNN_BENCHMARKS[name]()
        dup_cap = 128 if name == "resnet50-imagenet" else 64
        space = space_factory(cnn) if space_factory else DesignSpace(
            cnn, dup_caps=(dup_cap,))
        with span(f"dse_search:{name}", cat="dse", budget=budget):
            result = search(cnn, space, budget=budget, seed=seed,
                            dup_cap=dup_cap, cim_spec=cim_spec)
        winner = result.winner()
        validated: Optional[bool] = None
        if validate == "all" or (validate == "cifar10"
                                 and cnn.dataset == "cifar10"):
            with span(f"dse_validate:{name}", cat="dse"):
                validated = validate_bitwise(cnn, winner, seed=seed,
                                             engine=engine, device=device)
        reports.append(ModelReport(model=name, result=result,
                                   winner=winner, validated=validated))
    return reports


# ---------------------------------------------------------------------------
# Robustness DSE: precision axes + accuracy-under-variation
# ---------------------------------------------------------------------------


@dataclass
class RobustModelReport:
    """One model's robustness search: the ROBUST_AXES Pareto front with
    per-layer precision and measured accuracy-under-variation live."""

    model: str
    result: "SearchResult"
    variation: object                # the swept VariationModel
    trials: int
    front: List[Candidate]
    zero_var_bitwise: Optional[bool]

    def best_accuracy(self) -> Candidate:
        return max(self.front, key=lambda c: (c.score.acc_noisy,
                                              c.score.tops_per_w))

    def best_efficiency(self) -> Candidate:
        return max(self.front, key=lambda c: (c.score.tops_per_w,
                                              c.score.acc_noisy))

    def pareto_rows(self) -> List[Dict]:
        rows = [{"config": c.config.describe(), **c.score.as_dict()}
                for c in self.front]
        return sorted(rows, key=lambda r: -r["acc_noisy"])


def run_robust_dse(models: Sequence[str] = ("vgg11-cifar10",
                                            "resnet18-cifar10"),
                   budget: int = 32, seed: int = 0, trials: int = 5,
                   batch: int = 4, variation=None, engine: str = "cim",
                   base_spec=None,
                   space_factory: Optional[Callable[[CNNConfig],
                                                    DesignSpace]] = None,
                   device=None) -> List[RobustModelReport]:
    """The robustness DSE: search mapping x precision, measuring every
    distinct precision point's accuracy on the compiled quantized trace
    path under ``variation`` (``trials`` Monte-Carlo draws), and keep
    the ``ROBUST_AXES`` frontier — TOPS/W-at-precision vs
    accuracy-under-variation.

    Beyond the enumerated network-wide ``base_bits`` grid, two
    deterministic per-layer probes join the candidate pool (first conv
    and the FC head dropped to the most aggressive bits choice) so the
    per-layer ``(w_bits, a_bits, adc_bits)`` axis is exercised even when
    the mapping sub-space sweeps exhaustively (per-layer overrides are
    otherwise mutation-only, like ``dup_overrides``).

    Every accuracy point runs on ``device`` (``None`` = the card).  The
    params are the port's ``init_cnn`` from a ``torch.Generator``
    seeded with ``seed`` — not the reference's numbers, which come from
    ``jax.random``.
    """
    from dataclasses import replace as _cfg_replace

    from repro_torch.core.cim import DEFAULT_SPEC
    from repro_torch.core.variation import VARIATION_PRESETS
    from repro_torch.dse.space import layer_specs_for
    from repro_torch.runtime.robustness import (_float_reference,
                                                monte_carlo_sweep)

    dev = resolve_device(device)
    if variation is None:
        variation = VARIATION_PRESETS["all"]
    spec = DEFAULT_SPEC if base_spec is None else base_spec

    reports: List[RobustModelReport] = []
    for name in models:
        cnn = CNN_BENCHMARKS[name]()
        params = init_cnn(cnn, generator=torch.Generator().manual_seed(seed),
                          device=dev)
        rng = np.random.default_rng(seed)
        images = rng.random((batch, cnn.input_hw, cnn.input_hw, 3))
        ref = _float_reference(cnn, params, images, dev)
        dup_cap = 128 if name == "resnet50-imagenet" else 64
        space = space_factory(cnn) if space_factory else DesignSpace(
            cnn, strategy_names=("snake", "hilbert"), aspects=(1.0,),
            reuses=(1,), dup_caps=(dup_cap,),
            base_bits_choices=((8, 8, 8), (8, 8, 6), (6, 6, 6)),
            layer_bits_choices=((6, 6, 4),))
        aggressive = min(space.layer_bits_choices
                         or space.base_bits_choices)

        zero_ok: List[Optional[bool]] = []

        def accuracy_fn(cfg):
            ls = layer_specs_for(cfg, spec, space.layer_names)
            rep = monte_carlo_sweep(
                cnn, params, images, variation, trials, engine=engine,
                spec=spec, layer_specs=ls, seed0=seed,
                check_zero=not zero_ok, ref_logits=ref, device=dev)
            if rep.zero_var_bitwise is not None:
                zero_ok.append(rep.zero_var_bitwise)
            return rep.nominal_agree, rep.agree_float.mean

        # memoize by precision point so the probes below reuse draws
        memo: Dict[Tuple, Tuple[float, float]] = {}

        def cached_acc(cfg):
            key = cfg.precision_key
            if key not in memo:
                memo[key] = accuracy_fn(cfg)
            return memo[key]

        result = search(cnn, space, budget=budget, seed=seed,
                        dup_cap=dup_cap, cim_spec=spec,
                        accuracy_fn=cached_acc)

        # deterministic per-layer precision probes on the most efficient
        # mapping found: dropping the first conv and the head to the
        # aggressive bits choice strictly raises TOPS/W-at-precision, so
        # the probe is non-dominated and per-layer precision shows up on
        # the front with its measured accuracy cost
        from repro_torch.dse.search import evaluate
        base_cfg = max(result.candidates,
                       key=lambda c: c.score.tops_per_w).config
        probe_layers = (space.conv_names[0], space.layer_names[-1])
        for ln in probe_layers:
            cfg = _cfg_replace(base_cfg,
                               precision=((ln, tuple(aggressive)),))
            if any(c.config == cfg for c in result.candidates):
                continue
            built = space.build(cfg)
            if built is None:
                continue
            result.candidates.append(
                evaluate(cnn, built, spec, accuracy=cached_acc(cfg)))
            result.evaluations += 1

        front = pareto_front(result.candidates, axes=ROBUST_AXES)
        reports.append(RobustModelReport(
            model=name, result=result, variation=variation, trials=trials,
            front=front,
            zero_var_bitwise=zero_ok[0] if zero_ok else None))
    return reports


def robust_to_markdown(reports: Sequence[RobustModelReport]) -> str:
    """The robustness table: nominal vs noisy top-1 agreement for each
    model's accuracy- and efficiency-winners, then the full precision-
    aware frontier."""
    lines = ["# Domino robustness DSE report", ""]
    if reports:
        v = reports[0].variation
        lines += [f"Variation corner: `{v.describe()}`, "
                  f"{reports[0].trials} Monte-Carlo trials per precision "
                  "point (compiled quantized trace path).", "",
                  "## Winners: nominal vs noisy top-1 agreement", "",
                  "| model | winner | config | TOPS/W | top-1 nominal | "
                  "top-1 noisy (MC mean) | zero-var bitwise |",
                  "|---|---|---|---|---|---|---|"]
    for rep in reports:
        z = {True: "==", False: "MISMATCH", None: "n/a"}[
            rep.zero_var_bitwise]
        for label, cand in (("best accuracy", rep.best_accuracy()),
                            ("best TOPS/W", rep.best_efficiency())):
            s = cand.score
            lines.append(
                f"| {rep.model} | {label} | {cand.config.describe()} "
                f"| {s.tops_per_w:.2f} | {s.acc_nominal:.3f} "
                f"| {s.acc_noisy:.3f} | {z} |")
    for rep in reports:
        lines += ["", f"## {rep.model} precision/robustness frontier "
                      f"({rep.result.evaluations} evaluations)", "",
                  "| config | TOPS/W | acc nominal | acc noisy | inf/s | "
                  "tiles |",
                  "|---|---|---|---|---|---|"]
        for r in rep.pareto_rows():
            lines.append(
                f"| {r['config']} | {r['tops_per_w']:.2f} "
                f"| {r['acc_nominal']:.3f} | {r['acc_noisy']:.3f} "
                f"| {r['inf_per_s']:.3g} | {r['tiles']:.0f} |")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Rendering
# ---------------------------------------------------------------------------


def to_markdown(reports: Sequence[ModelReport]) -> str:
    lines = ["# Domino mapping DSE report", "",
             "## Best-found mapping per model (vs snake baseline)", "",
             "| model | winning mapping | byte-hops (vs snake) | "
             "max link B (vs snake) | TOPS/W (vs snake) | inf/s | tiles | "
             "bitwise |",
             "|---|---|---|---|---|---|---|---|"]
    for rep in reports:
        r = rep.row()
        v = {True: "==", False: "MISMATCH", None: "n/a"}[r[
            "validated_bitwise"]]
        lines.append(
            f"| {r['model']} | {r['strategy']} "
            f"| {r['byte_hops']:,.0f} ({-r['byte_hops_saving_pct']:+.1f}%) "
            f"| {r['max_link_bytes']:,.0f} "
            f"(snake {r['max_link_bytes_snake']:,.0f}) "
            f"| {r['tops_per_w']:.2f} (snake {r['tops_per_w_snake']:.2f}) "
            f"| {r['inf_per_s']:.3g} | {r['tiles']} | {v} |")
    for rep in reports:
        lines += ["", f"## {rep.model} Pareto frontier "
                      f"({rep.result.mode}, {rep.result.evaluations} "
                      "evaluations)", "",
                  "| config | TOPS/W | inf/s | tiles | max link B | "
                  "byte-hops |",
                  "|---|---|---|---|---|---|"]
        for r in rep.pareto_rows():
            lines.append(
                f"| {r['config']} | {r['tops_per_w']:.2f} "
                f"| {r['inf_per_s']:.3g} | {r['tiles']:.0f} "
                f"| {r['max_link_bytes']:,.0f} "
                f"| {r['total_byte_hops']:,.0f} |")
    return "\n".join(lines) + "\n"


def to_json(reports: Sequence[ModelReport]) -> str:
    return json.dumps({
        "dse": [{
            **rep.row(),
            "pareto": rep.pareto_rows(),
        } for rep in reports]
    }, indent=1)
