"""Deterministic Monte-Carlo robustness harness for device variation —
the port of ``repro/runtime/robustness.py`` on the port's simulator.

Sweeps seeded trials of a :class:`~repro_torch.core.variation.VariationModel`
through the compiled quantized trace path: one ``NetworkSimulator``
build (schedules, trace plans, placement, calibration all amortized),
then per trial only the engine handles are rebuilt
(``NetworkSimulator.set_variation``: the numpy draws on the host, one
upload of the perturbed int8 weights and ADC tables) and the batched
lowering re-runs through the CIM kernel.  The compiled kernel is the
same for every trial; only its operands change.

Reported accuracy is top-1 agreement (random init weights, so agreement
against the nominal quantized run and against the float reference are
the meaningful axes), as mean / std / worst-case over trials.  Logits
stay tensors on the simulator's device until the top-1 step.

Trial ``t`` re-seeds the model with ``seed0 + t`` — same physics, fresh
draw — and the draws are the reference's own numpy streams, so the port
and the reference sweep the same perturbations.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.cim import CIMSpec, DEFAULT_SPEC
from repro_torch.core.engine import CIMEngine
from repro_torch.core.variation import VARIATION_PRESETS, VariationModel
from repro_torch.device import resolve_device
from repro_torch.telemetry.spans import span

__all__ = ["TrialStats", "RobustnessReport", "monte_carlo_sweep",
           "sweep_presets", "build_robust_sim"]


@dataclass(frozen=True)
class TrialStats:
    """mean / std / worst-case of a per-trial metric."""

    mean: float
    std: float
    worst: float

    @classmethod
    def of(cls, values: Sequence[float]) -> "TrialStats":
        v = np.asarray(values, np.float64)
        return cls(mean=float(v.mean()), std=float(v.std()),
                   worst=float(v.min()))


@dataclass
class RobustnessReport:
    """One model x one variation corner, over ``trials`` seeded draws."""

    model: str
    engine: str
    variation: VariationModel
    trials: int
    batch: int
    #: nominal quantized run vs the float32 forward (no variation)
    nominal_agree: float
    #: per-trial top-1 agreement vs the NOMINAL quantized run
    agree: TrialStats
    #: per-trial top-1 agreement vs the float32 reference
    agree_float: TrialStats
    #: zero-magnitude model ran equal by value to the nominal engine
    #: (None = check skipped)
    zero_var_bitwise: Optional[bool] = None
    per_trial: List[float] = field(default_factory=list, repr=False)

    def row(self) -> Dict[str, object]:
        return {
            "model": self.model, "engine": self.engine,
            "variation": self.variation.describe(),
            "trials": self.trials, "batch": self.batch,
            "nominal_agree": self.nominal_agree,
            "agree_mean": self.agree.mean, "agree_std": self.agree.std,
            "agree_worst": self.agree.worst,
            "agree_float_mean": self.agree_float.mean,
            "agree_float_worst": self.agree_float.worst,
            "zero_var_bitwise": self.zero_var_bitwise,
        }


def _make_engine(engine: "str | CIMEngine", spec: Optional[CIMSpec],
                 layer_specs: Optional[Dict[str, object]] = None,
                 clip_overrides: Optional[Dict[str, float]] = None,
                 device=None) -> CIMEngine:
    """A quantized engine on ``device`` with the per-layer precision and
    clip overrides applied.  ``engine`` is ``"cim"`` / ``"pallas"`` (the
    same kernel-backed engine) or a prebuilt :class:`CIMEngine` — e.g.
    one given the reference's calibration by ``convert.copy_calibration``."""
    if isinstance(engine, CIMEngine):
        if spec is not None:
            raise ValueError("pass spec only with an engine *name*; an "
                             "engine instance already carries its spec")
        eng = engine
    elif engine in ("cim", "pallas"):
        eng = CIMEngine(DEFAULT_SPEC if spec is None else spec,
                        device=device)
    else:
        raise ValueError(
            f"robustness sweeps need a quantized engine (cim/pallas), "
            f"not {engine!r}")
    for name, sp in (layer_specs or {}).items():
        if isinstance(sp, CIMSpec):
            eng.set_layer_spec(name, w_bits=sp.w_bits, a_bits=sp.a_bits,
                               adc_bits=sp.adc_bits)
        else:  # a (w_bits, a_bits, adc_bits) triple
            w, a, adc = sp
            eng.set_layer_spec(name, w_bits=w, a_bits=a, adc_bits=adc)
    for name, cp in (clip_overrides or {}).items():
        eng.set_layer_spec(name, clip_percentile=cp)
    return eng


def build_robust_sim(cnn, params, images, *,
                     engine: "str | CIMEngine" = "cim",
                     spec: Optional[CIMSpec] = None,
                     layer_specs: Optional[Dict[str, object]] = None,
                     clip_overrides: Optional[Dict[str, float]] = None,
                     calib_images=None, device=None):
    """One trace-backend quantized simulator on ``device`` (``None`` =
    the card), calibrated on the sweep's own images by default — build
    once, sweep many corners against it.  A prebuilt ``engine`` must
    live on ``device``; layers it has calibrated already keep their
    calibration."""
    from repro_torch.core.network import NetworkSimulator

    dev = resolve_device(device)
    eng = _make_engine(engine, spec, layer_specs, clip_overrides, dev)
    return NetworkSimulator(
        cnn, params, backend="trace", engine=eng, device=dev,
        calib_images=images if calib_images is None else calib_images)


def _float_reference(cnn, params, images, device=None) -> torch.Tensor:
    """The float32 forward (``models/cnn.py::cnn_forward``, TF32 off) on
    ``device``: logits (B, classes), left on the device."""
    from repro_torch.models.cnn import cnn_forward

    dev = resolve_device(device)
    p32 = {k: torch.as_tensor(v).to(dev, torch.float32)
           for k, v in params.items()}
    with torch.no_grad():
        return cnn_forward(p32, torch.as_tensor(images).to(dev, torch.float32),
                           cnn)


def _top1(logits) -> torch.Tensor:
    """Top-1 labels of logits given as a tensor or an array."""
    if not isinstance(logits, torch.Tensor):
        logits = torch.from_numpy(np.array(logits))
    return torch.argmax(logits, dim=-1)


def _agree(a: torch.Tensor, b: torch.Tensor) -> float:
    """Share of equal top-1 labels (the count over the batch, as numpy's
    mean of a boolean array)."""
    return int((a == b).sum().item()) / a.numel()


def monte_carlo_sweep(cnn, params, images, variation: VariationModel,
                      trials: int = 20, *,
                      engine: "str | CIMEngine" = "cim",
                      spec: Optional[CIMSpec] = None,
                      layer_specs: Optional[Dict[str, object]] = None,
                      clip_overrides: Optional[Dict[str, float]] = None,
                      seed0: Optional[int] = None,
                      check_zero: bool = True,
                      calib_images=None, sim=None,
                      ref_logits=None, device=None) -> RobustnessReport:
    """Seeded Monte-Carlo sweep of ``variation`` over ``trials`` draws.

    ``sim`` may be a prebuilt quantized trace simulator (from
    :func:`build_robust_sim`) to amortize calibration across corners;
    its variation model is restored to ``None`` on exit either way.
    ``ref_logits`` (array or tensor) short-circuits the float32
    reference forward.  Without ``sim`` the simulator is built on
    ``device`` (``None`` = the card)."""
    if trials < 1:
        raise ValueError(f"trials must be >= 1: {trials}")
    if sim is None:
        sim = build_robust_sim(cnn, params, images, engine=engine,
                               spec=spec, layer_specs=layer_specs,
                               clip_overrides=clip_overrides,
                               calib_images=calib_images, device=device)
    if ref_logits is None:
        ref_logits = _float_reference(cnn, params, images, sim.device)
    top1_f = _top1(ref_logits).to(sim.device)
    seed0 = variation.seed if seed0 is None else int(seed0)

    try:
        nominal = sim.run(images).logits
        top1_n = _top1(nominal)
        nominal_agree = _agree(top1_n, top1_f)

        zero_ok: Optional[bool] = None
        if check_zero:
            sim.set_variation(VariationModel(seed=seed0))
            zero_ok = bool(torch.equal(sim.run(images).logits + 0.0,
                                       nominal + 0.0))

        agree_n: List[float] = []
        agree_f: List[float] = []
        for t in range(trials):
            with span(f"mc_trial:{cnn.name}", cat="robustness", trial=t):
                with span("engine_swap", cat="robustness", trial=t):
                    sim.set_variation(variation.reseed(seed0 + t))
                top1 = _top1(sim.run(images).logits)
                agree_n.append(_agree(top1, top1_n))
                agree_f.append(_agree(top1, top1_f))
    finally:
        sim.set_variation(None)

    return RobustnessReport(
        model=cnn.name, engine=sim.pe_engine.name,
        variation=variation, trials=trials, batch=int(len(images)),
        nominal_agree=nominal_agree,
        agree=TrialStats.of(agree_n), agree_float=TrialStats.of(agree_f),
        zero_var_bitwise=zero_ok, per_trial=agree_n)


def sweep_presets(cnn, params, images,
                  presets: Optional[Sequence[str]] = None,
                  trials: int = 20, *,
                  engine: "str | CIMEngine" = "cim",
                  spec: Optional[CIMSpec] = None,
                  seed0: int = 0, sim=None, ref_logits=None,
                  device=None) -> Dict[str, RobustnessReport]:
    """Sweep the named variation corners (default: all of
    ``VARIATION_PRESETS``) against ONE shared simulator build — built
    on ``device`` here unless ``sim`` is given."""
    names: Tuple[str, ...] = tuple(presets) if presets is not None \
        else tuple(VARIATION_PRESETS)
    if sim is None:
        sim = build_robust_sim(cnn, params, images, engine=engine,
                               spec=spec, device=device)
    ref = (_float_reference(cnn, params, images, sim.device)
           if ref_logits is None else ref_logits)
    out: Dict[str, RobustnessReport] = {}
    for i, name in enumerate(names):
        out[name] = monte_carlo_sweep(
            cnn, params, images, VARIATION_PRESETS[name], trials,
            seed0=seed0, check_zero=(i == 0), sim=sim, ref_logits=ref)
    return out
