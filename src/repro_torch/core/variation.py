"""Device-variation models for the analog CIM arrays (fault injection).

Real ReRAM/SRAM compute-in-memory silicon deviates from the ideal
integer arithmetic the reproduction's :class:`~repro_torch.core.engine.CIMEngine`
computes: programmed cell conductances carry multiplicative write noise,
a fraction of cells are stuck at zero / full-scale, and every
per-subarray SAR ADC has its own offset and gain error.  Domino's
power-efficiency claims (Tab. 4) assume none of this; this module makes
the deviation injectable behind the ``PEEngine`` seam so the *same*
compiled trace path (``core/trace.py``) can be swept Monte-Carlo style
(``runtime/robustness.py``) without touching the exact float engine.

Design constraints (all load-bearing for the bitwise test matrix):

* **Determinism** — every draw comes from
  ``np.random.default_rng([seed, crc32(layer_name), stream])``, so a
  given ``(VariationModel, layer)`` pair perturbs identically no matter
  which engine (``CIMEngine`` vs ``PallasEngine``), lowering (per-tile
  interp vs fused trace vs jitted trace) or call order observes it.
  ``zlib.crc32`` is used instead of ``hash()`` because the latter is
  salted per process.
* **Perturb once, before tiling** — weights are perturbed on the *full*
  quantized integer tensor, before it is sliced into subarray tiles.
  Every derived view (``tile_w8`` / ``w_stack`` / the Pallas operand)
  then sees the same integers, so the engine-equality invariants of the
  nominal path survive under variation by construction.
* **ADC error stays in the shared conversion arithmetic** — offset and
  gain perturb the float32 multiply-add inside
  :func:`repro_torch.core.cim.adc_convert` (and the CIM kernel), per
  *subarray*, exactly where a real per-column SAR ADC sits.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["VariationModel", "VARIATION_PRESETS", "preset"]


@dataclass(frozen=True)
class VariationModel:
    """Seeded description of device non-idealities.

    All magnitudes default to zero; a zero-magnitude model is
    ``is_null`` and the engines skip injection entirely, so it is
    bitwise-equivalent to running with no model at all (tested on all
    benchmark geometries).
    """

    seed: int = 0
    #: std-dev of multiplicative conductance (write) noise on the
    #: programmed integer weight: ``q' = round(q * (1 + N(0, sigma)))``
    conductance_sigma: float = 0.0
    #: fraction of cells stuck at zero conductance (weight -> 0)
    stuck_zero: float = 0.0
    #: fraction of cells stuck at full conductance (weight -> +w_max)
    stuck_one: float = 0.0
    #: per-subarray ADC offset error, in output-code LSBs
    adc_offset_sigma: float = 0.0
    #: per-subarray ADC gain error, relative (perturbs the code slope)
    adc_gain_sigma: float = 0.0

    # -- classification ----------------------------------------------------
    @property
    def has_weight(self) -> bool:
        return (self.conductance_sigma != 0.0 or self.stuck_zero != 0.0
                or self.stuck_one != 0.0)

    @property
    def has_adc(self) -> bool:
        return self.adc_offset_sigma != 0.0 or self.adc_gain_sigma != 0.0

    @property
    def is_null(self) -> bool:
        return not (self.has_weight or self.has_adc)

    def describe(self) -> str:
        parts = [f"seed={self.seed}"]
        if self.conductance_sigma:
            parts.append(f"sigma_g={self.conductance_sigma:g}")
        if self.stuck_zero:
            parts.append(f"sa0={self.stuck_zero:g}")
        if self.stuck_one:
            parts.append(f"sa1={self.stuck_one:g}")
        if self.adc_offset_sigma:
            parts.append(f"adc_off={self.adc_offset_sigma:g}")
        if self.adc_gain_sigma:
            parts.append(f"adc_gain={self.adc_gain_sigma:g}")
        return "variation(" + ", ".join(parts) + ")"

    def reseed(self, seed: int) -> "VariationModel":
        """Same physics, fresh Monte-Carlo draw."""
        return replace(self, seed=seed)

    # -- draws -------------------------------------------------------------
    def _rng(self, name: str, stream: int) -> np.random.Generator:
        # crc32 keys the per-layer stream stably across processes;
        # stream 0 = weight cells, stream 1 = ADC parameters.
        return np.random.default_rng(
            [int(self.seed), zlib.crc32(name.encode("utf-8")), stream])

    def perturb_weights(self, name: str, q: np.ndarray,
                        w_max: int) -> np.ndarray:
        """Perturbed copy of the quantized integer weight tensor ``q``.

        Applies conductance noise (round back to the integer grid, clip
        to the signed ``w_bits`` range) then stuck-at masks drawn from a
        single uniform field (so stuck-at-0 and stuck-at-1 cells are
        disjoint).  Same dtype in, same dtype out.
        """
        q = np.asarray(q)
        if not self.has_weight:
            return q
        out = q.astype(np.float64)
        rng = self._rng(name, 0)
        if self.conductance_sigma != 0.0:
            noise = rng.normal(0.0, self.conductance_sigma, q.shape)
            out = np.clip(np.round(out * (1.0 + noise)),
                          -float(w_max) - 1.0, float(w_max))
        if self.stuck_zero != 0.0 or self.stuck_one != 0.0:
            u = rng.random(q.shape)
            out = np.where(u < self.stuck_zero, 0.0, out)
            hi = self.stuck_zero + self.stuck_one
            out = np.where((u >= self.stuck_zero) & (u < hi),
                           float(w_max), out)
        return out.astype(q.dtype)

    def adc_params(self, name: str, n_sub: int, inv_step: float
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """Per-subarray ADC ``(inv, offset)`` float32 arrays.

        ``inv`` is the nominal inverse conversion step with the gain
        error folded in (so a zero-sigma gain reproduces the nominal
        ``np.float32(inv_step)`` bit pattern exactly); ``offset`` is in
        output-code LSBs and is added *before* rounding, mirroring an
        input-referred SAR comparator offset.
        """
        rng = self._rng(name, 1)
        gain = (rng.normal(0.0, self.adc_gain_sigma, n_sub)
                if self.adc_gain_sigma != 0.0 else np.zeros(n_sub))
        off = (rng.normal(0.0, self.adc_offset_sigma, n_sub)
               if self.adc_offset_sigma != 0.0 else np.zeros(n_sub))
        inv32 = np.asarray(float(inv_step) * (1.0 + gain), np.float32)
        return inv32, np.asarray(off, np.float32)


#: named corners used by the robustness bench / README table; magnitudes
#: follow the usual ReRAM literature ballparks (a few % conductance
#: noise, sub-% stuck cells, sub-LSB ADC offset)
VARIATION_PRESETS: Dict[str, VariationModel] = {
    "noise": VariationModel(conductance_sigma=0.03),
    "stuck": VariationModel(stuck_zero=0.005, stuck_one=0.002),
    "adc": VariationModel(adc_offset_sigma=0.5, adc_gain_sigma=0.02),
    "all": VariationModel(conductance_sigma=0.03, stuck_zero=0.005,
                          stuck_one=0.002, adc_offset_sigma=0.5,
                          adc_gain_sigma=0.02),
}


def preset(name: Optional[str]) -> Optional[VariationModel]:
    """Look up a named corner (``None``/"none" -> no variation)."""
    if name is None or name == "none":
        return None
    try:
        return VARIATION_PRESETS[name]
    except KeyError:
        raise KeyError(f"unknown variation preset {name!r}; "
                       f"have {sorted(VARIATION_PRESETS)}") from None
