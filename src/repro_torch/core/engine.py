"""Pluggable PE numerics engines on torch tensors — the port of
``repro/core/engine.py``.

* :class:`ExactEngine` — float64 products (``torch.matmul``); allclose to
  the reference's BLAS, whose reduction order differs;
* :class:`CIMEngine` — faithful w8a8 CIM numerics (paper §4.5): int8
  weights resident per tile (one tile == one ``<= n_c``-row subarray),
  activations quantized with a per-layer static scale, an exact integer
  subarray dot, the SAR-ADC round-and-saturate, and the digital code sum
  along the chain.  Its batch-of-tiles and FC-grid MACs go through the
  CIM kernel wrapper (``kernels/cim_matmul.py::cim_codes``): on a CUDA
  tensor that launches the Hopper kernel, on a CPU tensor it runs the
  plain version.  ``"pallas"`` names the same engine, so callers of the
  reference work unchanged.

Handles hold device tensors (int8 weights, float64 dequantization
multipliers, the float32 per-subarray ADC table) built once per layer.
Host work stays numpy, as in the reference: activation-scale and gain
calibration, and device-variation draws (``core/variation.py``, numpy
``default_rng`` streams, so the perturbations equal the reference's).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.cim import CIMSpec, DEFAULT_SPEC, calibrate_gain, divide
from repro_torch.core.simulator import gemm_rows
from repro_torch.core.variation import VariationModel
from repro_torch.device import resolve_device
from repro_torch.kernels import cim_matmul as _kernel

#: engine registry keys accepted by ``make_engine`` / ``NetworkSimulator``
ENGINES = ("exact", "cim", "pallas")


# ---------------------------------------------------------------------------
# Weight quantization shared by every quantized consumer: symmetric int8
# with a per-output-column scale over the flattened contraction — (K*K*C,
# M) for conv kernels, (C_in, C_out) for FC — matching the crossbar layout.
# ---------------------------------------------------------------------------


def quantize_weight(w: torch.Tensor, bits: int = 8
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K, K, C, M) or (C_in, C_out) float -> (q int8 same shape, s (M,)
    float64), on ``w``'s device.  The same float32 max / divide /
    round-half-even / clip as the reference's numpy ``quantize_weight``
    (IEEE elementwise ops), so both give identical weights."""
    if not 2 <= bits <= 8:
        raise ValueError(f"w_bits must be in [2, 8] (int8 storage): {bits}")
    q_max = 2 ** (bits - 1) - 1
    w32 = w.to(torch.float32).reshape(-1, w.shape[-1])
    amax = w32.abs().amax(dim=0, keepdim=True)
    s = divide(torch.clamp_min(amax, 1e-8), q_max)
    q = torch.clamp(torch.round(w32 / s), -q_max - 1, q_max).to(torch.int8)
    return q.reshape(w.shape), s.to(torch.float64).reshape(w.shape[-1])


def dequantize_weight(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_weight` (float64)."""
    return q.to(torch.float64) * s.to(torch.float64).reshape(-1)


def is_quantized_leaf(leaf) -> bool:
    """A ``{"q", "s"}`` dict leaf — the CIM-resident serving format."""
    return isinstance(leaf, dict) and "q" in leaf and "s" in leaf


# ---------------------------------------------------------------------------
# Per-layer engine state (handles)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TileTaps:
    """One tile's weight slice: which taps / channel slice it holds."""

    tap_row: int
    tap_col: int
    pack: int
    c_lo: int
    c_hi: int  # resolved (never None)


def conv_tile_slices(sched) -> Tuple[TileTaps, ...]:
    """The tile -> weight-slice map of a compiled ``BlockSchedule``."""
    out = []
    for prog in sched.tiles:
        c_hi = prog.c_hi if prog.c_hi is not None else sched.c_in
        out.append(TileTaps(prog.tap_row, prog.tap_col, prog.pack,
                            prog.c_lo, c_hi))
    return tuple(out)


@dataclass
class _ADCState:
    """Per-layer quantized state shared by conv and FC handles."""

    deq: Optional[torch.Tensor] = None     # (M,) f64 code -> float
    a_scale: float = 1.0
    a_clip: float = 127.0                  # activation code saturation
    spec: Optional[CIMSpec] = None         # per-layer spec (calibrated gain)
    #: per-subarray ADC variation: (n, 2) float32 [inverse step with
    #: gain error folded in, comparator offset in code LSBs]; None =
    #: nominal scalar conversion
    adc: Optional[torch.Tensor] = None


@dataclass
class ConvHandle(_ADCState):
    """Engine-domain state for one conv layer's tile chain."""

    name: str = ""
    c_out: int = 0
    #: exact engine: per tile (pack, Cs, M) float64
    tile_w: Optional[List[torch.Tensor]] = None
    #: quantized engine: per-tile contraction depth pack * C_slice, and
    #: every tile's int8 weights on a zero-padded common depth
    #: (T, max kc, M) — the batch-of-tiles kernel operand, a view of a
    #: K-major (T, M, depth padded to 16) tensor
    kc: Optional[Tuple[int, ...]] = None
    w8_stack: Optional[torch.Tensor] = None


@dataclass
class FCHandle(_ADCState):
    """Engine-domain state for one FC layer's tile grid."""

    name: str = ""
    w: Optional[torch.Tensor] = None     # exact engine: (C_in, C_out) f64
    #: quantized engine: int8 (C_in, C_out), a view of a K-major
    #: (C_out, C_in) tensor
    w8: Optional[torch.Tensor] = None


@dataclass(frozen=True)
class LayerCalib:
    """Per-layer calibration: activation scale + ADC integration gain."""

    a_scale: float = 1.0
    gain: Optional[float] = None  # None = the spec's own gain


# ---------------------------------------------------------------------------
# The engines
# ---------------------------------------------------------------------------


class PEEngine:
    """Interface every executor MACs through (see the reference's
    ``PEEngine``).  ``device`` is where the engine's handles live."""

    name = "abstract"
    #: quantized engines need the per-layer calibration pass at build
    needs_calibration = False

    def __init__(self, device=None):
        self.device = resolve_device(device)

    def finalize_conv(self, h: ConvHandle, acc: torch.Tensor) -> torch.Tensor:
        return acc

    def finalize_fc(self, h: FCHandle, psum: torch.Tensor,
                    n0: int, n1: int) -> torch.Tensor:
        return psum

    def quant_stream(self, h, x: torch.Tensor) -> torch.Tensor:
        """Convert an activation stream into the engine's input domain
        once per run (identity on the exact engine)."""
        return x

    def calibrate_layer(self, name: str, x: np.ndarray,
                        w: np.ndarray) -> None:
        pass


class ExactEngine(PEEngine):
    """Float64 products on the engine's device, identity finalization."""

    name = "exact"

    def conv_handle(self, name, weights, tiles, prequant=None):
        if prequant is not None:
            weights = dequantize_weight(*prequant)
        weights = weights.to(self.device, torch.float64)
        tile_w = [weights[tt.tap_row, tt.tap_col:tt.tap_col + tt.pack,
                          tt.c_lo:tt.c_hi] for tt in tiles]
        return ConvHandle(name=name, c_out=weights.shape[-1], tile_w=tile_w)

    def tile_mac(self, h, t, taps):
        """taps[d]: (rows, Cs) float64 — the gathered patch columns of
        packed tap ``d``, accumulated in tap order."""
        w = h.tile_w[t]
        acc = None
        for d, px in enumerate(taps):
            if acc is None:
                acc = torch.zeros((px.shape[0], h.c_out), dtype=torch.float64,
                                  device=px.device)
            acc = acc + gemm_rows(px, w[d])
        return acc

    def fc_handle(self, name, w, prequant=None):
        if prequant is not None:
            w = dequantize_weight(*prequant)
        return FCHandle(name=name, w=w.to(self.device, torch.float64))

    def fc_mac(self, h, x, k0, k1, n0, n1):
        return gemm_rows(x, h.w[k0:k1, n0:n1])


class CIMEngine(PEEngine):
    """w8a8 + per-subarray SAR ADC, digitally accumulated (paper §4.5),
    with every subarray dot and conversion in the CIM kernel.

    Codes are integers (exact in float64), so the chain/group/batch
    association order cannot change a bit."""

    name = "cim"
    needs_calibration = True

    #: default activation-clip percentile (percentile clipping: a rare
    #: outlier saturates instead of stretching the int8 range)
    CLIP_PERCENTILE = 99.9

    def __init__(self, spec: CIMSpec = DEFAULT_SPEC,
                 use_calibrated_gain: bool = True,
                 clip_percentile: Optional[float] = None,
                 variation: Optional[VariationModel] = None,
                 device=None):
        super().__init__(device)
        self.spec = spec
        self.use_calibrated_gain = use_calibrated_gain
        self.clip_percentile = (self.CLIP_PERCENTILE if clip_percentile
                                is None else float(clip_percentile))
        if not 0.0 < self.clip_percentile <= 100.0:
            raise ValueError(
                f"clip_percentile must be in (0, 100]: {clip_percentile}")
        self.calib: Dict[str, LayerCalib] = {}
        #: per-layer bit-scalable spec overrides (kept out of ``calib``
        #: so ``calibrate_engine``'s already-calibrated skip still works)
        self.layer_specs: Dict[str, CIMSpec] = {}
        #: per-layer activation-clip percentile overrides
        self.clip_overrides: Dict[str, float] = {}
        #: device-variation model injected into every handle built after
        #: it is set (``None`` = ideal arithmetic)
        self.variation = variation

    # -- calibration ---------------------------------------------------------

    def set_layer(self, name: str, a_scale: float = 1.0,
                  gain: Optional[float] = None) -> "CIMEngine":
        self.calib[name] = LayerCalib(a_scale=a_scale, gain=gain)
        return self

    def set_layer_spec(self, name: str, *, w_bits: Optional[int] = None,
                       a_bits: Optional[int] = None,
                       adc_bits: Optional[int] = None,
                       clip_percentile: Optional[float] = None
                       ) -> "CIMEngine":
        """Per-layer bit-scalable precision / calibration override (set
        before handles are built / calibration runs)."""
        base = self.layer_specs.get(name, self.spec)
        kw = {}
        if w_bits is not None:
            kw["w_bits"] = int(w_bits)
        if a_bits is not None:
            kw["a_bits"] = int(a_bits)
        if adc_bits is not None:
            kw["adc_bits"] = int(adc_bits)
        if kw:
            self.layer_specs[name] = replace(base, **kw)
        if clip_percentile is not None:
            cp = float(clip_percentile)
            if not 0.0 < cp <= 100.0:
                raise ValueError(
                    f"clip_percentile must be in (0, 100]: {cp}")
            self.clip_overrides[name] = cp
        return self

    def _base_spec(self, name: str) -> CIMSpec:
        return self.layer_specs.get(name, self.spec)

    def calibrate_layer(self, name, x, w):
        """Derive (a_scale, gain) from one layer's captured float input
        (host numpy, as in the reference)."""
        spec = self._base_spec(name)
        clip = self.clip_overrides.get(name, self.clip_percentile)
        x = np.asarray(x, np.float32)
        mags = np.abs(x)
        if clip >= 100.0:
            a_obs = float(np.max(mags))
        else:
            a_obs = float(np.percentile(mags, clip))
        a_scale = max(a_obs / spec.a_max, 1e-8)
        gain = None
        if self.use_calibrated_gain:
            cols, wmat = _calibration_matrix(x, np.asarray(w, np.float32))
            if wmat.shape[1] > _CALIB_COLS:
                # weight columns quantize independently (per-column
                # scales), so a deterministic column stride is
                # self-consistent — it just reads fewer ADC channels
                wmat = wmat[:, ::math.ceil(wmat.shape[1] / _CALIB_COLS)]
            gain = calibrate_gain(cols, wmat, spec)
        self.calib[name] = LayerCalib(a_scale=a_scale, gain=gain)

    def _layer_spec(self, name: str) -> Tuple[CIMSpec, float]:
        cal = self.calib.get(name, LayerCalib())
        spec = self._base_spec(name)
        if cal.gain is not None and self.use_calibrated_gain:
            spec = replace(spec, gain=cal.gain)
        return spec, cal.a_scale

    # -- device variation ----------------------------------------------------

    def _perturbed(self, name: str, q: torch.Tensor, spec: CIMSpec
                   ) -> torch.Tensor:
        """Weight-cell variation on the FULL quantized tensor, before tile
        slicing, drawn by the numpy ``VariationModel`` on the host."""
        vm = self.variation
        if vm is None or not vm.has_weight:
            return q
        pert = vm.perturb_weights(name, q.cpu().numpy(), spec.w_max)
        return torch.from_numpy(pert).to(q.device)

    def _adc_table(self, name: str, n_sub: int, spec: CIMSpec
                   ) -> Optional[torch.Tensor]:
        vm = self.variation
        if vm is None or not vm.has_adc:
            return None
        inv, off = vm.adc_params(name, n_sub, float(spec.adc_inv_step))
        return torch.from_numpy(np.stack([inv, off], axis=1)).to(self.device)

    # -- handles -------------------------------------------------------------

    def _common(self, name: str, s_w: torch.Tensor, n_sub: int) -> dict:
        spec, a_scale = self._layer_spec(name)
        # code -> float: ADC step back to dot units, then the w8a8 scales
        deq = (spec.adc_step * a_scale) * s_w.to(self.device, torch.float64)
        return dict(deq=deq, a_scale=a_scale, a_clip=float(spec.a_max),
                    spec=spec, adc=self._adc_table(name, n_sub, spec))

    def _weights(self, name, w, prequant):
        spec, _ = self._layer_spec(name)
        if prequant is not None and spec.w_bits == 8:
            q, s = prequant
            s = s.to(torch.float64).reshape(-1)
        else:
            # per-layer w_bits below the serving format's 8: requantize
            # from the float weights onto the narrower grid
            q, s = quantize_weight(w, spec.w_bits)
        return self._perturbed(name, q.to(self.device), spec), s

    def conv_handle(self, name, weights, tiles, prequant=None):
        q, s = self._weights(name, weights, prequant)
        for tt in tiles:
            if tt.pack * (tt.c_hi - tt.c_lo) > self.spec.n_c:
                raise ValueError(
                    f"{name}: tile holds {tt.pack}x{tt.c_hi - tt.c_lo} "
                    f"weight rows > n_c={self.spec.n_c} — not one subarray")
        # batch-of-tiles view: each tile's (pack * Cs, M) slab on a
        # zero-padded common depth — padded rows add nothing to the
        # exact integer dot.  Stored K-major, (T, M, depth padded to 16),
        # the layout the kernel reads; w8_stack is its (T, max kc, M) view
        m = q.shape[-1]
        kc = tuple(tt.pack * (tt.c_hi - tt.c_lo) for tt in tiles)
        w8_k = torch.zeros((len(tiles), m, -(-max(kc) // 16) * 16),
                           dtype=torch.int8, device=self.device)
        for i, tt in enumerate(tiles):
            w8_k[i, :, :kc[i]] = q[tt.tap_row, tt.tap_col:tt.tap_col + tt.pack,
                                   tt.c_lo:tt.c_hi].reshape(kc[i], m).T
        return ConvHandle(name=name, c_out=m, kc=kc,
                          w8_stack=w8_k[:, :, :max(kc)].transpose(1, 2),
                          **self._common(name, s, len(tiles)))

    def fc_handle(self, name, w, prequant=None):
        q, s = self._weights(name, w, prequant)
        # one physical per-subarray ADC every n_c weight rows; grid tiles
        # index into this shared pool by k0 // n_c (see fc_mac)
        n_alloc = 2 * math.ceil(q.shape[0] / self._layer_spec(name)[0].n_c) + 1
        # stored K-major, (N, K); w8 is its (K, N) view, so each grid
        # tile's slice reaches the kernel with no copy
        return FCHandle(name=name, w8=q.T.contiguous().T,
                        **self._common(name, s, n_alloc))

    # -- the numerics --------------------------------------------------------

    def quant_stream(self, h, x):
        """Static per-layer activation quantization to int8 (the float64
        divide / round half to even / clip of the reference)."""
        return torch.clamp(torch.round(divide(x, h.a_scale)), -h.a_clip - 1,
                           h.a_clip).to(torch.int8)

    def tile_mac(self, h: ConvHandle, t: int, taps) -> torch.Tensor:
        """One tile's MAC, the per-tile reference fold's step: ``taps[d]``
        (rows, Cs) int8, already quantized — the tile's packed-tap window
        side by side is one subarray's input.  One kernel call (one
        step, this tile's ADC table row).  Returns (rows, M) float64
        codes."""
        x = torch.cat(taps, dim=1)[None]
        adc = None if h.adc is None else h.adc[t:t + 1]
        return _kernel.cim_codes(x, h.w8_stack[t:t + 1, :x.shape[2]], h.spec,
                                 adc=adc).to(torch.float64)

    def tiles_mac(self, h: ConvHandle, patches: torch.Tensor) -> torch.Tensor:
        """Batch-of-tiles MAC: ``patches`` (T, R, max kc) int8, already
        quantized, zero past each tile's depth.  One kernel call: T
        subarray dots, T conversions, the code sum over tiles — the
        chain/group digital fold.  Returns (R, M) float64 code sums."""
        return _kernel.cim_codes(patches, h.w8_stack, h.spec,
                                 adc=h.adc).to(torch.float64)

    def finalize_conv(self, h, acc):
        return acc * h.deq

    def fc_mac(self, h: FCHandle, x: torch.Tensor, k0: int, k1: int,
               n0: int, n1: int) -> torch.Tensor:
        """One FC grid tile: ``x`` (B, k1 - k0) int8 (already quantized).
        The tile's rows split into ``n_c``-row subarrays (the last one
        ragged), one conversion each, codes summed — global subarray
        ``k0 // n_c + i`` reads row ``i`` of the layer's ADC table."""
        adc = None
        if h.adc is not None:
            n_c = h.spec.n_c
            lo = k0 // n_c
            adc = h.adc[lo:lo + -(-(k1 - k0) // n_c)]
        return _kernel.cim_codes(x, h.w8[k0:k1, n0:n1], h.spec,
                                 adc=adc).to(torch.float64)

    def fc_layer_mac(self, h: FCHandle, x: torch.Tensor) -> torch.Tensor:
        """A whole FC layer in one kernel call: ``x`` (B, c_in) int8
        (already quantized) against the resident (c_in, c_out) weights,
        cut into the layer's ``n_c``-row subarrays (the last one ragged),
        subarray ``t`` converted by row ``t`` of the ADC table.  Returns
        (B, c_out) float64 code sums: for grid tiles that each hold
        whole subarrays, every column chain's sum of its tiles'
        ``fc_mac`` codes (integers, so the order of the sum is moot)."""
        adc = None
        if h.adc is not None:
            adc = h.adc[:-(-x.shape[1] // h.spec.n_c)]
        return _kernel.cim_codes(x, h.w8, h.spec, adc=adc).to(torch.float64)

    def finalize_fc(self, h, psum, n0, n1):
        return psum * h.deq[n0:n1]


def make_engine(engine, cim_spec: Optional[CIMSpec] = None,
                device=None) -> PEEngine:
    """Resolve an engine selection (name or instance) to a ``PEEngine``
    on ``device``."""
    dev = resolve_device(device)
    if isinstance(engine, PEEngine):
        if cim_spec is not None:
            raise ValueError(
                "pass cim_spec only with an engine *name*; an engine "
                "instance already carries its spec")
        if engine.device != dev:
            raise ValueError(
                f"the engine lives on {engine.device}, not {dev}")
        return engine
    if engine == "exact":
        if cim_spec is not None:
            raise ValueError("cim_spec has no effect on the exact engine")
        return ExactEngine(dev)
    if engine in ("cim", "pallas"):
        return CIMEngine(cim_spec if cim_spec is not None else DEFAULT_SPEC,
                         device=dev)
    raise ValueError(f"engine must be one of {ENGINES}: {engine!r}")


# ---------------------------------------------------------------------------
# Calibration driver
# ---------------------------------------------------------------------------

#: cap on im2col rows fed to calibrate_gain (deterministic stride
#: subsample — calibration reads magnitudes, not every pixel)
_CALIB_ROWS = 4096
#: cap on weight columns fed to calibrate_gain (per-column quantization
#: makes a column subsample self-consistent)
_CALIB_COLS = 512


def _calibration_matrix(x: np.ndarray, w: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """(layer input, weight) -> (im2col'd activations, flat weight matrix)
    in the (C, K, K) feature order of the reference's CIM forward; the
    row subsample happens before patch extraction (host numpy)."""
    if w.ndim == 2:
        cols = x.reshape(-1, x.shape[-1])
        if cols.shape[0] > _CALIB_ROWS:
            cols = cols[::math.ceil(cols.shape[0] / _CALIB_ROWS)]
        return cols, w
    k, _, c, m = w.shape
    b, h, wd, _ = x.shape
    total = b * h * wd
    # magnitudes, not geometry: unit stride + SAME padding samples densest
    # and never yields an empty patch set (late layers can be smaller than
    # their kernel)
    step = math.ceil(total / _CALIB_ROWS) if total > _CALIB_ROWS else 1
    idx = np.arange(0, total, step)
    bi, rest = np.divmod(idx, h * wd)
    yi, xi = np.divmod(rest, wd)
    lo = (k - 1) // 2
    xp = np.zeros((b, h + k - 1, wd + k - 1, c), np.float32)
    xp[:, lo:lo + h, lo:lo + wd] = x
    dy, dx = np.meshgrid(np.arange(k), np.arange(k), indexing="ij")
    # (rows, k, k, C) windows at the sampled centres
    win = xp[bi[:, None, None], yi[:, None, None] + dy[None],
             xi[:, None, None] + dx[None]]
    cols = win.transpose(0, 3, 1, 2).reshape(len(idx), -1)  # (C, K, K) order
    return cols, w.transpose(2, 0, 1, 3).reshape(-1, m)


def calibrate_engine(engine: PEEngine, cnn,
                     params: Dict[str, torch.Tensor],
                     images) -> None:
    """Run the float forward on ``images`` on the engine's device,
    capture every layer's input and hand each (input, weight) pair to
    the engine's per-layer calibration.  Layers the engine already knows
    are left alone (a pre-calibrated engine can be reused, or given the
    reference's calibration through ``convert.copy_calibration``)."""
    if not engine.needs_calibration:
        return
    todo = [l.name for l in cnn.layers if l.name not in
            getattr(engine, "calib", {})]
    if not todo:
        return
    from repro_torch.models.cnn import collect_layer_inputs
    from repro_torch.telemetry.spans import span

    dev = engine.device
    with span(f"calibrate:{cnn.name}", engine=engine.name, layers=len(todo)):
        p32 = {k: v.to(dev, torch.float32) for k, v in params.items()}
        imgs = torch.as_tensor(images).to(dev, torch.float32)
        inputs = collect_layer_inputs(p32, imgs, cnn)
        for name in todo:
            engine.calibrate_layer(name, inputs[name].cpu().numpy(),
                                   params[name].cpu().numpy())
