"""CIM array numerics on torch tensors — the port of ``repro/core/cim.py``.

The Domino PE (paper §4.5) stores 8-bit weights as single-level cells
across bit lines; bit-plane significances, the 16:1 group join and
charge-averaged bit-serial inputs together equal an exact int8 dot
product, so the only nonideality kept is the per-subarray (``n_c``
rows) SAR ADC: ``q = clip(round(d * gain * Q / FS), -Q-1, Q)``, with
ADC codes accumulated digitally across subarrays.

``CIMSpec``, ``lossless_spec``, ``calibrate_gain`` and ``_quant_np`` are
numpy host code copied from the reference.  The tensor functions keep
its arithmetic op for op: exact integer dots (formed in float64, exact
below 2^53), int32 -> float32, a float32 multiply by the float32
inverse step, an optional separately rounded float32 offset add, round
half to even, saturate.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class CIMSpec:
    """Static description of one CIM crossbar (Domino Tab. 3 defaults)."""

    n_c: int = 256  # rows per subarray = ADC accumulation granularity
    n_m: int = 256  # columns (8-bit weights) per array
    w_bits: int = 8
    a_bits: int = 8
    adc_bits: int = 8
    # integration gain k (paper §4.5): scales the ADC input so the useful
    # dot-product range fills the converter.  gain=FS/target_range.
    gain: float = 16.0

    @property
    def q_max(self) -> int:
        return 2 ** (self.adc_bits - 1) - 1

    @property
    def w_max(self) -> int:
        return 2 ** (self.w_bits - 1) - 1

    @property
    def a_max(self) -> int:
        return 2 ** (self.a_bits - 1) - 1

    @property
    def full_scale(self) -> float:
        """Max |dot| one subarray can produce (drives the ADC range)."""
        return float(self.n_c * self.w_max * self.a_max)

    @property
    def adc_inv_step(self) -> float:
        """Multiplier taking an exact int32 subarray dot to ADC codes."""
        return self.gain * self.q_max / self.full_scale

    @property
    def adc_step(self) -> float:
        return 1.0 / self.adc_inv_step

    @property
    def lossless(self) -> bool:
        """True if the ADC step <= 1 (no information lost)."""
        return self.adc_step <= 1.0


DEFAULT_SPEC = CIMSpec()


def lossless_spec(n_c: int = 256, w_bits: int = 8, a_bits: int = 8) -> CIMSpec:
    """A spec whose ADC step is exactly 1 code per dot unit: the converter
    is wide enough that ``q_max >= full_scale`` (no saturation) and the
    gain makes the float32 inverse step round to exactly 1.0 — so ADC
    codes *are* the exact subarray dots."""
    w_max = 2 ** (w_bits - 1) - 1
    a_max = 2 ** (a_bits - 1) - 1
    fs = n_c * w_max * a_max
    adc_bits = math.ceil(math.log2(fs + 1)) + 1  # q_max = 2^(b-1)-1 >= fs
    q_max = 2 ** (adc_bits - 1) - 1
    spec = CIMSpec(n_c=n_c, w_bits=w_bits, a_bits=a_bits,
                   adc_bits=adc_bits, gain=fs / q_max)
    assert spec.lossless and np.float32(spec.adc_inv_step) == np.float32(1.0)
    return spec


def f32_scalar(value: float, device) -> torch.Tensor:
    """A 0-d float32 tensor: pins a Python float to its float32 rounding
    before it meets a float32 tensor, as numpy's ``np.float32`` and
    JAX's weak types do."""
    return torch.tensor(np.float32(value), dtype=torch.float32, device=device)


def divide(x: torch.Tensor, value: float) -> torch.Tensor:
    """``x / value`` rounded as an IEEE division on every device, as
    numpy divides.  On a CUDA tensor PyTorch turns a division by a Python
    number into a multiply by its reciprocal, which can round to another
    float; a 0-d divisor on ``x``'s device (filled there, no copy) keeps
    the division."""
    return x / torch.full((), value, dtype=x.dtype, device=x.device)


# ---------------------------------------------------------------------------
# Quantization helpers
# ---------------------------------------------------------------------------


def quantize_symmetric(x: torch.Tensor, bits: int = 8,
                       axis: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor (or per-axis) int quantization.

    Returns (q, scale) with x ~= q * scale, q in int8.
    """
    qmax = 2 ** (bits - 1) - 1
    xa = x.abs()
    amax = xa.amax() if axis is None else xa.amax(dim=axis, keepdim=True)
    scale = divide(torch.clamp_min(amax, 1e-8), qmax)
    q = torch.clamp(torch.round(x / scale), -qmax - 1, qmax).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def adc_quantize(d: torch.Tensor, spec: CIMSpec) -> torch.Tensor:
    """The SAR-ADC model: round-and-saturate an exact subarray dot.

    ``d`` holds exact integer dots (int32 or integral float64).  Output
    is int32 ADC codes in [-q_max-1, q_max].
    """
    acc = d.to(torch.int32).to(torch.float32) * f32_scalar(
        spec.adc_inv_step, d.device)
    return torch.clamp(torch.round(acc), -spec.q_max - 1,
                       spec.q_max).to(torch.int32)


def adc_dequantize(codes: torch.Tensor, spec: CIMSpec) -> torch.Tensor:
    return codes.to(torch.float32) * f32_scalar(spec.adc_step, codes.device)


def adc_convert(d: torch.Tensor, inv_step32, code_lo: float, code_hi: float,
                offset: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The SAR conversion on exact integer dots: int32 -> float32, scale
    by the float32 inverse step, (optionally) add the float32 offset as
    a separately rounded op, round half to even, saturate.  Output is
    ADC codes as float64.

    ``inv_step32`` is a float scalar or a float32 tensor broadcastable
    against ``d`` (per-subarray gain error); ``offset`` (same broadcast
    rules, in code LSBs) models the per-subarray comparator offset.
    """
    if not torch.is_tensor(inv_step32):
        inv_step32 = f32_scalar(inv_step32, d.device)
    acc = d.to(torch.int32).to(torch.float32) * inv_step32
    if offset is not None:
        acc = acc + offset
    return torch.clamp(torch.round(acc), code_lo, code_hi).to(torch.float64)


def calibrate_gain(x, w, spec: CIMSpec, percentile: float = 100.0) -> float:
    """Pick the integration gain k so the `percentile` of subarray dots
    fills the ADC range (the knob the paper's current mirrors provide).

    Host numpy, as in the reference: calibration runs once per layer at
    network build, and the dots are exact small integers, so float64
    BLAS reproduces the int32 einsum bit for bit.
    """
    x = np.asarray(x, np.float32)
    w = np.asarray(w, np.float32)
    xq = _quant_np(x.reshape(-1, x.shape[-1]), spec.a_bits)
    wq = _quant_np(w, spec.w_bits, axis=0)
    k_dim = w.shape[0]
    pad = (-k_dim) % spec.n_c
    if pad:
        xq = np.pad(xq, ((0, 0), (0, pad)))
        wq = np.pad(wq, ((0, pad), (0, 0)))
    n_sub = (k_dim + pad) // spec.n_c
    xs = xq.reshape(-1, n_sub, spec.n_c).transpose(1, 0, 2)
    ws = wq.reshape(n_sub, spec.n_c, -1)
    d = np.matmul(xs, ws)  # (n_sub, B, N) exact per-subarray integer dots
    mag = float(np.percentile(np.abs(d).astype(np.float32), percentile))
    if mag <= 0:
        return 1.0
    return max(1.0, spec.full_scale / mag)


def _quant_np(x: np.ndarray, bits: int, axis: Optional[int] = None
              ) -> np.ndarray:
    """Numpy mirror of :func:`quantize_symmetric` (int-valued float64)."""
    qmax = 2 ** (bits - 1) - 1
    amax = np.max(np.abs(x), axis=axis, keepdims=axis is not None)
    scale = np.maximum(amax, 1e-8).astype(np.float32) / qmax
    return np.clip(np.round(x / scale), -qmax - 1, qmax).astype(np.float64)


# ---------------------------------------------------------------------------
# Functional CIM matmul (the plain tensor semantics)
# ---------------------------------------------------------------------------


def subarray_dots(xq: torch.Tensor, wq: torch.Tensor, n_c: int
                  ) -> torch.Tensor:
    """Exact per-subarray integer dots of (..., K) int8 x (K, N) int8:
    K zero-padded to a multiple of ``n_c``, returned as (..., n_sub, N)
    integral float64 (exact below 2^53; never an int8 matmul, which
    wraps)."""
    k_dim = wq.shape[0]
    pad = (-k_dim) % n_c
    xf = xq.to(torch.float64)
    wf = wq.to(torch.float64)
    if pad:
        xf = torch.nn.functional.pad(xf, (0, pad))
        wf = torch.nn.functional.pad(wf, (0, 0, 0, pad))
    n_sub = (k_dim + pad) // n_c
    lead = xf.shape[:-1]
    xs = xf.reshape(*lead, n_sub, 1, n_c)
    ws = wf.reshape(n_sub, n_c, -1)
    return torch.matmul(xs, ws).squeeze(-2)


def cim_matmul(xq: torch.Tensor, wq: torch.Tensor,
               spec: CIMSpec = DEFAULT_SPEC) -> torch.Tensor:
    """int8 x int8 -> f32 code sum through the per-subarray ADC pipeline.

    xq: (..., K) int8, wq: (K, N) int8.  Returns (..., N) float32 equal to
    ``sum_s adc_dequant(adc_quant(dot_s))`` — what the Rofm accumulates.
    """
    codes = adc_quantize(subarray_dots(xq, wq, spec.n_c), spec)
    return codes.sum(dim=-2).to(torch.float32) * f32_scalar(
        spec.adc_step, xq.device)


def cim_linear_reference(x: torch.Tensor, w: torch.Tensor,
                         spec: CIMSpec = DEFAULT_SPEC,
                         w_scale: Optional[torch.Tensor] = None,
                         wq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Float-in/float-out CIM linear: quantize activations per-tensor,
    weights per-column (pre-quantized if wq given), run the ADC pipeline,
    dequantize."""
    if wq is None:
        wq, w_scale = quantize_symmetric(w, spec.w_bits, axis=0)
    xq, x_scale = quantize_symmetric(x, spec.a_bits)
    acc = cim_matmul(xq, wq, spec)
    return acc * x_scale * w_scale.reshape((1,) * (x.ndim - 1) + (-1,))
