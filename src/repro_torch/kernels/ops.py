"""Layer-facing wrapper around the CIM kernel — the port of
``repro/kernels/ops.py``.

:func:`cim_linear` takes float activations and pre-quantized int8
weights, quantizes the activations per tensor, runs the CIM pipeline
(``kernels/cim_matmul.py::cim_codes``, ``emit_codes=False``),
dequantizes and applies the Domino "tail" ops that Rofm computes in the
last tile (bias, activation).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.cim import CIMSpec, DEFAULT_SPEC, quantize_symmetric
from repro_torch.kernels.cim_matmul import cim_codes


def cim_linear(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
               bias: Optional[torch.Tensor] = None,
               spec: CIMSpec = DEFAULT_SPEC,
               use_pallas: bool = False,
               activation: Optional[str] = None) -> torch.Tensor:
    """x (..., K) float @ pre-quantized wq (K, N) int8 -> (..., N) float,
    in ``x``'s dtype.

    The reference chooses between its Pallas kernel and a plain jnp
    pipeline with ``use_pallas``; here both choices are one call of
    :func:`~repro_torch.kernels.cim_matmul.cim_codes`, which launches the
    Hopper kernel on a CUDA tensor and runs its plain version on a CPU
    one — no plain path runs on the card.  The flag is kept so that
    callers of the reference work unchanged."""
    del use_pallas  # one pipeline either way (see above)
    lead = x.shape[:-1]
    xq, x_scale = quantize_symmetric(x.to(torch.float32), spec.a_bits)
    acc = cim_codes(xq.reshape(-1, xq.shape[-1]), wq, spec,
                    emit_codes=False).reshape(*lead, -1)
    out = acc * x_scale * w_scale.reshape((1,) * len(lead) + (-1,))
    if bias is not None:
        out = out + bias
    if activation is not None:
        out = _ACTIVATIONS[activation](out)
    return out.to(x.dtype)


def quantize_weights(w: torch.Tensor, spec: CIMSpec = DEFAULT_SPEC):
    """Per-output-column symmetric int8 weight quantization (offline —
    Domino programs the cells once at initialization).  Returns (wq,
    scale); ``wq`` is stored K-major, the layout the kernel reads, so a
    :func:`cim_linear` call on the card copies no weight."""
    wq, scale = quantize_symmetric(w, spec.w_bits, axis=0)
    return wq.T.contiguous().T, scale


def _gelu_tanh(v: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(v, approximate="tanh")


_ACTIVATIONS: dict = {
    "relu": torch.relu,
    "silu": F.silu,
    "gelu": _gelu_tanh,
    "tanh": torch.tanh,
}
