"""Plain tensor oracles for the CIM kernel (the CIM part of
``repro/kernels/ref.py``)."""
from __future__ import annotations

import torch

from repro_torch.core.cim import CIMSpec, DEFAULT_SPEC, cim_matmul


def cim_matmul_ref(xq: torch.Tensor, wq: torch.Tensor,
                   spec: CIMSpec = DEFAULT_SPEC) -> torch.Tensor:
    """Oracle for the CIM matmul: per-subarray exact int dot -> ADC
    quantize -> digital code accumulation.  (M, K) x (K, N) int8 ->
    (M, N) float32."""
    if xq.dim() != 2 or wq.dim() != 2 or xq.shape[1] != wq.shape[0]:
        raise ValueError(f"{tuple(xq.shape)} x {tuple(wq.shape)}")
    return cim_matmul(xq, wq, spec)


def int8_matmul_exact_ref(xq: torch.Tensor, wq: torch.Tensor
                          ) -> torch.Tensor:
    """Lossless int8 matmul (what an ideal, infinite-resolution ADC
    gives): exact integer dots (float64, never an int8 matmul, which
    wraps), returned as float32."""
    return torch.matmul(xq.to(torch.float64),
                        wq.to(torch.float64)).to(torch.float32)
