"""Plain tensor oracles for the port's kernels (``repro/kernels/ref.py``
on torch): the CIM matmul and the sliding-window attention."""
from __future__ import annotations

from typing import Optional

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


def local_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        window: int, causal: bool = True,
                        softcap: Optional[float] = None) -> torch.Tensor:
    """Oracle for the sliding-window attention kernel.

    q, k, v: (B, H, S, D).  Token i attends to [i-window+1, i] (causal).
    The scores are formed in the input dtype and then taken to float32,
    as the reference's oracle does."""
    s, d = q.shape[-2], q.shape[-1]
    logits = torch.matmul(q, k.transpose(-1, -2)).float() * d ** -0.5
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    qi = torch.arange(s, device=q.device)[:, None]
    ki = torch.arange(s, device=q.device)[None, :]
    mask = ki <= qi if causal else torch.ones((s, s), dtype=torch.bool,
                                              device=q.device)
    mask = mask & (ki > qi - window)
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    p = torch.softmax(logits, dim=-1)
    return torch.matmul(p.to(v.dtype), v)
