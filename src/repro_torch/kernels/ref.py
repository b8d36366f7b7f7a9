"""Plain tensor oracles for the port's kernels (``repro/kernels/ref.py``
on torch): the CIM matmul (the functional form and the circuit-faithful
bit-plane form) and the sliding-window attention."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.cim import (
    CIMSpec,
    DEFAULT_SPEC,
    adc_quantize,
    cim_matmul,
    f32_scalar,
)


def cim_matmul_ref(xq: torch.Tensor, wq: torch.Tensor,
                   spec: CIMSpec = DEFAULT_SPEC) -> torch.Tensor:
    """Oracle for the CIM matmul: per-subarray exact int dot -> ADC
    quantize -> digital code accumulation.  (M, K) x (K, N) int8 ->
    (M, N) float32."""
    if xq.dim() != 2 or wq.dim() != 2 or xq.shape[1] != wq.shape[0]:
        raise ValueError(f"{tuple(xq.shape)} x {tuple(wq.shape)}")
    return cim_matmul(xq, wq, spec)


def cim_matmul_bitplane_ref(xq: torch.Tensor, wq: torch.Tensor,
                            spec: CIMSpec = DEFAULT_SPEC) -> torch.Tensor:
    """The *circuit-faithful* oracle: weights decomposed into 8 bit planes
    across bit lines, the current-mirror significances (k/8, k/4, k/2, k
    per 4-bit group), the two integrator groups joined by the 16:1
    charge redistribution, inputs run bit-serially with charge-averaged
    significance (the MSB cycle signed) — then the ADC.

    It must equal :func:`cim_matmul_ref`: the "one exact int dot, then
    the ADC" shortcut of the fast paths is the circuit's semantics.  The
    bit views are ``& 0xFF`` on int32 (never an int8 matmul, which
    wraps); each plane product is a 0/1 dot formed in float64 (exact),
    and the partial sums accumulate in float32 as in the reference —
    every value stays below 2^24, so float32 holds it exactly."""
    if spec.w_bits != 8 or spec.a_bits != 8:
        raise ValueError("the bit-plane oracle models 8-bit cells and inputs")
    if xq.dim() != 2 or wq.dim() != 2 or xq.shape[1] != wq.shape[0]:
        raise ValueError(f"{tuple(xq.shape)} x {tuple(wq.shape)}")
    m, k = xq.shape
    n = wq.shape[1]
    pad = (-k) % spec.n_c
    n_sub = (k + pad) // spec.n_c
    # two's-complement bit planes: w = -128*b7 + sum_{j<7} 2^j * b_j
    wu = torch.nn.functional.pad(wq.to(torch.int32), (0, 0, 0, pad)) & 0xFF
    xu = torch.nn.functional.pad(xq.to(torch.int32), (0, pad)) & 0xFF
    w_planes = [((wu >> j) & 1).to(torch.float64).reshape(n_sub, spec.n_c, n)
                for j in range(8)]
    x_bits = [((xu >> i) & 1).to(torch.float64).reshape(m, n_sub, spec.n_c)
              .transpose(0, 1) for i in range(8)]

    def dot(xb, plane):  # (n_sub, M, n_c) x (n_sub, n_c, N) -> (M, n_sub, N)
        return torch.matmul(xb, plane).transpose(0, 1).to(torch.float32)

    total = torch.zeros((m, n_sub, n), dtype=torch.float32,
                        device=xq.device)
    for i, xb in enumerate(x_bits):  # input bit-serial cycle i
        # lower 4-bit group: mirrors k/8, k/4, k/2, k (ratios 1, 2, 4, 8)
        lo = sum(dot(xb, w_planes[j]) * (2 ** j) for j in range(4))
        # upper group: the same ratios; b7 carries the sign
        hi = sum(dot(xb, w_planes[j]) * (2 ** (j - 4)) for j in range(4, 7))
        hi = hi + dot(xb, w_planes[7]) * (-(2 ** 3))
        # 16:1 charge redistribution joins the groups: hi*16 + lo
        joined = hi * 16.0 + lo
        # input-bit significance by charge averaging across cycles
        sign = -1.0 if i == 7 else 1.0  # two's-complement input MSB
        total = total + joined * sign * (2 ** i)
    codes = adc_quantize(total.to(torch.int32), spec)
    return codes.sum(dim=1).to(torch.float32) * f32_scalar(spec.adc_step,
                                                           xq.device)


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
