"""Card-only checks of the port (marker ``cuda``): they skip without an
NVIDIA card, and import no ``jax`` so that they run on the card's
machine (``pytest -m cuda tests/test_torch_*.py``).

Tolerances.  CIM kernel: equal by value — the kernel and its plain
version compute the same exact integer dots and the same float32
conversion ops.  Local attention: float32 within rtol = atol = 2e-5 (the
reference's own kernel-vs-oracle tolerance; the two sum in other
orders), bfloat16 within rtol = atol = 1e-2 (both round p and the
output to bfloat16 at other points; one bfloat16 ulp is 2^-8 relative).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.cim import CIMSpec  # noqa: E402
from repro_torch.kernels import local_attention as LA  # noqa: E402
from repro_torch.kernels.cim_matmul import (  # noqa: E402
    LAUNCHES,
    cim_codes,
    cim_codes_plain,
)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")


def _ints(rng, shape):
    return torch.from_numpy(
        rng.integers(-128, 128, shape).astype(np.int8)).cuda()


def _table(rng, n, spec):
    inv = np.float32(spec.adc_inv_step) * (1 + 0.02 * rng.standard_normal(n))
    off = 0.5 * rng.standard_normal(n)
    return torch.from_numpy(
        np.stack([inv, off], axis=1).astype(np.float32)).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("n_c", [32, 96, 256])
def test_cuda_kernel_matches_plain(n_c):
    """Both layouts, both ADC flavors, both output modes, ragged R, N
    and K; every call launches the kernel once."""
    _needs_card()
    rng = np.random.default_rng(n_c)
    spec = CIMSpec(n_c=n_c)
    cases = [(_ints(rng, (5, 37, n_c - 3)), _ints(rng, (5, n_c - 3, 77))),
             (_ints(rng, (13, 3 * n_c + 11)), _ints(rng, (3 * n_c + 11, 130))),
             (_ints(rng, (18, 16, n_c)), _ints(rng, (18, n_c, 512)))]
    before = sum(LAUNCHES.values())
    for x, w in cases:
        steps = x.shape[0] if x.dim() == 3 else -(-x.shape[1] // n_c)
        for adc in (None, _table(rng, steps, spec)):
            for emit in (True, False):
                a = cim_codes(x, w, spec, adc=adc, emit_codes=emit)
                b = cim_codes_plain(x, w, spec, adc=adc, emit_codes=emit)
                torch.cuda.synchronize()
                assert torch.equal(a + 0.0, b + 0.0)
    assert sum(LAUNCHES.values()) == before + 4 * len(cases)


@pytest.mark.cuda
def test_fc_layout_reads_strided_slices():
    """The FC grid hands the kernel column slices of the resident weight
    matrix and row-strided activation slices; no copy, same codes."""
    _needs_card()
    rng = np.random.default_rng(1)
    spec = CIMSpec(n_c=96)
    x, w = _ints(rng, (7, 500)), _ints(rng, (500, 300))
    xs, ws = x[:, 100:400], w[100:400, 40:250]
    assert not xs.is_contiguous() and not ws.is_contiguous()
    a = cim_codes(xs, ws, spec)
    b = cim_codes_plain(xs.contiguous(), ws.contiguous(), spec)
    torch.cuda.synchronize()
    assert torch.equal(a + 0.0, b + 0.0)


ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}


def _normal(rng, shape, dtype):
    return torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).cuda().to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 64, 128, 256])
def test_cuda_local_attention_matches_plain(d, dtype):
    """The bfloat16 (tensor-core) and float32 (CUDA-core) kernels against
    the plain version where the tiling has edges: S not a multiple of the
    64-key tiles or the 128-row blocks (37, 777, 2049), windows that are
    not multiples of a tile (1, 63, 65, 100, 513, S), GQA groups 1, 2, 4
    and 8 over 2 kv heads, soft cap off and 50.0, and the (BH, S, D)
    layout.  Each call launches its dtype's kernel once and the other
    kernel never."""
    _needs_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(d)
    tol = ATTN_TOL[dtype]
    name, other = (("local_attention", "local_attention_f32")
                   if dtype == torch.bfloat16 else
                   ("local_attention_f32", "local_attention"))
    calls = 0
    for s in (37, 777, 2049):
        for group in (1, 2, 4, 8):
            q = _normal(rng, (1, s, 2 * group, d), dtype)
            k, v = (_normal(rng, (1, s, 2, d), dtype) for _ in range(2))
            for window in (1, 63, 65, 100, 513, s):
                for cap in (None, 50.0):
                    before = dict(LA.LAUNCHES)
                    a = LA.grouped_local_attention(q, k, v, window=window,
                                                   softcap=cap)
                    b = LA.grouped_local_attention_plain(
                        q, k, v, window=window, softcap=cap)
                    torch.cuda.synchronize()
                    assert LA.LAUNCHES[name] == before[name] + 1
                    assert LA.LAUNCHES[other] == before[other]
                    torch.testing.assert_close(a.float(), b.float(),
                                               rtol=tol, atol=tol)
                    calls += 1
        q = _normal(rng, (2, s, 4, d), dtype)
        k, v = (_normal(rng, (2, s, 1, d), dtype) for _ in range(2))
        qb = q.permute(0, 2, 1, 3).reshape(8, s, d)
        kb = k.expand(2, s, 4, d).permute(0, 2, 1, 3).reshape(8, s, d)
        vb = v.expand(2, s, 4, d).permute(0, 2, 1, 3).reshape(8, s, d)
        a = LA.local_attention(qb, kb, vb, window=7)
        b = LA.local_attention_plain(qb, kb, vb, window=7)
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)
    assert calls == 3 * 4 * 6 * 2
