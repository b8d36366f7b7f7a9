"""Card-only checks of the port (marker ``cuda``): they skip without an
NVIDIA card, and import no ``jax`` so that they run on the card's
machine (``pytest -m cuda tests/test_torch_*.py``).

Tolerance: equal by value — the kernel and its plain version compute the
same exact integer dots and the same float32 conversion ops.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.cim import CIMSpec  # noqa: E402
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
