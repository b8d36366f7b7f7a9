"""Port parity: the CIM kernel wrapper (``repro_torch/kernels/cim_matmul.py``)
and its oracles (``kernels/ref.py``) against the JAX reference's Pallas
kernel, run in interpret mode as the reference's own tests run it.

On the CPU the wrapper computes the kernel's plain PyTorch version
(``cim_codes_plain``); the CUDA kernel itself is checked against that
plain version on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``).

Tolerance: equal by value.  Both sides take exact integer subarray dots
and the same float32 conversion ops; code sums are integers exact in
float32 below 2^24 (the wrapper refuses shapes that could pass it).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core.cim import CIMSpec as RSpec  # noqa: E402
from repro.kernels import ref as RREF  # noqa: E402
from repro.kernels.cim_matmul import (  # noqa: E402
    cim_chain_codes_pallas,
    cim_matmul_pallas,
)
from repro_torch.core.cim import CIMSpec  # noqa: E402
from repro_torch.kernels import ref as PREF  # noqa: E402
from repro_torch.kernels.cim_matmul import (  # noqa: E402
    cim_codes,
    cim_codes_plain,
)

N_CS = [32, 96, 256]


def _ints(rng, shape):
    return rng.integers(-128, 128, shape).astype(np.int8)


def _table(rng, n, spec):
    inv = np.float32(spec.adc_inv_step) * (1 + 0.02 * rng.standard_normal(n))
    off = 0.5 * rng.standard_normal(n)
    return np.stack([inv, off], axis=1).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("n_c", N_CS)
@pytest.mark.parametrize("variation", [False, True])
@pytest.mark.parametrize("emit_codes", [True, False])
def test_fc_layout_matches_pallas(n_c, variation, emit_codes):
    """(R, K) x (K, N) with a ragged last subarray (K % n_c != 0)."""
    rng = np.random.default_rng(n_c + 7 * variation + 3 * emit_codes)
    k = 2 * n_c + 7
    x, w = _ints(rng, (13, k)), _ints(rng, (k, 77))
    rspec = RSpec(n_c=n_c, gain=7.0)
    spec = CIMSpec(**dataclasses.asdict(rspec))
    adc = _table(rng, 3, rspec) if variation else None
    ref = np.asarray(cim_matmul_pallas(
        jnp.asarray(x), jnp.asarray(w), rspec, interpret=True,
        emit_codes=emit_codes,
        adc_var=None if adc is None else jnp.asarray(adc)))
    got = cim_codes(_t(x), _t(w), spec,
                    adc=None if adc is None else _t(adc),
                    emit_codes=emit_codes)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("n_c", N_CS)
@pytest.mark.parametrize("variation", [False, True])
def test_chain_layout_matches_pallas_chain_codes(n_c, variation):
    """(T, R, kc) patches x (T, kc, N) stacked tile weights against the
    reference's multi-tile layout: each tile's kc columns in its own
    n_c-wide K block, weights zero-padded past kc."""
    rng = np.random.default_rng(100 + n_c + variation)
    t, r, kc, n = 4, 11, n_c - 5, 70
    x3, w3 = _ints(rng, (t, r, kc)), _ints(rng, (t, kc, n))
    xq = np.zeros((r, t * n_c), np.int8)
    wq = np.zeros((t * n_c, n), np.int8)
    for i in range(t):
        xq[:, i * n_c:i * n_c + kc] = x3[i]
        wq[i * n_c:i * n_c + kc] = w3[i]
    rspec = RSpec(n_c=n_c, gain=5.0)
    spec = CIMSpec(**dataclasses.asdict(rspec))
    adc = _table(rng, t, rspec) if variation else None
    ref = np.asarray(cim_chain_codes_pallas(jnp.asarray(xq), jnp.asarray(wq),
                                            rspec, interpret=True,
                                            adc_var=adc))
    got = cim_codes(_t(x3), _t(w3), spec, adc=None if adc is None else _t(adc))
    np.testing.assert_array_equal(got.numpy(), ref)
    # and the same steps through the 2-D layout give the same sums
    if kc == n_c:
        np.testing.assert_array_equal(
            cim_codes(_t(xq), _t(wq), spec).numpy(),
            cim_codes(_t(x3), _t(w3), spec).numpy())


def test_wrapper_dispatches_cpu_to_plain_and_checks_inputs():
    rng = np.random.default_rng(1)
    spec = CIMSpec(n_c=32)
    x, w = _t(_ints(rng, (3, 9, 30))), _t(_ints(rng, (3, 30, 5)))
    assert torch.equal(cim_codes(x, w, spec), cim_codes_plain(x, w, spec))
    with pytest.raises(TypeError):
        cim_codes(x.to(torch.int32), w, spec)
    with pytest.raises(ValueError):  # step deeper than one subarray
        cim_codes(_t(_ints(rng, (3, 9, 40))), _t(_ints(rng, (3, 40, 5))),
                  spec)
    with pytest.raises(ValueError):  # ADC table of the wrong length
        cim_codes(x, w, spec, adc=torch.ones((2, 2), dtype=torch.float32))
    with pytest.raises(ValueError):  # code sums could leave f32's exact range
        cim_codes(x, w, CIMSpec(n_c=32, adc_bits=24))


@pytest.mark.parametrize("layout", ["3d", "2d"])
def test_code_sum_guard_boundary(layout):
    """``T * (q_max + 1) <= 2^24`` holds the float32 code sum exact:
    16-bit codes over 512 steps reach 2^24 and run; 513 steps raise."""
    spec = CIMSpec(n_c=32, adc_bits=16)
    for t, ok in ((512, True), (513, False)):
        if layout == "3d":
            x = torch.ones((t, 2, 1), dtype=torch.int8)
            w = torch.ones((t, 1, 3), dtype=torch.int8)
        else:
            x = torch.ones((2, t * 32), dtype=torch.int8)
            w = torch.ones((t * 32, 3), dtype=torch.int8)
        if ok:
            assert cim_codes(x, w, spec).shape == (2, 3)
        else:
            with pytest.raises(ValueError, match="2\\^24"):
                cim_codes(x, w, spec)


def test_plain_dots_do_not_wrap():
    """int8 x int8 at the extremes: an int8 ``torch.matmul`` would wrap;
    the plain version's float64 dots are exact (lossless spec: codes ARE
    the dots)."""
    from repro_torch.core.cim import lossless_spec

    spec = lossless_spec(32)
    x = torch.full((2, 32), -128, dtype=torch.int8)
    w = torch.full((32, 3), 127, dtype=torch.int8)
    got = cim_codes(x, w, spec)
    assert torch.all(got == float(-32 * 128 * 127))


@pytest.mark.parametrize("n_c", N_CS)
def test_ref_oracles_match_reference(n_c):
    rng = np.random.default_rng(n_c + 11)
    x, w = _ints(rng, (9, 3 * n_c - 4)), _ints(rng, (3 * n_c - 4, 21))
    rspec = RSpec(n_c=n_c, gain=6.0)
    spec = CIMSpec(**dataclasses.asdict(rspec))
    np.testing.assert_array_equal(
        PREF.cim_matmul_ref(_t(x), _t(w), spec).numpy(),
        np.asarray(RREF.cim_matmul_ref(jnp.asarray(x), jnp.asarray(w),
                                       rspec)))
    np.testing.assert_array_equal(
        PREF.int8_matmul_exact_ref(_t(x), _t(w)).numpy(),
        np.asarray(RREF.int8_matmul_exact_ref(jnp.asarray(x),
                                              jnp.asarray(w))))
    # the wrapper's 2-D layout is the oracle's function
    np.testing.assert_array_equal(
        cim_codes(_t(x), _t(w), spec, emit_codes=False).numpy(),
        PREF.cim_matmul_ref(_t(x), _t(w), spec).numpy())
