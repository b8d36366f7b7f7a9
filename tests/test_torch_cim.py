"""Port parity: ``repro_torch/core/cim.py`` against the JAX reference
``repro/core/cim.py`` on the same numpy inputs.

Tolerance: equal by value everywhere.  The integer dots are exact in
both packages (int32 einsum vs float64 products below 2^53), and every
float step is the same IEEE float32 operation in the same order
(int32 -> float32, multiply by the float32 inverse step, round half to
even, clip), so there is nothing to tolerate.  Values, not bytes: the
reference itself disagrees on the sign of zero (ROADMAP fault R1).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import cim as R  # noqa: E402
from repro_torch.core import cim as P  # noqa: E402


def _port_spec(spec):
    return P.CIMSpec(**dataclasses.asdict(spec))


def _specs(n_c):
    return [R.CIMSpec(n_c=n_c, adc_bits=8, gain=7.0),
            R.CIMSpec(n_c=n_c, adc_bits=5, gain=40.0),
            R.lossless_spec(n_c)]


#: (M, K, N, n_c): K % n_c != 0 in every ragged case
SHAPES = [(12, 10, 95, 96), (7, 300, 33, 96), (5, 70, 9, 32),
          (3, 513, 17, 256), (4, 256, 8, 256)]


def _ints(rng, shape):
    return rng.integers(-128, 128, shape).astype(np.int8)


@pytest.mark.parametrize("m,k,n,n_c", SHAPES)
def test_cim_matmul_matches_jnp(m, k, n, n_c):
    rng = np.random.default_rng(m * 1000 + k)
    x, w = _ints(rng, (m, k)), _ints(rng, (k, n))
    for spec in _specs(n_c):
        ref = np.asarray(R.cim_matmul(jnp.asarray(x), jnp.asarray(w), spec))
        got = P.cim_matmul(torch.from_numpy(x), torch.from_numpy(w),
                           _port_spec(spec)).numpy()
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n_c", [32, 96, 256])
def test_adc_quantize_dequantize_match_jnp(n_c):
    rng = np.random.default_rng(n_c)
    for spec in _specs(n_c):
        fs = int(spec.full_scale)
        d = rng.integers(-fs, fs + 1, (64, 33)).astype(np.int32)
        codes = np.array(R.adc_quantize(jnp.asarray(d), spec))
        got = P.adc_quantize(torch.from_numpy(d), _port_spec(spec)).numpy()
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, codes)
        np.testing.assert_array_equal(
            P.adc_dequantize(torch.from_numpy(codes), _port_spec(spec)).numpy(),
            np.asarray(R.adc_dequantize(jnp.asarray(codes), spec)))


@pytest.mark.parametrize("with_offset", [False, True])
def test_adc_convert_matches_numpy(with_offset):
    """The per-subarray conversion with (T,)-broadcast gain and offset,
    the variation flavor's separately rounded multiply then add."""
    rng = np.random.default_rng(3)
    spec = R.CIMSpec(n_c=96, gain=9.0)
    d = rng.integers(-200_000, 200_000, (5, 16, 7)).astype(np.float64)
    inv = (np.float32(spec.adc_inv_step)
           * (1 + 0.02 * rng.standard_normal(5))).astype(np.float32)
    off = (0.5 * rng.standard_normal(5)).astype(np.float32)
    lo, hi = float(-spec.q_max - 1), float(spec.q_max)
    ref = R.adc_convert(d, inv[:, None, None], lo, hi,
                        off[:, None, None] if with_offset else None)
    got = P.adc_convert(torch.from_numpy(d),
                        torch.from_numpy(inv).reshape(-1, 1, 1), lo, hi,
                        torch.from_numpy(off).reshape(-1, 1, 1)
                        if with_offset else None)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("axis", [None, 0])
def test_quantize_symmetric_matches_jnp(axis):
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((33, 17)) * 3).astype(np.float32)
    q_ref, s_ref = R.quantize_symmetric(jnp.asarray(x), 8, axis=axis)
    q, s = P.quantize_symmetric(torch.from_numpy(x), 8, axis=axis)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    np.testing.assert_array_equal(P.dequantize(q, s).numpy(),
                                  np.asarray(R.dequantize(q_ref, s_ref)))


@pytest.mark.parametrize("n_c", [96, 256])
def test_cim_linear_reference_matches_jnp(n_c):
    rng = np.random.default_rng(n_c + 1)
    x = rng.standard_normal((6, 300)).astype(np.float32)
    w = (rng.standard_normal((300, 21)) / 17).astype(np.float32)
    for spec in _specs(n_c):
        ref = np.asarray(R.cim_linear_reference(jnp.asarray(x),
                                                jnp.asarray(w), spec))
        got = P.cim_linear_reference(torch.from_numpy(x), torch.from_numpy(w),
                                     _port_spec(spec)).numpy()
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n_c", [32, 96, 256])
def test_host_helpers_are_copies(n_c):
    """``lossless_spec`` and ``calibrate_gain`` are copied host code: the
    same spec and the same gain from the same inputs."""
    assert dataclasses.asdict(P.lossless_spec(n_c)) == \
        dataclasses.asdict(R.lossless_spec(n_c))
    rng = np.random.default_rng(n_c)
    x = rng.standard_normal((40, 200))
    w = rng.standard_normal((200, 9))
    spec = R.CIMSpec(n_c=n_c)
    for pct in (100.0, 99.0):
        assert P.calibrate_gain(x, w, _port_spec(spec), pct) == \
            R.calibrate_gain(x, w, spec, pct)
