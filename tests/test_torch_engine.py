"""Port parity: ``repro_torch/core/engine.py`` against the reference
``CIMEngine`` with the same calibration (copied through ``set_layer``),
with and without a ``VariationModel``.

Tolerance: equal by value.  Handles hold the same integers (the same
float32 weight quantization, the same numpy variation draws), and the
MACs are exact integer dots plus the shared float32 conversion; codes
are integers exact in float64.  The exact engine's float64 products
are held to rtol 1e-12: torch and the reference's padded BLAS reduce in
different orders, and a handful of products over <= 27 terms differ by
a few ulps at most.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import engine as RE  # noqa: E402
from repro.core.cim import CIMSpec as RSpec  # noqa: E402
from repro.core.schedule import compile_conv_block as r_compile  # noqa: E402
from repro.core.variation import VariationModel as RVar  # noqa: E402
from repro_torch.convert import copy_calibration  # noqa: E402
from repro_torch.core import engine as PE  # noqa: E402
from repro_torch.core.cim import CIMSpec  # noqa: E402
from repro_torch.core.schedule import compile_conv_block as p_compile  # noqa: E402
from repro_torch.core.variation import VariationModel  # noqa: E402

#: conv geometries: packed taps, a C > n_c split chain, and a 1x1 layer
GEOMS = [
    dict(h=6, w=6, c_in=3, c_out=20, k=3, stride=1, pad=1, pack=3,
         c_splits=1),
    dict(h=4, w=4, c_in=130, c_out=24, k=3, stride=1, pad=1, pack=1,
         c_splits=2),
    dict(h=5, w=5, c_in=40, c_out=12, k=1, stride=1, pad=0, pack=1,
         c_splits=1),
]
VARIATIONS = [None, dict(conductance_sigma=0.03, stuck_zero=0.005,
                         stuck_one=0.002, adc_offset_sigma=0.5,
                         adc_gain_sigma=0.02, seed=3)]


def _engines(spec: RSpec, variation, name, a_scale=0.05, gain=9.0):
    ref = RE.CIMEngine(spec, variation=None if variation is None
                       else RVar(**variation))
    ref.set_layer(name, a_scale=a_scale, gain=gain)
    port = PE.CIMEngine(CIMSpec(**dataclasses.asdict(spec)), device="cpu",
                        variation=None if variation is None
                        else VariationModel(**variation))
    return ref, copy_calibration(ref, port)


def _adc(h):
    return None if h.adc_inv is None else np.stack([h.adc_inv, h.adc_off], 1)


def test_quantize_weight_matches_reference():
    rng = np.random.default_rng(0)
    for shape in [(3, 3, 17, 40), (300, 11)]:
        w = rng.standard_normal(shape) * rng.random(shape[-1])
        for bits in (8, 4):
            q_ref, s_ref = RE.quantize_weight(w, bits)
            q, s = PE.quantize_weight(torch.from_numpy(w), bits)
            np.testing.assert_array_equal(q.numpy(), q_ref)
            np.testing.assert_array_equal(s.numpy(), s_ref)
            np.testing.assert_array_equal(
                PE.dequantize_weight(q, s).numpy(),
                RE.dequantize_weight(q_ref, s_ref))


@pytest.mark.parametrize("gi", range(len(GEOMS)))
@pytest.mark.parametrize("vi", range(len(VARIATIONS)))
def test_conv_handle_and_tiles_mac(gi, vi):
    g = GEOMS[gi]
    spec = RSpec(n_c=256 if g["c_splits"] == 1 else 96, gain=16.0)
    rsched = r_compile("L", **g, activation="relu")
    psched = p_compile("L", **g, activation="relu")
    ref, port = _engines(spec, VARIATIONS[vi], "L")
    rng = np.random.default_rng(gi * 10 + vi)
    w = rng.standard_normal((g["k"], g["k"], g["c_in"], g["c_out"]))
    prequant = RE.quantize_weight(w)
    rh = ref.conv_handle("L", w, RE.conv_tile_slices(rsched),
                         prequant=prequant)
    ph = port.conv_handle("L", torch.from_numpy(w),
                          PE.conv_tile_slices(psched),
                          prequant=tuple(torch.from_numpy(np.array(a))
                                         for a in prequant))
    assert ph.kc == rh.kc
    np.testing.assert_array_equal(ph.w8_stack.numpy(), rh.w8_stack)
    np.testing.assert_array_equal(ph.deq.numpy(), rh.deq)
    ref_adc = _adc(rh)
    assert (ph.adc is None) == (ref_adc is None)
    if ref_adc is not None:
        np.testing.assert_array_equal(ph.adc.numpy(), ref_adc)
    # the activation quantization and the batch-of-tiles MAC
    x = rng.standard_normal((37, g["c_in"])) * 4
    np.testing.assert_array_equal(
        port.quant_stream(ph, torch.from_numpy(x)).numpy(),
        ref.quant_stream(rh, x))
    patches = rng.integers(-128, 128, rh.w8_stack.shape[:2] + (53,))
    patches = patches.transpose(0, 2, 1).astype(np.int8)  # (T, R, kc)
    got = port.tiles_mac(ph, torch.from_numpy(np.array(patches)))
    want = ref.tiles_mac(rh, patches.astype(rh.w_stack.dtype))
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(port.finalize_conv(ph, got).numpy(),
                                  ref.finalize_conv(rh, want))


@pytest.mark.parametrize("vi", range(len(VARIATIONS)))
@pytest.mark.parametrize("n_c", [96, 256])
def test_fc_handle_and_fc_mac(vi, n_c):
    """FC grid tiles of n_m columns whose n_c-row subarrays split a
    tile's rows raggedly, each converted by its own global ADC."""
    spec = RSpec(n_c=n_c, gain=12.0)
    ref, port = _engines(spec, VARIATIONS[vi], "fc", a_scale=0.02)
    rng = np.random.default_rng(vi + n_c)
    w = rng.standard_normal((300, 40)) / 10
    rh = ref.fc_handle("fc", w)
    ph = port.fc_handle("fc", torch.from_numpy(w))
    np.testing.assert_array_equal(ph.w8.numpy(), rh.w8)
    np.testing.assert_array_equal(ph.deq.numpy(), rh.deq)
    x = rng.standard_normal((5, 300)) * 3
    xr = ref.quant_stream(rh, x)
    xp = port.quant_stream(ph, torch.from_numpy(x))
    np.testing.assert_array_equal(xp.numpy(), xr)
    for k0, k1, n0, n1 in [(0, 256, 0, 32), (256, 300, 0, 32),
                           (0, n_c, 32, 40), (n_c, 300, 32, 40)]:
        want = ref.fc_mac(rh, xr[:, k0:k1], k0, k1, n0, n1, quantized=True)
        got = port.fc_mac(ph, xp[:, k0:k1], k0, k1, n0, n1)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            port.finalize_fc(ph, got, n0, n1).numpy(),
            ref.finalize_fc(rh, want, n0, n1))


def test_exact_engine_matches_reference():
    g = GEOMS[1]
    rsched = r_compile("L", **g, activation="relu")
    psched = p_compile("L", **g, activation="relu")
    rng = np.random.default_rng(4)
    w = rng.standard_normal((3, 3, g["c_in"], g["c_out"]))
    ref, port = RE.ExactEngine(), PE.ExactEngine("cpu")
    rh = ref.conv_handle("L", w, RE.conv_tile_slices(rsched))
    ph = port.conv_handle("L", torch.from_numpy(w),
                          PE.conv_tile_slices(psched))
    taps = [rng.standard_normal((9, tt.c_hi - tt.c_lo))
            for tt in RE.conv_tile_slices(rsched)[:1]]
    np.testing.assert_allclose(
        port.tile_mac(ph, 0, [torch.from_numpy(t) for t in taps]).numpy(),
        ref.tile_mac(rh, 0, taps), rtol=1e-12)
    fw = rng.standard_normal((50, 7))
    x = rng.standard_normal((3, 50))
    np.testing.assert_allclose(
        port.fc_mac(port.fc_handle("f", torch.from_numpy(fw)),
                    torch.from_numpy(x), 0, 50, 0, 7).numpy(),
        ref.fc_mac(ref.fc_handle("f", fw), x, 0, 50, 0, 7), rtol=1e-12)


def test_make_engine_resolves_names_and_devices():
    assert isinstance(PE.make_engine("cim", device="cpu"), PE.CIMEngine)
    assert isinstance(PE.make_engine("pallas", device="cpu"), PE.CIMEngine)
    assert isinstance(PE.make_engine("exact", device="cpu"), PE.ExactEngine)
    eng = PE.CIMEngine(device="cpu")
    assert PE.make_engine(eng, device="cpu") is eng
    with pytest.raises(ValueError):
        PE.make_engine("bogus", device="cpu")
    if not torch.cuda.is_available():
        # no silent CPU fallback: the default device is the card
        with pytest.raises(RuntimeError):
            PE.CIMEngine()
