"""Port parity for the CNN simulator's CIM numerics outside the trace
executor: ``kernels/ops.py::cim_linear`` / ``quantize_weights``,
``kernels/ref.py::cim_matmul_bitplane_ref`` and the CIM mode of
``models/cnn.py::cnn_forward``, against the reference's on the same
numpy inputs.  The reference's ``use_pallas=True`` runs its Pallas
kernel in interpret mode on the CPU; the port's wrapper runs the
kernel's plain version on CPU tensors.

Tolerances, stated per check:

* codes, the bit-plane oracle, quantized weights — equal by value
  (exact integer dots, the same float32 conversion ops);
* ``cnn_forward`` in CIM mode — equal by value: quantization, the exact
  dots and the elementwise float32 dequantization are the same IEEE
  ops, and the im2col is a copy (the ResNet's global average pool reduces in another
  order in torch and XLA; on these inputs it still gives equal logits);
* ``cim_linear`` without an activation or with ReLU — equal by value to
  the reference run op by op (``jax.disable_jit``); with silu, gelu
  (tanh form) or tanh — rtol = atol = 1e-6 of it: torch and XLA
  evaluate the transcendental functions with other approximations (a
  few float32 ulps);
* ``cim_linear`` against the reference as it runs, jitted — rtol = atol
  = 1e-6: XLA reassociates the dequantization multiplies and contracts
  the bias add into a fused multiply-add, so the reference's jitted and
  op-by-op runs differ by a few ulps themselves.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")
jax = pytest.importorskip("jax")

from test_torch_network import _resnet_mini  # noqa: E402
from test_torch_trace_jit import _vgg_mini  # noqa: E402

from repro.configs import cnn as RC  # noqa: E402
from repro.core.cim import CIMSpec as RSpec  # noqa: E402
from repro.kernels import ops as ROPS  # noqa: E402
from repro.kernels import ref as RREF  # noqa: E402
from repro.models.cnn import cnn_forward as r_forward  # noqa: E402
from repro_torch.configs import cnn as PC  # noqa: E402
from repro_torch.core.cim import CIMSpec  # noqa: E402
from repro_torch.kernels import ops as POPS  # noqa: E402
from repro_torch.kernels import ref as PREF  # noqa: E402
from repro_torch.models.cnn import cnn_forward, im2col  # noqa: E402

SPECS = [dict(), dict(n_c=32, gain=5.0), dict(n_c=96, adc_bits=6, gain=7.0)]


def _same(a, b):
    a, b = np.asarray(a) + 0.0, np.asarray(b) + 0.0
    return a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("activation", [None, "relu", "silu", "gelu",
                                        "tanh"])
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("bias", [False, True])
def test_cim_linear_matches_reference(activation, use_pallas, bias):
    rng = np.random.default_rng(7)
    spec = dict(n_c=64, gain=6.0)
    x = rng.standard_normal((2, 5, 150)).astype(np.float32)
    w = (rng.standard_normal((150, 24)) / 12).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32) if bias else None
    rwq, rs = ROPS.quantize_weights(jnp.asarray(w), RSpec(**spec))
    pwq, ps = POPS.quantize_weights(torch.from_numpy(w), CIMSpec(**spec))
    assert _same(pwq.numpy(), rwq) and _same(ps.numpy(), rs)
    assert pwq.stride(0) == 1  # K-major, the kernel's weight layout
    args = (jnp.asarray(x), rwq, rs, None if b is None else jnp.asarray(b),
            RSpec(**spec))
    kw = dict(use_pallas=use_pallas, activation=activation)
    jitted = np.asarray(ROPS.cim_linear(*args, **kw))
    with jax.disable_jit():
        eager = np.asarray(ROPS.cim_linear(*args, **kw))
    got = POPS.cim_linear(
        torch.from_numpy(x), pwq, ps, None if b is None else torch.from_numpy(b),
        CIMSpec(**spec), **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 5, 24)
    if activation in (None, "relu"):
        assert _same(got.numpy(), eager)
    else:
        np.testing.assert_allclose(got.numpy(), eager, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), jitted, rtol=1e-6, atol=1e-6)


def test_cim_linear_returns_input_dtype():
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((3, 40)))
    wq, s = POPS.quantize_weights(torch.from_numpy(
        rng.standard_normal((40, 6)).astype(np.float32)))
    assert POPS.cim_linear(x, wq, s).dtype == torch.float64
    with pytest.raises(KeyError):
        POPS.cim_linear(x, wq, s, activation="bogus")


@pytest.mark.parametrize("spec", SPECS)
def test_bitplane_oracle_matches_reference(spec):
    """The circuit-faithful oracle: equal to the reference's and to the
    functional oracle (``cim_matmul_ref``), ragged K included."""
    rng = np.random.default_rng(len(spec))
    for m, k, n in ((13, 300, 17), (4, 32, 5), (1, 257, 3)):
        xq = rng.integers(-128, 128, (m, k)).astype(np.int8)
        wq = rng.integers(-128, 128, (k, n)).astype(np.int8)
        ref = RREF.cim_matmul_bitplane_ref(jnp.asarray(xq), jnp.asarray(wq),
                                           RSpec(**spec))
        got = PREF.cim_matmul_bitplane_ref(torch.from_numpy(xq),
                                           torch.from_numpy(wq),
                                           CIMSpec(**spec))
        func = PREF.cim_matmul_ref(torch.from_numpy(xq),
                                   torch.from_numpy(wq), CIMSpec(**spec))
        assert got.dtype == torch.float32
        assert _same(got.numpy(), ref)
        assert torch.equal(got + 0.0, func + 0.0)


def test_bitplane_oracle_needs_8_bits():
    x = torch.zeros((2, 8), dtype=torch.int8)
    with pytest.raises(ValueError):
        PREF.cim_matmul_bitplane_ref(x, x.T, CIMSpec(w_bits=6))


@pytest.mark.parametrize("c,k,s,p", [(5, 3, 1, 1), (7, 3, 2, 1), (4, 1, 1, 0),
                                     (2, 5, 2, 2)])
def test_im2col_feature_order_matches_lax_patches(c, k, s, p):
    """The patch features come in (C, K, K) order, as
    ``lax.conv_general_dilated_patches`` emits them: checked where the
    channel count, the kernel size and 1 all differ."""
    from jax import lax

    rng = np.random.default_rng(c * k)
    x = rng.standard_normal((2, 9, 7, c)).astype(np.float32)
    layer = PC.ConvLayer("l", 9, 7, c, 3, k=k, s=s, p=p)
    ref = np.asarray(lax.conv_general_dilated_patches(
        jnp.asarray(x), (k, k), (s, s), padding=[(p, p), (p, p)],
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    got = im2col(torch.from_numpy(x), layer).numpy()
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def _params(cnn, seed):
    rng = np.random.default_rng(seed)
    params = {}
    for l in cnn.layers:
        shape = ((l.k, l.k, l.c, l.m) if isinstance(l, RC.ConvLayer)
                 else (l.c_in, l.c_out))
        params[l.name] = (rng.standard_normal(shape) / np.sqrt(
            np.prod(shape[:-1]))).astype(np.float32)
    x = rng.random((3, cnn.input_hw, cnn.input_hw,
                    cnn.layers[0].c)).astype(np.float32)
    return params, x


@pytest.mark.parametrize("build", [_vgg_mini, _resnet_mini],
                         ids=["vgg-mini", "resnet-mini"])
@pytest.mark.parametrize("spec", SPECS)
def test_cnn_forward_cim_matches_reference(build, spec):
    rcnn, pcnn = build(RC), build(PC)
    params, x = _params(rcnn, 3)
    ref = np.asarray(r_forward({k: jnp.asarray(v) for k, v in params.items()},
                               jnp.asarray(x), rcnn, cim=RSpec(**spec)))
    got = cnn_forward({k: torch.from_numpy(v) for k, v in params.items()},
                      torch.from_numpy(x), pcnn, cim=CIMSpec(**spec))
    assert tuple(got.shape) == (3, pcnn.layers[-1].c_out)
    assert _same(got.numpy(), ref)
    dense = cnn_forward({k: torch.from_numpy(v) for k, v in params.items()},
                        torch.from_numpy(x), pcnn)
    assert not torch.equal(got, dense)


def test_cnn_forward_cim_captures_layer_inputs():
    """``capture`` works in CIM mode too, with the reference's argument
    order (``cim`` before ``capture``)."""
    pcnn = _resnet_mini(PC)
    params, x = _params(_resnet_mini(RC), 4)
    cap = {}
    cnn_forward({k: torch.from_numpy(v) for k, v in params.items()},
                torch.from_numpy(x), pcnn, CIMSpec(), cap)
    assert set(cap) == {l.name for l in pcnn.layers}
