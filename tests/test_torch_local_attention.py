"""Port parity: the sliding-window attention wrapper
(``repro_torch/kernels/local_attention.py``) and its oracle
(``kernels/ref.py::local_attention_ref``) against the JAX reference's
Pallas kernel in interpret mode, as the reference's own tests run it,
and against the reference's oracle and its model-level
``flash_attention``, on the same numpy inputs.

On the CPU the wrapper computes the kernel's plain version
(``grouped_local_attention_plain``); the CUDA kernel itself is held
against that plain version on the card (``tests/test_torch_cuda.py``
and ``chip_smoke.py``).

Tolerance: rtol = atol = 2e-5 against the Pallas kernel and the oracle
(the reference holds its kernel to its oracle at 2e-5), 1e-4 against
``flash_attention`` (the reference's own tolerance there); float32, the
sums taken in other orders.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels.local_attention import (  # noqa: E402
    local_attention as ref_kernel,
)
from repro.kernels.ref import local_attention_ref as ref_oracle  # noqa: E402
from repro.models.common import flash_attention as ref_flash  # noqa: E402
from repro_torch.kernels import local_attention as LA  # noqa: E402
from repro_torch.kernels.ref import local_attention_ref  # noqa: E402
from repro_torch.models.common import flash_attention  # noqa: E402

TOL = 2e-5


def _data(seed, shape, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("s,block", [(37, 16), (64, 32), (64, 16)])
@pytest.mark.parametrize("window", [1, 8, 16, 80])
@pytest.mark.parametrize("softcap", [None, 20.0])
@pytest.mark.parametrize("d", [16, 32])
def test_matches_pallas_kernel_and_oracle(s, block, window, softcap, d):
    """(BH, S, D) layout: ragged S (37), windows from one token to more
    than S, soft cap off and on; the Pallas kernel at two block sizes."""
    q, k, v = _data(s * 100 + window + d, (3, s, d))
    got = LA.local_attention(_t(q), _t(k), _t(v), window=window,
                             softcap=softcap)
    want = ref_kernel(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      window=window, softcap=softcap, block_q=block,
                      block_k=block, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    oracle = ref_oracle(jnp.asarray(q)[None], jnp.asarray(k)[None],
                        jnp.asarray(v)[None], window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle)[0], rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("window", [3, 40])
@pytest.mark.parametrize("softcap", [None, 5.0])
def test_port_oracle_matches_reference_oracle(window, softcap):
    q, k, v = _data(window, (2, 3, 40, 16))
    got = local_attention_ref(_t(q), _t(k), _t(v), window, softcap=softcap)
    want = ref_oracle(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("heads,kv_heads", [(4, 1), (4, 2), (4, 4)])
@pytest.mark.parametrize("window", [8, None])
def test_grouped_layout_matches_reference_flash_attention(heads, kv_heads,
                                                          window):
    """The model's call: q (B, S, H, D) over k, v (B, S, KV, D) read per
    group (no repeat); a global layer (``window=None``) runs the kernel
    with window = S."""
    q = _data(heads, (2, 48, heads, 16), 1)[0]
    k, v = _data(kv_heads + 10, (2, 48, kv_heads, 16), 2)
    got = flash_attention(_t(q), _t(k), _t(v), window=window,
                          logit_softcap=50.0)
    want = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=True, window=window, logit_softcap=50.0,
                     block_q=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_cpu_wrapper_is_the_plain_version_and_counts_nothing():
    q, k, v = (_t(a) for a in _data(0, (2, 20, 16)))
    before = LA.LAUNCHES["local_attention"]
    got = LA.local_attention(q, k, v, window=5)
    assert torch.equal(got, LA.local_attention_plain(q, k, v, window=5))
    assert LA.LAUNCHES["local_attention"] == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "heads", "window",
                                 "softcap", "layout"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    q, k, v = (_t(a) for a in _data(1, (1, 10, 4, 16)))
    kw = {"window": 4, "softcap": None}
    if bad == "dtype":
        q = q.double()
    elif bad == "shape":
        k = k[:, :9]
    elif bad == "heads":
        k, v = k[:, :, :3], v[:, :, :3]
    elif bad == "window":
        kw["window"] = 0
    elif bad == "softcap":
        kw["softcap"] = -1.0
    else:
        q = q[0]
    with pytest.raises((TypeError, ValueError)):
        LA.grouped_local_attention(q, k, v, **kw)
