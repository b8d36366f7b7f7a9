"""Port parity: MLA (DeepSeek-V3 latent attention) and the MTP block's
parameters, against the JAX reference at tp = 1, float32, on the CPU.

The config is the reduced deepseek-v3-671b: 2 layers (a dense one, then
an MoE one with a shared expert), 4 heads, q / k 16 + 8 rope dims
against v 16, q and kv latents 32 wide, MTP on.  The reference's params
are drawn with ``jax.random`` (norm scales non-zero) and handed to both
sides as numpy arrays; inputs come from a numpy generator.  On the CPU
the port's prefill attention is the kernel's plain version.

Tolerances: rtol = atol = 1e-4 in float32 (both sides sum in other
orders; the reference's ``flash_attention`` is held to its oracle at
1e-4); 2e-3 for decode over an int8 cache, where a value on a rounding
edge can flip one int8 code, as ``test_torch_lm.py`` allows.  Int8 cache
codes may differ by one, in at most 5% of the codes.  Converted weights
are compared bit for bit.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import attention as RA  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.models.common import ShardingPlan as RefPlan  # noqa: E402
from repro.models.common import flash_attention as ref_flash  # noqa: E402
from repro.runtime.serve_loop import (  # noqa: E402
    quantize_decisions as ref_decisions,
)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.kernels import local_attention as LA  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.common import ShardingPlan  # noqa: E402
from repro_torch.runtime.serve_loop import quantize_decisions  # noqa: E402

ARCH = "deepseek-v3-671b"
B, S, STEPS = 2, 12, 4
TOL = 1e-4
TOL_INT8_KV = 2e-3


def _configs():
    return ref_config(ARCH).reduced(), get_config(ARCH).reduced()


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


def _codes_close(got, want, what):
    """int8 codes: at most one apart, in at most 5% of them."""
    diff = (got.int() - _t(want).int()).abs()
    assert int(diff.max()) <= 1, what
    assert int((diff > 0).sum()) <= max(1, diff.numel() // 20), what


def _mla_params(rcfg, seed):
    """The reference's MLA params of one layer as numpy, norms non-zero."""
    p = RA.init_mla(jax.random.PRNGKey(seed), rcfg,
                    RefPlan.for_model(rcfg, tp=1), jnp.float32)
    rng = np.random.default_rng(seed)
    return {k: ((0.1 * rng.standard_normal(v.shape)).astype(np.float32)
                if "norm" in k else np.asarray(v)) for k, v in p.items()}


def _compare_cache(got, want, kv_dtype, tol, what):
    assert set(got) == set(want), what
    for name in want:
        if kv_dtype == "int8" and name == "c":
            _codes_close(got[name], want[name], f"{what} {name}")
        else:
            _close(got[name], want[name], tol, f"{what} {name}")


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_mla_forward_matches_reference(kv_dtype):
    """The prefill: output (B, S, D) and the cache payload [c ‖ k_rope]
    (int8 codes and a scale per position in the int8 flavor)."""
    rcfg, pcfg = _configs()
    p = _mla_params(rcfg, 0)
    x = np.random.default_rng(1).standard_normal(
        (B, S, rcfg.d_model)).astype(np.float32)
    want, want_cache = RA.mla_forward(
        p, jnp.asarray(x), rcfg, 0, RefPlan.for_model(rcfg, tp=1),
        jnp.arange(S), want_cache=True, kv_dtype=kv_dtype)
    got, cache = A.mla_forward({k: _t(v) for k, v in p.items()}, _t(x), pcfg,
                               0, ShardingPlan(), torch.arange(S),
                               want_cache=True, kv_dtype=kv_dtype)
    assert got.shape == (B, S, pcfg.d_model)
    _close(got, want, TOL, "mla_forward output")
    a = pcfg.attention
    assert cache["c"].shape == (B, S, a.kv_lora_rank + a.qk_rope_head_dim)
    _compare_cache(cache, jax.tree.map(np.asarray, want_cache), kv_dtype,
                   TOL, "prefill cache")


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_mla_decode_matches_reference_over_steps(kv_dtype):
    """The absorbed decode, STEPS tokens after an S-token prefill, both
    sides starting from the reference's prefill cache grown to s_max;
    the cache is written in place at each position."""
    rcfg, pcfg = _configs()
    rplan = RefPlan.for_model(rcfg, tp=1)
    p = _mla_params(rcfg, 2)
    tp = {k: _t(v) for k, v in p.items()}
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, S, rcfg.d_model)).astype(np.float32)
    _, cache = RA.mla_forward(p, jnp.asarray(x), rcfg, 0, rplan,
                              jnp.arange(S), want_cache=True,
                              kv_dtype=kv_dtype)
    ref_cache = {k: jnp.pad(v, ((0, 0), (0, STEPS), (0, 0)))
                 for k, v in cache.items()}
    port_cache = {k: _t(v) for k, v in ref_cache.items()}
    tol = TOL_INT8_KV if kv_dtype == "int8" else TOL
    for i in range(STEPS):
        xi = rng.standard_normal((B, 1, rcfg.d_model)).astype(np.float32)
        want, ref_cache = RA.mla_decode(p, jnp.asarray(xi), ref_cache, S + i,
                                        rcfg, 0, rplan, kv_dtype=kv_dtype)
        got, port_cache = A.mla_decode(tp, _t(xi), port_cache, S + i, pcfg,
                                       0, ShardingPlan(), kv_dtype=kv_dtype)
        _close(got, want, tol, f"decode output at {S + i}")
        _compare_cache(port_cache, jax.tree.map(np.asarray, ref_cache),
                       kv_dtype, TOL, f"cache after position {S + i}")


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_mla_cache_shape_matches_reference(kv_dtype):
    rcfg, pcfg = _configs()
    want = RA.mla_cache_shape(rcfg, RefPlan.for_model(rcfg, tp=1), B, 40,
                              kv_dtype)
    got = A.mla_cache_shape(pcfg, ShardingPlan(), B, 40, kv_dtype)
    assert set(got) == set(want)
    for name, (shape, dt) in want.items():
        assert got[name][0] == tuple(shape), name
        assert str(got[name][1]) == f"torch.{jnp.dtype(dt).name}", name
    caches = T.init_cache(pcfg, ShardingPlan(), B, 40, kv_dtype, device="cpu")
    assert all(c.keys() == got.keys() for c in caches)


@pytest.mark.parametrize("dqk,dv,heads,kv_heads", [
    (24, 16, 2, 2), (24, 16, 2, 1), (192, 128, 2, 2)])
@pytest.mark.parametrize("window", [None, 5])
def test_plain_attention_with_its_own_v_head_dim(dqk, dv, heads, kv_heads,
                                                 window):
    """q and k at DQK, v at DV: the wrapper (its plain version on the CPU)
    against the reference's ``flash_attention`` (scale DQK^-0.5, output
    DV wide), at the reduced config's (24, 16) and deepseek-v3's
    (192, 128)."""
    rng = np.random.default_rng(dqk + dv + heads + kv_heads)
    s = 37
    q = rng.standard_normal((1, s, heads, dqk)).astype(np.float32)
    k = rng.standard_normal((1, s, kv_heads, dqk)).astype(np.float32)
    v = rng.standard_normal((1, s, kv_heads, dv)).astype(np.float32)
    got = LA.grouped_local_attention(_t(q), _t(k), _t(v),
                                     window=s if window is None else window)
    want = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=True, window=window, block_q=16)
    assert got.shape == (1, s, heads, dv)
    _close(got, want, TOL)


def test_only_v_may_have_its_own_head_dim():
    q = torch.zeros((1, 8, 2, 24))
    with pytest.raises(ValueError):
        LA.grouped_local_attention(q, torch.zeros((1, 8, 2, 16)),
                                   torch.zeros((1, 8, 2, 16)), window=4)
    with pytest.raises(ValueError):  # k and v on other heads
        LA.grouped_local_attention(q, q, torch.zeros((1, 8, 1, 16)),
                                   window=4)


def test_operations_count_each_product_at_its_head_dim():
    """Q K^T runs at DQK, P V at DV: 2 (DQK + DV) per pair where both
    products run; ``operations(d)`` is ``operations(d, d)``."""
    sched = LA.tile_schedule(2048, 2048)
    assert sched.operations(192, 128) == 2 * (192 * sched.s_pairs
                                              + 128 * sched.pv_pairs)
    assert sched.operations(256) == sched.operations(256, 256)
    # deepseek-v3's prefill call: 640 operations per unmasked pair, and
    # the kernel computes at most a tile's worth more on the diagonal
    assert sched.unmasked_pairs == 2048 * 2049 // 2
    assert 1.0 < sched.operations(192, 128) / (
        640 * sched.unmasked_pairs) < 1.1


def test_init_params_match_reference_tree():
    """The port's init has the reference's leaves (``mtp`` included),
    shapes and dtypes, once the reference's segments are un-stacked."""
    rcfg, pcfg = _configs()
    ref = jax.tree.map(np.asarray, RT.init_params(
        jax.random.PRNGKey(0), rcfg, RefPlan.for_model(rcfg, tp=1),
        dtype=jnp.float32))
    want = lm_params_from_reference(ref, pcfg, device="cpu")
    got = T.init_params(pcfg, ShardingPlan(), torch.Generator().manual_seed(0),
                        dtype=torch.float32)

    def shapes(tree, path=""):
        if isinstance(tree, dict):
            return {k2: v2 for k, v in tree.items()
                    for k2, v2 in shapes(v, f"{path}/{k}").items()}
        if isinstance(tree, list):
            return {k2: v2 for i, v in enumerate(tree)
                    for k2, v2 in shapes(v, f"{path}/{i}").items()}
        return {path: (tuple(tree.shape), tree.dtype)}

    assert "mtp" in got and set(got["mtp"]) == {"layer", "proj"}
    assert shapes(got) == shapes(want)
    assert set(got["layers"][0]["attn"]) == {
        "w_dq", "q_norm", "w_uq", "w_dkv", "kv_norm", "w_uk", "w_uv", "wo"}


def test_mtp_params_convert_bit_for_bit():
    """The reference's ``mtp`` block (its layer and ``proj``; bfloat16,
    the router float32) arrives with the same dtypes and bits."""
    rcfg, pcfg = _configs()
    ref = jax.tree.map(np.asarray, RT.init_params(
        jax.random.PRNGKey(4), rcfg, RefPlan.for_model(rcfg, tp=1)))
    got = lm_params_from_reference(ref, pcfg, device="cpu")
    leaves = jax.tree_util.tree_flatten_with_path(ref["mtp"])[0]
    assert len(leaves) > 10
    for path, want in leaves:
        have = got["mtp"]
        for key in path:
            have = have[key.key]
        assert str(have.dtype) == f"torch.{want.dtype.name}", path
        assert torch.equal(have.contiguous().view(torch.uint8),
                           torch.from_numpy(want.view(np.uint8).copy())), path
    assert got["mtp"]["proj"].dtype == torch.bfloat16


@pytest.mark.parametrize("min_size", [1, 1 << 14])
def test_quantize_decisions_match_reference(min_size):
    """Which leaves get int8 residency: the MLA projections, the MoE's
    and the MTP block's (``mtp/proj`` among them) as the reference
    decides, leaf by leaf."""
    rcfg, pcfg = _configs()
    ref = jax.tree.map(np.asarray, RT.init_params(
        jax.random.PRNGKey(5), rcfg, RefPlan.for_model(rcfg, tp=1),
        dtype=jnp.float32))
    want = {}
    for name, v in ref_decisions(ref, min_size).items():
        name = re.sub(r"[\[\]']", "", name)
        # each reduced segment is one unstacked layer: segments/l/0 -> l
        want[re.sub(r"^segments/(\d+)/0/", r"layers/\1/", name)] = v
    got = quantize_decisions(lm_params_from_reference(ref, pcfg,
                                                      device="cpu"),
                             pcfg, min_size)
    assert got == want
    # (2 D, D) = 8192 elements and (kv_lora, H nope) = 2048 at this size
    assert got["mtp/proj"] is got["layers/0/attn/w_uk"] is (min_size == 1)
    assert got["head"]
    assert not got["layers/0/attn/kv_norm"]


def test_prefill_then_decode_equals_longer_prefill():
    """Greedy decode after prefill(S) gives prefill(S + 1)'s last logits,
    as ``tests/test_models.py`` holds the reference: the absorbed decode
    against the latent cache reproduces the kernel path."""
    _, pcfg = _configs()
    plan = ShardingPlan()
    params = T.init_params(pcfg, plan, torch.Generator().manual_seed(6),
                           dtype=torch.float32)
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, pcfg.vocab_size, (B, S + 1)))
    logits_a, caches = T.prefill(params, tokens[:, :S], pcfg, plan,
                                 s_max=S + 4)
    assert caches[0]["c"].shape[1] == S + 4
    logits_b, _ = T.decode_step(params, tokens[:, S], caches, S, pcfg, plan)
    logits_full, _ = T.prefill(params, tokens, pcfg, plan)
    _close(logits_b, logits_full.numpy(), TOL)
