"""Port parity: the encoder-decoder (seamless-m4t-large-v2's backbone)
against the JAX reference's ``models/encdec.py`` at tp = 1, float32, on
the CPU.

The config is the reduced seamless-m4t-large-v2: 2 encoder and 2
decoder layers of d_model 64, 4 heads of 16 on 4 kv heads, a gated gelu
MLP of 128, a tied vocabulary of 256, frames 32 wide.  The reference's
params are drawn with ``jax.random`` (norm scales non-zero) and handed
to both sides as numpy arrays through ``convert``; frames and prompts
come from a numpy generator.  The frames (9) are fewer than the prompt's
tokens (12): the memory's length is its own.  On the CPU the decoder's
causal self-attention is the kernel's plain version; the encoder's
self-attention and cross-attention are the port's plain bidirectional
blocks on every device.

Tolerances: logits and float caches rtol = atol = 1e-4 in float32 (both
sides sum in other orders); 2e-3 for decode logits over the int8 cache,
where a value on a rounding edge can flip one int8 code, as
``test_torch_lm.py`` states.  Int8 cache codes may differ by one, in at
most 5% of a layer's codes.  Tokens must be equal; quantized weights
equal by value.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import encdec as RED  # noqa: E402
from repro.models.common import ShardingPlan as RefPlan  # noqa: E402
from repro.models.common import flash_attention as ref_flash  # noqa: E402
from repro.runtime.serve_loop import (  # noqa: E402
    quantize_params_for_serving as ref_quantize,
)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    encdec_caches_from_reference,
    encdec_params_from_reference,
)
from repro_torch.models import encdec as ED  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.common import (  # noqa: E402
    ShardingPlan,
    flash_attention,
)
from repro_torch.runtime.serve_loop import (  # noqa: E402
    build_serve_program,
    greedy_generate,
    quantize_decisions,
    quantize_params_for_serving,
)

ARCH = "seamless-m4t-large-v2"
B, PROMPT, FRAMES, STEPS = 2, 12, 9, 6
S_MAX = PROMPT + STEPS + 1
TOL = 1e-4
TOL_INT8_KV = 2e-3


def _configs():
    return ref_config(ARCH).reduced(), get_config(ARCH).reduced()


def _ref_params(rcfg, seed, dtype=jnp.float32):
    """Reference params as numpy, norm scales non-zero."""
    params = RED.init_params(jax.random.PRNGKey(seed), rcfg,
                             RefPlan.for_model(rcfg, tp=1), dtype=dtype)
    rng = np.random.default_rng(seed)

    def one(path, leaf):
        a = np.asarray(leaf)
        if "norm" in str(path[-1]):
            a = (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(one, params)


def _inputs(rcfg, seed, frames_dtype=np.float32):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, rcfg.vocab_size, (B, PROMPT)).astype(np.int32)
    frames = rng.standard_normal(
        (B, FRAMES, rcfg.frontend.embed_dim)).astype(frames_dtype)
    return tokens, frames


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


def _compare_cache_list(port, ref, what):
    assert len(port) == len(ref)
    for l, (pc, rc) in enumerate(zip(port, ref)):
        assert pc.keys() == rc.keys(), (what, l)
        for name in pc:
            a, b = pc[name], rc[name]
            assert a.shape == b.shape and a.dtype == b.dtype, (what, l, name)
            if a.dtype == torch.int8:
                diff = (a.int() - b.int()).abs()
                assert int(diff.max()) <= 1, (what, l, name)
                assert int((diff > 0).sum()) <= max(1, a.numel() // 20), (
                    f"{what}: layer {l} {name}: {int((diff > 0).sum())} of "
                    f"{a.numel()} int8 codes differ")
            else:
                _close(a, b.numpy(), TOL, f"{what}: layer {l} {name}")


def _compare_caches(port, ref_np, pcfg, what):
    ref = encdec_caches_from_reference(ref_np, pcfg, device="cpu")
    for part, (p, r) in zip(("self", "cross"), zip(port, ref)):
        assert len(p) == pcfg.num_layers
        _compare_cache_list(p, r, f"{what}, {part}")


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("cim_weights", [False, True])
def test_prefill_and_greedy_decode_match_reference(kv_dtype, cim_weights):
    """Prefill logits and both caches, every decode step's logits and
    the greedy tokens through ``build_serve_program`` /
    ``greedy_generate``; with CIM weights both sides quantize at
    ``min_size = 1`` (every matmul weight, the cross projections and
    ``frontend_proj`` among them)."""
    rcfg, pcfg = _configs()
    rplan = RefPlan.for_model(rcfg, tp=1)
    params = _ref_params(rcfg, 1)
    if cim_weights:
        params = jax.tree.map(np.asarray, ref_quantize(params, 1))
    tokens, frames = _inputs(rcfg, 2)

    r_prefill = jax.jit(functools.partial(
        RED.prefill, cfg=rcfg, plan=rplan, kv_dtype=kv_dtype, s_max=S_MAX))
    r_decode = jax.jit(functools.partial(
        RED.decode_step, cfg=rcfg, plan=rplan, kv_dtype=kv_dtype))
    r_logits, r_caches = r_prefill(params, {"tokens": jnp.asarray(tokens),
                                            "frames": jnp.asarray(frames)})
    ref_logits = [np.asarray(r_logits)]

    prog = build_serve_program(pcfg, batch=B, s_max=S_MAX, kv_dtype=kv_dtype,
                               cim_weights=cim_weights, quant_min_size=1,
                               device="cpu")
    pparams = encdec_params_from_reference(params, pcfg, device="cpu")
    batch = {"tokens": _t(tokens), "frames": _t(frames)}
    p_logits, p_caches = prog.prefill_fn(pparams, batch)
    _close(p_logits, r_logits, TOL, "prefill logits")
    _compare_caches(p_caches, jax.tree.map(np.asarray, r_caches), pcfg,
                    "prefill caches")
    # the cross cache keeps the memory's dtype, never int8
    assert all(c["k"].dtype == torch.float32 for c in p_caches[1])

    dec_tol = TOL_INT8_KV if kv_dtype == "int8" else TOL
    r_token = jnp.argmax(r_logits, axis=-1).astype(jnp.int32)
    ref_tokens = [np.asarray(r_token)]
    for i in range(STEPS - 1):
        pos = PROMPT + i
        p_logits, p_caches = prog.decode_fn(pparams, _t(r_token), p_caches,
                                            pos)
        r_logits, r_caches = r_decode(params, r_token, r_caches,
                                      jnp.int32(pos))
        _close(p_logits, r_logits, dec_tol, f"decode logits at {pos}")
        r_token = jnp.argmax(r_logits, axis=-1).astype(jnp.int32)
        assert torch.equal(torch.argmax(p_logits, -1).int(), _t(r_token)), pos
        ref_tokens.append(np.asarray(r_token))
        ref_logits.append(np.asarray(r_logits))
    _compare_caches(p_caches, jax.tree.map(np.asarray, r_caches), pcfg,
                    "caches after decoding")

    seen = []
    got = greedy_generate(prog, pparams, batch, STEPS,
                          on_logits=lambda i, lg: seen.append(lg.clone()))
    assert torch.equal(got, _t(np.stack(ref_tokens, axis=1)))
    for i, lg in enumerate(seen):
        _close(lg, ref_logits[i], TOL if i == 0 else dec_tol,
               f"greedy_generate logits at step {i}")


@pytest.mark.parametrize("s,t,heads,kv_heads,cap,q_dtype", [
    (37, 37, 4, 4, None, "float32"),      # the encoder: S = T, group 1
    (600, 600, 4, 2, None, "float32"),    # two 512-row blocks, group 2
    (1100, 513, 8, 2, None, "float32"),   # three blocks over T keys
    (37, 53, 4, 1, 5.0, "float32"),       # cross: S != T, group 4, cap
    (37, 53, 4, 4, None, "bfloat16"),     # a bf16 stream, f32 memory
    (1, 9, 4, 2, None, "float32"),        # one query row
])
def test_bidirectional_attention_matches_reference(s, t, heads, kv_heads,
                                                   cap, q_dtype):
    """``flash_attention(causal=False)`` against the reference's at S
    not a multiple of its 512-row blocks, GQA groups 1 to 4, the soft
    cap, and q in bfloat16 against float32 k / v (the promotion of a
    bfloat16 decoder stream attending to a float32 memory)."""
    rng = np.random.default_rng(s + t + heads + kv_heads)
    q = rng.standard_normal((2, s, heads, 16)).astype(np.float32)
    k = rng.standard_normal((2, t, kv_heads, 16)).astype(np.float32)
    v = rng.standard_normal((2, t, kv_heads, 16)).astype(np.float32)
    rq = jnp.asarray(q).astype(q_dtype)
    want = ref_flash(rq, jnp.asarray(k), jnp.asarray(v), causal=False,
                     logit_softcap=cap)
    pq = _t(q).to(getattr(torch, q_dtype))
    got = flash_attention(pq, _t(k), _t(v), causal=False, logit_softcap=cap)
    assert got.shape == (2, s, heads, 16)
    assert str(got.dtype) == f"torch.{want.dtype}"
    _close(got, want, TOL)


def test_bidirectional_attention_refuses_a_window():
    q = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, q, q, causal=False, window=4)


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_init_cache_matches_reference(kv_dtype):
    """Zero (self, cross) caches with the reference's declared shapes and
    dtypes: the cross cache in bfloat16 whatever the kv dtype."""
    rcfg, pcfg = _configs()
    ref = jax.tree.map(np.asarray, RED.init_cache(
        rcfg, RefPlan.for_model(rcfg, tp=1), B, S_MAX, FRAMES, kv_dtype))
    want = encdec_caches_from_reference(ref, pcfg, device="cpu")
    got = ED.init_cache(pcfg, ShardingPlan(), B, S_MAX, FRAMES, kv_dtype,
                        device="cpu")
    for g_list, w_list in zip(got, want):
        assert len(g_list) == len(w_list) == pcfg.num_layers
        for g, w in zip(g_list, w_list):
            assert g.keys() == w.keys()
            for name in g:
                assert g[name].shape == w[name].shape, name
                assert g[name].dtype == w[name].dtype, name
                assert not g[name].any()
    assert got[1][0]["k"].dtype == torch.bfloat16


@pytest.mark.parametrize("min_size,n_want", [(1, 19), (1 << 14, 6)])
def test_quantized_weights_equal_reference(min_size, n_want):
    """The same leaves quantized to the same codes and scales as the
    reference's, whose size floor counts each stack's leaves
    ``encoder_layers`` or ``num_layers`` times: at ``1 << 14`` the
    reduced model quantizes only its MLP weights (2 x 64 x 128 per
    stacked leaf), not its attention ones (2 x 64 x 64)."""
    rcfg, pcfg = _configs()
    params = _ref_params(rcfg, 0)
    want = encdec_params_from_reference(
        jax.tree.map(np.asarray, ref_quantize(params, min_size)), pcfg,
        device="cpu")
    port = encdec_params_from_reference(params, pcfg, device="cpu")
    got = quantize_params_for_serving(port, pcfg, min_size)
    decided = quantize_decisions(port, pcfg, min_size)
    n_quantized = 0

    def walk(g, w, path):
        nonlocal n_quantized
        if isinstance(w, dict) and "q" in w:
            assert isinstance(g, dict) and "q" in g, f"{path}: not quantized"
            assert decided[path], path
            n_quantized += 1
            assert bool((g["q"] == w["q"]).all()), path
            assert torch.equal(g["s"], w["s"]), path
        elif isinstance(w, dict):
            assert set(g) == set(w), path
            for k in w:
                walk(g[k], w[k], f"{path}/{k}" if path else k)
        elif isinstance(w, list):
            for i, (a, b) in enumerate(zip(g, w)):
                walk(a, b, f"{path}/{i}")
        else:
            assert not isinstance(g, dict), f"{path}: quantized, ref is not"
            assert torch.equal(g, w), path

    walk(got, want, "")
    assert n_quantized == sum(decided.values())
    # the reference's stacked leaves: the top level and each stack's
    # first layer
    n_stacked = sum(v for path, v in decided.items()
                    if path.split("/")[0] not in ("encoder", "decoder")
                    or path.split("/")[1] == "0")
    assert n_stacked == n_want


def test_bf16_params_with_f32_frames_raise_as_the_reference():
    """With bfloat16 params, float32 frames make a float32 memory that
    turns the decoder stream float32 at the first cross-attention: the
    reference's layer scan refuses it, and the port raises a
    ``ValueError`` naming both dtypes.  bfloat16 frames run on both."""
    rcfg, pcfg = _configs()
    rplan = RefPlan.for_model(rcfg, tp=1)
    params = _ref_params(rcfg, 3, dtype=jnp.bfloat16)
    tokens, frames = _inputs(rcfg, 4)
    with pytest.raises(Exception, match="float32"):
        RED.prefill(params, {"tokens": jnp.asarray(tokens),
                             "frames": jnp.asarray(frames)}, rcfg, rplan)
    prog = build_serve_program(pcfg, batch=B, s_max=S_MAX, device="cpu")
    pparams = encdec_params_from_reference(params, pcfg, device="cpu")
    with pytest.raises(ValueError, match="bfloat16.*float32"):
        prog.prefill_fn(pparams, {"tokens": _t(tokens), "frames": _t(frames)})
    logits, (self_c, cross_c) = prog.prefill_fn(
        pparams, {"tokens": _t(tokens),
                  "frames": _t(frames).to(torch.bfloat16)})
    assert bool(torch.isfinite(logits).all())
    assert self_c[0]["k"].dtype == cross_c[0]["k"].dtype == torch.bfloat16


def test_serving_checks_the_frames():
    _, pcfg = _configs()
    prog = build_serve_program(pcfg, batch=B, s_max=S_MAX, device="cpu")
    params = prog.init_params(torch.Generator().manual_seed(0),
                              torch.float32)
    tokens = torch.zeros((B, PROMPT), dtype=torch.int64)
    with pytest.raises(ValueError, match="needs frames"):
        prog.prefill_fn(params, {"tokens": tokens})
    with pytest.raises(ValueError, match="frames"):
        prog.prefill_fn(params, {"tokens": tokens,
                                 "frames": torch.zeros((B, FRAMES, 7))})
    with pytest.raises(ValueError, match="patch_embeds"):
        prog.prefill_fn(params, {"tokens": tokens,
                                 "frames": torch.zeros((B, FRAMES, 32)),
                                 "patch_embeds": torch.zeros((B, 4, 32))})
    assert set(params) == {"embed", "frontend_proj", "enc_norm", "dec_norm",
                           "encoder", "decoder"}
    assert len(params["encoder"]) == pcfg.encoder_layers
    assert set(params["decoder"][0]) == {"norm1", "attn", "norm_cross",
                                         "cross", "norm2", "mlp"}


def test_decoder_only_model_refuses_an_encoder_decoder():
    _, pcfg = _configs()
    with pytest.raises(ValueError, match="encoder-decoder"):
        T.init_params(pcfg, ShardingPlan(), torch.Generator())
