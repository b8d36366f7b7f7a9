"""Port parity: LM serving (prefill + greedy decode) of the port against
the JAX reference at tp = 1, float32, on the CPU.

The reference runs ``T.prefill`` / ``T.decode_step`` directly with
``ShardingPlan.for_model(cfg, tp=1)`` (no ``shard_map``); the port gets
the same params through ``convert.lm_params_from_reference``.  Norm
scales and QKV biases are drawn non-zero so that those paths count.
On the CPU the port's prefill attention is the kernel's plain version.

Configs: gemma3-1b reduced to 14 layers (a 6-layer cycle stacked twice
plus an unstacked 2-layer cycle; local layers with window 8 and global
layers), gemma2-27b reduced (attention and final soft caps), qwen2-0.5b
reduced (QKV bias, silu), minitron-8b reduced (squared ReLU without a
gate; an untied head, which the reference dequantizes to bfloat16),
granite-moe-3b-a800m reduced (2 MoE layers, stacked), falcon-mamba-7b
reduced (2 Mamba layers, stacked, untied head), jamba-v0.1-52b
reduced (one 8-layer cycle: Mamba, attention, dense and MoE MLPs),
deepseek-v3-671b reduced (MLA with q/k 16 + 8 rope dims against v 16, a
dense layer then an MoE layer with a shared expert, MTP params carried
and quantized, not run) and internvl2-2b reduced (GQA group 2, an
untied head, and its ``vit_stub`` frontend: 4 patch embeddings, 32 wide,
passed to both sides, whose ``frontend_proj`` replaces the prompt's
first 4 positions).  The encoder-decoder is ``test_torch_encdec.py``.
The prompt (12) is longer than the local layers' ring (9), and the
decode steps wrap the ring.  Dropping MoE pairs, granite's GQA group
of 3 and the Mamba block at the published state size are held in
``test_torch_moe_ssm.py``.

Tolerances: logits rtol = atol = 1e-4 in float32 (both sides sum in
other orders); 2e-3 for decode logits with the int8 KV cache, where a k
or v value on a rounding edge can flip one int8 code.  Int8 cache codes
may differ by one, in at most 5% of a layer's codes.  Generated tokens
must be equal.  Quantized weights must be equal by value.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.models.common import ShardingPlan as RefPlan  # noqa: E402
from repro.runtime.serve_loop import (  # noqa: E402
    quantize_params_for_serving as ref_quantize,
)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    lm_caches_from_reference,
    lm_params_from_reference,
)
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.common import ShardingPlan  # noqa: E402
from repro_torch.runtime.serve_loop import (  # noqa: E402
    build_serve_program,
    greedy_generate,
    quantize_decisions,
    quantize_params_for_serving,
)

B, PROMPT, STEPS = 2, 12, 12
S_MAX = PROMPT + STEPS + 1
TOL = 1e-4
TOL_INT8_KV = 2e-3
#: gemma3 keeps the reference's default size floor, which quantizes the
#: stacked 6-cycle's w_in but not the unstacked 2-cycle's
ARCHS = {"gemma3-1b": (14, 1 << 14), "gemma2-27b": (None, 1),
         "qwen2-0.5b": (None, 1), "minitron-8b": (None, 1),
         "granite-moe-3b-a800m": (None, 1), "falcon-mamba-7b": (None, 1),
         "jamba-v0.1-52b": (None, 1), "deepseek-v3-671b": (None, 1),
         "internvl2-2b": (None, 1)}


def _configs(arch):
    layers, _ = ARCHS[arch]
    rcfg, pcfg = ref_config(arch).reduced(), get_config(arch).reduced()
    if layers is not None:
        rcfg = dataclasses.replace(rcfg, num_layers=layers)
        pcfg = dataclasses.replace(pcfg, num_layers=layers)
    return rcfg, pcfg


def _ref_params(rcfg, seed):
    """Reference float32 params as numpy, norms and biases non-zero."""
    return _ref_params_dtype(rcfg, seed, jnp.float32)


def _ref_params_dtype(rcfg, seed, dtype):
    plan = RefPlan.for_model(rcfg, tp=1)
    params = RT.init_params(jax.random.PRNGKey(seed), rcfg, plan,
                            dtype=dtype)
    rng = np.random.default_rng(seed)

    def one(path, leaf):
        a = np.asarray(leaf)
        name = str(path[-1])
        if any(n in name for n in ("norm", "bq", "bk", "bv", "conv_b")):
            a = (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(one, params)


def _patch_embeds(rcfg, seed, dtype=np.float32):
    """The frontend's patch embeddings (B, num_tokens, embed_dim), or
    None for a model without one."""
    fe = rcfg.frontend
    if fe is None or fe.kind != "vit_stub":
        return None
    return np.random.default_rng(seed).standard_normal(
        (B, fe.num_tokens, fe.embed_dim)).astype(dtype)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


def _compare_caches(port, ref_np, pcfg, kv_dtype, what):
    ref = lm_caches_from_reference(ref_np, pcfg, device="cpu")
    assert len(port) == len(ref) == pcfg.num_layers
    for l, (pc, rc) in enumerate(zip(port, ref)):
        assert pc.keys() == rc.keys(), (what, l)
        for name in pc:
            a, b = pc[name], rc[name]
            assert a.shape == b.shape and a.dtype == b.dtype, (what, l, name)
            if a.dtype == torch.int8:
                # a value on a rounding edge may flip one code, and a
                # flipped code moves the values that later layers and
                # steps quantize by up to the decode-logit tolerance
                diff = (a.int() - b.int()).abs()
                assert int(diff.max()) <= 1, (what, l, name)
                assert int((diff > 0).sum()) <= max(1, a.numel() // 20), (
                    f"{what}: layer {l} {name}: {int((diff > 0).sum())} of "
                    f"{a.numel()} int8 codes differ")
            else:
                _close(a, b, TOL, f"{what}: layer {l} {name}")


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("min_size", [1, 1 << 14])
def test_quantized_weights_equal_reference(arch, min_size):
    """The port quantizes the same leaves to the same int8 codes and
    scales as the reference's ``quantize_params_for_serving``, whose
    size floor counts scan-stacked leaves."""
    rcfg, pcfg = _configs(arch)
    params = _ref_params(rcfg, 0)
    want = lm_params_from_reference(
        jax.tree.map(np.asarray, ref_quantize(params, min_size)), pcfg,
        device="cpu")
    got = quantize_params_for_serving(
        lm_params_from_reference(params, pcfg, device="cpu"), pcfg, min_size)
    decided = quantize_decisions(
        lm_params_from_reference(params, pcfg, device="cpu"), pcfg, min_size)
    n_quantized = 0

    def walk(g, w, path):
        nonlocal n_quantized
        if isinstance(w, dict) and "q" in w:
            assert isinstance(g, dict) and "q" in g, f"{path}: not quantized"
            assert decided[path]
            n_quantized += 1
            differ = int((g["q"] != w["q"]).sum())
            assert differ == 0, (
                f"{path}: {differ} of {w['q'].numel()} int8 codes differ "
                "(x / scale on a round-half edge)")
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
    assert n_quantized > 0 or min_size > 1


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("cim_weights", [False, True])
def test_prefill_and_greedy_decode_match_reference(arch, kv_dtype,
                                                   cim_weights):
    rcfg, pcfg = _configs(arch)
    _, min_size = ARCHS[arch]
    rplan = RefPlan.for_model(rcfg, tp=1)
    params = _ref_params(rcfg, 1)
    if cim_weights:
        params = jax.tree.map(np.asarray, ref_quantize(params, min_size))
    tokens = np.random.default_rng(2).integers(
        0, rcfg.vocab_size, (B, PROMPT)).astype(np.int32)
    patches = _patch_embeds(rcfg, 3)
    r_extras = None if patches is None else {
        "patch_embeds": jnp.asarray(patches)}
    batch = {"tokens": _t(tokens)}
    if patches is not None:
        batch["patch_embeds"] = _t(patches)

    r_prefill = jax.jit(functools.partial(
        RT.prefill, cfg=rcfg, plan=rplan, kv_dtype=kv_dtype, s_max=S_MAX))
    r_decode = jax.jit(functools.partial(
        RT.decode_step, cfg=rcfg, plan=rplan, kv_dtype=kv_dtype))
    r_logits, r_caches = r_prefill(params, jnp.asarray(tokens),
                                   extras=r_extras)
    ref_logits = [np.asarray(r_logits)]

    prog = build_serve_program(pcfg, batch=B, s_max=S_MAX, kv_dtype=kv_dtype,
                               cim_weights=cim_weights,
                               quant_min_size=min_size, device="cpu")
    pparams = lm_params_from_reference(params, pcfg, device="cpu")
    p_logits, p_caches = prog.prefill_fn(pparams, batch)
    _close(p_logits, r_logits, TOL, "prefill logits")
    _compare_caches(p_caches, jax.tree.map(np.asarray, r_caches), pcfg,
                    kv_dtype, "prefill caches")

    # decode, both fed the reference's greedy tokens
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
                    kv_dtype, "caches after the ring wrapped")

    # the entry point itself, its per-step logits seen through on_logits
    seen = []
    got = greedy_generate(prog, pparams, batch, STEPS,
                          on_logits=lambda i, logits: seen.append(
                              (i, logits.clone())))
    assert torch.equal(got, _t(np.stack(ref_tokens, axis=1)))
    assert [i for i, _ in seen] == list(range(STEPS))
    for i, logits in seen:
        _close(logits, ref_logits[i], TOL if i == 0 else dec_tol,
               f"greedy_generate logits at step {i}")


def test_bfloat16_params_convert_bit_for_bit():
    """The reference's default dtype: bfloat16 leaves (ml_dtypes arrays)
    arrive with the same bits, un-stacked in layer order."""
    rcfg, pcfg = _configs("gemma3-1b")
    params = jax.tree.map(np.asarray, RT.init_params(
        jax.random.PRNGKey(3), rcfg, RefPlan.for_model(rcfg, tp=1)))
    got = lm_params_from_reference(params, pcfg, device="cpu")
    assert got["embed"].dtype == torch.bfloat16
    stacked = params["segments"][0][2]["attn"]["wq"]   # (2, d, d)
    for r in range(2):
        want = torch.from_numpy(stacked[r].view(np.uint16).astype(np.int32))
        have = got["layers"][6 * r + 2]["attn"]["wq"].view(torch.int16)
        assert torch.equal(have.int() & 0xFFFF, want)
    last = params["segments"][1][1]["mlp"]["w_out"]
    assert torch.equal(got["layers"][13]["mlp"]["w_out"].float(),
                       torch.from_numpy(last.astype(np.float32)))


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_init_cache_matches_reference_shapes(kv_dtype):
    """Zero caches: global layers hold s_max positions, local layers a
    ring of window + 1, int8 caches a float32 scale per position."""
    rcfg, pcfg = _configs("gemma3-1b")
    ref = jax.tree.map(np.asarray, RT.init_cache(
        rcfg, RefPlan.for_model(rcfg, tp=1), B, S_MAX, kv_dtype))
    want = lm_caches_from_reference(ref, pcfg, device="cpu")
    got = T.init_cache(pcfg, ShardingPlan(), B, S_MAX, kv_dtype,
                       device="cpu")
    assert len(got) == len(want) == 14
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for name in g:
            assert g[name].shape == w[name].shape, name
            assert g[name].dtype == w[name].dtype, name
            assert not g[name].any()


def test_serving_params_quantize_only_with_cim_weights():
    _, pcfg = _configs("qwen2-0.5b")
    gen = torch.Generator().manual_seed(0)
    params = T.init_params(pcfg, ShardingPlan(), gen, dtype=torch.float32)
    plain = build_serve_program(pcfg, 1, 8, device="cpu")
    cim = build_serve_program(pcfg, 1, 8, cim_weights=True, quant_min_size=1,
                              device="cpu")
    assert plain.serving_params(params) is params
    served = cim.serving_params(params)
    assert set(served["layers"][0]["attn"]["wq"]) == {"q", "s"}
    assert torch.is_tensor(served["layers"][0]["attn"]["bq"])
    assert torch.is_tensor(served["embed"])


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_float32_patch_embeds_promote_the_stream(kv_dtype):
    """bfloat16 params with float32 patch embeddings: the reference's
    ``jnp.where`` promotes the whole stream to float32, so both sides
    compute in float32 on bfloat16 weights and the bfloat16-flavor cache
    holds float32.  Prefill logits and caches match the reference's.
    Decoding over that cache is refused by the reference (a bfloat16 key
    into a float32 cache) and by the port; over the int8 cache both
    decode, in bfloat16: the logits agree within 0.05 (bfloat16
    products rounded at other points, 2 layers)."""
    rcfg, pcfg = _configs("internvl2-2b")
    rplan = RefPlan.for_model(rcfg, tp=1)
    params = _ref_params_dtype(rcfg, 4, jnp.bfloat16)
    tokens = np.random.default_rng(5).integers(
        0, rcfg.vocab_size, (B, PROMPT)).astype(np.int32)
    patches = _patch_embeds(rcfg, 6)
    r_logits, r_caches = RT.prefill(
        params, jnp.asarray(tokens), rcfg, rplan,
        extras={"patch_embeds": jnp.asarray(patches)}, kv_dtype=kv_dtype,
        s_max=S_MAX)
    prog = build_serve_program(pcfg, batch=B, s_max=S_MAX, kv_dtype=kv_dtype,
                               device="cpu")
    pparams = lm_params_from_reference(params, pcfg, device="cpu")
    p_logits, p_caches = prog.prefill_fn(
        pparams, {"tokens": _t(tokens), "patch_embeds": _t(patches)})
    _close(p_logits, r_logits, TOL, "prefill logits")
    _compare_caches(p_caches, jax.tree.map(np.asarray, r_caches), pcfg,
                    kv_dtype, "prefill caches")
    if kv_dtype == "bfloat16":
        assert p_caches[0]["k"].dtype == torch.float32
    token = jnp.argmax(r_logits, axis=-1).astype(jnp.int32)
    if kv_dtype == "bfloat16":
        with pytest.raises(TypeError, match="same dtypes"):
            RT.decode_step(params, token, r_caches, PROMPT, rcfg, rplan,
                           kv_dtype=kv_dtype)
        with pytest.raises(ValueError, match="float32 KV cache"):
            prog.decode_fn(pparams, _t(token), p_caches, PROMPT)
        return
    r_logits, _ = RT.decode_step(params, token, r_caches, PROMPT, rcfg,
                                 rplan, kv_dtype=kv_dtype)
    p_logits, _ = prog.decode_fn(pparams, _t(token), p_caches, PROMPT)
    _close(p_logits, r_logits, 0.05, "decode logits in bfloat16")


def test_patch_embeds_are_checked():
    """Patch embeddings of another width are refused; more of them than
    the prompt has positions raise, as the reference's negative pad
    does."""
    _, pcfg = _configs("internvl2-2b")
    prog = build_serve_program(pcfg, batch=B, s_max=S_MAX, device="cpu")
    params = prog.init_params(torch.Generator().manual_seed(0))
    tokens = torch.zeros((B, 3), dtype=torch.int64)
    for n, width, match in ((2, 31, "patch_embeds"), (4, 32, "prompt must")):
        patches = torch.zeros((B, n, width), dtype=torch.bfloat16)
        with pytest.raises(ValueError, match=match):
            prog.prefill_fn(params, {"tokens": tokens,
                                     "patch_embeds": patches})


def test_tp_above_one_raises():
    """Serving (``test_torch_serve_tp.py``) and training
    (``test_torch_train_tp.py``) at tp > 1 are ported.  What still
    raises at tp > 1: a plan with no mesh axis asked for its rank's
    index (it can run no collective).  A train program on a (1, 2) mesh
    builds its rank's plan and specs without running a collective."""
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.runtime.train_loop import build_train_program
    from repro_torch.tree import leaves
    from test_torch_serve_tp import _fake_mesh

    cfg = get_config("gemma3-1b")
    plan = ShardingPlan.for_model(cfg, tp=2)
    assert plan.tp == 2 and plan.attn_sharded and not plan.kv_sharded
    with pytest.raises(RuntimeError, match="mesh axis"):
        plan.tp_index()
    prog = build_train_program(cfg.reduced(), ParallelConfig(),
                               TrainConfig(), device="cpu",
                               mesh=_fake_mesh((1, 2), (0, 1)))
    assert prog.plan.tp == 2 and prog.plan.tp_index() == 1
    assert any("model" in s.dims for s in leaves(prog.param_specs))


def test_serving_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the no-card behaviour")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_serve_program(get_config("gemma3-1b").reduced(), 1, 8)


def test_init_cache_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the no-card behaviour")
    cfg = get_config("gemma3-1b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_cache(cfg, ShardingPlan(), 1, 8)


@pytest.mark.parametrize("arch", ["gemma3-1b", "granite-moe-3b-a800m",
                                  "falcon-mamba-7b", "jamba-v0.1-52b",
                                  "deepseek-v3-671b", "seamless-m4t-large-v2",
                                  "internvl2-2b"])
def test_serve_cli_runs_on_cpu(arch, capsys):
    from repro_torch.launch.serve import main

    assert main(["--arch", arch, "--device", "cpu", "--batch", "2",
                 "--prompt-len", "10", "--gen", "4", "--cim-weights",
                 "--kv-dtype", "int8"]) == 0
    out = capsys.readouterr().out
    assert "generated (2, 4)" in out and "on cpu" in out
