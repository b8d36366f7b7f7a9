"""Port parity: training the encoder-decoder (seamless-m4t-large-v2) and
the vision-language model (internvl2-2b, ``vit_stub`` frontend) at tp =
1, float32, on the CPU, against the JAX reference on the same numpy
inputs.

Configs: the reduced seamless-m4t-large-v2 (2 encoder and 2 decoder
layers of d_model 64, 4 heads of 16 on 4 kv heads, a gated gelu MLP of
128, a tied vocabulary of 256, frames 32 wide) under the reference's
``encdec_loss``, and the reduced internvl2-2b (2 layers, 4 heads on 2
kv heads, 4 patch embeddings 32 wide projected over the prompt's first
positions) under ``lm_loss`` with the batch's ``patch_embeds``.  Batch
2, sequence 24 (seamless: 24 frames, as ``synthetic_batch`` draws
them), the cross-entropy in chunks of 8.  The params are drawn by the
port's ``init_params`` in the training layout (seamless: the encoder's
and the decoder's leaves stacked over their layers, as the reference's
``vmap``-ed init), norms non-zero, handed to the reference as numpy
(``to_reference``; its layout checked leaf for leaf against
``jax.eval_shape`` of the reference's ``init_params``) and back through
``encdec_train_params_from_reference`` /
``lm_train_params_from_reference``.  On the CPU the decoders' causal
self-attention is the kernel's plain version; the encoder's
self-attention and the cross-attention are the plain bidirectional
blocks; autograd differentiates all of them.

Tolerances, as ``test_torch_train_families.py``: the loss relative
1e-5; gradients per leaf max |diff| <= 1e-4 max |ref| + 1e-6; the remat
modes bit-equal; one SGD step's params and momentum within the
gradients' tolerance.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs.base import TrainConfig as RefTrainConfig  # noqa: E402
from repro.data import pipeline as RD  # noqa: E402
from repro.models import encdec as RED  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.models.common import ShardingPlan as RefPlan  # noqa: E402
from repro.optim import optimizer as RO  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ParallelConfig, TrainConfig  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    encdec_train_params_from_reference,
    lm_train_params_from_reference,
    to_reference,
)
from repro_torch.kernels import local_attention as LA  # noqa: E402
from repro_torch.models import encdec as ED  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.common import ShardingPlan  # noqa: E402
from repro_torch.optim import optimizer as PO  # noqa: E402
from repro_torch.runtime.train_loop import (  # noqa: E402
    build_train_program,
    init_for,
    loss_for,
    value_and_grad,
)

B, S, CHUNK = 2, 24, 8
TOL_LOSS = 1e-5
TOL_GRAD = 1e-4
ARCHS = ("seamless-m4t-large-v2", "internvl2-2b")


def _configs(arch, dtype="float32"):
    return tuple(dataclasses.replace(get(arch).reduced(), dtype=dtype)
                 for get in (ref_config, get_config))


def _ref_init(rcfg):
    return RED.init_params if rcfg.is_encdec else RT.init_params


def _from_reference(params, pcfg):
    conv = (encdec_train_params_from_reference if pcfg.is_encdec
            else lm_train_params_from_reference)
    return conv(params, pcfg, "cpu")


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """(ref cfg, port cfg, reference params (numpy), batch (numpy))."""
    rcfg, pcfg = _configs(arch)
    gen = torch.Generator().manual_seed(5)
    params = to_reference(init_for(pcfg)(pcfg, ShardingPlan.for_model(pcfg),
                                         gen))
    want = jax.eval_shape(functools.partial(
        _ref_init(rcfg), cfg=rcfg, plan=RefPlan.for_model(rcfg, tp=1),
        dtype=jnp.float32), jax.random.PRNGKey(5))
    assert (jax.tree_util.tree_structure(params)
            == jax.tree_util.tree_structure(want))
    for a, w in zip(jax.tree.leaves(params), jax.tree.leaves(want)):
        assert a.shape == w.shape and a.dtype == w.dtype
    rng = np.random.default_rng(5)

    def one(path, leaf):
        a = np.asarray(leaf)
        if "norm" in str(path[-1]):
            a = (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    params = jax.tree_util.tree_map_with_path(one, params)
    fe = rcfg.frontend
    spec = RD.DataSpec(vocab_size=rcfg.vocab_size, seq_len=S,
                       global_batch=B, seed=7, frontend_kind=fe.kind,
                       frontend_dim=fe.embed_dim,
                       frontend_tokens=fe.num_tokens, encdec=rcfg.is_encdec)
    batch = RD.synthetic_batch(spec, 0)
    batch["labels"][0, -3:] = -1  # positions the loss does not count
    assert ("frames" in batch) == (arch == ARCHS[0])
    assert ("patch_embeds" in batch) == (arch == ARCHS[1])
    return rcfg, pcfg, params, batch


def _port(arch):
    _, pcfg, params, batch = _setup(arch)
    return (pcfg, _from_reference(params, pcfg),
            {k: torch.from_numpy(v) for k, v in batch.items()})


@functools.lru_cache(maxsize=None)
def _ref_value_and_grad(arch):
    """The reference's ``jax.value_and_grad`` of its loss for the config
    (``encdec_loss`` or ``lm_loss``, jitted once), as (loss, numpy
    gradients)."""
    rcfg, _, params, batch = _setup(arch)
    plan = RefPlan.for_model(rcfg, tp=1)
    ref_loss = RED.encdec_loss if rcfg.is_encdec else RT.lm_loss

    def loss(p, b):
        return ref_loss(p, b, rcfg, plan, remat="none", xent_chunk=CHUNK)

    value, grads = jax.jit(jax.value_and_grad(loss))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(value), jax.tree.map(np.asarray, grads)


def _port_value_and_grad(arch, remat):
    pcfg, params, batch = _port(arch)
    plan = ShardingPlan.for_model(pcfg)
    loss = loss_for(pcfg)
    return value_and_grad(
        lambda p, b: loss(p, b, pcfg, plan, remat=remat, xent_chunk=CHUNK),
        params, batch)


def _trees_close(port_tree, ref_tree, tol, floor=0.0):
    pl = tree.leaves_with_paths(port_tree)
    rl = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    assert [p for p, _ in pl] == ["/".join(str(k) for k in p)
                                  for p, _ in rl]
    for (path, a), (_, b) in zip(pl, rl):
        a = np.asarray(a.detach().float().numpy(), np.float64)
        b = np.asarray(b, np.float64)
        err = float(np.max(np.abs(a - b))) if b.size else 0.0
        bound = tol * (float(np.max(np.abs(b))) if b.size else 0.0) + floor
        assert err <= bound, (path, err, bound)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    """The loss and every gradient leaf (seamless: the stacked encoder
    and decoder, the cross-attention, ``frontend_proj`` and the tied
    embedding; internvl2: ``frontend_proj`` through the patch
    embeddings) against ``jax.value_and_grad`` of the reference's loss
    (``loss_for``: ``encdec_loss`` for the encoder-decoder)."""
    pcfg = _setup(arch)[1]
    assert loss_for(pcfg) is (ED.encdec_loss if arch == ARCHS[0]
                              else T.lm_loss)
    loss, grads = _port_value_and_grad(arch, "full")
    ref_loss, ref_grads = _ref_value_and_grad(arch)
    assert abs(float(loss) - ref_loss) <= TOL_LOSS * abs(ref_loss), (
        float(loss), ref_loss)
    _trees_close(grads, ref_grads, TOL_GRAD, 1e-6)
    leaves = dict(tree.leaves_with_paths(grads))
    proj = next(g for p, g in leaves.items() if "frontend_proj" in p)
    assert float(proj.abs().max()) > 0  # the frontend is trained
    if arch == ARCHS[0]:
        assert any("['cross']" in p for p in leaves)
        enc = next(g for p, g in leaves.items()
                   if "['encoder']" in p and "wq" in p)
        assert enc.shape[0] == pcfg.encoder_layers  # stacked over layers


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_modes_give_bit_equal_grads(arch):
    """Checkpointing each layer (seamless: every encoder and decoder
    layer, as the reference's scans; internvl2: its repeated segment)
    recomputes the same forward: "none", "full" and "dots" give the same
    loss and gradients, bit for bit."""
    base = _port_value_and_grad(arch, "none")
    for remat in ("full", "dots"):
        loss, grads = _port_value_and_grad(arch, remat)
        assert torch.equal(loss, base[0])
        for a, b in zip(tree.leaves(grads), tree.leaves(base[1])):
            assert torch.equal(a, b)


@pytest.mark.parametrize("arch,donate", [(ARCHS[0], True),
                                         (ARCHS[1], False)])
def test_step_fn_matches_reference_composition(arch, donate):
    """One ``step_fn`` (SGD, lr 1e-2) of ``build_train_program``, whose
    loss and init are the config's (``loss_for`` / ``init_for``),
    against the reference's composition: its gradients, then
    ``apply_updates``.  The step's loss runs the cross-entropy in one
    chunk, the reference's gradients in chunks of 8."""
    rcfg, pcfg, params, batch = _setup(arch)
    kw = dict(optimizer="sgd", lr=1e-2, total_steps=10)
    rt, pt = RefTrainConfig(**kw), TrainConfig(**kw)
    ref_loss, grads = _ref_value_and_grad(arch)
    state = RO.init_opt_state(params, rt, False)
    r_params, r_state, _ = jax.jit(functools.partial(
        RO.apply_updates, cfg=rt))(params, grads, state)

    prog = build_train_program(pcfg, ParallelConfig(remat="full"), pt,
                               device="cpu", donate=donate)
    init_p, _ = prog.init_fn(0)
    assert [p for p, _ in tree.leaves_with_paths(init_p)] == [
        p for p, _ in tree.leaves_with_paths(_port(arch)[1])]
    pp = _from_reference(params, pcfg)
    ps = PO.init_opt_state(pp, pt)
    new_p, new_s, metrics = prog.step_fn(
        pp, ps, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(metrics["loss"]) - ref_loss) <= TOL_LOSS * abs(ref_loss)
    assert int(new_s.step) == int(r_state.step) == 1
    _trees_close(new_p, r_params, TOL_GRAD, 1e-6)
    _trees_close(new_s.m, r_state.m, TOL_GRAD, 1e-6)
    same = all(a is b for a, b in zip(tree.leaves(new_p), tree.leaves(pp)))
    assert same == donate


def test_encdec_train_params_cross_both_ways():
    """The encoder-decoder's training tree (encoder and decoder stacked
    over their layers) crosses to the reference and back leaf for leaf;
    a tree stacked over the wrong count is refused; serving's per-layer
    lists give the same forward as the stacked tree."""
    pcfg = _setup(ARCHS[0])[1]
    plan = ShardingPlan.for_model(pcfg)
    gen = torch.Generator().manual_seed(11)
    layers = ED.init_params(pcfg, plan, gen)
    params = ED.stack_layers(layers)
    back = encdec_train_params_from_reference(to_reference(params), pcfg,
                                              "cpu")
    pl, bl = tree.leaves_with_paths(params), tree.leaves_with_paths(back)
    assert [p for p, _ in pl] == [p for p, _ in bl]
    for (_, a), (_, b) in zip(pl, bl):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="layers"):
        encdec_train_params_from_reference(
            to_reference(params), dataclasses.replace(pcfg, num_layers=3),
            "cpu")
    batch = {k: torch.from_numpy(v) for k, v in _setup(ARCHS[0])[3].items()}
    with torch.no_grad():
        a = ED.encdec_loss(params, batch, pcfg, plan)
        b = ED.encdec_loss(layers, batch, pcfg, plan)
    assert torch.equal(a, b)


def test_bf16_params_with_f32_frames_raise_in_training():
    """R5 in the training path: with bfloat16 params, float32 frames make
    a float32 memory, which turns the decoder stream float32 at the
    first cross-attention; the reference's layer scan refuses that, and
    the port's loss raises (under every remat mode)."""
    _, pcfg = _configs(ARCHS[0], "bfloat16")
    plan = ShardingPlan.for_model(pcfg)
    params = init_for(pcfg)(pcfg, plan, torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in _setup(ARCHS[0])[3].items()}
    assert batch["frames"].dtype == torch.float32
    for remat in ("none", "full"):
        with pytest.raises(ValueError, match="decoder stream"):
            value_and_grad(lambda p, b: ED.encdec_loss(p, b, pcfg, plan,
                                                       remat=remat),
                           params, batch)
    batch["frames"] = batch["frames"].to(torch.bfloat16)
    loss, _ = value_and_grad(
        lambda p, b: ED.encdec_loss(p, b, pcfg, plan), params, batch)
    assert torch.isfinite(loss)


def test_f32_patch_embeds_promote_the_training_stream():
    """R5 in the training path: with bfloat16 params, float32 patch
    embeddings turn internvl2's stream float32 (``embed_tokens``'
    promotion), so its attention runs in float32, forward and backward;
    bfloat16 ones keep it bfloat16.  Every leaf gets a gradient in its
    own dtype."""
    _, pcfg = _configs(ARCHS[1], "bfloat16")
    plan = ShardingPlan.for_model(pcfg)
    params = init_for(pcfg)(pcfg, plan, torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in _setup(ARCHS[1])[3].items()}
    seen = []
    real = LA.grouped_local_attention_plain

    def recording(q, k, v, **kw):
        seen.append(q.dtype)
        return real(q, k, v, **kw)

    LA.grouped_local_attention_plain = recording
    try:
        for embeds, want in ((torch.float32, torch.float32),
                             (torch.bfloat16, torch.bfloat16)):
            seen.clear()
            b = dict(batch, patch_embeds=batch["patch_embeds"].to(embeds))
            loss, grads = value_and_grad(
                lambda p, bb: T.lm_loss(p, bb, pcfg, plan), params, b)
            assert torch.isfinite(loss)
            assert seen and set(seen) == {want}
            for (_, p), (_, g) in zip(tree.leaves_with_paths(params),
                                      tree.leaves_with_paths(grads)):
                assert g.dtype == p.dtype
    finally:
        LA.grouped_local_attention_plain = real
