"""Port parity: training deepseek-v3-671b (MLA with multi-token
prediction) at tp = 1, float32, on the CPU, against the JAX reference on
the same numpy inputs.

The config is the reduced deepseek-v3-671b cut to 3 layers: layer 0
dense, layers 1 and 2 MoE (4 routed experts, top-2, and the shared
expert), one segment of count 2, so each of its cycles is checkpointed;
MLA at 4 heads, q and k 16 + 8 rope dims wide against v's 16 (the
attention's (24, 16) head-dim pair), q_lora and kv_lora 32.  Its
multi-token-prediction block's layer is of the last layer's kind, an
MoE layer, whose aux loss the reference drops.  Batch 2, sequence 24,
the cross-entropy in chunks of 8.  The params are drawn by the port's
``init_params`` in the training layout, norms non-zero so that their
gradients count, handed to the reference as numpy (``to_reference``;
its layout checked leaf for leaf against ``jax.eval_shape`` of the
reference's ``init_params``, whose eager draws take about 10 s a config
on one core) and back to the port through
``lm_train_params_from_reference``, the ``"mtp"`` block with them.  On
the CPU the attention is the kernel's plain version, differentiated by
autograd.

Tolerances, as ``test_torch_train_families.py``: the loss relative
1e-5; gradients per leaf max |diff| <= 1e-4 max |ref| + 1e-6 (both sum
in float32 in other orders); the remat modes bit-equal.  A step against
the reference's composition: SGD, params and momentum within the
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
from repro.models import transformer as RT  # noqa: E402
from repro.models.common import ShardingPlan as RefPlan  # noqa: E402
from repro.optim import optimizer as RO  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ParallelConfig, TrainConfig  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    lm_train_params_from_reference,
    to_reference,
)
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.common import ShardingPlan  # noqa: E402
from repro_torch.optim import optimizer as PO  # noqa: E402
from repro_torch.runtime.train_loop import (  # noqa: E402
    build_train_program,
    value_and_grad,
)

ARCH = "deepseek-v3-671b"
B, S, CHUNK, LAYERS = 2, 24, 8, 3
TOL_LOSS = 1e-5
TOL_GRAD = 1e-4


def _configs():
    return tuple(dataclasses.replace(get(ARCH).reduced(), num_layers=LAYERS,
                                     dtype="float32")
                 for get in (ref_config, get_config))


@functools.lru_cache(maxsize=None)
def _setup():
    """(ref cfg, port cfg, reference params (numpy), batch (numpy))."""
    rcfg, pcfg = _configs()
    gen = torch.Generator().manual_seed(4)
    params = to_reference(T.stack_layers(T.init_params(
        pcfg, ShardingPlan.for_model(pcfg), gen), pcfg))
    want = jax.eval_shape(functools.partial(
        RT.init_params, cfg=rcfg, plan=RefPlan.for_model(rcfg, tp=1),
        dtype=jnp.float32), jax.random.PRNGKey(4))
    assert (jax.tree_util.tree_structure(params)
            == jax.tree_util.tree_structure(want))
    for a, w in zip(jax.tree.leaves(params), jax.tree.leaves(want)):
        assert a.shape == w.shape and a.dtype == w.dtype
    rng = np.random.default_rng(4)

    def one(path, leaf):
        a = np.asarray(leaf)
        if "norm" in str(path[-1]):
            a = (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    params = jax.tree_util.tree_map_with_path(one, params)
    spec = RD.DataSpec(vocab_size=rcfg.vocab_size, seq_len=S,
                       global_batch=B, seed=6)
    batch = RD.synthetic_batch(spec, 0)
    batch["labels"][0, -3:] = -1  # positions the loss does not count
    return rcfg, pcfg, params, batch


def _params(mtp: bool):
    """The reference params, with or without the ``"mtp"`` block."""
    params = _setup()[2]
    return params if mtp else {k: v for k, v in params.items()
                               if k != "mtp"}


def _port(mtp: bool = True):
    _, pcfg, _, batch = _setup()
    return (pcfg, lm_train_params_from_reference(_params(mtp), pcfg, "cpu"),
            {k: torch.from_numpy(v) for k, v in batch.items()})


@functools.lru_cache(maxsize=None)
def _ref_value_and_grad(mtp: bool):
    """The reference's ``jax.value_and_grad`` of ``lm_loss`` (jitted
    once), as (loss, numpy gradients)."""
    rcfg, _, _, batch = _setup()
    plan = RefPlan.for_model(rcfg, tp=1)

    def loss(p, b):
        return RT.lm_loss(p, b, rcfg, plan, remat="none", xent_chunk=CHUNK)

    value, grads = jax.jit(jax.value_and_grad(loss))(
        _params(mtp), {k: jnp.asarray(v) for k, v in batch.items()})
    return float(value), jax.tree.map(np.asarray, grads)


def _port_value_and_grad(remat, mtp: bool = True):
    pcfg, params, batch = _port(mtp)
    plan = ShardingPlan.for_model(pcfg)
    return value_and_grad(
        lambda p, b: T.lm_loss(p, b, pcfg, plan, remat=remat,
                               xent_chunk=CHUNK), params, batch)


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


def test_config_is_mla_with_mtp_over_an_moe_layer():
    """The cut keeps what the training path has to carry: MLA at the
    (24, 16) pair, layer 0 dense and the rest MoE with a shared expert,
    a checkpointed segment, and an MTP block of the MoE kind."""
    pcfg = _setup()[1]
    a = pcfg.attention
    assert (a.kind, a.head_dim + a.qk_rope_head_dim, a.v_head_dim) == (
        "mla", 24, 16)
    specs = T.layer_specs(pcfg)
    assert [s.mlp for s in specs] == ["dense", "moe", "moe"]
    assert T.layer_spec(pcfg, LAYERS - 1).mlp == "moe"
    assert pcfg.moe.num_shared_experts == 1 and pcfg.mtp_depth == 1
    assert [seg.count for seg in T.build_segments(pcfg)] == [1, 2]
    assert "shared_in" in _port()[1]["mtp"]["layer"]["moe"]


@pytest.mark.parametrize("mtp", [True, False])
def test_lm_loss_and_grads_match_reference(mtp):
    """The loss (cross-entropy, 0.1 times the MTP block's cross-entropy
    on the labels two on, and the stack's MoE aux loss) and every
    gradient leaf of the reference's tree (the MLA projections, the
    experts, the shared expert, the router, the MTP block's ``proj`` and
    layer) against ``jax.value_and_grad`` of the reference's loss; and
    the same without the ``"mtp"`` block, which both skip."""
    loss, grads = _port_value_and_grad("full", mtp)
    ref_loss, ref_grads = _ref_value_and_grad(mtp)
    assert abs(float(loss) - ref_loss) <= TOL_LOSS * abs(ref_loss), (
        float(loss), ref_loss)
    _trees_close(grads, ref_grads, TOL_GRAD, 1e-6)
    paths = [p for p, _ in tree.leaves_with_paths(grads)]
    for name in ("w_dq", "w_uq", "w_dkv", "w_uk", "w_uv", "router",
                 "shared_in", "shared_gate", "shared_out"):
        assert any(f"['{name}']" in p for p in paths), name
    assert any("['mtp']" in p for p in paths) == mtp


def test_mtp_term_adds_a_tenth_of_its_loss_and_drops_its_aux():
    """The loss with the block minus the loss without it is 0.1 times
    ``mtp_loss``; the MTP layer's MoE has an aux loss of its own, which
    the total leaves out (as the reference's ``hm, _, _``)."""
    pcfg, params, batch = _port()
    plan = ShardingPlan.for_model(pcfg)
    with torch.no_grad():
        full = T.lm_loss(params, batch, pcfg, plan, xent_chunk=CHUNK)
        bare = T.lm_loss({k: v for k, v in params.items() if k != "mtp"},
                         batch, pcfg, plan, xent_chunk=CHUNK)
        h, _, _ = T.forward(params, batch["tokens"], pcfg, plan)
        term = T.mtp_loss(params, h, batch["labels"],
                          T._head_weight(params, pcfg), pcfg, plan, CHUNK)
        hm = torch.zeros((B, S, pcfg.d_model))
        _, _, aux = T.apply_layer(params["mtp"]["layer"], hm,
                                  T.layer_spec(pcfg, LAYERS - 1), pcfg, plan,
                                  torch.arange(S))
    assert float(term) > 0 and float(aux) > 0
    assert abs(float(full - bare) - 0.1 * float(term)) <= 1e-5 * float(full)


def test_remat_modes_give_bit_equal_grads():
    """Checkpointing recomputes the same forward (the router's choices
    in the MoE segment): "none", "full" and "dots" give the same loss and
    gradients, bit for bit."""
    base = _port_value_and_grad("none")
    for remat in ("full", "dots"):
        loss, grads = _port_value_and_grad(remat)
        assert torch.equal(loss, base[0])
        for a, b in zip(tree.leaves(grads), tree.leaves(base[1])):
            assert torch.equal(a, b)


@pytest.mark.parametrize("donate", [False, True])
def test_step_fn_matches_reference_composition(donate):
    """One ``step_fn`` (SGD, lr 1e-2) against the reference's
    composition: its gradients, then ``apply_updates``.  The step's loss
    runs the cross-entropy in one chunk, the reference's gradients in
    chunks of 8: the same function summed in other orders.  With
    ``donate`` the step updates the params and state it was given."""
    rcfg, pcfg, params, batch = _setup()
    kw = dict(optimizer="sgd", lr=1e-2, total_steps=10)
    rt, pt = RefTrainConfig(**kw), TrainConfig(**kw)
    ref_loss, grads = _ref_value_and_grad(True)
    state = RO.init_opt_state(params, rt, False)
    r_params, r_state, _ = jax.jit(functools.partial(
        RO.apply_updates, cfg=rt))(params, grads, state)

    prog = build_train_program(pcfg, ParallelConfig(remat="full"), pt,
                               device="cpu", donate=donate)
    pp = lm_train_params_from_reference(params, pcfg, "cpu")
    ps = PO.init_opt_state(pp, pt)
    new_p, new_s, metrics = prog.step_fn(
        pp, ps, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(metrics["loss"]) - ref_loss) <= TOL_LOSS * abs(ref_loss)
    assert int(new_s.step) == int(r_state.step) == 1
    _trees_close(new_p, r_params, TOL_GRAD, 1e-6)
    _trees_close(new_s.m, r_state.m, TOL_GRAD, 1e-6)
    same = all(a is b for a, b in zip(tree.leaves(new_p), tree.leaves(pp)))
    assert same == donate


def test_train_params_carry_the_mtp_block_both_ways():
    """The port's training tree crosses to the reference and back leaf
    for leaf, the unstacked ``"mtp"`` block (layer and ``proj``) with
    it."""
    pcfg = _setup()[1]
    gen = torch.Generator().manual_seed(9)
    params = T.stack_layers(T.init_params(pcfg, ShardingPlan.for_model(pcfg),
                                          gen), pcfg)
    back = lm_train_params_from_reference(to_reference(params), pcfg, "cpu")
    assert set(back["mtp"]) == {"layer", "proj"}
    assert back["mtp"]["proj"].shape == (2 * pcfg.d_model, pcfg.d_model)
    pl, bl = tree.leaves_with_paths(params), tree.leaves_with_paths(back)
    assert [p for p, _ in pl] == [p for p, _ in bl]
    for (_, a), (_, b) in zip(pl, bl):
        assert a.dtype == b.dtype and torch.equal(a, b)
