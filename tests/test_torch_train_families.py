"""Port parity: training the MoE, Mamba and hybrid families at tp = 1,
float32, on the CPU, against the JAX reference on the same numpy inputs.

Configs: the reduced granite-moe-3b-a800m (2 layers, one segment of
count 2, so each cycle is checkpointed; 4 experts top-2) at capacity
factor 0.5, whose capacity of 12 an expert holds 48 of the 96 (token,
k) pairs, so pairs drop (the reduced config's own 4.0 drops none, and
jamba's MoE layers run at it), the reduced
falcon-mamba-7b (2 Mamba layers, d_state 4) and the reduced
jamba-v0.1-52b (one 8-layer cycle: 7 Mamba layers and attention at 4,
MoE on the odd layers).  Batch 2, sequence 24, the cross-entropy in
chunks of 8.  The params are drawn by the port's ``init_params`` in the
training layout, norms and the Mamba conv bias non-zero so that their
gradients count, handed to the reference as numpy (``to_reference``; its
layout checked leaf for leaf against ``jax.eval_shape`` of the
reference's ``init_params``, whose eager draws take about 10 s a config
on one core) and back to the port through
``lm_train_params_from_reference``.  On the CPU the attention and the
scan are their kernels' plain versions, the scan differentiated by its
plain backward.

Tolerances, as ``test_torch_train.py``: the loss relative 1e-5;
gradients per leaf max |diff| <= 1e-4 max |ref| + 1e-6 (both sum in
float32 in other orders: the reference's associative scan multiplies
decays in another order than the sequential recurrence); the remat
modes bit-equal.  A step against the reference's composition: SGD (a
gradient within the tolerance of zero then moves a param by lr times
that), params and momentum within the gradients' tolerance.  A donated
step (params and moments written in place) against the functional one:
bit-equal, for each optimizer.
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
from repro_torch.models import moe as PM  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.common import ShardingPlan  # noqa: E402
from repro_torch.optim import optimizer as PO  # noqa: E402
from repro_torch.runtime.train_loop import (  # noqa: E402
    build_train_program,
    value_and_grad,
)

B, S, CHUNK = 2, 24, 8
TOL_LOSS = 1e-5
TOL_GRAD = 1e-4
#: (case, arch, capacity factor or None for the config's own)
CASES = (("granite-cf0.5", "granite-moe-3b-a800m", 0.5),
         ("falcon-mamba", "falcon-mamba-7b", None),
         ("jamba", "jamba-v0.1-52b", None))
ARCH = {case: (arch, cf) for case, arch, cf in CASES}
#: leaves of a training tree that hold the MoE and Mamba parameters
MOE_LEAVES = ("router", "w_in", "w_out", "w_gate")
MAMBA_LEAVES = ("A_log", "D", "dt_bias", "conv_w", "conv_b", "x_proj",
                "dt_proj", "w_in_x", "w_in_z", "w_out")


def _configs(case):
    arch, cf = ARCH[case]
    out = []
    for get in (ref_config, get_config):
        cfg = dataclasses.replace(get(arch).reduced(), dtype="float32")
        if cf is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=cf))
        out.append(cfg)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _setup(case):
    """(ref cfg, port cfg, reference params (numpy), batch (numpy))."""
    rcfg, pcfg = _configs(case)
    gen = torch.Generator().manual_seed(3)
    params = to_reference(T.stack_layers(T.init_params(
        pcfg, ShardingPlan.for_model(pcfg), gen), pcfg))
    want = jax.eval_shape(functools.partial(
        RT.init_params, cfg=rcfg, plan=RefPlan.for_model(rcfg, tp=1),
        dtype=jnp.float32), jax.random.PRNGKey(3))
    assert (jax.tree_util.tree_structure(params)
            == jax.tree_util.tree_structure(want))
    for a, w in zip(jax.tree.leaves(params), jax.tree.leaves(want)):
        assert a.shape == w.shape and a.dtype == w.dtype
    rng = np.random.default_rng(3)

    def one(path, leaf):
        a = np.asarray(leaf)
        if any(n in str(path[-1]) for n in ("norm", "conv_b")):
            a = (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    params = jax.tree_util.tree_map_with_path(one, params)
    spec = RD.DataSpec(vocab_size=rcfg.vocab_size, seq_len=S,
                       global_batch=B, seed=5)
    batch = RD.synthetic_batch(spec, 0)
    batch["labels"][0, -3:] = -1  # positions the loss does not count
    return rcfg, pcfg, params, batch


def _port(case):
    _, pcfg, params, batch = _setup(case)
    return (pcfg, lm_train_params_from_reference(params, pcfg, "cpu"),
            {k: torch.from_numpy(v) for k, v in batch.items()})


@functools.lru_cache(maxsize=None)
def _ref_value_and_grad(case):
    """The reference's ``jax.value_and_grad`` of ``lm_loss`` (jitted
    once), as (loss, numpy gradients)."""
    rcfg, _, params, batch = _setup(case)
    plan = RefPlan.for_model(rcfg, tp=1)

    def loss(p, b):
        return RT.lm_loss(p, b, rcfg, plan, remat="none", xent_chunk=CHUNK)

    value, grads = jax.jit(jax.value_and_grad(loss))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(value), jax.tree.map(np.asarray, grads)


def _port_value_and_grad(case, remat):
    pcfg, params, batch = _port(case)
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


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_lm_loss_and_grads_match_reference(case):
    """The loss (cross-entropy plus the MoE aux loss) and every gradient
    leaf of the reference's stacked tree (experts, router, the Mamba
    leaves, jamba's hybrid cycle) against ``jax.value_and_grad`` of the
    reference's loss."""
    pcfg = _setup(case)[1]
    loss, grads = _port_value_and_grad(case, "full")
    ref_loss, ref_grads = _ref_value_and_grad(case)
    assert abs(float(loss) - ref_loss) <= TOL_LOSS * abs(ref_loss), (
        float(loss), ref_loss)
    _trees_close(grads, ref_grads, TOL_GRAD, 1e-6)
    paths = [p for p, _ in tree.leaves_with_paths(grads)]
    want = ((MOE_LEAVES if pcfg.moe is not None else ())
            + (MAMBA_LEAVES if pcfg.num_mamba_layers else ()))
    for name in want:
        assert any(f"['{name}']" in p for p in paths), name
    if pcfg.moe is not None:
        t, e = B * S, pcfg.moe.num_experts
        cap = PM.capacity(t, pcfg, ShardingPlan.for_model(pcfg))
        # at factor 0.5 the experts hold fewer slots than there are pairs
        assert (cap * e < t * pcfg.moe.top_k) == (case == "granite-cf0.5")


@pytest.mark.parametrize("case", ["granite-cf0.5", "falcon-mamba", "jamba"])
def test_remat_modes_give_bit_equal_grads(case):
    """Checkpointing recomputes the same forward (the router's choices,
    the scan's states): "none", "full" and "dots" give the same loss and
    gradients, bit for bit."""
    base = _port_value_and_grad(case, "none")
    for remat in ("full", "dots"):
        loss, grads = _port_value_and_grad(case, remat)
        assert torch.equal(loss, base[0])
        for a, b in zip(tree.leaves(grads), tree.leaves(base[1])):
            assert torch.equal(a, b)


@pytest.mark.parametrize("case,donate", [("granite-cf0.5", False),
                                         ("falcon-mamba", True)])
def test_step_fn_matches_reference_composition(case, donate):
    """One ``step_fn`` (SGD, lr 1e-2) against the reference's
    composition: its gradients, then ``apply_updates``.  The step's loss
    runs the cross-entropy in one chunk, the reference's gradients in
    chunks of 8: the same function summed in other orders.  The Mamba
    case donates its params and state, which the step updates in place
    and returns."""
    rcfg, pcfg, params, batch = _setup(case)
    kw = dict(optimizer="sgd", lr=1e-2, total_steps=10)
    rt, pt = RefTrainConfig(**kw), TrainConfig(**kw)
    ref_loss, grads = _ref_value_and_grad(case)
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


@pytest.mark.parametrize("arch,item", [
    ("deepseek-v3-671b", "16(b)"), ("internvl2-2b", "16(c)"),
    ("seamless-m4t-large-v2", "16(c)")])
def test_train_program_builds_only_what_trains(arch, item):
    """Every family builds a train program now (the test keeps its name
    from when the three configs here raised, naming their ROADMAP Queue
    1 item): MLA with MTP, the vit_stub frontend and the encoder-decoder
    each take a donated AdamW step on the CPU (reduced config, float32)
    that gives the functional step's loss, params and moments bit for
    bit and writes them into the trees it was given; the families of
    this file build too."""
    for case in ("granite-cf0.5", "falcon-mamba", "jamba"):
        build_train_program(_setup(case)[1], ParallelConfig(),
                            TrainConfig(), device="cpu")
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    tcfg = TrainConfig(lr=1e-2, warmup_steps=1, total_steps=5)
    fe = cfg.frontend
    kw = {} if fe is None else dict(frontend_kind=fe.kind,
                                    frontend_dim=fe.embed_dim,
                                    frontend_tokens=fe.num_tokens)
    batch = {k: torch.from_numpy(v) for k, v in RD.synthetic_batch(
        RD.DataSpec(cfg.vocab_size, S, B, 2, encdec=cfg.is_encdec, **kw),
        0).items()}
    runs = []
    for donate in (False, True):
        prog = build_train_program(cfg, ParallelConfig(remat="full"), tcfg,
                                   device="cpu", donate=donate)
        p, state = prog.init_fn(1)
        new_p, new_s, metrics = prog.step_fn(p, state, batch)
        same = [a is b for a, b in zip(tree.leaves(new_p), tree.leaves(p))]
        assert (all(same) if donate else not any(same)), (arch, item)
        runs.append((metrics["loss"], tree.leaves(new_p),
                     tree.leaves(new_s)))
    assert torch.isfinite(runs[0][0]) and torch.equal(runs[0][0],
                                                      runs[1][0])
    for a, b in zip(runs[0][1] + runs[0][2], runs[1][1] + runs[1][2]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor", "sgd"])
def test_donated_step_equals_functional_step(optimizer, monkeypatch):
    """A donated step (params and moments written in place, AdamW and
    SGD in slices of ``DONATE_CHUNK`` elements along each leaf's first
    axis, here small enough to split every stacked leaf) gives the
    functional step's loss, params and state bit for bit, and returns
    the trees it was given."""
    monkeypatch.setattr(PO, "DONATE_CHUNK", 1000)
    pcfg = _setup("granite-cf0.5")[1]
    tcfg = TrainConfig(optimizer=optimizer, lr=1e-2, warmup_steps=1,
                       total_steps=5)
    _, params, batch = _port("granite-cf0.5")
    runs = []
    for donate in (False, True):
        prog = build_train_program(pcfg, ParallelConfig(remat="full"), tcfg,
                                   device="cpu", donate=donate)
        p = tree.tree_map(torch.clone, params)
        state = PO.init_opt_state(p, tcfg)
        new_p, new_s, metrics = prog.step_fn(p, state, batch)
        same = [a is b for a, b in zip(tree.leaves(new_p), tree.leaves(p))]
        assert all(same) if donate else not any(same)
        runs.append((metrics["loss"], tree.leaves(new_p),
                     tree.leaves(new_s)))
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(runs[0][1] + runs[0][2], runs[1][1] + runs[1][2]):
        assert torch.equal(a, b)
