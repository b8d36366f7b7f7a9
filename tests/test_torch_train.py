"""Port parity: the training path at tp = 1, float32, on the CPU, against
the JAX reference on the same numpy inputs.

The reference's ``build_train_program`` fails under this jax (ROADMAP
R2), so the port is held against what its ``step_fn_py`` composes:
``T.lm_loss`` at a tp = 1 plan outside ``shard_map``,
``jax.value_and_grad``, ``opt.compress_gradients`` and
``opt.apply_updates``.  The port gets the reference's params in their own
stacked layout (``convert.lm_train_params_from_reference``), norms and
biases drawn non-zero so that their gradients count.

Configs: qwen2-0.5b reduced to 5 layers with its all-global pattern
written twice (so the layer cycle is 2 long: segments of count 2 and 1;
QKV bias, silu) and gemma2-27b reduced to 5 layers (local window 8 and
global layers alternating: segments of count 2 and 1; attention and
final soft caps, gelu).  Batch 2, sequence 24 (three windows), the
cross-entropy in chunks of 8.  On the CPU the attention is the kernel's
plain version, differentiated by autograd.

Tolerances: loss values relative 1e-5; gradients per leaf max |diff| <=
1e-4 max |ref| + 1e-6 (both sum in float32 in other orders through the
whole stack); optimizer params and state fed the same gradients per
leaf within 1e-6 of max |ref| (op for op the same float32 arithmetic;
pow, cos and the adafactor means may round an ulp apart); the
attention's closed-form gradient within 1e-4 of the largest |value| of
the three reference gradients (D = dO . o against autodiff's sum of p
dp).  Batches, int8 gradient codes and checkpoints are compared exactly.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.checkpoint.manager import CheckpointManager as RefCkpt  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs.base import TrainConfig as RefTrainConfig  # noqa: E402
from repro.data import pipeline as RD  # noqa: E402
from repro.models import common as RC  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.models.common import ShardingPlan as RefPlan  # noqa: E402
from repro.optim import optimizer as RO  # noqa: E402
from repro.runtime import fault as RF  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ParallelConfig, TrainConfig  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    lm_train_params_from_reference,
    opt_state_from_reference,
    to_reference,
)
from repro_torch.data import pipeline as PD  # noqa: E402
from repro_torch.kernels import local_attention as LA  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.common import ShardingPlan  # noqa: E402
from repro_torch.optim import optimizer as PO  # noqa: E402
from repro_torch.runtime import fault as PF  # noqa: E402
from repro_torch.runtime.train_loop import (  # noqa: E402
    build_train_program,
    value_and_grad,
)

B, S, CHUNK = 2, 24, 8
TOL_LOSS = 1e-5
TOL_GRAD = 1e-4
TOL_OPT = 1e-6
TOL_ATTN_BWD = 1e-4
ARCHS = ("qwen2-0.5b", "gemma2-27b")


def _configs(arch):
    """(reference, port) configs: reduced, 5 layers, float32."""
    out = []
    for get in (ref_config, get_config):
        cfg = dataclasses.replace(get(arch).reduced(), num_layers=5,
                                  dtype="float32")
        if arch == "qwen2-0.5b":  # cycle of 2 all-global layers
            cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
                cfg.attention, pattern=("global", "global")))
        out.append(cfg)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """(ref cfg, port cfg, reference params (numpy), batch (numpy))."""
    rcfg, pcfg = _configs(arch)
    segs = T.build_segments(pcfg)
    assert len(segs) == 2 and [s.count for s in segs] == [2, 1]
    params = RT.init_params(jax.random.PRNGKey(3), rcfg,
                            RefPlan.for_model(rcfg, tp=1),
                            dtype=jnp.float32)
    rng = np.random.default_rng(3)

    def one(path, leaf):
        a = np.asarray(leaf)
        if any(n in str(path[-1]) for n in ("norm", "bq", "bk", "bv")):
            a = (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    params = jax.tree_util.tree_map_with_path(one, params)
    spec = RD.DataSpec(vocab_size=rcfg.vocab_size, seq_len=S,
                       global_batch=B, seed=5)
    batch = RD.synthetic_batch(spec, 0)
    batch["labels"][0, -3:] = -1  # positions the loss does not count
    return rcfg, pcfg, params, batch


def _port(arch):
    rcfg, pcfg, params, batch = _setup(arch)
    return (pcfg, lm_train_params_from_reference(params, pcfg, "cpu"),
            {k: torch.from_numpy(v) for k, v in batch.items()})


@functools.lru_cache(maxsize=None)
def _ref_loss_fn(arch, remat, xent_chunk, grad):
    """The reference's ``lm_loss`` (or its ``value_and_grad``), jitted."""
    rcfg = _setup(arch)[0]
    plan = RefPlan.for_model(rcfg, tp=1)

    def loss(p, b):
        return RT.lm_loss(p, b, rcfg, plan, remat=remat,
                          xent_chunk=xent_chunk)

    return jax.jit(jax.value_and_grad(loss) if grad else loss)


@functools.lru_cache(maxsize=None)
def _ref_value_and_grad(arch):
    _, _, params, batch = _setup(arch)
    loss, grads = _ref_loss_fn(arch, "none", CHUNK, True)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), jax.tree.map(np.asarray, grads)


def _port_value_and_grad(arch, remat):
    pcfg, params, batch = _port(arch)
    plan = ShardingPlan.for_model(pcfg)
    return value_and_grad(
        lambda p, b: T.lm_loss(p, b, pcfg, plan, remat=remat,
                               xent_chunk=CHUNK), params, batch)


def _t(a):
    return torch.from_numpy(np.array(a))


def _leaf_close(got, want, tol, floor=0.0):
    """max |got - want| <= tol * max |want| + floor."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    bound = tol * (float(np.max(np.abs(want))) if want.size else 0.0) + floor
    return err <= bound, err, bound


def _trees_close(port_tree, ref_tree, tol, floor=0.0):
    pl = tree.leaves_with_paths(port_tree)
    rl = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    assert [p for p, _ in pl] == ["/".join(str(k) for k in p)
                                  for p, _ in rl]
    for (path, a), (_, b) in zip(pl, rl):
        a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else a
        ok, err, bound = _leaf_close(a, np.asarray(b, np.float32), tol, floor)
        assert ok, (path, err, bound)


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["tokens", "vit_stub", "encdec"])
def test_synthetic_batch_matches_reference(kind):
    """The port's batches are the reference's arrays, bit for bit, at
    several specs and steps; ``to_device`` keeps their dtypes."""
    kw = {"tokens": {}, "vit_stub": dict(frontend_kind="vit_stub",
                                         frontend_dim=32, frontend_tokens=4),
          "encdec": dict(frontend_dim=16, encdec=True)}[kind]
    for seed, b, s, vocab in ((0, 2, 16, 256), (7, 3, 33, 50_000)):
        for step in (0, 1, 9):
            a = PD.synthetic_batch(PD.DataSpec(vocab, s, b, seed, **kw), step)
            r = RD.synthetic_batch(RD.DataSpec(vocab, s, b, seed, **kw), step)
            assert sorted(a) == sorted(r)
            for k in a:
                assert a[k].dtype == r[k].dtype
                np.testing.assert_array_equal(a[k], r[k])
            dev = PD.to_device(a, "cpu")
            assert all(torch.equal(dev[k], torch.from_numpy(a[k]))
                       for k in a)


def test_spec_for_and_prefetcher_match_reference():
    """``spec_for`` builds the reference's spec, and the prefetcher
    yields the deterministic stream from its start step, as tensors."""
    from repro.configs.base import SHAPES as RSHAPES
    from repro_torch.configs.base import SHAPES

    for arch in ("gemma3-1b", "internvl2-2b", "seamless-m4t-large-v2"):
        for name in ("train_4k", "decode_32k"):
            a = PD.spec_for(get_config(arch), SHAPES[name], seed=3)
            r = RD.spec_for(ref_config(arch), RSHAPES[name], seed=3)
            assert dataclasses.asdict(a) == dataclasses.asdict(r)
    spec = PD.DataSpec(vocab_size=300, seq_len=8, global_batch=2, seed=4)
    pre = PD.Prefetcher(spec, start_step=5, device="cpu")
    try:
        for want in (5, 6, 7):
            step, batch = next(pre)
            assert step == want
            for k, v in RD.synthetic_batch(spec, step).items():
                np.testing.assert_array_equal(batch[k].numpy(), v)
    finally:
        pre.close()


# ---------------------------------------------------------------------------
# Loss and gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_matches_reference(arch, remat):
    """The loss with grad enabled (each cycle of the count-2 segment and
    each cross-entropy chunk checkpointed unless remat="none") against
    the reference's ``lm_loss`` at tp = 1."""
    _, _, params, batch = _setup(arch)
    ref = float(_ref_loss_fn(arch, remat, CHUNK, False)(
        params, {k: jnp.asarray(v) for k, v in batch.items()}))
    loss, _ = _port_value_and_grad(arch, remat)
    assert abs(float(loss) - ref) <= TOL_LOSS * abs(ref), (float(loss), ref)
    assert float(_ref_value_and_grad(arch)[0]) == pytest.approx(ref,
                                                                rel=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_grads_match_reference(arch):
    """Every gradient leaf of the reference's stacked tree against
    ``jax.value_and_grad`` of the reference's loss."""
    loss, grads = _port_value_and_grad(arch, "full")
    ref_loss, ref_grads = _ref_value_and_grad(arch)
    assert abs(float(loss) - ref_loss) <= TOL_LOSS * abs(ref_loss)
    _trees_close(grads, ref_grads, TOL_GRAD, 1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_modes_give_bit_equal_grads(arch):
    """Checkpointing recomputes the same forward: "none", "full" and
    "dots" give the same loss and gradients, bit for bit."""
    base = _port_value_and_grad(arch, "none")
    for remat in ("full", "dots"):
        loss, grads = _port_value_and_grad(arch, remat)
        assert torch.equal(loss, base[0])
        for a, b in zip(tree.leaves(grads), tree.leaves(base[1])):
            assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "internvl2-2b",
                                  "seamless-m4t-large-v2"])
def test_lm_loss_raises_for_families_not_trained(arch):
    """The three families that raised until MLA with MTP, the vit_stub
    frontend and the encoder-decoder were ported now train (the test
    keeps its name): each builds a train program at its reduced config
    (float32) and takes an AdamW step on the CPU on
    ``synthetic_batch``'s batch (its frames or patch embeddings
    included), whose loss is the config's loss (``encdec_loss`` for the
    encoder-decoder, ``lm_loss`` with the MTP term or the batch's patch
    embeddings otherwise) and which moves the params the new paths
    reach."""
    from repro_torch.models import encdec as ED

    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    prog = build_train_program(cfg, ParallelConfig(),
                               TrainConfig(lr=1e-2, warmup_steps=1),
                               device="cpu")
    params, state = prog.init_fn(0)
    fe = cfg.frontend
    kw = {} if fe is None else dict(frontend_kind=fe.kind,
                                    frontend_dim=fe.embed_dim,
                                    frontend_tokens=fe.num_tokens)
    batch = PD.to_device(PD.synthetic_batch(PD.DataSpec(
        cfg.vocab_size, S, B, 1, encdec=cfg.is_encdec, **kw), 0), "cpu")
    plan = ShardingPlan.for_model(cfg)
    with torch.no_grad():
        want = (ED.encdec_loss if cfg.is_encdec else T.lm_loss)(
            params, batch, cfg, plan)
    new_p, new_s, metrics = prog.step_fn(params, state, batch)
    assert torch.isfinite(metrics["loss"]) and int(new_s.step) == 1
    assert abs(float(metrics["loss"]) - float(want)) <= 1e-6 * float(want)
    moved = {"deepseek-v3-671b": ("mtp", "proj"),
             "internvl2-2b": ("frontend_proj",),
             "seamless-m4t-large-v2": ("decoder", "cross", "wq")}[arch]
    a, b = params, new_p
    for key in moved:
        a, b = a[key], b[key]
    assert not torch.equal(a, b)


@pytest.mark.parametrize("field", ["zero3", "dp_only"])
def test_mesh_only_parallel_configs_raise(field):
    """ZeRO-3 and dp_only shard params over a mesh, or replicate them
    over one (item 15(b), ``test_torch_train_tp.py``); they raise no
    more.  On one device they have no effect, as the other
    ParallelConfig fields that move data between devices: the step
    equals the default config's, bit for bit."""
    cfg = _setup("qwen2-0.5b")[1]
    runs = []
    for pcfg in (ParallelConfig(), ParallelConfig(**{field: True})):
        prog = build_train_program(cfg, pcfg, TrainConfig(), device="cpu")
        assert prog.plan.tp == 1 and prog.mesh is None
        params, state = prog.init_fn(0)
        batch = {k: torch.from_numpy(v) for k, v in RD.synthetic_batch(
            RD.DataSpec(cfg.vocab_size, 8, 2, 1), 0).items()}
        runs.append(prog.step_fn(params, state, batch))
    assert torch.equal(runs[0][2]["loss"], runs[1][2]["loss"])
    for a, b in zip(tree.leaves(runs[0][0]), tree.leaves(runs[1][0])):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------


def _opt_inputs(arch, seed):
    """(reference params, two gradient trees) as numpy on the stacked
    leaves."""
    _, _, params, _ = _setup(arch)
    rng = np.random.default_rng(seed)
    grads = [jax.tree.map(
        lambda a: (0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        params) for _ in range(2)]
    return params, grads


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("optimizer", ["adamw", "adafactor", "sgd"])
def test_apply_updates_matches_reference(optimizer, moment_dtype):
    """Two updates fed the same gradients on the reference's stacked
    leaves (so a stacked (2, 64) norm scale is decayed and factored, as
    there): params and state per leaf within TOL_OPT, metrics too.  The
    float32 runs clip (the global norm is about 11); the bfloat16-moment
    runs do not, since the norm sums its squares in another order than
    the reference's, and a moment one float32 ulp apart may round to the
    neighbouring bfloat16: unclipped, the moments are the same float32
    bits before they round.  The reference runs op by op, not under
    ``jit``, where XLA would fuse its multiply-adds into FMAs."""
    params, grads = _opt_inputs("gemma2-27b", 1)
    kw = dict(optimizer=optimizer, lr=3e-2, warmup_steps=1, total_steps=4,
              moment_dtype=moment_dtype,
              grad_clip=0.5 if moment_dtype == "float32" else 1e3)
    rcfg, pcfg = RefTrainConfig(**kw), TrainConfig(**kw)
    rp, rs = params, RO.init_opt_state(params, rcfg)
    pp = tree.tree_map(_t, params)
    ps = PO.init_opt_state(pp, pcfg)
    _trees_close(ps, rs, 0.0)
    for g in grads:
        rp, rs, rm = RO.apply_updates(rp, g, rs, rcfg)
        pp, ps, pm = PO.apply_updates(
            pp, tree.tree_map(_t, g), ps, pcfg)
        _trees_close(pp, rp, TOL_OPT)
        _trees_close(ps, rs, TOL_OPT)
        for k in ("lr", "grad_norm", "step"):
            ok, err, bound = _leaf_close(pm[k].numpy(), np.asarray(rm[k]),
                                         TOL_OPT)
            assert ok, (k, err, bound)
    if optimizer == "adafactor":
        # a norm scale stacked as (2, 64) is factored, as in the reference
        assert set(ps.v["segments"][0][0]["norm1"]) == {"row", "col"}


def test_lr_schedule_matches_reference():
    for warm, total, lr in ((0, 10, 1e-3), (2, 8, 3e-3), (5, 5, 1.0)):
        kw = dict(lr=lr, warmup_steps=warm, total_steps=total)
        rf, pf = RO.lr_schedule(RefTrainConfig(**kw)), \
            PO.lr_schedule(TrainConfig(**kw))
        for step in range(total + 3):
            ref = np.asarray(rf(jnp.int32(step)))
            got = pf(torch.tensor(step, dtype=torch.int32)).numpy()
            assert got.dtype == np.float32
            ok, err, bound = _leaf_close(got, ref, TOL_OPT)
            assert ok, (warm, total, step, err, bound)


def test_compression_with_error_feedback_matches_reference():
    """Two rounds of int8 compression carrying the residual: codes and
    scales equal, residuals and decompressed gradients within TOL_OPT.
    The reference runs op by op: under ``jit`` XLA turns the division by
    127 into a multiply by its reciprocal (the port's ``divide`` keeps
    it a division, as the reference's op-by-op run does)."""
    params, grads = _opt_inputs("qwen2-0.5b", 2)
    r_err = jax.tree.map(np.zeros_like, params)
    p_err = tree.tree_map(_t, r_err)
    for g in grads:
        rq, rsc, r_err = RO.compress_gradients(g, r_err)
        pq, psc, p_err = PO.compress_gradients(
            tree.tree_map(_t, g), p_err)
        for a, b in zip(tree.leaves(pq), jax.tree.leaves(rq)):
            assert a.dtype == torch.int8
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        _trees_close(psc, rsc, 0.0)
        _trees_close(p_err, r_err, TOL_OPT)
        _trees_close(PO.decompress_gradients(pq, psc),
                     RO.decompress_gradients(rq, rsc), 0.0)


# ---------------------------------------------------------------------------
# The whole step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compression", [False, True])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_step_fn_matches_reference_composition(microbatches, compression):
    """One ``step_fn`` against ``step_fn_py`` composed by hand: the
    gradient of each microbatch, summed in float32 and divided by their
    count, the loss their mean, compression with error feedback, then
    ``apply_updates``.  SGD, so that a gradient within the tolerance of
    zero moves a param by lr times that, as it would not under Adam's
    normalisation at step 1.  Params within TOL_GRAD of max |ref| (the
    gradients' tolerance), the loss within TOL_LOSS.  With compression a
    gradient within that tolerance of a rounding edge may take the
    neighbouring int8 code: params are then held within lr times the
    largest quantization step, and the residual within one step."""
    arch = "gemma2-27b"
    rcfg, pcfg, params, batch = _setup(arch)
    kw = dict(optimizer="sgd", lr=1e-2, total_steps=10)
    rt, pt = RefTrainConfig(**kw), TrainConfig(**kw)
    vg = _ref_loss_fn(arch, "none", 1024, True)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if microbatches > 1:
        losses, gsum = [], jax.tree.map(
            lambda p: jnp.zeros(p.shape, jnp.float32), params)
        for i in range(microbatches):
            mb = {k: v.reshape(microbatches, -1, *v.shape[1:])[i]
                  for k, v in jb.items()}
            l, g = vg(params, mb)
            gsum = jax.tree.map(lambda a, gg: a + gg.astype(jnp.float32),
                                gsum, g)
            losses.append(l)
        grads = jax.tree.map(lambda g: g / microbatches, gsum)
        loss = jnp.mean(jnp.stack(losses))
    else:
        loss, grads = vg(params, jb)
    state = RO.init_opt_state(params, rt, compression)
    if compression:
        qs, scales, new_err = RO.compress_gradients(grads, state.err)
        grads = RO.decompress_gradients(qs, scales)
        state = state._replace(err=new_err)
    r_params, r_state, r_metrics = RO.apply_updates(params, grads, state,
                                                    rt)

    prog = build_train_program(
        pcfg, ParallelConfig(remat="full", microbatches=microbatches,
                             grad_compression=compression), pt,
        device="cpu")
    pp = lm_train_params_from_reference(params, pcfg, "cpu")
    ps = PO.init_opt_state(pp, pt, compression)
    new_p, new_s, metrics = prog.step_fn(
        pp, ps, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(metrics["loss"]) - float(loss)) <= \
        TOL_LOSS * abs(float(loss))
    assert int(new_s.step) == int(r_state.step) == 1
    step = 0.0
    if compression:
        step = max(float(np.max(np.asarray(s)))
                   for s in jax.tree.leaves(scales)) * 1.001
        _trees_close(new_s.err, r_state.err, 0.0, step)
    _trees_close(new_p, r_params, TOL_GRAD, 1e-6 + pt.lr * step)
    _trees_close(new_s.m, r_state.m, TOL_GRAD, 1e-6 + step)
    # the inputs are left as they were (a step is functional)
    _trees_close(pp, params, 0.0)


# ---------------------------------------------------------------------------
# The attention's gradient
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dims", [(16, 16), (24, 16)])
@pytest.mark.parametrize("cap", [None, 50.0])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("window", [1, 5, 19])
def test_attention_bwd_plain_matches_autograd_and_jax_vjp(window, group,
                                                          cap, dims):
    """``local_attention_bwd_plain`` and the row statistics against
    autograd of the plain forward and against ``jax.vjp`` of the
    reference's ``flash_attention`` (window S = 19: full causal), at the
    (q/k, v) head-dim pairs (16, 16) and the reduced MLA's (24, 16)
    (scale 24^-0.5; dq, dk 24 wide, dv 16)."""
    s, kvh = 19, 2
    d, dv = dims
    rng = np.random.default_rng(window * 10 + group + d)
    q_np = rng.standard_normal((2, s, kvh * group, d)).astype(np.float32)
    do_np = rng.standard_normal((2, s, kvh * group, dv)).astype(np.float32)
    k_np = rng.standard_normal((2, s, kvh, d)).astype(np.float32)
    v_np = rng.standard_normal((2, s, kvh, dv)).astype(np.float32)
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in (q_np, k_np, v_np))
    o = LA.grouped_local_attention_plain(q, k, v, window=window, softcap=cap)
    do = torch.from_numpy(do_np)
    auto = torch.autograd.grad(o, (q, k, v), do)
    got = LA.local_attention_bwd_plain(q.detach(), k.detach(), v.detach(),
                                       o.detach(), do, window=window,
                                       softcap=cap)
    o_ref, vjp = jax.vjp(lambda a, b, c: RC.flash_attention(
        a, b, c, window=None if window >= s else window, logit_softcap=cap),
        jnp.asarray(q_np), jnp.asarray(k_np), jnp.asarray(v_np))
    ref = [np.asarray(g) for g in vjp(jnp.asarray(do_np))]
    scale = max(float(np.abs(g).max()) for g in ref)
    for a, b, c in zip(got, auto, ref):
        assert float(np.abs(a.numpy() - c).max()) <= TOL_ATTN_BWD * scale
        assert float((a - b).abs().max()) <= TOL_ATTN_BWD * scale
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_ref),
                               rtol=1e-5, atol=1e-5)
    # row statistics: lse over each row's window and D = dO . o
    lse, delta = LA.local_attention_row_stats_plain(
        q.detach(), k.detach(), o.detach(), do, window=window, softcap=cap)
    kr = np.repeat(k_np, group, axis=2)
    sc = np.einsum("bqhd,bkhd->bhqk", q_np, kr) * d ** -0.5
    if cap is not None:
        sc = np.tanh(sc / cap) * cap
    i, j = np.arange(s)[:, None], np.arange(s)[None, :]
    sc = np.where((j <= i) & (j > i - window), sc, -np.inf)
    m = sc.max(-1, keepdims=True)
    lse_ref = (m + np.log(np.exp(sc - m).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), lse_ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        delta.numpy(), np.einsum("bqhd,bqhd->bhq", do_np, np.asarray(o_ref)),
        rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# Checkpoints, fault tolerance, the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoint_read_by_the_other_package(writer, tmp_path):
    """A checkpoint of params (float32 and bfloat16 leaves) and an AdamW
    state written by one package restores in the other leaf for leaf:
    same paths, dtypes, values."""
    _, pcfg, params, _ = _setup("qwen2-0.5b")
    params = dict(params, embed=np.asarray(params["embed"]).astype(
        jnp.bfloat16))
    rt = RefTrainConfig(moment_dtype="bfloat16")
    r_tree = {"params": jax.tree.map(jnp.asarray, params),
              "opt_state": RO.init_opt_state(params, rt)}
    rng = np.random.default_rng(4)
    r_tree["opt_state"] = r_tree["opt_state"]._replace(
        step=jnp.int32(7), m=jax.tree.map(
            lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype),
            r_tree["opt_state"].m))
    p_tree = {"params": lm_train_params_from_reference(params, pcfg, "cpu"),
              "opt_state": opt_state_from_reference(r_tree["opt_state"],
                                                    "cpu")}
    assert p_tree["params"]["embed"].dtype == torch.bfloat16
    if writer == "port":
        CheckpointManager(str(tmp_path)).save(3, p_tree, blocking=True)
        got, step = RefCkpt(str(tmp_path)).restore(r_tree)
        want = r_tree
    else:
        RefCkpt(str(tmp_path)).save(3, r_tree, blocking=True)
        template = tree.tree_map(torch.zeros_like, p_tree)
        got, step = CheckpointManager(str(tmp_path)).restore(template)
        got, want = to_reference(got), r_tree
    assert step == 3
    gl = jax.tree_util.tree_flatten_with_path(got)[0]
    wl = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, a), (_, b) in zip(gl, wl):
        assert np.dtype(a.dtype) == np.dtype(b.dtype), path
        np.testing.assert_array_equal(np.asarray(a, np.float64),
                                      np.asarray(b, np.float64))


def test_step_guard_and_straggler_monitor():
    """As the reference's ``test_straggler_and_guard``; a programming
    error is not retried."""
    for mod in (PF, RF):
        mon = mod.StragglerMonitor(threshold=2.0, trip_limit=2)
        assert not mon.observe(0, 1.0)
        assert not mon.observe(1, 1.05)
        assert not mon.observe(2, 5.0)   # first trip
        assert mon.observe(3, 5.0)       # second trip -> escalate
        assert mon.flagged_steps == [2, 3]
    assert PF.RETRYABLE_FAULTS == RF.RETRYABLE_FAULTS
    calls = []
    guard = PF.StepGuard(recover=lambda s: calls.append(s), max_retries=2,
                         backoff_s=0.0)
    state = {"n": 0}

    def flaky():
        state["n"] += 1
        if state["n"] < 3:
            raise RuntimeError("CUDA error: an illegal memory access")
        return torch.ones(())

    out = guard.run(flaky, step=7)
    assert float(out) == 1.0 and calls == [6, 6] and guard.failures == 2

    def wrong():
        raise ValueError("a bug, not a fault")

    with pytest.raises(ValueError):
        guard.run(wrong, step=8)
    assert guard.failures == 2


def test_train_cli_resume_equals_uninterrupted(tmp_path, capsys):
    """``python -m repro_torch.launch.train --device cpu``: 3 steps in
    one run, and 2 steps then a resume to 3, end on the same params and
    optimizer state, bit for bit."""
    from repro_torch.launch import train

    common = ["--arch", "qwen2-0.5b", "--device", "cpu", "--batch", "2",
              "--seq", "16"]
    assert train.main(common + ["--steps", "3", "--ckpt-dir",
                                str(tmp_path / "a")]) == 0
    assert train.main(common + ["--steps", "2", "--ckpt-dir",
                                str(tmp_path / "b")]) == 0
    assert train.main(common + ["--steps", "3", "--ckpt-dir",
                                str(tmp_path / "b"), "--resume"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and out.count("step     2") == 2
    cfg = get_config("qwen2-0.5b").reduced()
    prog = build_train_program(cfg, ParallelConfig(), TrainConfig(),
                               device="cpu")
    template = dict(zip(("params", "opt_state"), prog.init_fn(1)))
    a, step_a = CheckpointManager(str(tmp_path / "a")).restore(template)
    b, step_b = CheckpointManager(str(tmp_path / "b")).restore(template)
    assert step_a == step_b == 3
    for x, y in zip(tree.leaves(a), tree.leaves(b)):
        assert torch.equal(x, y)
