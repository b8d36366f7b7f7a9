"""Port parity: training at tp > 1 on gloo CPU ranks against the JAX
reference, float32, reduced configs.

One spawn of 4 ranks (``tests/torch_tp_ranks.py::train_cases``) runs
every case.  Each rank's params are its shard of the global draws of a
tp = 1 program seeded with ``TRAIN_SEED`` (``TrainProgram.init_fn``);
the reference gets those global params (the tp = 1 program's, as numpy)
and the same global batch (``synthetic_batch`` seed 5, the last 3 labels
of every row -1, so every data shard counts the same positions).

* Every family's first-step loss and gradients (reduced over the mesh,
  each rank's ZeRO slice all-gathered) at tp 2 on three meshes: (1, 2)
  with the ring, (1, 2) with the all-reduce baseline, and (2, 2)
  (the data axis splits the batch), against the reference's
  ``jax.value_and_grad(loss_for(cfg))`` at tp = 1.  The MoE families
  run with ``aux_loss_coef`` 0 and a capacity that drops no pair, as the
  reference's own ``test_moe_sharded_grads_match_tp1``.  qwen2 with
  H = 6, KV = 2 also runs at (1, 4): its heads do not divide 4, so its
  attention is replicated.  granite with pairs dropped (capacity factor
  0.5) and its aux loss on, per rank over its own tokens, runs on
  (1, 2) against the reference's own tp = 2 gradient under
  ``shard_map`` (8 virtual CPU devices in a subprocess).
* One step on (2, 2) of AdamW, Adafactor and SGD (``grad_clip`` 0.5,
  which binds), each plain, with ``grad_compression`` and with 2
  microbatches, ZeRO-1 states over ``("data", "model")``: the gathered
  params and state against the reference's ``apply_updates`` /
  ``compress_gradients`` on global trees at tp = 1; each rank holds the
  ``zero_spec_for`` slice of every moment and residual.
* ZeRO-3 on (2, 2) (gemma3; granite, whose stacked leaves gather on
  their second dim): the loss and the reduced gradients bit-equal to the
  baseline's (every sum has two terms), params and moments after a step
  within 1e-6 of each leaf's largest |value| (the global norm sums the
  other slices in another order), each ZeRO-3 leaf 1/dp on each rank.
* ``dp_only`` on (2, 2): the gradients against tp = 1; its plan against
  the reference's ``make_plan``; serving with it (tp = 1, the batch over
  both axes) against the port's tp = 1 serving.
* Elastic restore: a checkpoint saved on (2, 2) after a step, restored
  onto the mesh ``elastic_remesh`` builds from ranks 0 and 1 ((1, 2)),
  whose next step equals the uninterrupted (2, 2) run's within 1e-5;
  ``remesh_shape`` against the reference's ``elastic_remesh`` for 1-8
  devices and model parallelism 1, 2, 4, 16.
* The specs, pure functions: ``zero_spec_for`` and ``_zero3_plan`` for
  every family's full config at mesh sizes (2, 4) and (2, 2) against the
  reference's.
* The train CLI on a (2, 2) mesh with checkpoints, resumed on (1, 2).

Tolerances: the loss 1e-5 relative; gradients atol 2e-4, rtol 2e-3 (the
reference's own ``test_moe_sharded``); a step's params and state within
1e-4 of each leaf's largest |value| plus 1e-6 (as
``test_torch_train_families.py``: the gradients' float32 noise moves a
param by lr times it; an Adafactor step rescales it), on all but 1% of
each leaf's elements for a compressed step (a gradient on an int8
rounding edge takes the next code), and AdamW's params only where the
gradient is above 1e-4 of its leaf's largest (the first step moves a
param by lr g / |g|, whose sign the noise sets where g is nearly zero;
everywhere within 2.5 lr).
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

import torch_tp_ranks as R  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs.base import ParallelConfig as RefParallel  # noqa: E402
from repro.configs.base import TrainConfig as RefTrainConfig  # noqa: E402
from repro.models import encdec as RE  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.models.common import ShardingPlan as RefPlan  # noqa: E402
from repro.optim import optimizer as RO  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import ASSIGNED_ARCHS, get_config  # noqa: E402
from repro_torch.configs.base import ParallelConfig, TrainConfig  # noqa: E402
from repro_torch.convert import to_reference  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.models.common import ShardingPlan  # noqa: E402
from repro_torch.runtime import partition  # noqa: E402
from repro_torch.runtime.train_loop import (  # noqa: E402
    build_train_program,
    train_specs,
)

ROOT = Path(__file__).resolve().parent.parent
TOL_LOSS = 1e-5
ATOL, RTOL = 2e-4, 2e-3
TOL_STEP = 1e-4
#: ZeRO-3's params and moments against the baseline's, per leaf's max
TOL_ZERO3 = 1e-6
#: the share of a leaf's elements a compressed step may move otherwise
#: (a gradient on an int8 rounding edge)
STEP_SHARE_INT8 = 1e-2
#: the CLI's float32 SGD params, resumed on another mesh, against the
#: uninterrupted run's: per leaf, of its largest |value| (the two meshes
#: sum the gradients in other orders; SGD's step is linear in them)
TOL_CLI = 1e-6
#: the CLI's SGD learning rate: the resumed step (lr / 2 in the warmup;
#: the first step's lr is 0) moves every leaf by far more than TOL_CLI
CLI_LR = 0.1


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("train_tp_ckpt")
    return spawn(R.train_cases, 4, str(ckpt),
                 tmp_dir=str(tmp_path_factory.mktemp("train_tp_ranks")),
                 timeout_s=300)


SHARDED_REFERENCE = r"""
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
sys.path.insert(0, sys.argv[2])
import torch_tp_ranks as R
from repro.compat import shard_map
from repro.configs import get_config
from repro.configs.base import ParallelConfig
from repro.models import transformer as RT
from repro.runtime.fault import elastic_remesh
from repro.runtime.partition import derive_specs
from repro.runtime.train_loop import _batch_pspec, make_plan
from repro_torch.configs.base import ParallelConfig as PP, TrainConfig as PT
from repro_torch.convert import to_reference
from repro_torch.runtime.train_loop import build_train_program

out = {}
pcfg = R.train_config("granite-moe-3b-a800m", "moe_drop", aux=True)
rcfg = R.variant(dataclasses.replace(get_config(
    "granite-moe-3b-a800m").reduced(), dtype="float32"), "moe_drop")
params = to_reference(build_train_program(
    pcfg, PP(), PT(), device="cpu").init_fn(R.TRAIN_SEED)[0])
batch = R.train_batch(pcfg)
axis_type = getattr(jax.sharding, "AxisType", None)
devices = np.array(jax.devices()[:2]).reshape(1, 2)
mesh = (Mesh(devices, ("data", "model"), axis_types=(axis_type.Auto,) * 2)
        if axis_type is not None else Mesh(devices, ("data", "model")))
plan = make_plan(rcfg, mesh, ParallelConfig(reduction="ring"))
key = jax.random.PRNGKey(0)
init = lambda p: RT.init_params(key, rcfg, p, jnp.float32)
specs = derive_specs(jax.eval_shape(lambda: init(plan.as_global())),
                     jax.eval_shape(lambda: init(plan)), plan.tp)
loss_sm = shard_map(
    lambda p, b: RT.lm_loss(p, b, rcfg, plan, remat="full"), mesh,
    in_specs=(specs, _batch_pspec(batch, plan)), out_specs=P())
value, grads = jax.jit(jax.value_and_grad(loss_sm))(params, batch)
out["loss"] = np.asarray(value)
for i, g in enumerate(jax.tree.leaves(grads)):
    out[f"g{i}"] = np.asarray(g)
for n in range(1, 9):
    for mp in (1, 2, 4, 16):
        m, dropped = elastic_remesh(jax.devices()[:n], mp)
        out[f"remesh-{n}-{mp}"] = np.array(
            [m.devices.shape[0], m.devices.shape[1], len(dropped)])
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def sharded_reference(tmp_path_factory):
    """The reference's own tp = 2 gradient of granite with pairs dropped
    and the aux loss on, under ``shard_map`` on 2 of 8 virtual CPU
    devices, and its ``elastic_remesh`` shapes, in a subprocess (the
    device count must be set before jax starts)."""
    path = tmp_path_factory.mktemp("train_tp_ref") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.run(
        [sys.executable, "-c", SHARDED_REFERENCE, str(path),
         str(ROOT / "tests")], env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(path) as f:
        return dict(f)


def _ref_cfg(arch, var=None, aux=False):
    cfg = dataclasses.replace(ref_config(arch).reduced(), dtype="float32")
    cfg = R.variant(cfg, var) if var else cfg
    if cfg.moe is not None and not aux:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, aux_loss_coef=0.0))
    return cfg


@functools.lru_cache(maxsize=None)
def _global_params(arch, var=None):
    """The global params every mesh's ranks hold their shards of: the
    tp = 1 program's init, as numpy in the reference's layout."""
    prog = build_train_program(R.train_config(arch, var), ParallelConfig(),
                               TrainConfig(), device="cpu")
    return to_reference(prog.init_fn(R.TRAIN_SEED)[0])


@functools.lru_cache(maxsize=None)
def _ref_value_and_grad(arch, var=None):
    """The reference's ``jax.value_and_grad(loss_for(cfg))`` at tp = 1,
    jitted once a config."""
    rcfg = _ref_cfg(arch, var)
    loss_fn = RE.encdec_loss if rcfg.is_encdec else RT.lm_loss
    plan = RefPlan.for_model(rcfg, tp=1)
    return jax.jit(jax.value_and_grad(
        lambda p, b: loss_fn(p, b, rcfg, plan, remat="none")))


@functools.lru_cache(maxsize=None)
def _ref_loss_grad(arch, var=None):
    """(loss, numpy gradients) of it on the global params and batch."""
    batch = {k: jnp.asarray(v)
             for k, v in R.train_batch(R.train_config(arch, var)).items()}
    value, grads = _ref_value_and_grad(arch, var)(_global_params(arch, var),
                                                  batch)
    return float(value), jax.tree.map(np.asarray, grads)


def _close(port_tree, ref_leaves, atol=ATOL, rtol=RTOL):
    pl = tree.leaves_with_paths(port_tree)
    assert len(pl) == len(ref_leaves)
    for (path, a), b in zip(pl, ref_leaves):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=atol, rtol=rtol, err_msg=path)


def _parts(ranks, key):
    return {r[key]["coords"]: r[key] for r in ranks if key in r}


def _first(parts):
    return parts[min(parts)]


@pytest.mark.parametrize("mesh", sorted(R.MESHES))
@pytest.mark.parametrize("arch", R.FAMILIES)
def test_family_loss_and_grads_at_tp2_match_reference_at_tp1(arch, mesh,
                                                            ranks):
    parts = _parts(ranks, (arch, mesh))
    assert len(parts) == len(R.MESHES[mesh][1])
    loss, grads = _ref_loss_grad(arch)
    for p in parts.values():
        assert abs(float(p["loss"]) - loss) <= TOL_LOSS * abs(loss), (
            float(p["loss"]), loss)
    _close(_first(parts)["grads"], jax.tree.leaves(grads))


def test_replicated_attention_at_tp4_matches_reference_at_tp1(ranks):
    """qwen2 with H = 6, KV = 2 at tp = 4: heads do not shard, every
    rank runs the attention on the gathered stream with the whole
    weights, whose partial gradients sum over the model axis."""
    cfg = R.train_config("qwen2-0.5b", "seq_cache")
    assert not ShardingPlan.for_model(cfg, tp=4).attn_sharded
    parts = _parts(ranks, "seq_cache")
    assert len(parts) == 4
    loss, grads = _ref_loss_grad("qwen2-0.5b", "seq_cache")
    assert abs(float(_first(parts)["loss"]) - loss) <= TOL_LOSS * loss
    _close(_first(parts)["grads"], jax.tree.leaves(grads))


def test_dropping_moe_with_aux_matches_the_references_sharded_grads(
        ranks, sharded_reference):
    """Per-rank capacity and the per-rank aux loss differ from tp = 1's:
    granite at capacity factor 0.5 with its aux loss is held against the
    reference's own tp = 2 gradient.  Each rank's loss is its own (the
    aux term differs between the ranks); the reference returns device
    0's."""
    parts = _parts(ranks, ("moe_drop_aux", R.DROP_MESH))
    assert len(parts) == 2
    assert float(parts[(0, 0)]["loss"]) != float(parts[(0, 1)]["loss"])
    want = float(sharded_reference["loss"])
    assert abs(float(parts[(0, 0)]["loss"]) - want) <= TOL_LOSS * want
    n = len(tree.leaves(parts[(0, 0)]["grads"]))
    _close(parts[(0, 0)]["grads"], [sharded_reference[f"g{i}"]
                                    for i in range(n)])


@functools.lru_cache(maxsize=None)
def _ref_step(optimizer, compression, micro):
    """The reference's composition at tp = 1: the gradient (each
    microbatch's, averaged), compression, ``apply_updates``."""
    params = _global_params(R.STEP_ARCH)
    batch = R.train_batch(R.train_config(R.STEP_ARCH))
    vg = _ref_value_and_grad(R.STEP_ARCH)
    n = R.TRAIN_B // micro
    outs = [vg(params, {k: jnp.asarray(v[i * n:(i + 1) * n])
                        for k, v in batch.items()}) for i in range(micro)]
    grads = jax.tree.map(lambda *g: sum(g) / micro, *[o[1] for o in outs])
    loss = float(np.mean([float(o[0]) for o in outs]))
    rt = RefTrainConfig(optimizer=optimizer, **R.STEP_TCFG)
    state = RO.init_opt_state(params, rt, compression)
    if compression:
        qs, scales, err = RO.compress_gradients(grads, state.err)
        grads = RO.decompress_gradients(qs, scales)
        state = state._replace(err=err)
    new_p, new_s, metrics = RO.apply_updates(params, grads, state, rt)
    return loss, new_p, new_s, float(metrics["grad_norm"])


def _step_close(port_tree, ref_tree, moments=None, share=0.0):
    """Each leaf within TOL_STEP of its largest |value| (plus 1e-6),
    except a ``share`` of its elements (int8 compression: a gradient on a
    rounding edge takes the next code on one side).  With ``moments``
    (AdamW's first moments, the reference's), a param is held only
    where its gradient is above 1e-4 of the leaf's largest: the first
    AdamW step moves a param by lr times g / |g|, whose sign the float32
    noise sets where g is nearly zero (there both moves stay within 2.5
    lr of each other, checked too)."""
    pl = tree.leaves_with_paths(port_tree)
    rl = jax.tree.leaves(ref_tree)
    ml = jax.tree.leaves(moments) if moments is not None else [None] * len(rl)
    assert len(pl) == len(rl) == len(ml)
    for (path, a), b, m in zip(pl, rl, ml):
        a = a.detach().double().numpy()
        b = np.asarray(b, np.float64)
        if not b.size:
            continue
        diff = np.abs(a - b)
        bound = TOL_STEP * float(np.max(np.abs(b))) + 1e-6
        if m is not None or share:
            assert float(np.max(diff)) <= 2.5 * R.STEP_TCFG["lr"] or (
                m is None and float(np.mean(diff > bound)) <= share), path
        if m is not None:
            m = np.abs(np.asarray(m, np.float64))
            diff = diff[m > 1e-4 * float(np.max(m))]
        assert float(np.mean(diff > bound)) <= share, (path, bound,
                                                      float(np.max(diff)))


@pytest.mark.parametrize("case", R.STEP_CASES,
                         ids=lambda c: f"{c[0]}-{'int8' if c[1] else 'f32'}"
                                       f"-mb{c[2]}")
def test_one_step_on_2x2_matches_reference_composition(case, ranks):
    parts = _parts(ranks, ("step",) + case)
    assert len(parts) == 4
    loss, ref_p, ref_s, gnorm = _ref_step(*case)
    first = _first(parts)
    assert abs(float(first["loss"]) - loss) <= TOL_LOSS * loss
    assert gnorm > R.STEP_TCFG["grad_clip"]  # the clip binds
    assert abs(float(first["grad_norm"]) - gnorm) <= 1e-4 * gnorm
    share = STEP_SHARE_INT8 if case[1] else 0.0
    _step_close(first["params"], ref_p,
                ref_s.m if case[0] == "adamw" else None, share)
    _step_close(first["state"], ref_s, share=share)
    # every rank holds its zero_spec_for slice of each moment and residual
    prog_plan = ShardingPlan.for_model(R.train_config(R.STEP_ARCH), tp=2,
                                       dp_axes=("data",))
    optimizer, compression, _ = case
    specs, opt_specs, _, _, _ = train_specs(
        R.train_config(R.STEP_ARCH), prog_plan,
        ParallelConfig(grad_compression=compression),
        TrainConfig(optimizer=optimizer), {"data": 2, "model": 2})
    want = {p: s for p, s in tree.leaves_with_paths(opt_specs)}
    glob = {p: tuple(t.shape)
            for p, t in tree.leaves_with_paths(first["state"])}
    for coords, res in parts.items():
        cd = {"data": (coords[0], 2), "model": (coords[1], 2)}
        for path, shape in res["state_shapes"].items():
            spec = want[path]
            expect = tuple(n // _n_parts(e, cd) for n, e in zip(glob[path],
                                                                spec))
            assert shape == expect, (coords, path, shape, expect)
    sliced = [p for p, s in want.items()
              if any(e is not None for e in s.dims)]
    assert any("data" in str(want[p].dims) for p in sliced)


def _n_parts(entry, coords):
    n = 1
    for a in partition.entry_axes(entry):
        n *= coords[a][1]
    return n


@pytest.mark.parametrize("arch", R.ZERO3_ARCHS)
def test_zero3_matches_the_baseline_on_2x2(arch, ranks):
    parts = {r[("zero3", arch)]["coords"]: r[("zero3", arch)] for r in ranks}
    first = _first(parts)
    base, z3 = first["base"], first["zero3"]
    assert z3["zero3"], "no ZeRO-3 leaf"
    assert torch.equal(base["loss"], z3["loss"])
    for (path, a), (_, b) in zip(tree.leaves_with_paths(base["grads"]),
                                 tree.leaves_with_paths(z3["grads"])):
        assert torch.equal(a, b), path
    for name in ("params", "state"):
        for (path, a), (_, b) in zip(tree.leaves_with_paths(base[name]),
                                     tree.leaves_with_paths(z3[name])):
            if a.is_floating_point() and a.numel():
                err = float((a.double() - b.double()).abs().max())
                assert err <= TOL_ZERO3 * float(a.abs().max()), (path, err)
            else:
                assert torch.equal(a, b), path
    if arch == "granite-moe-3b-a800m":  # a stacked leaf gathers on dim 1
        assert any(full == used + 1 for full, used in z3["zero3"].values())
    glob = {p: tuple(t.shape)
            for p, t in tree.leaves_with_paths(base["params"])}
    for coords, res in parts.items():
        for path, (dim, _) in res["zero3"]["zero3"].items():
            shape = res["zero3"]["shapes"][path]
            base_shape = res["base"]["shapes"][path]
            assert shape[dim] * 2 == base_shape[dim] == glob[path][dim], (
                coords, path)


def test_dp_only_grads_match_tp1_and_its_plan_the_reference(ranks):
    parts = _parts(ranks, "dp_only")
    assert len(parts) == 4
    loss, grads = _ref_loss_grad(R.STEP_ARCH)
    for p in parts.values():
        assert abs(float(p["loss"]) - loss) <= TOL_LOSS * loss
    _close(_first(parts)["grads"], jax.tree.leaves(grads))
    from repro.runtime.train_loop import make_plan as ref_make_plan
    from repro_torch.runtime.train_loop import make_plan
    from test_torch_serve_tp import _fake_mesh

    fake = SimpleNamespace(axis_names=("data", "model"),
                           devices=SimpleNamespace(shape=(2, 2)))
    for arch in ASSIGNED_ARCHS:
        for dp_only in (True, False):
            want = ref_make_plan(ref_config(arch), fake,
                                 RefParallel(dp_only=dp_only, zero3=True))
            got = make_plan(get_config(arch), _fake_mesh((2, 2), (0, 0)),
                            ParallelConfig(dp_only=dp_only, zero3=True))
            for f in dataclasses.fields(want):
                assert getattr(got, f.name) == getattr(want, f.name), (
                    arch, f.name)


def test_serving_dp_only_on_2x2_equals_tp1(ranks):
    """``dp_only`` serves at tp = 1 with the batch over both axes (one
    row a rank) and ``seq_cache`` off, as the reference's ``make_plan``
    says; each rank's logits are its row of the tp = 1 run's."""
    from repro_torch.runtime.serve_loop import build_serve_program

    parts = _parts(ranks, "serve_dp_only")
    assert len(parts) == 4
    cfg = R.port_config(R.DP_ONLY_SERVE_ARCH)
    prog = build_serve_program(cfg, R.SERVE_B, R.S_MAX, device="cpu")
    batch, _ = R.serve_inputs(cfg)
    with torch.no_grad():
        want, _ = prog.prefill_fn(R.global_params(cfg), batch)
    for (d, m), res in parts.items():
        assert res["tp"] == 1 and res["rows"] == 1 and not res["seq_cache"]
        row = d * 2 + m
        np.testing.assert_allclose(res["logits"].numpy(),
                                   want[row:row + 1].numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_elastic_restore_continues_the_run(ranks, sharded_reference):
    results = [r["elastic"] for r in ranks]
    assert all(r["dropped"] == [] for r in results)
    first = results[0]
    assert first["shape"] == (1, 2) and first["step"] == 1
    for (path, a), (_, b) in zip(tree.leaves_with_paths(first["got"]),
                                 tree.leaves_with_paths(first["want"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=path)
    from repro_torch.runtime.fault import remesh_shape

    for n in range(1, 9):
        for mp in (1, 2, 4, 16):
            data, model, dropped = sharded_reference[f"remesh-{n}-{mp}"]
            assert remesh_shape(n, mp) == (data, model)
            assert n - data * model == dropped


@pytest.mark.parametrize("mesh_shape", [(2, 4), (2, 2)])
@pytest.mark.parametrize("arch", R.FAMILIES)
def test_zero_and_zero3_specs_match_reference(arch, mesh_shape):
    """``zero_spec_for`` of every param leaf and ``_zero3_plan`` on the
    full config's global shapes (ZeRO-3 on, ``zero_axes`` both axes),
    against the reference's.  The encoder-decoder's stacks are consumed
    a layer at a time: the port counts their gather dim from the
    second, one below the reference's (ROADMAP R6)."""
    from repro.runtime.partition import derive_specs as ref_derive
    from repro.runtime.train_loop import _zero3_plan as ref_zero3

    d, m = mesh_shape
    rcfg, pcfg = ref_config(arch), get_config(arch)
    rplan = RefPlan.for_model(rcfg, tp=m, dp_axes=("data",))
    init = RE.init_params if rcfg.is_encdec else RT.init_params
    key = jax.random.PRNGKey(0)
    g = jax.eval_shape(lambda: init(key, rcfg, rplan.as_global()))
    l = jax.eval_shape(lambda: init(key, rcfg, rplan))
    rspecs = ref_derive(g, l, m)
    want_z3 = ref_zero3(rcfg, g, rspecs, rplan, d)
    saved = dict(RO._AXIS_SIZES)
    RO.set_axis_sizes({"data": d, "model": m})
    try:
        flat = jax.tree_util.tree_flatten_with_path(g)[0]
        rflat = jax.tree.leaves(rspecs, is_leaf=lambda s: isinstance(s, P))
        want_z = []
        for (path, leaf), spec in zip(flat, rflat):
            name = "/".join(str(p) for p in path)
            entries = list(spec) + [None] * (leaf.ndim - len(spec))
            if name in want_z3:
                entries[want_z3[name][0]] = "data"
            want_z.append(tuple(RO.zero_spec_for(P(*entries), leaf.shape,
                                                 ("data", "model"))))
    finally:
        RO._AXIS_SIZES.clear()
        RO._AXIS_SIZES.update(saved)
    plan = ShardingPlan.for_model(pcfg, tp=m, dp_axes=("data",))
    _, _, layouts, z3, _ = train_specs(pcfg, plan, ParallelConfig(zero3=True),
                                       TrainConfig(), {"data": d, "model": m})
    got_z = [lay.zspec.dims for lay in tree.leaves(layouts)]
    assert got_z == [w + (None,) * (len(g_) - len(w))
                     for w, g_ in zip(want_z, got_z)]
    assert sorted(z3) == sorted(want_z3)
    for name, (full, used) in want_z3.items():
        layered = rcfg.is_encdec and name.startswith(
            ("['encoder']", "['decoder']"))
        assert z3[name] == (full, used - 1 if layered else used), name
    assert want_z3


def test_train_cli_on_a_mesh_resumes_on_another(tmp_path, capfd):
    """``python -m repro_torch.launch.train --tp 2 --dp 2`` on CPU ranks
    for 2 steps (float32, SGD with momentum), a checkpoint after each;
    its step-2 checkpoint set aside, ``--resume`` on ``--tp 2 --dp 1``
    continues from step 1 and ends on the uninterrupted run's params
    within ``TOL_CLI``.  Each leaf of the resumed run is further than
    that from the step-1 checkpoint, so a resume that skipped its step,
    or stepped without the restored momentum or on another batch, fails."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch.train import main

    args = ["--arch", "gemma3-1b", "--device", "cpu", "--steps", "2",
            "--batch", "4", "--seq", "16", "--backend", "gloo",
            "--dtype", "float32", "--optimizer", "sgd",
            "--lr", str(CLI_LR), "--ckpt-dir", str(tmp_path / "ck")]
    assert main(args + ["--tp", "2", "--dp", "2", "--ckpt-every", "1"]) == 0
    (tmp_path / "ck" / "step_2").rename(tmp_path / "full_2")
    assert main(args + ["--tp", "2", "--dp", "1", "--resume"]) == 0
    assert "resumed from step 1" in capfd.readouterr().out
    cfg = dataclasses.replace(get_config("gemma3-1b").reduced(),
                              dtype="float32")
    prog = build_train_program(cfg, ParallelConfig(),
                               TrainConfig(optimizer="sgd"), device="cpu")
    params, state = prog.init_fn(0)
    template = {"opt_state": state, "params": params}
    mgr = CheckpointManager(str(tmp_path / "ck"))
    got, at = mgr.restore(template)
    assert at == 2
    before, _ = mgr.restore(template, step=1)
    os.makedirs(tmp_path / "ref")
    (tmp_path / "full_2").rename(tmp_path / "ref" / "step_2")
    want, _ = CheckpointManager(str(tmp_path / "ref")).restore(template)
    for (path, a), (_, b), (_, c) in zip(
            tree.leaves_with_paths(got["params"]),
            tree.leaves_with_paths(want["params"]),
            tree.leaves_with_paths(before["params"])):
        a, b, c = a.numpy(), b.numpy(), c.numpy()
        tol = TOL_CLI * float(np.max(np.abs(b)))
        np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=path)
        assert float(np.max(np.abs(a - c))) > 100 * tol, path


def test_dry_run_counts_each_ranks_real_step(ranks):
    """Each rank of the (2, 2) ring mesh counted one real AdamW step of
    gemma3 under ``OpStats``: its flops (all, and by the dtype of their
    peak: the backward's float32 products), HBM bytes, wire bytes and
    collectives equal the dry run's of the same cell and rank (a
    functional step, as the rank ran it)."""
    from repro_torch.configs.base import ParallelConfig, ShapeConfig, \
        TrainConfig
    from repro_torch.launch.dryrun_lib import dry_cell

    counted = [r["counted"] for r in ranks]
    assert sorted(c["rank"] for c in counted) == [0, 1, 2, 3]
    for real in counted:
        dry = dry_cell(R.STEP_ARCH,
                       ShapeConfig("counted", R.TRAIN_S, R.TRAIN_B, "train"),
                       (2, 2), cfg=R.train_config(R.STEP_ARCH),
                       pcfg=ParallelConfig(reduction="ring", remat="full"),
                       tcfg=TrainConfig(**R.STEP_TCFG), rank=real["rank"],
                       device="cpu", donate=False).stats
        assert real["wire_bytes"] > 0
        assert (dry.flops, dry.flops_by_dtype, dry.hbm_bytes, dry.wire_bytes,
                dry.op_counts) == (
            real["flops"], real["flops_by_dtype"], real["hbm_bytes"],
            real["wire_bytes"], real["op_counts"]), real["rank"]
        assert dry.op_counts["reduce-scatter"] > 0
        assert dry.flops_by_dtype["float32"] > 0
