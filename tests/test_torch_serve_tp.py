"""Port parity: serving at tp > 1 on gloo CPU ranks against the JAX
reference at tp = 1 on the same global params, float32.

One spawn of 4 ranks (``tests/torch_tp_ranks.py::serve_cases``) serves
every family's reduced config (gemma3-1b: the group trick, 4 heads on
one kv head; qwen2-0.5b: QKV bias; granite-moe-3b-a800m: MoE;
falcon-mamba-7b: Mamba; jamba-v0.1-52b: the hybrid; deepseek-v3-671b:
MLA + MoE; seamless-m4t-large-v2: the encoder-decoder; internvl2-2b:
the vit_stub frontend) at tp = 2 on three meshes: (1, 2) with the ring
reduction, (1, 2) with the all-reduce baseline, and (2, 2) (the data
axis splits the batch).  Each rank takes its shard of the global params
(``convert.shard_lm_params``) and its rows of the batch; the prompt
(12 tokens, longer than gemma3's window ring) is prefilled and two
decode steps are fed fixed tokens.  Four families also run with int8
weights and the int8 KV cache on the (1, 2) meshes: the global params
quantized as the reference quantizes them, then sharded.  The reference runs ``prefill`` /
``decode_step`` at tp = 1 with the same params (``convert.to_reference``
of the port's draws, norms and biases non-zero) and tokens.  The MoE
families' capacity factor (4.0 in the reduced configs) drops no pair at
either tp, and the ranks count their dropped pairs: zero, so per-rank
routing computes what tp = 1 computes.  Where pairs drop (granite at
capacity factor 0.5 on (1, 2)), the ranks are held against the
reference's own tp = 2 run under ``shard_map``, on 8 virtual CPU devices
in a subprocess.

At tp = 4 on a (1, 4) mesh: test_seq_cache.py's qwen2 variant with
H = 6, KV = 2 (heads do not divide tp: replicated attention, the
sequence-sharded cache padded from 15 to 16 positions, the
log-sum-exp merged decode), with the bfloat16-flavoured and the int8 KV
cache; and the MoE block with padded experts (granite with 6 experts,
E_total 8) and a capacity factor of 0.5, so pairs drop.  Routing,
capacity and dropping are per rank, so the block is held against the
reference's ``moe_forward`` at tp = 1 with ``experts_pad`` = 2 applied
to each rank's token chunk alone: the all_to_all only moves rows, so
this oracle is exact where pairs drop.

Without ranks: ``derive_specs`` on every family's global and local meta
trees against the reference's ``derive_specs`` on its ``eval_shape``
trees, and ``ShardingPlan.for_model`` against the reference's for every
config at tp 2, 4 and 16.

Tolerances: logits rtol = atol = 1e-4 (both sides sum in other orders
in float32); 2e-3 for decode logits over the int8 KV cache, where a
value on a rounding edge can flip one code (as ``test_torch_lm.py``);
1e-4 for the MoE block.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

import torch_tp_ranks as R  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import encdec as RE  # noqa: E402
from repro.models import moe as RM  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.models.common import ShardingPlan as RefPlan  # noqa: E402
from repro.runtime.partition import derive_specs as ref_derive  # noqa: E402
from repro.runtime.serve_loop import (  # noqa: E402
    quantize_params_for_serving as ref_quantize,
)
from repro_torch.configs import ASSIGNED_ARCHS, get_config  # noqa: E402
from repro_torch.convert import to_reference  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.models import encdec as ED  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.common import ShardingPlan  # noqa: E402
from repro_torch.runtime import partition  # noqa: E402
from repro_torch.runtime.serve_loop import _meta_params  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

TOL = 1e-4
TOL_INT8_KV = 2e-3


def _ref_cfg(arch, var=None):
    cfg = dataclasses.replace(ref_config(arch).reduced(), dtype="float32")
    return R.variant(cfg, var) if var else cfg


def _ref_layout(params, cfg):
    """The port's serving params in the reference's stacked layout, as
    numpy."""
    if cfg.is_encdec:
        return to_reference(ED.stack_layers(params))
    return to_reference(T.stack_layers(params, cfg))


def _reference_run(arch, var=None, kv_dtype="bfloat16", cim=False):
    """The reference at tp = 1: prefill logits and the decode steps'
    (``cim``: its params quantized by ``quantize_params_for_serving``
    with no size floor)."""
    rcfg, pcfg = _ref_cfg(arch, var), R.port_config(arch, var)
    params = _ref_layout(R.global_params(pcfg), pcfg)
    if cim:
        params = jax.tree.map(np.asarray, ref_quantize(params, 1))
    batch, steps = R.serve_inputs(pcfg)
    batch = {k: v.numpy() for k, v in batch.items()}
    steps = steps.numpy()
    plan = RefPlan.for_model(rcfg, tp=1)
    if rcfg.is_encdec:
        logits, caches = jax.jit(functools.partial(
            RE.prefill, cfg=rcfg, plan=plan, kv_dtype=kv_dtype,
            s_max=R.S_MAX))(params, batch)
        decode = functools.partial(RE.decode_step, cfg=rcfg, plan=plan,
                                   kv_dtype=kv_dtype)
    else:
        extras = {k: v for k, v in batch.items() if k != "tokens"} or None
        logits, caches = jax.jit(functools.partial(
            RT.prefill, cfg=rcfg, plan=plan, kv_dtype=kv_dtype,
            s_max=R.S_MAX))(params, batch["tokens"], extras=extras)
        decode = functools.partial(RT.decode_step, cfg=rcfg, plan=plan,
                                   kv_dtype=kv_dtype)
    out = [np.asarray(logits)]
    decode = jax.jit(decode)
    for i in range(R.STEPS):
        logits, caches = decode(params, jnp.asarray(steps[:, i]), caches,
                                jnp.int32(R.PROMPT + i))
        out.append(np.asarray(logits))
    return out


SHARDED_REFERENCE = r"""
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
sys.path.insert(0, sys.argv[2])
import torch_tp_ranks as R
from repro.configs import get_config
from repro.configs.base import ParallelConfig
from repro.runtime.serve_loop import build_serve_program
from repro_torch.convert import to_reference
from repro_torch.models import transformer as T

arch, var = "granite-moe-3b-a800m", "moe_drop"
pcfg = R.port_config(arch, var)
rcfg = R.variant(dataclasses.replace(get_config(arch).reduced(),
                                     dtype="float32"), var)
params = to_reference(T.stack_layers(R.global_params(pcfg), pcfg))
batch, steps = R.serve_inputs(pcfg)
axis_type = getattr(jax.sharding, "AxisType", None)
devices = np.array(jax.devices()[:2]).reshape(1, 2)
mesh = (Mesh(devices, ("data", "model"), axis_types=(axis_type.Auto,) * 2)
        if axis_type is not None else Mesh(devices, ("data", "model")))
prog = build_serve_program(rcfg, mesh, ParallelConfig(reduction="ring"),
                           batch=R.SERVE_B, s_max=R.S_MAX)
logits, caches = jax.jit(prog.prefill_fn)(
    params, {"tokens": batch["tokens"].numpy()})
out = [np.asarray(logits)]
decode = jax.jit(prog.decode_fn)
for i in range(R.STEPS):
    logits, caches = decode(params, jnp.asarray(steps[:, i].numpy()), caches,
                            jnp.int32(R.PROMPT + i))
    out.append(np.asarray(logits))
np.savez(sys.argv[1], *out)
"""


@pytest.fixture(scope="module")
def sharded_reference(tmp_path_factory):
    """The reference's own tp = 2 serving of granite with dropping
    capacity (``build_serve_program`` under ``shard_map``), on 2 of 8
    virtual CPU devices in a subprocess (the flag must be set before jax
    starts)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    path = tmp_path_factory.mktemp("sharded_ref") / "logits.npz"
    env = dict(os.environ, PYTHONPATH=str(root / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.run(
        [sys.executable, "-c", SHARDED_REFERENCE, str(path),
         str(root / "tests")], env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(path) as f:
        return [f[f"arr_{i}"] for i in range(len(f.files))]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn(R.serve_cases, 4,
                 tmp_dir=str(tmp_path_factory.mktemp("serve_tp_ranks")))


def _case(ranks, key):
    """{coords: result} of one case's ranks."""
    return {r[key]["coords"]: r[key] for r in ranks if key in r}


def _global_logits(parts, step, vocab):
    """The global (B, V) logits of one step: rows by data coordinate;
    every model rank of a row must return the same logits."""
    n_data = 1 + max(d for d, _ in parts)
    n_model = 1 + max(m for _, m in parts)
    rows = []
    for d in range(n_data):
        first = parts[(d, 0)]["logits"][step]
        for m in range(1, n_model):
            assert torch.equal(parts[(d, m)]["logits"][step], first), (d, m)
        rows.append(first.numpy())
    return np.concatenate(rows, axis=0)[:, :vocab]


def _check_logits(parts, want, vocab, decode_tol=TOL):
    for step, w in enumerate(want):
        tol = TOL if step == 0 else decode_tol
        np.testing.assert_allclose(
            _global_logits(parts, step, vocab), w[:, :vocab], rtol=tol,
            atol=tol, err_msg=f"step {step}")


@pytest.fixture(scope="module")
def reference_runs():
    return {}


def _ref(reference_runs, arch, var=None, kv_dtype="bfloat16", cim=False):
    key = (arch, var, kv_dtype, cim)
    if key not in reference_runs:
        reference_runs[key] = _reference_run(arch, var, kv_dtype, cim)
    return reference_runs[key]


@pytest.mark.parametrize("mesh", sorted(R.MESHES))
@pytest.mark.parametrize("arch", R.FAMILIES)
def test_family_at_tp2_matches_reference_at_tp1(arch, mesh, ranks,
                                                reference_runs):
    parts = _case(ranks, (arch, mesh))
    assert len(parts) == len(R.MESHES[mesh][1])
    assert all(p["drops"] == 0 for p in parts.values())
    cfg = R.port_config(arch)
    want = _ref(reference_runs, arch)
    assert want[0].shape[1] == cfg.vocab_size  # reduced vocab: no padding
    _check_logits(parts, want, cfg.vocab_size)


@pytest.mark.parametrize("arch,mesh", [
    (arch, mesh) for mesh, archs in sorted(R.CIM_FAMILIES.items())
    for arch in archs])
def test_int8_weights_and_cache_at_tp2_match_reference(arch, mesh, ranks,
                                                       reference_runs):
    """int8 weights: the global params quantized (a column's scale over
    all its rows, as the reference quantizes its global params), then
    codes and scales sharded; with the int8 KV cache."""
    parts = _case(ranks, (arch, mesh, "cim"))
    assert len(parts) == 2
    cfg = R.port_config(arch)
    want = _ref(reference_runs, arch, kv_dtype="int8", cim=True)
    _check_logits(parts, want, cfg.vocab_size, TOL_INT8_KV)


def test_dropping_moe_at_tp2_matches_the_references_sharded_run(
        ranks, sharded_reference):
    """Where pairs drop, per-rank capacity drops other pairs than tp = 1
    does: granite at capacity factor 0.5 on (1, 2) is held against the
    reference's own tp = 2 run instead, prefill and both decode steps."""
    parts = _case(ranks, ("moe_drop", R.DROP_MESH))
    assert len(parts) == 2
    assert all(p["drops"] > 0 for p in parts.values())
    cfg = R.port_config("granite-moe-3b-a800m", "moe_drop")
    _check_logits(parts, sharded_reference, cfg.vocab_size)


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_sequence_sharded_cache_at_tp4(kv_dtype, ranks, reference_runs):
    cfg = R.port_config("qwen2-0.5b", "seq_cache")
    plan = ShardingPlan.for_model(cfg, tp=4)
    assert not plan.attn_sharded
    parts = _case(ranks, ("seq_cache", kv_dtype))
    assert len(parts) == 4
    want = _ref(reference_runs, "qwen2-0.5b", "seq_cache", kv_dtype)
    _check_logits(parts, want, cfg.vocab_size,
                  TOL_INT8_KV if kv_dtype == "int8" else TOL)


def test_padded_dropping_moe_block_matches_per_chunk_oracle(ranks):
    rcfg = _ref_cfg("granite-moe-3b-a800m", "moe_pad")
    pcfg = R.port_config("granite-moe-3b-a800m", "moe_pad")
    results = [r["moe_pad"] for r in ranks]
    assert all(r["experts_pad"] == 2 for r in results)
    assert sum(r["drops"] for r in results) > 0
    gen = torch.Generator().manual_seed(3)
    from repro_torch.models import moe as moe_mod

    full = moe_mod.init_moe(gen, pcfg, ShardingPlan(tp=1, experts_pad=2),
                            torch.float32)
    params = to_reference(full)
    x = R.moe_pad_input(pcfg).numpy()
    chunk = R.MOE_S // R.MOE_PAD_TP
    plan = RefPlan(tp=1, experts_pad=2)
    for i, res in enumerate(results):
        want, _ = RM.moe_forward(params, x[:, i * chunk:(i + 1) * chunk],
                                 rcfg, plan)
        np.testing.assert_allclose(res["out"].numpy(), np.asarray(want),
                                   rtol=TOL, atol=TOL, err_msg=f"rank {i}")


def _port_specs_ref_layout(cfg, tp):
    """The port's param specs at ``tp`` in the reference's stacked
    layout: a leaf stacked over a segment's repeats (or an
    encoder-decoder stack's layers) gains a leading None."""
    plan = ShardingPlan.for_model(cfg, tp=tp)
    specs = partition.derive_specs(_meta_params(cfg, plan.as_global()),
                                   _meta_params(cfg, plan), tp)

    def lead(tree):
        if isinstance(tree, dict):
            return {k: lead(v) for k, v in tree.items()}
        return partition.Spec((None,) + tree.dims)

    if cfg.is_encdec:
        out = dict(specs)
        for name in ("encoder", "decoder"):
            layers = specs[name]
            assert all(l == layers[0] for l in layers)
            out[name] = lead(layers[0])
        return out
    layers = iter(specs["layers"])
    segments = []
    for seg in T.build_segments(cfg):
        cycles = [[next(layers) for _ in seg.cycle]
                  for _ in range(seg.count)]
        assert all(c == cycles[0] for c in cycles)
        segments.append(cycles[0] if seg.count == 1
                        else [lead(c) for c in cycles[0]])
    out = {k: v for k, v in specs.items() if k != "layers"}
    out["segments"] = segments
    return out


@pytest.mark.parametrize("arch", R.FAMILIES)
def test_derive_specs_match_reference(arch):
    rcfg, pcfg = _ref_cfg(arch), R.port_config(arch)
    rplan = RefPlan.for_model(rcfg, tp=2)
    init = RE.init_params if rcfg.is_encdec else RT.init_params
    key = jax.random.PRNGKey(0)
    g = jax.eval_shape(lambda: init(key, rcfg, rplan.as_global()))
    l = jax.eval_shape(lambda: init(key, rcfg, rplan))
    want = [tuple(s) for s in jax.tree.leaves(
        ref_derive(g, l, 2), is_leaf=lambda s: isinstance(s, P))]
    got = [s.dims for s in leaves(_port_specs_ref_layout(pcfg, 2))]
    assert got == want
    assert any("model" in s for s in got)


@pytest.mark.parametrize("tp", [2, 4, 16])
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_plan_fields_match_reference(arch, tp):
    want = RefPlan.for_model(ref_config(arch), tp=tp, dp_axes=("data",),
                             reduction="allreduce")
    got = ShardingPlan.for_model(get_config(arch), tp=tp, dp_axes=("data",),
                                 reduction="allreduce")
    for f in dataclasses.fields(want):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


def test_derive_specs_refuses_an_unshardable_pair():
    """A dim that is neither equal nor tp times the local one raises, as
    the reference's does."""
    from repro.runtime.partition import derive_specs as ref

    g, l = {"w": torch.empty(6, 4, device="meta")}, \
        {"w": torch.empty(4, 4, device="meta")}
    with pytest.raises(ValueError, match="unshardable"):
        partition.derive_specs(g, l, 2)
    with pytest.raises(ValueError, match="unshardable"):
        ref({"w": jax.ShapeDtypeStruct((6, 4), jnp.float32)},
            {"w": jax.ShapeDtypeStruct((4, 4), jnp.float32)}, 2)


@pytest.mark.parametrize("batch", [4, 3, 1])
def test_batch_specs_match_reference(batch):
    """The batch dim over the data axis where it divides it, else
    replicated (the reference's ``_batch_pspec``)."""
    from repro.runtime.train_loop import _batch_pspec

    shapes = {"tokens": torch.empty(batch, 8, device="meta"),
              "frames": torch.empty(batch, 8, 5, device="meta")}
    got = partition.batch_specs(shapes, ("data",), 2)
    want = _batch_pspec({k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.int32)
                         for k, v in shapes.items()},
                        RefPlan(tp=1, dp_axes=("data",)), dp_size=2)
    assert {k: s.dims for k, s in got.items()} == {
        k: tuple(v) + (None,) * (shapes[k].dim() - len(tuple(v)))
        for k, v in want.items()}


def test_shard_tree_cuts_each_rank_its_part():
    """Every (data, model) coordinate's part of a global tensor, the
    parts tiling it."""
    t = torch.arange(4 * 6 * 8).reshape(4, 6, 8)
    spec = partition.Spec(("data", None, "model"))
    rows = []
    for d in range(2):
        cols = [partition.shard_leaf(t, spec, {"data": (d, 2),
                                               "model": (m, 4)})
                for m in range(4)]
        assert all(c.shape == (2, 6, 2) for c in cols)
        rows.append(torch.cat(cols, dim=2))
    assert torch.equal(torch.cat(rows), t)
    assert partition.shard_leaf(t, partition.Spec((None,) * 3),
                                {"data": (1, 2)}) is t


def _fake_mesh(shape, coords):
    """A mesh as one rank sees it, with no process groups: enough for
    the shapes and specs a serve program derives (no collective runs)."""
    from repro_torch.launch.mesh import Mesh, MeshAxis

    (n_d, n_m), (d, m) = shape, coords
    return Mesh(shape=shape, coords=coords, backend="gloo", host_copies=False,
                data=MeshAxis("data", n_d, d, tuple(range(n_d)), "gloo",
                              False),
                model=MeshAxis("model", n_m, m, tuple(range(n_m)), "gloo",
                               False))


@pytest.mark.parametrize("arch,var,shape", [
    (arch, None, (2, 2)) for arch in R.FAMILIES] + [
    ("qwen2-0.5b", "seq_cache", (2, 4))])
def test_cache_specs_cut_global_caches_to_each_rank(arch, var, shape):
    """``convert.shard_lm_caches`` by a program's ``cache_specs`` cuts the
    global caches (``init_cache`` of the global plan) to each rank's
    shapes: the batch over the data axis, heads (or the group trick's
    head, or the sequence-sharded cache's chunk) over the model axis."""
    from repro_torch.convert import shard_lm_caches
    from repro_torch.runtime.serve_loop import (_meta_caches,
                                                build_serve_program)

    cfg = R.port_config(arch, var)
    for kv in ("bfloat16", "int8"):
        for d in range(shape[0]):
            for m in range(shape[1]):
                mesh = _fake_mesh(shape, (d, m))
                prog = build_serve_program(cfg, 4, R.S_MAX, kv_dtype=kv,
                                           device="cpu", mesh=mesh)
                glob = _meta_caches(cfg, prog.plan.as_global(), 4, R.S_MAX,
                                    kv)
                want = _meta_caches(cfg, prog.plan, prog.batch_local,
                                    R.S_MAX, kv)
                got = shard_lm_caches(glob, prog.cache_specs,
                                      mesh.coords_dict())
                assert [tuple(t.shape) for t in leaves(got)] == \
                    [tuple(t.shape) for t in leaves(want)]
    dims = {d for s in leaves(prog.cache_specs) for d in s.dims}
    assert "data" in dims
    # MLA's latent cache is whole on every rank; every other family's
    # cache shards over the model axis
    assert ("model" in dims) == (arch != "deepseek-v3-671b")


@pytest.mark.parametrize("arch", ["internvl2-2b", "seamless-m4t-large-v2"])
def test_padded_vocabulary_draws_the_weights_of_tp1(arch):
    """A vocabulary that pads at tp 2: each rank's ``init_params`` keeps
    its shard of the tp = 1 draws, the padded rows (embedding) and
    columns (head) zero, and every later draw (``frontend_proj``) is
    tp = 1's too.  No collective runs."""
    from repro_torch.runtime.serve_loop import build_serve_program

    cfg = R.port_config(arch)
    cfg = dataclasses.replace(cfg, vocab_size=cfg.vocab_size | 1)
    v = cfg.vocab_size
    want = build_serve_program(cfg, 2, R.S_MAX, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    ranks = [build_serve_program(
        cfg, 2, R.S_MAX, device="cpu",
        mesh=_fake_mesh((1, 2), (0, m))).init_params(
            torch.Generator().manual_seed(0)) for m in range(2)]
    names = ["embed"] + (["head"] if "head" in want else [])
    for name, dim in zip(names, (0, 1)):
        got = torch.cat([r[name] for r in ranks], dim=dim)
        assert got.shape[dim] == v + 1
        assert torch.equal(got.narrow(dim, 0, v), want[name])
        assert not got.narrow(dim, v, 1).any()
    for r in ranks:
        assert torch.equal(r["frontend_proj"], want["frontend_proj"])


def test_dry_run_counts_each_ranks_real_prefill(ranks):
    """Each rank of the (2, 2) ring mesh counted one real prefill of
    granite (MoE: the all_to_all, the ring matmuls) under ``OpStats``:
    its flops (all, and by the dtype of their peak), HBM bytes, wire
    bytes and collectives equal the dry run's of the same cell and rank,
    on fake tensors over a fake process group."""
    from repro_torch.configs.base import ParallelConfig, ShapeConfig
    from repro_torch.launch.dryrun_lib import dry_cell

    counted = [r[("counted", "2x2-ring")] for r in ranks]
    assert sorted(c["rank"] for c in counted) == [0, 1, 2, 3]
    cfg = R.port_config(R.COUNTED_SERVE_ARCH)
    for real in counted:
        dry = dry_cell(R.COUNTED_SERVE_ARCH,
                       ShapeConfig("counted", R.PROMPT, R.SERVE_B, "prefill"),
                       (2, 2), cfg=cfg, pcfg=ParallelConfig(reduction="ring"),
                       rank=real["rank"], device="cpu", s_max=R.S_MAX).stats
        assert real["wire_bytes"] > 0
        assert (dry.flops, dry.flops_by_dtype, dry.hbm_bytes, dry.wire_bytes,
                dry.op_counts) == (
            real["flops"], real["flops_by_dtype"], real["hbm_bytes"],
            real["wire_bytes"], real["op_counts"]), real["rank"]
        assert "all-to-all" in dry.op_counts
