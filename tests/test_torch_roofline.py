"""Port parity: the pure pieces of the dry-run tooling against the JAX
reference (``repro/analysis/roofline.py``, ``repro/analysis/report.py``,
``repro/launch/dryrun_lib.py``, ``repro/launch/inputs.py``).

* ``model_flops`` for every config and every ``SHAPES`` entry;
* ``auto_microbatches``, ``train_config_for`` and ``parallel_config_for``
  for every config and shape on the production meshes: (16, 16), and the
  multi-pod (2, 16, 16) that the port folds into (32, 16) (the
  reference's ``("pod", "data", "model")`` ZeRO axes are the port's
  ``("data", "model")`` over the same 512 ranks);
* the input stand-ins' shapes (the reference's prefill specs without
  ``labels``, which its ``lower_cell`` pops);
* ``Roofline.row()`` on the same inputs, with the reference's device
  constants passed as a ``Device`` (they are the reference's, read here;
  the port holds only the H100's);
* ``render()``'s text on one JSON file;
* each collective's wire bytes on fake groups of 2, 4 and 16 ranks
  against the reference's ``_WIRE_FACTOR[op](k)`` times its operand's
  bytes.
"""
import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.analysis import report as ref_report  # noqa: E402
from repro.analysis import roofline as ref_roofline  # noqa: E402
from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.launch import dryrun_lib as ref_dry  # noqa: E402
from repro.launch import inputs as ref_inputs  # noqa: E402
from repro_torch.analysis import report  # noqa: E402
from repro_torch.analysis.op_stats import OpStats  # noqa: E402
from repro_torch.analysis.roofline import (  # noqa: E402
    H100_SXM,
    Device,
    Roofline,
    model_flops,
)
from repro_torch.configs import ASSIGNED_ARCHS, SHAPES, get_config  # noqa
from repro_torch.launch import dryrun_lib as dry  # noqa: E402
from repro_torch.launch import inputs  # noqa: E402

#: (the reference's mesh: axis names and device grid shape, the port's
#: (data, model))
MESHES = {"pod16x16": ((("data", "model"), (16, 16)), (16, 16)),
          "2xpod16x16": ((("pod", "data", "model"), (2, 16, 16)), (32, 16))}


def _ref_mesh(names, shape):
    """What the reference's ``parallel_config_for`` reads of a mesh."""
    return types.SimpleNamespace(axis_names=names,
                                 devices=np.empty(shape, dtype=object))


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_model_flops_match_reference(arch):
    for name in SHAPES:
        assert model_flops(get_config(arch), SHAPES[name]) == \
            ref_roofline.model_flops(ref_config(arch), REF_SHAPES[name])


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_dry_run_configs_match_reference(arch, mesh):
    (names, grid), port_mesh = MESHES[mesh]
    cfg, rcfg = get_config(arch), ref_config(arch)
    assert dry.train_config_for(cfg).__dict__ == \
        ref_dry.train_config_for(rcfg).__dict__
    for name in SHAPES:
        shape, rshape = SHAPES[name], REF_SHAPES[name]
        if shape.kind == "train":  # (the rule divides by 0 elsewhere)
            assert dry.auto_microbatches(cfg, shape, port_mesh[0]) == \
                ref_dry.auto_microbatches(rcfg, rshape, port_mesh[0])
        got = dry.parallel_config_for(cfg, shape, port_mesh).__dict__
        want = dict(ref_dry.parallel_config_for(
            rcfg, rshape, _ref_mesh(names, grid)).__dict__)
        assert want["zero_axes"] == names
        want["zero_axes"] = ("data", "model")  # the pod axis folded
        assert got == want, (arch, mesh, name)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_input_specs_match_reference(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    for name in SHAPES:
        shape, rshape = SHAPES[name], REF_SHAPES[name]
        want = ref_inputs.train_input_specs(rcfg, rshape)
        got = inputs.train_input_specs(cfg, shape)
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}
        assert all(v.device.type == "meta" for v in got.values())
        assert got["tokens"].dtype == torch.int32
        want = ref_inputs.prefill_input_specs(rcfg, rshape)
        want.pop("labels")
        assert {k: tuple(v.shape) for k, v in
                inputs.prefill_input_specs(cfg, shape).items()} == \
            {k: tuple(v.shape) for k, v in want.items()}
        assert tuple(inputs.decode_token_spec(shape).shape) == \
            tuple(ref_inputs.decode_token_spec(rshape).shape)


ROWS = [  # (flops, bytes, wire, model flops, chips): each term leading
    (3.0e15, 2.0e12, 1.0e9, 4.0e17, 256),
    (1.0e12, 4.0e12, 1.0e9, 1.0e14, 256),
    (1.0e12, 1.0e9, 5.0e11, 2.0e14, 512),
    (0.0, 0.0, 0.0, 1.0, 1),
]


@pytest.mark.parametrize("row", ROWS)
def test_roofline_row_matches_reference_on_its_constants(row):
    flops, nbytes, wire, mflops, chips = row
    dev = Device("reference", {"bfloat16": ref_roofline.PEAK_FLOPS_BF16},
                 ref_roofline.HBM_BW, ref_roofline.ICI_LINK_BW)
    kw = dict(arch="a", shape="s", mesh="m", flops_per_device=flops,
              bytes_per_device=nbytes, wire_bytes_per_device=wire,
              model_flops_total=mflops, chips=chips,
              op_counts={"all-reduce": 2}, memory_per_device={"total_GB": 1})
    assert Roofline(device=dev, **kw).row() == \
        ref_roofline.Roofline(**kw).row()


def test_h100_row_uses_the_cells_dtype():
    kw = dict(arch="a", shape="s", mesh="m", flops_per_device=989.4e12,
              bytes_per_device=3.35e12, wire_bytes_per_device=450e9,
              model_flops_total=1.0, chips=1)
    assert Roofline(**kw).device is H100_SXM
    assert Roofline(**kw).t_compute == pytest.approx(1.0)
    assert Roofline(**kw).t_memory == pytest.approx(1.0)
    assert Roofline(**kw).t_collective == pytest.approx(1.0)
    assert Roofline(dtype="float32", **kw).t_compute == \
        pytest.approx(989.4 / 66.9)
    with pytest.raises(ValueError, match="no peak"):
        Roofline(dtype="float16", **kw).t_compute


def test_compute_term_sums_each_dtypes_flops_at_its_peak():
    """Flops counted by dtype each run at their own peak: a float32
    product on the CUDA cores, not at the cell's bfloat16 rate."""
    kw = dict(arch="a", shape="s", mesh="m", flops_per_device=2 * 989.4e12,
              bytes_per_device=0.0, wire_bytes_per_device=0.0,
              model_flops_total=989.4e12, chips=1)
    split = {"bfloat16": 989.4e12, "float32": 989.4e12}
    rl = Roofline(flops_by_dtype=split, **kw)
    assert rl.t_compute == pytest.approx(1.0 + 989.4 / 66.9)
    assert Roofline(**kw).t_compute == pytest.approx(2.0)
    assert rl.roofline_fraction == pytest.approx(1.0 / rl.t_compute)
    assert rl.bottleneck == "compute"


def test_render_matches_reference(tmp_path):
    kw = dict(shape="train_4k", flops_per_device=1e12, bytes_per_device=2e12,
              wire_bytes_per_device=3e9, model_flops_total=1e14, chips=256,
              memory_per_device={"total_GB": 12.5})
    data = {}
    for i, arch in enumerate(("gemma3-1b", "qwen2-0.5b")):
        for mesh in ("pod16x16", "2xpod16x16"):
            row = ref_roofline.Roofline(arch=arch, mesh=mesh, **dict(
                kw, flops_per_device=kw["flops_per_device"] * (i + 1))).row()
            data[f"{arch}|train_4k|{mesh}|ring"] = dict(
                row, status="ok", reduction="ring")
    data["gemma2-27b|long_500k|pod16x16|ring"] = {
        "status": "skip", "reason": "pure full-attention", "arch":
        "gemma2-27b", "shape": "long_500k", "mesh": "pod16x16"}
    data["minitron-8b|decode_32k|pod16x16|ring"] = {
        "status": "fail", "error": "ValueError: boom", "arch": "minitron-8b",
        "shape": "decode_32k", "mesh": "pod16x16"}
    path = tmp_path / "dry.json"
    path.write_text(json.dumps(data))
    for mesh in ("pod16x16", "2xpod16x16"):
        got = report.render(str(path), mesh=mesh)
        assert got == ref_report.render(str(path), mesh=mesh)
        assert "| gemma3-1b | train_4k |" in got
    assert "boom" in report.render(str(path))


def test_render_shows_one_route(tmp_path):
    """Rows of the kernels' route and of the CPU's plain route under one
    mesh: the table of either route alone, and none of both."""
    row = ref_roofline.Roofline(
        arch="gemma3-1b", shape="prefill_32k", mesh="pod16x16",
        flops_per_device=1e12, bytes_per_device=2e12,
        wire_bytes_per_device=3e9, model_flops_total=1e14, chips=256,
        memory_per_device={"total_GB": 12.5}).row()
    data = {f"gemma3-1b|prefill_32k|pod16x16|ring|{dev}": dict(
        row, status="ok", reduction="ring", device=dev,
        bytes_per_dev=row["bytes_per_dev"] * (1 + (dev == "cpu")))
        for dev in ("cuda", "cpu")}
    path = tmp_path / "dry.json"
    path.write_text(json.dumps(data))
    with pytest.raises(ValueError, match="routes"):
        report.render(str(path))
    for dev in ("cuda", "cpu"):
        got = report.render(str(path), device=dev)
        assert got.count("| gemma3-1b | prefill_32k |") == 1


@pytest.fixture
def fake_world():
    """A fake process group of ``k`` ranks, this process rank 0."""
    import torch.distributed as dist

    from repro_torch import compat

    def make(k):
        compat.init_fake_process_group(0, k)

    yield make
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("k", (2, 4, 16))
def test_wire_bytes_match_the_reference_ring_factors(k, fake_world):
    """Each collective on a fake model axis of k ranks, reported to an
    ``OpStats``: its wire bytes are the reference's ring factor times
    the operand's bytes (the all-gather's operand is the local shard),
    its operand's bytes go to ``hbm_bytes``, and ``TRAFFIC`` counts its
    transfers: the ring reduce-scatter's ``k - 1`` hops, one for each
    other collective."""
    from repro_torch.core import dataflow as df
    from repro_torch.launch.mesh import make_mesh

    fake_world(k)
    axis = make_mesh(1, k, backend="fake").model
    x = torch.zeros(4 * k, 6, dtype=torch.bfloat16)
    n = x.numel() * x.element_size()
    calls = {"all-reduce": lambda: df.psum(x, axis),
             "all-gather": lambda: df.all_gather(x, axis, 0),
             "reduce-scatter": lambda: df.psum_scatter(x, axis, 0),
             "all-to-all": lambda: df.all_to_all(x, axis, 0, 1),
             "collective-permute": lambda: df.ppermute(x, axis, 1)}
    for op, call in calls.items():
        df.reset_traffic()
        with OpStats() as st:
            call()
        want = ref_roofline._WIRE_FACTOR[op](k) * n
        assert st.wire_bytes == pytest.approx(want, abs=1), op
        assert st.op_counts == {op: 1} and st.op_bytes[op] == st.wire_bytes
        assert st.hbm_bytes == n and st.flops == 0
        assert df.TRAFFIC["collectives"] == (
            k - 1 if op == "reduce-scatter" else 1), op


@pytest.mark.parametrize("multi_pod", (False, True))
def test_production_mesh_folds_the_pod_axis(multi_pod, fake_world):
    """The reference's production meshes on the fake backend: (16, 16),
    and (2, 16, 16) as (32, 16), whose both-axes group spans the same
    512 ranks as the reference's ("pod", "data", "model")."""
    from repro_torch.launch.mesh import make_production_mesh

    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod)
    assert mesh.shape == ((32, 16) if multi_pod else (16, 16))
    assert mesh.backend == "fake" and mesh.coords == (0, 0)
    assert mesh.both.size == (512 if multi_pod else 256)
    assert mesh.model.ranks == tuple(range(16))
