"""The port's dry run (``launch/dryrun_lib.py``): one rank's program run
on fake tensors over a fake process group and counted by ``OpStats``.

* The reference's own cases (``tests/test_dryrun_small.py``) at the
  reduced configs on a (2, 4) fake mesh, seamless-m4t's ``t_small``
  included (the reference's lowering of it fails, ROADMAP R2).
* The long-context skip rule.
* Ring against all-reduce on one cell: the ring sends fewer bytes, in
  more ``collective-permute``s.
* Against the reference at tp = 1: qwen2-0.5b's reduced config, one
  ``p_small`` prefill through the reference's ``lower_cell`` and
  ``analyze_cell`` on a (1, 1) mesh, and the port's dry run on the CPU's
  plain route, whose plain versions dispatch the aten products the
  reference's jnp computes: the flops within 1% (they are equal), the
  argument bytes equal.
* The kernel wrappers' fake route: on fake CUDA tensors under an
  ``OpStats`` each reports its module's work formula and returns an
  empty output of the kernel's shape and dtype; outside a counter it
  raises (a fake tensor has no storage to launch on).

These dry runs take the CPU's plain route (``device="cpu"``): a torch
built without CUDA has no device guard for fake CUDA tensors' indexing.
The kernels' route runs on the card's host (``chip_smoke.py`` phase X).
Each rank's real counts against the dry run's, at tp 2 on gloo ranks,
are in ``test_torch_serve_tp.py`` and ``test_torch_train_tp.py`` (their
spawns count one prefill and one step).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.configs.base as RCB  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.launch import dryrun_lib as ref_dry  # noqa: E402
from repro_torch import compat  # noqa: E402
from repro_torch.analysis.op_stats import OpStats  # noqa: E402
from repro_torch.analysis.roofline import H100_SXM  # noqa: E402
from repro_torch.configs import SHAPES, get_config, shape_applicable  # noqa
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun_lib as dry  # noqa: E402

SMALL = {"t_small": ShapeConfig("t_small", 128, 8, "train"),
         "p_small": ShapeConfig("p_small", 128, 4, "prefill"),
         "d_small": ShapeConfig("d_small", 128, 8, "decode")}
#: the reference's CASES (tests/test_dryrun_small.py)
CASES = [
    ("qwen2-0.5b", "t_small"),
    ("jamba-v0.1-52b", "t_small"),       # hybrid + MoE + mamba
    ("deepseek-v3-671b", "p_small"),     # MLA prefill
    ("granite-moe-3b-a800m", "d_small"),  # MoE decode
    ("seamless-m4t-large-v2", "t_small"),  # enc-dec
    ("gemma2-27b", "d_small"),           # window ring cache + softcap
]
MESH = (2, 4)


def _cell(arch, shape, **kw):
    return dry.dry_cell(arch, SMALL[shape], MESH, cfg=get_config(arch)
                        .reduced(), device="cpu", **kw)


@pytest.mark.parametrize("arch,shape", CASES)
def test_cell_dry_runs_and_analyzes(arch, shape):
    run = _cell(arch, shape)
    row = dry.analyze_cell(run, arch, shape, "2x4")
    assert row["hlo_flops_per_dev"] > 0
    assert row["bytes_per_dev"] > 0
    assert row["wire_bytes_per_dev"] > 0 and row["op_counts"]
    assert row["bottleneck"] in ("compute", "memory", "collective")
    mem = row["memory"]
    assert mem["args_GB"] > 0 and mem["temp_GB"] > 0
    assert mem["total_GB"] == pytest.approx(mem["args_GB"] + mem["temp_GB"])
    assert row["kernels"] == {}  # the plain route: no kernel launches
    flops = row["flops_by_dtype"]
    assert sum(flops.values()) == row["hlo_flops_per_dev"]
    assert row["t_compute_s"] == pytest.approx(
        sum(f / H100_SXM.peak(d) for d, f in flops.items()))
    if shape == "t_small":  # tp > 1: the backward's products in float32
        assert flops["float32"] > 0
        assert row["t_compute_s"] > row["hlo_flops_per_dev"] / \
            H100_SXM.peak("bfloat16")
    import torch.distributed as dist
    assert not dist.is_initialized()


def test_long_context_skip_rule():
    """long_500k is refused for pure-attention archs, accepted for
    SSM / hybrid; the dry run raises SkipCell where it is refused."""
    long = SHAPES["long_500k"]
    ok, why = shape_applicable(get_config("gemma2-27b"), long)
    assert not ok and "sub-quadratic" in why
    assert shape_applicable(get_config("falcon-mamba-7b"), long)[0]
    assert shape_applicable(get_config("jamba-v0.1-52b"), long)[0]
    with pytest.raises(dry.SkipCell, match="sub-quadratic"):
        dry.dry_cell("gemma2-27b", "long_500k", (16, 16))


def test_ring_moves_fewer_bytes_than_allreduce():
    """Computing on the move: the ring's collective-permutes carry the
    partial sums, and the rank sends fewer bytes than the all-reduce
    baseline's psums."""
    ring = _cell("minitron-8b", "t_small", reduction="ring").stats
    ar = _cell("minitron-8b", "t_small", reduction="allreduce").stats
    assert ring.op_counts.get("collective-permute", 0) > \
        ar.op_counts.get("collective-permute", 0)
    assert ring.wire_bytes < ar.wire_bytes
    assert ring.flops == ar.flops


def test_prefill_flops_match_the_reference_at_tp1(monkeypatch):
    """qwen2-0.5b reduced, p_small, one device: the port's counted
    flops against the reference's loop-aware HLO count, and the
    arguments' bytes against its memory_analysis."""
    from jax.sharding import Mesh

    monkeypatch.setitem(RCB.SHAPES, "p_small", RCB.ShapeConfig(
        "p_small", 128, 4, "prefill"))
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    _, compiled, _ = ref_dry.lower_cell(
        "qwen2-0.5b", "p_small", mesh, cfg=ref_config("qwen2-0.5b").reduced())
    want = ref_dry.analyze_cell("qwen2-0.5b", "p_small", mesh, compiled, "1x1")
    run = dry.dry_cell("qwen2-0.5b", SMALL["p_small"], (1, 1),
                       cfg=get_config("qwen2-0.5b").reduced(), device="cpu")
    got = dry.analyze_cell(run, "qwen2-0.5b", "p_small", "1x1")
    ratio = got["hlo_flops_per_dev"] / want["hlo_flops_per_dev"]
    assert abs(ratio - 1) <= 0.01, ratio
    assert got["memory"]["args_GB"] == pytest.approx(
        want["memory"]["args_GB"])
    assert got["wire_bytes_per_dev"] == 0 and not got["op_counts"]


#: the dtype whose peak each kernel's operations run at (its bound's in
#: chip_smoke.py): the scans compute in float32 on the CUDA cores
PEAK_DTYPE = {"local_attention": "bfloat16", "local_attention_bwd": "bfloat16",
              "selective_scan": "float32", "selective_scan_bwd": "float32",
              "cim_codes": "int8"}


def _fake_cuda(mode, *shapes, dtype=torch.float32):
    with mode:
        return [torch.empty(s, dtype=dtype, device="cuda:0") for s in shapes]


def test_kernel_wrappers_report_their_work_on_fake_tensors():
    """Each wrapper on fake CUDA operands: one report of its work
    formula under its LAUNCHES name, an empty output of the kernel's
    shape and dtype, no launch counted; without a counter it raises."""
    import repro_torch.kernels.cim_matmul as km
    import repro_torch.kernels.local_attention as la
    import repro_torch.kernels.selective_scan as ss
    from repro_torch.core.cim import CIMSpec

    mode = compat.fake_tensor_mode()
    q, k, v = _fake_cuda(mode, (2, 64, 4, 64), (2, 64, 2, 64),
                         (2, 64, 2, 64), dtype=torch.bfloat16)
    dt, x, dy = _fake_cuda(mode, (2, 32, 16), (2, 32, 16), (2, 32, 16))
    b, c, a, d = _fake_cuda(mode, (2, 32, 4), (2, 32, 4), (16, 4), (16,))
    xi, wi = _fake_cuda(mode, (5, 300), (70, 300), dtype=torch.int8)
    wi = wi.T  # K-major, as the engine stores its weights
    spec = CIMSpec(n_c=128)
    launches = {**la.LAUNCHES, **ss.LAUNCHES, **km.LAUNCHES}
    calls = {
        "local_attention": (
            lambda: la.grouped_local_attention(q, k, v, window=16),
            la.attn_work(q, k, v, 16), [(2, 64, 4, 64)]),
        "local_attention_bwd": (
            lambda: la.local_attention_bwd(q, k, v, q, q, window=16),
            (la.bwd_work(q, 16, 64), la.bwd_bytes(q, k, v)),
            [(2, 64, 4, 64), (2, 64, 2, 64), (2, 64, 2, 64)]),
        "selective_scan": (
            lambda: ss.selective_scan(dt, x, b, c, a, d),
            ss.scan_work(dt, x, b, c, a, d), [(2, 32, 16), (2, 16, 4)]),
        "selective_scan_bwd": (
            lambda: ss.selective_scan_bwd(dt, x, b, c, a, d, dy),
            ss.scan_bwd_work(dt, b),
            [(2, 32, 16), (2, 32, 16), (2, 32, 4), (2, 32, 4), (16, 4),
             (16,), (2, 16, 4)]),
        "cim_codes": (lambda: km.cim_codes(xi, wi, spec),
                      km.work(xi, wi), [(5, 70)]),
    }
    for name, (call, work, shapes) in calls.items():
        with mode, OpStats() as st:
            out = call()
        outs = out if isinstance(out, tuple) else (out,)
        assert [tuple(t.shape) for t in outs] == shapes, name
        assert all(compat.is_fake(t) for t in outs)
        assert st.kernels == {name: {"calls": 1, "flops": work[0],
                                     "bytes": work[1]}}, name
        assert st.flops == work[0] and st.hbm_bytes == work[1]
        assert st.flops_by_dtype == {PEAK_DTYPE[name]: work[0]}, name
        with mode, pytest.raises(RuntimeError, match="no OpStats"):
            call()
    assert {**la.LAUNCHES, **ss.LAUNCHES, **km.LAUNCHES} == launches
