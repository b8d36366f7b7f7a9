"""Port parity for serving over the two-level chiplet fabric:
``repro_torch.runtime.serve_loop.build_stream_sim(chiplets=, noi=)``
against the reference's, on quantized weights (the CIM engine, with the
reference engine's calibration copied into the port's).

Tolerances, stated per check:

* logits — equal by value (``-0.0 == 0.0``) to the port's own
  ``chiplets=1`` run and to the reference's: placement changes hops,
  never math, and ADC codes are integers;
* traffic (per frame, per class, the NoI level included), counters,
  stage timeline, measured and analytic II, the serve report — identical
  to the reference's (the same host code);
* the degenerate 1x1 fabric — identical to the flat mesh in logits,
  traffic, heatmap and the energy report.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from conftest import int_params  # noqa: E402
from repro.configs import cnn as RC  # noqa: E402
from repro.runtime import serve_loop as RS  # noqa: E402
from repro_torch.configs import cnn as PC  # noqa: E402
from repro_torch.convert import copy_calibration, params_from_reference  # noqa: E402
from repro_torch.core.energy import analyze_plan  # noqa: E402
from repro_torch.core.engine import CIMEngine  # noqa: E402
from repro_torch.core.network import NetworkSimulator  # noqa: E402
from repro_torch.core.noc import ChipletFabric, shard_network  # noqa: E402
from repro_torch.runtime import serve_loop as PS  # noqa: E402
from repro_torch.telemetry import record_run  # noqa: E402


def _toy(m):
    return m.CNNConfig("toy", "cifar10", 8, (
        m.ConvLayer("c0", 8, 8, 3, 32, k=3, pool_k=2, pool_s=2),
        m.ConvLayer("c1", 4, 4, 32, 300, k=3),
        m.ConvLayer("c2", 4, 4, 300, 64, k=3, pool_k=2, pool_s=2),
        m.FCLayer("fc", 256, 10),
    ))


def _resnet_mini(m):
    layers = []
    h, w, c = m._res_block(layers, "s0b0", 8, 8, 4, 4, 1, False)
    h, w, c = m._res_block(layers, "s1b0", h, w, c, 6, 2, False)
    layers.append(m.FCLayer("fc", c, 5))
    return m.CNNConfig("resnet-mini", "cifar10", 8, tuple(layers))


CONFIGS = {"toy": _toy, "resnet-mini": _resnet_mini}


@pytest.fixture(scope="module", params=list(CONFIGS))
def served(request):
    """One model's quantized params and frames, the reference's flat
    serving simulator, and the port's flat run on the CPU."""
    name = request.param
    rcnn, pcnn = CONFIGS[name](RC), CONFIGS[name](PC)
    rng = np.random.default_rng(5)
    params = {}
    for l in rcnn.layers:
        shape = ((l.k, l.k, l.c, l.m) if isinstance(l, RC.ConvLayer)
                 else (l.c_in, l.c_out))
        params[l.name] = rng.standard_normal(shape) / np.sqrt(
            np.prod(shape[:-1]))
    x = rng.random((5, 8, 8, rcnn.layers[0].c))
    rq = RS.quantize_cnn_params_for_serving(params)
    pq = PS.quantize_cnn_params_for_serving(
        params_from_reference(params, "cpu"))
    rflat = RS.build_stream_sim(rcnn, rq, calib_images=x[:2])
    flat = PS.serve_stream(
        PS.build_stream_sim(pcnn, pq, engine=_engine(rflat), device="cpu"),
        x, batch_window=2)
    return dict(rcnn=rcnn, pcnn=pcnn, rq=rq, pq=pq, x=x, rflat=rflat,
                flat=flat)


def _engine(rsim):
    return copy_calibration(rsim.pe_engine, CIMEngine(device="cpu"))


def _same_traffic(a, b):
    return all(dict(getattr(a, f)) == dict(getattr(b, f))
               for f in ("byte_hops", "packets", "hops"))


@pytest.mark.parametrize("chiplets,noi", [(2, "mesh"), (2, "floret"),
                                          (4, "mesh"), (4, "floret")])
def test_chiplet_serving_matches_reference(served, chiplets, noi):
    s = served
    rsim = RS.build_stream_sim(s["rcnn"], s["rq"], chiplets=chiplets,
                               noi=noi, calib_images=s["x"][:2])
    psim = PS.build_stream_sim(s["pcnn"], s["pq"], chiplets=chiplets,
                               noi=noi, engine=_engine(s["rflat"]),
                               device="cpu")
    assert isinstance(psim.placement.noc, ChipletFabric)
    assert len(psim.placement.noc.chiplets) == chiplets
    rrep = RS.serve_stream(rsim, s["x"], batch_window=2)
    prep = PS.serve_stream(psim, s["x"], batch_window=2)
    assert torch.equal(prep.logits + 0.0, s["flat"].logits + 0.0)
    for f in ("arrivals", "latency_cycles"):
        np.testing.assert_array_equal(getattr(prep, f), getattr(rrep, f))
    for f in ("measured_ii", "analytic_ii", "fill_latency", "offered_inf_s",
              "throughput_inf_s", "flagged_frames", "straggler_escalate",
              "batch_sizes"):
        assert getattr(prep, f) == getattr(rrep, f), f
    assert prep.measured_ii == prep.analytic_ii
    rres = rsim.run_stream(s["x"], arrivals=rrep.arrivals, chunk=2)
    pres = psim.run_stream(s["x"], arrivals=prep.arrivals, chunk=2)
    np.testing.assert_array_equal(pres.logits.numpy(), rres.logits)
    np.testing.assert_array_equal(pres.start, rres.start)
    np.testing.assert_array_equal(pres.finish, rres.finish)
    assert all(dataclasses.asdict(a) == dataclasses.asdict(b) for a, b in
               zip(pres.frame_counters, rres.frame_counters))
    assert all(_same_traffic(a, b) for a, b in
               zip(pres.frame_traffic, rres.frame_traffic))
    # the streamed hand-offs really cross the interposer
    assert all(ft.byte_hops.get("noi", 0) > 0 for ft in pres.frame_traffic)


def test_1x1_fabric_identical_to_flat_mesh():
    rng = np.random.default_rng(0)
    cnn = PC.CNN_BENCHMARKS["vgg11-cifar10"]()
    params = params_from_reference(
        int_params(RC.CNN_BENCHMARKS["vgg11-cifar10"](), rng), "cpu")
    x = rng.integers(0, 2, (2, 32, 32, 3)).astype(np.float64)
    flat = NetworkSimulator(cnn, params, device="cpu")
    fab = NetworkSimulator(cnn, params, device="cpu",
                           placement=shard_network(flat.plan, 1))
    assert isinstance(fab.placement.noc, ChipletFabric)
    flat_res, flat_rec = record_run(flat, x)
    fab_res, fab_rec = record_run(fab, x)
    assert torch.equal(flat_res.logits, fab_res.logits)
    assert _same_traffic(flat_res.traffic, fab_res.traffic)
    assert "noi" not in fab_res.traffic.byte_hops
    assert flat_rec.heatmap().per_class == fab_rec.heatmap().per_class
    assert flat_rec.heatmap().render() == fab_rec.heatmap().render()
    flat_rep = analyze_plan(cnn, flat.plan, placement=flat.placement)
    fab_rep = analyze_plan(cnn, fab.plan, placement=fab.placement)
    assert fab_rep.e_noi == 0.0
    assert flat_rep.breakdown() == fab_rep.breakdown()
