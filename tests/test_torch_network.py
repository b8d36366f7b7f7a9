"""Port parity for the whole slice: ``repro_torch`` ``NetworkSimulator``
(``backend="trace"``), ``run_stream`` and ``serve_stream`` against the
reference's ``NetworkSimulator(backend="trace", engine="cim")`` on the
same numpy weights and frames.

Configs: the DSE suite's toy CNN (packing, a C = 300 > n_c split chain,
pools, an FC head) and the trace suite's resnet-mini (identity and
projection shortcuts, global average pool + FC).

Tolerances, stated per check:

* quantized engine — logits equal by value, with the reference engine's
  calibration copied into the port's (``copy_calibration``): ADC codes
  are integers, every float op is the same IEEE op in the same order;
* counters, traffic, stage timeline, II — identical (the same host code);
* exact engine — rtol 1e-9: float64 products reduce in another order in
  torch than in the reference's padded BLAS;
* calibration from the port's own float forward — rtol 1e-5: torch and
  XLA convolutions round float32 partial sums differently.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.configs import cnn as RC  # noqa: E402
from repro.core.network import NetworkSimulator as RSim  # noqa: E402
from repro.core.variation import VariationModel as RVar  # noqa: E402
from repro.runtime import serve_loop as RS  # noqa: E402
from repro_torch.configs import cnn as PC  # noqa: E402
from repro_torch.convert import copy_calibration, params_from_reference  # noqa: E402
from repro_torch.core.engine import CIMEngine  # noqa: E402
from repro_torch.core.network import NetworkSimulator, _global_avg_pool  # noqa: E402
from repro_torch.core.variation import VariationModel  # noqa: E402
from repro_torch.runtime import serve_loop as PS  # noqa: E402
from repro_torch.telemetry.spans import Profiler  # noqa: E402


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


def _setup(name, seed=0, frames=3):
    rcnn, pcnn = CONFIGS[name](RC), CONFIGS[name](PC)
    rng = np.random.default_rng(seed)
    params = {}
    for l in rcnn.layers:
        shape = ((l.k, l.k, l.c, l.m) if isinstance(l, RC.ConvLayer)
                 else (l.c_in, l.c_out))
        params[l.name] = rng.standard_normal(shape) / np.sqrt(
            np.prod(shape[:-1]))
    c_in = rcnn.layers[0].c
    x = rng.random((frames, rcnn.input_hw, rcnn.input_hw, c_in))
    return rcnn, pcnn, params, x


def _port_engine(ref_sim):
    return copy_calibration(ref_sim.pe_engine, CIMEngine(device="cpu"))


def _same_counters(a, b):
    return dataclasses.asdict(a) == dataclasses.asdict(b)


def _same_traffic(a, b):
    return all(dict(getattr(a, f)) == dict(getattr(b, f))
               for f in ("byte_hops", "packets", "hops"))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_run_matches_reference_cim(name):
    rcnn, pcnn, params, x = _setup(name)
    calib = x[:2]
    ref = RSim(rcnn, params, backend="trace", engine="cim",
               calib_images=calib)
    r = ref.run(x)
    port = NetworkSimulator(pcnn, params_from_reference(params, "cpu"),
                            engine=_port_engine(ref), device="cpu")
    p = port.run(x)
    assert p.logits.dtype == torch.float64
    np.testing.assert_array_equal(p.logits.numpy(), r.logits)
    assert _same_counters(p.counters, r.counters)
    assert _same_traffic(p.traffic, r.traffic)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_serve_stream_matches_reference(name):
    """Quantized-weights serving: ``quantize_cnn_params_for_serving`` ->
    ``build_stream_sim`` -> ``serve_stream`` with a micro-batch window,
    against the reference's same route."""
    rcnn, pcnn, params, x = _setup(name, seed=1, frames=5)
    rq = RS.quantize_cnn_params_for_serving(params)
    pq = PS.quantize_cnn_params_for_serving(
        params_from_reference(params, "cpu"))
    for k in rq:
        np.testing.assert_array_equal(pq[k]["q"].numpy(), rq[k]["q"])
        np.testing.assert_array_equal(pq[k]["s"].numpy(), rq[k]["s"])
    rsim = RS.build_stream_sim(rcnn, rq, calib_images=x[:2])
    psim = PS.build_stream_sim(pcnn, pq, engine=_port_engine(rsim),
                               device="cpu")
    rrep = RS.serve_stream(rsim, x, batch_window=2)
    prep = PS.serve_stream(psim, x, batch_window=2)
    for f in ("arrivals", "latency_cycles"):
        np.testing.assert_array_equal(getattr(prep, f), getattr(rrep, f))
    for f in ("measured_ii", "analytic_ii", "fill_latency", "offered_inf_s",
              "throughput_inf_s", "flagged_frames", "straggler_escalate",
              "batch_sizes"):
        assert getattr(prep, f) == getattr(rrep, f), f
    assert prep.measured_ii == prep.analytic_ii
    rres = rsim.run_stream(x, arrivals=rrep.arrivals, chunk=2)
    pres = psim.run_stream(x, arrivals=prep.arrivals, chunk=2)
    np.testing.assert_array_equal(prep.logits.numpy(), rres.logits)
    np.testing.assert_array_equal(pres.logits.numpy(), rres.logits)
    np.testing.assert_array_equal(pres.start, rres.start)
    np.testing.assert_array_equal(pres.finish, rres.finish)
    assert pres.residual_fifo_depth == rres.residual_fifo_depth
    assert all(_same_counters(a, b) for a, b in
               zip(pres.frame_counters, rres.frame_counters))
    assert all(_same_traffic(a, b) for a, b in
               zip(pres.frame_traffic, rres.frame_traffic))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_exact_engine_allclose(name):
    rcnn, pcnn, params, x = _setup(name, seed=2)
    r = RSim(rcnn, params, backend="trace").run(x)
    p = NetworkSimulator(pcnn, params_from_reference(params, "cpu"),
                         device="cpu").run(x)
    np.testing.assert_allclose(p.logits.numpy(), r.logits, rtol=1e-9,
                               atol=1e-12)
    assert _same_counters(p.counters, r.counters)
    assert _same_traffic(p.traffic, r.traffic)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_calibration_from_port_forward(name):
    rcnn, pcnn, params, x = _setup(name, seed=3)
    ref = RSim(rcnn, params, backend="trace", engine="cim",
               calib_images=x[:2])
    port = NetworkSimulator(pcnn, params_from_reference(params, "cpu"),
                            engine="cim", calib_images=x[:2], device="cpu")
    assert set(port.pe_engine.calib) == set(ref.pe_engine.calib)
    for layer, rc in ref.pe_engine.calib.items():
        pc = port.pe_engine.calib[layer]
        np.testing.assert_allclose(pc.a_scale, rc.a_scale, rtol=1e-5)
        np.testing.assert_allclose(pc.gain, rc.gain, rtol=1e-5)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_variation_matches_reference(name):
    """A device-variation model swapped in through ``set_variation``:
    perturbed weights and per-subarray ADC tables from the same numpy
    draws, the variation kernel flavor, logits equal by value."""
    rcnn, pcnn, params, x = _setup(name, seed=4)
    knobs = dict(seed=7, conductance_sigma=0.03, stuck_zero=0.005,
                 stuck_one=0.002, adc_offset_sigma=0.5, adc_gain_sigma=0.02)
    ref = RSim(rcnn, params, backend="trace", engine="cim",
               calib_images=x[:2])
    port = NetworkSimulator(pcnn, params_from_reference(params, "cpu"),
                            engine=_port_engine(ref), device="cpu")
    nominal = port.run(x).logits
    ref.set_variation(RVar(**knobs))
    port.set_variation(VariationModel(**knobs))
    r, p = ref.run(x), port.run(x)
    np.testing.assert_array_equal(p.logits.numpy(), r.logits)
    assert not torch.equal(p.logits, nominal)


def test_build_spans_reach_an_installed_profiler():
    _, pcnn, params, x = _setup("toy")
    with Profiler() as prof:
        NetworkSimulator(pcnn, params_from_reference(params, "cpu"),
                         engine="cim", calib_images=x[:2], device="cpu")
    begun = [e["name"] for e in prof.events if e["ph"] == "B"]
    assert begun == ["trace_lower:toy", "calibrate:toy",
                     "executor_build:toy"]
    assert len(prof.events) == 2 * len(begun)


def test_global_avg_pool_matches_numpy_mean():
    """The GAP feeds the quantized FC head, so it must reproduce numpy's
    ``mean(axis=(1, 2))`` bits, not just its value."""
    rng = np.random.default_rng(5)
    for shape in [(2, 4, 4, 6), (3, 7, 7, 64), (1, 1, 1, 3)]:
        x = rng.standard_normal(shape)
        got = _global_avg_pool(torch.from_numpy(x)).numpy()
        assert got.tobytes() == x.mean(axis=(1, 2)).tobytes()


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the no-card behaviour")
    _, pcnn, params, _ = _setup("toy")
    with pytest.raises(RuntimeError):
        params_from_reference(params)
    with pytest.raises(RuntimeError):
        NetworkSimulator(pcnn, params_from_reference(params, "cpu"))
    with pytest.raises(RuntimeError):
        PS.build_stream_sim(pcnn, params_from_reference(params, "cpu"))

