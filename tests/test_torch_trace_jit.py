"""Port parity for the trace executor's flavors and the per-cell stream
oracle: ``TraceExecutor(use_jax=, fused=)``, ``simulate_block_trace``,
``NetworkSimulator(trace_jit=True)`` and ``run_stream(batched=False)``
against the reference's on the same numpy weights and frames.

On the CPU the quantized ``use_jax`` flavor runs its eager path (the
captured CUDA-graph replay is a card path: ``tests/test_torch_cuda.py``
and ``chip_smoke.py`` phase J hold it against the eager run there).

Tolerances, stated per check:

* quantized engines — equal by value (``-0.0 == 0.0``), with the
  reference engine's calibration copied into the port's: ADC codes are
  integers and every float op is the same IEEE op;
* the exact engine's float32 flavor — rtol = atol = 1e-5, the
  reference's own tolerance for its float32 flavor against its float64
  path (``tests/test_trace.py::test_trace_jax_flavor_allclose``): the
  group gemms sum in other orders in torch and XLA;
* counters, traffic, the stage timeline, the FIFO depth and the batch
  sizes — identical (the same host code).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_network import (  # noqa: E402
    _port_engine,
    _resnet_mini,
    _same_counters,
    _same_traffic,
    _toy,
)

from repro.configs import cnn as RC  # noqa: E402
from repro.core.cim import CIMSpec as RSpec  # noqa: E402
from repro.core.engine import CIMEngine as RCIM  # noqa: E402
from repro.core.network import NetworkSimulator as RSim  # noqa: E402
from repro.core.schedule import compile_conv_block as r_compile  # noqa: E402
from repro.core.trace import TraceExecutor as RExec  # noqa: E402
from repro.core.trace import simulate_block_trace as r_simulate  # noqa: E402
from repro.core.variation import VariationModel as RVar  # noqa: E402
from repro.runtime import serve_loop as RS  # noqa: E402
from repro_torch.configs import cnn as PC  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.core.cim import CIMSpec  # noqa: E402
from repro_torch.core.engine import CIMEngine  # noqa: E402
from repro_torch.core.network import NetworkSimulator  # noqa: E402
from repro_torch.core.schedule import compile_conv_block  # noqa: E402
from repro_torch.core.trace import TraceExecutor, simulate_block_trace  # noqa: E402
from repro_torch.core.variation import VariationModel  # noqa: E402
from repro_torch.runtime import serve_loop as PS  # noqa: E402


def _vgg_mini(m):
    """A VGG at reduced width: channel counts unlike the kernel size, a
    C > n_c split chain, pools, and a two-layer FC head."""
    return m.CNNConfig("vgg-mini", "cifar10", 8, (
        m.ConvLayer("c0", 8, 8, 3, 16, k=3, pool_k=2, pool_s=2),
        m.ConvLayer("c1", 4, 4, 16, 40, k=3),
        m.ConvLayer("c2", 4, 4, 40, 280, k=3),
        m.ConvLayer("c3", 4, 4, 280, 24, k=3, pool_k=2, pool_s=2),
        m.FCLayer("fc0", 96, 32),
        m.FCLayer("fc1", 32, 10),
    ))


CONFIGS = {"toy": _toy, "vgg-mini": _vgg_mini, "resnet-mini": _resnet_mini}

#: block-level subarray: conv tiles are K-ragged (kc < n_c)
NARROW = dict(n_c=64, adc_bits=8, gain=48.0)
#: ragged conv geometries (the reference's ``tests/test_quant_trace.py``)
GEOMS = [
    dict(h=8, w=9, c=5, m=6, k=3, stride=1, pad=1),
    dict(h=8, w=8, c=9, m=6, k=3, stride=1, pad=1, c_splits=3),
    dict(h=9, w=7, c=4, m=5, k=3, stride=2, pad=1),
    dict(h=6, w=6, c=7, m=4, k=1, stride=1, pad=0),
    dict(h=8, w=8, c=4, m=6, k=3, stride=1, pad=1, pool_k=2, pool_s=2),
]
KNOBS = dict(seed=7, conductance_sigma=0.03, stuck_zero=0.005,
             stuck_one=0.002, adc_offset_sigma=0.5, adc_gain_sigma=0.02)


def _same(a, b):
    """Equal by value (the reference's flavors disagree on -0.0)."""
    a = np.asarray(a) + 0.0
    return a.shape == np.shape(b) and np.array_equal(a, np.asarray(b) + 0.0)


def _setup(name, seed=0, frames=3):
    rcnn, pcnn = CONFIGS[name](RC), CONFIGS[name](PC)
    rng = np.random.default_rng(seed)
    params = {}
    for l in rcnn.layers:
        shape = ((l.k, l.k, l.c, l.m) if isinstance(l, RC.ConvLayer)
                 else (l.c_in, l.c_out))
        params[l.name] = rng.standard_normal(shape) / np.sqrt(
            np.prod(shape[:-1]))
    x = rng.random((frames, rcnn.input_hw, rcnn.input_hw,
                    rcnn.layers[0].c))
    return rcnn, pcnn, params, x


def _block(seed, geom, batch=2):
    """(reference schedule, port schedule, weights, ifm) of one block."""
    rng = np.random.default_rng(seed)
    g = geom
    ifm = rng.standard_normal((batch, g["h"], g["w"], g["c"]))
    wts = rng.standard_normal((g["k"], g["k"], g["c"], g["m"]))
    kw = {k: v for k, v in g.items() if k in ("c_splits", "pool_k", "pool_s")}
    args = (f"blk{seed}", g["h"], g["w"], g["c"], g["m"], g["k"],
            g["stride"], g["pad"])
    return (r_compile(*args, **kw), compile_conv_block(*args, **kw), wts,
            ifm)


def _engines(sched, ifm, variation):
    a_scale = float(np.abs(ifm).max()) / 127
    ref = RCIM(RSpec(**NARROW)).set_layer(sched.layer_name, a_scale=a_scale)
    port = CIMEngine(CIMSpec(**NARROW), device="cpu").set_layer(
        sched.layer_name, a_scale=a_scale)
    if variation:
        ref.variation, port.variation = RVar(**KNOBS), VariationModel(**KNOBS)
    return ref, port


# -- block level -------------------------------------------------------------


@pytest.mark.parametrize("gi", range(len(GEOMS)))
def test_simulate_block_trace_f32_flavor_matches_reference(gi):
    """The exact engine's float32 flavor (one im2col gemm per tile
    group): within 1e-5 of the reference's flavor and of the port's
    float64 path; counters identical."""
    rsched, psched, wts, ifm = _block(30 + gi, GEOMS[gi])
    ref = r_simulate(rsched, wts, ifm, use_jax=True)
    pw, px = torch.from_numpy(wts), torch.from_numpy(ifm)
    got = simulate_block_trace(psched, pw, px, use_jax=True)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    f64 = TraceExecutor(psched, pw)
    np.testing.assert_allclose(got.numpy(), f64.run(px).numpy(), rtol=1e-5,
                               atol=1e-5)
    f32 = TraceExecutor(psched, pw, use_jax=True)
    f32.run(px)
    assert dataclasses.asdict(f32.counters) == dataclasses.asdict(
        f64.counters)


@pytest.mark.parametrize("gi", range(len(GEOMS)))
@pytest.mark.parametrize("variation", [False, True])
def test_quantized_flavors_match_reference(gi, variation):
    """fused == per-tile (``fused=False``) == the ``use_jax`` flavor, each
    equal by value to the reference's same flavor, nominal and under a
    full variation model."""
    rsched, psched, wts, ifm = _block(40 + gi, GEOMS[gi])
    reng, peng = _engines(rsched, ifm, variation)
    pw, px = torch.from_numpy(wts), torch.from_numpy(ifm)
    want = RExec(rsched, wts, engine=reng).run(ifm)
    for kw in (dict(), dict(fused=False), dict(use_jax=True)):
        assert _same(RExec(rsched, wts, engine=reng, **kw).run(ifm), want)
        got = TraceExecutor(psched, pw, engine=peng, **kw).run(px)
        assert _same(got.numpy(), want), kw
        assert _same(simulate_block_trace(psched, pw, px, engine=peng,
                                          **kw).numpy(), want), kw


def test_quantized_per_tile_fold_is_one_call_per_tile():
    """``fused=False`` runs one kernel call per tile; the fused path one
    per fire chunk."""
    from repro_torch.kernels import cim_matmul as km

    rsched, psched, wts, ifm = _block(50, GEOMS[1])
    _, peng = _engines(rsched, ifm, False)
    pw, px = torch.from_numpy(wts), torch.from_numpy(ifm)
    calls = []
    real = km.cim_codes

    def recorder(x, w, spec, adc=None, emit_codes=True):
        calls.append(tuple(x.shape))
        return real(x, w, spec, adc=adc, emit_codes=emit_codes)

    km.cim_codes = recorder
    try:
        ex = TraceExecutor(psched, pw, engine=peng, fused=False)
        ex.run(px)
        per_tile = len(calls)
        calls.clear()
        fused = TraceExecutor(psched, pw, engine=peng)
        fused.run(px)
    finally:
        km.cim_codes = real
    assert per_tile == len(ex.plan.tiles)
    assert len(calls) == len(fused._quant_chunks(fused.plan.fires, 2))


def test_executor_flavor_raises_like_reference():
    """``use_jax=True`` on a quantized engine has no per-tile form."""
    rsched, psched, wts, ifm = _block(3, GEOMS[0])
    reng, peng = _engines(rsched, ifm, False)
    with pytest.raises(ValueError):
        RExec(rsched, wts, use_jax=True, fused=False, engine=reng)
    with pytest.raises(ValueError):
        TraceExecutor(psched, torch.from_numpy(wts), use_jax=True,
                      fused=False, engine=peng)


# -- whole network: trace_jit ------------------------------------------------


@pytest.mark.parametrize("name", list(CONFIGS))
def test_trace_jit_run_matches_reference(name):
    """Quantized ``trace_jit`` ``run``: logits equal by value to the
    reference's ``trace_jit`` run and to the port's non-jit run;
    counters and traffic identical."""
    rcnn, pcnn, params, x = _setup(name, seed=11)
    ref = RSim(rcnn, params, backend="trace", engine="cim",
               calib_images=x[:2], trace_jit=True)
    r = ref.run(x)
    pp = params_from_reference(params, "cpu")
    port = NetworkSimulator(pcnn, pp, engine=_port_engine(ref),
                            trace_jit=True, device="cpu")
    assert port.trace_jit and all(ex.use_jax
                                  for ex in port._executors.values())
    p = port.run(x)
    assert _same(p.logits.numpy(), r.logits)
    assert _same_counters(p.counters, r.counters)
    assert _same_traffic(p.traffic, r.traffic)
    plain = NetworkSimulator(pcnn, pp, engine=_port_engine(ref),
                             device="cpu").run(x)
    assert torch.equal(p.logits + 0.0, plain.logits + 0.0)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_trace_jit_stream_variation_swap_and_restore(name):
    """Quantized ``trace_jit`` streaming (``build_stream_sim``), nominal,
    after a ``set_variation`` swap and after ``set_variation(None)``:
    each equal by value to the reference's ``trace_jit`` stream, the
    restored run equal to the nominal one; per-frame counters, traffic
    and the timeline identical."""
    rcnn, pcnn, params, x = _setup(name, seed=12, frames=5)
    rq = RS.quantize_cnn_params_for_serving(params)
    pq = PS.quantize_cnn_params_for_serving(
        params_from_reference(params, "cpu"))
    rsim = RS.build_stream_sim(rcnn, rq, calib_images=x[:2], trace_jit=True)
    psim = PS.build_stream_sim(pcnn, pq, engine=_port_engine(rsim),
                               device="cpu", trace_jit=True)
    runs = []
    for var in (None, "varied", None):
        rsim.set_variation(None if var is None else RVar(**KNOBS))
        psim.set_variation(None if var is None else VariationModel(**KNOBS))
        rres = rsim.run_stream(x, chunk=2)
        pres = psim.run_stream(x, chunk=2)
        assert _same(pres.logits.numpy(), rres.logits), var
        np.testing.assert_array_equal(pres.start, rres.start)
        np.testing.assert_array_equal(pres.finish, rres.finish)
        assert pres.measured_ii == rres.measured_ii == pres.analytic_ii
        assert all(_same_counters(a, b) for a, b in
                   zip(pres.frame_counters, rres.frame_counters))
        assert all(_same_traffic(a, b) for a, b in
                   zip(pres.frame_traffic, rres.frame_traffic))
        runs.append(pres.logits)
    assert not torch.equal(runs[0], runs[1])
    assert torch.equal(runs[0] + 0.0, runs[2] + 0.0)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_exact_trace_jit_run_allclose(name):
    """The exact engine's ``trace_jit`` run (float32 flavor) against the
    reference's: rtol = atol = 1e-5; counters identical."""
    rcnn, pcnn, params, x = _setup(name, seed=13)
    r = RSim(rcnn, params, backend="trace", trace_jit=True).run(x)
    p = NetworkSimulator(pcnn, params_from_reference(params, "cpu"),
                         trace_jit=True, device="cpu").run(x)
    np.testing.assert_allclose(p.logits.numpy(), r.logits, rtol=1e-5,
                               atol=1e-5)
    assert _same_counters(p.counters, r.counters)
    assert _same_traffic(p.traffic, r.traffic)


def test_network_flag_raises_like_reference():
    """``trace_jit`` and ``streaming`` need the trace backend; the exact
    engine's float32 flavor does not stream; an unknown backend is
    refused.  Each raise is the reference's."""
    rcnn, pcnn, params, _ = _setup("toy")
    pp = params_from_reference(params, "cpu")
    cases = [dict(backend="interp", trace_jit=True),
             dict(backend="interp", streaming=True),
             dict(backend="trace", trace_jit=True, streaming=True),
             dict(backend="bogus")]
    for kw in cases:
        with pytest.raises(ValueError):
            RSim(rcnn, params, **kw)
        with pytest.raises(ValueError):
            NetworkSimulator(pcnn, pp, device="cpu", **kw)


# -- whole network: the per-cell stream oracle -------------------------------


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("engine", ["cim", "exact"])
def test_percell_oracle_matches_reference(name, engine):
    """``run_stream(batched=False)`` against the reference's: logits (by
    value on the CIM engine; rtol 1e-9 on the exact one, whose float64
    products reduce in another order), per-frame counters and traffic,
    start, finish, FIFO depth and batch sizes; and against the port's
    batched stream, which it is the oracle of."""
    rcnn, pcnn, params, x = _setup(name, seed=14, frames=4)
    arrivals = np.array([0, 3, 3, 40])
    kw = dict(backend="trace", streaming=True)
    if engine == "cim":
        kw.update(engine="cim", calib_images=x[:2])
    rsim = RSim(rcnn, params, **kw)
    pkw = dict(streaming=True, device="cpu")
    if engine == "cim":
        pkw["engine"] = _port_engine(rsim)
    psim = NetworkSimulator(pcnn, params_from_reference(params, "cpu"), **pkw)
    rres = rsim.run_stream(x, arrivals=arrivals, batched=False)
    pres = psim.run_stream(x, arrivals=arrivals, batched=False)
    batched = psim.run_stream(x, arrivals=arrivals, chunk=3)
    if engine == "cim":
        assert _same(pres.logits.numpy(), rres.logits)
    else:
        np.testing.assert_allclose(pres.logits.numpy(), rres.logits,
                                   rtol=1e-9, atol=1e-12)
    assert torch.equal(pres.logits + 0.0, batched.logits + 0.0)
    for res in (rres, batched):
        np.testing.assert_array_equal(pres.start, res.start)
        np.testing.assert_array_equal(pres.finish, res.finish)
        assert pres.residual_fifo_depth == res.residual_fifo_depth
        assert pres.measured_ii == res.measured_ii
        assert all(_same_counters(a, b) for a, b in
                   zip(pres.frame_counters, res.frame_counters))
        assert all(_same_traffic(a, b) for a, b in
                   zip(pres.frame_traffic, res.frame_traffic))
    assert pres.batch_sizes == rres.batch_sizes == (1,) * len(x)
    assert batched.batch_sizes == (3, 1)
    if name == "resnet-mini":
        assert pres.residual_fifo_depth > 0


def test_percell_oracle_under_trace_jit_and_variation():
    """The per-cell oracle runs the captured flavor's executors too (one
    frame a cell), under a variation model: equal to the batched jit
    stream by value."""
    rcnn, pcnn, params, x = _setup("resnet-mini", seed=15, frames=3)
    rsim = RSim(rcnn, params, backend="trace", engine="cim",
                calib_images=x[:2])
    psim = NetworkSimulator(pcnn, params_from_reference(params, "cpu"),
                            engine=_port_engine(rsim), streaming=True,
                            trace_jit=True, device="cpu")
    psim.set_variation(VariationModel(**KNOBS))
    cell = psim.run_stream(x, batched=False)
    batched = psim.run_stream(x)
    assert torch.equal(cell.logits + 0.0, batched.logits + 0.0)
    np.testing.assert_array_equal(cell.finish, batched.finish)
