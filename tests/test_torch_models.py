"""Port parity for the main path's other four CNNs: the FC layer in one
CIM kernel call, width strips, the five ``CNN_BENCHMARKS`` host plans,
and the scalar timeline oracle — each against the reference on the same
numpy inputs.

Tolerances, stated per check:

* quantized engine — logits, ADC code sums and block outputs equal by
  value (``-0.0 == 0.0``), with the reference engine's calibration
  copied into the port's: codes are integers and every float op is the
  same IEEE op in the same order;
* exact engine on small integer data — equal: every product and sum is
  an integer far below 2^53, so no reduction order can round;
* counters, traffic, stage timeline, II, plans, strips and schedule
  tables — identical (the same host code).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.configs import cnn as RC  # noqa: E402
from repro.core import engine as RE  # noqa: E402
from repro.core import mapping as RM  # noqa: E402
from repro.core import schedule as RSch  # noqa: E402
from repro.core.cim import CIMSpec as RSpec  # noqa: E402
from repro.core.instructions import TABLE_CAPACITY  # noqa: E402
from repro.core.network import NetworkSimulator as RSim  # noqa: E402
from repro.core.network import stream_timeline_scalar as r_scalar  # noqa: E402
from repro.core.simulator import BlockSimulator  # noqa: E402
from repro.core.trace import TraceExecutor as RTrace  # noqa: E402
from repro.core.variation import VARIATION_PRESETS as R_PRESETS  # noqa: E402
from repro.core.variation import VariationModel as RVar  # noqa: E402
from repro.runtime import serve_loop as RS  # noqa: E402
from repro_torch.configs import cnn as PC  # noqa: E402
from repro_torch.convert import copy_calibration, params_from_reference  # noqa: E402
from repro_torch.core import engine as PE  # noqa: E402
from repro_torch.core import mapping as PM  # noqa: E402
from repro_torch.core import schedule as PSch  # noqa: E402
from repro_torch.core.cim import CIMSpec  # noqa: E402
from repro_torch.core.network import (  # noqa: E402
    NetworkSimulator,
    stream_timeline,
    stream_timeline_scalar,
)
from repro_torch.core.simulator import simulate_fc  # noqa: E402
from repro_torch.core.trace import TraceExecutor  # noqa: E402
from repro_torch.core.variation import VARIATION_PRESETS  # noqa: E402
from repro_torch.core.variation import VariationModel  # noqa: E402
from repro_torch.runtime import serve_loop as PS  # noqa: E402


def _fc_chain(m):
    """A conv layer, then a VGG-like chain of three FC layers whose grids
    are ragged in both directions at n_c = n_m = 256: 592 -> 300 is
    3 x 2 tiles, 300 -> 270 is 2 x 2, 270 -> 10 is 2 x 1."""
    return m.CNNConfig("fc-chain", "cifar10", 8, (
        m.ConvLayer("c0", 8, 8, 3, 37, k=3, pool_k=2, pool_s=2),
        m.FCLayer("fc0", 592, 300),
        m.FCLayer("fc1", 300, 270),
        m.FCLayer("fc2", 270, 10),
    ))


def _resnet_wide(m):
    """A 132-pixel-wide mini ResNet: a strided 7x7 stem with a 2/2 pool
    whose padded width 138 exceeds the 128-entry table (so it runs as
    width strips), two bottleneck blocks (a projection shortcut, then a
    strided one) and the GAP + FC head."""
    layers = [m.ConvLayer("stem", 132, 132, 3, 8, k=7, s=2, p=3,
                          pool_k=2, pool_s=2)]
    h, w, c = m._res_block(layers, "s0b0", 33, 33, 8, 4, 1, True)
    h, w, c = m._res_block(layers, "s1b0", h, w, c, 4, 2, True)
    layers.append(m.FCLayer("fc", c, 5))
    return m.CNNConfig("resnet-wide", "imagenet", 132, tuple(layers))


def _setup(build, seed, frames):
    rcnn, pcnn = build(RC), build(PC)
    rng = np.random.default_rng(seed)
    params = {}
    for l in rcnn.layers:
        shape = ((l.k, l.k, l.c, l.m) if isinstance(l, RC.ConvLayer)
                 else (l.c_in, l.c_out))
        params[l.name] = rng.standard_normal(shape) / np.sqrt(
            np.prod(shape[:-1]))
    x = rng.random((frames, rcnn.input_hw, rcnn.input_hw, 3))
    return rcnn, pcnn, params, x


def _port_engine(ref_sim):
    return copy_calibration(ref_sim.pe_engine, PE.CIMEngine(device="cpu"))


def _same(a, b):
    """Equal by value: ``-0.0 == 0.0`` (fault R1 of the reference)."""
    return np.array_equal(np.asarray(a), np.asarray(b))


def _same_counters(a, b):
    return dataclasses.asdict(a) == dataclasses.asdict(b)


def _same_traffic(a, b):
    return all(dict(getattr(a, f)) == dict(getattr(b, f))
               for f in ("byte_hops", "packets", "hops"))


def _count_kernel_calls(monkeypatch):
    """Wrap the engine's CIM kernel wrapper; returns the list each call
    appends its (x, w) geometry to."""
    calls = []
    real = PE._kernel.cim_codes

    def counted(x, w, spec, adc=None, emit_codes=True):
        calls.append((tuple(x.shape), tuple(w.shape), adc is not None))
        return real(x, w, spec, adc=adc, emit_codes=emit_codes)

    monkeypatch.setattr(PE._kernel, "cim_codes", counted)
    return calls


def _conv_calls(sim, batch):
    """Kernel calls of one conv pass: one per fire chunk of every
    (layer, strip) executor."""
    return sum(len(ex._quant_chunks(ex.plan.fires, batch))
               for ex in sim._executors.values())


# ---------------------------------------------------------------------------
# (a) one kernel call per FC layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("preset", [None, "all"])
def test_fc_chain_one_call_per_layer_matches_reference(preset, monkeypatch):
    """The FC chain on the CIM engine: one kernel call per FC layer with
    the layer's whole (B, c_in) x (c_in, c_out) operands, nominal and
    with every variation source; logits equal to the reference by value,
    counters and traffic identical."""
    rcnn, pcnn, params, x = _setup(_fc_chain, 0, 3)
    ref = RSim(rcnn, params, backend="trace", engine="cim",
               calib_images=x[:2])
    port = NetworkSimulator(pcnn, params_from_reference(params, "cpu"),
                            engine=_port_engine(ref), device="cpu")
    if preset is not None:
        ref.set_variation(R_PRESETS[preset])
        port.set_variation(VARIATION_PRESETS[preset])
    calls = _count_kernel_calls(monkeypatch)
    p, r = port.run(x), ref.run(x)
    fcs = [l for l in pcnn.layers if isinstance(l, PC.FCLayer)]
    assert len(calls) == _conv_calls(port, x.shape[0]) + len(fcs)
    assert calls[-len(fcs):] == [((3, l.c_in), (l.c_in, l.c_out),
                                  preset is not None) for l in fcs]
    assert _same(p.logits.numpy(), r.logits)
    assert _same_counters(p.counters, r.counters)
    assert _same_traffic(p.traffic, r.traffic)


@pytest.mark.parametrize("variation", [False, True])
@pytest.mark.parametrize("n_c", [96, 256])
def test_fc_layer_mac_equals_tile_chain(n_c, variation):
    """``fc_layer_mac`` on a ragged (c_in, c_out) equals, column by
    column, the sum of the reference's per-tile ``fc_mac`` codes down
    each grid column (grid tiles of n_c rows, n_m = 64 columns)."""
    spec = RSpec(n_c=n_c, gain=12.0)
    var = (dict(conductance_sigma=0.03, stuck_zero=0.005, stuck_one=0.002,
                adc_offset_sigma=0.5, adc_gain_sigma=0.02, seed=3)
           if variation else None)
    ref = RE.CIMEngine(spec, variation=None if var is None
                       else RVar(**var))
    ref.set_layer("fc", a_scale=0.02, gain=12.0)
    port = copy_calibration(ref, PE.CIMEngine(
        CIMSpec(**dataclasses.asdict(spec)), device="cpu",
        variation=None if var is None else VariationModel(**var)))
    rng = np.random.default_rng(n_c + variation)
    c_in, c_out, n_m = 2 * n_c + 37, 150, 64
    w = rng.standard_normal((c_in, c_out)) / 10
    rh = ref.fc_handle("fc", w)
    ph = port.fc_handle("fc", torch.from_numpy(w))
    x = rng.standard_normal((5, c_in)) * 3
    xr = ref.quant_stream(rh, x)
    got = port.fc_layer_mac(ph, port.quant_stream(ph, torch.from_numpy(x)))
    assert got.dtype == torch.float64 and got.shape == (5, c_out)
    want = np.zeros((5, c_out))
    for n0 in range(0, c_out, n_m):
        n1 = min(n0 + n_m, c_out)
        for k0 in range(0, c_in, n_c):
            k1 = min(k0 + n_c, c_in)
            want[:, n0:n1] += ref.fc_mac(rh, xr[:, k0:k1], k0, k1, n0, n1,
                                         quantized=True)
    assert _same(got.numpy(), want)


def test_fc_grid_of_partial_subarrays_raises():
    """A grid row that does not hold whole subarrays would need a
    per-tile conversion the one-call layer does not make."""
    eng = PE.CIMEngine(CIMSpec(n_c=256), device="cpu").set_layer("fc")
    w = torch.zeros((300, 20), dtype=torch.float64)
    h = eng.fc_handle("fc", w)
    with pytest.raises(ValueError, match="whole"):
        simulate_fc(torch.zeros((2, 300), dtype=torch.float64), w, 96, 256,
                    engine=eng, handle=h)


# ---------------------------------------------------------------------------
# (b) width strips
# ---------------------------------------------------------------------------

#: (h, w, c, m, k, s, p, pool, capacity): the reference's strip tests
STRIP_CASES = {
    "strided": (9, 21, 2, 3, 3, 2, 1, 0, 9),
    "pooled": (8, 16, 2, 3, 3, 1, 1, 2, 10),
}


@pytest.mark.parametrize("case", list(STRIP_CASES))
def test_width_strips_equal_whole_block(case):
    """A block run as width strips at a small table capacity: the port's
    strips equal the reference's, and the port's trace executor over the
    strips gives the reference interpreter's whole-block OFM (exact
    engine, integer data) and the reference's whole-block CIM trace (CIM
    engine, by value)."""
    h, w, c, m, k, s, p, pool, cap = STRIP_CASES[case]
    kw = dict(k=k, stride=s, pad=p, pool_k=pool, pool_s=pool)
    rng = np.random.default_rng(3)
    ifm = rng.integers(-4, 5, (2, h, w, c)).astype(np.float64)
    wts = rng.integers(-4, 5, (k, k, c, m)).astype(np.float64)
    rstrips = RSch.compile_conv_strips("L", h, w, c, m, capacity=cap, **kw)
    pstrips = PSch.compile_conv_strips("L", h, w, c, m, capacity=cap, **kw)
    assert len(pstrips) > 1
    assert [dataclasses.asdict(a) for a in pstrips] == \
        [dataclasses.asdict(b) for b in rstrips]
    rwhole = RSch.compile_conv_block("L", h, w, c, m, **kw)
    padded = np.zeros((2, h + 2 * p, w + 2 * p, c))
    padded[:, p:p + h, p:p + w] = ifm
    pw = torch.from_numpy(wts)

    def striped(engine=None, handle=None):
        return torch.cat([
            TraceExecutor(st.sched, pw, engine=engine, handle=handle).run(
                torch.from_numpy(padded[:, :, st.lo:st.hi]))
            for st in pstrips], dim=2).numpy()

    assert _same(striped(), BlockSimulator(rwhole, wts).run(ifm))
    spec = RSpec(n_c=256, gain=6.0)
    ref = RE.CIMEngine(spec).set_layer("L", a_scale=0.1, gain=6.0)
    port = copy_calibration(ref, PE.CIMEngine(
        CIMSpec(**dataclasses.asdict(spec)), device="cpu"))
    slices = PE.conv_tile_slices(pstrips[0].sched)
    assert all(PE.conv_tile_slices(st.sched) == slices for st in pstrips)
    want = RTrace(rwhole, wts, engine=ref, handle=ref.conv_handle(
        "L", wts, RE.conv_tile_slices(rwhole))).run(ifm)
    got = striped(port, port.conv_handle("L", pw, slices))
    assert _same(got, want)


@pytest.fixture(scope="module")
def resnet_wide():
    """The 132-wide mini ResNet through both packages' serving route
    (quantized weights, CIM engine, calibration copied)."""
    rcnn, pcnn, params, x = _setup(_resnet_wide, 1, 4)
    rq = RS.quantize_cnn_params_for_serving(params)
    pq = PS.quantize_cnn_params_for_serving(
        params_from_reference(params, "cpu"))
    rsim = RS.build_stream_sim(rcnn, rq, calib_images=x[:2], dup_cap=128)
    psim = PS.build_stream_sim(pcnn, pq, engine=_port_engine(rsim),
                               device="cpu", dup_cap=128)
    return rsim, psim, x


def test_resnet_wide_strips_match_reference(resnet_wide):
    rsim, psim, _ = resnet_wide
    assert list(psim._strips) == list(rsim._strips) == [0]
    layer = psim.cnn.layers[0]
    assert layer.w + 2 * layer.p > TABLE_CAPACITY
    for pst, rst in zip(psim._strips[0], rsim._strips[0]):
        assert (pst.lo, pst.hi, pst.f0, pst.f1) == \
            (rst.lo, rst.hi, rst.f0, rst.f1)
        assert dataclasses.asdict(pst.sched) == dataclasses.asdict(rst.sched)
    assert len(psim._strips[0]) == 2
    # the pooled stem's strips cut on pool-stride boundaries
    assert all(st.f0 % layer.pool_s == 0 for st in psim._strips[0])


def test_resnet_wide_run_matches_reference(resnet_wide):
    rsim, psim, x = resnet_wide
    p, r = psim.run(x[:2]), rsim.run(x[:2])
    assert _same(p.logits.numpy(), r.logits)
    assert _same_counters(p.counters, r.counters)
    assert _same_traffic(p.traffic, r.traffic)


def test_resnet_wide_serve_stream_matches_reference(resnet_wide):
    rsim, psim, x = resnet_wide
    rrep = RS.serve_stream(rsim, x, batch_window=2)
    prep = PS.serve_stream(psim, x, batch_window=2)
    assert prep.measured_ii == prep.analytic_ii == rrep.measured_ii \
        == rrep.analytic_ii
    rres = rsim.run_stream(x, arrivals=rrep.arrivals, chunk=2)
    pres = psim.run_stream(x, arrivals=prep.arrivals, chunk=2)
    assert _same(prep.logits.numpy(), rres.logits)
    assert _same(pres.logits.numpy(), rres.logits)
    np.testing.assert_array_equal(pres.start, rres.start)
    np.testing.assert_array_equal(pres.finish, rres.finish)
    assert pres.residual_fifo_depth == rres.residual_fifo_depth
    assert all(_same_counters(a, b) for a, b in
               zip(pres.frame_counters, rres.frame_counters))
    assert all(_same_traffic(a, b) for a, b in
               zip(pres.frame_traffic, rres.frame_traffic))


# ---------------------------------------------------------------------------
# (c) the five CNN_BENCHMARKS at full width, host side
# ---------------------------------------------------------------------------

#: the reference bench's analytic II (``BENCH_core.json`` stream_* rows)
ANALYTIC_II = {"vgg11-cifar10": 16, "vgg16-imagenet": 784,
               "vgg19-imagenet": 784, "resnet18-cifar10": 16,
               "resnet50-imagenet": 98}


@pytest.mark.parametrize("name", list(RC.CNN_BENCHMARKS))
def test_benchmark_plans_strips_and_tables_match_reference(name):
    """Each layer's plan, its strips (count and bounds) or single
    schedule, and each FC grid's tables, equal to the reference's at
    full width (``dup_cap=128`` for resnet50, as the reference's bench
    serves it).  No weights: host code only."""
    dup_cap = 128 if name == "resnet50-imagenet" else 64
    rcnn, pcnn = RC.CNN_BENCHMARKS[name](), PC.CNN_BENCHMARKS[name]()
    rplan = RM.plan_network(rcnn, dup_cap=dup_cap)
    pplan = PM.plan_network(pcnn, dup_cap=dup_cap)
    assert dataclasses.asdict(pplan) == dataclasses.asdict(rplan)
    assert pplan.initiation_interval == rplan.initiation_interval \
        == ANALYTIC_II[name]
    n_strips = 0
    for layer, lp in zip(pcnn.layers, pplan.layers):
        if isinstance(layer, PC.FCLayer):
            args = ("fc", layer.c_in, layer.c_out, 256, 256, "relu")
            assert PSch.compile_fc_block(*args) == \
                RSch.compile_fc_block(*args)
            continue
        kw = dict(h=layer.h, w=layer.w, c_in=layer.c, c_out=layer.m,
                  k=layer.k, stride=layer.s, pad=layer.p, pack=lp.pack,
                  c_splits=lp.c_splits, pool_k=layer.pool_k,
                  pool_s=layer.pool_s)
        if layer.w + 2 * layer.p > TABLE_CAPACITY:
            ps = PSch.compile_conv_strips(layer.name, **kw)
            rs = RSch.compile_conv_strips(layer.name, **kw)
            assert len(ps) > 1
            assert [dataclasses.asdict(a) for a in ps] == \
                [dataclasses.asdict(b) for b in rs]
            f_total = (layer.w + 2 * layer.p - layer.k + layer.s) // layer.s
            assert ps[0].f0 == 0 and ps[-1].f1 == f_total
            assert all(a.f1 == b.f0 for a, b in zip(ps, ps[1:]))
            assert all(st.sched.wp <= TABLE_CAPACITY for st in ps)
            n_strips += len(ps)
        else:
            assert dataclasses.asdict(
                PSch.compile_conv_block(layer.name, **kw)) == \
                dataclasses.asdict(RSch.compile_conv_block(layer.name, **kw))
    # ImageNet widths need strips (vgg: the 224-wide layers; resnet50:
    # the stem); the CIFAR models none
    assert (n_strips > 0) == (rcnn.dataset == "imagenet")


def test_single_schedule_beyond_the_table_raises():
    with pytest.raises(ValueError):
        PSch.compile_conv_block("too-wide", 224, 224, 3, 64, 3, 1, 1)


# ---------------------------------------------------------------------------
# the stream timeline against its scalar oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(16))
def test_stream_timeline_vectorized_equals_scalar(seed):
    """Random arrival vectors and stage shapes, as the reference's
    property test draws them: the port's max-plus scan equals the port's
    copy of the per-cell recurrence, which equals the reference's."""
    rng = np.random.default_rng(seed)
    s_n = int(rng.integers(1, 8))
    t_n = int(rng.integers(1, 12))
    occ = rng.integers(1, 60, s_n).tolist()
    lat = [int(o + d) for o, d in zip(occ, rng.integers(0, 80, s_n))]
    arr = np.sort(rng.integers(0, 400, t_n)).astype(np.int64)
    start_v, finish_v = stream_timeline(arr, occ, lat)
    start_s, finish_s = stream_timeline_scalar(arr, occ, lat)
    start_r, finish_r = r_scalar(arr, occ, lat)
    for a, b, c in ((start_v, start_s, start_r),
                    (finish_v, finish_s, finish_r)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(b, c)
