"""Port parity for the per-cycle interpreter: ``repro_torch``
``BlockSimulator`` and ``NetworkSimulator(backend="interp")`` against the
reference's on the same numpy weights and frames, and against the port's
own trace backend.

Configs: the DSE suite's toy CNN (packing, a C = 300 > n_c split chain,
pools, an FC head), the trace suite's resnet-mini (identity and
projection shortcuts, global average pool + FC), the toy CNN with its
first layer cut into width strips, and width-striped blocks.

Tolerances, stated per check:

* quantized engines (``cim``, ``pallas``) — logits and block OFMs equal
  by value (ADC codes are integers; the reference itself disagrees on
  the sign of zero, ROADMAP R1), with the reference engine's
  calibration copied into the port's;
* exact engine — bitwise on integer-valued data (every float64 sum is
  exact), rtol 1e-12 on float data (torch and the reference's padded
  BLAS reduce a dot in other orders);
* counters, traffic and per-link traffic — identical (the same host
  code).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.configs import cnn as RC  # noqa: E402
from repro.core import engine as RE  # noqa: E402
from repro.core import network as RN  # noqa: E402
from repro.core.mapping import plan_network as r_plan  # noqa: E402
from repro.core.schedule import compile_conv_block as r_block  # noqa: E402
from repro.core.schedule import compile_conv_strips as r_strips  # noqa: E402
from repro.core.simulator import BlockSimulator as RBlock  # noqa: E402
from repro.core.variation import VARIATION_PRESETS as R_PRESETS  # noqa: E402
from repro.dse.placements import strategies as r_strategies  # noqa: E402
from repro_torch.configs import cnn as PC  # noqa: E402
from repro_torch.convert import copy_calibration, params_from_reference  # noqa: E402
from repro_torch.core import engine as PE  # noqa: E402
from repro_torch.core import network as PN  # noqa: E402
from repro_torch.core.engine import CIMEngine, conv_tile_slices  # noqa: E402
from repro_torch.core.mapping import plan_network  # noqa: E402
from repro_torch.core.network import NetworkSimulator  # noqa: E402
from repro_torch.core.schedule import compile_conv_block as p_block  # noqa: E402
from repro_torch.core.schedule import compile_conv_strips as p_strips  # noqa: E402
from repro_torch.core.simulator import BlockSimulator, mac_slots  # noqa: E402
from repro_torch.core.variation import VARIATION_PRESETS  # noqa: E402
from repro_torch.dse.placements import strategies  # noqa: E402
from conftest import int_params  # noqa: E402
from test_torch_network import CONFIGS  # noqa: E402
from test_torch_network import _setup as _float_setup  # noqa: E402

RSim = RN.NetworkSimulator


def _setup(name, seed=0, frames=2, integer=False):
    """(reference config, port config, params, frames): integer-valued
    (``int_params``, frames in {0, 1}) or the parity suite's floats."""
    if not integer:
        return _float_setup(name, seed, frames)
    rcnn, pcnn = CONFIGS[name](RC), CONFIGS[name](PC)
    rng = np.random.default_rng(seed)
    params = int_params(rcnn, rng)
    x = rng.integers(0, 2, (frames, rcnn.input_hw, rcnn.input_hw,
                            rcnn.layers[0].c)).astype(np.float64)
    return rcnn, pcnn, params, x


def _counters(res):
    return dataclasses.asdict(res.counters)


def _traffic(res):
    return {f: dict(getattr(res.traffic, f))
            for f in ("byte_hops", "packets", "hops")}


def _links(sim):
    return dict(sim.placement.noc.link_traffic)


def _same(a, b):
    """Equal by value (``-0.0 == 0.0``)."""
    return a.shape == b.shape and torch.equal(a + 0.0, b + 0.0)


@functools.lru_cache(maxsize=None)
def _quantized(name, engine):
    """(reference interp sim, port interp sim, port trace sim, frames) on
    a quantized engine, the reference's calibration copied into both
    port engines (built once per module run)."""
    rcnn, pcnn, params, x = _setup(name)
    ref = RSim(rcnn, params, backend="interp", engine=engine,
               calib_images=x)
    p = params_from_reference(params, "cpu")
    ports = [NetworkSimulator(pcnn, p, backend=backend,
                              engine=copy_calibration(
                                  ref.pe_engine, CIMEngine(device="cpu")),
                              device="cpu")
             for backend in ("interp", "trace")]
    return ref, ports[0], ports[1], x


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("engine", ["cim", "pallas"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_interp_matches_reference_quantized(name, engine, batch):
    """Logits by value, counters, traffic and per-link traffic equal to
    the reference interpreter's; the port's interp equals its trace."""
    ref, port, trace, x = _quantized(name, engine)
    x = x[:batch]
    r = ref.run(x)
    p = port.run(x)
    assert p.logits.dtype == torch.float64
    assert _same(p.logits, torch.from_numpy(r.logits))
    assert _counters(p) == _counters(r) and _traffic(p) == _traffic(r)
    assert _links(port) == _links(ref)
    t = trace.run(x)
    assert _same(p.logits, t.logits)
    assert _counters(p) == _counters(t) and _traffic(p) == _traffic(t)
    assert _links(port) == _links(trace)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_interp_variation_matches_reference(name):
    """Every variation source attached through ``set_variation``: the
    rebuilt handles reach the interpreter; logits equal the reference's
    and the port's trace's."""
    rcnn, pcnn, params, x = _setup(name, seed=2)
    ref = RSim(rcnn, params, backend="interp", engine="cim", calib_images=x)
    p = params_from_reference(params, "cpu")
    port, trace = (NetworkSimulator(
        pcnn, p, backend=b, device="cpu",
        engine=copy_calibration(ref.pe_engine, CIMEngine(device="cpu")))
        for b in ("interp", "trace"))
    nominal = port.run(x).logits
    ref.set_variation(R_PRESETS["all"])
    for sim in (port, trace):
        sim.set_variation(VARIATION_PRESETS["all"])
    r, got = ref.run(x), port.run(x)
    assert _same(got.logits, torch.from_numpy(r.logits))
    assert not _same(got.logits, nominal)
    assert _same(got.logits, trace.run(x).logits)
    assert _counters(got) == _counters(r) and _traffic(got) == _traffic(r)
    port.set_variation(None)
    assert _same(port.run(x).logits, nominal)


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_interp_exact_engine(name, integer):
    """Exact engine: bitwise on integer data, rtol 1e-12 on float data,
    against the reference interpreter and the port's trace; B = 1 and
    B = 2; counters and traffic identical."""
    rcnn, pcnn, params, x = _setup(name, seed=3, integer=integer)
    ref = RSim(rcnn, params, backend="interp")
    p = params_from_reference(params, "cpu")
    port = NetworkSimulator(pcnn, p, backend="interp", device="cpu")
    trace = NetworkSimulator(pcnn, p, device="cpu")
    for xb in (x, x[:1]):
        r, got, t = ref.run(xb), port.run(xb), trace.run(xb)
        if integer:
            assert np.array_equal(got.logits.numpy(), r.logits)
            assert torch.equal(got.logits, t.logits)
        else:
            np.testing.assert_allclose(got.logits.numpy(), r.logits,
                                       rtol=1e-12, atol=0)
            np.testing.assert_allclose(got.logits.numpy(), t.logits.numpy(),
                                       rtol=1e-12, atol=0)
        assert _counters(got) == _counters(r) == _counters(t)
        assert _traffic(got) == _traffic(r) == _traffic(t)
        assert _links(port) == _links(ref)


def _striped(monkeypatch, module, capacity):
    """Run every layer wider than ``capacity`` as width strips."""
    monkeypatch.setattr(module, "TABLE_CAPACITY", capacity)
    monkeypatch.setattr(module, "compile_conv_strips", functools.partial(
        module.compile_conv_strips, capacity=capacity))


def test_interp_width_strips_network(monkeypatch):
    """The toy CNN's first layer (period 10) cut into strips at a
    9-entry table: the strips keep their halo columns, logits equal the
    reference's strips by value (CIM) and the unstriped run's, counters
    and traffic equal the reference's."""
    rcnn, pcnn, params, x = _setup("toy", seed=4)
    whole = RSim(rcnn, params, backend="interp", engine="cim",
                 calib_images=x)
    _striped(monkeypatch, RN, 9)
    _striped(monkeypatch, PN, 9)
    ref = RSim(rcnn, params, backend="interp", engine=whole.pe_engine)
    port = NetworkSimulator(
        pcnn, params_from_reference(params, "cpu"), backend="interp",
        engine=copy_calibration(ref.pe_engine, CIMEngine(device="cpu")),
        device="cpu")
    assert set(port._strips) == set(ref._strips) == {0}
    assert len(port._strips[0]) > 1
    r, got = ref.run(x), port.run(x)
    assert _same(got.logits, torch.from_numpy(r.logits))
    assert _same(got.logits, torch.from_numpy(whole.run(x).logits))
    assert _counters(got) == _counters(r) and _traffic(got) == _traffic(r)
    assert _links(port) == _links(ref)


@pytest.mark.parametrize("pool", [False, True])
def test_width_strips_block_bitwise(pool):
    """A block run as width strips (a tiny table capacity forces several)
    gives the whole block's OFM, pooling included, bitwise on integer
    data, as the reference's blocks do; on the CIM engine the strips
    (one shared handle) equal the reference's by value."""
    rng = np.random.default_rng(5)
    if pool:
        h, w, c, m, k, s, p, cap, kw = 8, 16, 2, 3, 3, 1, 1, 10, dict(
            pool_k=2, pool_s=2)
    else:
        h, w, c, m, k, s, p, cap, kw = 9, 21, 2, 3, 3, 2, 1, 9, {}
    ifm = rng.integers(-4, 5, (2, h, w, c)).astype(np.float64)
    wts = rng.integers(-4, 5, (k, k, c, m)).astype(np.float64)
    padded = np.zeros((2, h + 2 * p, w + 2 * p, c))
    padded[:, p:p + h, p:p + w] = ifm
    tw, tp = torch.from_numpy(wts), torch.from_numpy(padded)
    whole = BlockSimulator(p_block("whole", h, w, c, m, k, s, p, **kw),
                           tw).run(torch.from_numpy(ifm))
    r_whole = RBlock(r_block("whole", h, w, c, m, k, s, p, **kw),
                     wts).run(ifm)
    assert np.array_equal(whole.numpy(), r_whole)
    strips = p_strips("striped", h, w, c, m, k, s, p, capacity=cap, **kw)
    rstrips = r_strips("striped", h, w, c, m, k, s, p, capacity=cap, **kw)
    assert len(strips) > 1
    parts = [BlockSimulator(st.sched, tw).run(tp[:, :, st.lo:st.hi])
             for st in strips]
    assert torch.equal(torch.cat(parts, dim=2), whole)
    # CIM: one handle for every strip (same tile chain), as the network
    reng = RE.CIMEngine().set_layer("striped", a_scale=0.05)
    peng = PE.CIMEngine(device="cpu").set_layer("striped", a_scale=0.05)
    rh = reng.conv_handle("striped", wts,
                          RE.conv_tile_slices(rstrips[0].sched))
    ph = peng.conv_handle("striped", tw, conv_tile_slices(strips[0].sched))
    got = torch.cat([BlockSimulator(st.sched, tw, engine=peng, handle=ph)
                     .run(tp[:, :, st.lo:st.hi]) for st in strips], dim=2)
    want = np.concatenate([RBlock(st.sched, wts, engine=reng, handle=rh)
                           .run(padded[:, :, st.lo:st.hi])
                           for st in rstrips], axis=2)
    assert _same(got, torch.from_numpy(want))


def test_every_placement_bitwise_on_interpreter():
    """Every DSE strategy's placement keeps the interpreter's routed
    packets on their rendezvous slots: logits bitwise equal to the snake
    placement's, MACs equal, and counters and traffic equal to the
    reference interpreter's under the same placement."""
    rcnn, pcnn, params, x = _setup("toy", seed=6, integer=True)
    p = params_from_reference(params, "cpu")
    base = NetworkSimulator(pcnn, p, backend="interp", device="cpu").run(x)
    plan, rplan = plan_network(pcnn), r_plan(rcnn)
    rstrats = r_strategies(rcnn)
    for name, strat in strategies(pcnn).items():
        res = NetworkSimulator(pcnn, p, backend="interp", device="cpu",
                               placement=strat.place(plan)).run(x)
        ref = RSim(rcnn, params, backend="interp",
                   placement=rstrats[name].place(rplan)).run(x)
        assert torch.equal(res.logits, base.logits), name
        assert res.counters.macs == base.counters.macs
        assert np.array_equal(res.logits.numpy(), ref.logits)
        assert _counters(res) == _counters(ref)
        assert _traffic(res) == _traffic(ref)


@pytest.mark.parametrize("engine", ["exact", "cim", "pallas"])
def test_short_window_tile_mac_matches_reference(engine):
    """After a row restart the Rifm shift buffer holds fewer than
    ``pack`` pixels: a tile MAC over n < pack taps meets the tile's
    first n weight taps on both sides (the port slices the stacked
    weights by the taps' width, the reference its per-tile taps)."""
    rng = np.random.default_rng(7)
    sched = p_block("c0", 8, 8, 3, 32, 3, 1, 1, pack=3)
    assert max(tt.pack for tt in conv_tile_slices(sched)) == 3
    wts = rng.standard_normal((3, 3, 3, 32)) / 3
    if engine == "exact":
        reng, peng = RE.ExactEngine(), PE.ExactEngine("cpu")
    else:
        reng = (RE.CIMEngine() if engine == "cim" else RE.PallasEngine())
        reng.set_layer("c0", a_scale=0.01)
        peng = PE.CIMEngine(device="cpu").set_layer("c0", a_scale=0.01)
    rh = reng.conv_handle("c0", wts, RE.conv_tile_slices(sched))
    ph = peng.conv_handle("c0", torch.from_numpy(wts),
                          conv_tile_slices(sched))
    px = rng.standard_normal((3, 2, 3))
    rq = reng.quant_stream(rh, px)
    pq = peng.quant_stream(ph, torch.from_numpy(px))
    for t in range(len(sched.tiles)):
        for n in (1, 2, 3):
            want = reng.tile_mac(rh, t, list(rq[:n]), quantized=True)
            got = peng.tile_mac(ph, t, list(pq[:n]))
            if engine == "exact":
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
            else:
                assert _same(got, torch.from_numpy(want)), (t, n)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_mac_slots_count_the_interpreters_macs(name, monkeypatch):
    """``mac_slots`` (the decoded tables' MAC-firing slots) is the number
    of engine MACs an interpreter run makes: chain length x E x F per
    block."""
    _, pcnn, params, x = _setup(name, seed=8)
    sim = NetworkSimulator(pcnn, params_from_reference(params, "cpu"),
                           backend="interp", device="cpu")
    calls = []
    real = PE.ExactEngine.tile_mac
    monkeypatch.setattr(PE.ExactEngine, "tile_mac", lambda self, h, t, taps:
                        calls.append(t) or real(self, h, t, taps))
    sim.run(x)
    scheds = [s for s in sim.schedules if s is not None]
    assert len(calls) == sum(mac_slots(s) for s in scheds)
    assert all(mac_slots(s) == s.chain_len * s.e * s.f for s in scheds)

