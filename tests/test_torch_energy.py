"""Port parity for the analytic energy model: ``repro_torch.core.energy``
(a copy of the reference's host code) against ``repro.core.energy`` on
all five ``CNN_BENCHMARKS``.

Tolerance: none — every report field, every derived metric and every
per-class routed byte-hop count is equal, as Python floats and ints
(the same host code does the same float operations in the same order).
"""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro.configs import cnn as RC  # noqa: E402
from repro.core import cim as RCim  # noqa: E402
from repro.core import energy as RE  # noqa: E402
from repro.core import mapping as RM  # noqa: E402
from repro.core import noc as RN  # noqa: E402
from repro_torch.configs import cnn as PC  # noqa: E402
from repro_torch.core import cim as PCim  # noqa: E402
from repro_torch.core import energy as PE  # noqa: E402
from repro_torch.core import mapping as PM  # noqa: E402
from repro_torch.core import noc as PN  # noqa: E402

MODELS = tuple(RC.CNN_BENCHMARKS)
#: the flat Tab. 4 model, the default CIM spec, and a 6-bit one
SPECS = {"flat": None, "cim-8b": {}, "cim-6b": dict(w_bits=6, a_bits=6,
                                                   adc_bits=6)}
DERIVED = ("e_total", "inferences_per_s", "power_w", "ops_per_inference",
           "ce_tops_per_w", "throughput_tops", "area_mm2",
           "throughput_tops_mm2", "mops_per_8b_cell", "adc_share")


def _dup_cap(name):
    return 128 if name == "resnet50-imagenet" else 64


def _spec(mod, key):
    kw = SPECS[key]
    return None if kw is None else mod.CIMSpec(**kw)


def _same(p, r):
    assert dataclasses.asdict(p) == dataclasses.asdict(r)
    for prop in DERIVED:
        assert getattr(p, prop) == getattr(r, prop), prop
    assert p.breakdown() == r.breakdown()


@pytest.mark.parametrize("spec", list(SPECS))
@pytest.mark.parametrize("name", MODELS)
def test_analyze_matches_reference(name, spec):
    r = RE.analyze(RC.CNN_BENCHMARKS[name](), dup_cap=_dup_cap(name),
                   cim_spec=_spec(RCim, spec))
    p = PE.analyze(PC.CNN_BENCHMARKS[name](), dup_cap=_dup_cap(name),
                   cim_spec=_spec(PCim, spec))
    _same(p, r)


#: placements: the default snake mesh, and 2- and 4-chiplet shards over
#: both NoI topologies (the "noi" level of routed byte-hops)
PLACEMENTS = [(1, "mesh"), (2, "mesh"), (4, "floret")]


@pytest.mark.parametrize("chiplets,noi", PLACEMENTS)
@pytest.mark.parametrize("name", MODELS)
def test_analyze_plan_and_routed_byte_hops_match_reference(name, chiplets,
                                                           noi):
    rcnn, pcnn = RC.CNN_BENCHMARKS[name](), PC.CNN_BENCHMARKS[name]()
    rplan = RM.plan_network(rcnn, dup_cap=_dup_cap(name))
    pplan = PM.plan_network(pcnn, dup_cap=_dup_cap(name))
    if chiplets == 1:
        rpl, ppl = RN.place_network(rplan), PN.place_network(pplan)
    else:
        rpl = RN.shard_network(rplan, chiplets, noi=noi)
        ppl = PN.shard_network(pplan, chiplets, noi=noi)
    want = RE.routed_byte_hops_per_class(rcnn, rplan, rpl)
    assert PE.routed_byte_hops_per_class(pcnn, pplan, ppl) == want
    assert (want.get("noi", 0) > 0) == (chiplets > 1)
    # per-layer precision: the first conv and the head at (6, 6, 4)
    names = [l.name for l in rcnn.layers]
    for spec in SPECS:
        rs, ps = _spec(RCim, spec), _spec(PCim, spec)
        kw_r = dict(placement=rpl, cim_spec=rs)
        kw_p = dict(placement=ppl, cim_spec=ps)
        if rs is not None:
            kw_r["layer_specs"] = {n: dataclasses.replace(
                rs, w_bits=6, a_bits=6, adc_bits=4) for n in
                (names[0], names[-1])}
            kw_p["layer_specs"] = {n: dataclasses.replace(
                ps, w_bits=6, a_bits=6, adc_bits=4) for n in
                (names[0], names[-1])}
        _same(PE.analyze_plan(pcnn, pplan, **kw_p),
              RE.analyze_plan(rcnn, rplan, **kw_r))


def test_step_clock_and_tab3_constants():
    for key in ("STEP_CLOCK_HZ", "AREA_PER_TILE_MM2", "PSUM_BYTES",
                "E_ADC_8B"):
        assert getattr(PE, key) == getattr(RE, key), key
    for bits in (4, 6, 8):
        assert PE.adc_conversion_energy(bits) == \
            RE.adc_conversion_energy(bits)
