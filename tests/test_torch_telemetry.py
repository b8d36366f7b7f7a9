"""Port parity for telemetry: ``repro_torch.telemetry`` (heatmap,
metrics, spans — copied host code) against ``repro.telemetry``, driven
by the port's simulator on the CPU.

Tolerances, stated per check: none.  Per-link heatmaps, conservation
totals (heatmap == ``TrafficCounters`` == the analytic routed byte-hops,
the NoI level included), metrics snapshots and trace events are exact
integers or the same Python floats on both sides.  The registry cases
mirror ``tests/test_telemetry.py``'s, its error cases merged into one
parametrised test.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from conftest import int_params  # noqa: E402
from repro.configs import cnn as RC  # noqa: E402
from repro.core.energy import routed_byte_hops_per_class as r_analytic  # noqa: E402
from repro.core.network import NetworkSimulator as RSim  # noqa: E402
from repro.core.noc import shard_network as r_shard  # noqa: E402
from repro.runtime import serve_loop as RS  # noqa: E402
from repro.telemetry import MetricsRegistry as RReg  # noqa: E402
from repro.telemetry import record_run as r_record  # noqa: E402
from repro_torch.configs import cnn as PC  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.core.energy import routed_byte_hops_per_class  # noqa: E402
from repro_torch.core.network import NetworkSimulator  # noqa: E402
from repro_torch.core.noc import shard_network  # noqa: E402
from repro_torch.runtime import serve_loop as PS  # noqa: E402
from repro_torch.telemetry import (  # noqa: E402
    MetricsRegistry,
    Profiler,
    chrome_trace,
    check_conservation,
    load_chrome_trace,
    record_run,
    span,
    stream_timeline_events,
    validate_chrome_trace,
    write_chrome_trace,
)

ROOT = Path(__file__).resolve().parent.parent


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


CONFIGS = {"toy": _toy, "resnet-mini": _resnet_mini,
           "vgg11-cifar10": lambda m: m.CNN_BENCHMARKS["vgg11-cifar10"]()}


def _setup(name, batch=1, seed=0):
    rcnn, pcnn = CONFIGS[name](RC), CONFIGS[name](PC)
    rng = np.random.default_rng(seed)
    params = int_params(rcnn, rng)
    x = rng.integers(0, 2, (batch, rcnn.input_hw, rcnn.input_hw,
                            rcnn.layers[0].c)).astype(np.float64)
    return rcnn, pcnn, params, x


@pytest.mark.parametrize("chiplets", [1, 2])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_heatmap_conserved_and_equal_to_reference(name, chiplets):
    """Exact engine, integer params: the port's recorded heatmap equals
    its counters and the analytic routed byte-hops per class (on a
    2-chiplet floret shard, per level), and equals the reference's link
    by link."""
    rcnn, pcnn, params, x = _setup(name)
    rkw, pkw = {}, {}
    if chiplets > 1:
        rsim0 = RSim(rcnn, params, backend="trace")
        rkw["placement"] = r_shard(rsim0.plan, chiplets, noi="floret")
        psim0 = NetworkSimulator(pcnn, params_from_reference(params, "cpu"),
                                 device="cpu")
        pkw["placement"] = shard_network(psim0.plan, chiplets, noi="floret")
    rsim = RSim(rcnn, params, backend="trace", **rkw)
    psim = NetworkSimulator(pcnn, params_from_reference(params, "cpu"),
                            device="cpu", **pkw)
    res, rec = record_run(psim, x)
    assert psim.recorder is None
    analytic = routed_byte_hops_per_class(pcnn, psim.plan, psim.placement)
    assert check_conservation(rec.heatmap(), res.traffic, analytic,
                              flows=rec.flows.values()) == []
    assert (analytic.get("noi", 0) > 0) == (chiplets > 1)
    rres, rrec = r_record(rsim, x)
    assert analytic == r_analytic(rcnn, rsim.plan, rsim.placement)
    hm, rhm = rec.heatmap(), rrec.heatmap()
    assert hm.per_class == rhm.per_class
    assert hm.render() == rhm.render() and hm.to_csv() == rhm.to_csv()
    assert hm.top_links(10) == rhm.top_links(10)
    assert {k: vars(v) for k, v in rec.flows.items()} == \
        {k: vars(v) for k, v in rrec.flows.items()}
    np.testing.assert_allclose(res.logits.numpy(), rres.logits, rtol=1e-9)


@pytest.mark.parametrize("backend", ["interp", "trace"])
def test_telemetry_off_is_bit_identical(backend):
    """A recorder attached or a profiler installed changes nothing the
    run computes or counts, on the per-cycle interpreter and on the
    trace backend."""
    _, pcnn, params, x = _setup("toy")
    sim = NetworkSimulator(pcnn, params_from_reference(params, "cpu"),
                           backend=backend, engine="cim", calib_images=x,
                           device="cpu")
    plain = sim.run(x)
    recorded, _ = record_run(sim, x)
    with Profiler():
        profiled = sim.run(x)
    for other in (recorded, profiled):
        assert torch.equal(plain.logits, other.logits)
        assert dict(plain.traffic.byte_hops) == dict(other.traffic.byte_hops)
        assert plain.counters == other.counters


def test_span_is_one_shared_null_without_profiler():
    assert span("a") is span("b", cat="x", k=1)
    with Profiler() as prof, span("outer", depth=0), span("inner"):
        pass
    assert [e["ph"] for e in prof.events] == ["B", "B", "E", "E"]
    assert validate_chrome_trace(chrome_trace(prof.events)) == []
    assert span("a") is span("b")          # uninstalled on exit


# ---------------------------------------------------------------------------
# Metrics registry: Prometheus data-model semantics
# ---------------------------------------------------------------------------


def test_counter_and_gauge_semantics():
    reg = MetricsRegistry()
    c = reg.counter("reqs_total", "requests")
    c.inc()
    c.inc(4.0)
    g = reg.gauge("depth")
    g.set(7.0)
    g.inc(2.0)
    g.dec(3.0)
    snap = reg.snapshot()["metrics"]
    assert snap["reqs_total"]["series"][0]["value"] == 5.0
    assert snap["depth"]["series"][0]["value"] == 6.0
    assert snap["reqs_total"]["type"] == "counter"


def test_histogram_buckets_cumulative():
    reg = MetricsRegistry()
    h = reg.histogram("lat", buckets=(1.0, 5.0, 10.0))
    for v in (0.5, 1.0, 3.0, 10.0, 99.0):  # 1.0 lands IN the le=1 bucket
        h.observe(v)
    rec = reg.snapshot()["metrics"]["lat"]["series"][0]
    assert rec["count"] == 5
    assert rec["sum"] == pytest.approx(113.5)
    assert rec["buckets"] == {"1.0": 2, "5.0": 3, "10.0": 4, "+Inf": 5}


def test_labelled_series_and_idempotent_families():
    reg = MetricsRegistry()
    fam = reg.counter("frames_total", labelnames=("tenant",))
    fam.labels(tenant="a").inc(2.0)
    fam.labels(tenant="b").inc()
    again = reg.counter("frames_total", labelnames=("tenant",))
    assert again is fam
    again.labels(tenant="a").inc()
    snap = reg.snapshot()["metrics"]["frames_total"]
    assert snap["labelnames"] == ["tenant"]
    by_tenant = {s["labels"]["tenant"]: s["value"] for s in snap["series"]}
    assert by_tenant == {"a": 3.0, "b": 1.0}


def _neg_inc(reg):
    reg.counter("c").inc(-1.0)


def _unsorted(reg):
    reg.histogram("bad", buckets=(5.0, 1.0))


def _wrong_label(reg):
    reg.counter("f", labelnames=("tenant",)).labels(nope="x")


def _unlabelled_use(reg):
    reg.counter("f", labelnames=("tenant",)).inc()


def _kind_conflict(reg):
    reg.counter("x")
    reg.gauge("x")


def _labelnames_conflict(reg):
    reg.gauge("y", labelnames=("a",))
    reg.gauge("y", labelnames=("b",))


@pytest.mark.parametrize("misuse", [_neg_inc, _unsorted, _wrong_label,
                                    _unlabelled_use, _kind_conflict,
                                    _labelnames_conflict],
                         ids=lambda f: f.__name__.strip("_"))
def test_registry_misuse_raises(misuse):
    with pytest.raises(ValueError):
        misuse(MetricsRegistry())


def test_snapshot_is_json_serializable(tmp_path):
    reg = MetricsRegistry()
    reg.counter("c").inc()
    reg.histogram("h").observe(3.0)
    reg.gauge("g", labelnames=("t",)).labels(t="0").set(1.5)
    path = reg.to_json(str(tmp_path / "m.json"))
    with open(path) as f:
        assert json.load(f) == json.loads(json.dumps(reg.snapshot()))


# ---------------------------------------------------------------------------
# Chrome traces
# ---------------------------------------------------------------------------


def test_trace_round_trips_through_json(tmp_path):
    prof = Profiler()
    with prof, span("roundtrip", cat="host"):
        prof.instant("mark")
        prof.counter("queue", {"frames": 2.0})
    path = tmp_path / "t.json"
    write_chrome_trace(str(path), prof.events)
    doc = load_chrome_trace(str(path))
    assert validate_chrome_trace(doc) == []
    assert doc["traceEvents"] == chrome_trace(prof.events)["traceEvents"]


@pytest.mark.parametrize("doc,fragment", [
    ("nope", "top-level"),
    ({"nope": 1}, "traceEvents"),
    ({"traceEvents": [{"ph": "Z", "name": "x", "ts": 0.0,
                       "pid": 1, "tid": 1}]}, "unknown ph"),
    ({"traceEvents": [{"ph": "X", "name": 3, "ts": 0.0, "dur": 1.0,
                       "pid": 1, "tid": 1}]}, "name"),
    ({"traceEvents": [
        {"ph": "B", "name": "a", "ts": 1.0, "pid": 1, "tid": 1},
        {"ph": "E", "name": "b", "ts": 2.0, "pid": 1, "tid": 1},
    ]}, "closes"),
    ({"traceEvents": [
        {"ph": "B", "name": "a", "ts": 5.0, "pid": 1, "tid": 1},
        {"ph": "E", "name": "a", "ts": 1.0, "pid": 1, "tid": 1},
    ]}, "previous"),
    ({"traceEvents": [
        {"ph": "B", "name": "a", "ts": 1.0, "pid": 1, "tid": 1},
    ]}, "unclosed"),
    ({"traceEvents": [{"ph": "i", "name": "a", "ts": -1.0}]}, "bad ts"),
])
def test_validator_rejects_corrupt_traces(doc, fragment):
    errors = validate_chrome_trace(doc)
    assert errors, f"expected errors for {doc!r}"
    assert any(fragment in e for e in errors), errors


# ---------------------------------------------------------------------------
# Serving: metrics export and the stream timeline, against the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def stream_pair():
    rcnn, pcnn, params, x = _setup("resnet-mini", batch=4, seed=3)
    rsim = RS.build_stream_sim(rcnn, params)
    psim = PS.build_stream_sim(pcnn, params_from_reference(params, "cpu"),
                               device="cpu")
    return rcnn, pcnn, x, rsim, psim


def test_serve_stream_metrics_match_reference(stream_pair):
    rcnn, pcnn, frames, rsim, psim = stream_pair
    snaps = []
    for serve, sim, reg in ((RS.serve_stream, rsim, RReg()),
                            (PS.serve_stream, psim, MetricsRegistry())):
        serve(sim, frames, metrics=reg, metric_labels={"tenant": "t0"},
              batch_window=2)
        serve(sim, frames[:2], metrics=reg, metric_labels={"tenant": "t1"})
        serve(sim, frames[:0], metrics=reg, metric_labels={"tenant": "t2"})
        snaps.append(reg.snapshot())
    assert snaps[1] == snaps[0]
    series = snaps[1]["metrics"]["serve_frames_total"]["series"]
    assert {s["labels"]["tenant"]: s["value"] for s in series} == \
        {"t0": 4.0, "t1": 2.0, "t2": 0.0}


def test_stream_timeline_trace_matches_reference(stream_pair):
    rcnn, pcnn, frames, rsim, psim = stream_pair
    from repro.telemetry import stream_timeline_events as r_events

    res = psim.run_stream(frames, chunk=3)
    names = [pcnn.layers[st.li].name for st in psim._stages]
    events = stream_timeline_events(res, names)
    doc = chrome_trace(events)
    assert validate_chrome_trace(doc) == []
    by_ph = {}
    for e in doc["traceEvents"]:
        by_ph[e["ph"]] = by_ph.get(e["ph"], 0) + 1
    assert by_ph["X"] == len(names) * len(frames)
    assert by_ph["b"] == by_ph["e"] == len(frames) * (len(names) + 1)
    assert events == r_events(rsim.run_stream(frames, chunk=3), names)


def test_cli_heatmap_trace_summarize_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

    def cli(*args):
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.telemetry", *args], cwd=ROOT,
            env=env, capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        return proc.stdout

    out = cli("heatmap", "--device", "cpu", "--chiplets", "2", "--noi",
              "floret", "--csv", str(tmp_path / "links.csv"))
    assert "conservation: heatmap == counters == analytic" in out
    assert "noi" in out and (tmp_path / "links.csv").is_file()
    trace = tmp_path / "trace.json"
    cli("trace", str(trace), "--device", "cpu", "--frames", "2",
        "--metrics", str(tmp_path / "metrics.json"))
    assert "valid" in cli("summarize", str(trace))
    snap = json.loads((tmp_path / "metrics.json").read_text())
    assert snap["metrics"]["serve_frames_total"]["series"][0]["value"] == 2
