"""Port parity for the Monte-Carlo robustness harness:
``repro_torch.runtime.robustness`` against ``repro.runtime.robustness`` on
the same numpy params, frames and float-reference logits.

Tolerances, stated per check:

* sweep numbers (``per_trial``, ``agree``, ``agree_float``,
  ``nominal_agree``) — equal, with the reference engine's calibration
  copied into the port's (``copy_calibration``) and the reference's
  ``ref_logits`` passed to both: the draws are the same numpy streams,
  ADC codes are integers and every float op of the quantized path is
  the same IEEE op, so the top-1 labels cannot differ;
* the perturbed logits of a trial — equal by value (``-0.0 == 0.0``,
  fault R1 of ROADMAP Queue 3);
* ``zero_var_bitwise`` — ``True`` (logits compared by value);
* the port's own float32 forward against the reference's — allclose,
  rtol 1e-5 with atol 1e-5 x the largest |logit| (torch and XLA round
  float32 partial sums in other orders, and logits near zero are
  differences of terms of the logits' own scale);
* ``FAULT_SMOKE_REF`` (``benchmarks/run.py``) — reproduced exactly by the
  port with its OWN calibration and its own float reference, from the
  reference's ``init_cnn(PRNGKey(0))`` params.
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from conftest import int_params  # noqa: E402
from repro.configs import cnn as RC  # noqa: E402
from repro.core import variation as RV  # noqa: E402
from repro.runtime import robustness as R  # noqa: E402
from repro_torch.configs import cnn as PC  # noqa: E402
from repro_torch.convert import copy_calibration, params_from_reference  # noqa: E402
from repro_torch.core import variation as PV  # noqa: E402
from repro_torch.core.cim import DEFAULT_SPEC  # noqa: E402
from repro_torch.core.engine import CIMEngine  # noqa: E402
from repro_torch.runtime import robustness as P  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PRESETS = tuple(RV.VARIATION_PRESETS)


@pytest.fixture(scope="module")
def vgg11():
    """vgg11-cifar10 at full width, batch 2 (``tests/test_variation.py``'s
    set-up): the reference's sweep simulator, the port's CPU simulator
    with the reference's calibration copied in, and the reference's
    float32 logits."""
    rng = np.random.default_rng(11)
    rcnn = RC.CNN_BENCHMARKS["vgg11-cifar10"]()
    pcnn = PC.CNN_BENCHMARKS["vgg11-cifar10"]()
    params = {k: v * 0.1 for k, v in int_params(rcnn, rng).items()}
    frames = rng.random((2, 32, 32, 3))
    rsim = R.build_robust_sim(rcnn, params, frames)
    pparams = params_from_reference(params, "cpu")
    psim = P.build_robust_sim(
        pcnn, pparams, frames, device="cpu",
        engine=copy_calibration(rsim.pe_engine, CIMEngine(device="cpu")))
    ref = R._float_reference(rcnn, params, frames)
    return dict(rcnn=rcnn, pcnn=pcnn, params=params, pparams=pparams,
                frames=frames, rsim=rsim, psim=psim, ref=ref)


def _same_report(p, r):
    assert p.per_trial == r.per_trial
    for f in ("agree", "agree_float"):  # TrialStats of either package
        assert dataclasses.astuple(getattr(p, f)) == \
            dataclasses.astuple(getattr(r, f)), f
    assert p.nominal_agree == r.nominal_agree
    assert p.zero_var_bitwise == r.zero_var_bitwise
    assert p.row() == r.row()


@pytest.mark.parametrize("preset", PRESETS)
def test_monte_carlo_sweep_matches_reference(vgg11, preset):
    v = vgg11
    r = R.monte_carlo_sweep(v["rcnn"], v["params"], v["frames"],
                            RV.VARIATION_PRESETS[preset], trials=2, seed0=5,
                            sim=v["rsim"], ref_logits=v["ref"])
    p = P.monte_carlo_sweep(v["pcnn"], v["pparams"], v["frames"],
                            PV.VARIATION_PRESETS[preset], trials=2, seed0=5,
                            sim=v["psim"], ref_logits=v["ref"])
    assert p.zero_var_bitwise is True and r.zero_var_bitwise is True
    _same_report(p, r)
    assert v["psim"].pe_engine.variation is None  # restored on exit
    # one trial's perturbed logits, equal by value
    v["rsim"].set_variation(RV.VARIATION_PRESETS[preset].reseed(6))
    v["psim"].set_variation(PV.VARIATION_PRESETS[preset].reseed(6))
    try:
        want = v["rsim"].run(v["frames"]).logits
        got = v["psim"].run(v["frames"]).logits
    finally:
        v["rsim"].set_variation(None)
        v["psim"].set_variation(None)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sweep_presets_matches_reference_and_shares_one_sim(vgg11,
                                                            monkeypatch):
    v = vgg11
    r = R.sweep_presets(v["rcnn"], v["params"], v["frames"],
                        presets=("noise", "adc"), trials=1)
    p = P.sweep_presets(v["pcnn"], v["pparams"], v["frames"],
                        presets=("noise", "adc"), trials=1, sim=v["psim"],
                        ref_logits=v["ref"])
    assert set(p) == set(r) == {"noise", "adc"}
    for name in p:
        _same_report(p[name], r[name])
    assert p["noise"].zero_var_bitwise is True   # checked on the first only
    assert p["adc"].zero_var_bitwise is None
    # built by the sweep itself: one simulator for every corner
    built = []
    real = P.build_robust_sim

    def counting(*a, **kw):
        built.append(real(*a, **kw))
        return built[-1]

    monkeypatch.setattr(P, "build_robust_sim", counting)
    out = P.sweep_presets(v["pcnn"], v["pparams"], v["frames"], trials=1,
                          device="cpu")
    assert len(built) == 1 and set(out) == set(PRESETS)
    assert len({o.nominal_agree for o in out.values()}) == 1
    assert built[0].pe_engine.variation is None


def test_float_reference_close_to_reference(vgg11):
    v = vgg11
    got = P._float_reference(v["pcnn"], v["pparams"], v["frames"], "cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    scale = float(np.abs(v["ref"]).max())
    np.testing.assert_allclose(got.numpy(), v["ref"], rtol=1e-5,
                               atol=1e-5 * scale)


def test_bad_arguments_raise(vgg11):
    v = vgg11
    with pytest.raises(ValueError, match="trials"):
        P.monte_carlo_sweep(v["pcnn"], v["pparams"], v["frames"],
                            PV.VARIATION_PRESETS["all"], trials=0,
                            sim=v["psim"])
    with pytest.raises(ValueError, match="quantized engine"):
        P._make_engine("exact", None)
    with pytest.raises(ValueError, match="spec"):
        P._make_engine(CIMEngine(device="cpu"), DEFAULT_SPEC)
    if not torch.cuda.is_available():  # the entry point defaults to the card
        with pytest.raises(RuntimeError):
            P.build_robust_sim(v["pcnn"], v["pparams"], v["frames"])


def _committed_stream():
    """jax's PRNG as it was when ``FAULT_SMOKE_REF`` was committed: jax
    0.5 made ``threefry_partitionable`` the default, which changes
    every ``jax.random`` draw; older jax has only the old stream."""
    import contextlib

    import jax

    if hasattr(jax, "threefry_partitionable"):
        return jax.threefry_partitionable(False)
    return contextlib.nullcontext()


def test_fault_smoke_reference_reproduced():
    """``python -m benchmarks.run --fault-smoke`` on the port: vgg11 at
    batch 4, the reference's ``init_cnn(PRNGKey(0))`` params (drawn with
    the PRNG stream the constant was committed under), 2 trials of the
    "all" corner.  The reference's own sweep gives ``FAULT_SMOKE_REF`` on
    these params, and so does the port, with its own calibration and
    its own float forward."""
    import jax

    from repro.models.cnn import init_cnn

    spec = importlib.util.spec_from_file_location(
        "_bench_run", ROOT / "benchmarks" / "run.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    cnn = RC.CNN_BENCHMARKS["vgg11-cifar10"]()
    with _committed_stream():
        params = {k: np.asarray(v, np.float64)
                  for k, v in init_cnn(jax.random.PRNGKey(0), cnn).items()}
    images = np.random.default_rng(0).random((4, 32, 32, 3))
    reps = {
        "reference": R.monte_carlo_sweep(
            cnn, params, images, RV.VARIATION_PRESETS["all"], trials=2,
            seed0=0),
        "port": P.monte_carlo_sweep(
            PC.CNN_BENCHMARKS["vgg11-cifar10"](),
            params_from_reference(params, "cpu"), images,
            PV.VARIATION_PRESETS["all"], trials=2, seed0=0, device="cpu")}
    for who, rep in reps.items():
        assert rep.zero_var_bitwise is True, who
        got = {"nominal_agree": round(rep.nominal_agree, 6),
               "agree": [round(a, 6) for a in rep.per_trial]}
        assert got == bench.FAULT_SMOKE_REF, who
