"""Port parity for the design-space exploration: ``repro_torch.dse``
against ``repro.dse`` (search, scoring, Pareto fronts and reports are
copied host code; validation and the robust DSE's accuracy probes run
the port's simulator, here on the CPU).

Tolerances, stated per check:

* ``validate_bitwise`` — ``True`` for every placement strategy under
  the exact and the CIM engine: the port's logits under a strategy's
  placement equal its snake logits by value;
* ``run_dse`` — winners, candidates, scores, rows and Pareto rows equal
  to the reference's exactly (host code, the same float operations);
* ``run_robust_dse`` — configs, TOPS/W and the front's membership equal;
  accuracies equal as well: the port calibrates every precision point
  with its own float forward, and on the toy model that calibration
  moves no top-1 label (the looser bound the contract allows, one frame
  of the batch, is not needed here).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.configs import cnn as RC  # noqa: E402
from repro.dse import report as RREP  # noqa: E402
from repro_torch.configs import cnn as PC  # noqa: E402
from repro_torch.dse import report as PREP  # noqa: E402
from repro_torch.dse.placements import strategies  # noqa: E402
from repro_torch.dse.search import evaluate  # noqa: E402
from repro_torch.dse.space import DesignSpace, MappingConfig  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _toy(m):
    """``tests/test_dse.py``'s toy CNN: packing, a C = 300 > n_c channel
    split, pools, an FC head."""
    return m.CNNConfig("toy", "cifar10", 8, (
        m.ConvLayer("c0", 8, 8, 3, 32, k=3, pool_k=2, pool_s=2),
        m.ConvLayer("c1", 4, 4, 32, 300, k=3),
        m.ConvLayer("c2", 4, 4, 300, 64, k=3, pool_k=2, pool_s=2),
        m.FCLayer("fc", 256, 10),
    ))


@pytest.fixture
def toy_registered(monkeypatch):
    """The toy CNN under the name "toy" in both packages' model tables."""
    monkeypatch.setitem(RC.CNN_BENCHMARKS, "toy", lambda: _toy(RC))
    monkeypatch.setitem(PC.CNN_BENCHMARKS, "toy", lambda: _toy(PC))


def _candidate_key(c):
    return (c.config.describe(), dataclasses.astuple(c.config),
            c.score.as_dict())


def _same_reports(port, ref):
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        assert p.model == r.model
        assert p.row() == r.row()
        assert p.pareto_rows() == r.pareto_rows()
        assert _candidate_key(p.winner) == _candidate_key(r.winner)
        assert [_candidate_key(c) for c in p.result.candidates] == \
            [_candidate_key(c) for c in r.result.candidates]
        assert p.result.evaluations == r.result.evaluations
    assert PREP.to_markdown(port) == RREP.to_markdown(ref)
    assert PREP.to_json(port) == RREP.to_json(ref)


CONFIGS = [MappingConfig(strategy=name, dup_cap=64)
           for name in strategies()] + [
    MappingConfig(strategy="snake", dup_cap=64, chiplets=2, noi="floret")]


@pytest.mark.parametrize("engine", ["exact", "cim"])
@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c.describe())
def test_validate_bitwise_every_strategy(cfg, engine):
    """vgg11 at full width under each strategy's placement (and a
    2-chiplet floret shard) against the snake baseline of the same plan,
    on both engines."""
    cnn = PC.CNN_BENCHMARKS["vgg11-cifar10"]()
    built = DesignSpace(cnn, dup_caps=(64,)).build(cfg)
    assert built is not None
    cand = evaluate(cnn, built)
    assert PREP.validate_bitwise(cnn, cand, engine=engine, device="cpu")


@pytest.mark.parametrize("model", ["toy", "vgg11-cifar10"])
def test_run_dse_matches_reference(model, toy_registered):
    ref = RREP.run_dse([model], budget=8, seed=0)
    port = PREP.run_dse([model], budget=8, seed=0, device="cpu")
    assert port[0].validated is True and ref[0].validated is True
    _same_reports(port, ref)


def test_run_dse_cim_spec_matches_reference(toy_registered):
    """The precision-aware energy model scores the candidates (quantized
    TOPS/W), and the winner validates on the CIM engine."""
    from repro.core.cim import CIMSpec as RSpec
    from repro_torch.core.cim import CIMSpec as PSpec

    kw = dict(n_c=256, adc_bits=6, w_bits=8, a_bits=8)
    ref = RREP.run_dse(["toy"], budget=8, seed=1, cim_spec=RSpec(**kw),
                       engine="cim")
    port = PREP.run_dse(["toy"], budget=8, seed=1, cim_spec=PSpec(**kw),
                        engine="cim", device="cpu")
    assert port[0].validated is True
    _same_reports(port, ref)


def test_run_robust_dse_matches_reference(toy_registered, monkeypatch):
    """The toy model's robust DSE with the reference's params injected
    into the port (its own ``init_cnn`` draws other numbers)."""
    import jax

    from repro.models.cnn import init_cnn

    ref_params = {k: np.asarray(v, np.float64) for k, v in
                  init_cnn(jax.random.PRNGKey(0), _toy(RC)).items()}

    def injected(cnn, generator=None, device=None, dtype=None):
        return {k: torch.from_numpy(v).to(device)
                for k, v in ref_params.items()}

    monkeypatch.setattr(PREP, "init_cnn", injected)
    kw = dict(budget=8, seed=0, trials=2, batch=4)
    ref = RREP.run_robust_dse(["toy"], **kw)
    port = PREP.run_robust_dse(["toy"], device="cpu", **kw)
    (r,), (p,) = ref, port
    assert p.zero_var_bitwise is True and r.zero_var_bitwise is True
    assert p.result.evaluations == r.result.evaluations
    got = [_candidate_key(c) for c in p.result.candidates]
    want = [_candidate_key(c) for c in r.result.candidates]
    assert [g[:2] for g in got] == [w[:2] for w in want]       # configs
    assert [g[2]["tops_per_w"] for g in got] == \
        [w[2]["tops_per_w"] for w in want]
    assert got == want                                         # accuracies
    assert [_candidate_key(c) for c in p.front] == \
        [_candidate_key(c) for c in r.front]
    assert p.pareto_rows() == r.pareto_rows()
    assert PREP.robust_to_markdown(port) == RREP.robust_to_markdown(ref)
    assert any(c.config.precision or c.config.base_bits != (8, 8, 8)
               for c in p.front)


def test_cli_smoke_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.dse", "--smoke", "--device",
         "cpu"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "vgg11-cifar10" in proc.stdout and "| ==" in proc.stdout
