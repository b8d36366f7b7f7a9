"""Card-only checks of serving at tp > 1 (marker ``cuda``; they skip
without a card).  Two ranks share ``cuda:0``, so their collectives take
the gloo transport's explicit host copies (``core/dataflow.py``): NCCL
refuses two ranks on one device.  No jax here.

* Two ranks run ``dataflow``'s four matmuls and the dispatchers on the
  card against the dense product of the same float32 inputs
  (tolerance 2e-5, as the CPU parity tests), and count host copies.
  In bfloat16 each output is within half a bfloat16 ulp (plus the
  float32 sum's 1e-5 relative) of the exact product of the rounded
  inputs: the partial products reach the ring's sum in float32 and
  only the finished sum is rounded, as the reference's
  ``preferred_element_type=float32`` does.
* A CUDA tensor on a gloo mesh without host copies raises.
* ``python -m repro_torch.launch.serve --tp 2 --backend gloo`` on the
  card says that its collectives cross the host (the one-card run does
  not); both serve.
* A rank that raises on the card fails the spawn.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_tp_ranks as R  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
TOL = 2e-5


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (ranks share cuda:0)")


@pytest.fixture(scope="module")
def ring_results(tmp_path_factory):
    _needs_card()
    return spawn(R.cuda_ring_cases, 2,
                 tmp_dir=str(tmp_path_factory.mktemp("ring")))


def _gathered(results, which, fn_name):
    parts = {res[which][fn_name][0]: res[which][fn_name][1].numpy()
             for res in results}
    axis = 1 if fn_name in R.DOWN else 2
    return np.concatenate([parts[(0, m)] for m in range(2)], axis=axis)


@pytest.mark.cuda
def test_ring_matmuls_on_the_card_match_the_dense_product(ring_results):
    x, w = R.dataflow_inputs()[:2]
    want = x.astype(np.float64) @ w.astype(np.float64)
    for fn_name in R.DATAFLOW_FNS:
        np.testing.assert_allclose(_gathered(ring_results, 0, fn_name),
                                   want, rtol=0, atol=TOL, err_msg=fn_name)
    for _, _, traffic in ring_results:
        assert traffic["host_copies"] > 0
        assert traffic["host_copies"] == traffic["collectives"]


@pytest.mark.cuda
def test_bf16_ring_matmuls_round_only_the_finished_sum(ring_results):
    x, w = (torch.from_numpy(a).to(torch.bfloat16).double().numpy()
            for a in R.dataflow_inputs()[:2])
    want = x @ w
    half_ulp = 2.0 ** (np.floor(np.log2(np.abs(want))) - 8)
    for fn_name in R.DATAFLOW_FNS:
        err = np.abs(_gathered(ring_results, 1, fn_name) - want)
        assert (err <= half_ulp + 1e-5 * np.abs(want)).all(), (
            fn_name, float((err / half_ulp).max()))


@pytest.mark.cuda
def test_cuda_tensors_on_gloo_need_host_copies(tmp_path):
    _needs_card()
    errors = spawn(R.cuda_without_host_copies, 2, tmp_dir=str(tmp_path))
    for err in errors:
        assert err is not None and "host_copies=True" in err


@pytest.mark.cuda
def test_serve_cli_over_gloo_says_it_copies_through_the_host():
    _needs_card()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "gemma3-1b", "--prompt-len", "32", "--gen", "4"]
    one = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=600)
    two = subprocess.run(cmd + ["--tp", "2", "--backend", "gloo"], env=env,
                         capture_output=True, text=True, timeout=600)
    assert one.returncode == 0, one.stderr
    assert two.returncode == 0, two.stderr
    assert "collectives cross the host" in two.stdout, two.stdout
    assert "collectives cross the host" not in one.stdout
    assert any(l.startswith("sample") for l in two.stdout.splitlines())


@pytest.mark.cuda
def test_a_failing_rank_on_the_card_fails_the_spawn(tmp_path):
    _needs_card()
    from repro_torch.launch.mesh import SpawnError

    with pytest.raises(SpawnError, match="on purpose") as err:
        spawn(R.cuda_failing_rank, 2, tmp_dir=str(tmp_path), timeout_s=120)
    assert next(iter(err.value.errors)) == 1  # the failing rank first
