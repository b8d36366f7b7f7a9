"""The port stands alone: no ``repro_torch`` module and no part of
``chip_smoke.py`` imports ``jax`` or the reference package ``repro``, and
``chip_smoke.py`` refuses to report a result without a card or without
the port beside it."""
import ast
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"


def _port_modules():
    import repro_torch

    names = ["repro_torch"]
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(info.name)
    return names


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.") or name == "repro"
            or name.startswith("repro."))


#: modules of the robustness, DSE, telemetry and chiplet slice, of the
#: CNN simulator's CIM layer wrapper, of the training path, of serving
#: at tp > 1 and of the dry run, that the walk must reach (the CLIs are
#: imported, not run)
SLICE_MODULES = ("repro_torch.dse", "repro_torch.dse.__main__",
                 "repro_torch.dse.report", "repro_torch.runtime.robustness",
                 "repro_torch.telemetry.heatmap",
                 "repro_torch.telemetry.__main__", "repro_torch.kernels.ops",
                 "repro_torch.tree", "repro_torch.optim.optimizer",
                 "repro_torch.data.pipeline", "repro_torch.checkpoint.manager",
                 "repro_torch.runtime.fault", "repro_torch.runtime.train_loop",
                 "repro_torch.launch.train", "repro_torch.launch.mesh",
                 "repro_torch.core.dataflow", "repro_torch.runtime.partition",
                 "repro_torch.compat", "repro_torch.analysis.op_stats",
                 "repro_torch.analysis.roofline", "repro_torch.analysis.report",
                 "repro_torch.launch.inputs", "repro_torch.launch.dryrun_lib",
                 "repro_torch.launch.dryrun", "repro_torch.launch.hillclimb")


def test_every_port_module_imports_without_jax_or_reference():
    mods = _port_modules()
    assert "repro_torch.core.network" in mods and len(mods) > 15
    missing = [m for m in SLICE_MODULES if m not in mods]
    assert not missing, missing
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_imports_nothing_of_jax_or_reference():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert "repro_torch.runtime.serve_loop" in names
    assert not [n for n in names if _forbidden(n)], names


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_card_or_port(alone, tmp_path):
    """Without a card (here) it exits non-zero and prints no result; in
    a directory holding only the script it cannot find the port."""
    import torch

    if alone:
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    else:
        if torch.cuda.is_available():
            pytest.skip("checks the no-card behaviour")
        cwd = ROOT
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
