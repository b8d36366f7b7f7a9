"""CLI: explore Domino mapping spaces and print a Pareto report.

    PYTHONPATH=src python -m repro_torch.dse                  # CIFAR models
    PYTHONPATH=src python -m repro_torch.dse --models vgg16-imagenet --budget 64
    PYTHONPATH=src python -m repro_torch.dse --smoke          # CI-sized run
    PYTHONPATH=src python -m repro_torch.dse --robust --trials 20
    PYTHONPATH=src python -m repro_torch.dse --smoke --device cpu

The flags are the reference's (``python -m repro.dse``), plus
``--device``: the validation and accuracy simulations run on the card
by default, on the CPU only when asked.

``--smoke`` shrinks the space (two strategies, one aspect) and skips
nothing the acceptance cares about: the winner is still bitwise-
validated against the snake baseline.

``--robust`` runs the robustness DSE instead: mapping x bit-scalable
precision, with every precision point's top-1 agreement measured on the
compiled quantized trace path under the "all" device-variation corner
(``--trials`` Monte-Carlo draws each).  Exits non-zero if any model's
zero-magnitude variation run is not bitwise-equal to nominal.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.configs.cnn import CNN_BENCHMARKS
from repro_torch.dse.report import (
    robust_to_markdown,
    run_dse,
    run_robust_dse,
    to_json,
    to_markdown,
)
from repro_torch.dse.space import DesignSpace


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.dse", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--models", nargs="+",
                    default=["vgg11-cifar10", "resnet18-cifar10"],
                    choices=sorted(CNN_BENCHMARKS),
                    help="models to explore (default: the CIFAR pair)")
    ap.add_argument("--budget", type=int, default=128,
                    help="max configurations evaluated per model")
    ap.add_argument("--seed", type=int, default=0,
                    help="annealer seed (searches are deterministic)")
    ap.add_argument("--validate", choices=("none", "cifar10", "all"),
                    default="cifar10",
                    help="bitwise-check winners by simulating under the "
                         "found placement (default: CIFAR models)")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="also write the report as JSON")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny fixed-seed space for CI (<30 s)")
    ap.add_argument("--robust", action="store_true",
                    help="robustness DSE: precision axes + measured "
                         "accuracy-under-variation (see module docstring)")
    ap.add_argument("--trials", type=int, default=5,
                    help="Monte-Carlo draws per precision point "
                         "(--robust only)")
    ap.add_argument("--device", default=None,
                    help="device of the simulations (default: the card; "
                         "'cpu' runs the kernels' plain versions)")
    args = ap.parse_args(argv)

    if args.robust:
        budget = min(args.budget, 16) if args.smoke else args.budget
        reports = run_robust_dse(tuple(args.models), budget=budget,
                                 seed=args.seed, trials=args.trials,
                                 device=args.device)
        sys.stdout.write(robust_to_markdown(reports))
        bad = [r.model for r in reports if r.zero_var_bitwise is False]
        if bad:
            print(f"# ZERO-VARIATION PATH NOT BITWISE-EQUAL: {bad}",
                  file=sys.stderr)
            return 1
        return 0

    space_factory = None
    budget = args.budget
    if args.smoke:
        budget = min(budget, 16)

        def space_factory(cnn):
            return DesignSpace(
                cnn, strategy_names=("snake", "hilbert", "boustrophedon"),
                aspects=(1.0,), reuses=(1, 4), bands=(3,),
                dup_caps=(128 if cnn.name == "resnet50-imagenet" else 64,))

    reports = run_dse(args.models, budget=budget, seed=args.seed,
                      validate=args.validate, space_factory=space_factory,
                      device=args.device)
    sys.stdout.write(to_markdown(reports))
    if args.json:
        with open(args.json, "w") as f:
            f.write(to_json(reports))
        print(f"\n# wrote {args.json}")

    failed = [r.model for r in reports if r.validated is False]
    if failed:
        print(f"# BITWISE MISMATCH under winning placement: {failed}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
