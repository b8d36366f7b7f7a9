"""The dry-run CLI over the production meshes.

Runs one rank's train step or serve step of every (architecture x
input-shape) cell on fake tensors over a fake process group
(``launch/dryrun_lib.py``) on the reference's production meshes:

  * single-pod: 16 x 16 = 256 ranks, axes (data, model)
  * multi-pod:  2 x 16 x 16 = 512 ranks, folded into (32, 16) over
    (data, model) (``launch/mesh.py``)

and records each cell's counts, memory and roofline row on the H100
(``analysis/roofline.py``).  ``--device cuda`` (the default) counts the
kernels' route, the program the card runs: fake CUDA tensors, which a
torch built with CUDA is needed to index (no card).  ``--device cpu``
counts the CPU's plain route instead, whose plain versions hold what the
kernels do not (a prefill's dense S x S attention scores): it is not the
card's program, and is only asked for by name.  Each row records its
route, a cell is kept in ``--out`` for its own route only, and the
report (``analysis/report.py``) refuses a table that mixes the two.
Usage:

  PYTHONPATH=src python -m repro_torch.launch.dryrun \\
      [--arch qwen2-0.5b ...] [--shape train_4k ...] \\
      [--mesh single|multi|both] [--reduction ring|allreduce] \\
      [--device cuda|cpu] [--out results/torch_dryrun.json]
"""
import argparse
import os
import sys


def check_device(ap: argparse.ArgumentParser, device: str) -> None:
    """Refuse the kernels' route on a torch built without CUDA: fake
    CUDA tensors need its device guard (not a card)."""
    import torch

    if device == "cuda" and not torch.backends.cuda.is_built():
        ap.error("--device cuda (the kernels' route, the default) needs a "
                 "torch built with CUDA; this one has none.  Pass --device "
                 "cpu to count the CPU's plain route instead (dense "
                 "attention in place of the kernels: not the card's "
                 "program)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="*", default=None)
    ap.add_argument("--shape", nargs="*", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--reduction", choices=["ring", "allreduce"],
                    default="ring")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--out", default="results/torch_dryrun.json")
    args = ap.parse_args(argv)
    check_device(ap, args.device)

    from repro_torch.configs import ASSIGNED_ARCHS, SHAPES
    from repro_torch.launch.dryrun_lib import run_matrix
    from repro_torch.launch.mesh import PRODUCTION_MESHES

    archs = args.arch or list(ASSIGNED_ARCHS)
    shapes = args.shape or list(SHAPES)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    names = []
    if args.mesh in ("single", "both"):
        names.append("pod16x16")
    if args.mesh in ("multi", "both"):
        names.append("2xpod16x16")
    n_fail = 0
    for name in names:
        results = run_matrix(archs, shapes, PRODUCTION_MESHES[name], name,
                             args.out, reduction=args.reduction,
                             device=args.device)
        n_fail += sum(1 for r in results.values()
                      if r.get("status") == "fail")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
