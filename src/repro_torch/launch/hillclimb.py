"""Perf hillclimb runner: the reference's five tagged dry runs of three
cells on the single-pod production mesh (16, 16), baseline choices
against the levers (``launch/dryrun_lib.py``; rows on the H100).
``--device`` as in ``launch/dryrun.py``: the kernels' route by default;
each tag is kept in ``--out`` for its own route.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb [--device cuda|cpu]
"""
import argparse
import dataclasses
import json
import os
import sys
import time


def main(argv=None) -> int:
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.launch.dryrun import check_device
    from repro_torch.launch.dryrun_lib import (
        analyze_cell,
        dry_cell,
        parallel_config_for,
    )
    from repro_torch.launch.mesh import PRODUCTION_MESHES

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--out", default="results/torch_hillclimb.json")
    args = ap.parse_args(argv)
    check_device(ap, args.device)
    device = args.device
    mesh = PRODUCTION_MESHES["pod16x16"]
    axes = ("data", "model")
    out_path = args.out
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    results = {}
    if os.path.exists(out_path):
        with open(out_path) as f:
            results = json.load(f)

    def run(tag, arch, shape, pcfg):
        tag = f"{tag}|{device}"
        if tag in results:
            print(f"{tag}: cached")
            return
        t0 = time.time()
        try:
            cell = dry_cell(arch, shape, mesh, pcfg=pcfg, device=device)
            row = analyze_cell(cell, arch, shape, "pod16x16")
            row["status"] = "ok"
            row["device"] = device
        except Exception as e:  # noqa: BLE001
            row = {"status": "fail", "error": f"{type(e).__name__}: {e}"}
        row["run_s"] = time.time() - t0
        results[tag] = row
        with open(out_path, "w") as f:
            json.dump(results, f, indent=1, default=str)
        mem = row.get("memory") or {}
        print(f"{tag}: {row['status']} {row['run_s']:.0f}s "
              f"tC={row.get('t_compute_s', 0):.3g} "
              f"tM={row.get('t_memory_s', 0):.3g} "
              f"tX={row.get('t_collective_s', 0):.3g} "
              f"HBM={mem.get('total_GB', 0):.1f}GB "
              f"frac={row.get('roofline_fraction', 0):.3f}", flush=True)

    # ---- cell 1: deepseek-v3-671b x train_4k ----
    # v2a: ZeRO-3 param gathering (+ scattered grads via its transpose)
    cfg = get_config("deepseek-v3-671b")
    p = parallel_config_for(cfg, SHAPES["train_4k"], mesh)  # zero3 on
    run("deepseek_train|v2_zero3", "deepseek-v3-671b", "train_4k", p)

    # ---- cell 2: granite-moe x decode_32k ----
    # v2: sequence-sharded KV cache + LSE merge (heads don't divide tp)
    cfg = get_config("granite-moe-3b-a800m")
    p = parallel_config_for(cfg, SHAPES["decode_32k"], mesh)
    run("granite_decode|v2_seqcache", "granite-moe-3b-a800m", "decode_32k",
        p)

    # ---- cell 3: minitron-8b x train_4k ----
    # v2: pod-scale weight duplication (pure DP; paper Fig. 7 trade)
    p = ParallelConfig(reduction="ring", remat="full", microbatches=1,
                       zero_axes=axes, dp_only=True)
    run("minitron_train|v2_dup", "minitron-8b", "train_4k", p)

    # v2b for minitron: duplication + grad compression wire model (int8)
    p = ParallelConfig(reduction="ring", remat="full", microbatches=1,
                       zero_axes=axes, dp_only=True, grad_compression=True)
    run("minitron_train|v3_dup_comp", "minitron-8b", "train_4k", p)

    # granite v3: seq-cache + int8 KV (halve the dominant cache reads)
    p0 = parallel_config_for(get_config("granite-moe-3b-a800m"),
                             SHAPES["decode_32k"], mesh)
    p = dataclasses.replace(p0, kv_cache_dtype="int8")
    run("granite_decode|v3_int8", "granite-moe-3b-a800m", "decode_32k", p)
    return 0


if __name__ == "__main__":
    sys.exit(main())
