"""Render a dry run's JSON (``launch/dryrun.py``) as the roofline
table: the reference's ``repro/analysis/report.py`` table, on the same
keys.  A row holds the route it counted (``device``: ``cuda`` the
kernels', ``cpu`` the CPU's plain route); one table shows one route.

  PYTHONPATH=src python -m repro_torch.analysis.report [mesh] [reduction] \
      [cuda|cpu]
"""
from __future__ import annotations

import json
import sys
from typing import Optional


def fmt_t(x: float) -> str:
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.2f}ms"
    return f"{x*1e6:.1f}us"


def render(path: str = "results/torch_dryrun.json", mesh: str = "pod16x16",
           reduction: str = "ring", device: Optional[str] = None) -> str:
    """The table of ``mesh``'s cells under ``reduction``, of the rows of
    route ``device`` only where it is given; rows of two routes in one
    table raise."""
    with open(path) as f:
        data = json.load(f)
    rows, skips, fails = [], [], []
    routes = set()
    for key, r in sorted(data.items()):
        if device is not None and r.get("device") != device:
            continue
        if f"|{mesh}|" not in key and r.get("mesh") != mesh:
            continue
        if f"|{mesh}" not in key:
            continue
        if reduction not in key and r.get("reduction", "ring") != reduction:
            continue
        routes.add(r.get("device"))
        if r["status"] == "skip":
            skips.append(f"- `{r['arch']} x {r['shape']}`: {r['reason']}")
            continue
        if r["status"] == "fail":
            fails.append(f"- `{key}`: {r['error'][:160]}")
            continue
        rows.append(r)
    if len(routes) > 1:
        raise ValueError(f"{path} holds {mesh}'s cells of the routes "
                         f"{sorted(map(str, routes))}: pass device= to show "
                         "one")

    out = [f"| arch | shape | t_compute | t_memory | t_collective | "
           f"bottleneck | HBM/dev GB | useful-FLOPs | roofline frac |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        mem = r.get("memory") or {}
        out.append(
            f"| {r['arch']} | {r['shape']} | {fmt_t(r['t_compute_s'])} | "
            f"{fmt_t(r['t_memory_s'])} | {fmt_t(r['t_collective_s'])} | "
            f"**{r['bottleneck']}** | {mem.get('total_GB', 0):.2f} | "
            f"{r['useful_flops_frac']:.2f} | {r['roofline_fraction']:.3f} |")
    if skips:
        out.append("")
        out.append("Skipped cells (per DESIGN.md §Arch-applicability):")
        out.extend(sorted(set(skips)))
    if fails:
        out.append("")
        out.append("FAILED cells:")
        out.extend(fails)
    return "\n".join(out)


if __name__ == "__main__":
    mesh = sys.argv[1] if len(sys.argv) > 1 else "pod16x16"
    red = sys.argv[2] if len(sys.argv) > 2 else "ring"
    dev = sys.argv[3] if len(sys.argv) > 3 else None
    print(render(mesh=mesh, reduction=red, device=dev))
