"""Telemetry CLI: render link heatmaps, capture traces, summarize them.

Subcommands::

    python -m repro_torch.telemetry heatmap --model vgg11-cifar10 [--csv out.csv]
        run the model once (trace backend, seeded integer params) with a
        LinkRecorder attached, verify the three-way conservation
        (heatmap == TrafficCounters == analytic routed byte-hops) and
        render the mesh heatmap + hottest links

    python -m repro_torch.telemetry trace out.json --model vgg11-cifar10
        capture a Chrome trace of a short streaming serve: host spans
        (lowering, calibration, executor build) + the stage x frame pipeline
        timeline; open the file in https://ui.perfetto.dev

    python -m repro_torch.telemetry summarize trace.json
        validate a trace file and print per-category span totals

The flags are the reference's (``python -m repro.telemetry``), plus
``--device`` on ``heatmap`` and ``trace``: the simulator runs on the
card by default, on the CPU only when asked (``--device cpu``).
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional

import numpy as np


def _bench_model(name: str, seed: int):
    """Seeded small-integer params — the exact-arithmetic regime the
    bitwise suites run in (mirrors tests/conftest.py::int_params)."""
    from repro_torch.configs.cnn import CNN_BENCHMARKS, ConvLayer

    cnn = CNN_BENCHMARKS[name]()
    rng = np.random.default_rng(seed)
    params = {}
    for l in cnn.layers:
        if isinstance(l, ConvLayer):
            params[l.name] = rng.integers(
                -1, 2, (l.k, l.k, l.c, l.m)).astype(np.float64)
        else:
            params[l.name] = rng.integers(
                -1, 2, (l.c_in, l.c_out)).astype(np.float64)
    return cnn, params, rng


def _dup_cap(model: str) -> int:
    return 128 if model == "resnet50-imagenet" else 64


def cmd_heatmap(args) -> int:
    from repro_torch.core.energy import routed_byte_hops_per_class
    from repro_torch.core.network import NetworkSimulator
    from repro_torch.telemetry.heatmap import check_conservation, record_run

    cnn, params, rng = _bench_model(args.model, args.seed)
    kw = {}
    if args.chiplets > 1:
        # shard over a two-level fabric: the heatmap's geometry then
        # flows from the placement's ChipletFabric (per-chiplet grids
        # side by side, NoI links annotated) instead of a hardcoded
        # flat mesh
        from repro_torch.core.mapping import plan_network
        from repro_torch.core.noc import shard_network

        plan = plan_network(cnn, dup_cap=_dup_cap(args.model))
        kw["placement"] = shard_network(plan, args.chiplets, noi=args.noi)
    sim = NetworkSimulator(cnn, params, backend="trace",
                           dup_cap=_dup_cap(args.model), device=args.device,
                           **kw)
    x = rng.random((1, cnn.input_hw, cnn.input_hw, 3))
    res, rec = record_run(sim, x)
    hm = rec.heatmap()
    analytic = routed_byte_hops_per_class(cnn, sim.plan, sim.placement)
    problems = check_conservation(hm, res.traffic, analytic,
                                  flows=rec.flows.values())
    fabric = f"{args.chiplets}-chiplet fabric (noi {args.noi})" \
        if args.chiplets > 1 else "mesh"
    print(f"{args.model}: {sim.plan.total_tiles} tiles on "
          f"{hm.rows}x{hm.cols} {fabric}")
    totals = hm.class_totals()
    for kind in sorted(totals):
        print(f"  {kind:>9}: {totals[kind]:>12} byte-hops over "
              f"{len(hm.per_class[kind])} links")
    if problems:
        print("CONSERVATION FAILED:")
        for p in problems:
            print("  ", p)
        return 1
    print("conservation: heatmap == counters == analytic (exact)")
    print()
    print(hm.render())
    print(f"top {args.top} links (bytes, by class):")
    for (u, v), total, split in hm.top_links(args.top):
        parts = ", ".join(f"{k}={b}" for k, b in split.items())
        print(f"  {u} -> {v}: {total:>10}  ({parts})")
    if args.csv:
        with open(args.csv, "w") as f:
            f.write(hm.to_csv())
        print(f"wrote {args.csv}")
    return 0


def cmd_trace(args) -> int:
    from repro_torch.runtime.serve_loop import build_stream_sim, serve_stream
    from repro_torch.telemetry.metrics import MetricsRegistry
    from repro_torch.telemetry.spans import (Profiler, stream_timeline_events,
                                             validate_chrome_trace, chrome_trace,
                                             write_chrome_trace)

    cnn, params, rng = _bench_model(args.model, args.seed)
    frames = rng.random((args.frames, cnn.input_hw, cnn.input_hw, 3))
    registry = MetricsRegistry()
    with Profiler() as prof:
        sim = build_stream_sim(cnn, params, dup_cap=_dup_cap(args.model),
                               device=args.device)
        serve_stream(sim, frames, metrics=registry)
    res = sim.run_stream(frames)  # timeline re-run outside the profiler
    stage_names = [cnn.layers[st.li].name for st in sim._stages]
    events = prof.events + stream_timeline_events(res, stage_names)
    errors = validate_chrome_trace(chrome_trace(events))
    if errors:
        print("INVALID TRACE:")
        for e in errors[:10]:
            print("  ", e)
        return 1
    write_chrome_trace(args.out, events)
    print(f"wrote {args.out}: {len(events)} events "
          f"({args.frames} frames x {len(stage_names)} stages) — open in "
          "https://ui.perfetto.dev")
    if args.metrics:
        registry.to_json(args.metrics)
        print(f"wrote {args.metrics} (serving metrics snapshot)")
    return 0


def cmd_summarize(args) -> int:
    from repro_torch.telemetry.spans import load_chrome_trace, validate_chrome_trace

    doc = load_chrome_trace(args.trace)
    events = doc["traceEvents"]
    errors = validate_chrome_trace(doc)
    status = "valid" if not errors else f"INVALID ({len(errors)} problems)"
    print(f"{args.trace}: {len(events)} events, {status}")
    for e in errors[:10]:
        print("  ", e)

    by_ph: Dict[str, int] = {}
    for ev in events:
        by_ph[ev.get("ph", "?")] = by_ph.get(ev.get("ph", "?"), 0) + 1
    print("  events by phase:", dict(sorted(by_ph.items())))

    # pair up B/E spans per (pid, tid) for duration stats
    spans: List[tuple] = []
    stacks: Dict[tuple, list] = {}
    for ev in events:
        key = (ev.get("pid"), ev.get("tid"))
        if ev.get("ph") == "B":
            stacks.setdefault(key, []).append(ev)
        elif ev.get("ph") == "E":
            stack = stacks.get(key)
            if stack:
                b = stack.pop()
                spans.append((b.get("name", "?"), b.get("cat", "?"),
                              ev["ts"] - b["ts"]))
        elif ev.get("ph") == "X":
            spans.append((ev.get("name", "?"), ev.get("cat", "?"),
                          ev.get("dur", 0.0)))
    if spans:
        by_cat: Dict[str, float] = {}
        for _, cat, dur in spans:
            by_cat[cat] = by_cat.get(cat, 0.0) + dur
        print("  span time by category (ms):",
              {k: round(v / 1e3, 3) for k, v in sorted(by_cat.items())})
        print("  longest spans:")
        for name, cat, dur in sorted(spans, key=lambda s: -s[2])[:args.top]:
            print(f"    {dur / 1e3:>10.3f} ms  [{cat}] {name}")
    return 1 if errors else 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.telemetry",
        description="Domino telemetry: link heatmaps, traces, summaries")
    sub = ap.add_subparsers(dest="cmd", required=True)

    hp = sub.add_parser("heatmap", help="render a per-link traffic heatmap")
    hp.add_argument("--model", default="vgg11-cifar10")
    hp.add_argument("--seed", type=int, default=0)
    hp.add_argument("--top", type=int, default=10)
    hp.add_argument("--csv", help="also write per-link loads as CSV")
    hp.add_argument("--chiplets", type=int, default=1,
                    help="shard over an N-chiplet fabric (default: flat "
                         "single mesh)")
    hp.add_argument("--noi", default="mesh", choices=("mesh", "floret"),
                    help="NoI topology for --chiplets > 1")
    hp.add_argument("--device", default=None,
                    help="simulator device (default: the card)")

    tp = sub.add_parser("trace", help="capture a Chrome trace of a "
                                      "streaming serve")
    tp.add_argument("out", help="output trace path (.json)")
    tp.add_argument("--model", default="vgg11-cifar10")
    tp.add_argument("--frames", type=int, default=4)
    tp.add_argument("--seed", type=int, default=0)
    tp.add_argument("--metrics", help="also write a metrics snapshot JSON")
    tp.add_argument("--device", default=None,
                    help="simulator device (default: the card)")

    sp = sub.add_parser("summarize", help="validate + summarize a trace")
    sp.add_argument("trace")
    sp.add_argument("--top", type=int, default=8)

    args = ap.parse_args(argv)
    return {"heatmap": cmd_heatmap, "trace": cmd_trace,
            "summarize": cmd_summarize}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
