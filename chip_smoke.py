#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. the card's name and power limit (``nvidia-smi``), and the build of
   every kernel from the sources in ``src/repro_torch/csrc`` (nvcc,
   ``sm_90a``);
2. the main path: vgg11-cifar10 at full width, random float weights
   from a numpy seed, quantized for serving and served through the
   streaming simulator (``serve_stream``, 8 frames, ``batch_window=4``)
   on the card — once with nominal ADCs, once with a device-variation
   model attached.  Each run resets the kernel launch counts just
   before and reads them just after; every kernel must have launched.
   The same runs on the CPU (plain kernel versions, calibration copied
   from the card's engine) must give equal logits, counters, traffic
   and timeline, and ``measured_ii == analytic_ii``;
3. each kernel against its plain PyTorch version on the card, equal by
   value: at the main path's own calls (recorded from one batch), and
   on random int8 inputs at those shapes for n_c in {32, 96, 256}, both
   ADC flavors, both output modes, and ragged rows, columns and depth;
4. kernel times (CUDA events) beside the plain version's and the bound.

The line before the last is the ``kernels`` JSON; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
FRAMES = 8
BATCH_WINDOW = 4
WALL_REPS = 7
#: H100 SXM peaks (NVIDIA data sheet, dense): int8 tensor-core rate and
#: HBM3 bandwidth, at the full 700 W power limit
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
KERNEL_SOURCE = "src/repro_torch/csrc/cim_matmul.cu"
REPLACES = {"cim_codes": "src/repro/kernels/cim_matmul.py:36",
            "cim_codes_var": "src/repro/kernels/cim_matmul.py:65"}


def log(*a) -> None:
    print(*a, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal by value (``-0.0 == 0.0``; the reference itself disagrees
    on the sign of zero)."""
    return a.shape == b.shape and torch.equal(a + 0.0, b + 0.0)


def counters_equal(ra, rb) -> bool:
    import dataclasses

    return (all(dataclasses.asdict(x) == dataclasses.asdict(y)
                for x, y in zip(ra.frame_counters, rb.frame_counters))
            and all(dict(x.byte_hops) == dict(y.byte_hops)
                    and dict(x.packets) == dict(y.packets)
                    for x, y in zip(ra.frame_traffic, rb.frame_traffic))
            and np.array_equal(ra.start, rb.start)
            and np.array_equal(ra.finish, rb.finish))


def vgg11_params(cnn, rng):
    from repro_torch.configs.cnn import ConvLayer

    params = {}
    for layer in cnn.layers:
        shape = ((layer.k, layer.k, layer.c, layer.m)
                 if isinstance(layer, ConvLayer) else
                 (layer.c_in, layer.c_out))
        params[layer.name] = (rng.standard_normal(shape)
                              / np.sqrt(np.prod(shape[:-1])))
    return params


def serving_walls(sim, frames):
    """Wall time per frame of WALL_REPS serving runs: host clock around
    whole ``serve_stream`` runs that end in a synchronize."""
    from repro_torch.runtime.serve_loop import serve_stream

    walls = []
    for _ in range(WALL_REPS):
        t0 = time.perf_counter()
        serve_stream(sim, frames, batch_window=BATCH_WINDOW)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / FRAMES)
    return walls


def main_path(km):
    """Phase 2: serve vgg11-cifar10 on the card, nominal then with
    device variation; hold each against the CPU run."""
    from repro_torch.configs.cnn import CNN_BENCHMARKS
    from repro_torch.convert import copy_calibration, params_from_reference
    from repro_torch.core.engine import CIMEngine
    from repro_torch.core.variation import VARIATION_PRESETS
    from repro_torch.runtime.serve_loop import (
        build_stream_sim,
        quantize_cnn_params_for_serving,
        serve_stream,
    )

    cnn = CNN_BENCHMARKS["vgg11-cifar10"]()
    rng = np.random.default_rng(SEED)
    params = vgg11_params(cnn, rng)
    frames = rng.random((FRAMES, cnn.input_hw, cnn.input_hw, 3))
    t0 = time.perf_counter()
    sims = {}
    for dev in ("cuda", "cpu"):
        qp = quantize_cnn_params_for_serving(params_from_reference(params, dev))
        eng = None
        if dev == "cpu":
            eng = copy_calibration(sims["cuda"].pe_engine,
                                   CIMEngine(device="cpu"))
        sims[dev] = build_stream_sim(cnn, qp, engine=eng, device=dev)
    log(f"[e2e] {cnn.name}: {sims['cuda'].plan.total_tiles} placed tiles, "
        f"built in {time.perf_counter() - t0:.1f} s (calibrated on the card)")
    # warm the card (first launches, allocator) outside the counted runs
    serve_stream(sims["cuda"], frames[:BATCH_WINDOW], batch_window=BATCH_WINDOW)
    torch.cuda.synchronize()

    launches, wall = {}, {}
    for flavor, var in (("nominal", None), ("variation", VARIATION_PRESETS["all"])):
        if var is not None:
            for sim in sims.values():
                sim.set_variation(var)
        for k in km.cim_codes.launches:
            km.cim_codes.launches[k] = 0
        torch.cuda.synchronize()
        rep = serve_stream(sims["cuda"], frames, batch_window=BATCH_WINDOW)
        torch.cuda.synchronize()
        launches[flavor] = dict(km.cim_codes.launches)
        walls = serving_walls(sims["cuda"], frames)
        wall[flavor] = float(np.median(walls))
        rep_cpu = serve_stream(sims["cpu"], frames, batch_window=BATCH_WINDOW)
        lg = rep.logits
        if tuple(lg.shape) != (FRAMES, 10) or not torch.isfinite(lg).all():
            fail(f"{flavor}: logits {tuple(lg.shape)} not finite / wrong shape")
        if not same(lg.cpu(), rep_cpu.logits):
            diff = (lg.cpu() - rep_cpu.logits).abs().max().item()
            fail(f"{flavor}: card logits differ from the CPU run ({diff})")
        if rep.measured_ii != rep.analytic_ii or \
                rep_cpu.measured_ii != rep.measured_ii:
            fail(f"{flavor}: measured II {rep.measured_ii} vs analytic "
                 f"{rep.analytic_ii} (cpu {rep_cpu.measured_ii})")
        res = {dev: sims[dev].run_stream(frames, arrivals=rep.arrivals,
                                         chunk=BATCH_WINDOW)
               for dev in sims}
        if not counters_equal(res["cuda"], res["cpu"]):
            fail(f"{flavor}: counters / traffic / timeline differ from CPU")
        if not same(res["cuda"].logits.cpu(), lg.cpu()):
            fail(f"{flavor}: run_stream logits differ from serve_stream")
        log(f"[e2e] {flavor}: logits == CPU run by value, measured II "
            f"{rep.measured_ii} == analytic II {rep.analytic_ii}, counters "
            f"and timeline equal; launches {launches[flavor]}; wall "
            f"ms/frame over {WALL_REPS} runs of {FRAMES} frames "
            f"(batch_window={BATCH_WINDOW}): median {wall[flavor] * 1e3:.4f}, "
            f"all {[round(v * 1e3, 4) for v in walls]}")
    if launches["nominal"]["cim_codes"] == 0:
        fail("the nominal serving run never launched cim_codes")
    if launches["variation"]["cim_codes_var"] == 0:
        fail("the variation serving run never launched cim_codes_var")
    return sims["cuda"], frames, launches, wall


def device_share(sim, frames):
    """Device busy share of one nominal serving run of all frames, and
    the kernels that take the device time (``torch.profiler``)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.runtime.serve_loop import serve_stream

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve_stream(sim, frames, batch_window=BATCH_WINDOW)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for ev in prof.key_averages():
        # device-side events only (kernels, copies): the host ops that
        # launched them carry the same time again
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append((dev_us, ev.count, ev.key))
    busy = sum(r[0] for r in rows)
    if not rows:
        log("[profile] the profiler saw no device time: not measured")
        return
    log(f"[profile] one serving run of {len(frames)} frames: wall "
        f"{wall_us:.1f} us under the profiler, device busy {busy:.1f} us "
        f"({100 * busy / wall_us:.2f}%)")
    for dev_us, count, key in sorted(rows, reverse=True)[:8]:
        log(f"[profile]   {dev_us:10.1f} us  x{count:<4d} {key[:90]}")


def record_calls(km, sim, frames):
    """The kernel calls of one main-path batch, nominal and variation
    (recorded outside the counted runs)."""
    from repro_torch.core.variation import VARIATION_PRESETS
    from repro_torch.runtime.serve_loop import serve_stream

    calls = {"cim_codes": [], "cim_codes_var": []}
    real = km.cim_codes

    def recorder(x, w, spec, adc=None, emit_codes=True):
        calls["cim_codes_var" if adc is not None else "cim_codes"].append(
            (x, w, spec, adc))
        return real(x, w, spec, adc=adc, emit_codes=emit_codes)

    km.cim_codes = recorder
    try:
        for var in (None, VARIATION_PRESETS["all"]):
            sim.set_variation(var)
            serve_stream(sim, frames[:BATCH_WINDOW], batch_window=BATCH_WINDOW)
    finally:
        km.cim_codes = real
    torch.cuda.synchronize()
    return calls


def geometry(x, w, n_c):
    """(T, R, kc, N) of a call in either layout."""
    if x.dim() == 3:
        return tuple(x.shape) + (w.shape[2],)
    return (-(-x.shape[1] // n_c), x.shape[0], n_c, w.shape[1])


def work(x, w, adc):
    """(int8 operations, bytes) the call must do: 2 ops per multiply-add
    over the given depth; x, w and the ADC table read once, the float32
    output written once."""
    ops = 2 * x.shape[-2] * x.shape[-1] * w.shape[-1] * (
        x.shape[0] if x.dim() == 3 else 1)
    nbytes = x.numel() + w.numel() + 4 * x.shape[-2] * w.shape[-1]
    if adc is not None:
        nbytes += adc.numel() * 4
    return ops, nbytes


def check_kernels(km, calls):
    """Phase 3: kernel == plain version by value on the card."""
    from repro_torch.core.cim import CIMSpec

    worst = {"cim_codes": 0.0, "cim_codes_var": 0.0}
    n_checks = 0

    def check(name, x, w, spec, adc, emit):
        nonlocal n_checks
        a = km.cim_codes(x, w, spec, adc=adc, emit_codes=emit)
        b = km.cim_codes_plain(x, w, spec, adc=adc, emit_codes=emit)
        torch.cuda.synchronize()
        err = (a - b).abs().max().item() if a.numel() else 0.0
        worst[name] = max(worst[name], err)
        n_checks += 1
        if not same(a, b):
            fail(f"{name} != plain at {geometry(x, w, spec.n_c)} n_c="
                 f"{spec.n_c} emit_codes={emit}: max |diff| {err}")

    for name, lst in calls.items():
        for x, w, spec, adc in lst:
            for emit in (True, False):
                check(name, x, w, spec, adc, emit)
    rng = np.random.default_rng(SEED + 1)
    dev = torch.device("cuda")

    def i8(*shape):
        return torch.from_numpy(
            rng.integers(-128, 128, shape).astype(np.int8)).to(dev)

    def table(t, spec):
        inv = np.float32(spec.adc_inv_step) * (
            1 + 0.02 * rng.standard_normal(t))
        off = 0.5 * rng.standard_normal(t)
        return torch.from_numpy(
            np.stack([inv, off], 1).astype(np.float32)).to(dev)

    shapes = sorted({geometry(x, w, spec.n_c) + (x.dim(),)
                     for lst in calls.values() for x, w, spec, _ in lst})
    for n_c in (32, 96, 256):
        spec = CIMSpec(n_c=n_c)
        cases = []
        for t, r, kc, n, dim in shapes:
            kc = min(kc, n_c)
            cases.append((i8(t, r, kc), i8(t, kc, n)) if dim == 3 else
                         (i8(r, t * kc), i8(t * kc, n)))
        # ragged rows, columns and depth (last step short in 2-D)
        cases.append((i8(5, 37, n_c - 3), i8(5, n_c - 3, 77)))
        cases.append((i8(13, 3 * n_c + 11), i8(3 * n_c + 11, 130)))
        for x, w in cases:
            t = geometry(x, w, n_c)[0]
            for emit in (True, False):
                check("cim_codes", x, w, spec, None, emit)
                check("cim_codes_var", x, w, spec, table(t, spec), emit)
    log(f"[kernels] {n_checks} comparisons equal by value; max |diff| "
        f"{worst}")
    return worst


def time_kernels(km, calls, reps: int = 50):
    """Phase 4: per-batch kernel time vs plain version vs bound."""
    def timed(fn, lst):
        for args in lst:  # warm-up
            fn(*args)
        torch.cuda.synchronize()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        for _ in range(reps):
            for x, w, spec, adc in lst:
                fn(x, w, spec, adc=adc)
        ev1.record()
        torch.cuda.synchronize()
        return ev0.elapsed_time(ev1) / reps

    rows = {}
    for name, lst in calls.items():
        for x, w, spec, adc in lst:
            args = [(x, w, spec, adc)]
            ops, nbytes = work(x, w, adc)
            log(f"[time] {name} (T, R, kc, N)={geometry(x, w, spec.n_c)}: "
                f"kernel {timed(km.cim_codes, args):.5f} ms, plain "
                f"{timed(km.cim_codes_plain, args):.5f} ms, bound "
                f"{max(ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES) * 1e3:.6f} ms")
        ops = sum(work(x, w, adc)[0] for x, w, _, adc in lst)
        nbytes = sum(work(x, w, adc)[1] for x, w, _, adc in lst)
        t_ops, t_bytes = ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES
        rows[name] = dict(
            ms=timed(km.cim_codes, lst), plain_ms=timed(km.cim_codes_plain, lst),
            bound_ms=max(t_ops, t_bytes) * 1e3,
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            calls=len(lst))
        log(f"[time] {name}: {len(lst)} calls per {BATCH_WINDOW}-frame batch: "
            f"{rows[name]}")
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    try:
        import repro_torch.kernels.cim_matmul as km
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    lib, build_log = km.build()
    log(f"[build] {lib.name} in {time.perf_counter() - t0:.1f} s")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    sim, frames, launches, wall = main_path(km)
    # nominal again, after the variation run: separates the flavor from
    # the order of the runs in the wall-time comparison
    sim.set_variation(None)
    walls = serving_walls(sim, frames)
    wall["nominal_again"] = float(np.median(walls))
    log(f"[e2e] nominal again: wall ms/frame median "
        f"{wall['nominal_again'] * 1e3:.4f}, all "
        f"{[round(v * 1e3, 4) for v in walls]}")
    device_share(sim, frames)
    calls = record_calls(km, sim, frames)
    worst = check_kernels(km, calls)
    rows = time_kernels(km, calls)
    kernels = []
    for name, row in rows.items():
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES[name],
            "launches": launches["nominal" if name == "cim_codes"
                                 else "variation"][name],
            "max_abs_err": worst[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None})
    log(f"[e2e] wall per frame (ms, median of {WALL_REPS} runs): nominal "
        f"{wall['nominal'] * 1e3:.4f}, variation "
        f"{wall['variation'] * 1e3:.4f}, nominal again "
        f"{wall['nominal_again'] * 1e3:.4f} on {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
