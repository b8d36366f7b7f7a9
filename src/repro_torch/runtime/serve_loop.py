"""Domino streaming front-end on torch — the CNN half of
``repro/runtime/serve_loop.py``.

:func:`serve_stream` is a request-queue loop that feeds image frames
into the pipelined streaming simulator (``core/network.py``) at an
offered rate and reports closed-loop latency/throughput; the quantized
weights route (:func:`quantize_cnn_params_for_serving` ->
:func:`build_stream_sim`) keeps int8 weights resident in the CIM engine,
whose MACs run the Hopper kernel on the card.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.engine import is_quantized_leaf, quantize_weight
from repro_torch.runtime.fault import StragglerMonitor


def quantize_cnn_params_for_serving(params: Dict[str, Any]
                                    ) -> Dict[str, Any]:
    """Every conv kernel / FC matrix becomes ``{"q": int8, "s": (M,)}``
    with the per-output-column scale taken over the flattened
    contraction (K*K*C) — the crossbar-resident layout the CIM engine
    consumes directly — on each weight's own device."""
    out = {}
    for name, w in params.items():
        q, s = quantize_weight(torch.as_tensor(w))
        out[name] = {"q": q, "s": s}
    return out


def dequantize_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """The explicit float route for ``{"q", "s"}`` quantized leaves of a
    CNN name -> weight dict (float32, ``q * s``).  Other leaves pass
    through untouched."""
    return {name: (leaf["q"].to(torch.float32) * leaf["s"].to(torch.float32)
                   if is_quantized_leaf(leaf) else leaf)
            for name, leaf in params.items()}


@dataclass
class StreamServeReport:
    """Closed-loop serving statistics from one streamed request trace.

    Latencies are arrival -> pipeline-exit, in step-clock cycles; the
    seconds-level views apply the Tab. 3 step clock.  ``latency_hist``
    is a ``numpy.histogram`` pair over the per-request latencies."""

    arrivals: np.ndarray              # (T,) request arrival cycles
    latency_cycles: np.ndarray        # (T,) closed-loop latency per request
    #: steady-state exit spacing (cycles); None on a single-request
    #: trace — one exit has no spacing to measure
    measured_ii: Optional[int]
    analytic_ii: int                  # plan_network's slowest-stage bound
    fill_latency: int                 # first request: arrival -> exit
    offered_inf_s: float              # request rate the queue injected
    throughput_inf_s: float           # measured completion rate
    clock_hz: float
    latency_hist: Tuple[np.ndarray, np.ndarray] = field(repr=False)
    #: frames the StragglerMonitor flagged (> threshold x EWMA latency)
    flagged_frames: Tuple[int, ...] = ()
    #: monitor tripped ``trip_limit`` consecutive flags: reshard advised
    straggler_escalate: bool = False
    #: realized numerics micro-batch sizes (frames per batched stage
    #: sweep, bounded by ``batch_window``)
    batch_sizes: Tuple[int, ...] = ()
    #: per-request logits (T, classes) on the simulator's device
    logits: Optional[torch.Tensor] = field(default=None, repr=False)

    @property
    def latency_s(self) -> np.ndarray:
        return self.latency_cycles / self.clock_hz

    @property
    def completed(self) -> int:
        """Requests that made it through the pipeline."""
        return int(self.latency_cycles.size)

    def latency_percentiles(self, qs=(50, 95, 99)) -> Dict[str, float]:
        """Per-request latency percentiles in cycles (keys ``p50``...);
        ``{}`` when no request completed."""
        if self.latency_cycles.size == 0:
            return {}
        return {f"p{q}": float(np.percentile(self.latency_cycles, q))
                for q in qs}


def build_stream_sim(cnn, params: Dict[str, Any], engine=None,
                     chiplets: int = 1, device=None, **kw):
    """Serving-side constructor for the streaming simulator on
    ``device`` (``None`` = the card).

    Params carrying ``{"q", "s"}`` leaves (from
    :func:`quantize_cnn_params_for_serving`) run the CIM engine by
    default — the int8 weights stay resident — while float params run
    the exact engine; ``engine=`` overrides.  Serving over a chiplet
    fabric (``chiplets > 1``) is not ported yet."""
    from repro_torch.core.network import NetworkSimulator

    if chiplets != 1:
        raise NotImplementedError(
            "chiplets > 1 (the two-level chiplet fabric) is not ported")
    if engine is None:
        quantized = any(is_quantized_leaf(v) for v in params.values())
        engine = "cim" if quantized else "exact"
    return NetworkSimulator(cnn, params, backend="trace", streaming=True,
                            engine=engine, device=device, **kw)


def serve_stream(sim, frames, offered_inf_s: Optional[float] = None,
                 clock_hz: Optional[float] = None, hist_bins: int = 16,
                 straggler: Optional[StragglerMonitor] = None,
                 batch_window: Optional[int] = None) -> StreamServeReport:
    """Request-queue front-end over the streaming simulator.

    ``frames`` (T, H, W, C) are the queued requests, arriving spaced at
    ``offered_inf_s`` (requests/second at the step clock; by default the
    analytic initiation-interval rate).  Each request's closed-loop
    latency runs from its arrival cycle to its pipeline exit in the
    simulated stage timeline and feeds a :class:`StragglerMonitor`.
    ``batch_window`` bounds the numerics micro-batch (``run_stream``'s
    chunk); it cannot change a reported value.  The Prometheus-style
    metrics export of the reference is not ported yet.
    """
    from repro_torch.core.energy import STEP_CLOCK_HZ
    from repro_torch.telemetry.spans import span

    if clock_hz is None:
        clock_hz = STEP_CLOCK_HZ
    t_n = int(frames.shape[0])
    if offered_inf_s is None:
        spacing = float(sim.plan.initiation_interval)
    else:
        spacing = clock_hz / offered_inf_s
    if t_n == 0:
        empty = np.empty(0, np.int64)
        return StreamServeReport(
            arrivals=empty, latency_cycles=empty,
            measured_ii=0, analytic_ii=sim.plan.initiation_interval,
            fill_latency=0, offered_inf_s=clock_hz / spacing,
            throughput_inf_s=0.0, clock_hz=clock_hz,
            latency_hist=np.histogram(empty, bins=hist_bins))
    arrivals = np.floor(np.arange(t_n) * spacing).astype(np.int64)
    with span(f"serve_stream:{sim.cnn.name}", frames=t_n,
              batch_window=batch_window or 0):
        res = sim.run_stream(frames, arrivals=arrivals, chunk=batch_window)
    lat = res.frame_latency
    exits = res.finish[:, -1]
    exit_span = int(exits[-1] - exits[0])
    throughput = (clock_hz * (t_n - 1) / exit_span) if exit_span > 0 \
        else float("inf")
    counts, edges = np.histogram(lat, bins=hist_bins)
    mon = StragglerMonitor() if straggler is None else straggler
    escalate = False
    for i, cycles in enumerate(lat):
        escalate = mon.observe(i, float(cycles) / clock_hz) or escalate
    return StreamServeReport(
        arrivals=arrivals, latency_cycles=lat,
        measured_ii=res.measured_ii, analytic_ii=res.analytic_ii,
        fill_latency=res.fill_latency,
        offered_inf_s=clock_hz / spacing, throughput_inf_s=throughput,
        clock_hz=clock_hz, latency_hist=(counts, edges),
        flagged_frames=tuple(mon.flagged_steps),
        straggler_escalate=escalate, batch_sizes=res.batch_sizes,
        logits=res.logits)
