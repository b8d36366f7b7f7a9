"""Whole-network Domino simulation on torch tensors — the port of
``repro/core/network.py``.

Every CONV layer runs its compiled instruction tables on the placed,
routed mesh through one of two backends that share the placement,
schedules and transport:

* ``backend="trace"`` (the port's default) — the trace executor
  (``core/trace.py``): the tables lowered once into gathers and, on a
  quantized engine, one CIM kernel call per fire chunk;
* ``backend="interp"`` (the reference's default) — the per-cycle
  interpreter (``core/simulator.py::BlockSimulator``): every tile's
  instruction decoded each cycle, every chain psum and group sum a
  routed packet, one engine MAC (one CIM kernel call on a quantized
  engine) per firing tile and cycle.  Equal to the trace backend by
  value on the quantized engines, counters and traffic identical; slow
  (host work per tile and cycle), so the port keeps ``"trace"`` as its
  default and callers ask for the interpreter.

FC layers run the Fig. 4 grid (``core/simulator.py::simulate_fc``);
each block's OFM streams to the next block's head over its routed NoC
link.  Values live on the simulator's device; placement, schedules,
transport, counters and the stream timing pass are host code copied
from the reference, so counters, traffic and the stage timeline are
identical to it.

``trace_jit=True`` selects the executors' counterparts of the
reference's jitted flavors (``core/trace.py``): on a quantized engine
each conv block's fused integer path captured into a CUDA graph per
input shape and replayed (equal to the eager path by value, so it
composes with streaming); on the exact engine the float32 flavor
(allclose only, so not with streaming).

Stream computing (``streaming=True``): :meth:`NetworkSimulator.run_stream`
runs all frames stage-major in micro-batches (the batched numerics
pass), then replays the per-frame accounting and the max-plus wavefront
timeline analytically; the measured steady-state initiation interval
must emerge equal to ``plan_network``'s analytic slowest-stage bound.
``batched=False`` runs the per-cell interleaved oracle instead, one
stage of one frame at a time.

Functional notes (as in the reference): weight-duplicated copies share
weights, so one copy of each block computes the full OFM; residual
networks save at ``*_a``, add at ``residual_from`` (through an
immediately following ``*_sc`` projection when present) and apply ReLU
after the add; ResNet's global average pool runs at the FC boundary,
VGG flattens; layers whose period W + 2P exceeds the 128-entry table
run as width strips.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.cnn import CNNConfig, ConvLayer, FCLayer
from repro_torch.core.cim import CIMSpec, divide
from repro_torch.core.energy import STEP_CLOCK_HZ
from repro_torch.core.engine import (
    PEEngine,
    calibrate_engine,
    conv_tile_slices,
    dequantize_weight,
    is_quantized_leaf,
    make_engine,
)
from repro_torch.core.instructions import TABLE_CAPACITY
from repro_torch.core.mapping import NetworkPlan, plan_network
from repro_torch.core.noc import Placement, block_spans, place_network
from repro_torch.core.schedule import (
    BlockSchedule,
    ConvStrip,
    compile_conv_block,
    compile_conv_strips,
)
from repro_torch.core.simulator import (
    BlockSimulator,
    SimCounters,
    simulate_fc,
)
from repro_torch.core.trace import TracePlan, TraceExecutor, compile_trace
from repro_torch.core.transport import (
    OFM,
    RESIDUAL,
    NoCTransport,
    TrafficCounters,
)
from repro_torch.device import resolve_device
from repro_torch.telemetry.spans import span


@dataclass
class NetworkSimResult:
    logits: torch.Tensor          # (B, classes), on the simulator's device
    counters: SimCounters         # aggregated tile events, per inference
    traffic: TrafficCounters      # routed byte-hops per traffic class


@dataclass(frozen=True)
class _Stage:
    """One stage of the layer pipeline: a conv layer (plus its projection
    shortcut, which runs concurrently on its own placed tiles) or an FC
    layer.  ``occupancy`` is the stage's initiation interval; ``latency``
    is first-input to last-output of one frame."""

    li: int                    # main layer index
    sc_li: Optional[int]       # projection shortcut folded into this stage
    kind: str                  # "conv" | "fc"
    prev_li: Optional[int]     # main layer index of the upstream stage
    occupancy: int
    latency: int


@dataclass
class StreamResult:
    """Measured pipelined (stream-computing) execution of ``T`` frames.

    ``start``/``finish`` are the simulated stage timeline; the
    steady-state initiation interval is *measured* from ``finish``
    deltas at the exit stage.  ``measured_ii`` is None for a single
    frame (no exit spacing to measure)."""

    logits: torch.Tensor                  # (T, classes), frame-indexed
    frame_counters: List[SimCounters]     # per-frame tile events
    frame_traffic: List[TrafficCounters]  # per-frame routed traffic
    arrivals: np.ndarray                  # (T,) frame arrival cycles
    start: np.ndarray                     # (T, S) stage initiation cycles
    finish: np.ndarray                    # (T, S) stage completion cycles
    occupancy: Tuple[int, ...]            # per-stage initiation interval
    measured_ii: Optional[int]            # steady-state exit-to-exit cycles
    analytic_ii: int                      # plan_network slowest-stage bound
    fill_latency: int                     # frame 0: arrival -> pipeline exit
    residual_fifo_depth: int              # max shortcut frames buffered
    #: realized numerics micro-batches: frames per batched stage sweep
    batch_sizes: Tuple[int, ...] = ()

    @property
    def total_cycles(self) -> int:
        return int(self.finish[-1, -1])

    @property
    def frame_latency(self) -> np.ndarray:
        """Per-frame closed-loop latency: arrival -> pipeline exit."""
        return self.finish[:, -1] - self.arrivals

    @property
    def drain_latency(self) -> int:
        """Cycles to empty the pipeline after the last frame initiates."""
        return int(self.finish[-1, -1] - self.start[-1, 0])

    def inferences_per_s(self, clock_hz: float = STEP_CLOCK_HZ) -> float:
        """Measured steady-state throughput at the Tab. 3 step clock."""
        if self.measured_ii is None:
            raise ValueError(
                "a single-frame stream has no measured initiation "
                "interval (measured_ii is None) — throughput needs T >= 2")
        return clock_hz / self.measured_ii


def _is_shortcut(layer) -> bool:
    """The config convention for ResNet projection shortcuts."""
    return isinstance(layer, ConvLayer) and layer.name.endswith("_sc")


BACKENDS = ("interp", "trace")

#: default numerics micro-batch for the batched streaming path: frames
#: per stage-major sweep (bounds the working set; chunk boundaries
#: cannot change a bit)
DEFAULT_STREAM_CHUNK = 16


def stream_timeline(arrivals: np.ndarray, occupancy, latency
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """The wavefront timing recurrence, vectorized over frames::

        ready[t]      = finish[t, k-1] if k else arrivals[t]
        start[t, k]   = ready[t] if t == 0
                        else max(ready[t], start[t-1, k] + occ[k])
        finish[t, k]  = start[t, k] + lat[k]

    With ``g[t] = start[t] - t * occ[k]`` the ``start`` recurrence is a
    running maximum, so one ``np.maximum.accumulate`` per stage computes
    it exactly (integer arithmetic throughout)."""
    arr = np.asarray(arrivals, np.int64)
    t_n, s_n = arr.shape[0], len(occupancy)
    tidx = np.arange(t_n, dtype=np.int64)
    start = np.empty((t_n, s_n), np.int64)
    finish = np.empty((t_n, s_n), np.int64)
    ready = arr
    for k in range(s_n):
        shift = tidx * int(occupancy[k])
        st = np.maximum.accumulate(ready - shift) + shift
        start[:, k] = st
        finish[:, k] = st + int(latency[k])
        ready = finish[:, k]
    return start, finish


def stream_timeline_scalar(arrivals: np.ndarray, occupancy, latency
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Reference scalar form of :func:`stream_timeline` — the exact
    per-cell recurrence the interleaved oracle executes, kept as the
    differential-test oracle for the vectorized scan."""
    arr = np.asarray(arrivals, np.int64)
    t_n, s_n = arr.shape[0], len(occupancy)
    start = np.zeros((t_n, s_n), np.int64)
    finish = np.zeros((t_n, s_n), np.int64)
    for t in range(t_n):
        for k in range(s_n):
            ready = finish[t, k - 1] if k else arr[t]
            init = ready if t == 0 \
                else max(ready, start[t - 1, k] + occupancy[k])
            start[t, k] = init
            finish[t, k] = init + latency[k]
    return start, finish


def _global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """ResNet's global average pool in the reference's order: numpy's
    ``mean(axis=(1, 2))`` adds the spatial positions one by one in
    raster order, then divides once — a torch mean reduces in another
    order, which could move the quantized FC input by an ulp."""
    acc = x[:, 0, 0]
    for i in range(1, x.shape[1] * x.shape[2]):
        acc = acc + x[:, i // x.shape[2], i % x.shape[2]]
    return divide(acc, x.shape[1] * x.shape[2])


def _as_tensor(leaf, device: torch.device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(leaf).to(device=device, dtype=dtype)


class NetworkSimulator:
    """Execute a whole CNN from compiled instruction tables over the
    placed, routed NoC, with values on ``device``."""

    def __init__(self, cnn: CNNConfig, params: Dict[str, object],
                 n_c: int = 256, n_m: int = 256, reuse: int = 1,
                 dup_cap: int = 64, backend: str = "trace",
                 trace_jit: bool = False, streaming: bool = False,
                 placement: Optional[Placement] = None,
                 dup_overrides: Optional[Dict[str, int]] = None,
                 engine: "str | PEEngine" = "exact",
                 cim_spec: Optional[CIMSpec] = None,
                 calib_images: Optional[np.ndarray] = None,
                 device=None):
        """params: layer name -> (K, K, C, M) conv kernel or (C_in, C_out)
        FC matrix (tensors or arrays), or a ``{"q": int8, "s": scale}``
        quantized leaf (the CIM-resident serving format; requires a
        quantized engine).

        ``engine``: ``"exact"`` (float64), ``"cim"`` / ``"pallas"`` (w8a8
        + per-subarray ADC through the CIM kernel, per-layer gain
        calibrated at build from ``calib_images`` — default: a seeded
        synthetic batch), or a prebuilt ``PEEngine`` on ``device``.
        ``device=None`` means the card; ``"cpu"`` runs the plain kernel
        versions.  ``backend``: ``"trace"`` (the default here; the
        reference defaults to ``"interp"``, and its callers pass
        ``"trace"``) or ``"interp"``, the per-cycle interpreter (one
        engine MAC per firing tile and cycle).  ``trace_jit=True``
        runs each conv block as a captured CUDA-graph replay on a
        quantized engine (the eager path on the CPU), and as the float32
        flavor on the exact engine (see ``core/trace.py``).
        """
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}: {backend}")
        if trace_jit and backend != "trace":
            raise ValueError(
                "trace_jit=True requires backend='trace' (the default "
                "backend of the reference is the per-cycle interpreter)")
        if streaming and backend != "trace":
            raise ValueError(
                "streaming=True requires backend='trace' (the pipelined "
                "executor advances compiled per-stage trace plans)")
        self.device = resolve_device(device)
        self.pe_engine: PEEngine = make_engine(engine, cim_spec, self.device)
        if streaming and trace_jit and self.pe_engine.name == "exact":
            raise ValueError(
                "streaming=True is incompatible with trace_jit=True on "
                "the exact engine: its float32 flavor is allclose-only, "
                "which would break run_stream's per-frame "
                "equal-to-sequential guarantee (the quantized engines' "
                "captured flavor IS equal, so they may combine)")
        # residual wiring follows the configs/cnn.py naming convention the
        # reference uses (save at `*_a`, add at `residual_from`, project
        # through an immediately-following `*_sc`) — reject anything else
        last_save: Optional[str] = None
        prev: Optional[ConvLayer] = None
        for layer in cnn.layers:
            if not isinstance(layer, ConvLayer):
                prev = None
                continue
            if layer.name.endswith("_a"):
                last_save = layer.name
            if layer.residual_from is not None:
                if layer.residual_from != last_save:
                    raise NotImplementedError(
                        f"{cnn.name}: {layer.name} takes its shortcut from "
                        f"{layer.residual_from!r}, but the most recent saved "
                        f"block input is {last_save!r} — only the *_a/"
                        "residual_from/*_sc convention is wired")
                if layer.pool_s:
                    raise NotImplementedError(
                        f"{cnn.name}: {layer.name} pools in the same block "
                        "as a shortcut add — the reference pools after the "
                        "post-add ReLU, which is not wired")
            if _is_shortcut(layer) and (
                    prev is None or prev.residual_from is None):
                raise NotImplementedError(
                    f"{cnn.name}: {layer.name} is a projection shortcut "
                    "but does not immediately follow its residual-target "
                    "layer, so it would run inline on the main path")
            prev = layer
        self.cnn = cnn
        # optional per-link telemetry hook on every transport (None keeps
        # the transports on their zero-overhead path)
        self.recorder = None
        # split quantized {"q","s"} leaves from the float view: the
        # quantized engine consumes the int8 weights directly, the float
        # view feeds the exact engine and gain calibration
        self._prequant: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        fparams: Dict[str, torch.Tensor] = {}
        for name, leaf in params.items():
            if is_quantized_leaf(leaf):
                q = _as_tensor(leaf["q"], self.device)
                s = _as_tensor(leaf["s"], self.device,
                               torch.float64).reshape(-1)
                self._prequant[name] = (q, s)
                fparams[name] = dequantize_weight(q, s)
            else:
                fparams[name] = _as_tensor(leaf, self.device, torch.float64)
        if self._prequant and self.pe_engine.name == "exact":
            raise ValueError(
                f"{cnn.name}: params carry quantized {{'q','s'}} leaves "
                f"({sorted(self._prequant)[:3]}...) — run them on a "
                "quantized engine (engine='cim'/'pallas') or dequantize "
                "explicitly (repro_torch.runtime.serve_loop."
                "dequantize_params)")
        self.params = fparams
        self.n_c, self.n_m = n_c, n_m
        self.backend = backend
        self.trace_jit = trace_jit
        self.streaming = streaming
        self.plan: NetworkPlan = plan_network(cnn, n_c=n_c, n_m=n_m,
                                              reuse=reuse, dup_cap=dup_cap,
                                              dup_overrides=dup_overrides)
        if placement is None:
            placement = place_network(self.plan)
        else:
            spans = block_spans(self.plan)
            if (placement.block_start, placement.block_end) != spans:
                raise ValueError(
                    f"{cnn.name}: injected placement's block spans do not "
                    "match this plan (was it built from the same "
                    "n_c/n_m/reuse/dup_cap?)")
            if placement.noc.num_tiles < self.plan.total_tiles:
                raise ValueError(
                    f"{cnn.name}: {self.plan.total_tiles} tiles do not fit "
                    f"the injected {placement.noc.rows}x"
                    f"{placement.noc.cols} mesh")
        self.placement: Placement = placement
        self.schedules: List[Optional[BlockSchedule]] = []
        # layers whose period W + 2P exceeds the 128-entry table compile
        # as width strips run back to back on the same tile chain
        self._strips: Dict[int, Tuple[ConvStrip, ...]] = {}
        for li, (layer, lp) in enumerate(zip(cnn.layers, self.plan.layers)):
            if isinstance(layer, ConvLayer):
                # residual targets and projection shortcuts compile with a
                # bare tail: activation fires *after* the shortcut add
                act = None if (layer.residual_from or _is_shortcut(layer)) \
                    else "relu"
                kw = dict(h=layer.h, w=layer.w, c_in=layer.c,
                          c_out=layer.m, k=layer.k, stride=layer.s,
                          pad=layer.p, pack=lp.pack, c_splits=lp.c_splits,
                          pool_k=layer.pool_k, pool_s=layer.pool_s,
                          activation=act)
                if layer.w + 2 * layer.p > TABLE_CAPACITY:
                    self._strips[li] = compile_conv_strips(layer.name, **kw)
                    self.schedules.append(None)
                else:
                    self.schedules.append(
                        compile_conv_block(layer.name, **kw))
            else:
                self.schedules.append(None)  # FC runs the Fig. 4 grid
        self._trace_plans: Dict[Tuple[int, int], TracePlan] = {}
        self._executors: Dict[Tuple[int, int], TraceExecutor] = {}
        if backend == "trace":
            with span(f"trace_lower:{cnn.name}",
                      layers=len(self.schedules) + len(self._strips)):
                for li, sched in enumerate(self.schedules):
                    if sched is not None:
                        self._trace_plans[li, 0] = compile_trace(sched)
                for li, strips in self._strips.items():
                    for si, strip in enumerate(strips):
                        self._trace_plans[li, si] = compile_trace(
                            strip.sched)
        self._stages: Tuple[_Stage, ...] = self._build_stages()
        # quantized engines: per-layer calibration (activation scale +
        # ADC integration gain) runs ONCE at network build, then every
        # layer's engine handle is built and shared by all executors
        if self.pe_engine.needs_calibration:
            if calib_images is None:
                hw = cnn.input_hw
                calib_images = np.random.default_rng(0).random((2, hw, hw, 3))
            calibrate_engine(self.pe_engine, cnn, self.params, calib_images)
        elif calib_images is not None:
            raise ValueError(
                "calib_images has no effect on the exact engine")
        self._handles: Dict[int, object] = {}
        self._build_handles()
        if backend == "trace":
            self._build_executors()

    def _build_executors(self) -> None:
        """Eagerly instantiate the per-(layer, strip) trace executors (and
        upload their gather indices) once."""
        sink_t = NoCTransport(self.placement.noc)
        sink_c = SimCounters()
        with span(f"executor_build:{self.cnn.name}",
                  executors=len(self._trace_plans)):
            for li, sched in enumerate(self.schedules):
                if sched is not None:
                    self._executor(li, 0, sched, sink_t, sink_c)
            for li, strips in self._strips.items():
                for si, strip in enumerate(strips):
                    self._executor(li, si, strip.sched, sink_t, sink_c)

    def _build_handles(self) -> None:
        """(Re)build every layer's engine handle — the only per-trial
        work a device-variation swap needs."""
        for li, layer in enumerate(self.cnn.layers):
            if isinstance(layer, ConvLayer):
                sched0 = self.schedules[li]
                if sched0 is None:
                    # width strips run the same tile chain (same taps /
                    # channel slices), so one engine handle serves all
                    strips = self._strips[li]
                    sched0 = strips[0].sched
                    slices0 = conv_tile_slices(sched0)
                    assert all(conv_tile_slices(s.sched) == slices0
                               for s in strips[1:]), layer.name
                self._handles[li] = self.pe_engine.conv_handle(
                    layer.name, self.params[layer.name],
                    conv_tile_slices(sched0),
                    prequant=self._prequant.get(layer.name))
            else:
                self._handles[li] = self.pe_engine.fc_handle(
                    layer.name, self.params[layer.name],
                    prequant=self._prequant.get(layer.name))

    def set_variation(self, variation) -> None:
        """Swap the quantized engine's device-variation model
        (``core/variation.py``) and rebuild only the engine handles;
        cached executors keep their plans and gather indices and drop
        their captured graphs, which read the old handles' tensors (the
        next call captures again).  The interpreter builds its block
        simulators per run from the current handles."""
        if not hasattr(self.pe_engine, "variation"):
            raise ValueError(
                "set_variation requires a quantized engine "
                "(cim/pallas); the exact engine has no device physics")
        self.pe_engine.variation = variation
        self._build_handles()
        for (li, _si), ex in self._executors.items():
            ex.set_handle(self._handles[li])

    def _executor(self, li: int, si: int, sched: BlockSchedule,
                  transport: NoCTransport, counters: SimCounters
                  ) -> "TraceExecutor | BlockSimulator":
        """A block executor for (layer, strip) on the chosen backend (all
        strips of a layer share one engine handle — same tile chain).  The
        interpreter's is built anew per run (its tiles hold per-run FIFO
        and shift-buffer state); the trace executor is cached."""
        layer = self.cnn.layers[li]
        if self.backend == "interp":
            return BlockSimulator(
                sched, self.params[layer.name], bias=None,
                transport=transport, counters=counters,
                engine=self.pe_engine, handle=self._handles[li])
        ex = self._executors.get((li, si))
        if ex is None:
            ex = TraceExecutor(
                sched, self.params[layer.name], bias=None,
                transport=transport, counters=counters,
                plan=self._trace_plans[li, si], use_jax=self.trace_jit,
                engine=self.pe_engine, handle=self._handles[li])
            self._executors[li, si] = ex
        else:
            ex.transport, ex.counters = transport, counters
        return ex

    def _run_layer(self, li: int, transport: NoCTransport,
                   counters: SimCounters, x: torch.Tensor,
                   account: bool = True) -> torch.Tensor:
        """Run one conv layer's block — whole, or strip by strip when the
        layer is width-tiled (same chain, per-strip tables, halo columns
        re-streamed; output strips concatenate along the width).

        ``account=False`` (trace backend only) computes the math without
        counters/transport side effects — the streaming numerics pass."""
        kw = {} if account else {"account": False}
        strips = self._strips.get(li)
        if strips is None:
            return self._executor(li, 0, self.schedules[li], transport,
                                  counters).run(x, **kw)
        layer = self.cnn.layers[li]
        b, p = x.shape[0], layer.p
        padded = torch.zeros((b, layer.h + 2 * p, layer.w + 2 * p, layer.c),
                             dtype=torch.float64, device=x.device)
        padded[:, p:p + layer.h, p:p + layer.w] = x
        outs = [
            self._executor(li, si, strip.sched, transport, counters)
            .run(padded[:, :, strip.lo:strip.hi], **kw)
            for si, strip in enumerate(strips)
        ]
        return torch.cat(outs, dim=2)

    # -- the layer pipeline as stages ---------------------------------------

    def _stage_timing(self, li: int) -> Tuple[int, int]:
        """(occupancy, latency) of one layer's stage in step-clock cycles
        (conv: the schedules' hand-off metadata over the weight-duplicated
        copies; FC: fully pipelined, chain depth is fill latency)."""
        lp = self.plan.layers[li]
        if lp.kind == "fc":
            return 1, max(1, lp.chain_len)
        strips = self._strips.get(li)
        hands = ([s.sched.handoff for s in strips] if strips is not None
                 else [self.schedules[li].handoff])
        dup = lp.duplication
        occ = max(1, math.ceil(sum(h.out_elems for h in hands) / dup))
        stream = math.ceil(sum(h.stream_len for h in hands) / dup)
        return occ, max(occ, stream) + max(h.drain for h in hands)

    def _build_stages(self) -> Tuple[_Stage, ...]:
        layers = self.cnn.layers
        stages: List[_Stage] = []
        prev_li: Optional[int] = None
        li = 0
        while li < len(layers):
            layer = layers[li]
            step = 1
            if isinstance(layer, ConvLayer):
                sc_li = None
                if layer.residual_from is not None and li + 1 < len(layers) \
                        and _is_shortcut(layers[li + 1]):
                    sc_li = li + 1  # projection runs concurrently in-stage
                    step = 2
                occ, lat = self._stage_timing(li)
                if sc_li is not None:
                    occ_sc, lat_sc = self._stage_timing(sc_li)
                    occ, lat = max(occ, occ_sc), max(lat, lat_sc)
                stages.append(_Stage(li=li, sc_li=sc_li, kind="conv",
                                     prev_li=prev_li, occupancy=occ,
                                     latency=lat))
            else:
                occ, lat = self._stage_timing(li)
                stages.append(_Stage(li=li, sc_li=None, kind="fc",
                                     prev_li=prev_li, occupancy=occ,
                                     latency=lat))
            prev_li = li
            li += step
        return tuple(stages)

    def _exec_stage(self, stage: _Stage, x: torch.Tensor,
                    saved: Dict[str, Tuple[torch.Tensor, Optional[int]]],
                    counters: SimCounters,
                    traffic: TrafficCounters,
                    account: bool = True) -> torch.Tensor:
        """Execute one pipeline stage on one (possibly batched) value.

        ``saved`` holds residual block inputs (name -> (value, producing
        layer)) between the ``*_a`` save and the shortcut add.
        ``account=False`` computes the math with no accounting side
        effects (the batched streaming numerics pass)."""
        placement = self.placement
        noc = placement.noc
        li = stage.li
        layer = self.cnn.layers[li]
        transport = NoCTransport(noc, base=placement.block_start[li],
                                 counters=traffic, recorder=self.recorder)
        if stage.kind == "fc":
            assert isinstance(layer, FCLayer)
            if x.dim() == 4:
                if self.cnn.name.startswith("resnet"):
                    x = _global_avg_pool(x)
                else:
                    x = x.reshape(x.shape[0], -1)  # VGG flattens
            act = "relu" if li < len(self.cnn.layers) - 1 else None
            return simulate_fc(
                x, self.params[layer.name], self.n_c, self.n_m,
                activation=act, counters=counters,
                transport=transport if account else None,
                engine=self.pe_engine, handle=self._handles[li])

        mesh_root = NoCTransport(noc, base=0, counters=traffic,
                                 recorder=self.recorder)
        if layer.name.endswith("_a"):
            saved[layer.name] = (x, stage.prev_li)  # residual save (Fig. 2)
        y = self._run_layer(li, transport, counters, x, account=account)
        if layer.residual_from is not None:
            block_in, block_in_src = saved.pop(layer.residual_from)
            res_bytes = int(np.prod(block_in.shape[1:]))  # per frame, 8b
            if stage.sc_li is not None:
                # projection shortcut: its own placed block, driven by
                # the saved block input
                sc_li = stage.sc_li
                sc_tr = NoCTransport(noc, base=placement.block_start[sc_li],
                                     counters=traffic,
                                     recorder=self.recorder)
                if account:
                    self._record_residual(mesh_root, block_in_src,
                                          placement.block_start[sc_li],
                                          res_bytes)
                shortcut = self._run_layer(sc_li, sc_tr, counters, block_in,
                                           account=account)
                if account:
                    lp = self.plan.layers[sc_li]
                    mesh_root.record(placement.block_end[sc_li],
                                     placement.block_end[li], RESIDUAL,
                                     lp.out_pixels * lp.c_out)
            else:
                # identity shortcut streams straight to the add
                if account:
                    self._record_residual(mesh_root, block_in_src,
                                          placement.block_end[li], res_bytes)
                shortcut = block_in
            # tail adder + activation after the shortcut join
            y = torch.clamp_min(y + shortcut, 0.0)
            counters.act_ops += y.shape[1] * y.shape[2] * y.shape[3]
        return y

    def _record_ofm(self, src_li: int, dst_li: int,
                    traffic: TrafficCounters) -> None:
        """OFM tail -> next consumer's head over the routed mesh link."""
        placement = self.placement
        lp = self.plan.layers[src_li]
        nbytes = lp.out_pixels * lp.c_out  # 8b activations
        NoCTransport(placement.noc, base=0, counters=traffic,
                     recorder=self.recorder).record(
            placement.block_end[src_li], placement.block_start[dst_li],
            OFM, nbytes)

    def _input(self, images) -> torch.Tensor:
        return torch.as_tensor(images).to(self.device, torch.float64)

    def run(self, images) -> NetworkSimResult:
        """images: (B, H, W, 3) or (H, W, 3) -> logits (B, classes)."""
        x = self._input(images)
        squeeze = x.dim() == 3
        if squeeze:
            x = x[None]
        counters = SimCounters()
        traffic = TrafficCounters()
        self.placement.noc.link_traffic.clear()  # per-run link stats
        saved: Dict[str, Tuple[torch.Tensor, Optional[int]]] = {}
        for s, stage in enumerate(self._stages):
            x = self._exec_stage(stage, x, saved, counters, traffic)
            if s + 1 < len(self._stages):
                self._record_ofm(stage.li, self._stages[s + 1].li, traffic)
        return NetworkSimResult(
            logits=x[0] if squeeze else x,
            counters=counters, traffic=traffic)

    def run_stream(self, frames, arrivals: Optional[np.ndarray] = None,
                   batched: bool = True,
                   chunk: Optional[int] = None) -> StreamResult:
        """Pipelined stream computing over ``frames`` (T, H, W, 3).
        ``arrivals`` gives each frame's arrival cycle (non-decreasing;
        default all at cycle 0, so the measured II is the slowest
        stage's).  Two strategies, equal by construction:

        * ``batched=True``: the batched numerics pass (all frames
          stage-major, ``chunk`` frames per sweep, default
          ``DEFAULT_STREAM_CHUNK``), then the analytic accounting and
          timing pass;
        * ``batched=False``: the per-cell oracle, the interleaved
          wavefront loop with one ``_exec_stage`` call per (frame,
          stage) cell and timing and accounting inline — the
          differential check of the batched path.
        """
        if not self.streaming:
            raise ValueError(
                "run_stream requires NetworkSimulator(..., "
                "backend='trace', streaming=True)")
        frames = self._input(frames)
        if frames.dim() != 4:
            raise ValueError(
                f"frames must be (T, H, W, C): {tuple(frames.shape)}")
        t_n = frames.shape[0]
        if t_n < 1:
            raise ValueError("run_stream needs at least one frame")
        stages = self._stages
        if arrivals is None:
            arr = np.zeros(t_n, np.int64)
        else:
            arr = np.asarray(arrivals, np.int64)
            if arr.shape != (t_n,):
                raise ValueError(
                    f"arrivals must be one cycle per frame: {arr.shape}")
            if not (np.diff(arr) >= 0).all():
                raise ValueError("arrivals must be in FIFO order")
        occ = [st.occupancy for st in stages]
        lat = [st.latency for st in stages]
        self.placement.noc.link_traffic.clear()  # per-stream link stats
        counters = [SimCounters() for _ in range(t_n)]
        traffic = [TrafficCounters() for _ in range(t_n)]
        if batched:
            logits, batch_sizes = self._stream_numerics(frames, chunk)
            for t in range(t_n):
                self._account_frame(counters[t], traffic[t])
            start, finish = stream_timeline(arr, occ, lat)
            fifo_depth = self._residual_fifo_depth(t_n)
        else:
            logits, start, finish, fifo_depth = self._stream_percell(
                frames, arr, occ, lat, counters, traffic)
            batch_sizes = (1,) * t_n
        exits = finish[:, -1]
        return StreamResult(
            logits=logits, frame_counters=counters,
            frame_traffic=traffic, arrivals=arr, start=start, finish=finish,
            occupancy=tuple(occ),
            measured_ii=int(exits[-1] - exits[-2]) if t_n >= 2 else None,
            analytic_ii=self.plan.initiation_interval,
            fill_latency=int(exits[0] - arr[0]),
            residual_fifo_depth=fifo_depth,
            batch_sizes=batch_sizes)

    # -- streaming: batched numerics pass ------------------------------------

    def _stream_numerics(self, frames: torch.Tensor, chunk: Optional[int]
                         ) -> Tuple[torch.Tensor, Tuple[int, ...]]:
        """Stage-major batched execution of all frames, math only
        (counters and traffic go to throwaway sinks)."""
        chunk = DEFAULT_STREAM_CHUNK if chunk is None else int(chunk)
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1: {chunk}")
        sink_c, sink_t = SimCounters(), TrafficCounters()
        outs: List[torch.Tensor] = []
        sizes: List[int] = []
        for lo in range(0, frames.shape[0], chunk):
            x = frames[lo:lo + chunk]
            sizes.append(x.shape[0])
            saved: Dict[str, Tuple[torch.Tensor, Optional[int]]] = {}
            for stage in self._stages:
                x = self._exec_stage(stage, x, saved, sink_c, sink_t,
                                     account=False)
            assert not saved
            outs.append(x)
        return torch.cat(outs, dim=0), tuple(sizes)

    # -- streaming: analytic timing / accounting pass ------------------------

    def _account_frame(self, counters: SimCounters,
                       traffic: TrafficCounters) -> None:
        """Replay one frame's accounting without executing any numerics
        (every increment is a function of the plan alone)."""
        saved: Dict[str, Tuple[Optional[int], int]] = {}
        stages = self._stages
        for s, stage in enumerate(stages):
            self._account_stage(stage, saved, counters, traffic)
            if s + 1 < len(stages):
                self._record_ofm(stage.li, stages[s + 1].li, traffic)

    def _account_stage(self, stage: _Stage,
                       saved: Dict[str, Tuple[Optional[int], int]],
                       counters: SimCounters,
                       traffic: TrafficCounters) -> None:
        """Accounting-only mirror of :meth:`_exec_stage` for one frame.
        ``saved`` maps residual saves to (producing layer, frame bytes)."""
        placement = self.placement
        noc = placement.noc
        li = stage.li
        layer = self.cnn.layers[li]
        transport = NoCTransport(noc, base=placement.block_start[li],
                                 counters=traffic, recorder=self.recorder)
        if stage.kind == "fc":
            # account_only walks the grid dataflow and emits its
            # (value-independent) increments without the engine MACs —
            # the probe row only sets the batch shape
            w = self.params[layer.name]
            act = "relu" if li < len(self.cnn.layers) - 1 else None
            simulate_fc(
                torch.zeros((1, w.shape[0]), dtype=torch.float64,
                            device=self.device),
                w, self.n_c, self.n_m, activation=act,
                counters=counters, transport=transport,
                engine=self.pe_engine, handle=self._handles[li],
                account_only=True)
            return
        mesh_root = NoCTransport(noc, base=0, counters=traffic,
                                 recorder=self.recorder)
        if layer.name.endswith("_a"):
            # the saved value is the *input* to the `_a` layer
            saved[layer.name] = (stage.prev_li, layer.h * layer.w * layer.c)
        self._account_layer(li, transport, counters)
        if layer.residual_from is not None:
            src_li, res_bytes = saved.pop(layer.residual_from)
            if stage.sc_li is not None:
                sc_li = stage.sc_li
                sc_tr = NoCTransport(noc, base=placement.block_start[sc_li],
                                     counters=traffic,
                                     recorder=self.recorder)
                self._record_residual(mesh_root, src_li,
                                      placement.block_start[sc_li],
                                      res_bytes)
                self._account_layer(sc_li, sc_tr, counters)
                lp = self.plan.layers[sc_li]
                mesh_root.record(placement.block_end[sc_li],
                                 placement.block_end[li], RESIDUAL,
                                 lp.out_pixels * lp.c_out)
            else:
                self._record_residual(mesh_root, src_li,
                                      placement.block_end[li], res_bytes)
            lp = self.plan.layers[li]
            counters.act_ops += lp.out_pixels * lp.c_out  # post-add ReLU

    def _account_layer(self, li: int, transport: NoCTransport,
                       counters: SimCounters) -> None:
        """One conv layer's analytic accounting (every strip)."""
        strips = self._strips.get(li)
        if strips is None:
            self._executor(li, 0, self.schedules[li], transport,
                           counters)._account()
        else:
            for si, strip in enumerate(strips):
                self._executor(li, si, strip.sched, transport,
                               counters)._account()

    def _residual_fifo_depth(self, t_n: int) -> int:
        """Closed form of the per-cell loop's FIFO occupancy maximum: a
        (save stage ``ks``, add stage ``ka``) entry for frame ``t`` is
        alive after wavefront step ``m`` iff ``ks <= m - t < ka``."""
        pairs: List[Tuple[int, int]] = []
        save_stage: Dict[str, int] = {}
        for k, st in enumerate(self._stages):
            if st.kind != "conv":
                continue
            layer = self.cnn.layers[st.li]
            if layer.name.endswith("_a"):
                save_stage[layer.name] = k
            if layer.residual_from is not None:
                pairs.append((save_stage[layer.residual_from], k))
        if not pairs:
            return 0
        depth = 0
        for m in range(t_n + len(self._stages) - 1):
            d = 0
            for ks, ka in pairs:
                lo, hi = max(0, m - ka + 1), min(t_n - 1, m - ks)
                d += max(0, hi - lo + 1)
            depth = max(depth, d)
        return depth

    # -- streaming: interleaved per-cell oracle ------------------------------

    def _stream_percell(self, frames: torch.Tensor, arr: np.ndarray,
                        occ: List[int], lat: List[int],
                        counters: List[SimCounters],
                        traffic: List[TrafficCounters]
                        ) -> Tuple[torch.Tensor, np.ndarray, np.ndarray, int]:
        """The interleaved wavefront loop, kept as the differential
        oracle: one ``_exec_stage`` call per (frame, stage) cell, timing
        recurrence and accounting inline."""
        t_n, s_n = frames.shape[0], len(self._stages)
        stages = self._stages
        saved: List[Dict[str, Tuple[torch.Tensor, Optional[int]]]] = [
            {} for _ in range(t_n)]
        inflight: Dict[int, torch.Tensor] = {}  # frame -> inter-stage value
        logits: List[Optional[torch.Tensor]] = [None] * t_n
        start = np.zeros((t_n, s_n), np.int64)
        finish = np.zeros((t_n, s_n), np.int64)
        fifo_depth = 0
        for step in range(t_n + s_n - 1):
            # wavefront: deeper stages hold older frames (t = step - k)
            for k in range(s_n - 1, -1, -1):
                t = step - k
                if not 0 <= t < t_n:
                    continue
                stage = stages[k]
                x = inflight.pop(t) if k else frames[t:t + 1]
                y = self._exec_stage(stage, x, saved[t], counters[t],
                                     traffic[t])
                # stage timeline: a stage initiates frame t when its
                # input is ready AND one initiation interval has passed
                # since it accepted frame t-1
                ready = finish[t, k - 1] if k else arr[t]
                init = ready if t == 0 \
                    else max(ready, start[t - 1, k] + occ[k])
                start[t, k] = init
                finish[t, k] = init + lat[k]
                if k + 1 < s_n:
                    self._record_ofm(stage.li, stages[k + 1].li, traffic[t])
                    inflight[t] = y
                else:
                    logits[t] = y[0]
            # shortcut FIFO occupancy across all in-flight frames
            fifo_depth = max(fifo_depth, sum(len(d) for d in saved))
        assert not inflight and all(lg is not None for lg in logits)
        return torch.stack(logits), start, finish, fifo_depth

    def _record_residual(self, mesh_root: NoCTransport,
                         src_layer: Optional[int], dst_tile: int,
                         nbytes: int) -> None:
        """Shortcut stream: the saved block input travels from its
        producer block's tail to the join/projection site (8b acts).
        ``nbytes`` is one frame's saved-input footprint (H*W*C)."""
        if src_layer is None:
            return  # shortcut of the very first layer: off-chip input
        mesh_root.record(self.placement.block_end[src_layer], dst_tile,
                         RESIDUAL, nbytes)
