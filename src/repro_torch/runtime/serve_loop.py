"""Serving on torch (``repro/runtime/serve_loop.py``).

LM half: :func:`build_serve_program` gives prefill and one-token decode
functions for a GQA, MLA, MoE or Mamba decoder stack, with or without a
``vit_stub`` frontend (``models/transformer.py``), or for the
encoder-decoder (``models/encdec.py``); prefill's causal attention runs
the sliding-window Hopper kernel, the Mamba prefill the selective-scan
kernel, and :func:`greedy_generate` drives them.  With ``cim_weights``
the matmul weights are int8 ``{"q", "s"}`` leaves (Domino: 8-bit
weights resident in the arrays; stacked (E, d, f) expert weights get a
scale per expert and column; MLA's projections, the MTP ``proj``,
``frontend_proj`` and the cross-attention projections as the reference
decides), dequantized on use; the router, the norms and the Mamba
``conv_w``, ``A_log``, ``D`` and ``dt_bias`` stay float.
``kv_dtype="int8"`` keeps the KV cache (MLA's latent ``c``) in int8
(Mamba state stays float32, and the encoder-decoder's cross-attention
cache the memory's dtype).

With a ``mesh`` (``launch/mesh.py``) the program is one rank's part of
the reference's ``shard_map``: the plan follows the reference's
``make_plan`` (tp the model axis, ``seq_cache`` from
``ParallelConfig.seq_sharded_cache``, ``reduction`` "ring" or
"allreduce"; ``dp_only``: tp = 1, the batch over both axes), parameter and cache specs come from
``runtime/partition.py`` (a cache's batch dim found by comparing its
shapes at ``batch`` and ``2 batch``), and ``prefill_fn`` / ``decode_fn``
take this rank's shard of the params and its rows of the batch (all of
them when the batch does not divide the data axis) and return the whole
(rows, V_pad) logits.  ``init_params`` draws the global weights and
keeps this rank's shard of each layer as it is drawn, so every rank of
a mesh holds one model and no rank holds all of it; with
``cim_weights`` it quantizes each global layer (the decisions of the
global shapes, each column's scale over all its rows, as the reference
quantizes its global params) before it cuts the codes and scales.

CNN half: :func:`serve_stream` is a request-queue loop that feeds image
frames into the pipelined streaming simulator (``core/network.py``) at
an offered rate and reports closed-loop latency/throughput; the
quantized weights route (:func:`quantize_cnn_params_for_serving` ->
:func:`build_stream_sim`) keeps int8 weights resident in the CIM
engine, whose MACs run the Hopper kernel on the card.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import is_quantized_leaf, quantize_weight
from repro_torch.device import resolve_device
from repro_torch.models import encdec as ED
from repro_torch.models import transformer as T
from repro_torch.models.common import ShardingPlan
from repro_torch.runtime import partition
from repro_torch.runtime.fault import StragglerMonitor
# the reference serves through its training ``make_plan``, and so does the
# port: dp_only serves at tp = 1 over both axes, zero3 has no effect
from repro_torch.runtime.train_loop import make_plan

#: leaf names that are true matmul weights (safe to int8-quantize with
#: per-output-column scales), as in the reference
QUANTIZABLE = frozenset({
    "wq", "wk", "wv", "wo", "w_in", "w_out", "w_gate",
    "w_uq", "w_uk", "w_uv", "w_dq", "w_dkv", "head",
    "shared_in", "shared_out", "shared_gate", "frontend_proj",
    "w_in_x", "w_in_z", "x_proj", "dt_proj", "proj",
})


def _leaves(tree, path=()):
    """(path, tensor) of every tensor leaf; ``{"q", "s"}`` dicts are
    leaves."""
    if isinstance(tree, dict) and not is_quantized_leaf(tree):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    else:
        yield path, tree


def _stack_counts(cfg: ModelConfig) -> Dict[str, Any]:
    """How often the reference stacks a leaf under each per-layer list:
    ``"layers"``, layer index -> repeat count of the reference segment
    holding it; the encoder-decoder's ``"encoder"`` and ``"decoder"``,
    its layer counts (the reference ``vmap``s each stack whole)."""
    if cfg.is_encdec:
        return {"encoder": cfg.encoder_layers, "decoder": cfg.num_layers}
    out, l = {}, 0
    for seg in T.build_segments(cfg):
        for _ in range(seg.count * len(seg.cycle)):
            out[l] = seg.count
            l += 1
    return {"layers": out}


def quantize_decisions(params, cfg: ModelConfig, min_size: int = 1 << 14
                       ) -> Dict[str, bool]:
    """Which leaves get int8 CIM residency, by "/"-joined path.

    The reference decides on scan-stacked leaves, so a layer's size
    counts ``count`` times, ``count`` being the repeat count of its
    reference segment (the layer count of an encoder-decoder's stack);
    the rule here does the same, so both packages quantize the same
    leaves."""
    counts = _stack_counts(cfg)
    out = {}
    for path, leaf in _leaves(params):
        stack = counts.get(path[0], 1)
        if isinstance(stack, dict):
            stack = stack[int(path[1])]
        out["/".join(path)] = bool(
            path[-1] in QUANTIZABLE and leaf.dim() >= 2
            and leaf.shape[-1] >= 16 and leaf.shape[-2] >= 16
            and leaf.numel() * stack >= min_size)
    return out


def quantize_params_for_serving(params, cfg: ModelConfig,
                                min_size: int = 1 << 14,
                                decisions: Optional[Dict[str, bool]] = None,
                                prefix: Tuple[str, ...] = ()):
    """Quantize the selected matmul weights to int8 + a float32 scale
    per output column (``core/cim.py::quantize_symmetric`` over the
    contraction axis); the layers dequantize on use
    (``models/common.py::resolve_w``).  A stacked (E, d, f) expert
    weight is quantized one expert at a time: the same codes and
    scales (each column's scale is its own), without a float32 copy of
    the whole stack (15 GB for one of deepseek-v3's).  Leaves already
    int8 pass as they are.  ``prefix``: the path of ``params`` in the
    whole tree that ``decisions`` names (one layer of it, say).

    On a mesh the reference quantizes the global params (a column's
    scale over all its rows) and shards the codes and scales after: a
    serve program's ``init_params`` quantizes each layer before it cuts
    the rank's shard, and ``convert.shard_lm_params`` takes quantized
    global params."""
    from repro_torch.core.cim import quantize_symmetric

    if decisions is None:
        decisions = quantize_decisions(params, cfg, min_size)

    def one(tree, path):
        if is_quantized_leaf(tree):
            return tree
        if isinstance(tree, dict):
            return {k: one(v, path + (str(k),)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [one(v, path + (str(i),)) for i, v in enumerate(tree)]
        if decisions.get("/".join(path), False):
            if tree.dim() > 2:  # a stack of experts, one at a time
                parts = [quantize_symmetric(w.float(), 8, axis=-2)
                         for w in tree]
                return {"q": torch.stack([q for q, _ in parts]),
                        "s": torch.stack([s for _, s in parts])}
            q, s = quantize_symmetric(tree.float(), 8, axis=-2)
            return {"q": q, "s": s}
        return tree

    return one(params, tuple(str(k) for k in prefix))


@dataclass
class ServeProgram:
    """Prefill and decode of one model on one device, or one rank's part
    of them on a mesh.

    ``prefill_fn(params, {"tokens": (rows, S)[, "patch_embeds" |
    "frames": (rows, N, embed_dim)]})`` -> (last-token logits (rows,
    V_pad) float32, caches grown to ``s_max``); ``decode_fn(params,
    token (rows,), caches, pos)`` -> (logits, caches), the caches updated
    in place.  ``rows`` is ``batch_local``: the batch, or this rank's
    part of it on a data axis it divides."""

    cfg: ModelConfig
    plan: ShardingPlan
    batch: int
    s_max: int
    kv_dtype: str
    cim_weights: bool
    quant_min_size: int
    device: torch.device
    prefill_fn: Callable
    decode_fn: Callable
    mesh: Any = None
    batch_local: int = 0
    param_specs: Any = None
    cache_specs: Any = None
    #: the int8 decisions of the global shapes (by "/"-joined path)
    decisions: Optional[Dict[str, bool]] = None

    def init_params(self, gen: torch.Generator, dtype=None):
        """Random params for this program's model (``models/encdec.py``
        for an encoder-decoder, ``models/transformer.py`` otherwise): on
        a mesh, the global draws of ``gen`` (those of a tp = 1 program
        where the global shapes are tp = 1's), each layer cut to this
        rank's shard as soon as it is drawn."""
        model = ED if self.cfg.is_encdec else T
        if self.mesh is None:
            return model.init_params(self.cfg, self.plan, gen, dtype)
        coords = self.mesh.coords_dict()

        def keep(path, tree):
            spec = self.param_specs
            for key in path:
                spec = spec[key]
            return partition.shard_tree(self.serving_params(tree, path),
                                        spec, coords)

        return self.serving_params(model.init_params(
            self.cfg, self.plan.as_global(), gen, dtype, shard_fn=keep))

    def shard_batch(self, batch_in: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """This rank's rows of a global batch (all of them where the
        batch does not divide the data axis)."""
        if self.mesh is None:
            return batch_in
        sizes = {"data": self.mesh.data.size, "model": self.mesh.model.size}
        dpn = 1
        for a in self.plan.dp_axes:
            dpn *= sizes[a]
        specs = partition.batch_specs(batch_in, self.plan.dp_axes, dpn)
        return partition.shard_tree(batch_in, specs,
                                    self.mesh.coords_dict())

    def serving_params(self, params, prefix: Tuple[str, ...] = ()):
        """``params`` as this program serves them: int8 ``{"q", "s"}``
        matmul weights when ``cim_weights``, else unchanged.  On a mesh,
        give it global params (then ``convert.shard_lm_params``), or the
        rank's params from ``init_params``, which are quantized
        already."""
        if not self.cim_weights:
            return params
        return quantize_params_for_serving(params, self.cfg,
                                           self.quant_min_size,
                                           self.decisions, prefix)


def _meta_params(cfg: ModelConfig, plan: ShardingPlan):
    model = ED if cfg.is_encdec else T
    return model.init_params(cfg, plan, partition.META)


def _meta_caches(cfg: ModelConfig, plan: ShardingPlan, b: int, s_max: int,
                 kv_dtype: str):
    if cfg.is_encdec:
        return ED.init_cache(cfg, plan, b, s_max, t_enc=s_max,
                             kv_dtype=kv_dtype, device="meta")
    return T.init_cache(cfg, plan, b, s_max, kv_dtype, device="meta")


def build_serve_program(cfg: ModelConfig, batch: int, s_max: int,
                        kv_dtype: str = "bfloat16",
                        cim_weights: bool = False,
                        quant_min_size: int = 1 << 14,
                        device=None, mesh=None, pcfg=None) -> ServeProgram:
    """Serving functions for ``cfg`` on ``device`` (``None`` = the card):
    prompts of ``batch`` rows, caches for ``s_max`` positions.  An
    encoder-decoder's prompt carries ``frames`` (batch, T, embed_dim), T
    > 0; a ``vit_stub`` model's may carry ``patch_embeds`` (batch, N,
    embed_dim), which the prompt's S >= N positions must hold.  Both
    move to the device in their own dtype.  With ``mesh`` (and ``pcfg``,
    a ``ParallelConfig``; its defaults without one) this rank's part of
    the sharded program; a prompt's S must then divide the model axis."""
    from repro_torch.configs.base import ParallelConfig

    if kv_dtype not in ("bfloat16", "int8"):
        raise ValueError(f"kv_dtype must be bfloat16 or int8: {kv_dtype}")
    dev = resolve_device(device)
    model = ED if cfg.is_encdec else T
    extra = ("frames" if cfg.is_encdec
             else "patch_embeds" if T.has_frontend(cfg) else None)
    rows, param_specs, cache_specs, decisions = batch, None, None, None
    if mesh is None:
        plan = ShardingPlan.for_model(cfg, tp=1)
    else:
        plan = make_plan(cfg, mesh, pcfg or ParallelConfig())
        g_params, l_params = partition.eval_shape_pair(
            lambda p: _meta_params(cfg, p), plan)
        if cim_weights:
            # the specs of the served leaves: codes and scales
            decisions = quantize_decisions(g_params, cfg, quant_min_size)
            g_params, l_params = (quantize_params_for_serving(
                t, cfg, decisions=decisions) for t in (g_params, l_params))
        param_specs = partition.derive_specs(g_params, l_params, plan.tp,
                                             plan.tp_axis)
        sizes = {"data": mesh.data.size, "model": mesh.model.size}
        dpn = 1
        for a in plan.dp_axes:
            dpn *= sizes[a]
        dp_entry = (plan.dp_axes if len(plan.dp_axes) > 1
                    else plan.dp_axes[0])
        divides = batch % dpn == 0
        rows = batch // dpn if divides else batch
        cl = _meta_caches(cfg, plan, batch, s_max, kv_dtype)
        c2 = _meta_caches(cfg, plan, 2 * batch, s_max, kv_dtype)
        specs = partition.derive_specs(
            _meta_caches(cfg, plan.as_global(), batch, s_max, kv_dtype), cl,
            plan.tp, plan.tp_axis)
        from repro_torch.tree import tree_map

        def add_batch(spec, a, b2):
            dims = list(spec.dims)
            for i, (da, db) in enumerate(zip(a.shape, b2.shape)):
                if da != db and dims[i] is None and divides and dpn > 1:
                    dims[i] = dp_entry
            return partition.Spec(tuple(dims))

        cache_specs = tree_map(add_batch, specs, cl, c2)

    @torch.no_grad()
    def prefill_fn(params, batch_in):
        tokens = batch_in["tokens"]
        if tokens.dim() != 2 or tokens.shape[0] != rows \
                or not 0 < tokens.shape[1] <= s_max:
            raise ValueError(f"tokens {tuple(tokens.shape)}: want ({rows}, "
                             f"S) with 0 < S <= s_max={s_max}")
        if plan.tp > 1 and tokens.shape[1] % plan.tp:
            raise ValueError(f"a prompt of {tokens.shape[1]} tokens does not "
                             f"shard over the model axis ({plan.tp})")
        unknown = set(batch_in) - {"tokens", extra}
        if unknown:
            raise ValueError(f"{cfg.name} takes no {sorted(unknown)}")
        extras = {}
        if extra in batch_in:
            e = batch_in[extra]
            width = cfg.frontend.embed_dim
            if e.dim() != 3 or e.shape[0] != rows or e.shape[1] == 0 \
                    or e.shape[2] != width:
                raise ValueError(f"{extra} {tuple(e.shape)}: want ({rows}, "
                                 f"N, {width}) with N > 0")
            extras[extra] = e.to(dev)
        elif cfg.is_encdec:
            raise ValueError(f"{cfg.name} needs frames")
        if cfg.is_encdec:
            return ED.prefill(params, {"tokens": tokens.to(dev), **extras},
                              cfg, plan, kv_dtype=kv_dtype, s_max=s_max)
        return T.prefill(params, tokens.to(dev), cfg, plan,
                         extras=extras or None, kv_dtype=kv_dtype,
                         s_max=s_max)

    @torch.no_grad()
    def decode_fn(params, token, caches, pos: int):
        if not 0 <= pos < s_max:
            raise ValueError(f"position {pos} outside the cache "
                             f"(s_max={s_max})")
        return model.decode_step(params, token.to(dev), caches, int(pos),
                                 cfg, plan, kv_dtype=kv_dtype)

    return ServeProgram(cfg=cfg, plan=plan, batch=batch, s_max=s_max,
                        kv_dtype=kv_dtype, cim_weights=cim_weights,
                        quant_min_size=quant_min_size, device=dev,
                        prefill_fn=prefill_fn, decode_fn=decode_fn,
                        mesh=mesh, batch_local=rows,
                        param_specs=param_specs, cache_specs=cache_specs,
                        decisions=decisions)


def greedy_generate(serve: ServeProgram, params, batch_in, steps: int,
                    on_logits: Optional[Callable] = None) -> torch.Tensor:
    """Batched greedy generation: prefill, then ``steps - 1`` decode
    steps, each feeding back the argmax token.  -> (B, steps) int32.
    ``on_logits(i, logits)``, when given, sees step ``i``'s logits (B, V)
    before their argmax (step 0 is the prefill)."""
    logits, caches = serve.prefill_fn(params, batch_in)
    pos = batch_in["tokens"].shape[1]
    if on_logits is not None:
        on_logits(0, logits)
    token = torch.argmax(logits, dim=-1).to(torch.int32)
    out = [token]
    for i in range(steps - 1):
        logits, caches = serve.decode_fn(params, token, caches, pos + i)
        if on_logits is not None:
            on_logits(i + 1, logits)
        token = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(token)
    return torch.stack(out, dim=1)


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
                     chiplets: int = 1, noi: str = "mesh", device=None,
                     **kw):
    """Serving-side constructor for the streaming simulator on
    ``device`` (``None`` = the card).

    Params carrying ``{"q", "s"}`` leaves (from
    :func:`quantize_cnn_params_for_serving`) run the CIM engine by
    default — the int8 weights stay resident — while float params run
    the exact engine; ``engine=`` overrides.

    ``chiplets > 1`` serves the model sharded over a two-level
    :class:`~repro_torch.core.noc.ChipletFabric` (``noi`` names the
    interposer topology): the plan is cut at stage boundaries by
    :func:`~repro_torch.core.noc.shard_network`, and streamed OFM
    hand-offs between chiplets cross the NoI as ordinary routed
    traffic.  An explicit ``placement=`` wins over these knobs."""
    from repro_torch.core.network import NetworkSimulator

    if engine is None:
        quantized = any(is_quantized_leaf(v) for v in params.values())
        engine = "cim" if quantized else "exact"
    if chiplets > 1 and "placement" not in kw:
        from repro_torch.core.mapping import plan_network
        from repro_torch.core.noc import shard_network

        # NetworkSimulator's own planning defaults, so the sharded
        # placement's block spans match the simulator's plan exactly
        plan = plan_network(cnn, n_c=kw.get("n_c", 256),
                            n_m=kw.get("n_m", 256),
                            reuse=kw.get("reuse", 1),
                            dup_cap=kw.get("dup_cap", 64),
                            dup_overrides=kw.get("dup_overrides") or {})
        kw["placement"] = shard_network(plan, chiplets, noi=noi)
    return NetworkSimulator(cnn, params, backend="trace", streaming=True,
                            engine=engine, device=device, **kw)


#: serve-latency histogram bounds (step-clock cycles, geometric ladder
#: covering CIFAR pipelines through ImageNet fill latencies)
LATENCY_BUCKETS_CYCLES = (
    1e3, 2e3, 5e3, 1e4, 2e4, 5e4, 1e5, 2e5, 5e5, 1e6, 2e6, 5e6, 1e7)


def serve_stream(sim, frames, offered_inf_s: Optional[float] = None,
                 clock_hz: Optional[float] = None, hist_bins: int = 16,
                 straggler: Optional[StragglerMonitor] = None,
                 metrics=None,
                 metric_labels: Optional[Dict[str, str]] = None,
                 batch_window: Optional[int] = None) -> StreamServeReport:
    """Request-queue front-end over the streaming simulator.

    ``frames`` (T, H, W, C) are the queued requests, arriving spaced at
    ``offered_inf_s`` (requests/second at the step clock; by default the
    analytic initiation-interval rate).  Each request's closed-loop
    latency runs from its arrival cycle to its pipeline exit in the
    simulated stage timeline and feeds a :class:`StragglerMonitor`.
    ``batch_window`` bounds the numerics micro-batch (``run_stream``'s
    chunk); it cannot change a reported value.

    ``metrics`` (a ``repro_torch.telemetry.MetricsRegistry``) registers
    the reference's Prometheus-style series — completed and flagged
    frame counters, the latency histogram, the queue-depth distribution,
    realized micro-batch sizes and goodput gauges — under the label set
    ``metric_labels`` (e.g. ``{"tenant": "a"}``).
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
        report = StreamServeReport(
            arrivals=empty, latency_cycles=empty,
            measured_ii=0, analytic_ii=sim.plan.initiation_interval,
            fill_latency=0, offered_inf_s=clock_hz / spacing,
            throughput_inf_s=0.0, clock_hz=clock_hz,
            latency_hist=np.histogram(empty, bins=hist_bins))
        if metrics is not None:
            _export_serve_metrics(metrics, dict(metric_labels or {}),
                                  report, None)
        return report
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
    report = StreamServeReport(
        arrivals=arrivals, latency_cycles=lat,
        measured_ii=res.measured_ii, analytic_ii=res.analytic_ii,
        fill_latency=res.fill_latency,
        offered_inf_s=clock_hz / spacing, throughput_inf_s=throughput,
        clock_hz=clock_hz, latency_hist=(counts, edges),
        flagged_frames=tuple(mon.flagged_steps),
        straggler_escalate=escalate, batch_sizes=res.batch_sizes,
        logits=res.logits)
    if metrics is not None:
        _export_serve_metrics(metrics, dict(metric_labels or {}),
                              report, res)
    return report


def _export_serve_metrics(metrics, labels: Dict[str, str],
                          report: StreamServeReport, res) -> None:
    """Register/update the serving series on a telemetry registry (the
    reference's export, host code).  ``res`` is the stream result (for
    exit times) or None for an empty run, which still registers every
    series at zero."""
    lnames = tuple(sorted(labels))

    def series(fam):
        return fam.labels(**labels)

    series(metrics.counter(
        "serve_frames_total", "requests completed", lnames)).inc(
            report.completed)
    series(metrics.counter(
        "serve_flagged_total", "straggler-flagged requests",
        lnames)).inc(len(report.flagged_frames))
    hist = series(metrics.histogram(
        "serve_latency_cycles", "closed-loop request latency (cycles)",
        lnames, buckets=LATENCY_BUCKETS_CYCLES))
    for cycles in report.latency_cycles:
        hist.observe(float(cycles))
    # queue depth sampled at each arrival: arrived minus already exited
    exits = np.sort(res.finish[:, -1]) if res is not None \
        else np.empty(0, np.int64)
    depth_hist = series(metrics.histogram(
        "serve_queue_depth", "frames in flight at each arrival", lnames,
        buckets=(1, 2, 4, 8, 16, 32, 64, 128)))
    peak = 0
    for i, a in enumerate(report.arrivals):
        depth = (i + 1) - int(np.searchsorted(exits, a, side="right"))
        peak = max(peak, depth)
        depth_hist.observe(depth)
    series(metrics.gauge(
        "serve_queue_depth_peak", "max frames in flight", lnames)).set(peak)
    series(metrics.gauge(
        "serve_goodput_inf_s", "measured completion rate", lnames)).set(
            report.throughput_inf_s)
    series(metrics.gauge(
        "serve_offered_inf_s", "offered request rate", lnames)).set(
            report.offered_inf_s)
    batch_hist = series(metrics.histogram(
        "serve_batch_size", "realized numerics micro-batch sizes", lnames,
        buckets=(1, 2, 4, 8, 16, 32, 64)))
    for size in (res.batch_sizes if res is not None else ()):
        batch_hist.observe(float(size))
    series(metrics.gauge(
        "serve_measured_ii_cycles", "steady-state exit spacing",
        lnames)).set(float(report.measured_ii)
                     if report.measured_ii is not None else 0.0)
    series(metrics.gauge(
        "serve_straggler_escalate", "monitor escalation tripped",
        lnames)).set(1.0 if report.straggler_escalate else 0.0)
