"""Dry-run core: one rank's program of every (arch x shape x mesh) cell,
run eagerly on fake tensors over a fake process group, counted, and its
roofline row.

The reference (``repro/launch/dryrun_lib.py``) lowers and compiles each
cell's program on ``ShapeDtypeStruct`` inputs and parses the compiled
HLO.  The port has no compiler to ask, so :func:`dry_cell` runs the
program itself, once, as the rank of a mesh of ``data x model`` ranks
that one process stands for:

* the world is torch's fake process group of that size
  (``compat.init_fake_process_group``) and the mesh is built on its
  ``"fake"`` backend (``launch/mesh.py``), so every collective returns
  at once and ``core/dataflow.py`` still counts what it would send;
* every tensor is fake (``compat.fake_tensor_mode``): params, optimizer
  state, batch and caches are empty tensors of the rank's shapes, made
  from the meta trees the programs already derive their specs from
  (``runtime/partition.py``, ``train_loop.train_specs``,
  ``serve_loop._meta_params``), on ``"cuda"`` with no card;
* the kernel wrappers see fake operands, report their work to the
  counter and return empty outputs in place of a launch;
* :class:`~repro_torch.analysis.op_stats.OpStats` counts the train
  step, the prefill, or the decode step against a cache of the shape's
  length: products, kernels, collectives and memory.

Eager dispatch runs every loop iteration, so the counts are loop-aware
by construction.  ``device="cpu"`` dry-runs the CPU's plain route
instead: the kernels' plain versions dispatch aten products, as the
reference's jnp does.  A world of one rank needs no process group: the
program is the tp = 1 one (``mesh=None``), as a one-device run builds
it.
"""
from __future__ import annotations

import json
import os
import time
import traceback
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.analysis.op_stats import OpStats
from repro_torch.analysis.roofline import H100_SXM, Roofline, model_flops
from repro_torch.configs import SHAPES, get_config, shape_applicable
from repro_torch.configs.base import ModelConfig, ParallelConfig, \
    ShapeConfig, TrainConfig
from repro_torch.launch.inputs import decode_token_spec, \
    prefill_input_specs, train_input_specs
from repro_torch.tree import tree_map


class SkipCell(Exception):
    pass


def auto_microbatches(cfg: ModelConfig, shape: ShapeConfig, dp: int,
                      budget_bytes: float = 2.5e9) -> int:
    """Pick grad-accumulation so the remat residual stack fits:
    (B/dp/mb) * S * d_model * L * 2B <= budget."""
    b_local = max(1, shape.global_batch // dp)
    per_seq = shape.seq_len * cfg.d_model * 2 * (cfg.num_layers
                                                 + cfg.encoder_layers)
    mb = 1
    while b_local // mb > 1 and (b_local / mb) * per_seq > budget_bytes:
        mb *= 2
    mb = min(mb, b_local)
    while shape.global_batch % (dp * mb):
        mb //= 2
    return max(mb, 1)


def train_config_for(cfg: ModelConfig) -> TrainConfig:
    # Adam state for 671B (12 B/param) cannot fit the pod: Adafactor with
    # factored second moment (T5X practice).  bf16 moments elsewhere.
    if cfg.param_count() > 100e9:
        return TrainConfig(optimizer="adafactor", moment_dtype="float32")
    return TrainConfig(optimizer="adamw", moment_dtype="bfloat16")


def parallel_config_for(cfg: ModelConfig, shape: ShapeConfig,
                        mesh_shape: Tuple[int, int],
                        reduction: str = "ring",
                        remat: str = "full") -> ParallelConfig:
    """The reference's choice for a cell on a (data, model) mesh: every
    axis but the model axis is a data axis (a folded multi-pod mesh's
    data axis holds the pod axis), ZeRO over both."""
    dp = mesh_shape[0]
    kv_dtype = "bfloat16"
    if shape.kind == "decode" and cfg.param_count() > 100e9:
        kv_dtype = "int8"  # MLA latent cache at 32k x 128 batch
    return ParallelConfig(
        reduction=reduction,
        remat=remat,
        microbatches=(auto_microbatches(cfg, shape, dp)
                      if shape.kind == "train" else 1),
        zero_axes=("data", "model"),
        kv_cache_dtype=kv_dtype,
        cim_weights=shape.kind != "train",
        # FSDP-style param gathering for >100B training (84 GB/dev of
        # bf16 params otherwise)
        zero3=shape.kind == "train" and cfg.param_count() > 100e9,
    )


@dataclass
class DryRun:
    """One rank's counted program: the counter, and what the row
    needs."""

    cfg: ModelConfig
    shape: ShapeConfig
    mesh_shape: Tuple[int, int]
    stats: OpStats
    #: args / temp / out / total, in bytes: the resident trees, the peak
    #: of the storages the program made, those alive at its end, and
    #: resident + peak
    memory: Dict[str, int]
    seconds: float


def _local(shape, spec, sizes: Dict[str, int]) -> Tuple[int, ...]:
    """A global shape cut by ``spec`` on a mesh of ``sizes``."""
    from repro_torch.runtime.train_loop import _parts

    coords = {name: (0, n) for name, n in sizes.items()}
    dims = list(spec.dims) + [None] * (len(shape) - len(spec.dims))
    return tuple(int(s) // _parts(e, coords) for s, e in zip(shape, dims))


def _empty_like_meta(tree, device):
    return tree_map(lambda t: torch.empty(tuple(t.shape), dtype=t.dtype,
                                          device=device), tree)


def _train_args(prog, cfg, pcfg, tcfg, batch, device, sizes):
    """(params, opt_state, batch) of this rank, empty."""
    from repro_torch.optim import optimizer as opt
    from repro_torch.runtime import partition
    from repro_torch.runtime.train_loop import init_for

    if prog.mesh is None:
        params = _empty_like_meta(
            init_for(cfg)(cfg, prog.plan, partition.META), device)
        return params, opt.init_opt_state(params, tcfg,
                                          pcfg.grad_compression), batch
    g_meta = init_for(cfg)(cfg, prog.plan.as_global(), partition.META)
    params = tree_map(lambda g, lay: torch.empty(
        _local(g.shape, lay.pspec, sizes), dtype=g.dtype, device=device),
        g_meta, prog.layouts)
    return params, prog.init_state(params), prog.shard_batch(batch)


def _serve_params(prog, cfg):
    """This rank's serving params, empty: the local meta tree, quantized
    as the program serves it."""
    from repro_torch.runtime import serve_loop

    meta = serve_loop._meta_params(cfg, prog.plan)
    if prog.cim_weights:
        meta = serve_loop.quantize_params_for_serving(
            meta, cfg, prog.quant_min_size, prog.decisions)
    return _empty_like_meta(meta, prog.device)


def _serve_caches(prog, cfg, sizes):
    """This rank's decode caches at ``s_max``, empty."""
    from repro_torch.runtime import serve_loop

    if prog.mesh is None:
        return _empty_like_meta(serve_loop._meta_caches(
            cfg, prog.plan, prog.batch, prog.s_max, prog.kv_dtype),
            prog.device)
    glob = serve_loop._meta_caches(cfg, prog.plan.as_global(), prog.batch,
                                   prog.s_max, prog.kv_dtype)
    return tree_map(lambda g, spec: torch.empty(
        _local(g.shape, spec, sizes), dtype=g.dtype, device=prog.device),
        glob, prog.cache_specs)


def dry_cell(arch: str, shape: Union[str, ShapeConfig],
             mesh_shape: Tuple[int, int], *, reduction: str = "ring",
             remat: str = "full", pcfg: Optional[ParallelConfig] = None,
             cfg: Optional[ModelConfig] = None,
             tcfg: Optional[TrainConfig] = None, rank: int = 0,
             device: str = "cuda", s_max: Optional[int] = None,
             donate: bool = True) -> DryRun:
    """Rank ``rank``'s program of one cell on a (data, model) mesh,
    counted (module docstring).  ``shape``: a ``SHAPES`` name or a
    ``ShapeConfig``; ``cfg``, ``pcfg``, ``tcfg``: the config, parallel
    config and train config (the reference's choices by default);
    ``s_max``: the serving caches' length (the shape's by default; a
    prefill may fill it); ``donate``: the train step writes its params
    and optimizer state in place, as the reference's jitted step
    donates them (False: a functional step, two copies at its end).
    Raises :class:`SkipCell` where the reference skips the cell."""
    import torch.distributed as dist

    from repro_torch import compat
    from repro_torch.launch.mesh import make_mesh

    cfg = cfg or get_config(arch)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        raise SkipCell(why)
    pcfg = pcfg or parallel_config_for(cfg, shape, mesh_shape, reduction,
                                       remat)
    data, model = mesh_shape
    world = data * model
    sizes = {"data": data, "model": model}
    t0 = time.perf_counter()
    if world > 1:
        compat.init_fake_process_group(rank, world)
    try:
        with compat.fake_tensor_mode():
            mesh = make_mesh(data, model, backend="fake") \
                if world > 1 else None
            # an explicit index: with no card torch cannot name the
            # current one
            dev = torch.device("cuda", 0) if device == "cuda" \
                else torch.device(device)
            stats, memory = _run(cfg, shape, pcfg, tcfg, mesh, dev, sizes,
                                 s_max, donate)
    finally:
        if world > 1:
            dist.destroy_process_group()
    return DryRun(cfg=cfg, shape=shape, mesh_shape=tuple(mesh_shape),
                  stats=stats, memory=memory,
                  seconds=time.perf_counter() - t0)


def _run(cfg, shape, pcfg, tcfg, mesh, dev, sizes, s_max, donate):
    from repro_torch.runtime.serve_loop import build_serve_program
    from repro_torch.runtime.train_loop import build_train_program

    if shape.kind == "train":
        tcfg = tcfg or train_config_for(cfg)
        prog = build_train_program(cfg, pcfg, tcfg, device=dev,
                                   donate=donate, mesh=mesh)
        params, state, batch = _train_args(
            prog, cfg, pcfg, tcfg, train_input_specs(cfg, shape, dev), dev,
            sizes)
        resident = (params, state, batch)
        with OpStats(resident=resident) as stats:
            out = prog.step_fn(params, state, batch)
            memory = _memory(stats)
    else:
        prog = build_serve_program(
            cfg, batch=shape.global_batch, s_max=s_max or shape.seq_len,
            kv_dtype=pcfg.kv_cache_dtype, cim_weights=pcfg.cim_weights,
            device=dev, mesh=mesh, pcfg=pcfg)
        params = _serve_params(prog, cfg)
        if shape.kind == "prefill":
            batch = prog.shard_batch(prefill_input_specs(cfg, shape, dev))
            resident = (params, batch)
            with OpStats(resident=resident) as stats:
                out = prog.prefill_fn(params, batch)
                memory = _memory(stats)
        else:  # decode: one token against a cache of s_max positions
            token = prog.shard_batch(
                {"tokens": decode_token_spec(shape, dev)[:, None]}
            )["tokens"][:, 0]
            caches = _serve_caches(prog, cfg, sizes)
            resident = (params, token, caches)
            with OpStats(resident=resident) as stats:
                out = prog.decode_fn(params, token, caches, prog.s_max - 1)
                memory = _memory(stats)
    del out
    return stats, memory


def _memory(stats: OpStats) -> Dict[str, int]:
    """Read while the program's outputs are still referenced."""
    return {"args": stats.resident_bytes, "temp": stats.peak_bytes,
            "out": stats.live_bytes,
            "total": stats.resident_bytes + stats.peak_bytes}


def analyze_cell(run: DryRun, arch: str, shape_name: str, mesh_name: str
                 ) -> Dict[str, Any]:
    """The reference's roofline row of a dry run on the H100, its flops by
    the dtype whose peak they run at (``flops_by_dtype``), and each
    kernel's counted calls, operations and bytes (``kernels``)."""
    st = run.stats
    rl = Roofline(
        arch=arch, shape=shape_name, mesh=mesh_name,
        flops_per_device=float(st.flops),
        bytes_per_device=float(st.hbm_bytes),
        wire_bytes_per_device=float(st.wire_bytes),
        model_flops_total=model_flops(run.cfg, run.shape),
        chips=run.mesh_shape[0] * run.mesh_shape[1], device=H100_SXM,
        dtype=run.cfg.dtype,
        op_counts=dict(st.op_counts),
        memory_per_device={f"{k}_GB": v / 1e9
                           for k, v in run.memory.items()},
        flops_by_dtype={k: float(v) for k, v in st.flops_by_dtype.items()})
    row = rl.row()
    row["flops_by_dtype"] = rl.flops_by_dtype
    row["kernels"] = {k: dict(v) for k, v in st.kernels.items()}
    return row


def run_matrix(archs, shape_names, mesh_shape: Tuple[int, int],
               mesh_name: str, out_path: str, reduction: str = "ring",
               device: str = "cuda") -> Dict[str, Any]:
    """Dry-run every applicable cell on ``device``'s route; stream
    results to JSON (cells already ``ok`` there on the same route are
    kept: the route is part of each key)."""
    results: Dict[str, Any] = {}
    if os.path.exists(out_path):
        with open(out_path) as f:
            results = json.load(f)
    for arch in archs:
        for shape_name in shape_names:
            key = f"{arch}|{shape_name}|{mesh_name}|{reduction}|{device}"
            if key in results and results[key].get("status") == "ok":
                continue
            t0 = time.time()
            try:
                run = dry_cell(arch, shape_name, mesh_shape,
                               reduction=reduction, device=device)
                row = analyze_cell(run, arch, shape_name, mesh_name)
                row["status"] = "ok"
                row["reduction"] = reduction
                row["device"] = device
                row["run_s"] = time.time() - t0
                del run
            except SkipCell as e:
                row = {"status": "skip", "reason": str(e), "arch": arch,
                       "shape": shape_name, "mesh": mesh_name,
                       "device": device}
            except Exception as e:  # noqa: BLE001 — record and continue
                row = {"status": "fail", "error": f"{type(e).__name__}: {e}",
                       "trace": traceback.format_exc()[-2000:],
                       "arch": arch, "shape": shape_name, "mesh": mesh_name,
                       "device": device, "run_s": time.time() - t0}
            results[key] = row
            with open(out_path, "w") as f:
                json.dump(results, f, indent=1, default=str)
            print(f"[{time.strftime('%H:%M:%S')}] {key}: "
                  f"{row['status']} ({row.get('run_s', 0):.1f}s)",
                  flush=True)
    return results
