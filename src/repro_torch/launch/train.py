"""Training entry point, the reference's ``repro/launch/train.py`` on one
device:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
      [--steps 100] [--batch 8] [--seq 128] [--reduced | --full] \
      [--optimizer adamw|adafactor|sgd] [--microbatches 2] \
      [--ckpt-dir /tmp/ckpt] [--ckpt-every 10] [--resume] \
      [--device cuda|cpu] [--dtype bfloat16|float32] [--tp 2 --dp 2 \
      --reduction ring|allreduce --backend nccl|gloo] [--zero3] \
      [--dp-only] [--grad-compression]

The reference's flags and defaults (the reduced config unless
``--full``; ``--reduction`` is accepted and has no effect on one
device), plus ``--device`` and ``--dtype`` (the params' dtype; by
default the config's).  The same loop: batches are the
deterministic ``synthetic_batch(spec, step)``, each step runs under the
``StepGuard`` and feeds the ``StragglerMonitor``, and checkpoints go to
``--ckpt-dir`` every ``--ckpt-every`` steps and at the end.  The port
checkpoints the optimizer state beside the params (the reference saves
the params alone), so ``--resume`` continues where the run stopped and
gives the uninterrupted run's params.  Every config in ``configs/``
trains: the dense decoder family (gemma3-1b, gemma2-27b, qwen2-0.5b,
minitron-8b), the MoE stack (granite-moe-3b-a800m), the Mamba stack
(falcon-mamba-7b), the hybrid (jamba-v0.1-52b), MLA with multi-token
prediction (deepseek-v3-671b), the vit_stub frontend (internvl2-2b) and
the encoder-decoder (seamless-m4t-large-v2).  The batch's speech frames
(seamless) and patch embeddings (internvl2), which ``synthetic_batch``
draws in float32, are cast to the params' dtype, as the serving CLI draws
them: with bfloat16 params the reference's decoder refuses float32
frames, and float32 patch embeddings would turn internvl2's whole stream
float32.

``--tp`` / ``--dp`` above 1 train on a (dp, tp) mesh (``launch/mesh.py``),
as the serving CLI serves on one: the CLI spawns ``dp * tp`` ranks, rank
r on ``cuda:(r % device_count)`` (or the CPU); ``--backend nccl`` needs
one card a rank, ``--backend gloo`` on the card copies every
collective's operand through the host.  Each rank draws the global
weights and keeps its shard, takes its rows of each global batch and
steps with Domino's ``ring`` or the ``allreduce`` baseline, ZeRO-1
optimizer states over both axes, and ``--zero3``, ``--dp-only`` and
``--grad-compression`` as ``ParallelConfig`` says.  Rank 0 prints, and
saves the checkpoints: the global state, gathered from every rank, so
``--resume`` restores it onto whatever mesh the new run has (another
``--tp`` / ``--dp``, or one device).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time


def _train(args, mesh=None) -> None:
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.convert import gather_train_state
    from repro_torch.data.pipeline import DataSpec, synthetic_batch, to_device
    from repro_torch.runtime.fault import StepGuard, StragglerMonitor
    from repro_torch.runtime.train_loop import build_train_program

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    pcfg = ParallelConfig(reduction=args.reduction, remat="full",
                          microbatches=args.microbatches, zero3=args.zero3,
                          dp_only=args.dp_only,
                          grad_compression=args.grad_compression)
    tcfg = TrainConfig(optimizer=args.optimizer, lr=args.lr,
                       warmup_steps=max(2, args.steps // 20),
                       total_steps=args.steps, seed=args.seed)
    device = args.device
    if mesh is not None and device == "cuda":
        import torch

        device = f"cuda:{mesh.both.ranks[mesh.rank_index] % torch.cuda.device_count()}"
    prog = build_train_program(cfg, pcfg, tcfg, device=device, mesh=mesh)
    params, state = prog.init_fn(args.seed)
    lead = mesh is None or mesh.rank_index == 0

    spec = DataSpec(vocab_size=cfg.vocab_size, seq_len=args.seq,
                    global_batch=args.batch, seed=args.seed,
                    frontend_kind=cfg.frontend.kind if cfg.frontend else "none",
                    frontend_dim=cfg.frontend.embed_dim if cfg.frontend else 0,
                    frontend_tokens=cfg.frontend.num_tokens if cfg.frontend else 0,
                    encdec=cfg.is_encdec)

    start_step = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir)
        if args.resume and mgr.latest_step() is not None:
            specs = coords = None
            if mesh is not None:
                specs = {"opt_state": prog.opt_specs,
                         "params": prog.param_specs}
                coords = mesh.coords_dict()
            restored, start_step = mgr.restore(
                {"params": params, "opt_state": state}, specs=specs,
                coords=coords)
            params, state = restored["params"], restored["opt_state"]
            if lead:
                print(f"resumed from step {start_step}")

    def save(step, blocking=False):
        gp, gs = gather_train_state(prog, params, state)
        if lead:
            mgr.save(step, {"params": gp, "opt_state": gs},
                     blocking=blocking or mesh is not None)

    monitor = StragglerMonitor()
    guard = StepGuard(recover=lambda s: print(f"recover to step {s}"),
                      mesh=mesh)

    def extras_dtype(batch):
        dtype = params["embed"].dtype
        return {k: v.to(dtype) if k in ("frames", "patch_embeds") else v
                for k, v in batch.items()}

    for step in range(start_step, args.steps):
        batch = extras_dtype(prog.shard_batch(to_device(
            synthetic_batch(spec, step), prog.device)))
        t0 = time.time()
        params, state, metrics = guard.run(
            prog.step_fn, step, params, state, batch)
        dt = time.time() - t0
        if monitor.observe(step, dt) and lead:
            print(f"straggler escalation advised at step {step}")
        if step % args.log_every == 0 and lead:
            print(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.3f} {dt*1e3:.0f}ms",
                  flush=True)
        if mgr and args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            save(step + 1)
    if mgr:
        save(args.steps, blocking=True)


def _rank(rank: int, world: int, args) -> None:
    from repro_torch.launch.mesh import make_mesh

    host_copies = args.backend == "gloo" and args.device == "cuda"
    mesh = make_mesh(args.dp, args.tp, backend=args.backend,
                     host_copies=host_copies)
    _train(args, mesh)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--reduction", default="ring",
                    choices=["ring", "allreduce"])
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--dtype", default=None, choices=["bfloat16", "float32"],
                    help="the params' dtype (default: the config's)")
    ap.add_argument("--tp", type=int, default=1,
                    help="model-axis ranks (tensor parallelism)")
    ap.add_argument("--dp", type=int, default=1, help="data-axis ranks")
    ap.add_argument("--backend", default="nccl", choices=["nccl", "gloo"])
    ap.add_argument("--zero3", action="store_true")
    ap.add_argument("--dp-only", action="store_true")
    ap.add_argument("--grad-compression", action="store_true")
    args = ap.parse_args(argv)
    if args.tp < 1 or args.dp < 1:
        ap.error("--tp and --dp are at least 1")
    world = args.tp * args.dp
    if world == 1:
        _train(args)
        return 0
    import tempfile

    import torch
    from repro_torch.launch.mesh import spawn

    if args.device == "cpu" and args.backend == "nccl":
        ap.error("nccl runs on cards: use --backend gloo with --device cpu")
    if args.device == "cuda":
        if not torch.cuda.is_available():
            ap.error("no CUDA device: pass --device cpu")
        cards = torch.cuda.device_count()
        if args.backend == "nccl" and cards < world:
            ap.error(f"nccl needs one card per rank: {world} ranks, {cards} "
                     "cards (--backend gloo shares cards through the host)")
    with tempfile.TemporaryDirectory() as tmp:
        spawn(_rank, world, args, tmp_dir=tmp, backend=args.backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
