"""Training entry point, the reference's ``repro/launch/train.py`` on one
device:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
      [--steps 100] [--batch 8] [--seq 128] [--reduced | --full] \
      [--optimizer adamw|adafactor|sgd] [--microbatches 2] \
      [--ckpt-dir /tmp/ckpt] [--ckpt-every 10] [--resume] \
      [--device cuda|cpu]

The reference's flags and defaults (the reduced config unless
``--full``; ``--reduction`` is accepted and has no effect on one
device), plus ``--device``.  The same loop: batches are the
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
"""
from __future__ import annotations

import argparse
import sys
import time


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
    args = ap.parse_args(argv)

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.data.pipeline import DataSpec, synthetic_batch, to_device
    from repro_torch.runtime.fault import StepGuard, StragglerMonitor
    from repro_torch.runtime.train_loop import build_train_program

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    pcfg = ParallelConfig(reduction=args.reduction, remat="full",
                          microbatches=args.microbatches)
    tcfg = TrainConfig(optimizer=args.optimizer, lr=args.lr,
                       warmup_steps=max(2, args.steps // 20),
                       total_steps=args.steps, seed=args.seed)
    prog = build_train_program(cfg, pcfg, tcfg, device=args.device)
    params, state = prog.init_fn(args.seed)

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
            restored, start_step = mgr.restore(
                {"params": params, "opt_state": state})
            params, state = restored["params"], restored["opt_state"]
            print(f"resumed from step {start_step}")

    monitor = StragglerMonitor()
    guard = StepGuard(recover=lambda s: print(f"recover to step {s}"))

    def extras_dtype(batch):
        dtype = params["embed"].dtype
        return {k: v.to(dtype) if k in ("frames", "patch_embeds") else v
                for k, v in batch.items()}

    for step in range(start_step, args.steps):
        batch = extras_dtype(to_device(synthetic_batch(spec, step),
                                       prog.device))
        t0 = time.time()
        params, state, metrics = guard.run(
            prog.step_fn, step, params, state, batch)
        dt = time.time() - t0
        if monitor.observe(step, dt):
            print(f"straggler escalation advised at step {step}")
        if step % args.log_every == 0:
            print(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.3f} {dt*1e3:.0f}ms",
                  flush=True)
        if mgr and args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            mgr.save(step + 1, {"params": params, "opt_state": state})
    if mgr:
        mgr.save(args.steps, {"params": params, "opt_state": state},
                 blocking=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
