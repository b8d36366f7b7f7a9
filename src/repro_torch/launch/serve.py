"""Serving entry point: batched prefill + greedy decode, optionally with int8
CIM weights and an int8 KV cache, on one card or over a mesh of ranks.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \
      --full [--cim-weights --kv-dtype int8] [--batch 4] \
      [--prompt-len 32] [--gen 16] [--tp 2 --dp 1 \
      --reduction ring|allreduce --backend nccl|gloo]

Any arch the port runs: the dense GQA stacks (gemma3-1b, gemma2-27b,
qwen2-0.5b, minitron-8b), granite-moe-3b-a800m (MoE), falcon-mamba-7b
(Mamba), jamba-v0.1-52b (Mamba + attention + MoE; at ``--full`` its
32 layers hold 104 GB in bfloat16, more than one 80 GB card) and
deepseek-v3-671b (MLA + MoE; at ``--full`` its 61 layers hold 671 G
parameters, 1.3 TB in bfloat16, far more than one card: ``chip_smoke.py``
serves its first 4 layers at full width).  deepseek's multi-token
prediction block is built with the weights but not run: serving never
reads it.  seamless-m4t-large-v2 (encoder-decoder) gets random speech
frames (batch, prompt-len, 1024) and internvl2-2b (``vit_stub``) random
patch embeddings (batch, 256, 1024), as the reference's CLI draws them,
but in the params' dtype: with bfloat16 params the reference's decoder
refuses float32 frames, and float32 patch embeddings would turn
internvl2's whole stream float32.  internvl2's prompt must hold its
patch tokens, so its ``--prompt-len`` defaults to their number + 32.
Weights are random, from the port's ``init_params`` with a generator
seeded with 0; the prompt and the extras are random draws from the same
generator.  Without ``--full`` the arch's reduced config runs.
``--device cpu`` runs on the CPU (the kernels' plain versions).

``--tp`` / ``--dp`` above 1 serve on a (dp, tp) mesh
(``launch/mesh.py``): the CLI spawns ``dp * tp`` ranks itself, rank r on
``cuda:(r % device_count)`` (or the CPU), each drawing the global
weights and keeping its shard, with ``--reduction`` Domino's ``ring``
or the ``allreduce`` baseline.  ``--backend nccl`` needs one card per
rank; ``--backend gloo`` on the card copies every collective's operand
through the host (the ranks may then share a card).  Rank 0 prints
what the one-card run prints.  The prompt length must divide tp.
"""
from __future__ import annotations

import argparse
import sys
import tempfile
import time


def _draw_inputs(cfg, fe, args, gen, device, dtype):
    import torch

    batch = {"tokens": torch.randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len), generator=gen,
        device=device)}
    if fe is not None:
        n = args.prompt_len if cfg.is_encdec else fe.num_tokens
        key = "frames" if cfg.is_encdec else "patch_embeds"
        batch[key] = torch.randn(
            (args.batch, n, fe.embed_dim), generator=gen,
            device=device).to(dtype)
    return batch


def _config(args):
    from repro_torch.configs import get_config

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    fe = cfg.frontend if cfg.frontend and cfg.frontend.kind != "none" \
        else None
    if args.prompt_len is None:
        n_img = fe.num_tokens if fe and fe.kind == "vit_stub" else 0
        args.prompt_len = 32 if n_img < 32 else n_img + 32
    return cfg, fe


def _serve(args, mesh=None, rank: int = 0) -> None:
    import torch

    from repro_torch.configs.base import ParallelConfig
    from repro_torch.runtime.serve_loop import (
        build_serve_program,
        greedy_generate,
    )

    cfg, fe = _config(args)
    s_max = args.prompt_len + args.gen + 1
    device = args.device
    if mesh is not None and device == "cuda":
        device = f"cuda:{rank % torch.cuda.device_count()}"
    prog = build_serve_program(
        cfg, batch=args.batch, s_max=s_max, kv_dtype=args.kv_dtype,
        cim_weights=args.cim_weights,
        quant_min_size=1 if args.reduced else 1 << 14, device=device,
        mesh=mesh, pcfg=ParallelConfig(reduction=args.reduction))
    gen = torch.Generator(device=prog.device).manual_seed(0)
    params = prog.serving_params(prog.init_params(gen))
    batch = prog.shard_batch(_draw_inputs(cfg, fe, args, gen, prog.device,
                                          params["embed"].dtype))

    def sync():
        if prog.device.type == "cuda":
            torch.cuda.synchronize(prog.device)

    sync()
    t0 = time.perf_counter()
    tokens = greedy_generate(prog, params, batch, args.gen)
    sync()
    dt = time.perf_counter() - t0
    if rank:
        return
    name = (torch.cuda.get_device_name(prog.device)
            if prog.device.type == "cuda" else "cpu")
    where = ""
    if mesh is not None:
        where = (f" on a {mesh.shape} (data, model) mesh, {args.backend}, "
                 f"{args.reduction}")
        if mesh.host_copies:
            where += "; ranks share cards, collectives cross the host"
    print(f"{cfg.name}: generated {tuple(tokens.shape)} in {dt:.2f}s "
          f"({tokens.numel() / dt:.1f} tok/s, first call, on {name}{where})")
    print("sample:", tokens[0][:16].tolist())


def _rank(rank: int, world: int, args) -> None:
    from repro_torch.launch.mesh import make_mesh

    host_copies = args.backend == "gloo" and args.device == "cuda"
    mesh = make_mesh(args.dp, args.tp, backend=args.backend,
                     host_copies=host_copies)
    _serve(args, mesh, rank)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=None,
                    help="prompt tokens (default 32, or a vit_stub "
                    "frontend's patch tokens + 32 when more)")
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--kv-dtype", default="bfloat16",
                    choices=["bfloat16", "int8"])
    ap.add_argument("--cim-weights", action="store_true")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--tp", type=int, default=1,
                    help="model-axis ranks (tensor parallelism)")
    ap.add_argument("--dp", type=int, default=1, help="data-axis ranks")
    ap.add_argument("--reduction", default="ring",
                    choices=["ring", "allreduce"])
    ap.add_argument("--backend", default="nccl", choices=["nccl", "gloo"])
    args = ap.parse_args(argv)
    if args.tp < 1 or args.dp < 1:
        ap.error("--tp and --dp are at least 1")
    world = args.tp * args.dp
    if world == 1:
        _serve(args)
        return 0

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
