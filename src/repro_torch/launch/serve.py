"""Serving entry point: batched prefill + greedy decode, optionally with int8
CIM weights and an int8 KV cache, on one card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \
      --full [--cim-weights --kv-dtype int8] [--batch 4] \
      [--prompt-len 32] [--gen 16]

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
"""
from __future__ import annotations

import argparse
import sys
import time


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
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_config
    from repro_torch.runtime.serve_loop import (
        build_serve_program,
        greedy_generate,
    )

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    fe = cfg.frontend if cfg.frontend and cfg.frontend.kind != "none" \
        else None
    if args.prompt_len is None:
        n_img = fe.num_tokens if fe and fe.kind == "vit_stub" else 0
        args.prompt_len = 32 if n_img < 32 else n_img + 32
    s_max = args.prompt_len + args.gen + 1
    prog = build_serve_program(cfg, batch=args.batch, s_max=s_max,
                               kv_dtype=args.kv_dtype,
                               cim_weights=args.cim_weights,
                               quant_min_size=1 if args.reduced else 1 << 14,
                               device=args.device)
    gen = torch.Generator(device=prog.device).manual_seed(0)
    params = prog.serving_params(prog.init_params(gen))
    batch = {"tokens": torch.randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len), generator=gen,
        device=prog.device)}
    if fe is not None:
        n = args.prompt_len if cfg.is_encdec else fe.num_tokens
        key = "frames" if cfg.is_encdec else "patch_embeds"
        batch[key] = torch.randn(
            (args.batch, n, fe.embed_dim), generator=gen,
            device=prog.device).to(params["embed"].dtype)

    def sync():
        if prog.device.type == "cuda":
            torch.cuda.synchronize(prog.device)

    sync()
    t0 = time.perf_counter()
    tokens = greedy_generate(prog, params, batch, args.gen)
    sync()
    dt = time.perf_counter() - t0
    name = (torch.cuda.get_device_name(prog.device)
            if prog.device.type == "cuda" else "cpu")
    print(f"{cfg.name}: generated {tuple(tokens.shape)} in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s, first call, on {name})")
    print("sample:", tokens[0][:16].tolist())
    return 0


if __name__ == "__main__":
    sys.exit(main())
