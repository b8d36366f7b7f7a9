"""Rank programs of the port's tp > 1 CPU parity tests
(``test_torch_dataflow.py``, ``test_torch_serve_tp.py``).

``launch/mesh.py::spawn`` starts each in new processes, which import
this module by name: it imports torch and the port only (no jax, no
reference), and the test modules import it to draw the same inputs the
ranks draw.  Every input is drawn from a seed (numpy for the dataflow
cases, a CPU ``torch.Generator`` for params and prompts), so the parent
and every rank see the same global arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# ---------------------------------------------------------------------------
# core/dataflow.py
# ---------------------------------------------------------------------------

#: x (B, S, K) against w (K, N), the reference's test_dataflow.py sizes
B, S, K, N = 4, 16, 32, 24
#: lse_merge_decode_attention: (B, H, S_CACHE, D), VALID filled slots
H, D, S_CACHE, VALID = 3, 8, 16, 5
DATAFLOW_FNS = ("ring_reducescatter_matmul", "allreduce_matmul",
                "ring_allgather_matmul", "allgather_matmul",
                "up_ring", "up_allreduce", "down_ring", "down_allreduce")
DOWN = {"ring_reducescatter_matmul", "allreduce_matmul", "down_ring",
        "down_allreduce"}


def dataflow_inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) / K ** 0.5).astype(np.float32)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kc = rng.standard_normal((B, H, S_CACHE, D)).astype(np.float32)
    vc = rng.standard_normal((B, H, S_CACHE, D)).astype(np.float32)
    valid = np.zeros((B, S_CACHE), bool)
    valid[:, :VALID] = True
    return x, w, q, kc, vc, valid


def dataflow_case_names():
    names = [f"{fn}-k{k}-{'tanh' if tail else 'none'}"
             for k in (2, 4) for fn in DATAFLOW_FNS for tail in (False, True)]
    return names + [f"lse_merge-k{k}" for k in (2, 4)]


def _dataflow_call(fn_name, x, w, axis, tail):
    from repro_torch.core import dataflow as df

    if fn_name.startswith(("up_", "down_")):
        kind, red = fn_name.split("_")
        fn = df.up_matmul if kind == "up" else df.down_matmul
        return fn(x, w, axis=axis, reduction=red, tail=tail)
    return getattr(df, fn_name)(x, w, axis, tail=tail)


def dataflow_cases(rank: int, world: int):
    """Every case at k = 2 (on a (2, 2) mesh: the data axis splits the
    batch) and k = 4 (a (1, 4) mesh).  -> {case: (coords, this rank's
    output)}.  A down product takes the rank's contraction slice and
    returns its sequence chunk; an up product takes its sequence chunk
    and its column slice and returns the whole sequence."""
    from repro_torch.core import dataflow as df
    from repro_torch.launch.mesh import make_mesh

    torch.set_num_threads(1)  # four ranks share the host's cores
    x, w, q, kc, vc, valid = (torch.from_numpy(a)
                              for a in dataflow_inputs())
    out = {}
    for k, shape in ((2, (2, 2)), (4, (1, 4))):
        mesh = make_mesh(*shape, backend="gloo")
        d, m = mesh.coords
        rows = slice(d * (B // shape[0]), (d + 1) * (B // shape[0]))
        for fn_name in DATAFLOW_FNS:
            for tail in (None, torch.tanh):
                if fn_name in DOWN:
                    kk = K // k
                    xl = x[rows, :, m * kk:(m + 1) * kk]
                    wl = w[m * kk:(m + 1) * kk]
                else:
                    ss, nn = S // k, N // k
                    xl = x[rows, m * ss:(m + 1) * ss]
                    wl = w[:, m * nn:(m + 1) * nn]
                name = (f"{fn_name}-k{k}-"
                        f"{'tanh' if tail is not None else 'none'}")
                out[name] = (mesh.coords, _dataflow_call(
                    fn_name, xl.contiguous(), wl.contiguous(), mesh.model,
                    tail))
        sc = S_CACHE // k
        cut = slice(m * sc, (m + 1) * sc)
        out[f"lse_merge-k{k}"] = (mesh.coords, df.lse_merge_decode_attention(
            q[rows], kc[rows, :, cut], vc[rows, :, cut], valid[rows, cut],
            mesh.model))
    out["grads"] = dataflow_grad_cases(rank, world)
    return out


def failing_rank(rank: int, world: int):
    """Rank 1 raises; rank 0 waits for it in a collective."""
    import torch.distributed as dist

    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.all_reduce(torch.ones(1))
    return rank


# ---------------------------------------------------------------------------
# Serving at tp > 1
# ---------------------------------------------------------------------------

#: the families at their reduced configs
FAMILIES = ("gemma3-1b", "qwen2-0.5b", "granite-moe-3b-a800m",
            "falcon-mamba-7b", "jamba-v0.1-52b", "deepseek-v3-671b",
            "seamless-m4t-large-v2", "internvl2-2b")
#: global batch, prompt (divides 2 and 4; longer than gemma3's window
#: ring of 9), decode steps, cache positions (15: the sequence-sharded
#: cache pads it to 16 at tp = 4)
SERVE_B, PROMPT, STEPS, S_MAX = 4, 12, 2, 15
#: (mesh shape, ranks, reduction) of the family runs
MESHES = {"1x2-ring": ((1, 2), (0, 1), "ring"),
          "1x2-allreduce": ((1, 2), (2, 3), "allreduce"),
          "2x2-ring": ((2, 2), (0, 1, 2, 3), "ring")}
#: int8 weights (each global leaf quantized, then sharded) and an int8
#: KV cache, on the two (1, 2) meshes
CIM_FAMILIES = {"1x2-ring": ("gemma3-1b", "deepseek-v3-671b"),
                "1x2-allreduce": ("granite-moe-3b-a800m", "falcon-mamba-7b")}
#: granite with a capacity factor of 0.5 (pairs drop, per rank) on this
#: mesh, held against the reference's own sharded run
DROP_MESH = "1x2-ring"
#: the MoE block with experts padded: 6 experts at tp = 4 (E_total 8),
#: capacity factor low enough to drop pairs
MOE_PAD_EXPERTS, MOE_PAD_CF, MOE_PAD_TP = 6, 0.5, 4
MOE_B, MOE_S = 2, 16


def variant(cfg, name: str):
    """A config variant, for either package's ``ModelConfig`` (the same
    field names): "seq_cache" is test_seq_cache.py's qwen2 with H = 6,
    KV = 2 (H does not divide tp = 4: replicated attention and the
    sequence-sharded cache); "moe_pad" is granite with 6 experts and a
    capacity factor of 0.5; "moe_drop" granite with that capacity
    factor alone."""
    if name == "seq_cache":
        return dataclasses.replace(cfg, attention=dataclasses.replace(
            cfg.attention, num_heads=6, num_kv_heads=2))
    if name == "moe_pad":
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=MOE_PAD_EXPERTS,
            capacity_factor=MOE_PAD_CF))
    if name == "moe_drop":
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=MOE_PAD_CF))
    raise KeyError(name)


def port_config(arch: str, var: str = None):
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    return variant(cfg, var) if var else cfg


def _randomize(tree, gen):
    """Norm scales and biases non-zero (drawn from ``gen``), so that
    those paths count."""
    if isinstance(tree, dict):
        return {k: (0.1 * torch.randn(v.shape, generator=gen)
                    if isinstance(v, torch.Tensor) and any(
                        n in k for n in ("norm", "bq", "bk", "bv", "conv_b"))
                    else _randomize(v, gen))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_randomize(v, gen) for v in tree]
    return tree


def global_params(cfg, seed: int = 0, experts_pad: int = 0):
    """Float32 global params of ``cfg`` in the port's serving layout:
    the port's init at tp = 1 (with ``experts_pad`` padded experts),
    norms and biases redrawn non-zero."""
    from repro_torch.models import encdec as ED
    from repro_torch.models import transformer as T
    from repro_torch.models.common import ShardingPlan

    gen = torch.Generator().manual_seed(seed)
    model = ED if cfg.is_encdec else T
    params = model.init_params(cfg, ShardingPlan(tp=1,
                                                 experts_pad=experts_pad),
                               gen, torch.float32)
    return _randomize(params, gen)


def serve_inputs(cfg, seed: int = 1):
    """(the global prompt batch, the decode steps' tokens (B, STEPS))."""
    gen = torch.Generator().manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (SERVE_B, PROMPT),
                                     generator=gen, dtype=torch.int32)}
    fe = cfg.frontend
    if fe is not None and fe.kind != "none":
        n = PROMPT if cfg.is_encdec else fe.num_tokens
        key = "frames" if cfg.is_encdec else "patch_embeds"
        batch[key] = torch.randn((SERVE_B, n, fe.embed_dim), generator=gen)
    steps = torch.randint(0, cfg.vocab_size, (SERVE_B, STEPS),
                          generator=gen, dtype=torch.int32)
    return batch, steps


def moe_pad_input(cfg, seed: int = 2):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((MOE_B, MOE_S, cfg.d_model), generator=gen)


def _serve(cfg, mesh, reduction: str, kv_dtype: str = "bfloat16",
           cim: bool = False):
    """This rank's (prefill logits, decode logits...), its MoE layers'
    dropped pairs, and its coordinates.  ``cim``: int8 weights, the
    global params quantized and then sharded."""
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.convert import shard_lm_params
    from repro_torch.models import moe as moe_mod
    from repro_torch.runtime.serve_loop import build_serve_program

    prog = build_serve_program(cfg, SERVE_B, S_MAX, kv_dtype=kv_dtype,
                               cim_weights=cim, quant_min_size=1,
                               device="cpu", mesh=mesh,
                               pcfg=ParallelConfig(reduction=reduction))
    params = shard_lm_params(prog.serving_params(global_params(cfg)),
                             prog.param_specs, mesh.coords_dict())
    batch, steps = serve_inputs(cfg)
    batch = prog.shard_batch(batch)
    steps = prog.shard_batch({"t": steps})["t"]
    real, drops = moe_mod.moe_forward, [0]

    def counted(p, x, c, plan):
        drops[0] += moe_mod.dropped_pairs(p, x, c, plan)[0]
        return real(p, x, c, plan)

    moe_mod.moe_forward = counted
    try:
        logits, caches = prog.prefill_fn(params, batch)
        out = [logits]
        for i in range(STEPS):
            logits, caches = prog.decode_fn(params, steps[:, i], caches,
                                            PROMPT + i)
            out.append(logits)
    finally:
        moe_mod.moe_forward = real
    return {"coords": mesh.coords, "logits": out, "drops": drops[0]}


def _moe_pad(mesh):
    """The padded, dropping MoE block on this rank's token chunk."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.common import ShardingPlan
    from repro_torch.runtime import partition

    cfg = port_config("granite-moe-3b-a800m", "moe_pad")
    plan = ShardingPlan.for_model(cfg, MOE_PAD_TP, axis=mesh.model)
    specs = partition.derive_specs(
        moe_mod.init_moe(partition.META, cfg, plan.as_global(),
                         torch.float32),
        moe_mod.init_moe(partition.META, cfg, plan, torch.float32),
        plan.tp)
    gen = torch.Generator().manual_seed(3)
    full = moe_mod.init_moe(gen, cfg, ShardingPlan(
        tp=1, experts_pad=plan.experts_pad), torch.float32)
    p = partition.shard_tree(full, specs, mesh.coords_dict())
    x = moe_pad_input(cfg)
    chunk = MOE_S // MOE_PAD_TP
    i = mesh.model.index
    xl = x[:, i * chunk:(i + 1) * chunk].contiguous()
    out, aux = moe_mod.moe_forward(p, xl, cfg, plan)
    drops, cap = moe_mod.dropped_pairs(p, xl, cfg, plan)
    return {"out": out, "aux": aux, "drops": drops, "cap": cap,
            "experts_pad": plan.experts_pad}


#: the serve cell each rank of the (2, 2) ring mesh also counts under
#: ``OpStats``: its prefill's flops and wire bytes against the dry run's
COUNTED_SERVE_ARCH = "granite-moe-3b-a800m"


def _counted(run, resident):
    """``run()`` counted: this rank's flops (all, and by the dtype of
    their peak), HBM bytes, wire bytes and the ops' counts."""
    import torch.distributed as dist

    from repro_torch.analysis.op_stats import OpStats

    with OpStats(resident=resident) as st:
        run()
    return {"rank": dist.get_rank(), "flops": st.flops,
            "flops_by_dtype": dict(st.flops_by_dtype),
            "hbm_bytes": st.hbm_bytes, "wire_bytes": st.wire_bytes,
            "op_counts": dict(st.op_counts)}


def _counted_prefill(cfg, mesh, reduction: str):
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.convert import shard_lm_params
    from repro_torch.runtime.serve_loop import build_serve_program

    prog = build_serve_program(cfg, SERVE_B, S_MAX, device="cpu", mesh=mesh,
                               pcfg=ParallelConfig(reduction=reduction))
    params = shard_lm_params(global_params(cfg), prog.param_specs,
                             mesh.coords_dict())
    batch = prog.shard_batch(serve_inputs(cfg)[0])
    return _counted(lambda: prog.prefill_fn(params, batch), (params, batch))


def serve_cases(rank: int, world: int):
    """The families on each mesh of ``MESHES``, then at tp = 4 the
    sequence-sharded cache (bf16 and int8 KV) and the padded MoE block.
    -> {case: this rank's result}."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh

    torch.set_num_threads(1)  # four ranks share the host's cores
    meshes = {name: make_mesh(*shape, backend="gloo", ranks=ranks)
              for name, (shape, ranks, _) in MESHES.items()}
    out = {}
    with torch.no_grad():
        for name, (_, _, reduction) in MESHES.items():
            mesh = meshes[name]
            if mesh is None:
                continue
            for arch in FAMILIES:
                out[(arch, name)] = _serve(port_config(arch), mesh,
                                           reduction)
            for arch in CIM_FAMILIES.get(name, ()):
                out[(arch, name, "cim")] = _serve(
                    port_config(arch), mesh, reduction, "int8", cim=True)
            if name == DROP_MESH:
                out[("moe_drop", name)] = _serve(
                    port_config("granite-moe-3b-a800m", "moe_drop"), mesh,
                    reduction)
            if name == "2x2-ring":
                out[("counted", name)] = _counted_prefill(
                    port_config(COUNTED_SERVE_ARCH), mesh, reduction)
        dist.barrier()
        mesh4 = make_mesh(1, 4, backend="gloo")
        for kv in ("bfloat16", "int8"):
            out[("seq_cache", kv)] = _serve(
                port_config("qwen2-0.5b", "seq_cache"), mesh4, "ring", kv)
        out["moe_pad"] = _moe_pad(mesh4)
    return out


# ---------------------------------------------------------------------------
# On the card (test_torch_tp_cuda.py): two gloo ranks share cuda:0
# ---------------------------------------------------------------------------


def cuda_ring_cases(rank: int, world: int):
    """The ring matmuls on cuda:0 over a gloo (1, 2) mesh with host
    copies, in float32 and in bfloat16: -> ({case: (coords, output on
    the CPU)}, {case: the same in bfloat16}), and the rank's traffic
    counters of the float32 calls."""
    from repro_torch.core import dataflow as df
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh(1, world, backend="gloo", host_copies=True)
    k, m = world, mesh.coords[1]
    outs, traffic = [], None
    for dtype in (torch.float32, torch.bfloat16):
        x, w = (torch.from_numpy(a).cuda().to(dtype)
                for a in dataflow_inputs()[:2])
        df.reset_traffic()
        out = {}
        for fn_name in DATAFLOW_FNS:
            if fn_name in DOWN:
                kk = K // k
                xl, wl = x[:, :, m * kk:(m + 1) * kk], w[m * kk:(m + 1) * kk]
            else:
                ss, nn = S // k, N // k
                xl, wl = x[:, m * ss:(m + 1) * ss], w[:, m * nn:(m + 1) * nn]
            y = _dataflow_call(fn_name, xl.contiguous(), wl.contiguous(),
                               mesh.model, None)
            assert y.is_cuda and y.dtype == dtype
            out[fn_name] = (mesh.coords, y.float().cpu())
        outs.append(out)
        traffic = traffic or dict(df.TRAFFIC)
    return outs[0], outs[1], traffic


def cuda_without_host_copies(rank: int, world: int):
    """A CUDA tensor on a gloo mesh built without host copies: the
    collective must raise, not fall back.  -> the error's text."""
    from repro_torch.core import dataflow as df
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh(1, world, backend="gloo")
    try:
        df.psum(torch.ones(4, device="cuda"), mesh.model)
    except RuntimeError as e:
        return str(e)
    return None


def cuda_failing_rank(rank: int, world: int):
    """Rank 1 raises after touching the card; rank 0 waits for it in a
    collective over host copies."""
    from repro_torch.core import dataflow as df
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh(1, world, backend="gloo", host_copies=True)
    x = torch.ones(4, device="cuda")
    if rank == 1:
        raise ValueError("rank 1 fails on the card on purpose")
    return df.psum(x, mesh.model).cpu()


# ---------------------------------------------------------------------------
# Gradients of the collectives and of the dataflow matmuls
# ---------------------------------------------------------------------------

#: the collectives differentiated, on x (B, S, K) split over the model
#: axis on its sequence dim: (name, whether the output is whole on every
#: model rank, the output's split dim or None)
COLLECTIVES = (("ppermute", False, 1), ("psum", True, None),
               ("all_gather", True, None), ("all_to_all", False, 2),
               ("psum_scatter", False, 2))


def grad_cotangents(seed: int = 1):
    """Fixed global cotangents of every case's output, drawn in the
    output's global shape."""
    rng = np.random.default_rng(seed)
    out = {"down": rng.standard_normal((B, S, N)).astype(np.float32),
           "up": rng.standard_normal((B, S, N)).astype(np.float32)}
    for k in (2, 4):
        out[f"ppermute-k{k}"] = rng.standard_normal((B, S, K)).astype(
            np.float32)
        out[f"psum-k{k}"] = rng.standard_normal((B, S // k, K)).astype(
            np.float32)
        out[f"all_gather-k{k}"] = rng.standard_normal((B, S, K)).astype(
            np.float32)
        out[f"all_to_all-k{k}"] = rng.standard_normal((B, S, K)).astype(
            np.float32)
        out[f"psum_scatter-k{k}"] = rng.standard_normal(
            (B, S // k, K)).astype(np.float32)
    return out


def collective_call(name, x, axis):
    """The port's collective of one case."""
    from repro_torch.core import dataflow as df

    if name == "ppermute":
        return df.ppermute(x, axis, 1)
    if name == "psum":
        return df.psum(x, axis)
    if name == "all_gather":
        return df.all_gather(x, axis, 1)
    if name == "all_to_all":
        return df.all_to_all(x, axis, 2, 1)
    return df.psum_scatter(x, axis, 2)


def grad_case_names():
    names = [f"{fn}-k{k}-{'tanh' if tail else 'none'}"
             for k in (2, 4) for fn in DATAFLOW_FNS for tail in (False, True)]
    return names + [f"{c[0]}-k{k}" for k in (2, 4) for c in COLLECTIVES]


def dataflow_grad_cases(rank: int, world: int):
    """The gradients with respect to x and w of each dataflow matmul and
    of each collective, at k = 2 on a (2, 2) mesh (the data axis splits
    the batch) and k = 4 on (1, 4): this rank's local objective is its
    output against its part of the global cotangent, seeded with 1 over
    the model ranks that hold the same output (the reference's gradient
    of an output whole on every model rank is that of one copy).  ->
    {case: (coords, dx, dw)}, dw None for a collective."""
    from repro_torch.launch.mesh import make_mesh

    torch.set_num_threads(1)
    xg, wg = (torch.from_numpy(a) for a in dataflow_inputs()[:2])
    cts = {k: torch.from_numpy(v) for k, v in grad_cotangents().items()}
    out = {}
    for k, shape in ((2, (2, 2)), (4, (1, 4))):
        mesh = make_mesh(*shape, backend="gloo")
        d, m = mesh.coords
        rb = B // shape[0]
        rows = slice(d * rb, (d + 1) * rb)
        ss, nn, kk = S // k, N // k, K // k
        for fn_name in DATAFLOW_FNS:
            for tail in (None, torch.tanh):
                if fn_name in DOWN:
                    xl = xg[rows, :, m * kk:(m + 1) * kk]
                    wl = wg[m * kk:(m + 1) * kk]
                    ct = cts["down"][rows, m * ss:(m + 1) * ss]
                else:
                    xl = xg[rows, m * ss:(m + 1) * ss]
                    wl = wg[:, m * nn:(m + 1) * nn]
                    ct = cts["up"][rows, :, m * nn:(m + 1) * nn]
                xl = xl.contiguous().requires_grad_()
                wl = wl.contiguous().requires_grad_()
                y = _dataflow_call(fn_name, xl, wl, mesh.model, tail)
                dx, dw = torch.autograd.grad(torch.sum(y * ct), (xl, wl))
                name = (f"{fn_name}-k{k}-"
                        f"{'tanh' if tail is not None else 'none'}")
                out[name] = (mesh.coords, dx, dw)
        x3 = torch.from_numpy(np.random.default_rng(2).standard_normal(
            (B, S, K)).astype(np.float32))
        for name, whole, dim in COLLECTIVES:
            xl = x3[rows, m * ss:(m + 1) * ss].contiguous().requires_grad_()
            y = collective_call(name, xl, mesh.model)
            ct = cts[f"{name}-k{k}"][rows]
            if dim is not None:
                size = ct.shape[dim] // k
                ct = ct.narrow(dim, m * size, size)
            seed = 1.0 / k if whole else 1.0
            dx, = torch.autograd.grad(torch.sum(y * ct) * seed, (xl,))
            out[f"{name}-k{k}"] = (mesh.coords, dx, None)
    return out


# ---------------------------------------------------------------------------
# Training at tp > 1
# ---------------------------------------------------------------------------

#: global batch and sequence of the training cases (the sequence
#: divides 4); the last TRAIN_MASKED labels of every row are -1, so
#: every data shard counts the same positions
TRAIN_B, TRAIN_S, TRAIN_MASKED = 4, 16, 3
TRAIN_SEED = 3
#: the one-step optimizer cases on (2, 2): (optimizer, compression,
#: microbatches); gemma3's reduced config, grad_clip 0.5 (the gradient
#: norm is about 2.6, so the clip binds)
STEP_CASES = tuple((o, c, n) for o in ("adamw", "adafactor", "sgd")
                   for c, n in ((False, 1), (True, 1), (False, 2)))
STEP_ARCH = "gemma3-1b"
STEP_TCFG = dict(lr=1e-2, warmup_steps=1, total_steps=5, grad_clip=0.5)
#: ZeRO-3 on (2, 2): every QUANTIZABLE leaf the data axis divides, on
#: gemma3 (no stacked leaf) and granite (one segment of count 2: the
#: gather dim of a stacked leaf counts from its second dim)
ZERO3_MIN_SIZE = 1
ZERO3_ARCHS = ("gemma3-1b", "granite-moe-3b-a800m")


def train_config(arch: str, var: str = None, aux: bool = False):
    """A family's reduced float32 config for training; the MoE aux loss
    off unless ``aux`` (it is per rank over its own tokens, so it
    differs from tp = 1's), as the reference's own sharded test."""
    cfg = port_config(arch, var)
    if cfg.moe is not None and not aux:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, aux_loss_coef=0.0))
    return cfg


def train_batch(cfg):
    """The global batch (numpy): ``synthetic_batch`` seed 5, step 0, the
    last TRAIN_MASKED labels of every row -1."""
    from repro_torch.data.pipeline import DataSpec, synthetic_batch

    fe = cfg.frontend
    kw = {} if fe is None else dict(frontend_kind=fe.kind,
                                    frontend_dim=fe.embed_dim,
                                    frontend_tokens=fe.num_tokens)
    batch = synthetic_batch(DataSpec(cfg.vocab_size, TRAIN_S, TRAIN_B, 5,
                                     encdec=cfg.is_encdec, **kw), 0)
    batch["labels"][:, -TRAIN_MASKED:] = -1
    return batch


def _tensors(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _train_prog(cfg, mesh, reduction="ring", tcfg=None, **pkw):
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.runtime.train_loop import build_train_program

    return build_train_program(
        cfg, ParallelConfig(reduction=reduction, remat="full", **pkw),
        tcfg or TrainConfig(), device="cpu", mesh=mesh)


def _gathered_grads(prog, grads):
    from repro_torch.runtime import partition
    from repro_torch.tree import tree_map

    return tree_map(lambda g, lay: partition.gather_leaf(
        g, lay.zspec, prog.mesh), grads, prog.layouts)


def _grads_case(cfg, mesh, reduction="ring", **pkw):
    """(this rank's loss, the global gradients (None off the mesh's
    first rank)) of one family's first step."""
    prog = _train_prog(cfg, mesh, reduction, **pkw)
    params, _ = prog.init_fn(TRAIN_SEED)
    loss, grads = prog.grad_fn(params,
                               prog.shard_batch(_tensors(train_batch(cfg))))
    full = _gathered_grads(prog, grads)
    return {"coords": mesh.coords, "loss": loss,
            "grads": full if mesh.rank_index == 0 else None}


def _local_shapes(tree):
    from repro_torch.tree import leaves_with_paths

    return {p: tuple(t.shape) for p, t in leaves_with_paths(tree)}


def _step_case(mesh, optimizer, compression, micro):
    from repro_torch.configs.base import TrainConfig
    from repro_torch.convert import gather_train_state

    cfg = train_config(STEP_ARCH)
    prog = _train_prog(cfg, mesh, tcfg=TrainConfig(optimizer=optimizer,
                                                   **STEP_TCFG),
                       grad_compression=compression, microbatches=micro)
    params, state = prog.init_fn(TRAIN_SEED)
    new_p, new_s, metrics = prog.step_fn(
        params, state, prog.shard_batch(_tensors(train_batch(cfg))))
    gp, gs = gather_train_state(prog, new_p, new_s)
    return {"coords": mesh.coords, "loss": metrics["loss"],
            "grad_norm": metrics["grad_norm"],
            "state_shapes": _local_shapes(new_s),
            "param_shapes": _local_shapes(new_p),
            "params": gp if mesh.rank_index == 0 else None,
            "state": gs if mesh.rank_index == 0 else None}


def _zero3_case(mesh, arch):
    """The baseline and ZeRO-3 from one init on (2, 2): each one's loss,
    global reduced gradients, and params and state after one AdamW
    step; this rank's params' local shapes."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.convert import gather_train_state

    cfg = train_config(arch)
    batch = _tensors(train_batch(cfg))
    out = {"coords": mesh.coords}
    for name, z3 in (("base", False), ("zero3", True)):
        prog = _train_prog(cfg, mesh, tcfg=TrainConfig(**STEP_TCFG),
                           zero3=z3, zero3_min_size=ZERO3_MIN_SIZE)
        params, state = prog.init_fn(TRAIN_SEED)
        b = prog.shard_batch(batch)
        loss, grads = prog.grad_fn(params, b)
        full = _gathered_grads(prog, grads)
        new_p, new_s, _ = prog.step_fn(params, state, b)
        gp, gs = gather_train_state(prog, new_p, new_s)
        out[name] = {"loss": loss, "grads": full, "params": gp,
                     "state": gs, "zero3": dict(prog.zero3),
                     "shapes": _local_shapes(params)}
    return out


def _elastic_case(rank, tmp):
    """A checkpoint of the (2, 2) mesh's state after one AdamW step,
    restored onto the mesh ``elastic_remesh`` builds from ranks 0 and 1;
    the next step there against the uninterrupted (2, 2) run's."""
    import torch.distributed as dist

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.base import TrainConfig
    from repro_torch.convert import gather_train_state
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.fault import elastic_remesh

    cfg = train_config(STEP_ARCH)
    batch = _tensors(train_batch(cfg))
    tcfg = TrainConfig(**STEP_TCFG)
    mesh = make_mesh(2, 2, backend="gloo")
    prog = _train_prog(cfg, mesh, tcfg=tcfg)
    params, state = prog.init_fn(TRAIN_SEED)
    b = prog.shard_batch(batch)
    params, state, _ = prog.step_fn(params, state, b)
    gp, gs = gather_train_state(prog, params, state)
    mgr = CheckpointManager(tmp)
    if rank == 0:
        mgr.save(1, {"params": gp, "opt_state": gs}, blocking=True)
    params, state, _ = prog.step_fn(params, state, b)
    want = gather_train_state(prog, params, state)[0]
    dist.barrier()
    small, dropped = elastic_remesh([0, 1], model_parallelism=2)
    if small is None:
        return {"dropped": dropped}
    prog2 = _train_prog(cfg, small, tcfg=tcfg)
    p2, s2 = prog2.init_fn(TRAIN_SEED + 1)
    restored, step = mgr.restore(
        {"params": p2, "opt_state": s2},
        specs={"opt_state": prog2.opt_specs, "params": prog2.param_specs},
        coords=small.coords_dict())
    p2, s2, _ = prog2.step_fn(restored["params"], restored["opt_state"],
                              prog2.shard_batch(batch))
    got = gather_train_state(prog2, p2, s2)[0]
    return {"dropped": dropped, "shape": small.shape, "step": step,
            "got": got if rank == 0 else None,
            "want": want if rank == 0 else None}


def _serve_dp_only(mesh):
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.convert import shard_lm_params
    from repro_torch.runtime.serve_loop import build_serve_program

    cfg = port_config(DP_ONLY_SERVE_ARCH)
    prog = build_serve_program(cfg, SERVE_B, S_MAX, device="cpu", mesh=mesh,
                               pcfg=ParallelConfig(dp_only=True))
    params = shard_lm_params(global_params(cfg), prog.param_specs,
                             mesh.coords_dict())
    batch, _ = serve_inputs(cfg)
    with torch.no_grad():
        logits, _ = prog.prefill_fn(params, prog.shard_batch(batch))
    return {"coords": mesh.coords, "logits": logits, "tp": prog.plan.tp,
            "rows": prog.batch_local, "seq_cache": prog.plan.seq_cache}


#: the family served with dp_only on (2, 2)
DP_ONLY_SERVE_ARCH = "qwen2-0.5b"


def _counted_step(mesh):
    """One AdamW step of STEP_ARCH on ``mesh``, counted."""
    from repro_torch.configs.base import TrainConfig

    cfg = train_config(STEP_ARCH)
    prog = _train_prog(cfg, mesh, tcfg=TrainConfig(**STEP_TCFG))
    params, state = prog.init_fn(TRAIN_SEED)
    b = prog.shard_batch(_tensors(train_batch(cfg)))
    return _counted(lambda: prog.step_fn(params, state, b),
                    (params, state, b))


def train_cases(rank: int, world: int, tmp: str):
    """Every family's first-step loss and gradients on each mesh of
    ``MESHES``; granite with pairs dropped and its aux loss on (1, 2);
    then on (2, 2) the optimizer steps, ZeRO-3 against the baseline,
    dp_only's gradients and serving, the elastic restore; at tp = 4
    qwen2's H = 6 variant (replicated attention).  -> {case: result}."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    torch.set_num_threads(1)
    meshes = {name: make_mesh(*shape, backend="gloo", ranks=ranks)
              for name, (shape, ranks, _) in MESHES.items()}
    out = {}
    for name, (_, _, reduction) in MESHES.items():
        mesh = meshes[name]
        if mesh is None:
            continue
        for arch in FAMILIES:
            out[(arch, name)] = _grads_case(train_config(arch), mesh,
                                            reduction)
        if name == DROP_MESH:
            out[("moe_drop_aux", name)] = _grads_case(
                train_config("granite-moe-3b-a800m", "moe_drop", aux=True),
                mesh, reduction)
    dist.barrier()
    mesh = meshes["2x2-ring"]
    out["counted"] = _counted_step(mesh)
    for case in STEP_CASES:
        out[("step",) + case] = _step_case(mesh, *case)
    for arch in ZERO3_ARCHS:
        out[("zero3", arch)] = _zero3_case(mesh, arch)
    out["dp_only"] = _grads_case(train_config(STEP_ARCH), mesh,
                                 dp_only=True)
    out["serve_dp_only"] = _serve_dp_only(mesh)
    dist.barrier()
    mesh4 = make_mesh(1, 4, backend="gloo")
    out["seq_cache"] = _grads_case(train_config("qwen2-0.5b", "seq_cache"),
                                   mesh4)
    dist.barrier()
    out["elastic"] = _elastic_case(rank, tmp)
    return out
