"""Port parity: ``repro_torch/core/dataflow.py`` on gloo CPU ranks
against the reference's ``repro/core/dataflow.py`` under ``shard_map``.

The four matmuls and the ``up_matmul`` / ``down_matmul`` dispatchers at
k = 2 and 4 model ranks, each with a tail (tanh, on the last hop) and
without, and ``lse_merge_decode_attention`` with shards that hold no
valid slot (5 of 16 cache positions are filled).  The port's ranks come
from one spawn of 4 gloo processes (``tests/torch_tp_ranks.py``): k = 2
on a (2, 2) mesh, whose data axis splits the batch, and k = 4 on a
(1, 4) mesh.  The reference runs on 8 virtual CPU devices in a
subprocess, because ``--xla_force_host_platform_device_count`` must be
set before jax starts and a test worker may have started it already.
Both sides read the same numpy inputs; each rank's output is placed
into the global array its spec says, and the global arrays compared.

The gradients: each matmul's (with and without its tail) and each
collective's (``ppermute``, ``psum``, ``all_gather``, ``all_to_all``,
``psum_scatter``) with respect to x and w, at k = 2 and 4, against the
reference's ``jax.grad`` of the same function under ``shard_map``
against a fixed cotangent of its global output.  Each rank seeds its
objective with 1 over the model ranks that hold the same output (the
reference differentiates one copy of an output whole on every device);
a weight's gradient is summed over the data ranks that hold it.

Tolerance: 2e-5 absolute, float32 (the reference's own
``tests/test_dataflow.py``): both sides sum the same partial products
in orders that may differ.  The gradients: rtol = atol = 1e-5.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_tp_ranks as R  # noqa: E402
from repro_torch.core import dataflow  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
TOL = 2e-5

REFERENCE = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
sys.path.insert(0, sys.argv[2])
import torch_tp_ranks as R
from repro.compat import shard_map
from repro.core import dataflow as df

x, w, q, kc, vc, valid = R.dataflow_inputs()
out = {}
for k in (2, 4):
    mesh = Mesh(np.array(jax.devices()[:k]).reshape(1, k), ("data", "model"))
    for name in R.DATAFLOW_FNS:
        for tail in (None, jnp.tanh):
            if name.startswith(("up_", "down_")):
                kind, red = name.split("_")
                fn = df.up_matmul if kind == "up" else df.down_matmul
                call = lambda a, b, fn=fn, red=red, tail=tail: fn(
                    a, b, axis="model", reduction=red, tail=tail)
            else:
                call = lambda a, b, fn=getattr(df, name), tail=tail: fn(
                    a, b, axis="model", tail=tail)
            if name in R.DOWN:
                specs = (P(None, None, "model"), P("model", None))
                out_spec = P(None, "model", None)
            else:
                specs = (P(None, "model", None), P(None, "model"))
                out_spec = P(None, None, "model")
            f = jax.jit(shard_map(call, mesh=mesh, in_specs=specs,
                                  out_specs=out_spec))
            key = f"{name}-k{k}-{'tanh' if tail is not None else 'none'}"
            out[key] = np.asarray(f(x, w))
    f = jax.jit(shard_map(
        lambda a, b, c, d: df.lse_merge_decode_attention(a, b, c, d,
                                                         axis="model"),
        mesh=mesh, in_specs=(P(), P(None, None, "model", None),
                             P(None, None, "model", None), P(None, "model")),
        out_specs=P()))
    out[f"lse_merge-k{k}"] = np.asarray(f(q, kc, vc, valid))
    # gradients against fixed cotangents of the global outputs
    cts = R.grad_cotangents()
    for name in R.DATAFLOW_FNS:
        for tail in (None, jnp.tanh):
            if name.startswith(("up_", "down_")):
                kind, red = name.split("_")
                fn = df.up_matmul if kind == "up" else df.down_matmul
                call = lambda a, b, fn=fn, red=red, tail=tail: fn(
                    a, b, axis="model", reduction=red, tail=tail)
            else:
                call = lambda a, b, fn=getattr(df, name), tail=tail: fn(
                    a, b, axis="model", tail=tail)
            if name in R.DOWN:
                specs = (P(None, None, "model"), P("model", None))
                out_spec, ct = P(None, "model", None), cts["down"]
            else:
                specs = (P(None, "model", None), P(None, "model"))
                out_spec, ct = P(None, None, "model"), cts["up"]
            f = shard_map(call, mesh=mesh, in_specs=specs,
                          out_specs=out_spec)
            gx, gw = jax.jit(jax.grad(
                lambda a, b, f=f, ct=ct: jnp.sum(f(a, b) * ct),
                argnums=(0, 1)))(x, w)
            key = f"grad-{name}-k{k}-{'tanh' if tail is not None else 'none'}"
            out[key + "-x"], out[key + "-w"] = np.asarray(gx), np.asarray(gw)
    perm = [(j, (j + 1) % k) for j in range(k)]
    colls = {
        "ppermute": (lambda a: lax.ppermute(a, "model", perm),
                     P(None, "model", None)),
        "psum": (lambda a: lax.psum(a, "model"), P()),
        "all_gather": (lambda a: lax.all_gather(a, "model", axis=1,
                                                tiled=True), P()),
        "all_to_all": (lambda a: lax.all_to_all(a, "model", 2, 1,
                                                tiled=True),
                       P(None, None, "model")),
        "psum_scatter": (lambda a: lax.psum_scatter(
            a, "model", scatter_dimension=2, tiled=True),
            P(None, None, "model")),
    }
    x3 = np.random.default_rng(2).standard_normal(
        (R.B, R.S, R.K)).astype(np.float32)
    for name, (fn, out_spec) in colls.items():
        f = shard_map(fn, mesh=mesh, in_specs=(P(None, "model", None),),
                      out_specs=out_spec)
        ct = cts[f"{name}-k{k}"]
        gx = jax.jit(jax.grad(lambda a, f=f, ct=ct: jnp.sum(f(a) * ct)))(x3)
        out[f"grad-{name}-k{k}-x"] = np.asarray(gx)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("dataflow_ref") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.run(
        [sys.executable, "-c", REFERENCE, str(path), str(ROOT / "tests")],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(path) as f:
        return dict(f)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn(R.dataflow_cases, 4,
                 tmp_dir=str(tmp_path_factory.mktemp("dataflow_ranks")))


def _assemble(ranks, case):
    """The global array of one case from its ranks' outputs: rows by
    data coordinate; a down product's sequence chunks and an up
    product's column slices by model coordinate; the merged attention
    whole on every model rank."""
    parts = {}
    for res in ranks:
        coords, out = res[case]
        parts[coords] = out.numpy()
    n_data = 1 + max(d for d, _ in parts)
    n_model = 1 + max(m for _, m in parts)
    fn = case.split("-")[0]
    rows = []
    for d in range(n_data):
        if fn == "lse_merge":
            for m in range(1, n_model):
                np.testing.assert_array_equal(parts[(d, m)], parts[(d, 0)])
            rows.append(parts[(d, 0)])
        else:
            axis = 1 if fn in R.DOWN else 2
            rows.append(np.concatenate(
                [parts[(d, m)] for m in range(n_model)], axis=axis))
    return np.concatenate(rows, axis=0)


@pytest.mark.parametrize("case", R.dataflow_case_names())
def test_matches_reference_under_shard_map(case, ranks, reference):
    got = _assemble(ranks, case)
    want = reference[case]
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL, err_msg=case)


@pytest.mark.parametrize("case", [c for c in R.dataflow_case_names()
                                  if not c.startswith("lse")])
def test_matches_dense_product(case, ranks):
    """And the product itself: the dense float64 oracle ``tail(x @ w)``."""
    x, w = R.dataflow_inputs()[:2]
    want = x.astype(np.float64) @ w.astype(np.float64)
    if case.endswith("tanh"):
        want = np.tanh(want)
    np.testing.assert_allclose(_assemble(ranks, case), want, rtol=0,
                               atol=TOL, err_msg=case)


def test_lse_merge_matches_dense_attention(ranks):
    """Shards with no valid slot contribute nothing: the merge equals a
    softmax over the filled slots alone."""
    _, _, q, kc, vc, valid = R.dataflow_inputs()
    n = R.VALID
    s = np.einsum("bhd,bhsd->bhs", q, kc[:, :, :n]) * R.D ** -0.5
    p = np.exp(s - s.max(-1, keepdims=True))
    want = np.einsum("bhs,bhsd->bhd", p / p.sum(-1, keepdims=True),
                     vc[:, :, :n])
    for k in (2, 4):
        np.testing.assert_allclose(_assemble(ranks, f"lse_merge-k{k}"), want,
                                   rtol=0, atol=TOL)


def test_identity_on_one_rank():
    """On an axis of size 1 every collective is the identity and no
    traffic is counted."""
    from repro_torch.launch.mesh import MeshAxis

    axis = MeshAxis("model", 1, 0, (0,), "gloo", False)
    x = torch.randn(2, 4, 3)
    dataflow.reset_traffic()
    assert dataflow.ppermute(x, axis, 1) is x
    assert dataflow.psum(x, axis) is x
    assert dataflow.all_gather(x, axis, 1) is x
    assert dataflow.all_to_all(x, axis, 0, 1) is x
    assert dataflow.TRAFFIC == {"collectives": 0, "bytes_sent": 0,
                                "host_copies": 0, "ops": {}, "op_bytes": {},
                                "operand_bytes": 0}


def test_a_failing_rank_fails_the_spawn(tmp_path):
    """A rank that raises fails the whole run: the other rank, waiting
    in a collective, is stopped, and the caller sees the error."""
    from repro_torch.launch.mesh import SpawnError

    with pytest.raises(SpawnError, match="on purpose") as err:
        spawn(R.failing_rank, 2, tmp_dir=str(tmp_path), timeout_s=60)
    assert next(iter(err.value.errors)) == 1  # the failing rank first


def test_bf16_products_reach_the_sums_in_float32():
    """bfloat16 operands give float32 products, unrounded, as the
    reference's ``preferred_element_type=float32``: the ring's partial
    sums add them in float32 and only the finished sum is rounded."""
    from repro_torch.launch.mesh import MeshAxis

    x, w = (torch.from_numpy(a).to(torch.bfloat16)
            for a in R.dataflow_inputs()[:2])
    exact = x.double() @ w.double()
    y = dataflow._mm(x, w)
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.double().numpy(), exact.numpy(), rtol=0,
                               atol=1e-5)
    axis = MeshAxis("model", 1, 0, (0,), "gloo", False)
    out = dataflow.ring_reducescatter_matmul(x, w, axis)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, y.to(torch.bfloat16))


def _assemble_grad(ranks, case):
    """(dx, dw) global gradients of one case from its ranks: dx placed by
    the input's split (rows by data coordinate; the contraction dim of a
    down product's x, the sequence of an up product's or a collective's
    by model coordinate), dw by the weight's model split and summed over
    the data coordinates that hold it."""
    parts = {}
    for res in ranks:
        coords, dx, dw = res["grads"][case]
        parts[coords] = (dx.numpy(), None if dw is None else dw.numpy())
    n_data = 1 + max(d for d, _ in parts)
    n_model = 1 + max(m for _, m in parts)
    fn = case.rsplit("-", 2)[0] if case.count("-") == 2 else \
        case.split("-")[0]
    x_dim, w_dim = (2, 0) if fn in R.DOWN else (1, 1)
    dx = np.concatenate([np.concatenate(
        [parts[(d, m)][0] for m in range(n_model)], axis=x_dim)
        for d in range(n_data)], axis=0)
    if parts[(0, 0)][1] is None:
        return dx, None
    dw = sum(np.concatenate([parts[(d, m)][1] for m in range(n_model)],
                            axis=w_dim) for d in range(n_data))
    return dx, dw


@pytest.mark.parametrize("case", R.grad_case_names())
def test_gradients_match_reference_under_shard_map(case, ranks, reference):
    """The transposes: a ring's backward is the transposed ring, psum's
    is psum, an all-gather's a reduce-scatter and back, an all_to_all's
    the all_to_all with its dims swapped, ppermute's the permutation
    back."""
    dx, dw = _assemble_grad(ranks, case)
    np.testing.assert_allclose(dx, reference[f"grad-{case}-x"], rtol=1e-5,
                               atol=1e-5, err_msg=case)
    if dw is not None:
        np.testing.assert_allclose(dw, reference[f"grad-{case}-w"],
                                   rtol=1e-5, atol=1e-5, err_msg=case)
