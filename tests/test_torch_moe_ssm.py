"""Port parity: the MoE block, the Mamba block and the selective scan of
the port against the JAX reference at tp = 1, float32, on the CPU (the
scan kernel's plain version runs on CPU tensors).

What the LM parity tests (``test_torch_lm.py``) cannot reach:

* MoE token dropping.  The reduced configs set the capacity factor to
  4.0, so no (token, k) pair drops there.  Here the factor is 1.0 on
  the reduced granite, and the published 40 experts top-8 run with
  t = 4 tokens, where the capacity is 1 (granite's decode at batch 4);
  shared experts (deepseek-v3's) on the reduced granite.
* granite's GQA group of 3: the reduced config turns 24 / 8 heads into
  4 / 1; a variant with 6 / 2 keeps the group.
* the Mamba block at the published d_state 16 / d_conv 4 on a narrow
  width, also with int8 x_proj / dt_proj leaves (which the reference
  dequantizes through bfloat16, with no ``like``).
* the scan against the reference's associative scan, and the caches
  that ``convert`` carries across for stacked mamba segments.
* the gradients: the scan's plain backward, the Mamba block's and the
  MoE block's (with and without dropped pairs, the aux loss's included)
  against ``jax.vjp`` of the reference's.

Tolerances: rtol = atol = 1e-4 for block outputs and logits (both sides
sum in other orders, in float32); 1e-5 for the scan alone (the
associative scan multiplies decays in another order).  Gradients: each
within its tolerance times its largest |reference value| (TOL_SCAN_GRAD
for the scan's seven, TOL for the blocks' leaves).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import moe as RM  # noqa: E402
from repro.models import ssm as RS  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.models.common import ShardingPlan as RefPlan  # noqa: E402
from repro.runtime.serve_loop import (  # noqa: E402
    quantize_params_for_serving as ref_quantize,
)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    lm_caches_from_reference,
    lm_params_from_reference,
)
from repro_torch.kernels.selective_scan import (  # noqa: E402
    selective_scan,
    selective_scan_bwd_plain,
    selective_scan_plain,
)
from repro_torch.models import moe as PM  # noqa: E402
from repro_torch.models import ssm as PS  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.common import ShardingPlan  # noqa: E402
from repro_torch.runtime.serve_loop import build_serve_program  # noqa: E402

TOL = 1e-4
TOL_SCAN = 1e-5
TOL_SCAN_GRAD = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


def _tree_t(tree):
    if isinstance(tree, dict):
        return {k: _tree_t(v) for k, v in tree.items()}
    return _t(tree)


def _both(replace_fn, arch="granite-moe-3b-a800m"):
    """(reference config, port config), each reduced and then edited by
    ``replace_fn`` (the same edit on both)."""
    return (replace_fn(ref_config(arch).reduced()),
            replace_fn(get_config(arch).reduced()))


def _moe_cfg(cfg, **moe):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

#: (name, config edit, tokens (B, S)): dropping at capacity factor 1.0;
#: the published 40 experts top-8 at t = 4 (cap = 1); shared experts;
#: plain (non-gated) experts
MOE_CASES = [
    ("cf1", lambda c: _moe_cfg(c, capacity_factor=1.0), (2, 12)),
    ("cf1-t1", lambda c: _moe_cfg(c, capacity_factor=1.0), (1, 1)),
    ("40e-top8-t4", lambda c: _moe_cfg(
        c, num_experts=40, top_k=8, d_ff_expert=32, capacity_factor=1.25),
     (4, 1)),
    ("40e-top8-prefill", lambda c: _moe_cfg(
        c, num_experts=40, top_k=8, d_ff_expert=32, capacity_factor=1.25),
     (2, 16)),
    ("shared", lambda c: _moe_cfg(c, num_shared_experts=2,
                                  capacity_factor=1.0), (2, 12)),
    ("relu2", lambda c: dataclasses.replace(
        _moe_cfg(c, capacity_factor=1.0), activation="relu2"), (2, 12)),
]


@pytest.mark.parametrize("name,edit,shape", MOE_CASES,
                         ids=[c[0] for c in MOE_CASES])
@pytest.mark.parametrize("cim_weights", [False, True])
def test_moe_forward_matches_reference(name, edit, shape, cim_weights):
    rcfg, pcfg = _both(edit)
    rplan = RefPlan.for_model(rcfg, tp=1)
    seed = sum(map(ord, name))
    params = jax.tree.map(np.asarray, RM.init_moe(
        jax.random.PRNGKey(seed), rcfg, rplan, jnp.float32))
    if cim_weights:
        params = jax.tree.map(np.asarray, ref_quantize(params, 1))
        assert set(params["w_in"]) == {"q", "s"}
        assert params["w_in"]["s"].shape[:2] == (rcfg.moe.num_experts, 1)
        assert not isinstance(params["router"], dict)
    x = np.random.default_rng(seed).standard_normal(
        shape + (rcfg.d_model,)).astype(np.float32)
    r_out, r_aux = jax.jit(functools.partial(
        RM.moe_forward, cfg=rcfg, plan=rplan))(params, jnp.asarray(x))
    pp = _tree_t(params)
    plan = ShardingPlan.for_model(pcfg)
    p_out, p_aux = PM.moe_forward(pp, _t(x), pcfg, plan)
    _close(p_out, r_out, TOL, f"{name}: out")
    _close(p_aux, r_aux, TOL, f"{name}: aux")
    dropped, cap = PM.dropped_pairs(pp, _t(x), pcfg, plan)
    t = shape[0] * shape[1]
    if name == "40e-top8-t4":
        assert cap == 1
    if name in ("cf1", "40e-top8-t4", "shared", "relu2"):
        assert 0 < dropped < t * pcfg.moe.top_k, (name, dropped)


def test_serving_quantization_of_expert_and_mamba_leaves():
    """The port's serving quantization gives the stacked (E, d, f)
    expert weights one scale per (expert, column), and keeps the router
    and the Mamba conv_w, A_log, D and dt_bias float (jamba's bfloat16
    params: the float32 leaves stay float32)."""
    from repro_torch.runtime.serve_loop import quantize_params_for_serving

    _, pcfg = _both(lambda c: c, "jamba-v0.1-52b")
    gen = torch.Generator().manual_seed(0)
    params = T.init_params(pcfg, ShardingPlan(), gen)
    served = quantize_params_for_serving(params, pcfg, 1)
    moe = served["layers"][1]["moe"]
    e, f = pcfg.moe.num_experts, pcfg.moe.d_ff_expert
    assert moe["w_in"]["q"].dtype == torch.int8
    assert tuple(moe["w_in"]["s"].shape) == (e, 1, f)
    assert tuple(moe["w_out"]["s"].shape) == (e, 1, pcfg.d_model)
    assert torch.is_tensor(moe["router"])
    assert moe["router"].dtype == torch.float32
    mamba = served["layers"][0]["mamba"]
    assert set(mamba["w_in_x"]) == {"q", "s"}
    for name in ("A_log", "D", "dt_bias"):
        assert torch.is_tensor(mamba[name]), name
        assert mamba[name].dtype == torch.float32, name
    assert torch.is_tensor(mamba["conv_w"])
    assert mamba["conv_w"].dtype == torch.bfloat16


def _greedy_vs_reference(rcfg, pcfg, seed, steps=4, prompt=10, batch=2):
    """Prefill and ``steps`` greedy decode steps of the port against the
    reference on the same params: logits within TOL, tokens equal."""
    rplan = RefPlan.for_model(rcfg, tp=1)
    params = jax.tree.map(np.asarray, RT.init_params(
        jax.random.PRNGKey(seed), rcfg, rplan, dtype=jnp.float32))
    tokens = np.random.default_rng(seed).integers(
        0, rcfg.vocab_size, (batch, prompt)).astype(np.int32)
    s_max = prompt + steps + 1
    r_decode = jax.jit(functools.partial(RT.decode_step, cfg=rcfg,
                                         plan=rplan))
    r_logits, r_caches = jax.jit(functools.partial(
        RT.prefill, cfg=rcfg, plan=rplan, s_max=s_max))(
            params, jnp.asarray(tokens))
    prog = build_serve_program(pcfg, batch=batch, s_max=s_max, device="cpu")
    pparams = lm_params_from_reference(params, pcfg, device="cpu")
    p_logits, p_caches = prog.prefill_fn(pparams, {"tokens": _t(tokens)})
    _close(p_logits, r_logits, TOL, "prefill logits")
    token = jnp.argmax(r_logits, -1).astype(jnp.int32)
    for i in range(steps):
        pos = prompt + i
        r_logits, r_caches = r_decode(params, token, r_caches,
                                      jnp.int32(pos))
        p_logits, p_caches = prog.decode_fn(pparams, _t(token), p_caches, pos)
        _close(p_logits, r_logits, TOL, f"decode logits at {pos}")
        token = jnp.argmax(r_logits, -1).astype(jnp.int32)
        assert torch.equal(torch.argmax(p_logits, -1).int(), _t(token))


def test_granite_gqa_group_of_three_matches_reference():
    """granite's published group (24 / 8 heads) at reduced width: 6 query
    heads on 2 kv heads, through prefill and greedy decode."""
    def edit(c):
        return dataclasses.replace(c, attention=dataclasses.replace(
            c.attention, num_heads=6, num_kv_heads=2))

    rcfg, pcfg = _both(edit)
    assert pcfg.attention.num_heads // pcfg.attention.num_kv_heads == 3
    _greedy_vs_reference(rcfg, pcfg, seed=5)


def test_granite_decode_with_dropping_matches_reference():
    """The reduced granite at the published capacity factor 1.25, batch
    4: a decode step's cap is ceil(4 * 2 / 4 * 1.25) = 3, so an expert
    that more than 3 of the 8 (token, k) pairs choose drops the rest."""
    rcfg, pcfg = _both(lambda c: _moe_cfg(c, capacity_factor=1.25))
    _greedy_vs_reference(rcfg, pcfg, seed=6, batch=4)


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------

#: (name, config edit): the reduced falcon-mamba (d_state 4, d_conv 2),
#: the published d_state 16 / d_conv 4 at d_model 64, and at d_model
#: 256 where x_proj (512, 48) and dt_proj (16, 512) are large enough to
#: quantize
MAMBA_CASES = [
    ("reduced", lambda c: c),
    ("published-state", lambda c: dataclasses.replace(
        c, ssm=dataclasses.replace(c.ssm, d_state=16, d_conv=4))),
    ("published-state-d256", lambda c: dataclasses.replace(
        c, d_model=256, ssm=dataclasses.replace(c.ssm, d_state=16,
                                                d_conv=4))),
]


def _mamba_params(rcfg, seed, cim_weights):
    rplan = RefPlan.for_model(rcfg, tp=1)
    params = jax.tree.map(np.asarray, RS.init_mamba(
        jax.random.PRNGKey(seed), rcfg, rplan, jnp.float32))
    params["conv_b"] = (0.1 * np.random.default_rng(seed).standard_normal(
        params["conv_b"].shape)).astype(np.float32)
    if cim_weights:
        params = jax.tree.map(np.asarray, ref_quantize(params, 1))
    return params


@pytest.mark.parametrize("name,edit", MAMBA_CASES,
                         ids=[c[0] for c in MAMBA_CASES])
@pytest.mark.parametrize("cim_weights", [False, True])
def test_mamba_forward_and_decode_match_reference(name, edit, cim_weights):
    rcfg, pcfg = _both(edit, "falcon-mamba-7b")
    rplan, plan = RefPlan.for_model(rcfg, tp=1), ShardingPlan()
    seed = sum(map(ord, name))
    params = _mamba_params(rcfg, seed, cim_weights)
    if cim_weights and name == "published-state-d256":
        # the no-``like`` path: both projections are int8 leaves
        assert set(params["x_proj"]) == {"q", "s"}
        assert set(params["dt_proj"]) == {"q", "s"}
    pp = _tree_t(params)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 11, rcfg.d_model)).astype(np.float32)
    r_out, r_cache = jax.jit(functools.partial(
        RS.mamba_forward, cfg=rcfg, plan=rplan, want_cache=True))(
            params, jnp.asarray(x))
    r_decode = jax.jit(functools.partial(RS.mamba_decode, cfg=rcfg,
                                         plan=rplan))
    p_out, p_cache = PS.mamba_forward(pp, _t(x), pcfg, plan, want_cache=True)
    _close(p_out, r_out, TOL, f"{name}: prefill out")
    assert p_cache.keys() == r_cache.keys()
    for key in p_cache:
        assert p_cache[key].dtype == _t(r_cache[key]).dtype, key
        _close(p_cache[key], r_cache[key], TOL, f"{name}: cache {key}")
    for step in range(3):
        xs = rng.standard_normal((2, 1, rcfg.d_model)).astype(np.float32)
        r_out, r_cache = r_decode(params, jnp.asarray(xs), r_cache)
        p_out, p_cache = PS.mamba_decode(pp, _t(xs), p_cache, pcfg, plan)
        _close(p_out, r_out, TOL, f"{name}: decode {step} out")
        for key in p_cache:
            _close(p_cache[key], r_cache[key], TOL,
                   f"{name}: decode {step} cache {key}")


@jax.jit
def _ref_scan(dt, x, b, c, a, d):
    """The reference's discretisation and associative scan
    (``repro/models/ssm.py:97-108``) on numpy inputs."""
    decay = jnp.exp(dt[..., None] * a[None, None])
    drive = dt[..., None] * b[:, :, None, :] * x[..., None]

    def combine(left, right):
        return left[0] * right[0], right[0] * left[1] + right[1]

    _, h = jax.lax.associative_scan(combine, (decay, drive), axis=1)
    y = jnp.einsum("bsdn,bsn->bsd", h, c) + d * x
    return y, h[:, -1]


def _scan_inputs(rng, bsz, s, dl, n):
    dt = np.log1p(np.exp(rng.standard_normal((bsz, s, dl)) - 2.0))
    x = rng.standard_normal((bsz, s, dl))
    b, c = (rng.standard_normal((bsz, s, n)) for _ in range(2))
    a = -np.tile(np.arange(1, n + 1, dtype=np.float64), (dl, 1)) \
        * np.exp(0.1 * rng.standard_normal((dl, n)))
    d = rng.standard_normal(dl)
    return [v.astype(np.float32) for v in (dt, x, b, c, a, d)]


@pytest.mark.parametrize("bsz,s,dl,n", [(1, 1, 8, 4), (2, 37, 24, 4),
                                        (2, 130, 16, 16), (3, 5, 130, 16)])
def test_selective_scan_plain_matches_associative_scan(bsz, s, dl, n):
    """The sequential recurrence against the reference's associative
    scan; sequences longer than the plain version's chunk included."""
    rng = np.random.default_rng(s * 1000 + dl)
    ins = _scan_inputs(rng, bsz, s, dl, n)
    want_y, want_h = _ref_scan(*(jnp.asarray(v) for v in ins))
    y, h = selective_scan_plain(*(_t(v) for v in ins))
    _close(y, want_y, TOL_SCAN, "y")
    _close(h, want_h, TOL_SCAN, "last state")
    # the wrapper takes the plain version on CPU tensors
    y2, h2 = selective_scan(*(_t(v) for v in ins))
    assert torch.equal(y, y2) and torch.equal(h, h2)


def test_selective_scan_initial_state_continues_the_sequence():
    """Scanning S1 steps and then S2 more from the last state equals one
    scan over S1 + S2."""
    rng = np.random.default_rng(7)
    ins = [_t(v) for v in _scan_inputs(rng, 2, 40, 16, 16)]
    y, h = selective_scan_plain(*ins)
    dt, x, b, c, a, d = ins
    y1, h1 = selective_scan_plain(dt[:, :25], x[:, :25], b[:, :25],
                                  c[:, :25], a, d)
    y2, h2 = selective_scan_plain(dt[:, 25:], x[:, 25:], b[:, 25:],
                                  c[:, 25:], a, d, h0=h1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, rtol=TOL_SCAN,
                               atol=TOL_SCAN)
    torch.testing.assert_close(h2, h, rtol=TOL_SCAN, atol=TOL_SCAN)


@jax.jit
def _ref_scan_vjp(ins, cotangents):
    """``jax.vjp`` of the reference's composition (``repro/models/
    ssm.py:97-108``) with an initial state h0 (``ins[6]``; zeros where
    the port gets none), which enters the first step's drive as
    decay_0 h0."""
    def scan(dt, x, b, c, a, d, h0):
        decay = jnp.exp(dt[..., None] * a[None, None])
        drive = dt[..., None] * b[:, :, None, :] * x[..., None]
        drive = drive.at[:, 0].add(decay[:, 0] * h0)

        def combine(left, right):
            return left[0] * right[0], right[0] * left[1] + right[1]

        _, h = jax.lax.associative_scan(combine, (decay, drive), axis=1)
        y = jnp.einsum("bsdn,bsn->bsd", h, c) + d * x
        return y, h[:, -1]

    return jax.vjp(scan, *ins)[1](cotangents)


def _grads_close(got, want, tol, names):
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, name
        err = float(np.max(np.abs(g.detach().numpy().astype(np.float64)
                                  - w))) if w.size else 0.0
        scale = float(np.max(np.abs(w))) if w.size else 0.0
        assert err <= tol * scale, (name, err, scale)


@pytest.mark.parametrize("s", [1, 37, 130])
@pytest.mark.parametrize("n", [4, 16])
@pytest.mark.parametrize("h0,dh_last", [(False, False), (True, True),
                                        (False, True)])
def test_selective_scan_bwd_plain_matches_jax_vjp(s, n, h0, dh_last):
    """The scan's plain backward (all seven gradients, dh0 with an
    initial state) against ``jax.vjp`` of the reference's associative
    scan, with and without the last state's gradient; S 1, 37 and 130
    (past the plain version's 128-step chunk)."""
    rng = np.random.default_rng(100 * s + 10 * n + 2 * h0 + dh_last)
    ins = _scan_inputs(rng, 2, s, 24, n)
    init = rng.standard_normal((2, 24, n)).astype(np.float32) if h0 \
        else None
    dy = rng.standard_normal((2, s, 24)).astype(np.float32)
    dh = rng.standard_normal((2, 24, n)).astype(np.float32) if dh_last \
        else np.zeros((2, 24, n), np.float32)
    zero = np.zeros((2, 24, n), np.float32)
    want = _ref_scan_vjp(
        [jnp.asarray(v) for v in ins + [init if h0 else zero]],
        (jnp.asarray(dy), jnp.asarray(dh)))
    got = selective_scan_bwd_plain(*(_t(v) for v in ins), _t(dy),
                                   _t(dh) if dh_last else None,
                                   _t(init) if h0 else None)
    names = ("ddt", "dx", "dB", "dC", "dA", "dD", "dh0")
    keep = 7 if h0 else 6
    _grads_close(got[:keep], want[:keep], TOL_SCAN_GRAD, names)
    # autograd through the wrapper on CPU tensors gives the same bits
    leaves = [_t(v).requires_grad_() for v in ins]
    y, h = selective_scan(*leaves, _t(init) if h0 else None)
    back = torch.autograd.grad((y * _t(dy)).sum() + (h * _t(dh)).sum(),
                               leaves)
    assert all(torch.equal(a, b) for a, b in zip(back, got))


@pytest.mark.parametrize("name,edit", MAMBA_CASES[:2],
                         ids=[c[0] for c in MAMBA_CASES[:2]])
def test_mamba_forward_grads_match_jax_vjp(name, edit):
    """The Mamba block's gradients (x and every param leaf: the
    projections, conv, A_log, D, dt_bias) through the scan's plain
    backward, against ``jax.vjp`` of the reference's ``mamba_forward``."""
    rcfg, pcfg = _both(edit, "falcon-mamba-7b")
    rplan, plan = RefPlan.for_model(rcfg, tp=1), ShardingPlan()
    seed = sum(map(ord, name)) + 1
    params = _mamba_params(rcfg, seed, False)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 19, rcfg.d_model)).astype(np.float32)
    dout = rng.standard_normal(x.shape).astype(np.float32)
    keys = sorted(params)
    r_params, r_x = jax.jit(lambda p, xx, ct: jax.vjp(
        lambda p, xx: RS.mamba_forward(p, xx, rcfg, rplan)[0], p, xx)[1](ct))(
            params, jnp.asarray(x), jnp.asarray(dout))
    pp = {k: _t(v).requires_grad_() for k, v in params.items()}
    xs = _t(x).requires_grad_()
    out, _ = PS.mamba_forward(pp, xs, pcfg, plan)
    got = torch.autograd.grad(out, [xs] + [pp[k] for k in keys],
                              _t(dout))
    _grads_close(got, [r_x] + [r_params[k] for k in keys], TOL,
                 ["x"] + keys)


@pytest.mark.parametrize("name,edit,shape", [
    ("no-drops", lambda c: c, (2, 12)),
    ("cf1", lambda c: _moe_cfg(c, capacity_factor=1.0), (2, 12)),
    ("40e-top8-prefill", MOE_CASES[3][1], (2, 16))],
    ids=["no-drops", "cf1", "40e-top8-prefill"])
def test_moe_forward_grads_match_jax_vjp(name, edit, shape):
    """The MoE block's gradients (x, the router, the experts) with the
    aux loss's, against ``jax.vjp`` of the reference's ``moe_forward``
    with cotangents on both outputs: the reduced granite at its own
    capacity factor 4.0 (no pair dropped), at 1.0 and the published 40
    experts top-8 at 1.25 (pairs dropped)."""
    rcfg, pcfg = _both(edit)
    rplan, plan = RefPlan.for_model(rcfg, tp=1), ShardingPlan.for_model(pcfg)
    seed = sum(map(ord, name)) + 2
    params = jax.tree.map(np.asarray, RM.init_moe(
        jax.random.PRNGKey(seed), rcfg, rplan, jnp.float32))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape + (rcfg.d_model,)).astype(np.float32)
    dout = rng.standard_normal(x.shape).astype(np.float32)
    daux = np.float32(3.0)
    keys = sorted(params)
    r_params, r_x = jax.jit(lambda p, xx, ct: jax.vjp(
        lambda p, xx: RM.moe_forward(p, xx, rcfg, rplan), p, xx)[1](ct))(
            params, jnp.asarray(x), (jnp.asarray(dout), jnp.asarray(daux)))
    pp = {k: _t(v).requires_grad_() for k, v in params.items()}
    xs = _t(x).requires_grad_()
    out, aux = PM.moe_forward(pp, xs, pcfg, plan)
    got = torch.autograd.grad((out * _t(dout)).sum() + aux * float(daux),
                              [xs] + [pp[k] for k in keys])
    _grads_close(got, [r_x] + [r_params[k] for k in keys], TOL,
                 ["x"] + keys)
    dropped, _ = PM.dropped_pairs(pp, xs.detach(), pcfg, plan)
    assert (dropped > 0) == (name != "no-drops"), (name, dropped)


def test_selective_scan_rejects_bad_operands():
    rng = np.random.default_rng(8)
    dt, x, b, c, a, d = (_t(v) for v in _scan_inputs(rng, 1, 4, 8, 4))
    with pytest.raises(TypeError):
        selective_scan(dt.double(), x, b, c, a, d)
    with pytest.raises(ValueError):
        selective_scan(dt, x, b[:, :3], c, a, d)


# ---------------------------------------------------------------------------
# Caches and stacked segments carried across by convert
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "falcon-mamba-7b",
                                  "jamba-v0.1-52b"])
@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_init_cache_matches_reference(arch, kv_dtype):
    """Zero caches of the new families: mamba layers ``h`` float32 and
    ``conv`` bfloat16, attention layers as before."""
    rcfg, pcfg = ref_config(arch).reduced(), get_config(arch).reduced()
    ref = jax.tree.map(np.asarray, RT.init_cache(
        rcfg, RefPlan.for_model(rcfg, tp=1), 2, 9, kv_dtype))
    want = lm_caches_from_reference(ref, pcfg, device="cpu")
    got = T.init_cache(pcfg, ShardingPlan(), 2, 9, kv_dtype, device="cpu")
    assert len(got) == len(want) == pcfg.num_layers
    for g, w, spec in zip(got, want, T.layer_specs(pcfg)):
        assert g.keys() == w.keys()
        assert ("h" in g) == (spec.kind == "mamba")
        for name in g:
            assert g[name].shape == w[name].shape, name
            assert g[name].dtype == w[name].dtype, name
            assert not g[name].any()


def test_stacked_jamba_cycles_unstack_in_layer_order():
    """jamba over two 8-layer cycles (one reference segment stacked
    twice, as the full model's four): params and prefill caches land in
    layer order, the mamba ``h`` / ``conv`` caches included."""
    def edit(c):
        return dataclasses.replace(c, num_layers=16)

    rcfg, pcfg = _both(edit, "jamba-v0.1-52b")
    segs = T.build_segments(pcfg)
    assert [(len(s.cycle), s.count) for s in segs] == [(8, 2)]
    rplan = RefPlan.for_model(rcfg, tp=1)
    params = jax.tree.map(np.asarray, RT.init_params(
        jax.random.PRNGKey(9), rcfg, rplan, dtype=jnp.float32))
    got = lm_params_from_reference(params, pcfg, device="cpu")
    stacked = params["segments"][0]
    for r in range(2):
        assert torch.equal(got["layers"][8 * r + 4]["attn"]["wq"],
                           _t(stacked[4]["attn"]["wq"][r]))
        assert torch.equal(got["layers"][8 * r + 1]["moe"]["w_in"],
                           _t(stacked[1]["moe"]["w_in"][r]))
        assert torch.equal(got["layers"][8 * r + 7]["mamba"]["A_log"],
                           _t(stacked[7]["mamba"]["A_log"][r]))
    tokens = np.random.default_rng(9).integers(
        0, rcfg.vocab_size, (2, 6)).astype(np.int32)
    _, r_caches = jax.jit(functools.partial(
        RT.prefill, cfg=rcfg, plan=rplan))(params, jnp.asarray(tokens))
    r_caches = jax.tree.map(np.asarray, r_caches)
    caches = lm_caches_from_reference(r_caches, pcfg, device="cpu")
    for r in range(2):
        for j in (0, 4, 7):
            for name, arr in r_caches[0][j].items():
                assert torch.equal(caches[8 * r + j][name], _t(arr[r])), (
                    r, j, name)
    assert set(caches[3]) == {"h", "conv"} and set(caches[12]) == {"k", "v"}
    _, p_caches = T.prefill(got, _t(tokens), pcfg, ShardingPlan())
    for l, (pc, rc) in enumerate(zip(p_caches, caches)):
        for name in pc:
            _close(pc[name], rc[name], TOL, f"layer {l} {name}")
