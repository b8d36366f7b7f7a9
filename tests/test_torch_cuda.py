"""Card-only checks of the port (marker ``cuda``): they skip without an
NVIDIA card, and import no ``jax`` so that they run on the card's
machine (``pytest -m cuda tests/test_torch_*.py``).

Tolerances.  CIM kernel: equal by value — the kernel and its plain
version compute the same exact integer dots and the same float32
conversion ops.  Local attention: float32 within rtol = atol = 2e-5 (the
reference's own kernel-vs-oracle tolerance; the two sum in other
orders), bfloat16 within rtol = atol = 1e-2 (both round p and the
output to bfloat16 at other points; one bfloat16 ulp is 2^-8 relative).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.cim import CIMSpec  # noqa: E402
from repro_torch.kernels import local_attention as LA  # noqa: E402
from repro_torch.kernels import cim_matmul as KM  # noqa: E402
from repro_torch.kernels.cim_matmul import (  # noqa: E402
    LAUNCHES,
    cim_codes,
    cim_codes_plain,
)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")


def _ints(rng, shape):
    return torch.from_numpy(
        rng.integers(-128, 128, shape).astype(np.int8)).cuda()


def _table(rng, n, spec):
    inv = np.float32(spec.adc_inv_step) * (1 + 0.02 * rng.standard_normal(n))
    off = 0.5 * rng.standard_normal(n)
    return torch.from_numpy(
        np.stack([inv, off], axis=1).astype(np.float32)).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("n_c", [32, 96, 256])
def test_cuda_kernel_matches_plain(n_c):
    """Both layouts, both ADC flavors, both output modes, ragged R, N
    and K; every call launches the kernel once."""
    _needs_card()
    rng = np.random.default_rng(n_c)
    spec = CIMSpec(n_c=n_c)
    cases = [(_ints(rng, (5, 37, n_c - 3)), _ints(rng, (5, n_c - 3, 77))),
             (_ints(rng, (13, 3 * n_c + 11)), _ints(rng, (3 * n_c + 11, 130))),
             (_ints(rng, (18, 16, n_c)), _ints(rng, (18, n_c, 512)))]
    before = sum(LAUNCHES.values())
    for x, w in cases:
        steps = x.shape[0] if x.dim() == 3 else -(-x.shape[1] // n_c)
        for adc in (None, _table(rng, steps, spec)):
            for emit in (True, False):
                a = cim_codes(x, w, spec, adc=adc, emit_codes=emit)
                b = cim_codes_plain(x, w, spec, adc=adc, emit_codes=emit)
                torch.cuda.synchronize()
                assert torch.equal(a + 0.0, b + 0.0)
    assert sum(LAUNCHES.values()) == before + 4 * len(cases)


@pytest.mark.cuda
def test_fc_layout_reads_strided_slices():
    """The FC grid hands the kernel column slices of the resident weight
    matrix and row-strided activation slices; no copy, same codes."""
    _needs_card()
    rng = np.random.default_rng(1)
    spec = CIMSpec(n_c=96)
    x, w = _ints(rng, (7, 500)), _ints(rng, (500, 300))
    xs, ws = x[:, 100:400], w[100:400, 40:250]
    assert not xs.is_contiguous() and not ws.is_contiguous()
    a = cim_codes(xs, ws, spec)
    b = cim_codes_plain(xs.contiguous(), ws.contiguous(), spec)
    torch.cuda.synchronize()
    assert torch.equal(a + 0.0, b + 0.0)


def _same(a, b):
    return torch.equal(a + 0.0, b + 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("kc", [9, 29, 256])
def test_cuda_kernel_edge_grid(kc):
    """Rows 1, 4, 16, 37 and 4096 (not multiples of the row tiles),
    columns 10, 64, 77, 512 and 1000, steps 1, 3, 7, 18 and 40 (no split
    size divides them all), depth 9, 29 and n_c = 256 (the first two on
    the byte-staging path); the weight K-major (no copy) and N-major
    (one counted copy a call).  Then FC-layout slices: x a column slice
    at an aligned and an odd offset, the weight a slice of a K-major
    store, the last step ragged.  Both variants, both output modes."""
    _needs_card()
    rng = np.random.default_rng(kc)
    spec = CIMSpec(n_c=256)
    for r in (1, 4, 16, 37, 4096):
        for n in (10, 64, 77, 512, 1000):
            cases = []
            for t in (1, 3, 7, 18, 40):
                w_nk = _ints(rng, (t, n, kc))
                cases.append((_ints(rng, (t, r, kc)), w_nk.transpose(1, 2),
                              t))
            for t in (1, 3, 7):
                k = (t - 1) * 256 + kc
                xs, store = _ints(rng, (r, k + 35)), _ints(rng, (n + 5, k + 21))
                for off in (16, 3):
                    cases.append((xs[:, off:off + k],
                                  store[3:3 + n, 5:5 + k].T, t))
            for x, w_k, t in cases:
                w_n = w_k.contiguous()
                for adc in (None, _table(rng, t, spec)):
                    for emit in (True, False):
                        want = cim_codes_plain(x, w_k, spec, adc=adc,
                                               emit_codes=emit)
                        copies = KM.WEIGHT_COPIES
                        a = cim_codes(x, w_k, spec, adc=adc, emit_codes=emit)
                        assert KM.WEIGHT_COPIES == copies
                        b = cim_codes(x, w_n, spec, adc=adc, emit_codes=emit)
                        assert KM.WEIGHT_COPIES == copies + 1
                        torch.cuda.synchronize()
                        assert _same(a, want) and _same(b, want), (
                            x.shape, w_k.shape, adc is not None, emit)


#: the robust DSE's precisions below 8 bits: 6-bit weights and
#: activations with 6- and 4-bit ADCs
LOW_PRECISION = [CIMSpec(n_c=256, w_bits=6, a_bits=6, adc_bits=b)
                 for b in (6, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("spec", LOW_PRECISION,
                         ids=lambda s: f"adc{s.adc_bits}")
def test_cuda_kernel_low_precision(spec):
    """The kernel reads ``q_max`` and the steps at run time: 6-bit
    operands (codes of the narrower grid) with 6- and 4-bit ADCs equal
    the plain version by value, both variants, both layouts, both output
    modes, at vgg11's call shapes and ragged ones."""
    _needs_card()
    rng = np.random.default_rng(spec.adc_bits)
    lo, hi = -spec.w_max - 1, spec.w_max + 1

    def ints(shape):
        return torch.from_numpy(
            rng.integers(lo, hi, shape).astype(np.int8)).cuda()

    cases = [(ints((3, 4096, 9)), ints((3, 64, 9)).transpose(1, 2)),
             (ints((18, 16, 256)), ints((18, 512, 256)).transpose(1, 2)),
             (ints((7, 37, 29)), ints((7, 77, 29)).transpose(1, 2)),
             (ints((4, 16 * 256)), ints((10, 16 * 256)).T),
             (ints((13, 3 * 256 + 11)), ints((130, 3 * 256 + 11)).T)]
    for x, w in cases:
        steps = x.shape[0] if x.dim() == 3 else -(-x.shape[1] // 256)
        for adc in (None, _table(rng, steps, spec)):
            for emit in (True, False):
                a = cim_codes(x, w, spec, adc=adc, emit_codes=emit)
                b = cim_codes_plain(x, w, spec, adc=adc, emit_codes=emit)
                torch.cuda.synchronize()
                assert _same(a, b), (tuple(x.shape), adc is not None, emit)


@pytest.mark.cuda
def test_cuda_captured_launch_counted_at_run_only():
    """A ``cim_codes`` call recorded into a CUDA graph by any caller is
    not counted as a launch; the warm-up call and the graph's replay run
    the kernel, and the replay equals the eager result."""
    _needs_card()
    rng = np.random.default_rng(5)
    spec = CIMSpec(n_c=128)
    x, w = _ints(rng, (40, 300)), _ints(rng, (300, 96))
    before = dict(LAUNCHES)
    want = cim_codes(x, w, spec)                # warm-up: builds, launches
    torch.cuda.synchronize()
    assert LAUNCHES["cim_codes"] == before["cim_codes"] + 1
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = cim_codes(x, w, spec)
    assert LAUNCHES["cim_codes"] == before["cim_codes"] + 1
    graph.replay()
    torch.cuda.synchronize()
    assert _same(got, want)
    assert LAUNCHES == {k: before[k] + (k == "cim_codes") for k in before}


@pytest.mark.cuda
def test_cuda_code_width_guard():
    """The kernel sums codes below 2^22 only: a 23-bit ADC
    (``q_max + 1 == 2^22``) runs and equals the plain version, a 24-bit
    one raises before launching."""
    _needs_card()
    rng = np.random.default_rng(23)
    x, w = _ints(rng, (2, 8, 256)), _ints(rng, (2, 256, 64))
    ok = CIMSpec(n_c=256, adc_bits=23)
    before = dict(LAUNCHES)
    a = cim_codes(x, w, ok)
    torch.cuda.synchronize()
    assert _same(a, cim_codes_plain(x, w, ok))
    assert LAUNCHES["cim_codes"] == before["cim_codes"] + 1
    with pytest.raises(ValueError, match="2\\^22"):
        cim_codes(x, w, CIMSpec(n_c=256, adc_bits=24))
    assert LAUNCHES["cim_codes"] == before["cim_codes"] + 1


@pytest.mark.cuda
def test_cuda_kernel_any_split_same_codes(monkeypatch):
    """Every row tile and every split into 1 to 8 slices (more slices
    than steps included) gives the plain version's codes: the code sum
    is exact, so no split changes a bit."""
    _needs_card()
    rng = np.random.default_rng(7)
    spec = CIMSpec(n_c=256)
    for t, r, kc, n in [(18, 16, 256, 512), (7, 37, 29, 77), (3, 100, 9, 130),
                        (40, 64, 256, 64)]:
        x, w = _ints(rng, (t, r, kc)), _ints(rng, (t, n, kc)).transpose(1, 2)
        for adc in (None, _table(rng, t, spec)):
            want = cim_codes_plain(x, w, spec, adc=adc)
            for rows in KM.ROW_TILES:
                for slices in range(1, KM.MAX_SLICES + 1):
                    plan = KM.Plan(rows, slices)
                    monkeypatch.setattr(KM, "launch_plan",
                                        lambda t, r, n, plan=plan: plan)
                    got = cim_codes(x, w, spec, adc=adc)
                    torch.cuda.synchronize()
                    assert _same(got, want), (t, r, kc, n, rows, slices)


@pytest.mark.cuda
@pytest.mark.parametrize("c_in,c_out", [(25088, 4096), (4096, 4096),
                                        (4096, 1000)])
def test_cuda_fc_layer_one_launch(c_in, c_out):
    """vgg16-imagenet's three FC layers at a 4-frame batch through the
    engine's one-call FC layer: one launch of the flavor's variant, no
    weight copy, equal by value to ``cim_codes_plain`` and to the sum
    down each column of the per-tile ``fc_mac`` grid (n_c = n_m = 256),
    nominal and with a per-subarray ADC table."""
    _needs_card()
    from repro_torch.core.engine import CIMEngine

    rng = np.random.default_rng(c_in + c_out)
    eng = CIMEngine(device="cuda").set_layer("fc", a_scale=0.05)
    w = torch.from_numpy((rng.standard_normal((c_in, c_out))
                          / np.sqrt(c_in)).astype(np.float32)).cuda()
    h = eng.fc_handle("fc", w)
    x = _ints(rng, (4, c_in))
    spec, t = h.spec, -(-c_in // h.spec.n_c)
    # the engine's table has 2 t + 1 rows; the layer reads the first t
    for adc in (None, _table(rng, 2 * t + 1, spec)):
        h.adc = adc
        before, copies = dict(LAUNCHES), KM.WEIGHT_COPIES
        got = eng.fc_layer_mac(h, x)
        torch.cuda.synchronize()
        launched = {k: LAUNCHES[k] - before[k] for k in before}
        assert launched == {"cim_codes": int(adc is None),
                            "cim_codes_var": int(adc is not None)}
        assert KM.WEIGHT_COPIES == copies
        plain = cim_codes_plain(x, h.w8, spec,
                                adc=None if adc is None else adc[:t])
        assert _same(got, plain.to(torch.float64))
        chain = torch.zeros_like(got)
        for n0 in range(0, c_out, 256):
            n1 = min(n0 + 256, c_out)
            for k0 in range(0, c_in, spec.n_c):
                k1 = min(k0 + spec.n_c, c_in)
                chain[:, n0:n1] += eng.fc_mac(h, x[:, k0:k1], k0, k1, n0, n1)
        torch.cuda.synchronize()
        assert _same(got, chain)
        assert KM.WEIGHT_COPIES == copies


@pytest.mark.cuda
def test_cuda_quantization_matches_cpu():
    """The steps that divide give the CPU's values on the card: weight
    scales and codes, activation codes, vgg16's and resnet50's global
    average pools (7 x 7).  A CUDA division by a Python number multiplies
    by its reciprocal, which rounds some quotients to another float."""
    _needs_card()
    from types import SimpleNamespace

    from repro_torch.core.engine import CIMEngine, quantize_weight
    from repro_torch.core.network import _global_avg_pool

    rng = np.random.default_rng(11)
    w = torch.from_numpy(rng.standard_normal((3, 3, 256, 512)) / 48)
    for bits in (8, 6):
        q_card, s_card = quantize_weight(w.cuda(), bits)
        q, s = quantize_weight(w, bits)
        assert torch.equal(q_card.cpu(), q) and torch.equal(s_card.cpu(), s)
    h = SimpleNamespace(a_scale=0.0123, a_clip=127.0)
    x = torch.from_numpy(rng.standard_normal((4, 7, 7, 2048)))
    assert torch.equal(
        CIMEngine(device="cuda").quant_stream(h, x.cuda()).cpu(),
        CIMEngine(device="cpu").quant_stream(h, x))
    assert torch.equal(_global_avg_pool(x.cuda()).cpu(), _global_avg_pool(x))


def _toy_sims(variation=None):
    """A reduced CNN (packing, a C = 300 > n_c split chain, pools, an FC
    head) served on the card twice, sharing one calibrated CIM engine:
    eager (``trace_jit=False``) and captured (``trace_jit=True``)."""
    from repro_torch.configs.cnn import CNNConfig, ConvLayer, FCLayer
    from repro_torch.core.engine import CIMEngine
    from repro_torch.core.network import NetworkSimulator

    cnn = CNNConfig("toy", "cifar10", 8, (
        ConvLayer("c0", 8, 8, 3, 32, k=3, pool_k=2, pool_s=2),
        ConvLayer("c1", 4, 4, 32, 300, k=3),
        ConvLayer("c2", 4, 4, 300, 64, k=3, pool_k=2, pool_s=2),
        FCLayer("fc", 256, 10)))
    rng = np.random.default_rng(21)
    params = {}
    for l in cnn.layers:
        shape = ((l.k, l.k, l.c, l.m) if isinstance(l, ConvLayer)
                 else (l.c_in, l.c_out))
        params[l.name] = torch.from_numpy(
            rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1])))
    frames = rng.random((6, 8, 8, 3))
    eng = CIMEngine(device="cuda")
    sims = [NetworkSimulator(cnn, params, engine=eng, streaming=True,
                             calib_images=frames[:2], trace_jit=jit,
                             device="cuda") for jit in (False, True)]
    if variation is not None:
        for sim in sims:
            sim.set_variation(variation)
    return sims, frames


def _cim_kernel_events(run):
    """CIM kernel launches that ``torch.profiler`` sees in ``run()`` (a
    graph replay's kernels included)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return sum(ev.count for ev in prof.key_averages()
               if "cim_codes_kernel" in ev.key)


@pytest.mark.cuda
def test_cuda_trace_jit_replay_equals_eager():
    """A captured executor's replay equals its eager run by value (logits
    of ``run`` and of ``run_stream``); the first call of each executor
    captures, later calls replay."""
    _needs_card()
    from repro_torch.core.trace import GRAPHS

    (eager, jit), frames = _toy_sims()
    n_ex = len(jit._executors)
    before = dict(GRAPHS)
    got = jit.run(frames[:4])
    assert GRAPHS["captures"] - before["captures"] == n_ex
    assert GRAPHS["replays"] - before["replays"] == n_ex
    want = eager.run(frames[:4])
    torch.cuda.synchronize()
    assert _same(got.logits, want.logits)
    res = jit.run_stream(frames, chunk=4)       # a 4- and a 2-frame batch
    assert GRAPHS["captures"] - before["captures"] == 2 * n_ex
    assert GRAPHS["replays"] - before["replays"] == 3 * n_ex
    assert _same(res.logits, eager.run_stream(frames, chunk=4).logits)


@pytest.mark.cuda
def test_cuda_replayed_launches_counted():
    """A run whose graphs are captured launches no conv kernel through
    the wrapper: its conv launches are replayed, counted per graph in
    ``REPLAYED`` (one per fire chunk), and the profiler sees exactly the
    replayed and the wrapper's (FC) launches — the cluster launches
    capture and replay."""
    _needs_card()
    from repro_torch.core.trace import GRAPHS, REPLAYED

    (_, jit), frames = _toy_sims()
    jit.run(frames[:4])                         # captures
    chunks = sum(len(ex._quant_chunks(ex.plan.fires, 4))
                 for ex in jit._executors.values())
    assert sum(sum(g.launches.values()) for ex in jit._executors.values()
               for g in ex._graphs.values()) == chunks
    before, rep = dict(LAUNCHES), dict(REPLAYED)
    captures, copies = GRAPHS["captures"], KM.WEIGHT_COPIES
    seen = _cim_kernel_events(lambda: jit.run(frames[:4]))
    assert GRAPHS["captures"] == captures
    assert REPLAYED["cim_codes"] - rep["cim_codes"] == chunks
    assert LAUNCHES["cim_codes"] - before["cim_codes"] == 1  # the FC layer
    assert seen == chunks + 1
    assert KM.WEIGHT_COPIES == copies


@pytest.mark.cuda
def test_cuda_replay_after_set_variation_equals_eager():
    """``set_variation`` drops the captured graphs (they read the old
    handles): the next replay, and the one after a swap back to nominal,
    equal the eager runs by value."""
    _needs_card()
    from repro_torch.core.variation import VARIATION_PRESETS

    (eager, jit), frames = _toy_sims()
    nominal = jit.run(frames[:4]).logits
    for sim in (eager, jit):
        sim.set_variation(VARIATION_PRESETS["all"])
    assert all(not ex._graphs for ex in jit._executors.values())
    varied = jit.run(frames[:4]).logits
    assert _same(varied, eager.run(frames[:4]).logits)
    assert not _same(varied, nominal)
    for sim in (eager, jit):
        sim.set_variation(None)
    assert _same(jit.run(frames[:4]).logits, nominal)


@pytest.mark.cuda
def test_cuda_replay_output_is_fresh_per_call():
    """Each replay returns a new tensor: a later replay leaves what an
    earlier call returned unchanged."""
    _needs_card()
    (_, jit), frames = _toy_sims()
    ex = jit._executors[0, 0]
    x = torch.from_numpy(frames[:4]).cuda()
    a = ex.run(x, account=False)
    a_copy = a.clone()
    b = ex.run(x * 0.5, account=False)
    torch.cuda.synchronize()
    assert a.data_ptr() != b.data_ptr()
    assert torch.equal(a, a_copy) and not torch.equal(a, b)
    assert all(a.data_ptr() != g.out.data_ptr()
               for g in ex._graphs.values())


@pytest.mark.cuda
def test_cuda_interp_equals_trace():
    """The per-cycle interpreter on the card: the toy CNN's logits equal
    the trace backend's by value, counters and traffic equal; one kernel
    launch per MAC-firing slot of the decoded tables plus one for the FC
    layer; no weight copy and no host sync inside ``run``."""
    _needs_card()
    import dataclasses

    from repro_torch.core.network import NetworkSimulator
    from repro_torch.core.simulator import mac_slots

    (trace, _), frames = _toy_sims()
    interp = NetworkSimulator(trace.cnn, trace.params, backend="interp",
                              engine=trace.pe_engine, device="cuda")
    x = torch.from_numpy(frames[:4]).cuda()
    want = trace.run(x)
    slots = sum(mac_slots(s) for s in interp.schedules if s is not None)
    before, copies = dict(LAUNCHES), KM.WEIGHT_COPIES
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = interp.run(x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert LAUNCHES["cim_codes"] - before["cim_codes"] == slots + 1
    assert LAUNCHES["cim_codes_var"] == before["cim_codes_var"]
    assert KM.WEIGHT_COPIES == copies
    assert _same(got.logits, want.logits)
    assert dataclasses.asdict(got.counters) == dataclasses.asdict(
        want.counters)
    assert dict(got.traffic.byte_hops) == dict(want.traffic.byte_hops)


ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}


def _normal(rng, shape, dtype):
    return torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).cuda().to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 64, 128, 256])
def test_cuda_local_attention_matches_plain(d, dtype):
    """The bfloat16 (tensor-core) and float32 (CUDA-core) kernels against
    the plain version where the tiling has edges: S not a multiple of the
    64-key tiles or the 128-row blocks (37, 777, 2049), windows that are
    not multiples of a tile (1, 63, 65, 100, 513, S), GQA groups 1, 2, 4
    and 8 over 2 kv heads, soft cap off and 50.0, and the (BH, S, D)
    layout.  Each call launches its dtype's kernel once and the other
    kernel never."""
    _needs_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(d)
    tol = ATTN_TOL[dtype]
    name, other = (("local_attention", "local_attention_f32")
                   if dtype == torch.bfloat16 else
                   ("local_attention_f32", "local_attention"))
    calls = 0
    for s in (37, 777, 2049):
        for group in (1, 2, 4, 8):
            q = _normal(rng, (1, s, 2 * group, d), dtype)
            k, v = (_normal(rng, (1, s, 2, d), dtype) for _ in range(2))
            for window in (1, 63, 65, 100, 513, s):
                for cap in (None, 50.0):
                    before = dict(LA.LAUNCHES)
                    a = LA.grouped_local_attention(q, k, v, window=window,
                                                   softcap=cap)
                    b = LA.grouped_local_attention_plain(
                        q, k, v, window=window, softcap=cap)
                    torch.cuda.synchronize()
                    assert LA.LAUNCHES[name] == before[name] + 1
                    assert LA.LAUNCHES[other] == before[other]
                    torch.testing.assert_close(a.float(), b.float(),
                                               rtol=tol, atol=tol)
                    calls += 1
        q = _normal(rng, (2, s, 4, d), dtype)
        k, v = (_normal(rng, (2, s, 1, d), dtype) for _ in range(2))
        qb = q.permute(0, 2, 1, 3).reshape(8, s, d)
        kb = k.expand(2, s, 4, d).permute(0, 2, 1, 3).reshape(8, s, d)
        vb = v.expand(2, s, 4, d).permute(0, 2, 1, 3).reshape(8, s, d)
        a = LA.local_attention(qb, kb, vb, window=7)
        b = LA.local_attention_plain(qb, kb, vb, window=7)
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)
    assert calls == 3 * 4 * 6 * 2


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 64, 128, 256])
def test_cuda_local_attention_f32_tile_edges(d):
    """The float32 kernel at its own edges: S on each side of its 64-row
    blocks and 64-key tiles (63, 64, 65, 129), windows on each side of
    its 4-key P V groups, 8-row warps and 64-key tiles, GQA
    groups 1 and 4, soft cap off and 50.0; one launch a call."""
    _needs_card()
    rng = np.random.default_rng(100 + d)
    tol = ATTN_TOL[torch.float32]
    calls = 0
    for s in (63, 64, 65, 129):
        for group in (1, 4):
            q = _normal(rng, (2, s, 2 * group, d), torch.float32)
            k, v = (_normal(rng, (2, s, 2, d), torch.float32)
                    for _ in range(2))
            for window in (3, 4, 5, 7, 8, 9, 63, 64, 65, s):
                for cap in (None, 50.0):
                    before = dict(LA.LAUNCHES)
                    a = LA.grouped_local_attention(q, k, v, window=window,
                                                   softcap=cap)
                    b = LA.grouped_local_attention_plain(
                        q, k, v, window=window, softcap=cap)
                    torch.cuda.synchronize()
                    assert LA.LAUNCHES["local_attention_f32"] == \
                        before["local_attention_f32"] + 1
                    assert LA.LAUNCHES["local_attention"] == \
                        before["local_attention"]
                    torch.testing.assert_close(a, b, rtol=tol, atol=tol)
                    calls += 1
    assert calls == 4 * 2 * 10 * 2


@pytest.mark.cuda
def test_cuda_local_attention_f32_reads_unaligned_views():
    """A strided view whose rows start on 16 bytes is read in place; one
    whose rows do not is copied once by the wrapper."""
    _needs_card()
    rng = np.random.default_rng(7)
    base = _normal(rng, (2, 300, 4, 3, 64), torch.float32)
    q, k, v = base[..., 0, :], base[:, :, :1, 1, :], base[:, :, :1, 2, :]
    flat = _normal(rng, (2 * 100 * 2 * 64 + 1,), torch.float32)
    qm = flat[1:].view(2, 100, 2, 64)
    for args, window in (((q, k, v), 65), ((qm, qm, qm), 33)):
        before = LA.LAUNCHES["local_attention_f32"]
        a = LA.grouped_local_attention(*args, window=window)
        b = LA.grouped_local_attention_plain(*args, window=window)
        torch.cuda.synchronize()
        assert LA.LAUNCHES["local_attention_f32"] == before + 1
        torch.testing.assert_close(a, b, rtol=ATTN_TOL[torch.float32],
                                   atol=ATTN_TOL[torch.float32])


@pytest.mark.cuda
def test_cuda_local_attention_rejects_unbuilt_head_dim():
    _needs_card()
    q = torch.zeros((1, 8, 2, 32), device="cuda")
    before = dict(LA.LAUNCHES)
    with pytest.raises(ValueError, match="head dim"):
        LA.grouped_local_attention(q, q, q, window=4)
    assert LA.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kv,d", [(6, 2, 64), (24, 8, 64), (8, 2, 128)])
def test_cuda_local_attention_odd_groups(h, kv, d, dtype):
    """granite's GQA group of 3 at head dim 64 (reduced 6 / 2 and
    published 24 / 8 heads) and jamba's group of 4 at head dim 128, full
    causal and windowed, S ragged against the tiles."""
    _needs_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(h * 100 + d)
    tol = ATTN_TOL[dtype]
    name = ("local_attention" if dtype == torch.bfloat16
            else "local_attention_f32")
    for s in (37, 300):
        q = _normal(rng, (2, s, h, d), dtype)
        k, v = (_normal(rng, (2, s, kv, d), dtype) for _ in range(2))
        for window in (s, 65):
            before = LA.LAUNCHES[name]
            a = LA.grouped_local_attention(q, k, v, window=window)
            b = LA.grouped_local_attention_plain(q, k, v, window=window)
            torch.cuda.synchronize()
            assert LA.LAUNCHES[name] == before + 1
            torch.testing.assert_close(a.float(), b.float(), rtol=tol,
                                       atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kv,d", [(16, 16, 64), (16, 8, 128)])
def test_cuda_local_attention_encdec_and_vlm_shapes(h, kv, d, dtype):
    """seamless-m4t's decoder self-attention (16 heads of 64 on 16 kv
    heads) and internvl2's layers (16 / 8 heads of 128) at their
    published widths: full causal, as both models run it, and windowed,
    S ragged against the tiles and at the prompt length past it."""
    _needs_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(h * 1000 + kv * 10 + d)
    tol = ATTN_TOL[dtype]
    name = ("local_attention" if dtype == torch.bfloat16
            else "local_attention_f32")
    for s in (37, 777, 2049):
        q = _normal(rng, (1, s, h, d), dtype)
        k, v = (_normal(rng, (1, s, kv, d), dtype) for _ in range(2))
        for window in (s, 65):
            before = LA.LAUNCHES[name]
            a = LA.grouped_local_attention(q, k, v, window=window)
            b = LA.grouped_local_attention_plain(q, k, v, window=window)
            torch.cuda.synchronize()
            assert LA.LAUNCHES[name] == before + 1
            torch.testing.assert_close(a.float(), b.float(), rtol=tol,
                                       atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_local_attention_mla_head_dims(dtype):
    """deepseek-v3's MLA pair, q / k 192 wide against v 128, in both
    kernels: S ragged against the tiles (37, 777, 2049), windows 1, 63,
    65, 100, 513 and S, groups 1 and 4 (128 heads on 128 kv heads in the
    model), soft cap off and 50.0; the output is 128 wide, one launch a
    call."""
    _needs_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(192)
    tol = ATTN_TOL[dtype]
    name = ("local_attention" if dtype == torch.bfloat16
            else "local_attention_f32")
    for s in (37, 777, 2049):
        for group in (1, 4):
            q = _normal(rng, (1, s, 2 * group, 192), dtype)
            k = _normal(rng, (1, s, 2, 192), dtype)
            v = _normal(rng, (1, s, 2, 128), dtype)
            for window in (1, 63, 65, 100, 513, s):
                for cap in (None, 50.0):
                    before = LA.LAUNCHES[name]
                    a = LA.grouped_local_attention(q, k, v, window=window,
                                                   softcap=cap)
                    b = LA.grouped_local_attention_plain(
                        q, k, v, window=window, softcap=cap)
                    torch.cuda.synchronize()
                    assert a.shape == (1, s, 2 * group, 128)
                    assert LA.LAUNCHES[name] == before + 1
                    torch.testing.assert_close(a.float(), b.float(),
                                               rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_local_attention_mla_strided_v(dtype):
    """v as a strided view (a slice of a wider per-head tensor, as the
    c w_uv product could be cut), read in place; k's rope columns a
    broadcast copy of one head's, as the model builds them."""
    _needs_card()
    rng = np.random.default_rng(193)
    name = ("local_attention" if dtype == torch.bfloat16
            else "local_attention_f32")
    s, h = 300, 4
    q = _normal(rng, (2, s, h, 192), dtype)
    k_rope = _normal(rng, (2, s, 1, 64), dtype)
    k = torch.cat([_normal(rng, (2, s, h, 128), dtype),
                   k_rope.expand(2, s, h, 64)], dim=-1)
    wide = _normal(rng, (2, s, h, 256), dtype)
    v = wide[..., 64:192]
    assert not v.is_contiguous()
    before = LA.LAUNCHES[name]
    a = LA.grouped_local_attention(q, k, v, window=s)
    b = LA.grouped_local_attention_plain(q, k, v, window=s)
    torch.cuda.synchronize()
    assert LA.LAUNCHES[name] == before + 1
    torch.testing.assert_close(a.float(), b.float(), rtol=ATTN_TOL[dtype],
                               atol=ATTN_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dqk,dv", [(192, 192), (128, 192), (256, 128)])
def test_cuda_local_attention_rejects_unbuilt_head_dim_pair(dqk, dv):
    _needs_card()
    q = torch.zeros((1, 8, 2, dqk), device="cuda", dtype=torch.bfloat16)
    v = torch.zeros((1, 8, 2, dv), device="cuda", dtype=torch.bfloat16)
    before = dict(LA.LAUNCHES)
    with pytest.raises(ValueError, match="head dims"):
        LA.grouped_local_attention(q, q, v, window=4)
    assert LA.LAUNCHES == before


#: the scan kernel against its plain version: both round each multiply
#: and add of the state apart (the kernel is built with -fmad=false); y's
#: sums over d_state run in other orders (the kernel's with fused
#: multiply-adds), and exp may differ by an ulp
SCAN_TOL = 1e-5


def _scan_operands(rng, bsz, s, dl, n, h0):
    dt = np.log1p(np.exp(rng.standard_normal((bsz, s, dl)) - 2.0))
    a = -np.tile(np.arange(1, n + 1, dtype=np.float64), (dl, 1))
    ops = [dt, rng.standard_normal((bsz, s, dl)),
           rng.standard_normal((bsz, s, n)), rng.standard_normal((bsz, s, n)),
           a, rng.standard_normal(dl),
           rng.standard_normal((bsz, dl, n)) if h0 else None]
    return [None if v is None else
            torch.from_numpy(v.astype(np.float32)).cuda() for v in ops]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 16])
def test_cuda_selective_scan_matches_plain(n):
    """Ragged shapes: S below, at and past the kernel's 16-step runs and
    its 3-run ring (1, 16, 17, 37, 48, 49, 2049), d_inner a multiple and a
    non-multiple of its 64-channel blocks and of 4 (4-byte copies), with
    and without an initial state; one launch a call."""
    from repro_torch.kernels import selective_scan as SS

    _needs_card()
    rng = np.random.default_rng(n)
    calls = 0
    shapes = ((1, 1, 128), (2, 37, 200), (3, 2049, 256), (1, 16, 5),
              (2, 17, 64), (1, 48, 130), (2, 49, 65))
    for bsz, s, dl in shapes:
        for h0 in (False, True):
            ops = _scan_operands(rng, bsz, s, dl, n, h0)
            before = SS.LAUNCHES["selective_scan"]
            y, h = SS.selective_scan(*ops)
            torch.cuda.synchronize()
            assert SS.LAUNCHES["selective_scan"] == before + 1
            y_ref, h_ref = SS.selective_scan_plain(*ops)
            torch.testing.assert_close(y, y_ref, rtol=SCAN_TOL,
                                       atol=SCAN_TOL)
            torch.testing.assert_close(h, h_ref, rtol=SCAN_TOL,
                                       atol=SCAN_TOL)
            calls += 1
    assert calls == 2 * len(shapes)


@pytest.mark.cuda
def test_cuda_selective_scan_reads_unaligned_views():
    """dt as a view that does not start on 16 bytes: the kernel copies
    4 bytes at a time, with the same result."""
    from repro_torch.kernels import selective_scan as SS

    _needs_card()
    ops = _scan_operands(np.random.default_rng(5), 2, 37, 64, 16, False)
    flat = torch.empty(ops[0].numel() + 1, device="cuda")
    dt = flat[1:].view(ops[0].shape)
    dt.copy_(ops[0])
    before = SS.LAUNCHES["selective_scan"]
    y, h = SS.selective_scan(dt, *ops[1:])
    y_ref, h_ref = SS.selective_scan_plain(dt, *ops[1:])
    torch.cuda.synchronize()
    assert SS.LAUNCHES["selective_scan"] == before + 1
    torch.testing.assert_close(y, y_ref, rtol=SCAN_TOL, atol=SCAN_TOL)
    torch.testing.assert_close(h, h_ref, rtol=SCAN_TOL, atol=SCAN_TOL)


@pytest.mark.cuda
def test_cuda_selective_scan_rejects_unbuilt_state_size():
    from repro_torch.kernels import selective_scan as SS

    _needs_card()
    ops = _scan_operands(np.random.default_rng(0), 1, 4, 8, 8, False)
    before = SS.LAUNCHES["selective_scan"]
    with pytest.raises(ValueError, match="d_state"):
        SS.selective_scan(*ops)
    assert SS.LAUNCHES["selective_scan"] == before


#: the backward kernel against its plain version: max |diff| of each of
#: dq, dk, dv within TOL_BWD times the largest |value| of the three plain
#: gradients.  float32: both sum in f32 in other orders, and the kernel's
#: D = dO . o and lse are its own sums; bfloat16: both round p to
#: bfloat16 for dV and their outputs to bfloat16 (one ulp is 2^-8
#: relative), where a p near a rounding edge can round apart.
TOL_BWD = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _bwd_close(got, want, dtype):
    scale = max(w.float().abs().max().item() for w in want)
    err = max((g.float() - w.float()).abs().max().item()
              for g, w in zip(got, want))
    return err <= TOL_BWD[dtype] * scale, err, scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d, dv", LA.BWD_HEAD_DIM_PAIRS)
def test_cuda_local_attention_bwd_matches_plain(d, dv, dtype):
    """The backward kernels of the route ``bwd_route`` names (tensor
    cores for bf16 at (64, 64) to (256, 256) and MLA's (192, 128), CUDA
    cores otherwise) against ``local_attention_bwd_plain`` where their
    tiles have edges: S 37, 130, 200 and 513 (the CUDA cores' 32-row
    tiles, the tensor cores' 64), windows 1, 5, 33 and S, GQA groups 1
    and 4 over 2 kv heads, soft cap off and 50.0; one launch a call, and
    none of either forward kernel."""
    _needs_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(300 + d + dv)
    calls = 0
    for s in (37, 130, 200, 513):
        for group in (1, 4):
            q = _normal(rng, (2, s, 2 * group, d), dtype)
            k = _normal(rng, (2, s, 2, d), dtype)
            v = _normal(rng, (2, s, 2, dv), dtype)
            do = _normal(rng, (2, s, 2 * group, dv), dtype)
            for window in (1, 5, 33, s):
                for cap in (None, 50.0):
                    o = LA.grouped_local_attention_plain(
                        q, k, v, window=window, softcap=cap)
                    before = dict(LA.LAUNCHES)
                    got = LA.local_attention_bwd(q, k, v, o, do,
                                                 window=window, softcap=cap)
                    torch.cuda.synchronize()
                    launched = {n: LA.LAUNCHES[n] - before[n]
                                for n in before}
                    assert launched == {"local_attention": 0,
                                        "local_attention_f32": 0,
                                        "local_attention_bwd": 1}
                    want = LA.local_attention_bwd_plain(
                        q, k, v, o, do, window=window, softcap=cap)
                    ok, err, scale = _bwd_close(got, want, dtype)
                    assert ok, (s, group, window, cap, err, scale)
                    calls += 1
    assert calls == 4 * 2 * 4 * 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, s, window", [
    (torch.bfloat16, 2048, 2048), (torch.float32, 640, 512),
    (torch.float32, 640, 640)])
def test_cuda_local_attention_bwd_repeats_bitwise(dtype, s, window):
    """Two backward calls at a reduced gemma3-1b layer (B 1, 4 heads on 1
    kv head, D 256): bf16 at S 2048, window S (the tensor cores' cluster
    of two), and float32 at S 640, windows 512 and S (the 12-layer
    run's calls, where the CUDA cores split every tile's walk over a
    cluster): bit-equal dq, dk and dv (no atomics), each call one
    launch, within TOL_BWD of the plain version."""
    _needs_card()
    rng = np.random.default_rng(23)
    q, do = (_normal(rng, (1, s, 4, 256), dtype) for _ in range(2))
    k, v = (_normal(rng, (1, s, 1, 256), dtype) for _ in range(2))
    if dtype == torch.bfloat16:
        assert LA.bwd_route(q.dtype, 256) == "tensor_cores"
    else:
        assert LA.bwd_route(q.dtype, 256) == "cuda_cores"
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        tiles = -(-s // LA.BWD_CC_TILE)
        assert LA.bwd_cc_parts(tiles, sms) > 1  # dk / dv: one kv head
        assert LA.bwd_cc_parts(4 * tiles, sms) > 1  # stats, dq: 4 heads
    o = LA.grouped_local_attention(q, k, v, window=window)
    runs = []
    for _ in range(2):
        before = LA.LAUNCHES["local_attention_bwd"]
        runs.append(LA.local_attention_bwd(q, k, v, o, do, window=window))
        torch.cuda.synchronize()
        assert LA.LAUNCHES["local_attention_bwd"] == before + 1
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    want = LA.local_attention_bwd_plain(q, k, v, o, do, window=window)
    ok, err, scale = _bwd_close(runs[0], want, dtype)
    assert ok, (err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_local_attention_bwd_one_launch_a_call(dtype):
    """Every built head-dim pair, on either route: each call adds exactly
    one to ``LAUNCHES["local_attention_bwd"]`` and nothing else."""
    _needs_card()
    rng = np.random.default_rng(41)
    for d, dv in LA.BWD_HEAD_DIM_PAIRS:
        q, k = _normal(rng, (1, 96, 2, d), dtype), \
            _normal(rng, (1, 96, 1, d), dtype)
        v, do = _normal(rng, (1, 96, 1, dv), dtype), \
            _normal(rng, (1, 96, 2, dv), dtype)
        o = LA.grouped_local_attention_plain(q, k, v, window=40)
        for _ in range(2):
            before = dict(LA.LAUNCHES)
            LA.local_attention_bwd(q, k, v, o, do, window=40)
            torch.cuda.synchronize()
            assert {n: LA.LAUNCHES[n] - before[n] for n in before} == {
                "local_attention": 0, "local_attention_f32": 0,
                "local_attention_bwd": 1}, (d, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_local_attention_grad_through_kernels(dtype):
    """With grad enabled, the wrapper's output has a ``grad_fn``: one
    forward launch, and one backward launch whose dq, dk, dv equal the
    backward kernel's on the forward's output; run twice, the gradients
    are bit-equal (no atomics)."""
    _needs_card()
    rng = np.random.default_rng(11)
    q = _normal(rng, (2, 100, 4, 64), dtype).requires_grad_()
    k, v = (_normal(rng, (2, 100, 1, 64), dtype).requires_grad_()
            for _ in range(2))
    do = _normal(rng, (2, 100, 4, 64), dtype)
    fwd = "local_attention" if dtype == torch.bfloat16 else \
        "local_attention_f32"
    grads = []
    for _ in range(2):
        before = dict(LA.LAUNCHES)
        o = LA.grouped_local_attention(q, k, v, window=17, softcap=30.0)
        assert o.grad_fn is not None
        grads.append(torch.autograd.grad(o, (q, k, v), do))
        torch.cuda.synchronize()
        assert {n: LA.LAUNCHES[n] - before[n] for n in before} == {
            fwd: 1, "local_attention_bwd": 1,
            ("local_attention_f32" if fwd == "local_attention"
             else "local_attention"): 0}
    want = LA.local_attention_bwd(q.detach(), k.detach(), v.detach(),
                                  o.detach(), do, window=17, softcap=30.0)
    for a, b, c in zip(grads[0], grads[1], want):
        assert torch.equal(a, b) and torch.equal(a, c)
    with torch.no_grad():
        assert LA.grouped_local_attention(q, k, v, window=17).grad_fn is None


@pytest.mark.cuda
def test_cuda_attention_and_scan_raise_without_backward():
    """A CUDA call that needs a gradient the card cannot give raises
    before any launch: the attention at a (q/k, v) pair with no kernel,
    (64, 128) (the forward refuses it, and so does the backward), and the
    selective scan at a d_state its kernels are not built for."""
    from repro_torch.kernels import selective_scan as SS

    _needs_card()
    q = torch.zeros((1, 8, 2, 64), device="cuda", requires_grad=True)
    v = torch.zeros((1, 8, 2, 128), device="cuda")
    before = dict(LA.LAUNCHES)
    with pytest.raises(ValueError, match="not among"):
        LA.grouped_local_attention(q, q, v, window=4)
    with pytest.raises(RuntimeError, match="need a gradient"):
        LA.local_attention_bwd(q.detach(), q.detach(), v, v, v, window=4)
    assert LA.LAUNCHES == before
    ops = _scan_operands(np.random.default_rng(0), 1, 4, 8, 8, False)
    ops[1].requires_grad_()
    before = dict(SS.LAUNCHES)
    with pytest.raises(ValueError, match="d_state"):
        SS.selective_scan(*ops)
    dy = torch.zeros_like(ops[1])
    with pytest.raises(ValueError, match="d_state"):
        SS.selective_scan_bwd(*(t.detach() if t is not None else None
                                for t in ops[:6]), dy)
    assert SS.LAUNCHES == before


#: the scan's backward kernel against its plain version: each of the
#: seven gradients within SCAN_BWD_TOL times its largest |plain value|.
#: Both recompute the states op for op as the forward (the same bits);
#: the adjoint's and the gradients' sums run in other orders (the
#: kernel's with fused multiply-adds, dB and dC over blocks of 64
#: channels, dA and dD over batch rows), and exp may differ by an ulp.
SCAN_BWD_TOL = 1e-5


def _scan_bwd_case(SS, rng, bsz, s, dl, n, h0, dh_last):
    ops = _scan_operands(rng, bsz, s, dl, n, h0)
    dy = torch.from_numpy(rng.standard_normal((bsz, s, dl)).astype(
        np.float32)).cuda()
    dhl = (torch.from_numpy(rng.standard_normal((bsz, dl, n)).astype(
        np.float32)).cuda() if dh_last else None)
    before = SS.LAUNCHES["selective_scan_bwd"]
    got = SS.selective_scan_bwd(*ops[:6], dy, dhl, ops[6])
    torch.cuda.synchronize()
    assert SS.LAUNCHES["selective_scan_bwd"] == before + 1
    want = SS.selective_scan_bwd_plain(*ops[:6], dy, dhl, ops[6])
    for name, g, w in zip(("ddt", "dx", "dB", "dC", "dA", "dD", "dh0"), got,
                          want):
        assert g.shape == w.shape, name
        err = (g - w).abs().max().item()
        scale = w.abs().max().item()
        assert err <= SCAN_BWD_TOL * scale, (name, bsz, s, dl, n, err, scale)
    return ops, dy, dhl, got


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 16])
@pytest.mark.parametrize("bsz", [1, 3])
def test_cuda_selective_scan_bwd_matches_plain(n, bsz):
    """S across the kernel's 4-step runs and the plain version's 128-step
    chunks (1, 15, 16, 17, 2049), d_inner a multiple and a non-multiple
    of the 64-channel blocks and of 4 (4-byte copies), with and without
    h0 and dh_last; one launch a call."""
    from repro_torch.kernels import selective_scan as SS

    _needs_card()
    rng = np.random.default_rng(10 * n + bsz)
    for s, dl in ((1, 128), (15, 200), (16, 64), (17, 130), (2049, 256),
                  (37, 5)):
        for h0, dh_last in ((False, False), (True, True), (False, True)):
            _scan_bwd_case(SS, rng, bsz, s, dl, n, h0, dh_last)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 16])
def test_cuda_selective_scan_bwd_design_edges(n):
    """The walk's boundaries: S at its run length and one either side
    (3, 4, 5) and one past two runs (9); d_inner not a multiple of its
    64-channel blocks (100, 130) nor of its 2-channel lanes (5); and a
    grid of more blocks than the card holds at once (more than one wave,
    d_inner 8192), with and without h0 and dh_last."""
    from repro_torch.kernels import selective_scan as SS

    _needs_card()
    rng = np.random.default_rng(20 + n)
    for s in (SS.BWD_RUN_STEPS - 1, SS.BWD_RUN_STEPS, SS.BWD_RUN_STEPS + 1,
              2 * SS.BWD_RUN_STEPS + 1):
        for dl in (100, 130, 5):
            for h0, dh_last in ((False, False), (True, True)):
                _scan_bwd_case(SS, rng, 2, s, dl, n, h0, dh_last)
    occ = SS.bwd_occupancy(n)
    slots = occ["per_sm"] * torch.cuda.get_device_properties(
        0).multi_processor_count
    bsz = slots // (8192 // SS.BLOCK_CHANNELS) + 1
    assert bsz * 8192 // SS.BLOCK_CHANNELS > slots
    _scan_bwd_case(SS, rng, bsz, 2 * SS.BWD_RUN_STEPS + 1, 8192, n, True,
                   True)


@pytest.mark.cuda
def test_cuda_selective_scan_bwd_geometry_matches_card():
    """The walk's launch as the card reports it is the design's: at
    d_state 16 no spills within the register budget, 128 threads and 4
    resident blocks an SM, and falcon-mamba-7b's call (batch 4, d_inner
    8192) in one wave to within 10%."""
    from repro_torch.kernels import selective_scan as SS

    _needs_card()
    occ = SS.bwd_occupancy(16)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    geo = SS.bwd_geometry(4, 8192, 16, sms=sms)
    assert occ["spill_bytes"] == 0
    assert occ["regs"] <= geo["regs"]
    assert (occ["threads"], occ["per_sm"]) == (geo["threads"], geo["per_sm"])
    waves = geo["blocks"] / (occ["per_sm"] * sms)
    assert abs(waves - round(waves)) <= 0.1 * max(round(waves), 1)


@pytest.mark.cuda
def test_cuda_selective_scan_bwd_repeats_bitwise():
    """Two calls on the same inputs give the same bits (no atomics: the
    cross-channel and cross-row sums run in a fixed order)."""
    from repro_torch.kernels import selective_scan as SS

    _needs_card()
    ops, dy, dhl, first = _scan_bwd_case(SS, np.random.default_rng(3), 3,
                                         300, 8192, 16, True, True)
    again = SS.selective_scan_bwd(*ops[:6], dy, dhl, ops[6])
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 16])
def test_cuda_selective_scan_grad_through_kernels(n):
    """Autograd through the scan on the card: one forward launch, one
    backward launch, the kernel's gradients; no plain version runs.
    Under no grad the call launches the forward alone and carries no
    gradient."""
    from repro_torch.kernels import selective_scan as SS

    _needs_card()
    ops = _scan_operands(np.random.default_rng(n), 2, 70, 96, n, False)
    leaves = [t.clone().requires_grad_() for t in ops[:6]]
    dy = torch.randn((2, 70, 96), device="cuda")
    before = dict(SS.LAUNCHES)
    y, h = SS.selective_scan(*leaves)
    grads = torch.autograd.grad(y, leaves, dy)
    torch.cuda.synchronize()
    assert SS.LAUNCHES == {"selective_scan": before["selective_scan"] + 1,
                           "selective_scan_bwd":
                               before["selective_scan_bwd"] + 1}
    want = SS.selective_scan_bwd(*ops[:6], dy)
    for a, b in zip(grads, want):
        assert torch.equal(a, b)
    with torch.no_grad():
        assert SS.selective_scan(*leaves)[0].grad_fn is None


@pytest.mark.cuda
def test_cuda_moe_backward_repeats_bitwise():
    """The MoE block's backward at granite's published width (1536, 40
    experts top-8 of 512, bfloat16) on 4 x 512 tokens, twice on the same
    inputs: every gradient the same bits (the dispatch and the combine
    go back through gathers, not atomic scatter-adds)."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as M
    from repro_torch.models.common import ShardingPlan

    _needs_card()
    cfg = get_config("granite-moe-3b-a800m")
    plan = ShardingPlan.for_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = M.init_moe(gen, cfg, plan, torch.bfloat16)
    x = torch.randn((4, 512, cfg.d_model), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    dout = torch.randn(x.shape, generator=gen, device="cuda",
                       dtype=torch.bfloat16)

    def grads():
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        xs = x.detach().requires_grad_()
        out, aux = M.moe_forward(leaves, xs, cfg, plan)
        return torch.autograd.grad((out.float() * dout.float()).sum()
                                   + aux, [xs, *leaves.values()])

    first, again = grads(), grads()
    assert M.dropped_pairs(params, x, cfg, plan)[1] == M.capacity(
        x.shape[0] * x.shape[1], cfg, plan)
    for a, b in zip(first, again):
        assert torch.isfinite(a).all() and torch.equal(a, b)