"""The CIM kernel's tile plan and weight layout, checked on the CPU.

``plan_blocks`` below mirrors how the CUDA kernel
(``csrc/cim_matmul.cu``) splits a call into blocks under
``kernels/cim_matmul.py::launch_plan``'s plan: 64 weight columns by
``rows`` x rows by a slice of the steps, and each block's share of its
cluster's reduction.  Brute-force coverage counts hold it to "every
(row, column, step) multiplied exactly once, every output stored exactly
once" on the main path's 14 calls (one 4-frame vgg11-cifar10 batch) and
on random shapes and forced plans.  The kernel itself is held to its
plain version on the card (``tests/test_torch_cuda.py``, whose split
test shows that no plan changes a code).

The engine stores weights K-major, the layout the kernel reads; its
``w8_stack`` / ``w8`` views must equal the reference's handles, the
plain version must give the same codes on those views, and the wrapper
must copy no weight on the CPU.  Tolerance: equal by value (exact
integer dots and the same float32 conversion on both sides).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import engine as RE  # noqa: E402
from repro.core.cim import CIMSpec as RSpec  # noqa: E402
from repro.core.schedule import compile_conv_block as r_compile  # noqa: E402
from repro_torch.convert import copy_calibration  # noqa: E402
from repro_torch.core import engine as PE  # noqa: E402
from repro_torch.core.cim import CIMSpec  # noqa: E402
from repro_torch.core.schedule import compile_conv_block as p_compile  # noqa: E402
from repro_torch.kernels import cim_matmul as K  # noqa: E402

#: (T, R, N) of the 14 kernel calls of one 4-frame vgg11-cifar10 batch:
#: 8 conv layers (3-D layout), then 4 FC tiles of fc1 and 2 of fc2
MAIN_PATH = [(3, 4096, 64), (3, 1024, 128), (6, 256, 256), (9, 256, 256),
             (9, 64, 512), (18, 64, 512), (18, 16, 512), (18, 16, 512),
             (1, 4, 256), (1, 4, 256), (1, 4, 256), (1, 4, 256),
             (1, 4, 10), (1, 4, 10)]


def step_slice(t, slices, z):
    """Steps [t0, t1) of slice ``z`` (empty when slices > t): the
    kernel's ``t0`` / ``t1``."""
    return z * t // slices, (z + 1) * t // slices


def plan_blocks(plan, t, r, n):
    """Every block of the launch, as the kernel computes it:
    ``((bx, by, bz), rows, cols, steps, owned)`` with ``rows``,
    ``cols`` and ``steps`` the ranges the block multiplies and
    ``owned`` the (row, col) pairs of its tile it reduces and stores:
    its share of the cluster's reduction, 4-column groups ``[bz G / S,
    (bz + 1) G / S)`` of the tile's G, bounds applied."""
    groups = plan.rows * K.COLS // 4
    per_row = K.COLS // 4
    for bx in range(-(-n // K.COLS)):
        for by in range(-(-r // plan.rows)):
            r0, n0 = by * plan.rows, bx * K.COLS
            for bz in range(plan.slices):
                owned = [(r0 + i // per_row, n0 + i % per_row * 4 + j)
                         for i in range(bz * groups // plan.slices,
                                        (bz + 1) * groups // plan.slices)
                         for j in range(4)
                         if r0 + i // per_row < r
                         and n0 + i % per_row * 4 + j < n]
                yield ((bx, by, bz), range(r0, min(r, r0 + plan.rows)),
                       range(n0, min(n, n0 + K.COLS)),
                       range(*step_slice(t, plan.slices, bz)), owned)


def _coverage(plan, t, r, n):
    """(times each (row, col, step) is multiplied, times each (row, col)
    is stored, block count)."""
    mult = np.zeros((r, n, t), np.int64)
    stored = np.zeros((r, n), np.int64)
    blocks = 0
    for _, rows, cols, steps, owned in plan_blocks(plan, t, r, n):
        blocks += 1
        mult[rows.start:rows.stop, cols.start:cols.stop,
             steps.start:steps.stop] += 1
        for i, j in owned:
            stored[i, j] += 1
    return mult, stored, blocks


@pytest.mark.parametrize("call", range(len(MAIN_PATH)),
                         ids=[f"call{i + 1}" for i in range(len(MAIN_PATH))])
def test_main_path_plan_covers_once(call):
    t, r, n = MAIN_PATH[call]
    plan = K.launch_plan(t, r, n)
    assert plan.rows in K.ROW_TILES and 1 <= plan.slices <= K.MAX_SLICES
    mult, stored, blocks = _coverage(plan, t, r, n)
    assert (mult == 1).all() and (stored == 1).all()
    if 2 <= call <= 7:  # conv calls 3-8: at least 48 blocks (8-16 before)
        assert blocks >= 48


def test_random_shapes_and_plans_cover_once():
    """Shapes the main path does not make, and forced plans, slices
    above T included (empty slices)."""
    rng = np.random.default_rng(0)
    for _ in range(60):
        t = int(rng.integers(1, 41))
        r = int(rng.integers(1, 300))
        n = int(rng.integers(1, 200))
        for plan in (K.launch_plan(t, r, n),
                     K.Plan(int(rng.choice(K.ROW_TILES)),
                            int(rng.integers(1, K.MAX_SLICES + 1)))):
            mult, stored, _ = _coverage(plan, t, r, n)
            assert (mult == 1).all() and (stored == 1).all(), (t, r, n, plan)


@pytest.mark.parametrize("rows", K.ROW_TILES)
def test_push_owner_matches_owned_groups(rows):
    """The kernel pushes group ``idx`` to block ``((idx + 1) S - 1) / G``,
    slot ``idx - owner G / S`` (csrc/cim_matmul.cu); that block's owned
    range must hold it, and slots must stay inside the receive buffer."""
    groups = rows * K.COLS // 4
    for s in range(1, K.MAX_SLICES + 1):
        cap = -(-groups // s)
        for idx in range(groups):
            owner = ((idx + 1) * s - 1) // groups
            slot = idx - owner * groups // s
            assert owner * groups // s <= idx < (owner + 1) * groups // s
            assert 0 <= slot < cap
        assert s * cap <= groups + K.MAX_SLICES


def _engines(n_c, name):
    spec = RSpec(n_c=n_c, gain=9.0)
    ref = RE.CIMEngine(spec)
    ref.set_layer(name, a_scale=0.05, gain=9.0)
    port = PE.CIMEngine(CIMSpec(**dataclasses.asdict(spec)), device="cpu")
    return ref, copy_calibration(ref, port)


@pytest.mark.parametrize("geom", [
    dict(h=6, w=6, c_in=3, c_out=20, k=3, stride=1, pad=1, pack=3,
         c_splits=1),
    dict(h=4, w=4, c_in=130, c_out=24, k=3, stride=1, pad=1, pack=1,
         c_splits=2)], ids=["packed", "split"])
def test_conv_handle_is_k_major(geom):
    """(T, max kc, M) view of a contiguous K-major (T, M, kc padded to
    16) tensor, equal to the reference's w8_stack."""
    n_c = 256 if geom["c_splits"] == 1 else 96
    ref, port = _engines(n_c, "L")
    rng = np.random.default_rng(geom["c_in"])
    w = rng.standard_normal((geom["k"], geom["k"], geom["c_in"],
                             geom["c_out"]))
    rh = ref.conv_handle("L", w, RE.conv_tile_slices(
        r_compile("L", **geom, activation="relu")))
    ph = port.conv_handle("L", torch.from_numpy(w), PE.conv_tile_slices(
        p_compile("L", **geom, activation="relu")))
    ws = ph.w8_stack
    assert tuple(ws.shape) == rh.w8_stack.shape
    assert ws.stride(1) == 1
    assert ws.stride(2) % 16 == 0 and ws.stride(2) >= ws.shape[1]
    assert ws.stride(0) == ws.stride(2) * ws.shape[2]
    np.testing.assert_array_equal(ws.numpy(), rh.w8_stack)


@pytest.mark.parametrize("k", [300, 512])
def test_fc_handle_is_k_major(k):
    """w8 is the (K, N) view of a contiguous (N, K) tensor, equal to the
    reference's; every grid tile's slice stays K-major."""
    ref, port = _engines(96, "fc")
    w = np.random.default_rng(k).standard_normal((k, 40)) / 10
    rh, ph = ref.fc_handle("fc", w), port.fc_handle("fc", torch.from_numpy(w))
    assert ph.w8.stride() == (1, k) and ph.w8.T.is_contiguous()
    np.testing.assert_array_equal(ph.w8.numpy(), rh.w8)
    assert ph.w8[96:192, 8:40].stride(0) == 1


def _ints(rng, shape):
    return torch.from_numpy(rng.integers(-128, 128, shape).astype(np.int8))


def _table(rng, t, spec):
    inv = np.float32(spec.adc_inv_step) * (1 + 0.02 * rng.standard_normal(t))
    off = 0.5 * rng.standard_normal(t)
    return torch.from_numpy(np.stack([inv, off], 1).astype(np.float32))


@pytest.mark.parametrize("n_c", [32, 96, 256])
def test_plain_on_k_major_views(n_c):
    """The plain version gives the same codes on K-major views as on
    N-major copies: 3-D stacks and strided 2-D FC slices with a ragged
    last step, both ADC flavors, both output modes."""
    rng = np.random.default_rng(n_c)
    spec = CIMSpec(n_c=n_c)
    k = 2 * n_c + 11
    store = _ints(rng, (90, k + 20))          # K-major (N, K) FC store
    cases = [(_ints(rng, (5, 37, n_c - 3)),
              _ints(rng, (5, 77, n_c - 3)).transpose(1, 2)),
             (_ints(rng, (13, k + 9))[:, 9:], store[5:82, 20:].T)]
    for x, w in cases:
        assert w.stride(-2) == 1 and not w.is_contiguous()
        t = x.shape[0] if x.dim() == 3 else -(-x.shape[1] // n_c)
        for adc in (None, _table(rng, t, spec)):
            for emit in (True, False):
                a = K.cim_codes_plain(x, w, spec, adc=adc, emit_codes=emit)
                b = K.cim_codes_plain(x, w.contiguous(), spec, adc=adc,
                                      emit_codes=emit)
                assert torch.equal(a + 0.0, b + 0.0)


def test_cpu_wrapper_makes_no_weight_copy():
    """On a CPU tensor the wrapper computes the plain version as it
    stands: N-major and K-major weights alike, no copy counted."""
    rng = np.random.default_rng(5)
    spec = CIMSpec(n_c=96)
    x, w = _ints(rng, (4, 21, 70)), _ints(rng, (4, 70, 33))
    before = K.WEIGHT_COPIES
    for wl in (w, w.transpose(1, 2).contiguous().transpose(1, 2)):
        got = K.cim_codes(x, wl, spec)
        assert torch.equal(got, K.cim_codes_plain(x, w, spec))
    assert K.WEIGHT_COPIES == before
