"""The tensor-core attention backward's tile walks and its route, on the
CPU (no ``jax``; the kernels themselves run only on the card, in
``tests/test_torch_cuda.py``).

``kernels/local_attention.py::bwd_tile_schedule`` mirrors the walks of
``csrc/local_attention_bwd.cu`` (``tcb``): ``tc_stats`` and ``tc_dq``
visit, per query tile, the key tiles of its rows' windows; ``tc_dkdv``
visits, per key tile, each head of the group over the query tiles whose
rows reach the keys, split over a cluster of two blocks on a (near)
full causal layer that fits one wave (``dkdv_parts``).  Each walk must
visit every unmasked (row, key) pair exactly once, and no tile that
holds none.  ``bwd_route`` is the one place that chooses the kernels of
a backward call.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import local_attention as LA  # noqa: E402

TILE = LA.BWD_TC_TILE


def _tile_pairs(s, window):
    """Unmasked (row, key) pairs in each (query tile, key tile), by brute
    force over the (S, S) mask."""
    n = -(-s // TILE)
    i = np.arange(n * TILE)[:, None]
    j = np.arange(n * TILE)[None, :]
    keep = (j <= i) & (i - j < window) & (i < s)
    return keep.reshape(n, TILE, n, TILE).sum(axis=(1, 3))


@pytest.mark.parametrize("parts", [1, 2])
@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("window", [1, 65, 513, None])
@pytest.mark.parametrize("s", [37, 777, 2049])
def test_bwd_walks_visit_every_unmasked_pair_once(s, window, group, parts):
    window = s if window is None else min(window, s)
    pairs = _tile_pairs(s, window)
    live = {(int(qt), int(kt)) for qt, kt in zip(*np.nonzero(pairs))}
    sched = LA.bwd_tile_schedule(s, window, group, parts)
    # the row walk (tc_stats, tc_dq): each live tile once, no dead one
    assert len(sched.rows) == len(set(sched.rows))
    assert set(sched.rows) == live
    assert sum(int(pairs[t]) for t in sched.rows) == (
        window * (window + 1) // 2 + (s - window) * window)
    # launch order: query tiles in reverse, each block's key tiles in order
    assert [qt for qt, _ in sched.rows] == sorted(
        (qt for qt, _ in sched.rows), reverse=True)
    assert all(a[1] < b[1] for a, b in zip(sched.rows, sched.rows[1:])
               if a[0] == b[0])
    # the key walk (tc_dkdv): each live tile once per head of the group,
    # in one block of the key tile's cluster
    steps_of = [(kt, gi, qt) for kt, _, gi, qt in sched.keys]
    assert len(steps_of) == len(set(steps_of))
    assert set(steps_of) == {(kt, gi, qt) for qt, kt in live
                             for gi in range(group)}
    # the cluster's blocks walk consecutive shares (block 0 the first),
    # each its heads in order and each head's query tiles in order, and
    # block 0 adds block 1's sum to its own: the group's sum has one
    # fixed order
    for kt in range(-(-s // TILE)):
        walk = [(part, gi, qt) for k, part, gi, qt in sched.keys if k == kt]
        assert walk == sorted(walk)
        assert [w[1:] for w in walk] == sorted(w[1:] for w in walk)
        shares = [sum(1 for w in walk if w[0] == part)
                  for part in range(parts)]
        assert max(shares) - min(shares) <= 1
    # full tiles: every pair unmasked, all rows below S
    assert sched.full == sum(pairs[t] == TILE * TILE for t in sched.rows)
    assert sched.full + sched.partial == len(sched.rows)


def test_bwd_walks_at_gemma3_shapes():
    """gemma3-1b's training calls (batch 4, S 2048, 4 heads on 1 kv
    head): a local layer's key tile walks 4 x 9 query tiles (the last 8
    keys' window ends in the ninth) in one block; a global layer's first
    key tile all 4 x 32, split over a cluster of two blocks."""
    blocks = 4 * 1 * 32  # batch x kv heads x key tiles: one wave of 132
    assert LA.dkdv_parts(blocks, 132, 2048, 512) == 1
    assert LA.dkdv_parts(blocks, 132, 2048, 2048) == 2
    assert LA.dkdv_parts(4 * blocks, 132, 2048, 2048) == 1
    local = LA.bwd_tile_schedule(2048, 512, 4, 1)
    glob = LA.bwd_tile_schedule(2048, 2048, 4, 2)
    assert sum(1 for kt, *_ in local.keys if kt == 0) == 4 * 9
    # the global layer's first key tile: 4 x 32 steps, 64 a block
    assert [sum(1 for kt, part, *_ in glob.keys if kt == 0 and part == p)
            for p in (0, 1)] == [64, 64]
    assert [sum(1 for kt, part, *_ in glob.keys if kt == 31 and part == p)
            for p in (0, 1)] == [2, 2]
    assert len(glob.rows) == 32 * 33 // 2
    assert glob.partial == 32 and local.partial == 2 * 32 - 8


@pytest.mark.parametrize("d", LA.BWD_HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_route_by_dtype_and_head_dim(dtype, d):
    want = ("tensor_cores" if dtype == torch.bfloat16
            and d in (64, 128, 256) else "cuda_cores")
    assert LA.bwd_route(dtype, d) == want
    assert LA.bwd_route(dtype, d, d) == want
    assert set(LA.BWD_KERNELS) == {"tensor_cores", "cuda_cores"}


@pytest.mark.parametrize("dqk, dv", [(192, 128), (32, 32), (64, 128)])
def test_bwd_route_raises_without_a_backward(dqk, dv):
    before = dict(LA.LAUNCHES)
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(RuntimeError, match="item 16"):
            LA.bwd_route(dtype, dqk, dv)
    assert LA.LAUNCHES == before


def test_bwd_plain_on_cpu_counts_no_launch():
    """On CPU tensors the wrapper computes the plain version: the same
    gradients, no launch counted, at a bf16 tensor-core head dim."""
    rng = np.random.default_rng(5)

    def t(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(torch.bfloat16)
    q, k, v, do = t((1, 70, 4, 64)), t((1, 70, 1, 64)), t((1, 70, 1, 64)), \
        t((1, 70, 4, 64))
    o = LA.grouped_local_attention_plain(q, k, v, window=33)
    before = dict(LA.LAUNCHES)
    got = LA.local_attention_bwd(q, k, v, o, do, window=33)
    want = LA.local_attention_bwd_plain(q, k, v, o, do, window=33)
    assert LA.LAUNCHES == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
