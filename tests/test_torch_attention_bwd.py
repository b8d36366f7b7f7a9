"""The attention backward's tile walks and its route, on the CPU (no
``jax``; the kernels themselves run only on the card, in
``tests/test_torch_cuda.py``).

``kernels/local_attention.py`` mirrors the walks of both routes of
``csrc/local_attention_bwd.cu``.  The tensor cores (``tcb``,
``bwd_tile_schedule``, 64-row tiles): ``tc_stats`` and ``tc_dq`` visit,
per query tile, the key tiles of its rows' windows; ``tc_dkdv`` visits,
per key tile, each head of the group over the query tiles whose rows
reach the keys, split over a cluster of two blocks on a (near) full
causal layer that fits one wave (``dkdv_parts``).  The CUDA cores
(``simt``, ``bwd_cc_schedule``, 32-row tiles) walk the same way, each
tile's walk split over a cluster of up to 8 blocks while the grid
leaves SMs idle (``bwd_cc_parts``), the partial sums added in block
order, and the tiles dealt to the clusters heaviest first
(``bwd_cc_deal``).  Each walk must visit every unmasked (row, key)
pair exactly once, and no tile that holds none; the CUDA-core walks,
written out in PyTorch on the CPU with their cluster sums, give the
plain version's gradient.  ``bwd_route`` is the one place that chooses
the kernels of a backward call.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import local_attention as LA  # noqa: E402

TILE = LA.BWD_TC_TILE
ROUTE_TILE = {"tensor_cores": LA.BWD_TC_TILE, "cuda_cores": LA.BWD_CC_TILE}


@functools.lru_cache(maxsize=None)
def _tile_pairs(s, window, tile=TILE):
    """Unmasked (row, key) pairs in each (query tile, key tile), by brute
    force over the (S, S) mask."""
    n = -(-s // tile)
    i = np.arange(n * tile)[:, None]
    j = np.arange(n * tile)[None, :]
    keep = (j <= i) & (i - j < window) & (i < s)
    return keep.reshape(n, tile, n, tile).sum(axis=(1, 3))


def _walks(route, s, window, group, parts):
    """(row walk as (query tile, block, key tile), key walk as (key tile,
    block, head, query tile), full, partial) of a route's mirror; the
    tensor cores' row walks take one block a query tile."""
    if route == "tensor_cores":
        sched = LA.bwd_tile_schedule(s, window, group, parts)
        rows = [(qt, 0, kt) for qt, kt in sched.rows]
        return rows, sched.keys, sched.full, sched.partial
    sched = LA.bwd_cc_schedule(s, window, group, parts, parts)
    # cc_stats walks what cc_dq walks, its teams taking turns in a block
    assert [(qt, part, kt) for qt, part, _, kt in sched.stats] == sched.dq
    for qt, part in {(qt, part) for qt, part, *_ in sched.stats}:
        teams = [team for q, p, team, _ in sched.stats
                 if (q, p) == (qt, part)]
        assert teams == [i % 2 for i in range(len(teams))]
    return sched.dq, sched.keys, sched.full, sched.partial


@pytest.mark.parametrize("parts", [1, 2])
@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("window", [1, 65, 513, None])
@pytest.mark.parametrize("s", [37, 777, 2049])
def test_bwd_walks_visit_every_unmasked_pair_once(s, window, group, parts):
    _check_walks("tensor_cores", s, window, group, parts)


@pytest.mark.parametrize("parts", [1, 2, 7, 8])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("window", [1, 65, 513, None])
@pytest.mark.parametrize("s", [37, 640, 2049])
def test_bwd_cc_walks_visit_every_unmasked_pair_once(s, window, group, parts):
    _check_walks("cuda_cores", s, window, group, parts)


def _check_shares(walk, parts, in_block_order=False):
    """A tile's walk as (block, step) in listing order: listed block by
    block, each block's steps in order and a consecutive run of the
    whole walk, the runs' lengths within one of each other; with
    ``in_block_order`` block 0's run first, then block 1's, ..."""
    assert walk == sorted(walk)
    steps = sorted(step for _, step in walk)
    if in_block_order:
        assert [step for _, step in walk] == steps
    runs = [[step for p, step in walk if p == part] for part in range(parts)]
    for run in runs:
        if run:
            at = steps.index(run[0])
            assert steps[at:at + len(run)] == run
    assert max(map(len, runs)) - min(map(len, runs)) <= 1


def _check_walks(route, s, window, group, parts):
    tile = ROUTE_TILE[route]
    window = s if window is None else min(window, s)
    pairs = _tile_pairs(s, window, tile)
    live = {(int(qt), int(kt)) for qt, kt in zip(*np.nonzero(pairs))}
    rows, keys, full, partial = _walks(route, s, window, group, parts)
    # the row walk (stats, dq): each live tile once, no dead one
    tiles = [(qt, kt) for qt, _, kt in rows]
    assert len(tiles) == len(set(tiles))
    assert set(tiles) == live
    assert sum(int(pairs[t]) for t in tiles) == (
        window * (window + 1) // 2 + (s - window) * window)
    # launch order: query tiles in reverse; a query tile's cluster walks
    # its key tiles in order, each block a consecutive share
    assert [qt for qt, *_ in rows] == sorted((qt for qt, *_ in rows),
                                             reverse=True)
    row_parts = parts if route == "cuda_cores" else 1
    for qt in {qt for qt, *_ in rows}:
        _check_shares([(part, kt) for q, part, kt in rows if q == qt],
                      row_parts)
    # the key walk (dkdv): each live tile once per head of the group,
    # in one block of the key tile's cluster
    steps_of = [(kt, gi, qt) for kt, _, gi, qt in keys]
    assert len(steps_of) == len(set(steps_of))
    assert set(steps_of) == {(kt, gi, qt) for qt, kt in live
                             for gi in range(group)}
    # the cluster's blocks walk consecutive shares, each its heads in
    # order and each head's query tiles in order, and the shares' sums
    # are added in block order: the group's sum has one fixed order
    for kt in range(-(-s // tile)):
        _check_shares([(part, (gi, qt)) for k, part, gi, qt in keys
                       if k == kt], parts, route == "tensor_cores")
    # full tiles: every pair unmasked, all rows below S
    assert full == sum(pairs[t] == tile * tile for t in set(tiles))
    assert full + partial == len(set(tiles))


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


@pytest.mark.parametrize("d, dv", [(16, 16), (64, 64), (128, 128),
                                   (256, 256), (192, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_route_by_dtype_and_head_dim(dtype, d, dv):
    """bf16 on the tensor cores at (64, 64) to (256, 256) and MLA's
    (192, 128); float32 at every pair and bf16 at (16, 16) on the CUDA
    cores."""
    want = ("tensor_cores" if dtype == torch.bfloat16 and d >= 64
            else "cuda_cores")
    assert LA.bwd_route(dtype, d, dv) == want
    if d == dv:
        assert LA.bwd_route(dtype, d) == want
    assert (d, dv) in LA.BWD_HEAD_DIM_PAIRS
    assert set(LA.BWD_KERNELS) == {"tensor_cores", "cuda_cores"}


@pytest.mark.parametrize("dqk, dv", [(32, 32), (64, 128)])
def test_bwd_route_raises_without_a_backward(dqk, dv):
    before = dict(LA.LAUNCHES)
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(RuntimeError, match="need a gradient"):
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


def _cc_walk_gradients(q, k, v, o, do, window, softcap, row_parts,
                       key_parts):
    """The CUDA-core route's arithmetic along ``bwd_cc_schedule``'s walks,
    in float32 PyTorch, 32 x 32 tiles: each block sums its share of a
    tile's walk in order, and the cluster's block sums are added in
    block order (block 0's first); lse from each block's running max
    and sum, merged in block order.  Returns (dq, dk, dv, lse)."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    group, tile = h // kv, LA.BWD_CC_TILE
    window = min(window, s)
    n = -(-s // tile)

    def sched(seq, seqs):  # the walks of one sequence among seqs
        return LA.bwd_cc_schedule(s, window, group, row_parts, key_parts,
                                  seq, seqs)

    def padded(x):  # rows past S are zeros, as the kernels copy them
        x = x.float()
        return torch.cat([x, x.new_zeros((b, n * tile - s) + x.shape[2:])], 1)

    qp, kp, vp, dop = (padded(x) for x in (q, k, v, do))
    delta = (padded(do) * padded(o)).sum(-1)                 # (B, S', H)
    pos = torch.arange(n * tile)
    rows = lambda t: slice(t * tile, (t + 1) * tile)  # noqa: E731

    def tile_scores(bi, head, qt, kt):
        x = qp[bi, rows(qt), head] @ kp[bi, rows(kt), head // group].T
        x = x * d ** -0.5
        t = None
        if softcap is not None:
            t = torch.tanh(x / softcap)
            x = t * softcap
        i, j = pos[rows(qt), None], pos[None, rows(kt)]
        return x, t, (j <= i) & (i - j < window) & (i < s)

    lse = torch.zeros(b, n * tile, h)
    for bi in range(b):
        for head in range(h):
            walks = sched(bi * h + head, b * h).dq
            for qt in range(n):
                parts = []
                for part in range(row_parts):
                    m = torch.full((tile,), -torch.inf)
                    l_ = torch.zeros(tile)
                    for _, _, kt in (w for w in walks
                                     if w[:2] == (qt, part)):
                        x, _, keep = tile_scores(bi, head, qt, kt)
                        x = torch.where(keep, x, -torch.inf)
                        mx = torch.maximum(m, x.max(1).values)
                        seen = mx > -torch.inf
                        l_ = torch.where(seen, l_ * torch.exp(m - mx)
                                         + torch.exp(x - mx[:, None]).sum(1),
                                         l_)
                        m = torch.where(seen, mx, m)
                    parts.append((m, l_))
                m, l_ = parts[0]
                for m2, l2 in parts[1:]:  # block order
                    mx = torch.maximum(m, m2)
                    l_ = torch.where(mx > -torch.inf, l_ * torch.exp(m - mx)
                                     + l2 * torch.exp(m2 - mx), l_)
                    m = mx
                lse[bi, rows(qt), head] = torch.where(
                    pos[rows(qt)] < s, m + torch.log(l_), 0.0)

    def p_ds(bi, head, qt, kt):
        x, t, keep = tile_scores(bi, head, qt, kt)
        p = torch.exp(x - lse[bi, rows(qt), head, None])
        dp = dop[bi, rows(qt), head] @ vp[bi, rows(kt), head // group].T
        ds = p * (dp - delta[bi, rows(qt), head, None])
        if t is not None:
            ds = ds * (1.0 - t * t)
        ds = ds * d ** -0.5
        p = torch.where(keep, p, 0.0).to(v.dtype).float()
        return p, torch.where(keep, ds, 0.0)

    dq, dk, dv = (torch.zeros_like(x) for x in (qp, kp, vp))
    for bi in range(b):
        for kvh in range(kv):
            walks = sched(bi * kv + kvh, b * kv).keys
            for kt in range(n):
                sums = []
                for part in range(key_parts):
                    sk = torch.zeros(tile, d)
                    sv = torch.zeros(tile, v.shape[3])
                    for _, _, gi, qt in (w for w in walks
                                         if w[:2] == (kt, part)):
                        head = kvh * group + gi
                        p, ds = p_ds(bi, head, qt, kt)
                        sv = sv + p.T @ dop[bi, rows(qt), head]
                        sk = sk + ds.T @ qp[bi, rows(qt), head]
                    sums.append((sk, sv))
                sk, sv = sums[0]
                for sk2, sv2 in sums[1:]:  # block order
                    sk, sv = sk + sk2, sv + sv2
                dk[bi, rows(kt), kvh], dv[bi, rows(kt), kvh] = sk, sv
        for head in range(h):
            walks = sched(bi * h + head, b * h).dq
            for qt in range(n):
                sums = []
                for part in range(row_parts):
                    acc = torch.zeros(tile, d)
                    for _, _, kt in (w for w in walks
                                     if w[:2] == (qt, part)):
                        _, ds = p_ds(bi, head, qt, kt)
                        acc = acc + ds @ kp[bi, rows(kt), head // group]
                    sums.append(acc)
                acc = sums[0]
                for acc2 in sums[1:]:  # block order
                    acc = acc + acc2
                dq[bi, rows(qt), head] = acc
    return (dq[:, :s].to(q.dtype), dk[:, :s].to(k.dtype),
            dv[:, :s].to(v.dtype), lse[:, :s].permute(0, 2, 1))


@pytest.mark.parametrize("dims", [(16, 16), (24, 16)])
@pytest.mark.parametrize("parts", [(1, 1), (2, 7), (3, 8)])
@pytest.mark.parametrize("cap", [None, 30.0])
@pytest.mark.parametrize("window", [5, 40, None])
def test_bwd_cc_walks_give_the_plain_gradient(window, cap, parts, dims):
    """The CUDA-core walks, split over clusters of ``parts`` (stats and
    dq, dk / dv) blocks whose sums are added in block order, give the
    plain version's lse, dq, dk and dv (float32 on the CPU, other
    summation orders: within 1e-5 of each one's largest value), at a
    ragged S of 70 (three tiles, the last 6 rows deep; blocks of a
    cluster of 7 or 8 with no step), 4 heads on 2 kv heads, at the
    (q/k, v) pairs (16, 16) and the reduced MLA's (24, 16)."""
    rng = np.random.default_rng(24)
    s = 70
    window = s if window is None else window
    d, dv = dims

    def t(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))
    q, do = t((1, s, 4, d)), t((1, s, 4, dv))
    k, v = t((1, s, 2, d)), t((1, s, 2, dv))
    o = LA.grouped_local_attention_plain(q, k, v, window=window, softcap=cap)
    *got, lse = _cc_walk_gradients(q, k, v, o, do, window, cap, *parts)
    want = LA.local_attention_bwd_plain(q, k, v, o, do, window=window,
                                        softcap=cap)
    lse_want, _ = LA.local_attention_row_stats_plain(q, k, o, do,
                                                     window=window,
                                                     softcap=cap)
    for a, b in zip(got + [lse], list(want) + [lse_want]):
        assert a.shape == b.shape
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()


@pytest.mark.parametrize("batch, s, window, rows, keys, longest", [
    (1, 640, 512, 2, 8, (9, 9)), (1, 640, 640, 2, 8, (10, 10)),
    (4, 2048, 512, 1, 1, (116, 136)), (4, 2048, 2048, 1, 1, (253, 256))])
def test_bwd_cc_parts_at_gemma3_shapes(batch, s, window, rows, keys,
                                       longest):
    """gemma3-1b's float32 calls, 4 heads on 1 kv head, on a card of 132
    SMs taken to hold 132, 66 and 15 clusters of 1, 2 and 8 of these
    blocks at once (the deal's clusters).  The 12-layer run (batch 1, S
    640): cc_stats and cc_dq have 80 query tiles, so clusters of 2, whose
    longest block walks 9 of a query tile's 17 key tiles (10 of 20 at
    window S); cc_dkdv 20 key tiles, so clusters of 8, whose longest
    block walks 9 of the first key tile's 4 x 17 steps (10 of 4 x 20).
    Full width (batch 4, S 2048): 1024 and 256 tiles fill the card, no
    cluster.  The longest block walks its shares of the tiles dealt to
    its cluster (``bwd_cc_deal``)."""
    n = -(-s // LA.BWD_CC_TILE)
    heads = batch * 4
    assert LA.bwd_cc_parts(heads * n, 132) == rows
    assert LA.bwd_cc_parts(batch * n, 132) == keys
    clusters = {1: 132, 2: 66, 8: 15}
    got = []
    for seqs, parts, walk_of in ((heads, rows, "dq"), (batch, keys, "keys")):
        # one sequence's walks, and the tiles of all in the kernels'
        # heaviest-first order: query tiles in reverse, key tiles in order
        sched = LA.bwd_cc_schedule(s, window, 4, rows, keys)
        steps = [0] * n
        for step in getattr(sched, walk_of):
            steps[step[0]] += 1
        walk = ([steps[n - 1 - t // seqs] for t in range(n * seqs)]
                if walk_of == "dq" else
                [steps[t // seqs] for t in range(n * seqs)])
        most = 0
        for dealt in LA.bwd_cc_deal(len(walk), clusters[parts]):
            block = [0] * parts
            for t in dealt:
                for p, share in enumerate(LA._shares(walk[t], parts, t)):
                    block[p] += len(share)
            most = max(most, *block)
        got.append(most)
    assert tuple(got) == longest


@pytest.mark.parametrize("tiles, clusters", [(80, 33), (20, 16), (7, 16),
                                             (1024, 132)])
def test_bwd_cc_deal_snakes_heaviest_first(tiles, clusters):
    """``bwd_cc_deal``: every tile dealt to one cluster, at most one
    cluster a tile, each cluster's tiles in the heaviest-first order, the
    first round in cluster order and the next in reverse."""
    deal = LA.bwd_cc_deal(tiles, clusters)
    assert len(deal) == min(tiles, clusters)
    assert sorted(t for d in deal for t in d) == list(range(tiles))
    assert all(d == sorted(d) for d in deal)
    assert [d[0] for d in deal] == list(range(len(deal)))
    if tiles >= 2 * clusters:
        assert [d[1] for d in deal] == list(range(2 * clusters - 1,
                                                  clusters - 1, -1))
