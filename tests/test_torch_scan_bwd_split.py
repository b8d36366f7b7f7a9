"""The selective-scan backward kernel's decomposition, written out in
float32 PyTorch and held to the plain version
(``selective_scan_bwd_plain``), and the Python mirror of its launch
geometry.

The CUDA kernel (``csrc/selective_scan_bwd.cu``) gives each lane
``BWD_LANE_CHANNELS`` channels x ``BWD_LANE_STATES`` states, so a
channel's states span ``d_state / BWD_LANE_STATES`` lanes of a warp and a
warp covers ``2 * 32 / lanes`` channels; a block is ``BLOCK_CHANNELS``
channels.  A first pass stores the state before every run of
``BWD_RUN_STEPS`` steps (the forward's operations, each rounded on its
own, so the stored states are the plain forward's bits); then, from the
last run to the first, the recompute forms each step's ``decay`` and
``decay * h_{t-1}`` once and dC of the step, and the walk back runs on
them (no third exp).  Its sums, in their fixed orders:

- ddt, dx: each lane sums its 4 states by fused multiply-adds
  (``sum g * A * ah``, ``sum g * B``; ddt = x * sum g B + sum g A ah, dx
  before D * dy = dt * sum g B), then the lanes of a channel meet by a
  reduce-scatter (lanes differing in the high bit add first); dx adds
  D * dy by one fused multiply-add;
- dB, dC: each lane sums its 2 channels (a product, then a fused
  multiply-add), a reduce-scatter over the warp's channel pairs, the
  warps' sums in warp order, the blocks' in block order;
- dA, dD: per (batch row, channel) over t from last to first by fused
  multiply-adds, then over batch rows in order.

Each gradient is held within TOL_SCAN_BWD of its largest |plain value|,
the card's tolerance (``chip_smoke.py``, ``tests/test_torch_cuda.py``).
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import selective_scan as SS  # noqa: E402

#: chip_smoke.py::TOL_SCAN_BWD
TOL_SCAN_BWD = 1e-5
RUN = SS.BWD_RUN_STEPS
LC, LP = SS.BWD_LANE_CHANNELS, SS.BWD_LANE_STATES


def _fma(a, b, c):
    """a * b + c rounded once to float32: the float64 product of two
    float32 values is exact."""
    return (a.double() * b.double() + c.double()).float()


def _tree(v, dim):
    """A reduce-scatter's sum over ``dim`` (a power of two): lanes that
    differ in the high bit add first (addition commutes, so the lane that
    keeps the sum does not change its bits)."""
    while v.shape[dim] > 1:
        h = v.shape[dim] // 2
        v = v.narrow(dim, 0, h) + v.narrow(dim, h, h)
    return v.squeeze(dim)


def _in_order(v, dim):
    """Sum over ``dim`` one term after another, in index order."""
    total = v.select(dim, 0)
    for i in range(1, v.shape[dim]):
        total = total + v.select(dim, i)
    return total


def _fma_chain(a, b, dim):
    """sum_i a_i * b_i over ``dim``: a product, then fused multiply-adds."""
    acc = a.select(dim, 0) * b.select(dim, 0)
    for i in range(1, a.shape[dim]):
        acc = _fma(a.select(dim, i), b.select(dim, i), acc)
    return acc


def _split_scan_bwd(dt, x, b, c, a, d, dy, dh_last=None, h0=None):
    """The kernel's arithmetic.  Pair tensors are laid out (batch, block,
    warp, channel pair of the warp, channel of the lane, state lane,
    state of the lane); channels past d_inner and steps past S are the
    zeros the kernel stages there."""
    bsz, s, dl = dt.shape
    n = a.shape[1]
    lanes_n = n // LP
    lanes_c = 32 // lanes_n
    warps = SS.BLOCK_CHANNELS // (LC * lanes_c)
    nb = -(-dl // SS.BLOCK_CHANNELS)
    dp = nb * SS.BLOCK_CHANNELS
    runs = -(-s // RUN)
    sp = runs * RUN

    def pad(t, shape):
        out = torch.zeros(shape, dtype=torch.float32)
        out[tuple(slice(0, k) for k in t.shape)] = t
        return out

    chan = (nb, warps, lanes_c, LC)  # channel index, split as the lanes

    def per_channel(t):  # (B, dp) -> broadcast against pair tensors
        return t.reshape(bsz, *chan)[..., None, None]

    def per_state(t):  # (B, n)
        return t.reshape(bsz, 1, 1, 1, 1, lanes_n, LP)

    def pairs(t):  # (B, dp, n)
        return t.reshape(bsz, *chan, lanes_n, LP)

    dtp, xp, dyp = (pad(t, (bsz, sp, dp)) for t in (dt, x, dy))
    bp, cp = (pad(t, (bsz, sp, n)) for t in (b, c))
    ap = pad(a, (dp, n)).reshape(1, *chan, lanes_n, LP)
    dvp = pad(d, (dp,))
    zeros = torch.zeros((bsz, dp, n), dtype=torch.float32)
    h = pairs(zeros if h0 is None else pad(h0, (bsz, dp, n)))

    def forward(h, t):
        dtv, xv = per_channel(dtp[:, t]), per_channel(xp[:, t])
        decay = torch.exp(dtv * ap)
        drive = (dtv * per_state(bp[:, t])) * xv
        ah = decay * h
        return ah + drive, ah, decay

    # pass 1: the state before every run
    ckpt = []
    for r in range(runs):
        ckpt.append(h)
        if r + 1 < runs:
            for t in range(r * RUN, (r + 1) * RUN):
                h = forward(h, t)[0]

    def block_sum(v):
        """A lane's (channel pair, state lane, state) values: the
        reduce-scatter over the warp's channel pairs, warps, blocks."""
        v = _tree(v, 3)                  # (B, nb, warps, lanes_n, LP)
        v = _in_order(v, 2)
        return _in_order(v, 1).reshape(bsz, n)

    carry = pairs(zeros if dh_last is None else pad(dh_last, (bsz, dp, n)))
    da = torch.zeros_like(carry)
    dd = torch.zeros((bsz, dp), dtype=torch.float32)
    ddt, dx = torch.empty((bsz, sp, dp)), torch.empty((bsz, sp, dp))
    db, dc = torch.empty((bsz, sp, n)), torch.empty((bsz, sp, n))
    for r in reversed(range(runs)):
        h = ckpt[r]
        kept = []
        for t in range(r * RUN, (r + 1) * RUN):   # the recompute
            h, ah, decay = forward(h, t)
            kept.append((ah, decay))
            vc = _fma(h.select(4, 1), per_channel(dyp[:, t]).select(4, 1),
                      h.select(4, 0) * per_channel(dyp[:, t]).select(4, 0))
            dc[:, t] = block_sum(vc)
        for i in reversed(range(RUN)):            # the walk back
            t = r * RUN + i
            ah, decay = kept[i]
            dtv, xv = per_channel(dtp[:, t]), per_channel(xp[:, t])
            dyv = per_channel(dyp[:, t])
            gp = _fma(per_state(cp[:, t]), dyv, carry)
            t1 = gp * ah
            sgaa = _fma_chain(t1, ap.expand_as(t1), 6)
            da = _fma(t1, dtv, da)
            sgb = _fma_chain(gp, per_state(bp[:, t]).expand_as(gp), 6)
            vb = _fma_chain(gp, (dtv * xv).expand_as(gp), 4)
            carry = decay * gp
            dd = _fma(dyp[:, t], xp[:, t], dd)
            xs, dts = xv[..., 0], dtv[..., 0]   # (B, *chan, 1)
            ddt[:, t] = _tree(_fma(xs, sgb, sgaa), 5).reshape(bsz, dp)
            dx[:, t] = _fma(dvp, dyp[:, t],
                            _tree(dts * sgb, 5).reshape(bsz, dp))
            db[:, t] = block_sum(vb)
    cut = (slice(None), slice(0, s), slice(0, dl))
    return (ddt[cut], dx[cut], db[:, :s], dc[:, :s],
            _in_order(da.reshape(bsz, dp, n), 0)[:dl],
            _in_order(dd, 0)[:dl],
            carry.reshape(bsz, dp, n)[:, :dl]), ckpt


def _operands(seed, bsz, s, dl, n, with_h0, with_dh_last):
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((bsz, s, dl)) - 2.0))
    a = -np.tile(np.arange(1, n + 1, dtype=np.float64), (dl, 1))
    ops = [dt, rng.standard_normal((bsz, s, dl)),
           rng.standard_normal((bsz, s, n)), rng.standard_normal((bsz, s, n)),
           a, rng.standard_normal(dl), rng.standard_normal((bsz, s, dl)),
           rng.standard_normal((bsz, dl, n)) if with_dh_last else None,
           rng.standard_normal((bsz, dl, n)) if with_h0 else None]
    return [None if v is None else torch.from_numpy(v.astype(np.float32))
            for v in ops]


@pytest.mark.parametrize("n", sorted(SS.STATE_GROUPS))
@pytest.mark.parametrize("s", [1, RUN - 1, RUN, RUN + 1, 2 * RUN + 1, 15,
                               16, 17])
@pytest.mark.parametrize("dl", [5, SS.BLOCK_CHANNELS, 130])
@pytest.mark.parametrize("with_h0,with_dh_last", [(False, False),
                                                   (True, True)])
def test_split_scan_bwd_matches_plain(n, s, dl, with_h0, with_dh_last):
    ops = _operands(s * 1000 + dl + n, 2, s, dl, n, with_h0, with_dh_last)
    got, _ = _split_scan_bwd(*ops)
    want = SS.selective_scan_bwd_plain(*ops)
    for name, g, w in zip(("ddt", "dx", "dB", "dC", "dA", "dD", "dh0"), got,
                          want):
        assert g.shape == w.shape, name
        scale = max(w.abs().max().item(), 1e-30)
        err = (g - w).abs().max().item()
        assert err <= TOL_SCAN_BWD * scale, (name, err, scale)


@pytest.mark.parametrize("n", sorted(SS.STATE_GROUPS))
def test_split_scan_bwd_stores_the_forward_states(n):
    """The first pass's stored states are the plain forward's bits at
    every run boundary (the recompute starts from them)."""
    s, dl = 3 * RUN + 2, 70
    ops = _operands(n, 2, s, dl, n, True, False)
    _, ckpt = _split_scan_bwd(*ops)
    dt, x, b, c, a, d, _, _, h0 = ops
    for r, h in enumerate(ckpt[1:], start=1):
        t = r * RUN
        _, h_ref = SS.selective_scan_plain(dt[:, :t], x[:, :t], b[:, :t],
                                           c[:, :t], a, d, h0)
        blocks = -(-dl // SS.BLOCK_CHANNELS) * SS.BLOCK_CHANNELS
        assert torch.equal(h.reshape(2, blocks, n)[:, :dl], h_ref)


def _source_constants():
    text = SS.BWD_SOURCE.read_text()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (k\w+) = (\d+);", text)}


def test_bwd_mirror_matches_the_source():
    """The Python tiling constants are the CUDA source's."""
    src = _source_constants()
    assert src["kChannels"] == SS.BLOCK_CHANNELS
    assert src["kRun"] == SS.BWD_RUN_STEPS
    assert src["kLaneC"] == SS.BWD_LANE_CHANNELS
    assert src["kLaneP"] == SS.BWD_LANE_STATES
    assert src["kMinBlocks"] == SS.BWD_MIN_BLOCKS


def test_bwd_geometry_fills_one_wave_at_falcon_mamba():
    """falcon-mamba-7b's training call (batch 4, d_inner 8192, d_state
    16) on 132 SMs under the 128-register budget that
    __launch_bounds__(128, 4) sets: 4 lanes a channel, 512 blocks of 128
    threads, 4 an SM, 0.97 waves: a whole wave to within 10%."""
    g = SS.bwd_geometry(4, 8192, 16)
    assert (g["lanes_per_channel"], g["threads"], g["blocks"], g["regs"],
            g["per_sm"]) == (4, 128, 512, 128, 4)
    assert round(g["waves"], 2) == 0.97
    assert abs(g["waves"] - round(g["waves"])) <= 0.1 * round(g["waves"])


@pytest.mark.parametrize("n", sorted(SS.STATE_GROUPS))
def test_bwd_lane_tile_divides_d_state(n):
    """A channel's states span whole lanes, a warp whole channel pairs,
    and the reduce-scatter over a warp's channel pairs leaves one dB / dC
    sum a lane."""
    assert n % SS.BWD_LANE_STATES == 0
    lanes_n = n // SS.BWD_LANE_STATES
    lanes_c = 32 // lanes_n
    assert 32 % lanes_n == 0 and lanes_c % SS.BWD_LANE_STATES == 0
    assert SS.BLOCK_CHANNELS % (SS.BWD_LANE_CHANNELS * lanes_c) == 0
