"""The selective-scan kernel's decomposition, written out in float32
PyTorch and held to the plain version (``selective_scan_plain``).

The CUDA kernel (``csrc/selective_scan.cu``) splits each channel's
d_state states over ``STATE_GROUPS[d_state]`` lanes.  A lane walks its
states with the plain version's operations, each rounded on its own
(``decay = exp(dt * A)``, ``drive = (dt * B) * x``, ``h = decay * h +
drive``), so the state must come out bit-equal.  y changes order: a lane
sums its share of ``h * C`` with fused multiply-adds on two accumulators
(even and odd states), adds the two, the lanes' shares are added in
lane order, and ``D * x`` last; y is held at the card tests' tolerance
(rtol = atol = 1e-5).  Runs of ``RUN_STEPS`` steps and blocks of
``BLOCK_CHANNELS`` channels only stage operands, so the shapes cross
those boundaries too.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.selective_scan import (  # noqa: E402
    BLOCK_CHANNELS,
    RUN_STEPS,
    STATE_GROUPS,
    selective_scan_plain,
)

#: the card tests' scan tolerance (tests/test_torch_cuda.py::SCAN_TOL)
SCAN_TOL = 1e-5


def _fma(a, b, c):
    """a * b + c rounded once to float32: the float64 product of two
    float32 values is exact."""
    return (a.double() * b.double() + c.double()).float()


def _split_scan(dt, x, b, c, a, d, h0=None):
    """The kernel's arithmetic, one time step after another."""
    bsz, s, dl = dt.shape
    n = a.shape[1]
    groups = STATE_GROUPS[n]
    per = n // groups
    h = (torch.zeros((bsz, dl, n), dtype=torch.float32) if h0 is None
         else h0.clone())
    y = torch.empty_like(x)
    for t in range(s):
        dtv = dt[:, t, :, None]                       # (B, dl, 1)
        decay = torch.exp(dtv * a)
        drive = (dtv * b[:, t, None, :]) * x[:, t, :, None]
        h = decay * h + drive                         # two roundings
        parts = []
        for g in range(groups):
            acc = [torch.zeros((bsz, dl)), torch.zeros((bsz, dl))]
            for p in range(per):
                i = g * per + p
                acc[p % 2] = _fma(h[:, :, i], c[:, t, None, i], acc[p % 2])
            parts.append(acc[0] + acc[1])
        total = parts[0]
        for part in parts[1:]:
            total = total + part
        y[:, t] = total + d * x[:, t]
    return y, h


def _operands(seed, bsz, s, dl, n, with_h0):
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((bsz, s, dl)) - 2.0))
    a = -np.tile(np.arange(1, n + 1, dtype=np.float64), (dl, 1))
    ops = [dt, rng.standard_normal((bsz, s, dl)),
           rng.standard_normal((bsz, s, n)), rng.standard_normal((bsz, s, n)),
           a, rng.standard_normal(dl),
           rng.standard_normal((bsz, dl, n)) if with_h0 else None]
    return [None if v is None else torch.from_numpy(v.astype(np.float32))
            for v in ops]


@pytest.mark.parametrize("n", sorted(STATE_GROUPS))
@pytest.mark.parametrize("s,dl", [
    (1, 5), (RUN_STEPS - 1, BLOCK_CHANNELS), (RUN_STEPS, BLOCK_CHANNELS + 1),
    (RUN_STEPS + 1, 2 * BLOCK_CHANNELS + 2), (3 * RUN_STEPS + 1, 7)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_split_scan_matches_plain(n, s, dl, with_h0):
    ops = _operands(s * 1000 + dl + n, 2, s, dl, n, with_h0)
    y, h = _split_scan(*ops)
    y_ref, h_ref = selective_scan_plain(*ops)
    assert torch.equal(h, h_ref)
    torch.testing.assert_close(y, y_ref, rtol=SCAN_TOL, atol=SCAN_TOL)


def test_state_groups_divide_d_state():
    """Each lane reads its states' B and C as float4s."""
    for n, groups in STATE_GROUPS.items():
        assert n % groups == 0 and (n // groups) % 4 == 0
