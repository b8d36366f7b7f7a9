"""Mamba-1 selective scan on Hopper.

No TPU kernel replaces this one: the reference's ``mamba_forward``
(``src/repro/models/ssm.py:101-107``) discretises and scans with
``lax.associative_scan``, materialising decay, drive and h as
(B, S, d_inner, d_state) float32 tensors.  Here one kernel walks the
recurrence and keeps the state in registers:

    decay = exp(dt * A);  drive = (dt * B) * x;  h = decay * h + drive
    y = sum_n h * C + D * x

with dt, x (B, S, d_inner), B, C (B, S, d_state), A (d_inner, d_state),
D (d_inner,) and an optional initial state h0 (B, d_inner, d_state), all
float32.  :func:`selective_scan` returns y (B, S, d_inner) and the last
state (B, d_inner, d_state) for the decode cache.  The silu(z) gate and
the output projection stay in PyTorch, as in the reference.

The kernel is bound by instruction issue on the H100 (the precise
``expf`` is eight of a state step's 14 instructions), so its design
issues little else: each channel's states are split over
``STATE_GROUPS[d_state]`` lanes of a warp that walk them op for op as
the plain version does (the state rounds exactly as there; each lane's
share of ``sum_n h * C`` is summed with fused multiply-adds and the
lanes' shares are added in a fixed order), and each block of
``BLOCK_CHANNELS`` channels stages runs of ``RUN_STEPS`` time steps of
dt, x, B and C in shared memory with ``cp.async``, three runs in a ring.

The CUDA source is ``csrc/selective_scan.cu`` (its header notes what
bounds the kernel on the H100 and what the design does about it), built
with ``nvcc`` for ``sm_90a`` and ``-fmad=false`` at first use
(``kernels/_build.py``) and loaded with ``ctypes``.  On a CPU tensor the
wrapper computes :func:`selective_scan_plain`, the sequential recurrence
in float32 PyTorch; on a CUDA tensor it launches the kernel or raises.
Under an active ``analysis/op_stats.py::OpStats`` each launch on a CUDA
tensor also reports its work (:func:`scan_work`, the backward's
:func:`scan_bwd_work`: the formulas ``chip_smoke.py`` bounds the kernels
by); on fake CUDA tensors (a dry run, ``launch/dryrun_lib.py``) the
wrappers return the empty outputs in place of the launch, and with no
counter active a fake tensor raises.

The gradient.  With grad enabled and an operand that requires it, the
scan goes through :class:`SelectiveScanFn`: its forward is the call
above under no grad, its backward :func:`selective_scan_bwd`, the
reverse-time recurrence of the state's adjoint g (``dh_last`` or zero
after the last step):

    g = g * decay_{t+1} + C_t * dy_t
    dC_t = sum_c h_t * dy_t;   dB_t = sum_c g * dt_t * x_t
    ddt_t = sum_n g * (A * decay_t * h_{t-1} + B_t * x_t)
    dx_t = sum_n g * dt_t * B_t + D * dy_t
    dA = sum_{b,t} g * dt_t * decay_t * h_{t-1};  dD = sum_{b,t} dy_t * x_t
    dh0 = decay_0 * g

on a CUDA tensor the kernel of ``csrc/selective_scan_bwd.cu``
(port-only, as the forward: the reference differentiates
``lax.associative_scan``), on a CPU tensor
:func:`selective_scan_bwd_plain`.  Both recompute the states from
boundary states rather than keep (B, S, d_inner, d_state) of them.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.analysis import op_stats
from repro_torch.kernels import _build

SOURCE = _build.CSRC / "selective_scan.cu"
BWD_SOURCE = _build.CSRC / "selective_scan_bwd.cu"
#: multiplies and adds round apart, as the plain version's operations do
NVCC_FLAGS = ("-fmad=false",)
#: state sizes the kernel is instantiated for: the reduced configs' 4 and
#: the published models' 16
D_STATES = (4, 16)
#: the CUDA source's tiling: lanes a channel's states are split over, by
#: d_state; channels per block; time steps per staged run
STATE_GROUPS = {4: 1, 16: 2}
BLOCK_CHANNELS = 64
RUN_STEPS = 16
#: the backward's tiling (``csrc/selective_scan_bwd.cu``): time steps
#: between stored states (a run it recomputes into shared memory and walks
#: back); a lane's channels and states (so a channel's d_state states span
#: d_state / BWD_LANE_STATES lanes); the blocks an SM its walk is built
#: for (``__launch_bounds__``)
BWD_RUN_STEPS = 4
BWD_LANE_CHANNELS = 2
BWD_LANE_STATES = 4
BWD_MIN_BLOCKS = 4
#: kernel launches; each wrapper adds one where it launches, and nowhere
#: else (a backward call launches the walk and the cross-block sums: one
#: count)
LAUNCHES = {"selective_scan": 0, "selective_scan_bwd": 0}
#: time steps the plain versions discretise at once (the backward keeps
#: the state only at these boundaries)
PLAIN_CHUNK = 128


def build() -> Tuple[Path, str]:
    """Compile the kernel library if this source has not been built yet.

    Returns (library path, compiler log)."""
    return _build.build(SOURCE, NVCC_FLAGS)


def build_bwd() -> Tuple[Path, str]:
    """Compile the backward's library (same flags: its recomputed states
    are the forward's bits).  Returns (library path, compiler log)."""
    return _build.build(BWD_SOURCE, NVCC_FLAGS)


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = ctypes.CDLL(str(build()[0]))
    fn = lib.selective_scan_launch
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr] * 9 + [i32] * 4 + [ptr]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_lib():
    lib = ctypes.CDLL(str(build_bwd()[0]))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.selective_scan_bwd_launch.argtypes = [ptr] * 20 + [i32] * 4 + [ptr]
    lib.selective_scan_bwd_launch.restype = ctypes.c_int
    lib.selective_scan_bwd_occupancy.argtypes = [i32, ptr]
    lib.selective_scan_bwd_occupancy.restype = ctypes.c_int
    return lib


def bwd_geometry(batch: int, d_inner: int, d_state: int, *,
                 sms: int = 132) -> dict:
    """The backward walk's launch at (batch, d_inner, d_state) as designed:
    lanes a channel's states span, threads a block, blocks, the register
    budget a thread that ``__launch_bounds__(threads, BWD_MIN_BLOCKS)``
    sets on the H100's 65,536 registers an SM, and the waves of
    ``BWD_MIN_BLOCKS`` blocks an SM on ``sms`` SMs (:func:`bwd_occupancy`
    reads what the card grants)."""
    lanes_n = d_state // BWD_LANE_STATES
    threads = BLOCK_CHANNELS // BWD_LANE_CHANNELS * lanes_n
    blocks = -(-d_inner // BLOCK_CHANNELS) * batch
    return dict(lanes_per_channel=lanes_n, threads=threads, blocks=blocks,
                regs=min(255, 65536 // (threads * BWD_MIN_BLOCKS)),
                per_sm=BWD_MIN_BLOCKS,
                waves=blocks / (BWD_MIN_BLOCKS * sms))


def bwd_occupancy(d_state: int) -> dict:
    """The backward's launch geometry as the card reports it (builds the
    library): the walk's registers a thread, spill bytes, resident blocks
    an SM, threads and shared memory a block; the sums kernel's registers
    and threads."""
    out = (ctypes.c_int * 7)()
    err = _bwd_lib().selective_scan_bwd_occupancy(d_state, out)
    if err != 0:
        raise RuntimeError(f"selective_scan_bwd occupancy at d_state "
                           f"{d_state}: error {err}")
    keys = ("regs", "spill_bytes", "per_sm", "threads", "smem", "sums_regs",
            "sums_threads")
    return dict(zip(keys, out))


def _check(dt, x, b, c, a, d, h0) -> None:
    if dt.dim() != 3 or x.shape != dt.shape:
        raise ValueError(f"dt and x must be (B, S, d_inner): "
                         f"{tuple(dt.shape)}, {tuple(x.shape)}")
    bsz, s, dl = dt.shape
    if a.dim() != 2 or a.shape[0] != dl:
        raise ValueError(f"A must be (d_inner, d_state): {tuple(a.shape)}")
    n = a.shape[1]
    for name, t, shape in (("B", b, (bsz, s, n)), ("C", c, (bsz, s, n)),
                           ("D", d, (dl,)), ("h0", h0, (bsz, dl, n))):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} {tuple(t.shape)}, want {shape}")
    for t in (dt, x, b, c, a, d, h0):
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"the scan takes float32 operands: {t.dtype}")
        if t.device != dt.device:
            raise ValueError(f"operands on {dt.device} and {t.device}")


def selective_scan_plain(dt: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
                         c: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
                         h0: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of :func:`selective_scan`: the
    recurrence one time step after another, in float32, the decay and
    drive of ``PLAIN_CHUNK`` steps formed at once."""
    _check(dt, x, b, c, a, d, h0)
    bsz, s, dl = dt.shape
    n = a.shape[1]
    h = (torch.zeros((bsz, dl, n), dtype=torch.float32, device=dt.device)
         if h0 is None else h0.clone())
    y = torch.empty_like(x)
    for t0 in range(0, s, PLAIN_CHUNK):
        t1 = min(s, t0 + PLAIN_CHUNK)
        dtc = dt[:, t0:t1, :, None]
        decay = torch.exp(dtc * a)                           # (B, T, dl, n)
        drive = (dtc * b[:, t0:t1, None, :]) * x[:, t0:t1, :, None]
        hs = torch.empty_like(decay)
        for t in range(t1 - t0):
            torch.mul(decay[:, t], h, out=hs[:, t])
            hs[:, t] += drive[:, t]
            h = hs[:, t]
        y[:, t0:t1] = (hs * c[:, t0:t1, None, :]).sum(-1) + d * x[:, t0:t1]
    return y, h.clone()


def _check_bwd(dt, dy, dh_last, a) -> None:
    if tuple(dy.shape) != tuple(dt.shape):
        raise ValueError(f"dy {tuple(dy.shape)}, want {tuple(dt.shape)}")
    want = (dt.shape[0], dt.shape[2], a.shape[1])
    if dh_last is not None and tuple(dh_last.shape) != want:
        raise ValueError(f"dh_last {tuple(dh_last.shape)}, want {want}")
    for t in (dy, dh_last):
        if t is not None and (t.dtype != torch.float32
                              or t.device != dt.device):
            raise TypeError(f"dy and dh_last must be float32 on "
                            f"{dt.device}: {t.dtype} on {t.device}")


def selective_scan_bwd_plain(dt: torch.Tensor, x: torch.Tensor,
                             b: torch.Tensor, c: torch.Tensor,
                             a: torch.Tensor, d: torch.Tensor,
                             dy: torch.Tensor,
                             dh_last: Optional[torch.Tensor] = None,
                             h0: Optional[torch.Tensor] = None):
    """The plain PyTorch version of :func:`selective_scan_bwd`: the
    gradients (ddt, dx, dB, dC, dA, dD, dh0) of the scan, given dy
    (B, S, d_inner) and the last state's gradient ``dh_last`` (None:
    zero), in float32.

    A first walk keeps the state at each ``PLAIN_CHUNK`` boundary; then,
    from the last chunk to the first, the chunk's states are recomputed
    from its boundary (op for op as :func:`selective_scan_plain` forms
    them), the adjoint walks the chunk backward, and the chunk's
    gradients are formed at once."""
    _check(dt, x, b, c, a, d, h0)
    _check_bwd(dt, dy, dh_last, a)
    bsz, s, dl = dt.shape
    n = a.shape[1]
    f32 = dict(dtype=torch.float32, device=dt.device)
    with torch.no_grad():
        h = torch.zeros((bsz, dl, n), **f32) if h0 is None else h0
        starts = list(range(0, s, PLAIN_CHUNK))
        bounds = []

        def discretise(t0, t1):
            dtc = dt[:, t0:t1, :, None]
            decay = torch.exp(dtc * a)
            return dtc, decay, (dtc * b[:, t0:t1, None, :]) \
                * x[:, t0:t1, :, None]

        for t0 in starts:
            bounds.append(h)
            _, decay, drive = discretise(t0, min(s, t0 + PLAIN_CHUNK))
            for t in range(decay.shape[1]):
                h = decay[:, t] * h + drive[:, t]
        g = (torch.zeros((bsz, dl, n), **f32) if dh_last is None
             else dh_last.clone())
        ddt, dx = torch.empty_like(dt), torch.empty_like(x)
        db, dc = (torch.empty((bsz, s, n), **f32) for _ in range(2))
        da = torch.zeros((dl, n), **f32)
        dd = torch.zeros((dl,), **f32)
        for t0, h_start in zip(reversed(starts), reversed(bounds)):
            t1 = min(s, t0 + PLAIN_CHUNK)
            dtc, decay, drive = discretise(t0, t1)
            hs = torch.empty((bsz, t1 - t0 + 1, dl, n), **f32)
            hs[:, 0] = h_start
            for t in range(t1 - t0):
                hs[:, t + 1] = decay[:, t] * hs[:, t] + drive[:, t]
            dyc, xc = dy[:, t0:t1], x[:, t0:t1]
            cdy = c[:, t0:t1, None, :] * dyc[..., None]
            gs = torch.empty_like(decay)
            for t in reversed(range(t1 - t0)):
                g = g + cdy[:, t]
                gs[:, t] = g
                g = decay[:, t] * g
            ah = decay * hs[:, :-1]                       # decay_t h_{t-1}
            bc = b[:, t0:t1, None, :]
            ddt[:, t0:t1] = (gs * (a * ah + bc * xc[..., None])).sum(-1)
            gdt = gs * dtc
            da += (gdt * ah).sum((0, 1))
            dx[:, t0:t1] = (gdt * bc).sum(-1) + d * dyc
            db[:, t0:t1] = (gdt * xc[..., None]).sum(2)
            dc[:, t0:t1] = (hs[:, 1:] * dyc[..., None]).sum(2)
            dd += (dyc * xc).sum((0, 1))
    return ddt, dx, db, dc, da, dd, g


def scan_work(dt, x, b, c, a, d, h0=None) -> Tuple[int, int]:
    """(operations, bytes) one scan call must do: 8 per (b, t, c, n)
    (dt * A, exp, dt * B, * x, decay * h, + drive, h * C, + acc) and 2
    per (b, t, c) (D * x, +); every operand read once, y and the last
    state written once.  The kernel's bound (``chip_smoke.py``) and its
    report to an active ``analysis/op_stats.py::OpStats`` both use it."""
    bsz, s, dl = dt.shape
    n = a.shape[1]
    ops = 8 * bsz * s * dl * n + 2 * bsz * s * dl
    outs = bsz * s * dl + bsz * dl * n
    nbytes = 4 * (sum(t.numel() for t in (dt, x, b, c, a, d)
                      if t is not None)
                  + (h0.numel() if h0 is not None else 0) + outs)
    return ops, nbytes


def scan_bwd_work(dt, b, h0=None) -> Tuple[int, int]:
    """(operations, bytes) one scan-backward call must do: per (b, t, c,
    n) the states again (6: dt * A, exp, dt * B, * x, decay * h, +) and
    the adjoint (18: g, its decay, the ddt, dA, dx, dB and dC terms and
    their sums), per (b, t, c) 4 (D * dy, +, dy * x, +); dt, x, dy, B,
    C, A, D (and h0, dh_last) read once, ddt, dx, dB, dC, dA, dD, dh0
    written once."""
    bsz, s, dl = dt.shape
    n = b.shape[2]
    ops = 24 * bsz * s * dl * n + 4 * bsz * s * dl
    elems = (3 * bsz * s * dl + 2 * bsz * s * n + dl * n + dl) \
        + (2 * bsz * s * dl + 2 * bsz * s * n + dl * n + dl + bsz * dl * n) \
        + (bsz * dl * n if h0 is not None else 0)
    return ops, 4 * elems


def _fake_plain(dt) -> bool:
    """A fake CPU tensor under an active counter (a dry run of the CPU's
    plain route): the plain versions' walk, a few elementwise ops a time
    step, computes nothing on it and holds no product to count, so they
    return empty outputs in its place."""
    from repro_torch.compat import is_fake

    return bool(op_stats.ACTIVE) and is_fake(dt)


def _scan(dt, x, b, c, a, d, h0):
    """The forward on the operands' device: the plain version on the CPU,
    the kernel on the card."""
    if dt.device.type == "cpu":
        if _fake_plain(dt):
            bsz, _, dl = dt.shape
            return torch.empty_like(x), (
                torch.empty((bsz, dl, a.shape[1]), dtype=torch.float32)
                if h0 is None else h0.clone())
        return selective_scan_plain(dt, x, b, c, a, d, h0)
    if dt.device.type != "cuda":
        raise ValueError(f"the scan runs on cpu or cuda, not {dt.device}")
    bsz, s, dl = dt.shape
    n = a.shape[1]
    if n not in D_STATES:
        raise ValueError(f"d_state {n} not in the kernel's {D_STATES}")
    if bsz > 65535:
        raise ValueError(f"batch {bsz} exceeds the kernel's grid")
    y = torch.empty((bsz, s, dl), dtype=torch.float32, device=dt.device)
    h_last = (torch.zeros((bsz, dl, n), dtype=torch.float32, device=dt.device)
              if h0 is None else h0.clone())
    if y.numel() == 0:
        return y, h_last
    ops = [t.contiguous() for t in (dt, x, b, c, a, d)]
    h0c = h0.contiguous() if h0 is not None else None
    if op_stats.ACTIVE and op_stats.launch(
            "selective_scan", scan_work(dt, x, b, c, a, d, h0), dt,
            torch.float32):
        return y, h_last
    launch = _launcher()
    with torch.cuda.device(dt.device):
        stream = torch.cuda.current_stream(dt.device).cuda_stream
        err = launch(*(t.data_ptr() for t in ops),
                     None if h0c is None else h0c.data_ptr(), y.data_ptr(),
                     h_last.data_ptr(), bsz, s, dl, n, stream)
    if err != 0:
        raise RuntimeError(f"selective_scan launch failed: CUDA error {err}")
    LAUNCHES["selective_scan"] += 1
    return y, h_last


def selective_scan_bwd(dt: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
                       dy: torch.Tensor,
                       dh_last: Optional[torch.Tensor] = None,
                       h0: Optional[torch.Tensor] = None):
    """(ddt, dx, dB, dC, dA, dD, dh0) of the scan, all float32.

    CPU tensors take :func:`selective_scan_bwd_plain`.  CUDA tensors
    launch the backward kernel (``LAUNCHES["selective_scan_bwd"]`` counts
    each call): one block per (batch row, ``BLOCK_CHANNELS`` channels),
    each lane ``BWD_LANE_CHANNELS`` channels x ``BWD_LANE_STATES``
    states, walks the states forward, keeping one every
    ``BWD_RUN_STEPS`` steps in a scratch buffer, then walks back run by
    run on the decays its recompute kept (:func:`bwd_geometry` reckons
    its waves); dB, dC, dA and dD are summed across blocks by a second
    kernel of the same launch in a fixed order, so two calls on the same
    inputs give the same bits."""
    _check(dt, x, b, c, a, d, h0)
    _check_bwd(dt, dy, dh_last, a)
    if dt.device.type == "cpu":
        if _fake_plain(dt):
            bsz, s, dl = dt.shape
            n = a.shape[1]
            return (torch.empty_like(dt), torch.empty_like(x),
                    torch.empty((bsz, s, n)), torch.empty((bsz, s, n)),
                    torch.empty((dl, n)), torch.empty((dl,)),
                    torch.empty((bsz, dl, n)))
        return selective_scan_bwd_plain(dt, x, b, c, a, d, dy, dh_last, h0)
    if dt.device.type != "cuda":
        raise ValueError(f"the scan runs on cpu or cuda, not {dt.device}")
    bsz, s, dl = dt.shape
    n = a.shape[1]
    if n not in D_STATES:
        raise ValueError(f"d_state {n} not in the kernel's {D_STATES}")
    if bsz > 65535:
        raise ValueError(f"batch {bsz} exceeds the kernel's grid")

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dt.device)

    ddt, dx = empty(bsz, s, dl), empty(bsz, s, dl)
    db, dc = empty(bsz, s, n), empty(bsz, s, n)
    da, dd, dh0 = empty(dl, n), empty(dl), empty(bsz, dl, n)
    if s == 0 or dl == 0:
        for t in (db, dc, da, dd):
            t.zero_()
        dh0.copy_(torch.zeros_like(dh0) if dh_last is None else dh_last)
        return ddt, dx, db, dc, da, dd, dh0
    blocks = -(-dl // BLOCK_CHANNELS)
    runs = -(-s // BWD_RUN_STEPS)
    ckpt = empty(bsz, runs, dl, n)
    part_bc = empty(bsz, s, blocks, 2 * n)
    part_a, part_d = empty(bsz, dl, n), empty(bsz, dl)
    ops = [t.contiguous() for t in (dt, x, b, c, a, d)]
    opt = [None if t is None else t.contiguous() for t in (h0, dy, dh_last)]
    if op_stats.ACTIVE and op_stats.launch(
            "selective_scan_bwd", scan_bwd_work(dt, b, h0), dt,
            torch.float32):
        return ddt, dx, db, dc, da, dd, dh0
    launch = _bwd_lib().selective_scan_bwd_launch
    with torch.cuda.device(dt.device):
        stream = torch.cuda.current_stream(dt.device).cuda_stream
        err = launch(*(t.data_ptr() for t in ops),
                     *(None if t is None else t.data_ptr() for t in opt),
                     *(t.data_ptr() for t in (ckpt, part_bc, part_a, part_d,
                                              ddt, dx, db, dc, da, dd, dh0)),
                     bsz, s, dl, n, stream)
    if err != 0:
        raise RuntimeError(
            f"selective_scan_bwd launch failed: CUDA error {err}")
    LAUNCHES["selective_scan_bwd"] += 1
    return ddt, dx, db, dc, da, dd, dh0


class SelectiveScanFn(torch.autograd.Function):
    """The scan with its gradient: the forward (kernel or plain version,
    by device) under no grad, then :func:`selective_scan_bwd`.  Under
    ``torch.utils.checkpoint`` the recompute runs the forward again."""

    @staticmethod
    def forward(ctx, dt, x, b, c, a, d, h0):
        y, h_last = _scan(dt, x, b, c, a, d, h0)
        ctx.save_for_backward(dt, x, b, c, a, d, h0)
        ctx.set_materialize_grads(False)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        dt, x, b, c, a, d, h0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        grads = selective_scan_bwd(dt, x, b, c, a, d, dy.contiguous(),
                                   dh_last, h0)
        return (*grads[:6], None if h0 is None else grads[6])


def selective_scan(dt: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
                   h0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (B, S, d_inner), last state (B, d_inner, d_state)) of the
    selective scan, all float32.

    CPU tensors take :func:`selective_scan_plain`.  CUDA tensors launch
    the kernel (``LAUNCHES["selective_scan"]`` counts it); nothing falls
    back to the plain version on the card.  With grad enabled and an
    operand that requires it, the call goes through
    :class:`SelectiveScanFn`, whose backward is
    :func:`selective_scan_bwd`."""
    _check(dt, x, b, c, a, d, h0)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (dt, x, b, c, a, d,
                                                        h0)):
        return SelectiveScanFn.apply(dt, x, b, c, a, d, h0)
    return _scan(dt, x, b, c, a, d, h0)
