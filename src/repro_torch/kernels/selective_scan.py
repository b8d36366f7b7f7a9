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
in float32 PyTorch; on a CUDA tensor it launches the kernel or raises.  The kernel has no
backward yet: a CUDA call whose operands require grad raises rather than
return an output with no ``grad_fn``.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

SOURCE = _build.CSRC / "selective_scan.cu"
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
#: kernel launches; the wrapper adds one where it launches, and nowhere
#: else
LAUNCHES = {"selective_scan": 0}
#: time steps the plain version discretises at once on the card
PLAIN_CHUNK = 128


def build() -> Tuple[Path, str]:
    """Compile the kernel library if this source has not been built yet.

    Returns (library path, compiler log)."""
    return _build.build(SOURCE, NVCC_FLAGS)


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = ctypes.CDLL(str(build()[0]))
    fn = lib.selective_scan_launch
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr] * 9 + [i32] * 4 + [ptr]
    fn.restype = ctypes.c_int
    return fn


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


def selective_scan(dt: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
                   h0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (B, S, d_inner), last state (B, d_inner, d_state)) of the
    selective scan, all float32.

    CPU tensors take :func:`selective_scan_plain`.  CUDA tensors launch
    the kernel (``LAUNCHES["selective_scan"]`` counts it); nothing falls
    back to the plain version on the card."""
    _check(dt, x, b, c, a, d, h0)
    if dt.device.type == "cpu":
        return selective_scan_plain(dt, x, b, c, a, d, h0)
    if dt.device.type != "cuda":
        raise ValueError(f"the scan runs on cpu or cuda, not {dt.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (dt, x, b, c, a, d,
                                                        h0)):
        raise RuntimeError(
            "the selective scan kernel has no backward yet (ROADMAP Queue 1 "
            "item 16(a)): its output would carry no gradient")
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
