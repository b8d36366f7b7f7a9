"""Domino CIM crossbar matmul (w8a8 + per-subarray ADC) on Hopper.

Replaces ``src/repro/kernels/cim_matmul.py::_cim_kernel`` and
``::_cim_kernel_var`` (both reached through ``cim_matmul_pallas`` /
``cim_chain_codes_pallas``).  One step is one CIM subarray: an exact
int8 x int8 -> int32 dot over at most ``n_c`` rows, the SAR-ADC
round/saturate, and the digital accumulation of ADC codes (what
Domino's Rofm adds "on the move").

:func:`cim_codes` takes either layout the engines produce:

* 3-D — ``x`` (T, R, kc) int8 patches and ``w`` (T, kc, N) int8 stacked
  tile weights (``kc <= n_c``), step ``t`` = chain tile ``t``: the fused
  trace path's batch-of-tiles MAC;
* 2-D — ``x`` (R, K) and ``w`` (K, N) int8, K cut into ``n_c``-row steps
  (the last one ragged): an FC grid tile.  The kernel reads the steps
  through strides and pads the ragged step itself, so no copy is made.

``adc`` is an optional (T, 2) float32 table of per-step ``[inverse step,
offset]`` (device variation, the ``_cim_kernel_var`` flavor); without it
every step converts with the spec's scalar inverse step and no add.

The kernel reads both operands K-major: ``x`` with unit stride along
depth, ``w`` with unit stride along depth too (``w.stride(-2) == 1``),
which is how the engine stores its weights.  A ``w`` with unit stride
along N instead is copied K-major once per call and counted in
``WEIGHT_COPIES``.

The CUDA source is ``csrc/cim_matmul.cu`` (its header notes what bounds
the kernel on the H100 and what the design does about it: int8
``wgmma``, a grid split over subarrays reduced within a thread-block
cluster, ``cp.async`` copies in rounds).  It is compiled with ``nvcc`` for
``sm_90a`` at first use into ``build/kernels/`` at the repository root
(``kernels/_build.py``) and loaded with ``ctypes``.  :func:`launch_plan`
picks each call's tiles and split (``tests/test_torch_cim_split.py``
mirrors the blocks the kernel makes of it).
On a CPU tensor the wrapper computes :func:`cim_codes_plain`, the plain
PyTorch version of the same arithmetic; on a CUDA tensor it launches
the kernel or raises.  Under an active ``analysis/op_stats.py::OpStats``
each call on a CUDA tensor also reports :func:`work` (the formula
``chip_smoke.py`` bounds the kernel by); on a fake CUDA tensor (a dry
run, ``launch/dryrun_lib.py``) it returns the empty output in place of
the launch, and with no counter active a fake tensor raises.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.cim import CIMSpec, adc_convert, f32_scalar
from repro_torch.analysis import op_stats
from repro_torch.kernels import _build

SOURCE = _build.CSRC / "cim_matmul.cu"
#: the reference converts with separately rounded multiply and add
NVCC_FLAGS = ("-fmad=false",)
#: largest code sum the float32 output holds exactly
_EXACT_F32 = 1 << 24
#: kernel launches by variant (nominal / device-variation flavor); the
#: wrapper adds one where it launches, and nowhere else
LAUNCHES = {"cim_codes": 0, "cim_codes_var": 0}
#: K-major copies of a weight operand the wrapper had to make (a ``w``
#: with unit stride along N); the engine's weights need none
WEIGHT_COPIES = 0

#: weight columns per block (wgmma's M)
COLS = 64
#: x rows per block the kernel is built for (wgmma's N)
ROW_TILES = (8, 16, 32)
#: blocks of one output tile in a cluster along the step axis (the
#: portable cluster size)
MAX_SLICES = 8
#: the split launch_plan takes at most: six slices beat eight on every
#: main-path call in development runs on the card
PLAN_SLICES = 6
#: blocks that fill the H100's 132 SMs once
WAVE = 132
_GRID_Y = 65535


@dataclass(frozen=True)
class Plan:
    """One launch's tiling: ``rows`` x rows per block, and ``slices``
    blocks per output tile, each walking a slice of the steps."""

    rows: int
    slices: int


def launch_plan(t: int, r: int, n: int) -> Plan:
    """The tiling the wrapper launches for T steps, R rows, N columns.

    Row tiles of 32 (the fastest on the main path's convs), or the
    smallest that holds R.  Steps split across up to six blocks, fewer
    once the tiles alone fill about four waves."""
    rows = next((b for b in ROW_TILES if b >= r), ROW_TILES[-1])
    tiles = -(-n // COLS) * -(-r // rows)
    slices = max(1, min(t, PLAN_SLICES, -(-4 * WAVE // max(tiles, 1))))
    return Plan(rows, slices)


def build() -> Tuple[Path, str]:
    """Compile the kernel library if this source has not been built yet.

    Returns (library path, compiler log)."""
    return _build.build(SOURCE, NVCC_FLAGS)


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = ctypes.CDLL(str(build()[0]))
    fn = lib.cim_codes_launch
    ptr, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_float)
    fn.argtypes = [ptr, i64, i64, i32, ptr, i64, i64, i32, ptr, f32, f32,
                   f32, f32, ptr, i32, i32, i32, i32, i64, i32, i32, i32,
                   ptr]
    fn.restype = ctypes.c_int
    return fn


def _geometry(x: torch.Tensor, w: torch.Tensor, n_c: int):
    """(T, R, kc, N, k_total) of either layout."""
    if x.dim() == 3:
        t, r, kc = x.shape
        if w.shape[:2] != (t, kc) or w.dim() != 3:
            raise ValueError(f"x {tuple(x.shape)} vs w {tuple(w.shape)}")
        if kc > n_c:
            raise ValueError(f"step depth {kc} exceeds n_c={n_c}")
        return t, r, kc, w.shape[2], t * kc
    if x.dim() == 2 and w.dim() == 2:
        r, k = x.shape
        if w.shape[0] != k:
            raise ValueError(f"x {tuple(x.shape)} vs w {tuple(w.shape)}")
        return max(1, -(-k // n_c)), r, n_c, w.shape[1], k
    raise ValueError(f"x must be (T, R, kc) or (R, K): {tuple(x.shape)}")


def _check(x, w, spec: CIMSpec, adc):
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"x and w must be int8: {x.dtype}, {w.dtype}")
    if w.device != x.device:
        raise ValueError(f"x on {x.device}, w on {w.device}")
    geo = _geometry(x, w, spec.n_c)
    t = geo[0]
    if adc is not None and (adc.dtype != torch.float32
                            or tuple(adc.shape) != (t, 2)
                            or adc.device != x.device):
        raise ValueError(
            f"adc must be a ({t}, 2) float32 table on {x.device}: "
            f"{adc.dtype} {tuple(adc.shape)} on {adc.device}")
    if t * (spec.q_max + 1) > _EXACT_F32:
        raise ValueError(
            f"{t} steps of {spec.adc_bits}-bit codes can exceed 2^24: the "
            "float32 code sum would not be exact")
    return geo


def _steps(x: torch.Tensor, w: torch.Tensor, n_c: int):
    """The 2-D layout as (T, R, n_c) / (T, n_c, N) zero-padded steps."""
    if x.dim() == 3:
        return x, w
    k = x.shape[1]
    t = max(1, -(-k // n_c))
    pad = t * n_c - k
    xp = torch.nn.functional.pad(x, (0, pad))
    wp = torch.nn.functional.pad(w, (0, 0, 0, pad))
    return (xp.reshape(x.shape[0], t, n_c).transpose(0, 1),
            wp.reshape(t, n_c, w.shape[1]))


def work(x: torch.Tensor, w: torch.Tensor,
         adc: Optional[torch.Tensor] = None) -> Tuple[int, int]:
    """(int8 operations, bytes) one :func:`cim_codes` call must do: 2 ops
    per multiply-add over the given depth; x, w and the ADC table read
    once, the float32 output written once.  The kernel's bound
    (``chip_smoke.py``) and its report to an active
    ``analysis/op_stats.py::OpStats`` both use it."""
    ops = 2 * x.shape[-2] * x.shape[-1] * w.shape[-1] * (
        x.shape[0] if x.dim() == 3 else 1)
    nbytes = x.numel() + w.numel() + 4 * x.shape[-2] * w.shape[-1]
    if adc is not None:
        nbytes += adc.numel() * 4
    return ops, nbytes


def cim_codes_plain(x: torch.Tensor, w: torch.Tensor, spec: CIMSpec,
                    adc: Optional[torch.Tensor] = None,
                    emit_codes: bool = True) -> torch.Tensor:
    """The plain PyTorch version of :func:`cim_codes`: the same layouts,
    the same result.  Dots are formed in float64 (exact for |d| < 2^53;
    an int8 ``torch.matmul`` would wrap), converted by the shared
    :func:`~repro_torch.core.cim.adc_convert`, and the integer codes
    summed exactly before the float32 output."""
    _check(x, w, spec, adc)
    xs, wsteps = _steps(x, w, spec.n_c)
    d = torch.matmul(xs.to(torch.float64), wsteps.to(torch.float64))
    if adc is None:
        codes = adc_convert(d, spec.adc_inv_step, -spec.q_max - 1,
                            spec.q_max)
    else:
        codes = adc_convert(d, adc[:, 0].reshape(-1, 1, 1),
                            -spec.q_max - 1, spec.q_max,
                            adc[:, 1].reshape(-1, 1, 1))
    out = codes.sum(dim=0).to(torch.float32)
    return out if emit_codes else out * f32_scalar(spec.adc_step, x.device)


def _aligned(t: torch.Tensor, *strides: int) -> int:
    """1 if the operand's base and row strides are 16-byte aligned (the
    kernel's cp.async path), else 0 (its byte-staging path)."""
    return int(t.data_ptr() % 16 == 0 and all(s % 16 == 0 for s in strides))


def cim_codes(x: torch.Tensor, w: torch.Tensor, spec: CIMSpec,
              adc: Optional[torch.Tensor] = None,
              emit_codes: bool = True) -> torch.Tensor:
    """(R, N) float32 ADC code sums (``emit_codes``) or their dequantized
    value ``codes * adc_step``, through the CIM pipeline.

    CPU tensors take :func:`cim_codes_plain`.  CUDA tensors launch the
    kernel (``cim_codes.launches`` counts launches by variant, not the
    launches a CUDA graph capture records) with :func:`launch_plan`'s
    tiling; no tiling changes the result.  Nothing falls back to the
    plain version on the card."""
    global WEIGHT_COPIES
    t, r, kc, n, k_total = _check(x, w, spec, adc)
    if x.device.type == "cpu":
        return cim_codes_plain(x, w, spec, adc, emit_codes)
    if x.device.type != "cuda":
        raise ValueError(f"cim_codes runs on cpu or cuda, not {x.device}")
    if spec.q_max + 1 > 1 << 22:
        raise ValueError(f"{spec.adc_bits}-bit codes: the kernel adds codes "
                         "below 2^22 only")
    if x.stride(-1) != 1 and x.shape[-1] > 1:
        raise ValueError("x needs unit stride along depth")
    if w.stride(-2) != 1 and w.shape[-2] > 1:
        w = w.transpose(-1, -2).contiguous().transpose(-1, -2)
        WEIGHT_COPIES += 1
    if adc is not None and not adc.is_contiguous():
        raise ValueError("adc must be contiguous")
    plan = launch_plan(t, r, n)
    if -(-r // plan.rows) > _GRID_Y:
        raise ValueError(f"{r} rows exceed the kernel's grid")
    out = torch.empty((r, n), dtype=torch.float32, device=x.device)
    if r == 0 or n == 0:
        return out
    if x.dim() == 3:
        sxt, sxr = x.stride(0), x.stride(1)
        swt, swn = w.stride(0), w.stride(2)
    else:  # step t starts n_c columns of x / rows of w further on
        sxt, sxr = kc, x.stride(0)
        swt, swn = kc, w.stride(1)
    if op_stats.ACTIVE and op_stats.launch(
            "cim_codes_var" if adc is not None else "cim_codes",
            work(x, w, adc), x, torch.int8):
        return out
    launch = _launcher()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(x.data_ptr(), sxt, sxr, _aligned(x, sxt, sxr),
                     w.data_ptr(), swt, swn, _aligned(w, swt, swn),
                     None if adc is None else adc.data_ptr(),
                     float(np.float32(spec.adc_inv_step)),
                     float(-spec.q_max - 1), float(spec.q_max),
                     float(np.float32(spec.adc_step)), out.data_ptr(),
                     t, r, n, kc, k_total, int(emit_codes), plan.rows,
                     plan.slices, stream)
    if err != 0:
        raise RuntimeError(f"cim_codes launch failed: CUDA error {err}")
    # a launch recorded into a CUDA graph runs nothing until the graph
    # replays; the replaying code counts it there
    if not torch.cuda.is_current_stream_capturing():
        LAUNCHES["cim_codes_var" if adc is not None else "cim_codes"] += 1
    return out


cim_codes.launches = LAUNCHES
