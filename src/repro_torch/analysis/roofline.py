"""The roofline of one dry-run cell on a device.

The reference's ``repro/analysis/roofline.py`` with the device as a
parameter.  Three terms per (arch x shape x mesh), in seconds:

    compute    = the sum over dtypes of the flops counted at that dtype
                 / its peak (``flops_by_dtype``; without it, all the
                 flops at the peak of the cell's dtype)
    memory     = bytes_per_device / HBM bandwidth
    collective = wire_bytes_per_device / the link bandwidth of one hop

The counts are one rank's (``analysis/op_stats.py::OpStats`` over the
rank's program, ``launch/dryrun_lib.py``); the collective wire bytes are
the ring's, as ``core/dataflow.py`` counts them (the reference's
``_WIRE_FACTOR``: all-reduce ``2 (k - 1) / k``, all-gather ``k - 1``
local parts, reduce-scatter and all-to-all ``(k - 1) / k``, a
collective-permute its operand).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass(frozen=True)
class Device:
    """One device of a mesh: its peak operations per second by dtype name
    (``"bfloat16"``, ``"int8"``, ``"float32"``), its memory bandwidth,
    and the bandwidth one ring hop gets (bytes a second, one way, to one
    peer)."""

    name: str
    peak_ops: Dict[str, float]
    hbm_bw: float
    link_bw: float

    def peak(self, dtype: str) -> float:
        if dtype not in self.peak_ops:
            raise ValueError(f"{self.name} has no peak for {dtype}: "
                             f"{sorted(self.peak_ops)}")
        return self.peak_ops[dtype]


#: NVIDIA H100 SXM5, dense rates (no sparsity), at the 700 W power limit:
#: 989.4 TFLOP/s bf16 and 1,978.9 TOP/s int8 on the tensor cores, 66.9
#: TFLOP/s float32 on the CUDA cores (the NVIDIA H100 Tensor Core GPU
#: Architecture white paper, its table of H100 SXM5 peaks: "Peak BF16
#: Tensor TFLOPS with FP32 Accumulate", "Peak INT8 Tensor TOPS", "Peak
#: FP32 TFLOPS (non-Tensor)"); 3.35 TB/s of HBM3 (the H100 data sheet,
#: SXM); NVLink 900 GB/s both ways to the other cards of the host
#: through NVSwitch (the data sheet), so 450 GB/s one way to one peer, the
#: bandwidth of one ring hop
H100_SXM = Device(
    name="NVIDIA H100 SXM",
    peak_ops={"bfloat16": 989.4e12, "int8": 1978.9e12, "float32": 66.9e12},
    hbm_bw=3.35e12,
    link_bw=450e9)


@dataclass
class Roofline:
    """One cell's roofline: the reference's fields and ``row()`` keys,
    with ``device``, the cell's ``dtype`` (whose peak the useful-FLOPs
    time uses) and ``flops_by_dtype`` (``flops_per_device`` split by the
    dtype whose peak each runs at: a float32 product runs at the CUDA
    cores' rate, not the tensor cores'; None: all at ``dtype``'s)."""

    arch: str
    shape: str
    mesh: str
    flops_per_device: float
    bytes_per_device: float
    wire_bytes_per_device: float
    model_flops_total: float
    chips: int
    device: Device = H100_SXM
    dtype: str = "bfloat16"
    op_counts: Dict[str, int] = field(default_factory=dict)
    memory_per_device: Optional[Dict[str, float]] = None
    flops_by_dtype: Optional[Dict[str, float]] = None

    @property
    def t_compute(self) -> float:
        if self.flops_by_dtype is None:
            return self.flops_per_device / self.device.peak(self.dtype)
        return sum(f / self.device.peak(d)
                   for d, f in self.flops_by_dtype.items())

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / self.device.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.wire_bytes_per_device / self.device.link_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_fraction(self) -> float:
        """model FLOPs / (counted flops x chips): how much of the counted
        compute is 'useful' (catches remat recompute, masked attention,
        padding)."""
        total = self.flops_per_device * self.chips
        return self.model_flops_total / max(total, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """Useful-FLOPs utilisation at the modeled bound:
        (model_flops / chips / peak) / t_bound."""
        t_useful = (self.model_flops_total / self.chips
                    / self.device.peak(self.dtype))
        return t_useful / max(self.t_bound, 1e-30)

    def row(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops_total,
            "hlo_flops_per_dev": self.flops_per_device,
            "bytes_per_dev": self.bytes_per_device,
            "wire_bytes_per_dev": self.wire_bytes_per_device,
            "useful_flops_frac": self.useful_flops_fraction,
            "roofline_fraction": self.roofline_fraction,
            "op_counts": self.op_counts,
            "memory": self.memory_per_device,
        }


def model_flops(cfg, shape, mtp: bool = False) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE), N excluding embeddings; D =
    tokens processed.  Train = fwd+bwd (6); prefill = fwd (2); decode =
    one token fwd (2)."""
    n_active = cfg.param_count(active_only=True)
    n_embed = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    n = max(n_active - n_embed, 1)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        mult = 6.0
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        mult = 2.0
    else:  # decode: one new token per sequence
        tokens = shape.global_batch
        mult = 2.0
    return mult * n * tokens
