"""Layer -> tile mapping planner (paper §5: Figs. 4, 6, 7, 12).

Computes, per CNN layer: tiles per weight copy, in-buffer tap packing,
crossbar utilization, weight duplication for rate synchronization
(pixels ratio, capped at the paper's 64-row input parallelism), and the
block-reuse trade-off (Fig. 7: chip size vs throughput).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Mapping, Optional, Tuple

from repro_torch.configs.cnn import CNNConfig, ConvLayer, FCLayer

#: the paper's maximum weight-duplication factor (Fig. 7 tops out at 64 —
#: the input buffer feeds at most 64 rows in parallel)
MAX_DUPLICATION = 64


@dataclass(frozen=True)
class LayerPlan:
    name: str
    kind: str  # "conv" | "fc"
    tiles_per_copy: int
    pack: int                # taps sharing one tile via in-buffer shifting
    c_splits: int            # input-channel splits (C > N_c)
    m_splits: int            # output-channel splits (M > N_m)
    duplication: int         # weight copies after reuse
    utilization: float       # used cells / allocated cells
    macs: int
    out_pixels: int          # E*F (1 for FC)
    in_pixels: int           # H*W of the (unpadded) input stream
    chain_len: int           # tiles a pixel traverses in one copy
    c_in: int = 0
    c_out: int = 0
    k: int = 1

    @property
    def total_tiles(self) -> int:
        return self.tiles_per_copy * self.duplication


@dataclass(frozen=True)
class NetworkPlan:
    model: str
    n_c: int
    n_m: int
    reuse: int
    layers: Tuple[LayerPlan, ...]

    @property
    def total_tiles(self) -> int:
        return sum(l.total_tiles for l in self.layers)

    @property
    def total_macs(self) -> int:
        return sum(l.macs for l in self.layers)

    @property
    def utilization(self) -> float:
        """Weight-weighted crossbar utilization (Fig. 12's metric)."""
        used = sum(l.utilization * l.tiles_per_copy for l in self.layers)
        alloc = sum(l.tiles_per_copy for l in self.layers)
        return used / alloc

    @property
    def initiation_interval(self) -> int:
        """Steady-state cycles between inferences = the slowest conv
        stage's pixel stream divided by its duplication (validated against
        Tab. 4: CIFAR 1024/64 = 16 -> 6.25e5 inf/s; ImageNet 50176/64 =
        784 -> 1.28e4 inf/s at the 10 MHz step clock).  Under rate-sync
        duplication the first layer is always the bottleneck; per-layer
        ``dup_overrides`` (DSE) can move it downstream."""
        return max(
            max(1, math.ceil(l.out_pixels / l.duplication))
            for l in self.layers if l.kind == "conv")

    @property
    def latency_cycles(self) -> int:
        """Pipeline depth: first stream + per-layer fill (K rows) + FC."""
        first = self.layers[0]
        cyc = first.in_pixels
        for l in self.layers[1:]:
            if l.kind == "conv":
                side = int(math.sqrt(max(1, l.in_pixels)))
                cyc += 3 * (side + 2)  # ~K rows of fill at the layer's width
            else:
                cyc += l.chain_len
        return cyc


def plan_conv(layer: ConvLayer, n_c: int, n_m: int, duplication: int) -> LayerPlan:
    c, m, k = layer.c, layer.m, layer.k
    m_splits = math.ceil(m / n_m)
    if c <= n_c:
        pack = min(k, max(1, n_c // c))
        tiles_per_row = math.ceil(k / pack)
        c_splits = 1
        tiles = k * tiles_per_row * m_splits
        chain = k * tiles_per_row
    else:
        pack = 1
        c_splits = math.ceil(c / n_c)
        tiles = k * k * c_splits * m_splits
        chain = k * k * c_splits
    used_cells = k * k * c * m
    util = used_cells / (tiles * n_c * n_m)
    return LayerPlan(
        name=layer.name, kind="conv", tiles_per_copy=tiles, pack=pack,
        c_splits=c_splits, m_splits=m_splits, duplication=duplication,
        utilization=util, macs=layer.macs,
        out_pixels=layer.conv_out_h * layer.conv_out_w,
        in_pixels=layer.h * layer.w, chain_len=chain,
        c_in=c, c_out=m, k=k,
    )


def plan_fc(layer: FCLayer, n_c: int, n_m: int) -> LayerPlan:
    m_t = math.ceil(layer.c_in / n_c)
    m_a = math.ceil(layer.c_out / n_m)
    tiles = m_t * m_a
    util = (layer.c_in * layer.c_out) / (tiles * n_c * n_m)
    return LayerPlan(
        name=layer.name, kind="fc", tiles_per_copy=tiles, pack=1,
        c_splits=m_t, m_splits=m_a, duplication=1, utilization=util,
        macs=layer.macs, out_pixels=1, in_pixels=1, chain_len=m_t,
        c_in=layer.c_in, c_out=layer.c_out,
    )


def plan_network(cnn: CNNConfig, n_c: int = 256, n_m: int = 256,
                 reuse: int = 1,
                 dup_cap: int = MAX_DUPLICATION,
                 dup_overrides: Optional[Mapping[str, int]] = None
                 ) -> NetworkPlan:
    """Plan the whole network with rate-sync duplication / block reuse.

    duplication_l = min(dup_cap, out_pixels_l / out_pixels_last_conv)
    / reuse (>= 1).  ``reuse=1`` is full synchronization (max throughput,
    max tiles); ``reuse=4`` matches the paper's Fig. 7 economy point.
    ``dup_cap`` defaults to the paper's 64 (Tab. 4 ResNet-50 row implies
    128 — passed explicitly by that benchmark).

    ``dup_overrides`` caps individual layers below the rate-sync value
    (``{layer_name: cap}``) — the DSE mutates these to trade per-layer
    tiles for initiation interval.  An override can only *lower* a
    layer's duplication (raising it would break rate synchronization),
    and must stay within [1, MAX_DUPLICATION].
    """
    convs = [l for l in cnn.layers if isinstance(l, ConvLayer)]
    # rate ratios use pre-pool conv outputs (the rate at which results are
    # *produced*; pooling only thins what is forwarded)
    last_pixels = convs[-1].conv_out_h * convs[-1].conv_out_w
    overrides = dict(dup_overrides or {})
    unknown = set(overrides) - {l.name for l in convs}
    if unknown:
        raise ValueError(f"{cnn.name}: dup_overrides for unknown conv "
                         f"layers {sorted(unknown)}")
    plans: List[LayerPlan] = []
    for layer in cnn.layers:
        if isinstance(layer, ConvLayer):
            rate = (layer.conv_out_h * layer.conv_out_w) / last_pixels
            dup = max(1, min(dup_cap, round(rate)) // reuse)
            if layer.name in overrides:
                cap = overrides[layer.name]
                if not 1 <= cap <= MAX_DUPLICATION:
                    raise ValueError(
                        f"{cnn.name}: dup override {cap} for {layer.name} "
                        f"outside [1, {MAX_DUPLICATION}]")
                dup = min(dup, cap)
            plans.append(plan_conv(layer, n_c, n_m, dup))
        else:
            plans.append(plan_fc(layer, n_c, n_m))
    return NetworkPlan(model=cnn.name, n_c=n_c, n_m=n_m, reuse=reuse,
                       layers=tuple(plans))
