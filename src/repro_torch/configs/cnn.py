"""CNN benchmark configs — the paper's own evaluation models.

VGG-11 (CIFAR-10, as in Jia et al. [23]), VGG-16/19 (ImageNet),
ResNet-18 (CIFAR-10), ResNet-50 (ImageNet).  These drive the mapping
planner (Fig. 7), the utilization analysis (Fig. 12) and the energy /
throughput model (Tab. 4).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ConvLayer:
    name: str
    h: int  # input height
    w: int  # input width
    c: int  # input channels
    m: int  # output channels
    k: int = 3
    s: int = 1
    p: int = 1
    pool_k: int = 0  # max-pool applied after this layer (0 = none)
    pool_s: int = 0
    residual_from: Optional[str] = None  # ResNet shortcut source layer

    @property
    def out_h(self) -> int:
        e = (self.h + 2 * self.p - self.k + self.s) // self.s
        return e // self.pool_s if self.pool_s else e

    @property
    def out_w(self) -> int:
        f = (self.w + 2 * self.p - self.k + self.s) // self.s
        return f // self.pool_s if self.pool_s else f

    @property
    def conv_out_h(self) -> int:
        return (self.h + 2 * self.p - self.k + self.s) // self.s

    @property
    def conv_out_w(self) -> int:
        return (self.w + 2 * self.p - self.k + self.s) // self.s

    @property
    def macs(self) -> int:
        return self.conv_out_h * self.conv_out_w * self.m * self.c * self.k * self.k


@dataclass(frozen=True)
class FCLayer:
    name: str
    c_in: int
    c_out: int

    @property
    def macs(self) -> int:
        return self.c_in * self.c_out


@dataclass(frozen=True)
class CNNConfig:
    name: str
    dataset: str  # cifar10 | imagenet
    input_hw: int
    layers: Tuple = field(default_factory=tuple)

    @property
    def total_macs(self) -> int:
        return sum(l.macs for l in self.layers)

    @property
    def total_ops(self) -> int:  # 1 MAC = 2 OPs (paper convention)
        return 2 * self.total_macs

    @property
    def conv_layers(self) -> Tuple[ConvLayer, ...]:
        return tuple(l for l in self.layers if isinstance(l, ConvLayer))

    @property
    def weight_count(self) -> int:
        n = 0
        for l in self.layers:
            if isinstance(l, ConvLayer):
                n += l.m * l.c * l.k * l.k
            else:
                n += l.c_in * l.c_out
        return n


def _vgg(name: str, plan, dataset: str, hw: int, fc: Tuple[int, ...]) -> CNNConfig:
    layers = []
    h = w = hw
    c = 3
    i = 0
    pending_pool = False
    specs = []
    for item in plan:
        if item == "M":
            # fold the pool into the previous conv layer
            prev = specs[-1]
            specs[-1] = (prev[0], prev[1], 2, 2)
        else:
            specs.append((item, 3, 0, 0))
    for m, k, pool_k, pool_s in specs:
        layers.append(
            ConvLayer(f"conv{i}", h=h, w=w, c=c, m=m, k=k, s=1, p=1,
                      pool_k=pool_k, pool_s=pool_s)
        )
        h, w, c = layers[-1].out_h, layers[-1].out_w, m
        i += 1
    c_in = c * h * w
    for j, c_out in enumerate(fc):
        layers.append(FCLayer(f"fc{j}", c_in, c_out))
        c_in = c_out
    return CNNConfig(name=name, dataset=dataset, input_hw=hw, layers=tuple(layers))


_VGG11 = [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"]
_VGG16 = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
          512, 512, 512, "M", 512, 512, 512, "M"]
_VGG19 = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
          512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]


def vgg11_cifar10() -> CNNConfig:
    # VGG-11 as used by Jia et al. [23] on CIFAR-10 (32x32)
    return _vgg("vgg11-cifar10", _VGG11, "cifar10", 32, (512, 10))


def vgg16_imagenet() -> CNNConfig:
    return _vgg("vgg16-imagenet", _VGG16, "imagenet", 224, (4096, 4096, 1000))


def vgg19_imagenet() -> CNNConfig:
    return _vgg("vgg19-imagenet", _VGG19, "imagenet", 224, (4096, 4096, 1000))


def _res_block(layers, name, h, w, c, m, s, bottleneck: bool):
    """Append one residual block's conv layers; returns (h, w, c_out)."""
    if bottleneck:
        layers.append(ConvLayer(f"{name}_a", h, w, c, m, k=1, s=1, p=0))
        layers.append(ConvLayer(f"{name}_b", h, w, m, m, k=3, s=s, p=1))
        h2, w2 = layers[-1].out_h, layers[-1].out_w
        layers.append(ConvLayer(f"{name}_c", h2, w2, m, 4 * m, k=1, s=1, p=0,
                                residual_from=f"{name}_a"))
        if s != 1 or c != 4 * m:
            layers.append(ConvLayer(f"{name}_sc", h, w, c, 4 * m, k=1, s=s, p=0))
        return h2, w2, 4 * m
    layers.append(ConvLayer(f"{name}_a", h, w, c, m, k=3, s=s, p=1))
    h2, w2 = layers[-1].out_h, layers[-1].out_w
    layers.append(ConvLayer(f"{name}_b", h2, w2, m, m, k=3, s=1, p=1,
                            residual_from=f"{name}_a"))
    if s != 1 or c != m:
        layers.append(ConvLayer(f"{name}_sc", h, w, c, m, k=1, s=s, p=0))
    return h2, w2, m


def resnet18_cifar10() -> CNNConfig:
    layers = []
    h = w = 32
    layers.append(ConvLayer("stem", h, w, 3, 64, k=3, s=1, p=1))  # CIFAR stem
    c = 64
    for stage, (m, n_blocks) in enumerate([(64, 2), (128, 2), (256, 2), (512, 2)]):
        for b in range(n_blocks):
            s = 2 if (b == 0 and stage > 0) else 1
            h, w, c = _res_block(layers, f"s{stage}b{b}", h, w, c, m, s, False)
    layers.append(FCLayer("fc", c, 10))  # global-avg-pool then FC
    return CNNConfig("resnet18-cifar10", "cifar10", 32, tuple(layers))


def resnet50_imagenet() -> CNNConfig:
    layers = []
    # Domino's tail pooling hardware (Fig. 9) supports K_p == S_p only, so
    # the stem's canonical overlapping 3x3/s2 max-pool deploys as a 2x2/s2
    # pool here: same 112 -> 56 geometry (the overlapping variant would
    # yield 55 without pool padding, contradicting the declared layer
    # shapes), identical MAC/energy anchors (Tab. 4 counts conv MACs and
    # pre-pool rates only).
    layers.append(ConvLayer("stem", 224, 224, 3, 64, k=7, s=2, p=3,
                            pool_k=2, pool_s=2))
    h = w = 56
    c = 64
    for stage, (m, n_blocks) in enumerate([(64, 3), (128, 4), (256, 6), (512, 3)]):
        for b in range(n_blocks):
            s = 2 if (b == 0 and stage > 0) else 1
            h, w, c = _res_block(layers, f"s{stage}b{b}", h, w, c, m, s, True)
    layers.append(FCLayer("fc", c, 1000))
    return CNNConfig("resnet50-imagenet", "imagenet", 224, tuple(layers))


CNN_BENCHMARKS = {
    "vgg11-cifar10": vgg11_cifar10,
    "vgg16-imagenet": vgg16_imagenet,
    "vgg19-imagenet": vgg19_imagenet,
    "resnet18-cifar10": resnet18_cifar10,
    "resnet50-imagenet": resnet50_imagenet,
}
