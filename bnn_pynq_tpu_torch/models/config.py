"""Typed network configurations — a pure-Python copy of
`bnn_pynq_tpu/models/config.py` (copied, not imported: importing any
`bnn_pynq_tpu` submodule imports jax). Keep the two in step; the port's
tests compare them config by config.

The analogue of the reference's per-network `config.h` folding headers
(SURVEY.md C9 «bnn/src/network/<net>/hw/config.h»): topology and bit
widths; folding is replaced by the kernels' own tile sizes.

Topologies (SURVEY.md C9 «bnn/src/network/…/hw/top.cpp», FINN paper):
- SFC: 784-256-256-256-10 binary MLP (MNIST, bipolar input).
- LFC: 784-1024-1024-1024-10 binary MLP (MNIST, bipolar input).
- CNV: VGG-style — conv3x3(64), conv3x3(64), pool2; conv3x3(128),
  conv3x3(128), pool2; conv3x3(256), conv3x3(256); fc(512), fc(512),
  fc(classes). 32×32 RGB int8 input, all convs VALID.
  Spatial trace: 32→30→28→14→12→10→5→3→1.

Beside them, outside `AVAILABLE_CONFIGS` (which stays equal to the JAX
package's), `mobilenet_v1()`: MobileNet-v1 W4A4 of FINN's model zoo
(Xilinx/finn-examples `mobilenetv1-w4a4`, built from Brevitas's
`quant_mobilenet_v1`; topology: Howard et al., arXiv:1704.04861,
Table 1): conv3×3 s2 (32) with 8-bit weights on the int8 image, 13
depthwise-separable blocks (a depthwise 3×3 conv, then a 1×1 pointwise
conv) with 4-bit weights, SAME zero padding (pad 1) on every 3×3 conv,
unsigned 4-bit activations (level = code), a thresholded 7×7 average
pool and a 1024→classes dense layer with 8-bit weights; and
`resnet50_v1_5()`: ResNet-50 v1.5 W1A2 of FINN's model zoo
(Xilinx/finn-examples `resnet50-w1a2`; topology: He et al.,
arXiv:1512.03385, Table 1, with the stride of each downsampling block on
its 3×3 conv as in v1.5): conv7×7 s2 pad 3 (64) with 8-bit weights on
the int8 image, a 3×3 s2 pad 1 max pool, 16 bottleneck blocks with 1-bit
weights whose shortcut joins before the block's last MultiThreshold,
unsigned 2-bit activations (level = code), a thresholded 7×7 average pool
and a 2048→classes dense layer with 8-bit weights. Only the `mega` route
and the reference forward run these two (`NetworkConfig.mega_only`).
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import ClassVar, Tuple, Union

from bnn_pynq_tpu_torch.ops.thresholds import codes_are_levels


def _repr_set(self) -> str:
    """The dataclass repr without the port-only fields `pad`, `wbits` and
    `unsigned` where they hold their default, so that the BNN-PYNQ
    configs print as the JAX package's do."""
    args = ", ".join(f"{f.name}={getattr(self, f.name)!r}"
                     for f in fields(self)
                     if f.name not in ("pad", "wbits", "unsigned")
                     or getattr(self, f.name) != f.default)
    return f"{type(self).__name__}({args})"


@dataclass(frozen=True, repr=False)
class ConvSpec:
    out_ch: int
    kernel: int = 3
    stride: int = 1
    pad: int = 0                  # zero padding on each side (1: SAME 3×3)
    wbits: int = 0                # the layer's weight width; 0: the net's
    __repr__ = _repr_set


@dataclass(frozen=True, repr=False)
class DepthwiseSpec:
    """A per-channel 3×3 conv (groups = channels), SAME-padded: the only
    kernel size and padding the port's depthwise conv takes."""
    kernel: ClassVar[int] = 3
    pad: ClassVar[int] = 1
    stride: int = 1
    wbits: int = 0
    __repr__ = _repr_set


@dataclass(frozen=True)
class PoolSpec:
    window: int = 2


@dataclass(frozen=True)
class MaxPoolSpec:
    """An overlapping max pool, zero-padded: on unsigned codes (never
    below 0) the padding never wins, so it is the max pool that pads with
    −∞. ResNet's 3×3, stride 2, pad 1."""
    kernel: int = 3
    stride: int = 2
    pad: int = 1


@dataclass(frozen=True)
class AvgPoolSpec:
    """A thresholded average pool: the int32 sum of each window's codes,
    then a MultiThreshold (the artifact's thresholds carry the divisor)."""
    window: int = 7


@dataclass(frozen=True, repr=False)
class DenseSpec:
    out_features: int
    wbits: int = 0
    __repr__ = _repr_set


@dataclass(frozen=True)
class BottleneckSpec:
    """A ResNet bottleneck block (v1.5) on input codes x of C channels:
    a = MT(conv1×1(x; W_a)), b = MT(conv3×3(a; W_b, stride, pad 1)),
    y = MT(conv1×1(b; W_c) + r ⊙ p), r an int32 multiplier a channel and
    p the shortcut: x itself, or with `projection` conv1×1(x; W_p,
    stride), an int32 accumulator. mid: the width of a and b; out: y's."""
    mid: int
    out: int
    stride: int = 1
    projection: bool = False
    wbits: int = 0


LayerSpec = Union[ConvSpec, DepthwiseSpec, PoolSpec, MaxPoolSpec,
                  AvgPoolSpec, BottleneckSpec, DenseSpec]


@dataclass(frozen=True, repr=False)
class NetworkConfig:
    name: str
    wbits: int
    abits: int
    input_kind: str               # 'bipolar' (±1 input) | 'int8'
    input_shape: Tuple[int, int, int]   # (H, W, C)
    layers: Tuple[LayerSpec, ...]
    num_classes: int
    dataset: str = ""
    # 2-bit activation codes are unsigned (a QuantReLU's: level = code)
    # rather than bipolar (level 2c − 3): ResNet-50's; `codes_are_levels`
    # reads it with the width
    unsigned: bool = False
    __repr__ = _repr_set

    @property
    def bits(self) -> int:
        """Packing width shared by weights and activations of the packed
        layers: 1 only for W1A1; otherwise 2 (±1 weights of W1A2 layers are
        stored as 2-bit codes so both operands share one decode path —
        see ops/matmul.py docstring)."""
        return 1 if (self.wbits == 1 and self.abits == 1) else 2

    @property
    def nthr(self) -> int:
        """Thresholds per channel for the activation quantizer."""
        return (1 << self.abits) - 1

    @property
    def codes_are_levels(self) -> bool:
        """The activation codes are unsigned, their own levels
        (`ops/thresholds.py::codes_are_levels` of the width and
        `unsigned`)."""
        return codes_are_levels(self.abits, self.unsigned)

    @property
    def mega_only(self) -> bool:
        """What only the `mega` route and the reference forward run:
        depthwise, padded or residual layers, average or overlapping max
        pools, unsigned codes."""
        return self.codes_are_levels or any(
            isinstance(s, (DepthwiseSpec, AvgPoolSpec, MaxPoolSpec,
                           BottleneckSpec)) or
            getattr(s, "pad", 0) for s in self.layers)

    def scheme(self) -> str:
        return f"W{self.wbits}A{self.abits}"


def sfc(wbits: int = 1, abits: int = 1) -> NetworkConfig:
    return NetworkConfig(
        name=f"sfc-w{wbits}a{abits}", wbits=wbits, abits=abits,
        input_kind="bipolar", input_shape=(28, 28, 1),
        layers=(DenseSpec(256), DenseSpec(256), DenseSpec(256),
                DenseSpec(10)),
        num_classes=10, dataset="mnist")


def lfc(wbits: int = 1, abits: int = 1) -> NetworkConfig:
    return NetworkConfig(
        name=f"lfc-w{wbits}a{abits}", wbits=wbits, abits=abits,
        input_kind="bipolar", input_shape=(28, 28, 1),
        layers=(DenseSpec(1024), DenseSpec(1024), DenseSpec(1024),
                DenseSpec(10)),
        num_classes=10, dataset="mnist")


def cnv(wbits: int = 1, abits: int = 1, num_classes: int = 10,
        dataset: str = "cifar10") -> NetworkConfig:
    return NetworkConfig(
        name=f"cnv-w{wbits}a{abits}" + (f"-{dataset}" if dataset != "cifar10" else ""),
        wbits=wbits, abits=abits,
        input_kind="int8", input_shape=(32, 32, 3),
        layers=(ConvSpec(64), ConvSpec(64), PoolSpec(),
                ConvSpec(128), ConvSpec(128), PoolSpec(),
                ConvSpec(256), ConvSpec(256),
                DenseSpec(512), DenseSpec(512), DenseSpec(num_classes)),
        num_classes=num_classes, dataset=dataset)


# MobileNet-v1's separable blocks at width multiplier 1: (pointwise
# width, depthwise stride), Table 1 of arXiv:1704.04861
MOBILENET_V1_BLOCKS = ((64, 1), (128, 2), (128, 1), (256, 2), (256, 1),
                       (512, 2), (512, 1), (512, 1), (512, 1), (512, 1),
                       (512, 1), (1024, 2), (1024, 1))


def mobilenet_v1(width: float = 1.0, num_classes: int = 1000) -> NetworkConfig:
    """MobileNet-v1 W4A4 on 224×224×3 int8 image levels: 28 convs, every
    width scaled by `width` (1/16 gives channels 2 to 64, for tests)."""
    def ch(n):
        return max(1, int(n * width))
    layers = [ConvSpec(ch(32), kernel=3, stride=2, pad=1, wbits=8)]
    for n, s in MOBILENET_V1_BLOCKS:
        layers += [DepthwiseSpec(stride=s, wbits=4),
                   ConvSpec(ch(n), kernel=1, stride=1, wbits=4)]
    layers += [AvgPoolSpec(7), DenseSpec(num_classes, wbits=8)]
    return NetworkConfig(
        name=("mobilenetv1-w4a4" if (width, num_classes) == (1.0, 1000)
              else f"mobilenetv1-w4a4-x{width:g}-c{num_classes}"),
        wbits=4, abits=4, input_kind="int8", input_shape=(224, 224, 3),
        layers=tuple(layers), num_classes=num_classes, dataset="imagenet")


# ResNet-50's stages: (blocks, mid width, out width, stride of the first
# block), Table 1 of arXiv:1512.03385
RESNET50_STAGES = ((3, 64, 256, 1), (4, 128, 512, 2), (6, 256, 1024, 2),
                   (3, 512, 2048, 2))


def resnet50_v1_5(width: float = 1.0, num_classes: int = 1000,
                  image: int = 224) -> NetworkConfig:
    """ResNet-50 v1.5 W1A2 on image×image×3 int8 image levels: the image
    conv, the max pool, 16 bottleneck blocks (the first of each stage
    with a projection shortcut, its stride on the 3×3 conv and the
    projection), the average pool over the image/32 map and the
    classifier; every width scaled by `width` (1/16 gives 4 to 128
    channels) and `image` a multiple of 32, for tests."""
    if image % 32:
        raise ValueError(f"image {image}: ResNet-50 halves it five times")

    def ch(n):
        return max(1, int(n * width))
    layers = [ConvSpec(ch(64), kernel=7, stride=2, pad=3, wbits=8),
              MaxPoolSpec()]
    for blocks, mid, out, stride in RESNET50_STAGES:
        layers += [BottleneckSpec(ch(mid), ch(out), stride if i == 0 else 1,
                                  projection=i == 0, wbits=1)
                   for i in range(blocks)]
    layers += [AvgPoolSpec(image // 32), DenseSpec(num_classes, wbits=8)]
    return NetworkConfig(
        name=("resnet50-w1a2" if (width, num_classes, image) ==
              (1.0, 1000, 224) else
              f"resnet50-w1a2-x{width:g}-c{num_classes}-i{image}"),
        wbits=1, abits=2, input_kind="int8", input_shape=(image, image, 3),
        layers=tuple(layers), num_classes=num_classes, dataset="imagenet",
        unsigned=True)


AVAILABLE_CONFIGS = {
    # The five reference overlays (SURVEY.md C9) + SFC variants.
    "sfc-w1a1": lambda: sfc(1, 1),
    "sfc-w1a2": lambda: sfc(1, 2),
    "lfc-w1a1": lambda: lfc(1, 1),
    "lfc-w1a2": lambda: lfc(1, 2),
    "cnv-w1a1": lambda: cnv(1, 1),
    "cnv-w1a2": lambda: cnv(1, 2),
    "cnv-w2a2": lambda: cnv(2, 2),
    "cnv-w1a1-svhn": lambda: cnv(1, 1, dataset="svhn"),
    "cnv-w2a2-svhn": lambda: cnv(2, 2, dataset="svhn"),
    "cnv-w1a1-gtsrb": lambda: cnv(1, 1, num_classes=43, dataset="gtsrb"),
    "cnv-w2a2-gtsrb": lambda: cnv(2, 2, num_classes=43, dataset="gtsrb"),
}


def get_config(name: str) -> NetworkConfig:
    try:
        return AVAILABLE_CONFIGS[name.lower()]()
    except KeyError:
        raise KeyError(
            f"unknown network '{name}'; available: {sorted(AVAILABLE_CONFIGS)}")
