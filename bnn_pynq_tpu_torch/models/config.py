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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple, Union


@dataclass(frozen=True)
class ConvSpec:
    out_ch: int
    kernel: int = 3
    stride: int = 1


@dataclass(frozen=True)
class PoolSpec:
    window: int = 2


@dataclass(frozen=True)
class DenseSpec:
    out_features: int


LayerSpec = Union[ConvSpec, PoolSpec, DenseSpec]


@dataclass(frozen=True)
class NetworkConfig:
    name: str
    wbits: int
    abits: int
    input_kind: str               # 'bipolar' (±1 input) | 'int8'
    input_shape: Tuple[int, int, int]   # (H, W, C)
    layers: Tuple[LayerSpec, ...]
    num_classes: int
    dataset: str = ""

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
