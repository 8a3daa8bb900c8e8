"""Structured metrics and roofline accounting.

Port of `bnn_pynq_tpu/utils/metrics.py`, with the one card the port runs
on. The roofline model of an NVIDIA H100 SXM5 80GB HBM3 at its 700 W
power limit (NVIDIA's data sheet, dense rates; the figures
`chip_smoke.py` divides by):

- int8 on the tensor cores: 1,979e12 operations/s (2 per MAC); the
  decoded-int8 routes and every conv kernel run there (`mma.sync` alone
  reaches about 1,260e12 on the card, `tools/layer_times.py`'s `rates`);
- 1-bit operands on the tensor cores (`mma.sync...b1.and.popc`, the
  `vpu` route's `packed_matmul`): the data sheet publishes no rate; the
  1-bit `mma` does 8 × the int8 `mma`'s operations at the same
  instruction rate, so 8 × 1,979e12 operations/s;
- device memory: 3.35e12 bytes/s.

`ChipSpec` keeps the JAX field names. `vpu_lane_ops_per_sec` means on
this card the 1-bit `mma` rate above in operations/s (2 per binary MAC),
not the TPU's vector unit, and `vpu_bitop_roofline_images_per_sec` reads
it so.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from bnn_pynq_tpu_torch.models.network import make_plan


@dataclass(frozen=True)
class ChipSpec:
    name: str
    int8_ops_per_sec: float      # tensor-core int8 operations (2 per MAC)
    vpu_lane_ops_per_sec: float  # tensor-core 1-bit operations (2 per MAC)
    hbm_bytes_per_sec: float


_CHIPS = {
    "h100": ChipSpec("h100", 1979e12, 8 * 1979e12, 3.35e12),
}


def chip_specs(name: Optional[str] = None) -> ChipSpec:
    """The card's spec; "h100" (the default) is the one the port has."""
    name = name or "h100"
    if name not in _CHIPS:
        raise ValueError(f"no spec for {name!r}; one of {sorted(_CHIPS)}")
    return _CHIPS[name]


def network_macs(config) -> int:
    """Integer MACs per image for a NetworkConfig (conv + dense layers)."""
    h, w, _ = config.input_shape
    total = 0
    for lp in make_plan(config):
        if lp.kind == "pool":
            h //= lp.window
            w //= lp.window
        elif lp.kind in ("conv", "conv_int8"):
            oh = (h - lp.kernel) // lp.stride + 1
            ow = (w - lp.kernel) // lp.stride + 1
            total += oh * ow * lp.k * lp.n
            h, w = oh, ow
        else:
            total += lp.k * lp.n
            h = w = 1
    return total


def mxu_roofline_images_per_sec(config,
                                chip: Optional[ChipSpec] = None) -> float:
    """Images/s if every MAC ran at the card's int8 tensor-core peak."""
    chip = chip or chip_specs()
    return chip.int8_ops_per_sec / (2 * network_macs(config))


def vpu_bitop_roofline_images_per_sec(config,
                                      chip: Optional[ChipSpec] = None
                                      ) -> float:
    """Images/s if every MAC ran as a 1-bit tensor-core operation pair at
    the card's 1-bit rate (the `vpu` route's physics)."""
    chip = chip or chip_specs()
    return chip.vpu_lane_ops_per_sec / (2 * network_macs(config))


def roofline_fraction(config, images_per_sec: float,
                      chip: Optional[ChipSpec] = None) -> float:
    return images_per_sec / mxu_roofline_images_per_sec(config, chip)


@dataclass
class RunMetrics:
    """Accumulates a run's metrics and writes one JSON file/line."""
    name: str
    values: Dict[str, float] = field(default_factory=dict)
    t0: float = field(default_factory=time.time)

    def record(self, **kw):
        self.values.update({k: float(v) for k, v in kw.items()})
        return self

    def emit(self, path: Optional[str] = None) -> str:
        payload = {"run": self.name, "wall_s": time.time() - self.t0,
                   **self.values}
        line = json.dumps(payload)
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, "a") as f:
                f.write(line + "\n")
        return line
