"""The benchmark's own arithmetic: peaks of the card, operations and bytes
of a network's layers, read from the configuration file.

`network_macs` is a frozen copy of `bnn_pynq_tpu_torch/utils/metrics.py::
network_macs`, and `bound_ms` of `chip_smoke.py::_bounds`, on the layer
list of `portbench/configs/<config>.json` (the artifact manifest's form),
so that a change to the program cannot move the yardstick.

Peaks: NVIDIA H100 SXM data sheet, dense, at the full 700 W limit.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

PEAK_INT8_OPS = 1979e12        # int8 tensor-core operations/s
PEAK_BYTES = 3.35e12           # HBM3 bytes/s


def layer_macs(config: dict) -> List[Dict]:
    """Per compute layer of a configuration: its index in `layers`, kind,
    MACs per image, input and output elements per image (int8 codes)."""
    h, w, c = config["input_shape"]
    out = []
    flat = False
    for i, spec in enumerate(config["layers"]):
        if spec["kind"] == "pool":
            h //= spec["window"]
            w //= spec["window"]
            continue
        if spec["kind"] == "conv":
            k, s, n = spec["kernel"], spec["stride"], spec["out_ch"]
            oh = (h - k) // s + 1
            ow = (w - k) // s + 1
            out.append({"index": i, "kind": "conv", "in": h * w * c,
                        "out": oh * ow * n, "macs": oh * ow * k * k * c * n})
            h, w, c = oh, ow, n
        else:
            n = spec["out_features"]
            k = c if flat else h * w * c
            flat = True
            out.append({"index": i, "kind": "dense", "in": k, "out": n,
                        "macs": k * n})
            h = w = 1
            c = n
    return out


def network_macs(config: dict) -> int:
    """Integer MACs per image (conv and dense layers)."""
    return sum(layer["macs"] for layer in layer_macs(config))


def bound_ms(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    at the int8 peak and the bytes at the memory rate."""
    return max(ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES) * 1e3


def conv_chain_bound_ms(config: dict, batch: int, first: int,
                        last: int) -> float:
    """Bound of the conv layers with `layers` indices in [first, last] at
    `batch` images (pools between them are not counted): their
    operations, the first's input bytes read once and the last's output
    bytes written once."""
    convs = [x for x in layer_macs(config)
             if first <= x["index"] <= last and x["kind"] == "conv"]
    ops = 2 * batch * sum(x["macs"] for x in convs)
    nbytes = batch * (convs[0]["in"] + convs[-1]["out"])
    return bound_ms(ops, nbytes)


def percentile(values, q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least q% of
    the values at or below it."""
    v = np.sort(np.asarray(values, dtype=np.float64).ravel())
    return float(v[max(0, math.ceil(q / 100.0 * v.size) - 1)])
