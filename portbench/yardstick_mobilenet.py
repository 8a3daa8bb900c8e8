"""Operations and bytes of MobileNet-v1's layers, from the configuration
file's layer list (the artifact manifest's form), for the readers of
`dwconv_roofline`, `pwconv_roofline` and `mfu.mobilenetv1`.

`yardstick.layer_macs` knows neither depthwise convs nor padding and
stays as it is; this file counts what it cannot: a conv's and a
depthwise conv's output size with padding, a depthwise conv's K² MACs a
pixel and channel, the average pool (no MAC) and the dense classifier.
Bytes are the int8 codes a layer reads once and writes once.
"""

from __future__ import annotations

from typing import Dict, List

from portbench.yardstick import bound_ms


def layers(config: dict) -> List[Dict]:
    """Per conv, depthwise conv and dense layer of a configuration: its
    index in `layers`, kind ('conv', 'dwconv', 'pwconv' for a 1x1 conv,
    'dense'), MACs, input and output elements per image."""
    h, w, c = config["input_shape"]
    out = []
    for i, spec in enumerate(config["layers"]):
        kind = spec["kind"]
        if kind in ("conv", "dwconv"):
            k, s, p = spec["kernel"], spec["stride"], spec.get("pad", 0)
            n = spec["out_ch"] if kind == "conv" else c
            oh = (h + 2 * p - k) // s + 1
            ow = (w + 2 * p - k) // s + 1
            macs = oh * ow * k * k * (c * n if kind == "conv" else c)
            if kind == "conv" and k == 1:
                kind = "pwconv"
            out.append({"index": i, "kind": kind, "in": h * w * c,
                        "out": oh * ow * n, "macs": macs})
            h, w, c = oh, ow, n
        elif kind in ("pool", "avgpool"):
            h //= spec["window"]
            w //= spec["window"]
        else:
            n = spec["out_features"]
            out.append({"index": i, "kind": "dense", "in": h * w * c,
                        "out": n, "macs": h * w * c * n})
            h = w = 1
            c = n
    return out


def network_macs(config: dict) -> int:
    """Integer MACs per image (568,740,352 for MobileNet-v1 at width 1)."""
    return sum(x["macs"] for x in layers(config))


def kind_bound_ms(config: dict, kind: str, batch: float) -> float:
    """The least time the layers of `kind` could take at `batch` images,
    summed layer by layer: each layer's operations at the int8 peak or
    its codes read and written at the memory rate, whichever is larger."""
    return sum(bound_ms(2.0 * batch * x["macs"],
                        batch * (x["in"] + x["out"]))
               for x in layers(config) if x["kind"] == kind)
