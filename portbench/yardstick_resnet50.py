"""Operations and bytes of ResNet-50 v1.5's layers, from the configuration
file's layer list (the artifact manifest's form), for the readers of
`resblock_roofline` and `mfu.resnet50`.

`yardstick.layer_macs` knows neither padding, bottleneck blocks nor the
max pool and stays as it is; this file counts them: conv1 with its
padding, each block's four products (its 1x1 convs, its 3x3 conv at the
block's stride with padding 1, and a projection's 1x1 conv at the
stride), the pools (no MAC) and the classifier. Bytes are the int8 codes
a product reads once and writes once.
"""

from __future__ import annotations

from typing import Dict, List

from portbench.yardstick import bound_ms


def layers(config: dict) -> List[Dict]:
    """Per product of a configuration: the index of its layer in `layers`,
    kind ('conv1', 'conv1x1', 'conv3x3', 'close' for a block's last 1x1
    conv, 'projection', 'dense'), MACs, and the codes a product reads
    and writes per image ('close': its 3x3 conv's codes and the shortcut's
    input, the identity's codes at the block's output or the projection's
    at the block's input, in; the block's codes out; 'projection' counts
    its MACs alone, its bytes being in 'close')."""
    h, w, c = config["input_shape"]
    out = []
    for i, spec in enumerate(config["layers"]):
        kind = spec["kind"]
        if kind == "conv":
            k, s, p, n = spec["kernel"], spec["stride"], spec.get("pad", 0), \
                spec["out_ch"]
            oh, ow = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
            out.append({"index": i, "kind": "conv1", "in": h * w * c,
                        "out": oh * ow * n, "macs": oh * ow * k * k * c * n})
            h, w, c = oh, ow, n
        elif kind == "maxpool":
            k, s, p = spec["kernel"], spec["stride"], spec["pad"]
            h, w = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
        elif kind == "bottleneck":
            s, mid, n = spec["stride"], spec["mid"], spec["out_ch"]
            oh, ow = (h - 1) // s + 1, (w - 1) // s + 1
            out.append({"index": i, "kind": "conv1x1", "in": h * w * c,
                        "out": h * w * mid, "macs": h * w * c * mid})
            out.append({"index": i, "kind": "conv3x3", "in": h * w * mid,
                        "out": oh * ow * mid, "macs": oh * ow * 9 * mid * mid})
            shortcut = oh * ow * (c if spec["projection"] else n)
            out.append({"index": i, "kind": "close",
                        "in": oh * ow * mid + shortcut, "out": oh * ow * n,
                        "macs": oh * ow * mid * n})
            if spec["projection"]:
                out.append({"index": i, "kind": "projection", "in": 0,
                            "out": 0, "macs": oh * ow * c * n})
            h, w, c = oh, ow, n
        elif kind == "avgpool":
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
    """Integer MACs per image (4,089,184,256 for ResNet-50 at width 1)."""
    return sum(x["macs"] for x in layers(config))


def resblock_bound_ms(config: dict, batch: float) -> float:
    """The least time the 16 block-closing 1x1 convs with their shortcut
    could take at `batch` images, summed block by block: each block's
    operations (its last product, and its projection's where it has one)
    at the int8 peak or its codes read (the 3x3 conv's, the shortcut's)
    and written at the memory rate, whichever is larger."""
    per = {}
    for x in layers(config):
        if x["kind"] in ("close", "projection"):
            d = per.setdefault(x["index"], {"macs": 0, "bytes": 0})
            d["macs"] += x["macs"]
            d["bytes"] += x["in"] + x["out"]
    return sum(bound_ms(2.0 * batch * d["macs"], batch * d["bytes"])
               for d in per.values())
