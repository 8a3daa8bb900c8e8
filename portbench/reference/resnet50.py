"""Plain reference of ResNet-50 v1.5 W1A2 (FINN's `resnet50-w1a2`,
Xilinx/finn-examples `build/resnet50`, Petrica et al., arXiv:2011.07317;
topology: He et al., arXiv:1512.03385, Table 1, as v1.5, with the stride
of a downsampling block on its 3x3 conv).

Reads an artifact `.npz` with its own decoding and computes each layer
from the configuration file's equations, in float64 on whatever device it
is given:

- input: uint8 pixels become int8 levels `p - 128`; int8 frames are
  levels already;
- activations: unsigned 2-bit codes, the output of a QuantReLU: code in
  {0..3}, level = code; a MultiThreshold `MT` gives
  `code = sum_t (acc >= thr[t])` against 3 thresholds a channel;
- conv1: 7x7, stride 2, zero padding 3, 8-bit weights, then MT;
- maxpool: 3x3, stride 2, padding 1, on codes (the padding, below every
  code, never wins);
- a bottleneck block on input codes x: a = MT(conv1x1(x; W_a)),
  b = MT(conv3x3(a; W_b, stride s, padding 1)), c = conv1x1(b; W_c),
  p = x, or in a block with a projection p = conv1x1(x; W_p, stride s),
  and y = MT(c + r * p), r an integer multiplier a channel; 1-bit +-1
  weights;
- gap: the sum of each channel's codes over the last map (7x7 at 224),
  then MT (thresholds window**2 * t: the floor of the mean);
- fc: 8-bit weights on the pooled codes, int32 accumulators, logits
  `float32(acc) * scale + bias` as two float32 operations.

Every product is computed in float64 and rounded, which is exact: every
sum is an integer below 2**22 (the largest, conv1's, is below
147 * 128 * 127), far below 2**53, and the rounding also absorbs the
last-bit error of any convolution algorithm the library picks.

Weights: conv1 and fc hold int8 levels under `w_int8`, [K*K*C, N] in
(ki, kj, c) order and [K, N]; a block's W_a, W_b, W_c, W_p are 1-bit,
packed along K into uint32 words under `wa_packed`, `wb_packed`,
`wc_packed`, `wp_packed` ([ceil(K / 32), N]; bit j of word w is element
32 w + j of K, level 2 bit - 1), W_b's K in (ki, kj, c) order; a block's
`r` (int32 [out]), `thr_a`, `thr_b`, `thr`.

A reference module of the benchmark: `load`, `check` and `forward` (the
contract in `portbench/harness.py`). Imports numpy and torch only.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

THRESHOLDS = 3                      # unsigned 2-bit codes


@dataclass
class Layer:
    kind: str        # 'conv' | 'maxpool' | 'bottleneck' | 'avgpool' | 'dense'
    c_in: int = 0
    out: int = 0
    mid: int = 0
    kernel: int = 1
    stride: int = 1
    pad: int = 0
    projection: bool = False
    window: int = 0
    wbits: int = 0
    # int8 levels by name: 'w' (conv1, fc), 'wa', 'wb', 'wc', 'wp'
    w: Dict[str, np.ndarray] = field(default_factory=dict)
    r: Optional[np.ndarray] = None                 # int64 [out]
    thr: Dict[str, np.ndarray] = field(default_factory=dict)


@dataclass
class Net:
    config: dict                    # the manifest's config
    num_classes: int
    input_shape: tuple              # (H, W, C)
    layers: List[Layer]
    out_scale: np.ndarray           # float32 [classes]
    out_bias: np.ndarray            # float32 [classes]


def layers_of(cfg: dict) -> List[Layer]:
    """The layer list of a manifest config, without weights."""
    h, w, c = cfg["input_shape"]
    layers = []
    for spec in cfg["layers"]:
        kind = spec["kind"]
        wbits = spec.get("wbits", cfg["wbits"])
        if kind == "conv":
            k, s, p = spec["kernel"], spec["stride"], spec.get("pad", 0)
            layers.append(Layer(kind, c_in=c, out=spec["out_ch"], kernel=k,
                                stride=s, pad=p, wbits=wbits))
            h, w = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
            c = spec["out_ch"]
        elif kind == "maxpool":
            k, s, p = spec["kernel"], spec["stride"], spec["pad"]
            layers.append(Layer(kind, c_in=c, out=c, kernel=k, stride=s,
                                pad=p))
            h, w = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
        elif kind == "bottleneck":
            s = spec["stride"]
            layers.append(Layer(kind, c_in=c, out=spec["out_ch"],
                                mid=spec["mid"], kernel=3, stride=s, pad=1,
                                projection=spec["projection"], wbits=wbits))
            h, w = (h - 1) // s + 1, (w - 1) // s + 1
            c = spec["out_ch"]
        elif kind == "avgpool":
            layers.append(Layer(kind, c_in=c, out=c, window=spec["window"]))
            h //= spec["window"]
            w //= spec["window"]
        elif kind == "dense":
            layers.append(Layer(kind, c_in=h * w * c,
                                out=spec["out_features"], wbits=wbits))
            c, h, w = spec["out_features"], 1, 1
        else:
            raise ValueError(f"no layer kind {kind!r} in ResNet-50")
    return layers


def weight_shapes(layer: Layer) -> Dict[str, tuple]:
    """[K, N] of each weight of a layer, by its name in the artifact."""
    if layer.kind == "conv":
        return {"w_int8": (layer.kernel ** 2 * layer.c_in, layer.out)}
    if layer.kind == "dense":
        return {"w_int8": (layer.c_in, layer.out)}
    if layer.kind != "bottleneck":
        return {}
    shapes = {"wa_packed": (layer.c_in, layer.mid),
              "wb_packed": (9 * layer.mid, layer.mid),
              "wc_packed": (layer.mid, layer.out)}
    if layer.projection:
        shapes["wp_packed"] = (layer.c_in, layer.out)
    return shapes


def unpack_bits(words: np.ndarray, k: int) -> np.ndarray:
    """uint32 words [ceil(k / 32), N] -> int8 levels [k, N]: bit j of word
    w is element 32 w + j, level 2 bit - 1."""
    words = np.asarray(words).astype(np.uint32)
    bits = (words[:, None, :] >> np.arange(32, dtype=np.uint32)[None, :,
                                                                  None]) & 1
    bits = bits.reshape(-1, words.shape[1])[:k]
    return (2 * bits.astype(np.int16) - 1).astype(np.int8)


def load(path: str) -> Net:
    """Decode an artifact: its manifest (JSON bytes under `manifest`) and
    every layer's weights, multipliers and thresholds."""
    with np.load(path, allow_pickle=False) as z:
        manifest = json.loads(bytes(z["manifest"]).decode())
        arrays = {k: z[k] for k in z.files}
    cfg = manifest["config"]
    layers = layers_of(cfg)
    for i, layer in enumerate(layers):
        for name, (k, n) in weight_shapes(layer).items():
            a = arrays[f"layer{i}/{name}"]
            w = a.astype(np.int8) if name == "w_int8" else unpack_bits(a, k)
            if w.shape != (k, n) or (name != "w_int8" and
                                     a.shape != (-(-k // 32), n)):
                raise ValueError(f"layer {i} {name}: {a.shape}, expected "
                                 f"levels {(k, n)}")
            layer.w[name.split("_")[0]] = w
        for name in ("thr", "thr_a", "thr_b"):
            if f"layer{i}/{name}" in arrays:
                layer.thr[name] = arrays[f"layer{i}/{name}"].astype(np.int64)
        if f"layer{i}/r" in arrays:
            layer.r = arrays[f"layer{i}/r"].astype(np.int64)
    return Net(config=cfg, num_classes=cfg["num_classes"],
               input_shape=tuple(cfg["input_shape"]), layers=layers,
               out_scale=arrays["out_scale"].astype(np.float32),
               out_bias=arrays["out_bias"].astype(np.float32))


def check(net: Net, config: dict) -> None:
    """Raise ValueError unless the artifact is the configuration `config`
    states: its precisions, signedness, input, classes and every layer's
    kind, widths, kernel, stride, padding, projection and weight width;
    and unless every weight level lies in its layer's range, every
    thresholded channel has 3 thresholds, and every block has its r."""
    keys = ("wbits", "abits", "input_kind", "input_shape", "num_classes",
            "layers")
    stated = {k: config[k] for k in keys}
    if {k: net.config[k] for k in keys} != stated or stated["abits"] != 2 \
            or not net.config.get("unsigned") or not config.get("unsigned"):
        raise ValueError(f"{config['artifact']} is not the configuration "
                         f"{config['name']} states")
    bad = ValueError(f"{config['artifact']}: layer weights, multipliers or "
                     "thresholds are not what the configuration states")
    for i, layer in enumerate(net.layers):
        lim = (1 << (layer.wbits - 1)) - 1 if layer.wbits > 1 else 1
        for w in layer.w.values():
            if np.abs(w.astype(np.int16)).max() > lim:
                raise bad
        want = {"conv": ("thr",), "bottleneck": ("thr_a", "thr_b", "thr"),
                "avgpool": ("thr",)}.get(layer.kind, ())
        if tuple(sorted(layer.thr)) != tuple(sorted(want)):
            raise bad
        for name, t in layer.thr.items():
            n = layer.mid if name in ("thr_a", "thr_b") else layer.out
            if t.shape != (THRESHOLDS, n):
                raise bad
        if (layer.kind == "bottleneck") != (layer.r is not None):
            raise bad
        if layer.r is not None and (layer.r.shape != (layer.out,) or
                                    layer.r.min() < 1):
            raise bad


def input_levels(net: Net, x: torch.Tensor) -> torch.Tensor:
    """uint8 pixels or int8 frames [B, H, W, C] -> float64 levels NCHW."""
    x = x.reshape((x.shape[0],) + net.input_shape)
    if x.dtype == torch.uint8:
        a = x.to(torch.float64) - 128.0
    else:
        a = x.to(torch.float64)
    return a.permute(0, 3, 1, 2)


def conv_weight(w: np.ndarray, kernel: int, device) -> torch.Tensor:
    """Levels [K*K*C, N], (ki, kj, c) order -> float64 [N, C, K, K]."""
    t = torch.from_numpy(w.astype(np.float64)).to(device)
    return t.reshape(kernel, kernel, -1, w.shape[1]).permute(3, 2, 0, 1) \
        .contiguous()


def conv(a: torch.Tensor, w: torch.Tensor, stride: int = 1,
         pad: int = 0) -> torch.Tensor:
    """The exact integer accumulators (float64) of a conv on levels a."""
    return torch.round(torch.nn.functional.conv2d(a, w, stride=stride,
                                                  padding=pad))


def threshold(acc: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """MultiThreshold of float64 accumulators (NCHW or [B, N]) against
    thr [3, N]: the codes, which are the levels, as float64."""
    t = thr.to(acc.dtype)
    if acc.ndim == 4:
        t = t[:, :, None, None]
    return (acc[:, None] >= t).sum(dim=1).to(torch.float64)


def block_parts(layer: Layer, ws: dict, x: torch.Tensor):
    """A bottleneck block's a, b (codes), c and p (accumulators), float64
    NCHW, from its input codes x."""
    a = threshold(conv(x, ws["wa"]), ws["thr_a"])
    b = threshold(conv(a, ws["wb"], layer.stride, 1), ws["thr_b"])
    c = conv(b, ws["wc"])
    p = conv(x, ws["wp"], layer.stride) if layer.projection else x
    return a, b, c, p


def junction(c: torch.Tensor, p: torch.Tensor, r: torch.Tensor,
             thr: torch.Tensor) -> torch.Tensor:
    """y = MT(c + r * p), r a multiplier a channel."""
    return threshold(c + r[None, :, None, None] * p, thr)


def device_layer(layer: Layer, device) -> dict:
    """A layer's weights, multipliers and thresholds as float64 and int64
    tensors on `device`."""
    d = {}
    for name, w in layer.w.items():
        if layer.kind == "dense":
            d[name] = torch.from_numpy(w.astype(np.float64)).to(device)
        else:
            k = {"w": layer.kernel, "wb": 3}.get(name, 1)
            d[name] = conv_weight(w, k, device)
    for name, t in layer.thr.items():
        d[name] = torch.from_numpy(t).to(device)
    if layer.r is not None:
        d["r"] = torch.from_numpy(layer.r.astype(np.float64)).to(device)
    return d


def layer_out(layer: Layer, ws: dict, a: torch.Tensor) -> torch.Tensor:
    """One layer on levels a (NCHW; [B, K] into the classifier): codes,
    or the classifier's accumulators."""
    if layer.kind == "conv":
        return threshold(conv(a, ws["w"], layer.stride, layer.pad),
                         ws["thr"])
    if layer.kind == "maxpool":
        return torch.nn.functional.max_pool2d(a, layer.kernel, layer.stride,
                                              layer.pad)
    if layer.kind == "bottleneck":
        _, _, c, p = block_parts(layer, ws, a)
        return junction(c, p, ws["r"], ws["thr"])
    if layer.kind == "avgpool":
        s = torch.round(torch.nn.functional.avg_pool2d(
            a, layer.window, divisor_override=1))
        return threshold(s, ws["thr"])
    if a.ndim == 4:
        a = a.permute(0, 2, 3, 1).reshape(a.shape[0], -1)
    return torch.round(a @ ws["w"])


def accumulators(net: Net, x: torch.Tensor, *, device=None,
                 block: int = 32) -> torch.Tensor:
    """int64 accumulators of the classifier [B, classes] on `device` (x's
    device by default), `block` images at a time moved there. TF32 is off
    meanwhile (float64 ignores it; the flags are stated all the same) and
    restored afterwards."""
    dev = torch.device(device) if device is not None else x.device
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        ws = [device_layer(layer, dev) for layer in net.layers]
        outs = []
        for lo in range(0, x.shape[0], block):
            a = input_levels(net, x[lo:lo + block].to(dev))
            for layer, w in zip(net.layers, ws):
                a = layer_out(layer, w, a)
            outs.append(a.to(torch.int64))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    return torch.cat(outs)


def logits(net: Net, acc: torch.Tensor,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """`dtype(acc) * scale + bias`, two operations in `dtype` (float32 as
    the configuration states; a lower one for a control)."""
    scale = torch.from_numpy(net.out_scale).to(acc.device, dtype)
    bias = torch.from_numpy(net.out_bias).to(acc.device, dtype)
    return acc.to(dtype) * scale + bias


def forward(net: Net, x: torch.Tensor, *, device,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Logits [N, classes] of every input, computed on `device` in blocks,
    with the output arithmetic in `dtype`."""
    return logits(net, accumulators(net, x, device=device), dtype)
