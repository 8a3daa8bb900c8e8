"""Plain reference of MobileNet-v1 W4A4 (FINN's `mobilenetv1-w4a4`, built
from Brevitas's `quant_mobilenet_v1`; topology: Howard et al.,
arXiv:1704.04861, Table 1).

Reads an artifact `.npz` with its own decoding and computes each layer
from its equations, in float64 on whatever device it is given:

- input: uint8 pixels become int8 levels `p - 128`; int8 frames are
  levels already;
- conv (the first: 3x3, stride 2; the pointwise ones: 1x1) and depthwise
  conv (3x3, one filter a channel: `groups` = channels, stride 1 or 2):
  zero padding `pad` on each side (1: SAME for a 3x3), the integer
  product of levels computed in float64 and rounded, which is exact: every
  sum is an integer below 2**22, far below 2**53, and the rounding also
  absorbs the last-bit error of any convolution algorithm the library
  picks;
- MultiThreshold: `code = sum_t (acc >= thr[t])`, 15 thresholds a
  channel; the next layer's level is the code itself (unsigned 4-bit, a
  `QuantReLU`'s output);
- average pool (7x7, the whole map): the int32 sum of each channel's
  levels over the window, then its MultiThreshold (the artifact's
  thresholds carry the divisor: 64 t for floor(sum / 64));
- dense input flattened in (h, w, c) order;
- last layer: int32 accumulators, logits `float32(acc) * scale + bias` as
  two float32 operations.

Weights: `w_int8` holds levels: [K*K*C, N] in (ki, kj, c) order for a
conv, [K*K, C] in (ki, kj) order for a depthwise conv, [K, N] for a dense
layer; every level lies in its layer's narrow range +-(2**(wbits-1) - 1).

A reference module of the benchmark: `load`, `check` and `forward` (the
contract in `portbench/harness.py`). Imports numpy and torch only.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch


@dataclass
class Layer:
    kind: str                       # 'conv' | 'dwconv' | 'avgpool' | 'dense'
    out: int = 0
    kernel: int = 1
    stride: int = 1
    pad: int = 0
    window: int = 0
    wbits: int = 0
    w: Optional[np.ndarray] = None    # int8 levels, as the docstring says
    thr: Optional[np.ndarray] = None  # int32 [15, N], None on the last


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
        if kind in ("conv", "dwconv"):
            k, s, p = spec["kernel"], spec["stride"], spec.get("pad", 0)
            n = spec["out_ch"] if kind == "conv" else c
            layers.append(Layer(kind, out=n, kernel=k, stride=s, pad=p,
                                wbits=wbits))
            h = (h + 2 * p - k) // s + 1
            w = (w + 2 * p - k) // s + 1
            c = n
        elif kind == "avgpool":
            layers.append(Layer(kind, out=c, window=spec["window"]))
            h //= spec["window"]
            w //= spec["window"]
        elif kind == "dense":
            layers.append(Layer(kind, out=spec["out_features"], wbits=wbits))
            c, h, w = spec["out_features"], 1, 1
        else:
            raise ValueError(f"no layer kind {kind!r} in MobileNet-v1")
    return layers


def weight_shape(layer: Layer, c_in: int, hw_in: int) -> tuple:
    if layer.kind == "conv":
        return (layer.kernel * layer.kernel * c_in, layer.out)
    if layer.kind == "dwconv":
        return (layer.kernel * layer.kernel, c_in)
    return (hw_in * c_in, layer.out)


def load(path: str) -> Net:
    """Decode an artifact: its manifest (JSON bytes under `manifest`) and
    every layer's weights and thresholds."""
    with np.load(path, allow_pickle=False) as z:
        manifest = json.loads(bytes(z["manifest"]).decode())
        arrays = {k: z[k] for k in z.files}
    cfg = manifest["config"]
    layers = layers_of(cfg)
    h, w, c = cfg["input_shape"]
    for i, layer in enumerate(layers):
        if layer.kind != "avgpool":
            layer.w = arrays[f"layer{i}/w_int8"].astype(np.int8)
            want = weight_shape(layer, c, h * w)
            if layer.w.shape != want:
                raise ValueError(f"layer {i}: weights {layer.w.shape}, "
                                 f"expected {want}")
        if f"layer{i}/thr" in arrays:
            layer.thr = arrays[f"layer{i}/thr"].astype(np.int32)
        if layer.kind in ("conv", "dwconv"):
            k, s, p = layer.kernel, layer.stride, layer.pad
            h, w = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
        elif layer.kind == "avgpool":
            h, w = h // layer.window, w // layer.window
        else:
            h = w = 1
        c = layer.out
    return Net(config=cfg, num_classes=cfg["num_classes"],
               input_shape=tuple(cfg["input_shape"]), layers=layers,
               out_scale=arrays["out_scale"].astype(np.float32),
               out_bias=arrays["out_bias"].astype(np.float32))


def check(net: Net, config: dict) -> None:
    """Raise ValueError unless the artifact is the configuration `config`
    states: its precisions, input, classes and every layer's kind, width,
    kernel, stride, padding and weight width; and unless every weight
    level lies in its layer's range and every layer but the last has 15
    thresholds a channel."""
    keys = ("wbits", "abits", "input_kind", "input_shape", "num_classes",
            "layers")
    stated = {k: config[k] for k in keys}
    if {k: net.config[k] for k in keys} != stated or stated["abits"] != 4:
        raise ValueError(f"{config['artifact']} is not the configuration "
                         f"{config['name']} states")
    for i, layer in enumerate(net.layers):
        if layer.w is not None:
            lim = (1 << (layer.wbits - 1)) - 1
            if np.abs(layer.w.astype(np.int16)).max() > lim:
                raise ValueError(f"{config['artifact']}: layer {i} weights "
                                 f"outside +-{lim}")
        last = i == len(net.layers) - 1
        if (layer.thr is None) != last or \
                (not last and layer.thr.shape != (15, layer.out)):
            raise ValueError(f"{config['artifact']}: layer {i} thresholds "
                             "are not 15 a channel")


def input_levels(net: Net, x: torch.Tensor) -> torch.Tensor:
    """uint8 pixels or int8 frames [B, H, W, C] -> float64 levels NCHW."""
    x = x.reshape((x.shape[0],) + net.input_shape)
    if x.dtype == torch.uint8:
        a = x.to(torch.float64) - 128.0
    else:
        a = x.to(torch.float64)
    return a.permute(0, 3, 1, 2)


def torch_weight(layer: Layer, device) -> torch.Tensor:
    """A layer's levels as the float64 weight its product takes."""
    w = torch.from_numpy(layer.w.astype(np.float64)).to(device)
    k = layer.kernel
    if layer.kind == "conv":
        return w.reshape(k, k, -1, layer.out).permute(3, 2, 0, 1).contiguous()
    if layer.kind == "dwconv":
        return w.reshape(k, k, -1).permute(2, 0, 1)[:, None].contiguous()
    return w


def layer_acc(layer: Layer, w: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """The exact integer accumulators (float64) of one layer on levels `a`
    (NCHW; [B, K] or NCHW into a dense layer)."""
    if layer.kind == "conv":
        acc = torch.nn.functional.conv2d(a, w, stride=layer.stride,
                                         padding=layer.pad)
    elif layer.kind == "dwconv":
        acc = torch.nn.functional.conv2d(a, w, stride=layer.stride,
                                         padding=layer.pad, groups=a.shape[1])
    elif layer.kind == "avgpool":
        acc = torch.nn.functional.avg_pool2d(a, layer.window,
                                             divisor_override=1)
    else:
        if a.ndim == 4:
            a = a.permute(0, 2, 3, 1).reshape(a.shape[0], -1)
        acc = a @ w
    return torch.round(acc)


def threshold(acc: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """MultiThreshold of float64 accumulators (NCHW or [B, N]) against
    thr [15, N]: the codes, which are the levels, as float64."""
    t = thr.to(acc.dtype)
    if acc.ndim == 4:
        t = t[:, :, None, None]
    return (acc[:, None] >= t).sum(dim=1).to(torch.float64)


def accumulators(net: Net, x: torch.Tensor, *, device=None,
                 block: int = 256) -> torch.Tensor:
    """int64 accumulators of the last layer [B, classes] on `device` (x's
    device by default), `block` images at a time moved there. TF32 is off
    meanwhile (float64 ignores it; the flags are stated all the same) and
    restored afterwards."""
    dev = torch.device(device) if device is not None else x.device
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        ws = [None if layer.w is None else torch_weight(layer, dev)
              for layer in net.layers]
        ts = [None if layer.thr is None else
              torch.from_numpy(layer.thr.astype(np.int64)).to(dev)
              for layer in net.layers]
        outs = []
        for lo in range(0, x.shape[0], block):
            a = input_levels(net, x[lo:lo + block].to(dev))
            for layer, w, t in zip(net.layers, ws, ts):
                acc = layer_acc(layer, w, a)
                a = acc if t is None else threshold(acc, t)
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
