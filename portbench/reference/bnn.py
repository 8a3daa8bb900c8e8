"""Plain reference of the BNN-PYNQ networks (FINN's CNV, LFC, SFC).

Reads an artifact `.npz` with its own decoding and computes each layer
from its published equations, in float64 on whatever device it is given:

- input: uint8 pixels become int8 levels `p - 128` for an image net, and
  `+1 if p >= 128 else -1` for a bipolar (MNIST) net; int8 frames are
  levels already;
- conv (VALID, stride as configured) and dense: the integer product of
  levels, computed in float64 and rounded, which is exact: every sum is
  an integer far below 2**53, and the rounding also absorbs the last-bit
  error of any convolution algorithm the library picks;
- MultiThreshold: `code = sum_t (acc >= thr[t])`, the next layer's level
  `2 code - 1` (1-bit activations) or `2 code - 3` (2-bit);
- max-pool on levels (the quantizer is monotone, so this is the pool of
  the pre-activations), VALID;
- dense input flattened in (h, w, c) order;
- last layer: int32 accumulators, logits `float32(acc) * scale + bias`
  as two float32 operations.

Weights: `w_int8` holds levels [K, N]; `w_packed` holds uint32 words
packed along K (bit or 2-bit field i of word j is row 32j + i or 16j + i),
levels `2 b - 1` for W1A1 and `2 c - 3` for the 2-bit codes of the other
schemes. K runs over (ki, kj, c) for a conv.

A reference module of the benchmark: `load`, `check` and `forward`
(the contract in `portbench/harness.py`). Imports numpy and torch only.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch


@dataclass
class Layer:
    kind: str                       # 'conv' | 'pool' | 'dense'
    out: int = 0
    kernel: int = 0
    stride: int = 1
    window: int = 0
    w: Optional[np.ndarray] = None  # int8 levels [K, N]
    thr: Optional[np.ndarray] = None  # int32 [nthr, N], None on the last


@dataclass
class Net:
    name: str
    wbits: int
    abits: int
    input_kind: str                 # 'int8' | 'bipolar'
    input_shape: tuple              # (H, W, C)
    num_classes: int
    layers: List[Layer]
    out_scale: np.ndarray           # float32 [classes]
    out_bias: np.ndarray            # float32 [classes]


def _unpack(words: np.ndarray, k: int, bits: int) -> np.ndarray:
    """uint32 words [Kw, N] packed along K -> int8 levels [k, N]."""
    words = np.asarray(words, dtype=np.uint32)
    per = 32 // bits
    shifts = (bits * np.arange(per, dtype=np.uint32))[None, :, None]
    fields = (words[:, None, :] >> shifts) & np.uint32((1 << bits) - 1)
    fields = fields.reshape(-1, words.shape[1])[:k].astype(np.int16)
    levels = 2 * fields - (1 if bits == 1 else 3)
    return levels.astype(np.int8)


def load(path: str) -> Net:
    """Decode an artifact: its manifest (JSON bytes under `manifest`) and
    every layer's weights and thresholds."""
    with np.load(path, allow_pickle=False) as z:
        manifest = json.loads(bytes(z["manifest"]).decode())
        arrays = {k: z[k] for k in z.files}
    cfg = manifest["config"]
    bits = 1 if (cfg["wbits"] == 1 and cfg["abits"] == 1) else 2
    h, w, c = cfg["input_shape"]
    layers: List[Layer] = []
    flat = False
    for i, spec in enumerate(cfg["layers"]):
        kind = spec["kind"]
        if kind == "pool":
            layers.append(Layer("pool", window=spec["window"]))
            h //= spec["window"]
            w //= spec["window"]
            continue
        if kind == "conv":
            kk, s = spec["kernel"], spec["stride"]
            k = kk * kk * c
            n = spec["out_ch"]
            layer = Layer("conv", out=n, kernel=kk, stride=s)
            h = (h - kk) // s + 1
            w = (w - kk) // s + 1
        else:
            k = c if flat else h * w * c
            flat = True
            n = spec["out_features"]
            layer = Layer("dense", out=n)
            h = w = 1
        if f"layer{i}/w_int8" in arrays:
            layer.w = arrays[f"layer{i}/w_int8"].astype(np.int8)
        else:
            layer.w = _unpack(arrays[f"layer{i}/w_packed"], k, bits)
        if layer.w.shape != (k, n):
            raise ValueError(f"layer {i}: weights {layer.w.shape}, "
                             f"expected {(k, n)}")
        if f"layer{i}/thr" in arrays:
            layer.thr = arrays[f"layer{i}/thr"].astype(np.int32)
        layers.append(layer)
        c = n
    return Net(name=cfg["name"], wbits=cfg["wbits"], abits=cfg["abits"],
               input_kind=cfg["input_kind"],
               input_shape=tuple(cfg["input_shape"]),
               num_classes=cfg["num_classes"], layers=layers,
               out_scale=arrays["out_scale"].astype(np.float32),
               out_bias=arrays["out_bias"].astype(np.float32))


def check(net: Net, config: dict) -> None:
    """Raise ValueError unless the artifact is the configuration `config`
    states: its precisions, input, classes and layer widths."""
    stated = (config["wbits"], config["abits"], config["input_kind"],
              tuple(config["input_shape"]), config["num_classes"])
    if (net.wbits, net.abits, net.input_kind, net.input_shape,
            net.num_classes) != stated or \
            [(x.kind, x.out) for x in net.layers if x.kind != "pool"] != \
            [(s["kind"], s.get("out_ch", s.get("out_features")))
             for s in config["layers"] if s["kind"] != "pool"]:
        raise ValueError(f"{config['artifact']} is not the configuration "
                         f"{config['name']} states")


def input_levels(net: Net, x: torch.Tensor) -> torch.Tensor:
    """uint8 pixels or int8 frames [B, H, W, C] (or [B, H*W*C]) -> float64
    levels [B, H, W, C]."""
    b = x.shape[0]
    x = x.reshape((b,) + net.input_shape)
    if net.input_kind == "bipolar":
        if x.dtype == torch.uint8:
            pos = x >= 128
        else:
            pos = x > 0
        return torch.where(pos, 1.0, -1.0).to(torch.float64)
    if x.dtype == torch.uint8:
        return x.to(torch.float64) - 128.0
    return x.to(torch.float64)


def _threshold(acc: torch.Tensor, thr: torch.Tensor, abits: int):
    code = (acc[..., None, :] >= thr).sum(dim=-2)
    return (2 * code - (1 if abits == 1 else 3)).to(torch.float64)


def accumulators(net: Net, x: torch.Tensor, *, device=None,
                 block: int = 1024) -> torch.Tensor:
    """int64 accumulators of the last layer [B, classes] on `device`
    (x's device by default), `block` images at a time moved there."""
    dev = torch.device(device) if device is not None else x.device
    ws, ts = [], []
    for layer in net.layers:
        if layer.kind == "pool":
            ws.append(None)
            ts.append(None)
            continue
        w = torch.from_numpy(layer.w.astype(np.float64)).to(dev)
        if layer.kind == "conv":
            kk = layer.kernel
            w = w.reshape(kk, kk, -1, layer.out).permute(3, 2, 0, 1)
        ws.append(w.contiguous())
        ts.append(None if layer.thr is None else
                  torch.from_numpy(layer.thr.astype(np.int64)).to(dev))
    outs = []
    for lo in range(0, x.shape[0], block):
        a = input_levels(net, x[lo:lo + block].to(dev))   # NHWC
        for layer, w, t in zip(net.layers, ws, ts):
            if layer.kind == "pool":
                a = torch.nn.functional.max_pool2d(
                    a.permute(0, 3, 1, 2), layer.window).permute(0, 2, 3, 1)
                continue
            if layer.kind == "conv":
                acc = torch.nn.functional.conv2d(
                    a.permute(0, 3, 1, 2), w, stride=layer.stride)
                acc = acc.permute(0, 2, 3, 1)
            else:
                acc = a.reshape(a.shape[0], -1) @ w
            acc = torch.round(acc).to(torch.int64)
            if t is None:
                a = acc
            else:
                a = _threshold(acc, t, net.abits)
        outs.append(a)
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
