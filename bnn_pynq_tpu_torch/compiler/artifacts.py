"""The packed-parameter artifact format, written and read byte for byte
as `bnn_pynq_tpu` writes and reads it.

Ported from `bnn_pynq_tpu/compiler/artifacts.py` with numpy only. Layout:
one `.npz` holding every layer array under `layer{i}/{name}` plus
`out_scale`/`out_bias`, and a JSON manifest under key `manifest`
describing the network config, so an artifact is self-contained.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List

import numpy as np

from bnn_pynq_tpu_torch.models.config import (AvgPoolSpec, BottleneckSpec,
                                              ConvSpec, DenseSpec,
                                              DepthwiseSpec, MaxPoolSpec,
                                              NetworkConfig, PoolSpec)

FORMAT_VERSION = 1


@dataclass
class CompiledNetwork:
    """Integer inference parameters for one network, as numpy arrays
    (the fields of `bnn_pynq_tpu.compiler.finnthesizer.CompiledNetwork`).

    layers: one dict per config layer — `{}` for a pool; `w_int8` (int8
    levels, first conv of an int8-input net, and every layer of a
    MobileNet: [K, N], a depthwise conv's [K², C]) or `w_packed`
    (uint32 words packed along K), and `thr` (int32 [nthr, N]) on every
    layer but the last (an average pool's alone: `{"thr": ...}`). A
    bottleneck block's: `wa_packed` [K=C], `wb_packed` [K=9·mid, (ki, kj,
    c) order], `wc_packed` [K=mid] and, with a projection, `wp_packed`
    [K=C]: its 1-bit weights packed along K at their width (bit j of word
    w is element 32w + j, level 2b − 1), whatever the net's `bits`;
    `thr_a`, `thr_b` (int32 [nthr, mid]), `thr` (int32 [nthr, out]) and
    `r` (int32 [out], the shortcut's multiplier)."""
    config: NetworkConfig
    layers: List[Dict[str, np.ndarray]]
    out_scale: np.ndarray                 # float32 [num_classes]
    out_bias: np.ndarray                  # float32 [num_classes]
    meta: Dict[str, Any] = field(default_factory=dict)


def config_to_json(cfg: NetworkConfig) -> dict:
    """The manifest's form of a config. A layer's `pad` and `wbits` are
    written only where they are set (MobileNet's, ResNet's), and so is
    `unsigned` (ResNet's), so the BNN-PYNQ configs' manifests stay the JAX
    package's byte for byte and MobileNet's as its committed artifact has
    it."""
    layers = []
    for s in cfg.layers:
        if isinstance(s, ConvSpec):
            d = {"kind": "conv", "out_ch": s.out_ch, "kernel": s.kernel,
                 "stride": s.stride}
        elif isinstance(s, DepthwiseSpec):
            d = {"kind": "dwconv", "kernel": s.kernel, "stride": s.stride,
                 "pad": s.pad}
        elif isinstance(s, PoolSpec):
            d = {"kind": "pool", "window": s.window}
        elif isinstance(s, AvgPoolSpec):
            d = {"kind": "avgpool", "window": s.window}
        elif isinstance(s, MaxPoolSpec):
            d = {"kind": "maxpool", "kernel": s.kernel, "stride": s.stride,
                 "pad": s.pad}
        elif isinstance(s, BottleneckSpec):
            d = {"kind": "bottleneck", "mid": s.mid, "out_ch": s.out,
                 "stride": s.stride, "projection": s.projection}
        else:
            d = {"kind": "dense", "out_features": s.out_features}
        if getattr(s, "pad", 0) and "pad" not in d:
            d["pad"] = s.pad
        if getattr(s, "wbits", 0):
            d["wbits"] = s.wbits
        layers.append(d)
    out = {"name": cfg.name, "wbits": cfg.wbits, "abits": cfg.abits,
           "input_kind": cfg.input_kind,
           "input_shape": list(cfg.input_shape), "layers": layers,
           "num_classes": cfg.num_classes, "dataset": cfg.dataset}
    if cfg.unsigned:
        out["unsigned"] = True
    return out


def config_from_json(d: dict) -> NetworkConfig:
    specs = []
    for s in d["layers"]:
        if s["kind"] == "conv":
            specs.append(ConvSpec(s["out_ch"], s["kernel"], s["stride"],
                                  s.get("pad", 0), s.get("wbits", 0)))
        elif s["kind"] == "dwconv":
            if (s["kernel"], s["pad"]) != (DepthwiseSpec.kernel,
                                           DepthwiseSpec.pad):
                raise ValueError(f"a depthwise conv is 3×3 with pad 1, got "
                                 f"kernel {s['kernel']}, pad {s['pad']}")
            specs.append(DepthwiseSpec(s["stride"], s.get("wbits", 0)))
        elif s["kind"] == "pool":
            specs.append(PoolSpec(s["window"]))
        elif s["kind"] == "avgpool":
            specs.append(AvgPoolSpec(s["window"]))
        elif s["kind"] == "maxpool":
            specs.append(MaxPoolSpec(s["kernel"], s["stride"], s["pad"]))
        elif s["kind"] == "bottleneck":
            specs.append(BottleneckSpec(s["mid"], s["out_ch"], s["stride"],
                                        s["projection"], s.get("wbits", 0)))
        elif s["kind"] == "dense":
            specs.append(DenseSpec(s["out_features"], s.get("wbits", 0)))
        else:
            raise ValueError(f"unknown layer kind {s['kind']!r}")
    return NetworkConfig(
        name=d["name"], wbits=d["wbits"], abits=d["abits"],
        input_kind=d["input_kind"], input_shape=tuple(d["input_shape"]),
        layers=tuple(specs), num_classes=d["num_classes"],
        dataset=d.get("dataset", ""), unsigned=d.get("unsigned", False))


def save_artifact(path: str, compiled: CompiledNetwork):
    arrays = {}
    for i, layer in enumerate(compiled.layers):
        for name, arr in layer.items():
            arrays[f"layer{i}/{name}"] = np.asarray(arr)
    arrays["out_scale"] = np.asarray(compiled.out_scale)
    arrays["out_bias"] = np.asarray(compiled.out_bias)
    manifest = {
        "format_version": FORMAT_VERSION,
        "config": config_to_json(compiled.config),
        "num_layers": len(compiled.layers),
        "scheme": compiled.config.scheme(),
        "meta": _jsonable(compiled.meta),
    }
    arrays["manifest"] = np.frombuffer(
        json.dumps(manifest).encode(), dtype=np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **arrays)


def load_artifact(path: str) -> CompiledNetwork:
    with np.load(path, allow_pickle=False) as z:
        manifest = json.loads(bytes(z["manifest"]).decode())
        if manifest["format_version"] > FORMAT_VERSION:
            raise ValueError(f"artifact format {manifest['format_version']} "
                             f"newer than supported {FORMAT_VERSION}")
        config = config_from_json(manifest["config"])
        layers: List[Dict[str, np.ndarray]] = [
            dict() for _ in range(manifest["num_layers"])]
        for key in z.files:
            if key.startswith("layer"):
                idx_s, _, name = key.partition("/")
                layers[int(idx_s[5:])][name] = z[key]
        return CompiledNetwork(config=config, layers=layers,
                               out_scale=z["out_scale"],
                               out_bias=z["out_bias"],
                               meta=manifest.get("meta", {}))


def _jsonable(obj):
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj
