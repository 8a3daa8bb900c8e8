"""Write `portbench/configs/mobilenetv1-w4a4.npz`: MobileNet-v1 W4A4 at its
published widths and full depth (`bnn_pynq_tpu_torch.models.config::
mobilenet_v1`), with seeded random weights and calibrated thresholds.

    python3 portbench/configs/make_mobilenetv1_w4a4.py

- weights: uniform random levels in each layer's narrow range,
  +-(2**(wbits-1) - 1): +-127 for the first conv and the classifier
  (8-bit), +-7 for the depthwise and pointwise convs (4-bit);
- thresholds: per channel, the 1/16 ... 15/16 quantiles of the layer's
  accumulators over a calibration batch of CALIB seeded uniform int8
  images (computed by the plain reference, layer by layer on the codes
  the thresholds before it give), so that every layer's codes spread over
  0..15;
- the average pool's thresholds: 64 t for t = 1..15, which gives
  floor(sum / 64) of the 49 codes of a channel;
- scale and bias of the logits, as a folded batch norm would leave them:
  per class, u / std and -u * mean / std + e, float32, where mean and std
  are the class's accumulator's over the calibration batch, u is uniform
  in [0.75, 1.25] and e normal with deviation 0.1. (The pool's codes vary
  little around their mean, so without the centring one class would win
  for every image.)

Every draw comes from `np.random.default_rng(SEED)` in that order, so the
file is the same on every machine. `build` makes the same at any width
(the tests' small size).
"""

from __future__ import annotations

import importlib.util
import os
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent.parent
SEED = 22
CALIB = 64
OUT = HERE / "mobilenetv1-w4a4.npz"
POOL_DIVISOR = 64


def _reference():
    path = HERE.parent / "reference" / "mobilenet_v1.py"
    name = "portbench_reference_mobilenet_v1"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def _quantile_thresholds(acc: torch.Tensor) -> np.ndarray:
    """acc: float64 [N, C, H, W] or [N, C] → int32 [15, C], per channel
    the sample at each t/16 quantile, t = 1..15."""
    c = acc.shape[1]
    per = acc.transpose(0, 1).reshape(c, -1).to(torch.int32).numpy()
    n = per.shape[1]
    kth = [min(n - 1, (t * n) // 16) for t in range(1, 16)]
    part = np.partition(per, kth, axis=1)
    return np.ascontiguousarray(part[:, kth].T.astype(np.int32))


def build(config, *, seed: int = SEED, calib: int = CALIB,
          chunk: int = 8):
    """A CompiledNetwork of `config` (a port NetworkConfig of MobileNet-v1),
    its weights and thresholds as the module docstring says."""
    from bnn_pynq_tpu_torch.compiler.artifacts import (CompiledNetwork,
                                                       config_to_json)
    ref = _reference()
    cfg = config_to_json(config)
    rng = np.random.default_rng(seed)
    layers = ref.layers_of(cfg)
    h, w, c = cfg["input_shape"]
    for layer in layers:
        if layer.kind != "avgpool":
            lim = (1 << (layer.wbits - 1)) - 1
            layer.w = rng.integers(-lim, lim + 1,
                                   size=ref.weight_shape(layer, c, h * w),
                                   dtype=np.int8)
        if layer.kind in ("conv", "dwconv"):
            k, s, p = layer.kernel, layer.stride, layer.pad
            h, w = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
        elif layer.kind == "avgpool":
            h, w = h // layer.window, w // layer.window
        c = layer.out
    images = rng.integers(-128, 128, size=(calib,) + tuple(
        cfg["input_shape"]), dtype=np.int8)
    u = rng.uniform(0.75, 1.25, size=cfg["num_classes"])
    e = rng.normal(0.0, 0.1, size=cfg["num_classes"])

    # the calibration batch's levels (NCHW), layer by layer, kept as int8
    acts = [torch.from_numpy(images[i:i + chunk]).permute(0, 3, 1, 2)
            for i in range(0, calib, chunk)]
    with torch.no_grad():
        for layer in layers[:-1]:
            wt = None if layer.w is None else ref.torch_weight(layer, "cpu")
            accs = [ref.layer_acc(layer, wt, a.to(torch.float64))
                    for a in acts]
            if layer.kind == "avgpool":
                layer.thr = np.repeat(
                    (POOL_DIVISOR * np.arange(1, 16, dtype=np.int32))[:, None],
                    layer.out, axis=1)
            else:
                layer.thr = _quantile_thresholds(torch.cat(accs))
            t = torch.from_numpy(layer.thr.astype(np.int64))
            acts = [ref.threshold(acc, t).to(torch.int8) for acc in accs]
            del accs
        fc = layers[-1]
        acc = torch.cat([ref.layer_acc(fc, ref.torch_weight(fc, "cpu"),
                                       a.to(torch.float64)) for a in acts])
        mean, std = acc.mean(dim=0).numpy(), acc.std(dim=0).numpy()
    scale = (u / std).astype(np.float32)
    bias = (-u * mean / std + e).astype(np.float32)
    out = []
    for layer in layers:
        d = {} if layer.w is None else {"w_int8": layer.w}
        if layer.thr is not None:
            d["thr"] = layer.thr
        out.append(d)
    return CompiledNetwork(
        config=config, layers=out, out_scale=scale, out_bias=bias,
        meta={"generator": "portbench/configs/make_mobilenetv1_w4a4.py",
              "seed": seed, "calibration_images": calib,
              "pool_divisor": POOL_DIVISOR})


def main() -> int:
    sys.path.insert(0, str(ROOT))
    from bnn_pynq_tpu_torch.compiler.artifacts import save_artifact
    from bnn_pynq_tpu_torch.models.config import mobilenet_v1
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    save_artifact(str(OUT), build(mobilenet_v1()))
    print(f"wrote {OUT.relative_to(ROOT)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
