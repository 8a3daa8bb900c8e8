"""Write `portbench/configs/resnet50-w1a2.npz`: ResNet-50 v1.5 W1A2 at its
published widths and full depth (`bnn_pynq_tpu_torch.models.config::
resnet50_v1_5`), with seeded random weights and calibrated thresholds.

    python3 portbench/configs/make_resnet50_w1a2.py [--device cuda]

- weights: uniform random levels in each layer's narrow range: +-127 for
  conv1 and the classifier (8-bit), +-1 for the blocks' W_a, W_b, W_c and
  W_p (1-bit), which the artifact stores packed along K, 32 to a word;
- thresholds: per channel, the 1/4, 2/4 and 3/4 quantiles of the layer's
  accumulators over a calibration batch of CALIB seeded uniform int8
  images (computed by the plain reference, layer by layer on the codes
  the thresholds before it give), so that every layer's codes spread over
  0..3; a block's last thresholds on its junction c + r * p;
- r, a block's shortcut multiplier: per channel max(1, round(std(c) /
  std(p))) over the calibration batch, c the block's last product and p
  its shortcut (the input's codes, or the projection's accumulators); 1
  where p does not vary; at most 127, so that W_p * r stays int8;
- the average pool's thresholds: window**2 * t for t = 1..3, which gives
  the floor of the mean of a channel's codes;
- scale and bias of the logits, as a folded batch norm would leave them:
  per class, u / std and -u * mean / std + e, float32, where mean and std
  are the class's accumulator's over the calibration batch, u is uniform
  in [0.75, 1.25] and e normal with deviation 0.1.

Every draw comes from `np.random.default_rng(SEED)` in that order; the
convs give exact integers on any device, and every statistic (quantile,
std, mean) is taken in numpy on the CPU from those integers, so the file
is the same on every machine. `build` makes the same at any width and
image size (the tests' small size).
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent.parent
SEED = 27
CALIB = 32
OUT = HERE / "resnet50-w1a2.npz"
MAX_R = 127


def _reference():
    path = HERE.parent / "reference" / "resnet50.py"
    name = "portbench_reference_resnet50"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def _per_channel(accs) -> np.ndarray:
    """float64 chunks [n, C, H, W] or [n, C] → int64 [C, samples]."""
    a = torch.cat([x.cpu() for x in accs])
    c = a.shape[1]
    return a.transpose(0, 1).reshape(c, -1).to(torch.int64).numpy()


def _quantile_thresholds(per: np.ndarray) -> np.ndarray:
    """int64 [C, n] → int32 [3, C], per channel the sample at each t/4
    quantile, t = 1..3."""
    n = per.shape[1]
    kth = [min(n - 1, (t * n) // 4) for t in range(1, 4)]
    part = np.partition(per, kth, axis=1)
    return np.ascontiguousarray(part[:, kth].T.astype(np.int32))


def _shortcut_mul(c: np.ndarray, p: np.ndarray) -> np.ndarray:
    """int32 [C]: max(1, round(std(c) / std(p))) a channel, 1 where p does
    not vary, at most MAX_R."""
    sc, sp = c.std(axis=1), p.std(axis=1)
    r = np.where(sp > 0, np.rint(sc / np.where(sp > 0, sp, 1.0)), 1.0)
    return np.clip(r, 1, MAX_R).astype(np.int32)


def build(config, *, seed: int = SEED, calib: int = CALIB, chunk: int = 8,
          device: str = "cpu"):
    """A CompiledNetwork of `config` (a port NetworkConfig of ResNet-50
    v1.5 W1A2), its weights and thresholds as the module docstring says."""
    from bnn_pynq_tpu_torch.compiler.artifacts import (CompiledNetwork,
                                                       config_to_json)
    from bnn_pynq_tpu_torch.ops.packing import np_pack_bits
    ref = _reference()
    cfg = config_to_json(config)
    rng = np.random.default_rng(seed)
    layers = ref.layers_of(cfg)
    for layer in layers:
        for name, shape in ref.weight_shapes(layer).items():
            lim = (1 << (layer.wbits - 1)) - 1 if layer.wbits > 1 else 1
            if lim == 1:
                w = (2 * rng.integers(0, 2, size=shape) - 1).astype(np.int8)
            else:
                w = rng.integers(-lim, lim + 1, size=shape, dtype=np.int8)
            layer.w[name.split("_")[0]] = w
    images = rng.integers(-128, 128, size=(calib,) + tuple(
        cfg["input_shape"]), dtype=np.int8)
    u = rng.uniform(0.75, 1.25, size=cfg["num_classes"])
    e = rng.normal(0.0, 0.1, size=cfg["num_classes"])

    def thresholded(accs, name, layer):
        layer.thr[name] = _quantile_thresholds(_per_channel(accs))
        t = torch.from_numpy(layer.thr[name].astype(np.int64)).to(device)
        return [ref.threshold(acc, t) for acc in accs]

    # the calibration batch's levels (float64 NCHW), layer by layer
    acts = [torch.from_numpy(images[i:i + chunk]).to(device)
            .permute(0, 3, 1, 2).to(torch.float64)
            for i in range(0, calib, chunk)]
    with torch.no_grad():
        for layer in layers[:-1]:
            ws = ref.device_layer(layer, device)
            if layer.kind == "conv":
                acts = thresholded([ref.conv(a, ws["w"], layer.stride,
                                             layer.pad) for a in acts],
                                   "thr", layer)
            elif layer.kind == "maxpool":
                acts = [ref.layer_out(layer, ws, a) for a in acts]
            elif layer.kind == "bottleneck":
                a = thresholded([ref.conv(x, ws["wa"]) for x in acts],
                                "thr_a", layer)
                b = thresholded([ref.conv(x, ws["wb"], layer.stride, 1)
                                 for x in a], "thr_b", layer)
                c = [ref.conv(x, ws["wc"]) for x in b]
                p = [ref.conv(x, ws["wp"], layer.stride) for x in acts] \
                    if layer.projection else acts
                layer.r = _shortcut_mul(_per_channel(c),
                                        _per_channel(p)).astype(np.int64)
                r = torch.from_numpy(layer.r.astype(np.float64)).to(device)
                acts = thresholded([x + r[None, :, None, None] * y
                                    for x, y in zip(c, p)], "thr", layer)
                del a, b, c, p
            else:                                   # the average pool
                layer.thr["thr"] = np.repeat(
                    (layer.window ** 2 * np.arange(1, 4, dtype=np.int64))
                    [:, None], layer.out, axis=1)
                acts = [ref.layer_out(layer, ref.device_layer(layer, device),
                                      a) for a in acts]
        fc = layers[-1]
        ws = ref.device_layer(fc, device)
        acc = _per_channel([ref.layer_out(fc, ws, a) for a in acts]) \
            .astype(np.float64)
        mean, std = acc.mean(axis=1), acc.std(axis=1, ddof=1)
    scale = (u / std).astype(np.float32)
    bias = (-u * mean / std + e).astype(np.float32)
    out = []
    for layer in layers:
        d = {}
        if layer.kind in ("conv", "dense"):
            d["w_int8"] = layer.w["w"]
        for name in ("wa", "wb", "wc", "wp"):
            if name in layer.w:
                d[f"{name}_packed"] = np_pack_bits(layer.w[name], axis=0)
        if layer.r is not None:
            d["r"] = layer.r.astype(np.int32)
        for name, t in layer.thr.items():
            d[name] = np.ascontiguousarray(t, dtype=np.int32)
        out.append(d)
    return CompiledNetwork(
        config=config, layers=out, out_scale=scale, out_bias=bias,
        meta={"generator": "portbench/configs/make_resnet50_w1a2.py",
              "seed": seed, "calibration_images": calib})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu",
                    help="where the convs run (the file is the same)")
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from bnn_pynq_tpu_torch.compiler.artifacts import save_artifact
    from bnn_pynq_tpu_torch.models.config import resnet50_v1_5
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    save_artifact(args.out, build(resnet50_v1_5(), device=args.device))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
