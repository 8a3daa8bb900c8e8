"""Full-size CNV-W1A1 training run on the synthetic CIFAR-10 stand-in:
the trainer's stability at full width, then the engine twin of what it
trained held against the training graph.

    python -m bnn_pynq_tpu_torch.tools.train_cnv_synth --out CURVE.jsonl \
        [--epochs 20] [--n-train 16384] [--n-test 2048] [--batch-size 64]
        [--device cuda|cpu]

Port of `tools/train_cnv_synth.py`, with the same arguments and rows: it
trains the full CNV-W1A1 topology (6 convs + 3 dense, STE binarization,
squared hinge loss, Adam with exponential decay, the weight clip:
`train/trainer.py`, on a card as one captured step replayed) on
`train/data.py::_synthetic`, checks that the loss stayed finite and
fell, compiles the best-validation parameters and classifies the first
256 test images with the engine (`route="s2d"`, the kernels). It
appends one row per epoch and a summary row to `--out` (no default: the
caller names the file), marked synthetic: a stability and plumbing
proof, not an accuracy claim. The summary also holds how many of those
256 images the engine classifies as the trained float model does
(`engine_float_agree`; the two differ only where a float32 rounding
meets a threshold). Default device: the card (no CUDA raises).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from bnn_pynq_tpu_torch.compiler import compile_network
from bnn_pynq_tpu_torch.models.config import get_config
from bnn_pynq_tpu_torch.runtime.engine import InferenceEngine
from bnn_pynq_tpu_torch.train import data as data_mod
from bnn_pynq_tpu_torch.train import trainer
from bnn_pynq_tpu_torch.train.model import QuantNet

ENGINE_IMAGES = 256


def float_classes(cfg, result, x_uint8, device) -> np.ndarray:
    """The trained float model's classes (best-validation parameters,
    running statistics) for uint8 images."""
    model = QuantNet(cfg).to(device)
    model.load_variables(result.params, result.batch_stats)
    x = torch.from_numpy(data_mod.train_inputs(
        cfg.dataset, x_uint8, cfg.input_kind)).to(device)
    return trainer.make_eval_fn(cfg, model)(x).argmax(-1).cpu().numpy()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--n-train", type=int, default=16384)
    ap.add_argument("--n-test", type=int, default=2048)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--out", required=True,
                    help="the jsonl file the curve is appended to")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = get_config("cnv-w1a1")
    ds = data_mod._synthetic("cifar10", args.n_train, args.n_test)
    result = trainer.train(cfg, ds, epochs=args.epochs,
                           batch_size=args.batch_size, lr_start=1e-3,
                           lr_end=1e-5, seed=0, log_every=1,
                           device=args.device)

    losses = [h["loss"] for h in result.history]
    if not np.isfinite(losses).all():
        raise RuntimeError("non-finite loss: the trainer is unstable")
    # stability: the curve went down and stayed finite at full width
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"loss did not decrease: {losses[0]:.4f} -> "
                           f"{losses[-1]:.4f}")

    compiled = compile_network(cfg, result.params, result.batch_stats,
                               meta={"data": "synthetic-drill",
                                     "val_acc": result.best_val_acc})
    eng = InferenceEngine(compiled, device=args.device, route="s2d",
                          batch_buckets=(ENGINE_IMAGES,))
    x, y = ds.x_test[:ENGINE_IMAGES], ds.y_test[:ENGINE_IMAGES]
    pred = eng.classify(x)
    agree = int((pred == float_classes(cfg, result, x,
                                       args.device)).sum())

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "a") as f:
        for h in result.history:
            row = dict(net="cnv-w1a1", data="synthetic-drill", **h)
            f.write(json.dumps(row) + "\n")
            print(json.dumps(row), flush=True)
        summ = {"net": "cnv-w1a1", "data": "synthetic-drill",
                "epochs": args.epochs, "n_train": args.n_train,
                "final_loss": round(losses[-1], 4),
                "best_val_acc": round(result.best_val_acc, 4),
                f"engine_s2d_acc_{ENGINE_IMAGES}":
                    round(float((pred == y).mean()), 4),
                "engine_float_agree": agree, "engine_images": len(x),
                "loss_decreased": True, "device": args.device}
        f.write(json.dumps(summ) + "\n")
        print(json.dumps(summ), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
