"""Example: the full pipeline — train, compile to an integer artifact,
serve with continuous batching.

    python -m bnn_pynq_tpu_torch.examples.train_compile_serve sfc-w1a1
        [--epochs 5] [--requests 64] [--max-train N] [--out artifacts]
        [--device cuda|cpu]

Port of `examples/train_compile_serve.py`: `trainer.train` on the
network's dataset (synthetic unless real data is provided), then
`compile_network` and `save_artifact` (`<out>/<network>.npz`), then an
`InferenceEngine` behind a `BatchingServer` answering `--requests`
single-image requests. `--max-train` trains on the first N images only.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from bnn_pynq_tpu_torch.compiler import compile_network, save_artifact
from bnn_pynq_tpu_torch.models.config import get_config
from bnn_pynq_tpu_torch.runtime.engine import InferenceEngine
from bnn_pynq_tpu_torch.runtime.serving import BatchingServer
from bnn_pynq_tpu_torch.train.trainer import train


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("network", nargs="?", default="sfc-w1a1")
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--max-train", type=int, default=None)
    ap.add_argument("--out", default="artifacts")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = get_config(args.network)
    print(f"training {cfg.name} on {args.device} ...")
    result = train(cfg, epochs=args.epochs, log_every=1,
                   max_train=args.max_train, device=args.device)
    print(f"best val acc {result.best_val_acc:.4f}")

    compiled = compile_network(cfg, result.params, result.batch_stats,
                               meta={"val_acc": result.best_val_acc})
    path = os.path.join(args.out, f"{cfg.name}.npz")
    save_artifact(path, compiled)
    print(f"artifact saved: {path}")

    engine = InferenceEngine(compiled, device=args.device)
    server = BatchingServer(engine, max_batch=64, max_wait_ms=2.0)
    rng = np.random.default_rng(0)
    xs = engine.prepare(rng.integers(
        0, 256, size=(args.requests,) + tuple(cfg.input_shape)
    ).astype(np.uint8))
    try:
        preds = [f.result(120) for f in [server.submit(x) for x in xs]]
    finally:
        server.stop()
    print(f"served {len(preds)} requests; stats: {server.stats.summary()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
