"""Serving walkthrough: continuous batching with every serving feature.

    python -m bnn_pynq_tpu_torch.examples.serving_pipeline [artifact.npz]
        [--device cuda|cpu]

Port of `examples/serving_pipeline.py`. Shows:
- single-image requests (`submit`) and multi-image requests
  (`submit_many`: one future per client batch);
- pipelined dispatch (batch t+1 launches while batch t is fetched;
  pipeline_depth 2);
- the packed-word transport for bipolar (MLP) engines: host-packed sign
  words, 32× fewer bytes to the device, unpacked there;
- oversized-request splitting into max_batch chunks;
- the adaptive latency tier (a lone request at an idle server goes at
  once) and bucket warmup (a warmed server builds nothing on a request);
- the stats surface (requests, images, batches, p50/p99).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from bnn_pynq_tpu_torch.runtime.engine import InferenceEngine
from bnn_pynq_tpu_torch.runtime.serving import BatchingServer

PRETRAINED = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "pretrained")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("artifact", nargs="?",
                    default=os.path.join(PRETRAINED, "sfc-w1a1.npz"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    engine = InferenceEngine.from_artifact(args.artifact, device=args.device,
                                           batch_buckets=(1, 64, 256))
    print(f"engine: {engine.config.name} runtime={engine.runtime} "
          f"device={engine.device}")
    for b in (1, 64, 256):        # warm every bucket's serving launches
        engine.warmup(b)
    server = BatchingServer(engine, max_batch=256, max_wait_ms=2.0)
    print(f"packed_transport={server.packed_transport} "
          f"pipeline_depth={server.pipeline_depth} "
          f"adaptive_wait={server.adaptive_wait}")

    rng = np.random.default_rng(0)
    shape = tuple(engine.config.input_shape)
    try:
        img = rng.integers(0, 256, size=(1,) + shape).astype(np.uint8)
        one = server.submit(engine.prepare(img)[0]).result(120)
        print(f"single request -> class {one}")

        imgs = rng.integers(0, 256, size=(100,) + shape).astype(np.uint8)
        t0 = time.perf_counter()
        classes = server.submit_many(engine.prepare(imgs)).result(120)
        dt = time.perf_counter() - t0
        print(f"batch request: 100 images in {dt * 1e3:.1f} ms "
              f"-> {np.bincount(classes, minlength=10).tolist()}")

        big = rng.integers(0, 256, size=(700,) + shape).astype(np.uint8)
        classes = server.submit_many(engine.prepare(big)).result(120)
        assert len(classes) == 700
        print(f"oversized request: 700 images -> {len(classes)} results "
              "(split into max_batch chunks internally)")
        print("stats:", server.stats.summary())
    finally:
        server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
