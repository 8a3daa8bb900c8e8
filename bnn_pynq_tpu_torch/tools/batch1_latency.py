"""Batch-1 latency of the port's routes: three timings per route.

    python -m bnn_pynq_tpu_torch.tools.batch1_latency [--net cnv-w1a1]
        [--routes mega,direct,vpu] [--iters 200] [--device cuda|cpu]
        [--out perf_results/torch_batch1.jsonl]

Port of `tools/batch1_latency.py`, on `init_random_params(cfg, seed=0)`
with unit scale and zero bias, one row per route (median of 5 windows):
- `chained_us`: `--iters` launches on a device-resident image between
  CUDA events (the host clock on the CPU): the device's time per forward
  when launches queue behind each other, or the host's enqueue where
  that is longer;
- `sync_dev_us`: a launch and a synchronise each, device-resident input;
- `sync_host_us`: host numpy in, logits fetched to the host, each: what a
  single request waits for (upload, forward, fetch).
`floor_chained_us` / `floor_sync_us` read the same two ways an empty
elementwise launch on a small tensor: the launch floor of this host and
device, under which no forward can go. Rows name the device; on the CPU
they time the plain versions.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from bnn_pynq_tpu_torch.runtime.engine import InferenceEngine
from bnn_pynq_tpu_torch.tools.perf_suite import (device_name, rand_input,
                                                 random_compiled)
from bnn_pynq_tpu_torch.utils.profiling import steady_state_stats


def chained_us(launch, iters: int) -> float:
    """Median over 5 windows of µs per launch, launches back to back
    (`utils/profiling.py`: CUDA events on a card, else the host clock)."""
    return round(steady_state_stats(launch, iters, repeats=5)[0] * 1e6, 2)


def sync_us(launch, iters: int, device) -> float:
    """Median over 5 windows of µs per launch, each launch waited for
    (host clock)."""
    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(iters):
            launch()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        ts.append((time.perf_counter() - t0) / iters * 1e6)
    return round(sorted(ts)[2], 2)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--net", default="cnv-w1a1")
    ap.add_argument("--routes", default="mega,direct,vpu")
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default="perf_results/torch_batch1.jsonl")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but CUDA is not available; pass "
                         "--device cpu to run the plain versions")
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())

    z = torch.zeros((8, 128), device=device)
    n_sync = max(20, args.iters // 4)
    floor_chained = chained_us(lambda: z + 1.0, args.iters)
    floor_sync = sync_us(lambda: z + 1.0, n_sync, device)

    compiled = random_compiled(args.net)
    x_np = rand_input(compiled.config, 1)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    for route in args.routes.split(","):
        eng = InferenceEngine(compiled, device=device, route=route,
                              batch_buckets=(1,))
        xd = eng.upload(x_np)
        eng.fetch(eng.launch_prepared(xd))          # first use builds

        def on_device():
            return eng.launch_prepared(xd)

        row = {
            "net": args.net, "route": route,
            "chained_us": chained_us(on_device, args.iters),
            "sync_dev_us": sync_us(on_device, n_sync, device),
            "sync_host_us": sync_us(
                lambda: eng.logits(x_np, prepared=True), n_sync, device),
            "floor_chained_us": floor_chained,
            "floor_sync_us": floor_sync,
            "device": device_name(device),
        }
        line = json.dumps(row)
        print(line, flush=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
