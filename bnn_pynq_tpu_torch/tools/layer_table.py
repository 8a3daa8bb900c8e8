"""Per-layer table of a network on a route: drives
`utils/layerprof.py::profile_layers` and appends its rows.

    python -m bnn_pynq_tpu_torch.tools.layer_table [--net cnv-w1a1]
        [--route mega|s2d|fused|xla|xlaconv] [--batch 1024] [--iters 50]
        [--device cuda|cpu] [--out perf_results/torch_layerprof.jsonl]

Port of `tools/layer_table.py`, on `init_random_params(cfg, seed=0)` with
unit scale and zero bias: one row per stage of the route (the `mega`
routes' kernel stages; a layer a row on `xla` and `xlaconv`, the
decoded-integer route that JAX's tool profiles), timed under CUDA graph
replay on a card and by the host clock on the CPU, then a `__total__` row
with their sum and the images/s it implies. Every row names its device
and route.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from bnn_pynq_tpu_torch.runtime.engine import MEGA_ROUTES, XLA_ROUTES
from bnn_pynq_tpu_torch.tools.perf_suite import device_name, random_compiled
from bnn_pynq_tpu_torch.utils.layerprof import profile_layers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--net", default="cnv-w1a1")
    ap.add_argument("--route", default="mega",
                    choices=MEGA_ROUTES + tuple(XLA_ROUTES))
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default="perf_results/torch_layerprof.jsonl")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but CUDA is not available; pass "
                         "--device cpu to run the plain versions")

    t0 = time.time()
    rows = profile_layers(random_compiled(args.net), batch=args.batch,
                          iters=args.iters, device=args.device,
                          route=args.route)
    dev = device_name(args.device)
    total_ms = sum(r["ms"] for r in rows)
    lines = [json.dumps(dict(net=args.net, route=args.route,
                             batch=args.batch, device=dev, **r))
             for r in rows]
    lines.append(json.dumps({
        "net": args.net, "route": args.route, "batch": args.batch,
        "device": dev,
        "layer": "__total__", "ms": round(total_ms, 4),
        "images_per_sec": round(args.batch / total_ms * 1e3, 1),
        "wall_s": round(time.time() - t0, 1)}))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "a") as f:
        for line in lines:
            print(line, flush=True)
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
