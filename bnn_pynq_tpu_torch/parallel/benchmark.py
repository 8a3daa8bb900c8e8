"""Scaling harness: tensor- and data-parallel throughput at increasing
rank counts.

Port of `bnn_pynq_tpu/parallel/benchmark.py`. For each rank count it spawns
a world (parallel/launch.py), builds a TPInferenceEngine on a mesh of that
size and times `iters` forwards of `batch_per_device` images a rank with
CUDA events and a synchronise on the card (the host clock on the CPU,
where every op is synchronous): through the engine's programs, as JAX
times its jitted call (`images_per_sec`; a graph replay a forward under
NCCL), and, beside them, the eager forward (`eager_images_per_sec`).
`execution` says how the programs ran (parallel/spmd.py). It returns one
row a count, images/s and efficiency (of the programs) against linear
scaling from the first count:

    python -m bnn_pynq_tpu_torch.parallel.benchmark --network cnv-w1a1

`ranks_per_card` says how many ranks shared one card. Where it is above
1 the ranks take turns on that card and talk over gloo through the host
(parallel/comm.py), so the row's efficiency is no scaling figure. On the
CPU it is None. The default counts are the cards present: [1] on a
machine with one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from typing import List, Optional

import numpy as np

from bnn_pynq_tpu_torch.parallel.launch import run_world

# the deadline of each rank count's world, spawn and warm-up included
WORLD_DEADLINE_S = 900


def _time_world(compiled, data, model, batch, iters, device):
    """Runs in every rank: seconds per forward through the programs and
    per eager forward, on this rank's clock, and the engine's
    execution."""
    import torch
    import torch.distributed as dist
    from bnn_pynq_tpu_torch.parallel.mesh import make_mesh
    from bnn_pynq_tpu_torch.parallel.overlap import elapsed_s
    from bnn_pynq_tpu_torch.parallel.tp import TPInferenceEngine
    mesh = make_mesh(data=data, model=model, device=device)
    engine = TPInferenceEngine(compiled, mesh)
    cfg = compiled.config
    rng = np.random.default_rng(0)
    if cfg.input_kind == "bipolar":
        x = rng.choice([-1, 1], size=(
            batch, int(np.prod(cfg.input_shape)))).astype(np.int8)
    else:
        x = rng.integers(-128, 128,
                         size=(batch,) + cfg.input_shape).astype(np.int8)
    engine.logits(x)          # warm: kernels, communicators, the capture
    xd = engine.upload(engine._pad_to_bucket(x)[0])
    params, xl = engine._state.params, engine._rows(xd)
    timed = {}
    for name, fn in (
            ("programs", lambda: engine.launch_prepared(xd)),
            ("eager", lambda: engine._eager(params, xl, False, False))):
        fn()
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        dist.barrier(group=mesh.group)    # every rank starts its clock
        timed[name] = elapsed_s(fn, iters, mesh.device)
    return timed["programs"], timed["eager"], engine.execution


def measure_tp_scaling(compiled, device_counts: Optional[List[int]] = None,
                       batch_per_device: int = 256, iters: int = 10,
                       data_axis: bool = True, *, device: str = "cuda"):
    """Rows {"devices", "mesh", "batch", "images_per_sec",
    "eager_images_per_sec", "execution", "scaling_efficiency",
    "ranks_per_card"} for each rank count."""
    import torch
    cards = torch.cuda.device_count() if device == "cuda" else 0
    if device == "cuda" and not cards:
        raise RuntimeError("device='cuda' but CUDA is not available")
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16) if d <= max(cards, 1)]
    results = []
    for nd in device_counts:
        if data_axis and nd > 1:
            data, model = 2, nd // 2
        else:
            data, model = 1, nd
        batch = batch_per_device * nd
        secs, eager, execution = run_world(
            _time_world, nd, timeout=WORLD_DEADLINE_S, device=device,
            args=(compiled, data, model, batch, iters, device))[0]
        results.append({"devices": nd, "mesh": f"{data}x{model}",
                        "batch": batch, "images_per_sec": batch / secs,
                        "eager_images_per_sec": batch / eager,
                        "execution": execution,
                        "ranks_per_card": -(-nd // cards) if cards
                        else None})
    base = results[0]["images_per_sec"]
    for r in results:
        r["scaling_efficiency"] = r["images_per_sec"] / (base * r["devices"])
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--network", default="cnv-w1a1")
    ap.add_argument("--batch-per-device", type=int, default=256)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from bnn_pynq_tpu_torch.compiler.artifacts import CompiledNetwork
    from bnn_pynq_tpu_torch.models.config import get_config
    from bnn_pynq_tpu_torch.models.network import init_random_params

    cfg = get_config(args.network)
    compiled = CompiledNetwork(
        config=cfg, layers=init_random_params(cfg, seed=0),
        out_scale=np.ones(cfg.num_classes, np.float32),
        out_bias=np.zeros(cfg.num_classes, np.float32))
    if args.device == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
        print(json.dumps({"nvidia_smi": smi}))
    for r in measure_tp_scaling(compiled,
                                batch_per_device=args.batch_per_device,
                                iters=args.iters, device=args.device):
        print(json.dumps(r))


if __name__ == "__main__":
    main()
