"""Per-workload demo, the script analogue of the reference's notebooks: for
one dataset, load the pretrained artifact, classify the test set, and
print top-1 accuracy, per-image latency and the kernels-against-reference
comparison (the RUNTIME_HW / RUNTIME_SW duality of the reference's
`bnn.py`).

    python -m bnn_pynq_tpu_torch.examples.workload_demo mnist
        [--artifact ...] [--batch 256] [--limit N] [--route mega]
        [--device cuda|cpu]
    python -m bnn_pynq_tpu_torch.examples.workload_demo cifar10

Port of `examples/workload_demo.py`. `runtime="kernels"` (the CUDA kernels
on a card, their plain versions on the CPU) against `runtime="ref"` on the
first 512 test images: any differing prediction exits 1. With real data
provisioned (`cli ingest`) the accuracy is the BASELINE.md gate number; on
the synthetic sets (`synthetic_data: true`) it demos the pipeline only.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from bnn_pynq_tpu_torch.runtime.engine import InferenceEngine
from bnn_pynq_tpu_torch.train import data as data_mod
from bnn_pynq_tpu_torch.utils.baseline import baseline_top1

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_ARTIFACTS = {
    "mnist": "pretrained/lfc-w1a1.npz",
    "cifar10": "pretrained/cnv-w1a1.npz",
    "svhn": "pretrained/cnv-w2a2-svhn.npz",
    "gtsrb": "pretrained/cnv-w2a2-gtsrb.npz",
}


def evaluate(engine, ds, batch, limit=None):
    """(top-1, µs per image on the host clock, images) over the first
    `limit` test images."""
    n = len(ds.x_test) if limit is None else min(limit, len(ds.x_test))
    correct = 0
    t0 = time.perf_counter()
    for i in range(0, n, batch):
        hi = min(i + batch, n)
        correct += int((engine.classify(ds.x_test[i:hi])
                        == ds.y_test[i:hi]).sum())
    dt = time.perf_counter() - t0
    return correct / n, dt / n * 1e6, n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dataset", choices=list(DEFAULT_ARTIFACTS))
    ap.add_argument("--artifact", default=None)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--limit", type=int, default=None,
                    help="evaluate only the first N test images")
    ap.add_argument("--route", default="mega")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    artifact = args.artifact or os.path.join(ROOT,
                                             DEFAULT_ARTIFACTS[args.dataset])
    ds = data_mod.load(args.dataset)
    report = {"dataset": args.dataset, "artifact": artifact,
              "synthetic_data": ds.synthetic}
    kw = dict(device=args.device, batch_buckets=(args.batch,))

    hw = InferenceEngine.from_artifact(artifact, runtime="kernels",
                                       route=args.route, **kw)
    acc, usec, n = evaluate(hw, ds, args.batch, args.limit)
    report["hw"] = {"runtime": "kernels", "device": str(hw.device),
                    "top1": round(acc, 5), "usec_per_image": round(usec, 2),
                    "n": n}

    sw = InferenceEngine.from_artifact(artifact, runtime="ref", **kw)
    n_cmp = min(512, n)
    acc_sw, usec_sw, _ = evaluate(sw, ds, args.batch, n_cmp)
    report["sw_ref"] = {"runtime": "ref", "top1": round(acc_sw, 5),
                        "usec_per_image": round(usec_sw, 2), "n": n_cmp}

    xs = ds.x_test[:n_cmp]
    mismatch = int((hw.classify(xs) != sw.classify(xs)).sum())
    report["hw_vs_sw_mismatches"] = mismatch

    name = os.path.basename(artifact).rsplit(".", 1)[0]
    base = baseline_top1(name, args.dataset)
    if base is not None:
        report["reference_top1"] = base
    print(json.dumps(report, indent=2))
    return 1 if mismatch else 0


if __name__ == "__main__":
    raise SystemExit(main())
