"""Command-line interface of the PyTorch/CUDA port:

    python -m bnn_pynq_tpu_torch.cli train    cnv-w1a1 --epochs 50 --out artifacts/
    python -m bnn_pynq_tpu_torch.cli compile  artifacts/cnv-w1a1-checkpoint.npz
    python -m bnn_pynq_tpu_torch.cli classify pretrained/cnv-w1a1.npz images.npy
    python -m bnn_pynq_tpu_torch.cli bench    pretrained/cnv-w1a1.npz --batch 1024
    python -m bnn_pynq_tpu_torch.cli eval     pretrained/sfc-w1a1.npz --gate
    python -m bnn_pynq_tpu_torch.cli serve    pretrained/sfc-w1a1.npz --port 8476
    python -m bnn_pynq_tpu_torch.cli reload   pretrained/sfc-w1a1.npz --url ...
    python -m bnn_pynq_tpu_torch.cli ingest   mnist --root raw/
    python -m bnn_pynq_tpu_torch.cli gate-all [--train]
    python -m bnn_pynq_tpu_torch.cli info     [network]

Port of `bnn_pynq_tpu/cli.py` with its flags. `--device` is `cuda` (the
default; without CUDA it raises) or `cpu`; `--runtime` is `kernels` (the
route's CUDA kernels, or their plain versions on the CPU; the JAX CLI's
`auto`, `tpu` and `interpret` are accepted as names of it) or `ref`;
`--route` takes every route name of the JAX package and defaults to the
port's main path, `mega`. `train` and `gate-all` train on `--device` too;
checkpoints and artifacts are the JAX package's formats, so either
package's `compile`, `eval` and `classify` take the other's files.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def _engine_kw(args) -> dict:
    return dict(device=args.device, runtime=args.runtime, route=args.route)


def cmd_classify(args):
    from bnn_pynq_tpu_torch.runtime.classifier import Classifier

    clf = Classifier.from_artifact(args.artifact, **_engine_kw(args))
    imgs = np.load(args.images)
    if imgs.ndim == 3:
        imgs = imgs[None]
    preds = clf.classify_images(imgs)
    for i, p in enumerate(preds):
        print(f"{i}: {int(p)} ({clf.class_name(p)})")
    print(f"usecPerImage: {clf.usecPerImage:.1f}")


def cmd_train(args):
    from bnn_pynq_tpu_torch.compiler import compile_network, save_artifact
    from bnn_pynq_tpu_torch.models.config import get_config
    from bnn_pynq_tpu_torch.train.trainer import train

    cfg = get_config(args.network)
    ckpt = os.path.join(args.out, f"{cfg.name}-checkpoint.npz")
    result = train(cfg, epochs=args.epochs, batch_size=args.batch_size,
                   lr_start=args.lr, seed=args.seed, checkpoint_path=ckpt,
                   log_every=1, device=args.device)
    print(f"best val acc: {result.best_val_acc:.4f}")
    compiled = compile_network(cfg, result.params, result.batch_stats,
                               meta={"val_acc": result.best_val_acc})
    path = os.path.join(args.out, f"{cfg.name}.npz")
    save_artifact(path, compiled)
    print(f"artifact: {path}")


def cmd_compile(args):
    from bnn_pynq_tpu_torch.compiler import compile_network, save_artifact
    from bnn_pynq_tpu_torch.models.config import get_config
    from bnn_pynq_tpu_torch.train.trainer import load_checkpoint

    params, stats, meta = load_checkpoint(args.checkpoint)
    cfg = get_config(args.network or str(meta.get("config", "")))
    compiled = compile_network(cfg, params, stats, meta=dict(meta))
    out = args.out or os.path.join(
        os.path.dirname(args.checkpoint), f"{cfg.name}.npz")
    if os.path.isdir(out):
        out = os.path.join(out, f"{cfg.name}.npz")
    save_artifact(out, compiled)
    print(f"artifact: {out}")


def cmd_bench(args):
    """Time `iters` launches on one device-resident batch: CUDA events
    around the launches and a synchronise on a card, the host clock on
    the CPU. The input is uploaded once, outside the timed region."""
    import torch

    from bnn_pynq_tpu_torch.models.network import input_shape
    from bnn_pynq_tpu_torch.runtime.engine import InferenceEngine

    engine = InferenceEngine.from_artifact(
        args.artifact, batch_buckets=(args.batch,), **_engine_kw(args))
    cfg = engine.config
    rng = np.random.default_rng(0)
    x = rng.integers(-2, 2, size=input_shape(cfg, args.batch)) \
        .astype(np.int8)
    xd = engine.upload(engine._pad_to_bucket(x)[0])

    def launch():
        return engine.launch_prepared(xd, argmax=args.classify)

    engine.fetch(launch())                     # first use builds kernels
    if engine.device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            launch()
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3 / args.iters
        device = torch.cuda.get_device_name(engine.device)
    else:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            out = launch()
        engine.fetch(out)
        dt = (time.perf_counter() - t0) / args.iters
        device = "cpu"
    print(json.dumps({
        "network": cfg.name, "batch": args.batch, "route": args.route,
        "path": "classify" if args.classify else "logits",
        "ms_per_batch": round(dt * 1e3, 3),
        "images_per_sec": round(args.batch / dt, 1),
        "usec_per_image": round(dt / args.batch * 1e6, 3),
        "device": device,
    }))


def cmd_eval(args):
    """Test-set accuracy of an artifact. With --gate, compares against the
    reference table (BASELINE.md) and exits 1 on a real-data Δ>0.1%
    regression; synthetic data marks the gate 'skipped'."""
    from bnn_pynq_tpu_torch.runtime.engine import InferenceEngine
    from bnn_pynq_tpu_torch.train import data as data_mod
    from bnn_pynq_tpu_torch.utils.baseline import gate

    engine = InferenceEngine.from_artifact(args.artifact, **_engine_kw(args))
    cfg = engine.config
    ds = data_mod.load(cfg.dataset)
    correct = total = 0
    bs = args.batch
    for i in range(0, len(ds.x_test), bs):
        xs, ys = ds.x_test[i:i + bs], ds.y_test[i:i + bs]
        correct += int((engine.classify(xs) == ys).sum())
        total += len(ys)
    top1 = correct / total
    out = {
        "network": cfg.name, "dataset": cfg.dataset,
        "synthetic_data": ds.synthetic,
        "top1_accuracy": round(top1, 5), "n_test": total,
    }
    failed = False
    if args.gate:
        passed, ref, delta = gate(cfg.name, cfg.dataset, top1)
        if ds.synthetic:
            out["gate"] = "skipped (synthetic data)"
        elif passed is None:
            out["gate"] = "skipped (no baseline for this network/dataset)"
        else:
            out["gate"] = "passed" if passed else "FAILED"
            out["baseline_top1"] = ref
            out["delta"] = round(delta, 5)
            failed = not passed
    print(json.dumps(out))
    if failed:
        raise SystemExit(1)


def cmd_ingest(args):
    """Convert raw dataset files (MNIST IDX / CIFAR-10 binary / SVHN .mat /
    GTSRB ppm) into the cached npz the loaders resolve."""
    from bnn_pynq_tpu_torch.train.datasets_raw import ingest
    path = ingest(args.dataset, root=args.root, out_dir=args.out)
    print(f"wrote {path}")


GATE_WORKLOADS = (
    # (config name, dataset) — one row per BASELINE.md accuracy entry
    ("sfc-w1a1", "mnist"), ("lfc-w1a1", "mnist"), ("lfc-w1a2", "mnist"),
    ("cnv-w1a1", "cifar10"), ("cnv-w1a2", "cifar10"),
    ("cnv-w2a2", "cifar10"),
    ("cnv-w1a1-svhn", "svhn"), ("cnv-w2a2-svhn", "svhn"),
    ("cnv-w1a1-gtsrb", "gtsrb"), ("cnv-w2a2-gtsrb", "gtsrb"),
)


def cmd_gate_all(args):
    """One-command Δ≤0.1% gate over every BASELINE.md workload:
    ingest-if-present → train-or-load → eval --gate per row. With no real
    data it prints 'skipped' per row and exits 0. Training and the engine
    run on `--device`."""
    from bnn_pynq_tpu_torch.models.config import get_config
    from bnn_pynq_tpu_torch.runtime.engine import InferenceEngine
    from bnn_pynq_tpu_torch.train import data as data_mod
    from bnn_pynq_tpu_torch.train.datasets_raw import ingest
    from bnn_pynq_tpu_torch.utils.baseline import gate

    os.makedirs(args.artifacts, exist_ok=True)
    any_failed = False
    n_skipped = 0
    for net, dataset in GATE_WORKLOADS:
        row = {"network": net, "dataset": dataset}
        try:
            # 1. ingest raw files if present
            try:
                row["ingested"] = os.path.basename(ingest(dataset))
            except FileNotFoundError:
                pass
            ds = data_mod.load(dataset)
            if ds.synthetic:
                row["gate"] = "skipped (no real data)"
                n_skipped += 1
                print(json.dumps(row), flush=True)
                continue

            # 2. train-or-load a real-data artifact (the pretrained/ demo
            # artifacts are synthetic-provenance and are not used here)
            art = os.path.join(args.artifacts, f"{net}.npz")
            if not os.path.exists(art):
                if not args.train:
                    row["gate"] = ("skipped (real data present but no "
                                   f"trained artifact at {art}; rerun "
                                   "with --train)")
                    n_skipped += 1
                    print(json.dumps(row), flush=True)
                    continue
                from bnn_pynq_tpu_torch.compiler import (compile_network,
                                                         save_artifact)
                from bnn_pynq_tpu_torch.train.trainer import preset_for, train
                cfg = get_config(net)
                preset = preset_for(cfg)
                if args.epochs:
                    preset["epochs"] = args.epochs
                result = train(cfg, ds, seed=args.seed,
                               checkpoint_path=os.path.join(
                                   args.artifacts, f"{net}-checkpoint.npz"),
                               device=args.device, **preset)
                compiled = compile_network(
                    cfg, result.params, result.batch_stats,
                    meta={"val_acc": result.best_val_acc,
                          "data": "real", "dataset": dataset})
                save_artifact(art, compiled)
                row["trained"] = round(result.best_val_acc, 5)

            # 3. eval + gate
            engine = InferenceEngine.from_artifact(art, **_engine_kw(args))
            correct = total = 0
            for i in range(0, len(ds.x_test), args.batch):
                xs = ds.x_test[i:i + args.batch]
                ys = ds.y_test[i:i + args.batch]
                correct += int((engine.classify(xs) == ys).sum())
                total += len(ys)
            top1 = correct / total
            passed, ref, delta = gate(net, dataset, top1)
            row.update(top1_accuracy=round(top1, 5), n_test=total,
                       baseline_top1=ref,
                       delta=None if delta is None else round(delta, 5),
                       gate="passed" if passed else "FAILED")
            any_failed |= not passed
        except Exception as e:  # noqa: BLE001 — keep gating other rows
            row["error"] = str(e)[:300]
            any_failed = True
        print(json.dumps(row), flush=True)
    print(json.dumps({"summary": f"skipped x{n_skipped}",
                      "failed": any_failed}), flush=True)
    if any_failed:
        raise SystemExit(1)


def cmd_reload(args):
    """Ship an artifact's bytes to a live `serve` host (POST /reload)."""
    import urllib.request
    with open(args.artifact, "rb") as f:
        body = f.read()
    with urllib.request.urlopen(urllib.request.Request(
            args.url.rstrip("/") + "/reload", data=body),
            timeout=300) as resp:
        print(resp.read().decode())


def cmd_serve(args):
    from bnn_pynq_tpu_torch.runtime.http_server import serve
    buckets = tuple(sorted(int(b) for b in args.buckets.split(",") if b)) \
        if args.buckets else None
    serve(args.artifact, host=args.host, port=args.port,
          max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
          batch_buckets=buckets, warmup=not args.no_warmup,
          **_engine_kw(args))


def cmd_info(args):
    from bnn_pynq_tpu_torch.models.config import (AVAILABLE_CONFIGS,
                                                  get_config)
    from bnn_pynq_tpu_torch.models.network import make_plan

    if not args.network:
        for name in sorted(AVAILABLE_CONFIGS):
            print(name)
        return
    cfg = get_config(args.network)
    print(f"{cfg.name}: {cfg.scheme()}  input={cfg.input_shape} "
          f"({cfg.input_kind})  classes={cfg.num_classes}  "
          f"dataset={cfg.dataset}")
    for i, lp in enumerate(make_plan(cfg)):
        if lp.kind == "pool":
            print(f"  [{i}] pool {lp.window}x{lp.window}")
        else:
            print(f"  [{i}] {lp.kind} K={lp.k} N={lp.n}"
                  + (f" kernel={lp.kernel}" if lp.kernel else "")
                  + ("  (logits)" if lp.last else ""))


def _engine_args(p: argparse.ArgumentParser) -> None:
    from bnn_pynq_tpu_torch.runtime.engine import ROUTES, RUNTIMES
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    p.add_argument("--runtime", default="kernels", choices=RUNTIMES)
    p.add_argument("--route", default="mega", choices=ROUTES)


def main(argv=None):
    p = argparse.ArgumentParser(prog="bnn_pynq_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", help="train a network and emit an artifact")
    t.add_argument("network")
    t.add_argument("--epochs", type=int, default=100)
    t.add_argument("--batch-size", type=int, default=100)
    t.add_argument("--lr", type=float, default=1e-3)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--out", default="artifacts")
    t.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    t.set_defaults(fn=cmd_train)

    c = sub.add_parser("compile", help="compile a checkpoint to an artifact")
    c.add_argument("checkpoint")
    c.add_argument("--network", default=None)
    c.add_argument("--out", default=None)
    c.set_defaults(fn=cmd_compile)

    cl = sub.add_parser("classify", help="classify images (npy file)")
    cl.add_argument("artifact")
    cl.add_argument("images")
    _engine_args(cl)
    cl.set_defaults(fn=cmd_classify)

    b = sub.add_parser("bench", help="throughput benchmark")
    b.add_argument("artifact")
    b.add_argument("--batch", type=int, default=1024)
    b.add_argument("--iters", type=int, default=20)
    _engine_args(b)
    b.add_argument("--classify", action="store_true",
                   help="time the device-argmax classify path")
    b.set_defaults(fn=cmd_bench)

    e = sub.add_parser("eval", help="test-set accuracy of an artifact")
    e.add_argument("artifact")
    e.add_argument("--batch", type=int, default=1024)
    _engine_args(e)
    e.add_argument("--gate", action="store_true",
                   help="fail (exit 1) if real-data accuracy drops >0.1% "
                        "below the reference table")
    e.set_defaults(fn=cmd_eval)

    g = sub.add_parser("ingest", help="convert raw dataset files to the "
                                      "cached npz format")
    g.add_argument("dataset", choices=["mnist", "cifar10", "svhn", "gtsrb"])
    g.add_argument("--root", default=None,
                   help="directory holding the raw files (default: the "
                        "data search dirs)")
    g.add_argument("--out", default=None)
    g.set_defaults(fn=cmd_ingest)

    ga = sub.add_parser("gate-all", help="ingest→train-or-load→gate every "
                                         "BASELINE workload")
    ga.add_argument("--artifacts", default="artifacts",
                    help="dir for real-data-trained artifacts")
    ga.add_argument("--train", action="store_true",
                    help="train missing artifacts on real data "
                         "(reference schedules; long)")
    ga.add_argument("--epochs", type=int, default=0,
                    help="override preset epoch counts (0 = preset)")
    ga.add_argument("--batch", type=int, default=1024)
    ga.add_argument("--seed", type=int, default=0)
    _engine_args(ga)
    ga.set_defaults(fn=cmd_gate_all)

    s = sub.add_parser("serve", help="HTTP classification server")
    s.add_argument("artifact")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8476)
    _engine_args(s)
    s.add_argument("--max-batch", type=int, default=256)
    s.add_argument("--max-wait-ms", type=float, default=3.0)
    s.add_argument("--buckets", default="",
                   help="comma-separated batch buckets; default: the "
                   "engine's standard set")
    s.add_argument("--no-warmup", action="store_true",
                   help="skip running every bucket once before serving "
                   "(the first requests then build the kernels)")
    s.set_defaults(fn=cmd_serve)

    r = sub.add_parser("reload", help="hot-swap parameters on a running "
                       "serve host (POST /reload; zero downtime)")
    r.add_argument("artifact", help="npz artifact to roll out")
    r.add_argument("--url", default="http://127.0.0.1:8476",
                   help="serving host base URL")
    r.set_defaults(fn=cmd_reload)

    i = sub.add_parser("info", help="list networks / show a network plan")
    i.add_argument("network", nargs="?")
    i.set_defaults(fn=cmd_info)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
