#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py          # from the repository root; one CUDA card

Phases (every check raises, so any failure exits non-zero):
1. the card: `nvidia-smi` name and power limit, torch's device name;
   no CUDA is a failure;
2. build the kernels from bnn_pynq_tpu_torch/csrc (nvcc, first use);
3. each kernel against its plain version on the card, on seeded inputs at
   the CNV-W1A1 main-path shapes at batch 1024 (and W2A2, LFC cases):
   codes exactly equal, logits within rtol=atol=1e-5; the median device
   time per call of each over 20 runs of 10 back-to-back calls, with
   CUDA events;
4. the main path: InferenceEngine(cnv-w1a1, device="cuda").classify of
   1024 seeded images, with every kernel's launch count read around it;
   logits against runtime="ref" on the card; images/s of both runtimes;
5. the same agreement for lfc-w1a1 (whole net in fused_mlp) and cnv-w2a2;
6. a BatchingServer over the CUDA CNV-W1A1 engine answering 68 requests.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

BATCH = 1024
REPS = 20
TOL = dict(rtol=1e-5, atol=1e-5)
HERE = os.path.dirname(os.path.abspath(__file__))


def _artifact(name):
    return os.path.join(HERE, "pretrained", f"{name}.npz")


def _time_ms(torch, fn, calls=10):
    """Device ms per call: median over REPS runs, each run `calls`
    back-to-back calls between two CUDA events, so the host's enqueue
    time hides behind the queued work instead of adding idle gaps."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def _kernel_cases(torch, device):
    """(kernel name, case label, wrapper fn, plain fn, output kind) at the
    main-path shapes, from the pretrained weights and seeded inputs."""
    from bnn_pynq_tpu_torch.compiler.artifacts import load_artifact
    from bnn_pynq_tpu_torch.models.params import params_from_numpy
    from bnn_pynq_tpu_torch.ops import conv_stack, fused_mlp

    rng = np.random.default_rng(0)

    def dev(a):
        return torch.from_numpy(a).to(device)

    def codes(shape, abits):
        return dev(rng.integers(0, 2 ** abits, size=shape).astype(np.int8))

    cases = []
    for name in ("cnv-w1a1", "cnv-w2a2"):
        c = load_artifact(_artifact(name))
        ab = c.config.abits
        layers, scale, bias = params_from_numpy(
            c.config, c.layers, c.out_scale, c.out_bias, device)
        image = dev(rng.integers(-128, 128, size=(BATCH, 32, 32, 3))
                    .astype(np.int8))
        chain01 = dict(weights=[layers[0]["w"], layers[1]["w"]],
                       thresholds=[layers[0]["thr"], layers[1]["thr"]],
                       kernel=3, abits=ab, input_levels=True)
        x34 = codes((BATCH, 14, 14, 64), ab)
        chain34 = dict(weights=[layers[3]["w"], layers[4]["w"]],
                       thresholds=[layers[3]["thr"], layers[4]["thr"]],
                       kernel=3, abits=ab)
        x6 = codes((BATCH * 9, 1152), ab)
        block6 = dict(weights=[layers[6]["w"]],
                      thresholds=[layers[6]["thr"]], abits=ab)
        xt = codes((BATCH, 2304), ab)
        tail = dict(weights=[layers[i]["w"] for i in (7, 8, 9, 10)],
                    thresholds=[layers[i]["thr"] for i in (7, 8, 9)],
                    out_scale=scale, out_bias=bias, abits=ab)
        cases += [
            ("conv_chain", f"{name} chain0-1 {tuple(image.shape)}",
             lambda x=image, kw=chain01: conv_stack.conv_chain(x, **kw),
             lambda x=image, kw=chain01: conv_stack.conv_chain_plain(x, **kw),
             "codes"),
            ("conv_chain", f"{name} chain3-4 {tuple(x34.shape)}",
             lambda x=x34, kw=chain34: conv_stack.conv_chain(x, **kw),
             lambda x=x34, kw=chain34: conv_stack.conv_chain_plain(x, **kw),
             "codes"),
            ("dense_block", f"{name} block6 {tuple(x6.shape)}",
             lambda x=x6, kw=block6: conv_stack.dense_block(x, **kw),
             lambda x=x6, kw=block6: conv_stack.dense_block_plain(x, **kw),
             "codes"),
            ("fused_mlp", f"{name} mlp_tail {tuple(xt.shape)}",
             lambda x=xt, kw=tail: fused_mlp.fused_mlp_forward(x, **kw),
             lambda x=xt, kw=tail: fused_mlp.fused_mlp_forward_plain(x, **kw),
             "logits"),
        ]
    c = load_artifact(_artifact("lfc-w1a1"))
    layers, scale, bias = params_from_numpy(
        c.config, c.layers, c.out_scale, c.out_bias, device)
    xl = codes((BATCH, 784), 1)
    lfc = dict(weights=[p["w"] for p in layers],
               thresholds=[p["thr"] for p in layers[:-1]],
               out_scale=scale, out_bias=bias, abits=1)
    cases.append(
        ("fused_mlp", f"lfc-w1a1 whole net {tuple(xl.shape)}",
         lambda x=xl, kw=lfc: fused_mlp.fused_mlp_forward(x, **kw),
         lambda x=xl, kw=lfc: fused_mlp.fused_mlp_forward_plain(x, **kw),
         "logits"))
    return cases


def _engine_check(torch, name, images, label):
    """Kernel engine vs ref engine on the card; returns both img/s."""
    from bnn_pynq_tpu_torch.runtime.engine import InferenceEngine
    eng = InferenceEngine.from_artifact(_artifact(name), device="cuda")
    ref = InferenceEngine.from_artifact(_artifact(name), device="cuda",
                                        runtime="ref")
    got = eng.logits(images)
    want = ref.logits(images)
    assert got.shape == (len(images), eng.config.num_classes), got.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)
    assert (got.argmax(1) == want.argmax(1)).all(), f"{name}: argmax"
    rates = {}
    for rt, e in (("kernels", eng), ("ref", ref)):
        e.classify(images)
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            e.classify(images)          # ends in a device→host fetch
            walls.append(time.perf_counter() - t0)
        rates[rt] = len(images) / float(np.median(walls))
    print(f"engine {label}: logits == ref (max |diff| "
          f"{float(np.abs(got - want).max()):.3g}), argmax equal; "
          f"images/s kernels {rates['kernels']:.1f}, ref {rates['ref']:.1f} "
          f"(batch {len(images)}, host clock, median of 5)")
    return eng


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from bnn_pynq_tpu_torch.ops import _build, conv_stack, fused_mlp
    from bnn_pynq_tpu_torch.runtime.engine import InferenceEngine
    from bnn_pynq_tpu_torch.runtime.serving import BatchingServer

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    device = torch.device("cuda", 0)
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"device {kind}, count {torch.cuda.device_count()}")

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.library()
    print(f"kernels: {lib.path.name} ready in "
          f"{time.perf_counter() - t0:.1f} s (nvcc {lib.build_seconds:.1f} s)")
    for line in lib.build_log.splitlines():
        if "registers" in line or "error" in line.lower():
            print(f"  ptxas: {line.strip()}")

    # -- 3. kernels against their plain versions ----------------------------
    counters = {"fused_mlp": fused_mlp.fused_mlp_forward.launches,
                "dense_block": conv_stack.dense_block.launches,
                "conv_chain": conv_stack.conv_chain.launches}
    results = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
               for k in counters}
    for kname, label, kern, plain, kind_out in _kernel_cases(torch, device):
        got, want = kern(), plain()
        torch.cuda.synchronize()
        assert got.shape == want.shape and got.dtype == want.dtype, label
        err = float((got.double() - want.double()).abs().max())
        if kind_out == "codes":
            assert torch.equal(got, want), f"{label}: codes differ"
        else:
            torch.testing.assert_close(got, want, **TOL)
        ms, plain_ms = _time_ms(torch, kern), _time_ms(torch, plain)
        print(f"{kname:11s} {label}: max |kernel - plain| {err:.3g}; "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        r = results[kname]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if label.startswith("cnv-w1a1"):    # main-path time per forward
            r["ms"] += ms
            r["plain_ms"] += plain_ms

    # -- 4. the main path -----------------------------------------------------
    rng = np.random.default_rng(1)
    images = rng.integers(0, 256, size=(BATCH, 32, 32, 3), dtype=np.uint8)
    eng = InferenceEngine.from_artifact(_artifact("cnv-w1a1"), device="cuda")
    for c in counters.values():
        c.reset()
    pred = eng.classify(images)
    torch.cuda.synchronize()
    launches = {k: c.value for k, c in counters.items()}
    print(f"main path: cnv-w1a1 classify batch {BATCH}, launches {launches}")
    for k, n in launches.items():
        assert n > 0, f"main path never launched {k}"
    assert pred.shape == (BATCH,) and pred.min() >= 0 and pred.max() < 10
    eng = _engine_check(torch, "cnv-w1a1", images, "cnv-w1a1")
    assert (eng.classify(images) == pred).all()

    # -- 5. the other whole-network checks -------------------------------------
    mnist = rng.integers(0, 256, size=(BATCH, 28, 28), dtype=np.uint8)
    _engine_check(torch, "lfc-w1a1", mnist, "lfc-w1a1")
    _engine_check(torch, "cnv-w2a2", images, "cnv-w2a2")

    # -- 6. serving ---------------------------------------------------------------
    prepared = eng.prepare(images[:128])
    want = eng.classify(prepared, prepared=True)
    server = BatchingServer(eng, max_batch=256, max_wait_ms=2.0)
    try:
        singles = [server.submit(prepared[i]) for i in range(64)]
        groups = [server.submit_many(prepared[64 + 16 * j:80 + 16 * j])
                  for j in range(4)]
        got_single = np.array([f.result(timeout=120) for f in singles])
        got_many = np.concatenate([f.result(timeout=120) for f in groups])
    finally:
        server.stop()
    assert (got_single == want[:64]).all(), "submit answers differ"
    assert (got_many == want[64:]).all(), "submit_many answers differ"
    print(f"serving: 68 requests answered as engine.classify; "
          f"stats {json.dumps(server.stats.summary())}")

    src = {"fused_mlp": ("bnn_pynq_tpu_torch/csrc/dense_chain.cu",
                         "bnn_pynq_tpu/ops/fused_mlp.py:30"),
           "dense_block": ("bnn_pynq_tpu_torch/csrc/dense_chain.cu",
                           "bnn_pynq_tpu/ops/conv_stack.py:282"),
           "conv_chain": ("bnn_pynq_tpu_torch/csrc/conv_chain.cu",
                          "bnn_pynq_tpu/ops/conv_stack.py:65")}
    kernels = [{"name": k, "route": "cuda", "source": src[k][0],
                "replaces": src[k][1], "launches": launches[k],
                **results[k]} for k in counters]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
