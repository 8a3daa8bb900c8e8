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
   CUDA events, and for the main-path cases also under CUDA graph
   replay (no host in the way); then ragged and odd cases of conv_chain
   and dense_block (batch 1 and 1023, N = 10 and 100, C = 3 and 24, a
   5×5 kernel, chains of three layers, W2A2 with three thresholds,
   weights too large for shared memory), all exact, and of fused_mlp (1, 7
   and 1023 rows; SFC, LFC and CNV-tail widths, LFC and SFC with their
   bound and graph-replay time; W2A2 with three thresholds; hidden widths
   that are no multiple of 64; thresholds at the ends of int32);
4. the main path: InferenceEngine(cnv-w1a1, device="cuda").classify of
   1024 seeded images, with every kernel's launch count read around it;
   logits against runtime="ref" on the card; images/s of both runtimes;
5. the same agreement for lfc-w1a1 (whole net in fused_mlp) and cnv-w2a2;
6. a BatchingServer over the CUDA CNV-W1A1 engine answering 68 requests;
7. packed_matmul (csrc/packed_matmul.cu) against its plain version, every
   arm: 'vpu' (the 1-bit tensor-core arm) and 'mxu' (the decode arm on the
   int8 tensor cores) at all eight packed layers of CNV-W1A1 at batch 1024,
   each with its time by events and under graph replay; 'mxu_rm' at its
   conv1/conv4/conv7/dense-512 shapes, 'mxu' at CNV-W2A2's (bits=2), and
   'vpu'/'mxu' at LFC-W1A1's 784→1024 (K ragged) and 1024→1024 layers;
   then odd cases on random words, every route the width allows: M = 1, 7,
   1023; N = 10 int32, N = 10 / 100 / 300 with thresholds; K tails (Kw = 1,
   5, 18, 25); W1A2 words (codes 1 / 2); thresholds at THR_ALWAYS,
   THR_NEVER and the ends of int32; random thresholds within one standard
   deviation of the accumulator; K = 30,000 bits and 12,000 2-bit levels,
   which no block holds whole rows of and the kernel walks in slices; codes
   and int32 exactly equal;
8. the packed routes: InferenceEngine(cnv-w1a1, route="vpu").classify of
   the 1024 images with the packed kernel's launch counts read around it
   (and no plain packed_matmul call), logits against runtime="ref";
   the same for cnv-w2a2 route="mxu" and lfc-w1a1 route="vpu";
9. packed input on lfc-w1a1: logits_packed and logits_words equal logits
   (route "vpu"), logits_words equals logits on route "mega";
10. a BatchingServer over the lfc-w1a1 "vpu" engine with the packed
   transport (words_device) answering 68 requests;
11. conv2d_direct and conv_chain_direct (csrc/conv_direct.cu) against
   their plain versions, exactly: CNV-W1A1's five direct-path layers
   (by events and under graph replay, conv1-3 beside conv_chain's kernel
   on the same layer), CNV-W2A2's layer 1, int32 output (no thresholds),
   5×5, stride 2, C = 3 / 24 / 32 / 256, N = 10 / 48 / 100 / 300, batch 1
   and 1023, W2A2; both chains of both nets, printed beside conv_chain's
   time at the same shapes (phase 3); then odd chains: batch 1 and 1023,
   one layer and three, C = 3 / 24 / 32, N = 10 / 48 / 100, 5×5, W2A2, all
   in one launch with the codes between the layers in shared memory, and
   a 64×64 map that does not fit there and runs a layer a launch through
   conv_chain;
12. the direct route: InferenceEngine(cnv-w1a1, route="direct").classify
   of the 1024 images with conv2d_direct's launch count read around it
   (5) and no plain call, logits against runtime="ref"; the same for
   cnv-w2a2; then batches above the largest bucket: classify of 2048 and
   4096 images on "mega", "direct" and "vpu" equal to runtime="ref" taken
   1024 at a time, with images/s beside the 1024 figure;
13. a BatchingServer over the cnv-w1a1 "direct" engine answering 68
   requests;
14. the seven Mosaic probes (csrc/mosaic_probes.cu) against their plain
   versions, exactly, at JAX's inputs, at seeded random ones (int8 over
   its full range, int32 over ±2^30) and at ragged random shapes (the
   kernels' scalar paths); then their entry point,
   `bnn_pynq_tpu_torch.tools.mosaic_probes --device cuda`: 7 PASS lines,
   every probe kernel launched, no plain call;
15. the serving entry points on cnv-w1a1: `http_server.serve` on the card
   (POST /classify of 128 images == engine.classify, /healthz, /stats,
   /reload 200 with the same artifact and 409 with lfc-w1a1, the HTTP
   round trip's p50/p99 over 50 POSTs), a Frontend over a "mega" and a
   "direct" HTTP backend answering 64 requests, `cli bench --classify` at
   batch 1024, and a BatchingServer with the upload stage answering 68
   requests;
16. training on the card (bnn_pynq_tpu_torch/train/, float32 with TF32
   off): one epoch of CNV-W1A1 at its published widths on the synthetic
   CIFAR-10 set at the preset batch of 50 (81 steps), every parameter and
   buffer on the card, the loss finite and falling from its first to its
   last 10 steps, the quantized kernels within [-1, 1], steps/s and
   images/s (and of a second epoch timed alone); three steps on the card
   against the same steps on the CPU from the same state (losses, batch
   statistics and gradients within the tolerances stated at
   STEP_LOSS_RTOL, the parameters within STEP_PARAM_ATOL of the CPU's Adam
   applied to the card's gradients); the checkpoint read back equal, compiled, and served on
   `mega` by conv_chain, dense_block and fused_mlp (counted launches, no
   plain call) equal to runtime="ref" on the card, the float model's
   accuracy beside the engine's; LFC-W1A2 and CNV-W2A2 trained 10 steps and
   served the same way; `cli train` → `compile` → `eval` on the card;
17. tensor-parallel inference (bnn_pynq_tpu_torch/parallel/): first
   packed_matmul (every arm), conv2d_direct (int32 out on input-channel
   shards, and thresholded) and conv_chain (one layer on the raw image)
   against their plain versions at the shard widths the engines give them;
   then, in a world of one rank on NCCL (mesh (1, 1)), TPInferenceEngine
   on 'vpu' and 'mxu' (8 packed_matmul launches a forward) and
   OverlapTPEngine ring, blocking and 'auto' (conv_chain 1, conv2d_direct
   5) classifying the 1024 images of phase 4, equal to the single-card
   engine (classes exactly, logits within rtol=atol=1e-5), with no plain
   call; then in a world of two ranks sharing the card over gloo, meshes
   (1, 2) and (2, 1) on CNV-W1A1 and LFC-W1A1, both engines, every arm, each
   rank's launches and collectives counted, and a BatchingServer on rank 0
   answering 68 requests while rank 1 follows, with the parameters swapped
   live after 64. Each configuration's ms per forward is printed beside
   the card's name and power limit; two ranks on one card, whose gloo
   collectives go through the host, give no scaling figure. A world past
   its deadline (PARALLEL_DEADLINE_S) fails the run; phase 17.0 also holds
   the three kernels against their plain versions at the row counts that
   path gives them (batch 1024, and 512 a rank on (2, 1)).

    python3 chip_smoke.py --spread  # a host with two or more cards

runs, after phase 1, only a gloo world of two ranks a card over every
card, mesh (2, cards): each rank computes on the card make_mesh gave it
(its current device too, which the launchers use), and TPInferenceEngine
'vpu' and OverlapTPEngine ring and blocking on CNV-W1A1 equal the
single-card engine on that card.

Beside each kernel's time stands its bound: the least time the card could
take for the same work, the larger of operations / peak rate and bytes /
memory rate (each input read once, each output written once; published
peaks of the H100 SXM; the operations of packed_matmul's 'vpu' arm, whose
operands are single bits, at 8 × the int8 peak: PEAK_B1), computed here
from the shapes of this run's inputs. `library_ms` is the time of one PyTorch call that computes the same
function on the same inputs. The five copy and max probes have one (a
strided slice made contiguous, `amax`: PROBE_LIBRARY), held equal to the
kernel here and used nowhere in the port. The dot kernels have none (each
is an integer dot plus thresholds or shifted rows, and PyTorch has no int8
matmul with an epilogue nor an int8 convolution on CUDA), so theirs is
null; for them `int_mm_ms` is `torch._int_mm` on the same M × K × N (for
the convs on patches never built): the dot only, no im2col, no thresholds,
a yardstick that the port never calls.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""

import contextlib
import functools
import io
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


# published peaks of the H100 SXM (dense, 700 W)
PEAK_INT8 = 1979e12       # int8 operations/s on the tensor cores
# 1-bit operations/s on the tensor cores: the data sheet publishes none; the
# 1-bit mma does 8 × the int8 mma's operations at the same instruction rate
# (tools/layer_times.py measures both forms alone), so 8 × the int8 peak
PEAK_B1 = 8 * PEAK_INT8
PEAK_FP32 = 67e12         # operations/s outside the tensor cores
PEAK_BYTES = 3.35e12      # device memory bytes/s


def _work(gemms, *tensors, peak=PEAK_INT8, ops=None):
    """What one call must do: the operations of its dots (2·M·K·N each, or
    `ops`) at `peak`, and the bytes of the tensors it reads; the caller
    adds the output's bytes once it exists."""
    return {"gemms": list(gemms), "peak": peak,
            "ops": ops if ops is not None
            else sum(2 * m * k * n for m, k, n in gemms),
            "bytes": sum(t.numel() * t.element_size() for t in tensors)}


def _conv_gemms(shape, kernel, widths, stride=1):
    """(M, K, N) of each layer of a VALID conv chain on `shape` (NHWC)."""
    b, h, w, c = shape
    gemms = []
    for n in widths:
        h, w = (h - kernel) // stride + 1, (w - kernel) // stride + 1
        gemms.append((b * h * w, kernel * kernel * c, n))
        c = n
    return gemms


def _dense_gemms(m, weights):
    return [(m, w.kn.shape[0], w.kn.shape[1]) for w in weights]


def _kn(weights):
    return [w.kn for w in weights]


def _int_mm_ms(torch, device, gemms):
    """torch._int_mm on int8 operands of each (M, K, N), K and N rounded up
    to 8 as it demands: the dot only. Summed over the gemms."""
    total = 0.0
    for m, k, n in gemms:
        a = torch.ones((max(m, 32), -(-k // 8) * 8), dtype=torch.int8,
                       device=device)
        b = torch.ones((a.shape[1], -(-n // 8) * 8), dtype=torch.int8,
                       device=device)
        total += _time_ms(torch, lambda: torch._int_mm(a, b))
        del a, b
    return total


def _new_result():
    return {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
            "ops_ms": 0.0, "bytes_ms": 0.0, "int_mm_ms": None,
            "graph_ms": None, "library_ms": None, "library_graph_ms": None}


def _bounds(work, out):
    """(ops_ms, bytes_ms) of one call: its operations at their peak rate,
    and its inputs' and output's bytes at the memory rate."""
    nbytes = work["bytes"] + out.numel() * out.element_size()
    return work["ops"] / work["peak"] * 1e3, nbytes / PEAK_BYTES * 1e3


def _account(torch, device, r, work, out, ms, plain_ms):
    """Add one main-path call to its kernel's row: times, bound, and the
    `_int_mm` yardstick where the call is a dot."""
    ops_ms, bytes_ms = _bounds(work, out)
    r["ms"] += ms
    r["plain_ms"] += plain_ms
    r["ops_ms"] += ops_ms
    r["bytes_ms"] += bytes_ms
    r["bound_ms"] += max(ops_ms, bytes_ms)
    if work["gemms"]:
        r["int_mm_ms"] = (r["int_mm_ms"] or 0.0) + \
            _int_mm_ms(torch, device, work["gemms"])
    return max(ops_ms, bytes_ms)


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
    """(kernel name, case label, wrapper fn, plain fn, output kind, work) at
    the main-path shapes, from the pretrained weights and seeded inputs;
    then the ragged and odd cases of conv_chain and dense_block (work None:
    checked and timed, on no kernel's row)."""
    from bnn_pynq_tpu_torch.compiler.artifacts import load_artifact
    from bnn_pynq_tpu_torch.models.params import (params_from_numpy,
                                                  weight_matrix)
    from bnn_pynq_tpu_torch.ops import conv_stack, fused_mlp

    rng = np.random.default_rng(0)

    def dev(a):
        return torch.from_numpy(a).to(device)

    def codes(shape, abits):
        return dev(rng.integers(0, 2 ** abits, size=shape).astype(np.int8))

    cases = []
    nets = {}
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
             "codes", _work(_conv_gemms(image.shape, 3, (64, 64)), image,
                            *_kn(chain01["weights"]),
                            *chain01["thresholds"])),
            ("conv_chain", f"{name} chain3-4 {tuple(x34.shape)}",
             lambda x=x34, kw=chain34: conv_stack.conv_chain(x, **kw),
             lambda x=x34, kw=chain34: conv_stack.conv_chain_plain(x, **kw),
             "codes", _work(_conv_gemms(x34.shape, 3, (128, 128)), x34,
                            *_kn(chain34["weights"]),
                            *chain34["thresholds"])),
            ("dense_block", f"{name} block6 {tuple(x6.shape)}",
             lambda x=x6, kw=block6: conv_stack.dense_block(x, **kw),
             lambda x=x6, kw=block6: conv_stack.dense_block_plain(x, **kw),
             "codes", _work(_dense_gemms(len(x6), block6["weights"]), x6,
                            *_kn(block6["weights"]),
                            *block6["thresholds"])),
            ("fused_mlp", f"{name} mlp_tail {tuple(xt.shape)}",
             lambda x=xt, kw=tail: fused_mlp.fused_mlp_forward(x, **kw),
             lambda x=xt, kw=tail: fused_mlp.fused_mlp_forward_plain(x, **kw),
             "logits", _work(_dense_gemms(len(xt), tail["weights"]), xt,
                             *_kn(tail["weights"]), *tail["thresholds"],
                             scale, bias)),
        ]
        nets[name] = layers
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
         "logits", _work(_dense_gemms(len(xl), lfc["weights"]), xl,
                         *_kn(lfc["weights"]), *lfc["thresholds"], scale,
                         bias)))
    tails = {name: dict(weights=[nets[name][i]["w"] for i in (7, 8, 9, 10)],
                        thresholds=[nets[name][i]["thr"] for i in (7, 8, 9)],
                        out_scale=scale, out_bias=bias)
             for name in nets}      # any scale and bias of 10 classes will do

    # -- ragged and odd cases of the two tensor-core kernels ----------------
    def rand_layers(widths, wbits, abits, k=1):
        """Random levels and sorted thresholds within one standard deviation
        of the accumulator."""
        wl = [-1, 1] if wbits == 1 else [-3, -1, 1, 3]
        ws, ts = [], []
        for cin, cout in zip(widths[:-1], widths[1:]):
            ws.append(weight_matrix(dev(rng.choice(
                wl, size=(k * k * cin, cout)).astype(np.int8))))
            sd = int((k * k * cin) ** .5 * (1 if abits == 1 else 5 ** .5)
                     * (1 if wbits == 1 else 5 ** .5))
            ts.append(dev(np.sort(rng.integers(
                -sd, sd + 1, size=(2 ** abits - 1, cout)), axis=0)
                .astype(np.int32)))
        return ws, ts

    def conv(label, x, ws, ts, **kw):
        kw = dict(weights=ws, thresholds=ts, **kw)
        cases.append(("conv_chain", f"odd: {label} {tuple(x.shape)}",
                      lambda: conv_stack.conv_chain(x, **kw),
                      lambda: conv_stack.conv_chain_plain(x, **kw),
                      "codes", None))

    def dense(label, x, ws, ts, **kw):
        kw = dict(weights=ws, thresholds=ts, **kw)
        cases.append(("dense_block", f"odd: {label} {tuple(x.shape)}",
                      lambda: conv_stack.dense_block(x, **kw),
                      lambda: conv_stack.dense_block_plain(x, **kw),
                      "codes", None))

    def mlp(label, x, work=False, **kw):
        cases.append(("fused_mlp", f"odd: {label} {tuple(x.shape)}",
                      lambda: fused_mlp.fused_mlp_forward(x, **kw),
                      lambda: fused_mlp.fused_mlp_forward_plain(x, **kw),
                      "logits",
                      _work(_dense_gemms(len(x), kw["weights"]), x,
                            *_kn(kw["weights"]), *kw["thresholds"],
                            kw["out_scale"], kw["out_bias"])
                      if work else None))

    def rand_mlp(widths, wbits, abits):
        ws, ts = rand_layers(widths, wbits, abits)
        return dict(weights=ws, thresholds=ts[:-1], abits=abits,
                    out_scale=dev(rng.uniform(0.01, 1.0, size=widths[-1])
                                  .astype(np.float32)),
                    out_bias=dev(rng.standard_normal(widths[-1])
                                 .astype(np.float32)))

    def pick(name, idx):
        return ([nets[name][i]["w"] for i in idx],
                [nets[name][i]["thr"] for i in idx])

    image = dev(rng.integers(-128, 128, size=(1023, 32, 32, 3))
                .astype(np.int8))
    conv("cnv-w1a1 chain0-1, batch 1", image[:1].contiguous(),
         *pick("cnv-w1a1", (0, 1)), kernel=3, abits=1, input_levels=True)
    conv("cnv-w2a2 chain0-1 (C=3 levels, nthr=3), batch 1023", image,
         *pick("cnv-w2a2", (0, 1)), kernel=3, abits=2, input_levels=True)
    conv("cnv-w1a1 chain3-4, batch 1023", codes((1023, 14, 14, 64), 1),
         *pick("cnv-w1a1", (3, 4)), kernel=3, abits=1)
    conv("N=10", codes((37, 9, 9, 64), 1), *rand_layers([64, 10], 1, 1, 3),
         kernel=3, abits=1)
    conv("C=24, N=100, W2A2", codes((33, 11, 11, 24), 2),
         *rand_layers([24, 100], 2, 2, 3), kernel=3, abits=2)
    conv("5x5, C=32, N=48", codes((65, 12, 12, 32), 1),
         *rand_layers([32, 48], 1, 1, 5), kernel=5, abits=1)
    conv("three layers, W2A2", codes((50, 12, 12, 32), 2),
         *rand_layers([32, 64, 32, 16], 2, 2, 3), kernel=3, abits=2)
    conv("weights past shared memory (C=256, N=256)",
         codes((8, 6, 6, 256), 1), *rand_layers([256, 256], 1, 1, 3),
         kernel=3, abits=1)
    dense("cnv-w1a1 block6, 1 row", codes((1, 1152), 1), *pick("cnv-w1a1", (6,)),
          abits=1)
    dense("cnv-w2a2 block6 (nthr=3), 1023·9 rows", codes((1023 * 9, 1152), 2),
          *pick("cnv-w2a2", (6,)), abits=2)
    dense("three layers, K=200, N=100/64/10, W2A2", codes((1023, 200), 2),
          *rand_layers([200, 100, 64, 10], 2, 2), abits=2)
    dense("levels in, K=40, N=300", dev(rng.choice(
        [-1, 1], size=(100, 40)).astype(np.int8)),
        *rand_layers([40, 300], 1, 1), abits=1, input_levels=True)
    mlp("cnv-w1a1 mlp_tail, 1 row", codes((1, 2304), 1), abits=1,
        **tails["cnv-w1a1"])
    mlp("cnv-w2a2 mlp_tail (nthr=3), 1023 rows", codes((1023, 2304), 2),
        abits=2, **tails["cnv-w2a2"])
    mlp("lfc-w1a1 whole net, 7 rows", codes((7, 784), 1), **lfc)
    mlp("sfc widths 784-256-256-256-10", codes((BATCH, 784), 1), work=True,
        **rand_mlp([784, 256, 256, 256, 10], 1, 1))
    mlp("hidden N=100/72, K0=200, W2A2", codes((37, 200), 2),
        **rand_mlp([200, 100, 72, 10], 2, 2))
    mlp("one layer, N=10", codes((1023, 96), 1), **rand_mlp([96, 10], 1, 1))
    ends = rand_mlp([64, 136, 48, 10], 2, 2)
    for t in ends["thresholds"]:            # never / always, per column
        t[0, ::3] = -2 ** 31
        t[2, ::2] = 2 ** 31 - 1
        t[:, 5] = 2 ** 31 - 1
        t[:, 7] = -2 ** 31
    mlp("thresholds at the ends of int32", codes((70, 64), 2), **ends)
    return cases


def _packed_cases(torch, device):
    """(case label, route, wrapper fn, plain fn, work or None, the sum the
    case's times go to or None) for packed_matmul. First the packed routes'
    shapes at batch 1024 (operations counted at the rate of the operands the
    arm multiplies: 1-bit on 'vpu', int8 on the decode arm): the pretrained
    words and thresholds, activation
    words from a seeded generator (pad bits zero, as the packers leave
    them); CNV-W1A1's eight layers on 'vpu' are the kernel's row, the same
    on 'mxu' the decode arm's sum. Then odd cases on random levels, packed
    here, thresholds within one standard deviation of the accumulator."""
    from bnn_pynq_tpu_torch.compiler.artifacts import load_artifact
    from bnn_pynq_tpu_torch.models.network import make_plan
    from bnn_pynq_tpu_torch.models.params import params_from_numpy
    from bnn_pynq_tpu_torch.ops import matmul, packing
    from bnn_pynq_tpu_torch.ops.thresholds import THR_ALWAYS, THR_NEVER

    gen = torch.Generator(device=device).manual_seed(2)
    cases = []

    def add(label, route, a, wp, kw, work=None, total=None):
        cases.append((
            label, route,
            lambda: matmul.packed_matmul(a, wp, route=route, **kw),
            lambda: matmul.packed_matmul_plain(a, wp, route=route, **kw),
            work, total))

    plan_arms = (("cnv-w1a1", ("vpu", "mxu"), None, True),
                 ("cnv-w1a1", ("mxu_rm",), (1, 4, 7, 9), False),
                 ("cnv-w2a2", ("mxu",), (1, 4, 7, 9), False),
                 ("lfc-w1a1", ("vpu", "mxu"), (0, 1), False))
    for name, routes, only, main in plan_arms:
        c = load_artifact(_artifact(name))
        bits = c.config.bits
        layers = params_from_numpy(c.config, c.layers, c.out_scale,
                                   c.out_bias, device)[0]
        h, w, _ = c.config.input_shape
        for i, lp in enumerate(make_plan(c.config)):
            if lp.kind == "pool":
                h, w = h // lp.window, w // lp.window
                continue
            m = BATCH
            if lp.kind != "dense":
                h = (h - lp.kernel) // lp.stride + 1
                w = (w - lp.kernel) // lp.stride + 1
                m = BATCH * h * w
            if lp.kind == "conv_int8" or (only and i not in only):
                continue
            kw = packing.packed_len(lp.k, bits)
            a = torch.randint(-2 ** 31, 2 ** 31, (m, kw), generator=gen,
                              device=device, dtype=torch.int32)
            valid = 32 - packing.pad_amount(lp.k, bits) * bits
            if valid < 32:
                a[:, -1] &= (1 << valid) - 1
            kw_args = dict(thr=layers[i].get("thr") if not lp.last else None,
                           k=lp.k, bits=bits)
            for route in routes:
                add(f"{name} layer{i} {route} M={m} K={lp.k} N={lp.n}"
                    f"{' int32' if lp.last else ''}", route, a,
                    layers[i]["w_packed"], kw_args,
                    _work([(m, lp.k, lp.n)], a, layers[i]["w_packed"],
                          *([] if lp.last else [layers[i]["thr"]]),
                          peak=PEAK_B1 if route == "vpu" else PEAK_INT8)
                    if main else None, route if main else None)

    # -- odd cases ------------------------------------------------------------
    rng = np.random.default_rng(5)

    def words(levels_or_codes, bits, axis):
        pack = packing.np_pack_bits if bits == 1 else packing.np_pack_codes2
        return packing.words_to_tensor(pack(levels_or_codes, axis=axis)) \
            .to(device)

    def odd(label, bits, m, k, n, nthr, w_binary=False, ends=False,
            timed=False):
        if bits == 1:
            a = words(rng.choice([-1, 1], size=(m, k)), 1, -1)
            wp = words(rng.choice([-1, 1], size=(k, n)), 1, 0)
            sd = int(k ** .5)
        else:
            a = words(rng.integers(0, 4, size=(m, k)), 2, -1)
            wp = words(rng.integers(1, 3, size=(k, n)) if w_binary
                       else rng.integers(0, 4, size=(k, n)), 2, 0)
            sd = int(k ** .5 * 5 ** .5 * (1 if w_binary else 5 ** .5))
        thr = None
        if nthr:
            thr = np.sort(rng.integers(-sd, sd + 1, size=(nthr, n)),
                          axis=0).astype(np.int32)
            if ends:                # never / always, per column
                thr[0, ::3] = -2 ** 31
                thr[-1, ::2] = 2 ** 31 - 1
                thr[:, 5] = 2 ** 31 - 1
                thr[:, 7] = -2 ** 31
                thr[:, 9] = THR_NEVER
                thr[:, 11] = THR_ALWAYS
            thr = torch.from_numpy(thr).to(device)
        for route in (("vpu", "mxu", "mxu_rm") if bits == 1
                      else ("mxu", "mxu_rm")):
            add(f"{'small' if timed else 'odd'}: {label} {route} M={m} K={k} "
                f"N={n} bits={bits}{'' if nthr else ' int32'}", route, a, wp,
                dict(thr=thr, k=k, bits=bits))

    odd("batch-1 dense", 1, 1, 512, 512, 1, timed=True)
    odd("batch-1 conv5", 1, 1, 2304, 256, 1, timed=True)
    odd("last layer", 1, 1024, 512, 10, 0, timed=True)
    odd("batch-1 last layer", 1, 1, 512, 10, 0, timed=True)
    odd("7 rows, Kw=18", 1, 7, 576, 64, 1)
    odd("1023 rows, Kw=18", 1, 1023, 576, 64, 1)
    odd("N=10, Kw=5 (K tail)", 1, 333, 150, 10, 1)
    odd("N=100, Kw=25 (K tail)", 1, 1023, 784, 100, 1)
    odd("N=300, Kw=1 (K=27)", 1, 500, 27, 300, 1)
    odd("N=300 int32, Kw=18, odd M", 1, 77, 576, 300, 0)
    odd("W1A2 words (codes 1/2), nthr=3", 2, 777, 576, 64, 3, w_binary=True)
    odd("W2A2 K=27 (K tail), N=100", 2, 1023, 27, 100, 3)
    odd("W2A2 N=10 int32, K=200", 2, 64, 200, 10, 0)
    # K beyond what a block holds whole rows of: walked in slices
    odd("K=30,000 in slices", 1, 300, 30000, 72, 1)
    odd("K=30,000 in slices, N=10 int32, one row", 1, 1, 30000, 10, 0)
    odd("W2A2 K=12,000 in slices, N=300", 2, 77, 12000, 300, 3)
    odd("thresholds at the ends", 1, 70, 150, 48, 3, ends=True)
    odd("thresholds at the ends, W2A2", 2, 70, 150, 48, 3, ends=True)
    return cases


def _direct_cases(torch, device):
    """(kernel name, case label, wrapper fn, plain fn, work on the main path
    or None, conv_chain's kernel on the same layer or None) for the direct
    kernels at batch 1024, from the pretrained weights and seeded inputs;
    then odd cases of conv2d_direct on random weights. The chain labels are
    phase 3's conv_chain labels."""
    from bnn_pynq_tpu_torch.compiler.artifacts import load_artifact
    from bnn_pynq_tpu_torch.models.params import (params_from_numpy,
                                                  weight_matrix)
    from bnn_pynq_tpu_torch.ops import conv_direct as cd
    from bnn_pynq_tpu_torch.ops import conv_stack

    rng = np.random.default_rng(3)

    def dev(a):
        return torch.from_numpy(a).to(device)

    def codes(shape, abits):
        return dev(rng.integers(0, 2 ** abits, size=shape).astype(np.int8))

    def conv(name, label, x, main=False, chain=False, **kw):
        work = _work(_conv_gemms(x.shape, kw["kernel"], [kw["w"].kn.shape[1]]),
                     x, kw["w"].kn, kw["thr"]) if main else None
        return ("conv2d_direct", f"{name} {label} {tuple(x.shape)}",
                lambda: cd.conv2d_direct(x, **kw),
                lambda: cd.conv2d_direct_plain(x, **kw), work,
                (lambda: conv_stack.conv_chain(
                    x, [kw["w"]], [kw["thr"]], kernel=kw["kernel"],
                    abits=kw["abits"])) if chain else None)

    def rand(cin, cout, k, wbits, abits):
        """Random levels and sorted thresholds within one standard deviation
        of the accumulator."""
        wl = [-1, 1] if wbits == 1 else [-3, -1, 1, 3]
        w = weight_matrix(dev(rng.choice(wl, size=(k * k * cin, cout))
                              .astype(np.int8)))
        sd = int((k * k * cin) ** .5 * (1 if abits == 1 else 5 ** .5)
                 * (1 if wbits == 1 else 5 ** .5))
        return w, dev(np.sort(rng.integers(
            -sd, sd + 1, size=(2 ** abits - 1, cout)), axis=0)
            .astype(np.int32))

    cases = []
    for name in ("cnv-w1a1", "cnv-w2a2"):
        c = load_artifact(_artifact(name))
        ab = c.config.abits
        layers = params_from_numpy(c.config, c.layers, c.out_scale,
                                   c.out_bias, device)[0]
        w1a1 = name == "cnv-w1a1"
        # the direct path's conv layers: (plan index, input H = W, C); the
        # last one's kernel covers its map (the dense kernel takes it)
        direct_layers = ((1, 30, 64), (3, 14, 64), (4, 12, 128),
                         (6, 5, 128), (7, 3, 256))
        for i, hw, ch in direct_layers if w1a1 else direct_layers[::4]:
            cases.append(conv(name, f"layer{i}", codes((BATCH, hw, hw, ch),
                                                       ab), main=w1a1,
                              chain=w1a1 and i in (1, 3, 4),
                              w=layers[i]["w"], thr=layers[i]["thr"],
                              kernel=3, abits=ab))
        image = dev(rng.integers(-128, 128, size=(BATCH, 32, 32, 3))
                    .astype(np.int8))
        x34 = codes((BATCH, 14, 14, 64), ab)
        for label, x, js, levels in (("chain0-1", image, (0, 1), True),
                                     ("chain3-4", x34, (3, 4), False)):
            kw = dict(weights=[layers[j]["w"] for j in js],
                      thresholds=[layers[j]["thr"] for j in js],
                      kernel=3, abits=ab, input_levels=levels)
            cases.append(
                ("conv_chain_direct", f"{name} {label} {tuple(x.shape)}",
                 lambda x=x, kw=kw: cd.conv_chain_direct(x, **kw),
                 lambda x=x, kw=kw: cd.conv_chain_direct_plain(x, **kw),
                 _work(_conv_gemms(x.shape, 3, [w.kn.shape[1]
                                                for w in kw["weights"]]),
                       x, *_kn(kw["weights"]), *kw["thresholds"])
                 if w1a1 else None, None))
        if w1a1:
            x1 = codes((BATCH, 30, 30, 64), 1)
            w5, t5 = rand(64, 64, 5, 1, 1)
            cases += [
                conv(name, "layer1 int32", x1, w=layers[1]["w"], kernel=3,
                     abits=1),
                conv(name, "layer1 stride 2", x1, w=layers[1]["w"],
                     thr=layers[1]["thr"], kernel=3, abits=1, stride=2),
                conv(name, "5x5 random weights", codes((BATCH, 14, 14, 64),
                                                       1),
                     w=w5, thr=t5, kernel=5, abits=1),
                conv(name, "layer3, batch 1023", codes((1023, 14, 14, 64), 1),
                     w=layers[3]["w"], thr=layers[3]["thr"], kernel=3,
                     abits=1),
                conv(name, "layer7 int32 (1x1 map, column chunks)",
                     codes((1023, 3, 3, 256), 1), w=layers[7]["w"], kernel=3,
                     abits=1)]

    def odd(label, shape, cout, k, wbits, abits, thr=True, stride=1):
        w, t = rand(shape[-1], cout, k, wbits, abits)
        cases.append(conv("odd:", label, codes(shape, abits), w=w,
                          thr=t if thr else None, kernel=k, abits=abits,
                          **({"stride": stride} if stride != 1 else {})))

    odd("C=3, N=10, batch 1", (1, 9, 9, 3), 10, 3, 1, 1)
    odd("C=24, N=100, W2A2", (33, 11, 11, 24), 100, 3, 2, 2)
    odd("C=32, N=48, 5x5", (65, 12, 12, 32), 48, 5, 1, 1)
    odd("C=256, N=300 (column chunks)", (8, 6, 6, 256), 300, 3, 1, 1)
    odd("C=256, N=300 int32", (8, 6, 6, 256), 300, 3, 1, 1, thr=False)
    odd("C=32, N=10 int32, W2A2", (5, 7, 7, 32), 10, 3, 2, 2, thr=False)
    odd("C=3, N=9 int32 (odd width)", (5, 7, 7, 3), 9, 3, 1, 1, thr=False)
    odd("stride 2, C=24, N=20, W2A2", (9, 11, 11, 24), 20, 3, 2, 2,
        stride=2)
    odd("stride 2, C=3, N=48", (1023, 8, 8, 3), 48, 3, 1, 1, stride=2)
    odd("kernel covers the map, 5x5, C=24, N=100, W2A2", (9, 5, 5, 24), 100,
        5, 2, 2)

    # -- odd chains: one launch, the codes between the layers on chip ---------
    def chain(label, x, chans, k, wbits, abits, **kw):
        ws, ts = zip(*(rand(ci, co, k, wbits, abits)
                       for ci, co in zip(chans[:-1], chans[1:])))
        if kw.get("input_levels"):      # the image's accumulator is wider
            ts = (ts[0] * 74,) + ts[1:]
        kw = dict(weights=list(ws), thresholds=list(ts), kernel=k,
                  abits=abits, **kw)
        cases.append(
            ("conv_chain_direct", f"odd: {label} {tuple(x.shape)}",
             lambda: cd.conv_chain_direct(x, **kw),
             lambda: cd.conv_chain_direct_plain(x, **kw), None, None))

    def image(b, hw):
        return dev(rng.integers(-128, 128, size=(b, hw, hw, 3))
                   .astype(np.int8))

    chain("batch 1, image, N=64/64", image(1, 32), [3, 64, 64], 3, 1, 1,
          input_levels=True)
    chain("batch 1023, C=64, N=128/128", codes((1023, 14, 14, 64), 1),
          [64, 128, 128], 3, 1, 1)
    chain("one layer, C=32, N=48", codes((65, 12, 12, 32), 1), [32, 48], 3,
          1, 1)
    chain("one layer, image, N=100", image(33, 16), [3, 100], 3, 1, 1,
          input_levels=True)
    chain("three layers, W2A2, N=64/32/10", codes((50, 12, 12, 32), 2),
          [32, 64, 32, 10], 3, 2, 2)
    chain("C=24 gathered, N=24 gathered, N=16", codes((33, 11, 11, 24), 1),
          [24, 24, 16], 3, 1, 1)
    chain("5x5, C=32, N=32/48, W2A2", codes((17, 13, 13, 32), 2),
          [32, 32, 48], 5, 2, 2)
    chain("weight chunks, C=128, N=256/64", codes((9, 7, 7, 128), 1),
          [128, 256, 64], 3, 1, 1)
    chain("a 64x64 map: a layer a launch", codes((3, 64, 64, 64), 1),
          [64, 64, 32], 3, 1, 1)
    return cases


def _engine_check(torch, name, images, label, route="mega"):
    """Kernel engine vs ref engine on the card; returns the kernel engine
    (and prints both img/s)."""
    from bnn_pynq_tpu_torch.runtime.engine import InferenceEngine
    eng = InferenceEngine.from_artifact(_artifact(name), device="cuda",
                                        route=route)
    ref = InferenceEngine.from_artifact(_artifact(name), device="cuda",
                                        runtime="ref")
    got = eng.logits(images)
    want = ref.logits(images)
    assert got.shape == (len(images), eng.config.num_classes), got.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)
    assert (got.argmax(1) == want.argmax(1)).all(), f"{name}: argmax"
    rates = {}
    for rt, e in ((route, eng), ("ref", ref)):
        e.classify(images)
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            e.classify(images)          # ends in a device→host fetch
            walls.append(time.perf_counter() - t0)
        rates[rt] = len(images) / float(np.median(walls))
    print(f"engine {label}: logits == ref (max |diff| "
          f"{float(np.abs(got - want).max()):.3g}), argmax equal; "
          f"images/s {route} {rates[route]:.1f}, ref {rates['ref']:.1f} "
          f"(batch {len(images)}, host clock, median of 5)")
    return eng


def _big_batch_check(torch, rng):
    """Batches above the largest bucket (1024) on CNV-W1A1: `classify` of
    2048 and 4096 images on three routes must give, image for image, what
    runtime="ref" gives 1024 at a time; images/s (host clock, median and
    range of 5) beside the 1024 figure of the same engine."""
    from bnn_pynq_tpu_torch.runtime.engine import InferenceEngine
    big = rng.integers(0, 256, size=(4 * BATCH, 32, 32, 3), dtype=np.uint8)
    ref = InferenceEngine.from_artifact(_artifact("cnv-w1a1"), device="cuda",
                                        runtime="ref")
    want = np.concatenate([ref.classify(big[i:i + BATCH])
                           for i in range(0, len(big), BATCH)])
    for route in ("mega", "direct", "vpu"):
        eng = InferenceEngine.from_artifact(_artifact("cnv-w1a1"),
                                            device="cuda", route=route)
        assert eng.batch_buckets[-1] == BATCH
        parts = []
        for b in (BATCH, 2 * BATCH, 4 * BATCH):
            got = eng.classify(big[:b])
            assert got.shape == (b,) and (got == want[:b]).all(), \
                f"{route}: classify of {b} images != ref in buckets"
            walls = []
            for _ in range(5):
                t0 = time.perf_counter()
                eng.classify(big[:b])
                walls.append(time.perf_counter() - t0)
            parts.append(f"{b}: {b / float(np.median(walls)):.1f} "
                         f"({b / max(walls):.1f}-{b / min(walls):.1f})")
        print(f"big batches cnv-w1a1 {route}: classify == ref taken "
              f"{BATCH} at a time; images/s (median of 5, range) "
              f"{'; '.join(parts)}")


def _serve_68(BatchingServer, eng, prepared, label, **server_kw):
    """68 requests (64 single, 4 of 16) through a BatchingServer; each
    answer must be engine.classify's. Returns the server (stopped)."""
    want = eng.classify(prepared, prepared=True)
    server = BatchingServer(eng, max_batch=256, max_wait_ms=2.0,
                            **server_kw)
    try:
        singles = [server.submit(prepared[i]) for i in range(64)]
        groups = [server.submit_many(prepared[64 + 16 * j:80 + 16 * j])
                  for j in range(4)]
        got_single = np.array([f.result(timeout=120) for f in singles])
        got_many = np.concatenate([f.result(timeout=120) for f in groups])
    finally:
        server.stop()
    assert (got_single == want[:64]).all(), f"{label}: submit answers differ"
    assert (got_many == want[64:]).all(), \
        f"{label}: submit_many answers differ"
    print(f"serving {label}: 68 requests answered as engine.classify; "
          f"stats {json.dumps(server.stats.summary())}")
    return server


# the TPU probe each port probe replaces (tools/mosaic_probes.py)
PROBE_LINES = {"probe_lane_concat": 37, "probe_scratch_lane_store": 57,
               "probe_mid_dim_index": 79, "probe_pool_reshape_max": 94,
               "probe_strided_row_slice": 115, "probe_lane_slice_64": 129,
               "probe_int32_acc_reshape": 143}


# the one PyTorch call that computes a probe's function, where there is one
# (inputs and options as the probe's wrapper takes them)
PROBE_LIBRARY = {
    "probe_mid_dim_index": lambda x: x[::2].contiguous(),
    "probe_pool_reshape_max": lambda x, bb=4, h=16, w=16: x.view(
        bb, h // 2, 2, w // 2, 2, -1).amax(dim=(2, 4)).view(-1, x.shape[1]),
    "probe_strided_row_slice": lambda x, stride=2: x[::stride].contiguous(),
    "probe_lane_slice_64": lambda x: x[:, 64:128].contiguous(),
    "probe_int32_acc_reshape": lambda x: x.view(
        x.shape[0] // 4, 4, -1).amax(dim=1),
}


def _probe_cases(torch, device):
    """(probe name, label, inputs) for each probe: JAX's inputs (ones, and
    the wrapped arange for the pool), then seeded random ones of the same
    shapes and dtypes (int8 over its full range, int32 over ±2^30), then
    random ones at ragged shapes."""
    from bnn_pynq_tpu_torch.ops import probes

    rng = np.random.default_rng(4)
    m, c = probes.M, probes.C
    dot = {"x": (m + 128, c), "w": (probes.K * c, probes.O)}
    shapes = {"probe_lane_concat": dot, "probe_scratch_lane_store": dot,
              "probe_lane_slice_64": {"x": (m, 256)}}
    # widths that are not multiples of 16 bytes take each kernel's scalar
    # path: (input shapes, options)
    rdot = ({"x": (40, 20), "w": (60, 13)}, {"m": 37})
    ragged = {"probe_lane_concat": rdot, "probe_scratch_lane_store": rdot,
              "probe_mid_dim_index": ({"x": (38, 20)}, {}),
              "probe_pool_reshape_max": ({"x": (120, 20)},
                                         {"bb": 2, "h": 6, "w": 10}),
              "probe_strided_row_slice": ({"x": (37, 20)}, {"stride": 3}),
              "probe_lane_slice_64": ({"x": (37, 136)}, {}),
              "probe_int32_acc_reshape": ({"x": (36, 6)}, {})}

    def ones(shape, dtype):
        return torch.ones(shape, dtype=dtype, device=device)

    def draw(shape, dtype):
        lo, hi = (-128, 128) if dtype == torch.int8 else (-2 ** 30, 2 ** 30)
        return torch.from_numpy(rng.integers(lo, hi, size=shape)).to(
            dtype).to(device)

    cases = []
    for fn in probes.PROBES:
        name = fn.__name__
        dtype = torch.int32 if name == "probe_int32_acc_reshape" \
            else torch.int8
        arg_shapes = shapes.get(name, {"x": (m, c)})
        jax_in = {k: ones(s, dtype) for k, s in arg_shapes.items()}
        if name == "probe_pool_reshape_max":
            jax_in = {"x": probes.pool_input(device=device)}
        cases.append((name, "JAX inputs", jax_in))
        cases.append((name, "random inputs",
                      {k: draw(s, dtype) for k, s in arg_shapes.items()}))
        r_shapes, opts = ragged[name]
        cases.append((name, "ragged inputs",
                      {**{k: draw(s, dtype) for k, s in r_shapes.items()},
                       **opts}))
    return cases


def _http(url, body=None):
    """(status, body bytes) of one request; non-200 answers too."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(urllib.request.Request(url, data=body),
                                    timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _npz(x):
    buf = io.BytesIO()
    np.savez(buf, x=x)
    return buf.getvalue()


def _probe_phase(torch, device, kind, results, launches):
    """Phase 14: each probe kernel against its plain version and, where one
    PyTorch call computes its function, against that call; then the probes'
    entry point on the card with every plain version counted."""
    from bnn_pynq_tpu_torch.ops import probes
    from bnn_pynq_tpu_torch.tools.layer_times import graph_ms
    from bnn_pynq_tpu_torch.tools import mosaic_probes as probe_tool
    for fn in probes.PROBES:
        results[fn.__name__] = _new_result()
    for name, label, inputs in _probe_cases(torch, device):
        kern = functools.partial(getattr(probes, name), **inputs)
        plain = functools.partial(getattr(probes, name + "_plain"), **inputs)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        assert got.shape == want.shape and got.dtype == want.dtype, label
        err = float((got.double() - want.double()).abs().max())
        assert torch.equal(got, want), f"{name} {label}: kernel != plain"
        library = None
        if name in PROBE_LIBRARY:
            library = functools.partial(PROBE_LIBRARY[name], **inputs)
            assert torch.equal(got, library()), \
                f"{name} {label}: kernel != the library call"
        ms, plain_ms = _time_ms(torch, kern), _time_ms(torch, plain)
        r = results[name]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        beside = ""
        if label == "JAX inputs":        # the entry point's inputs
            tensors = [v for v in inputs.values() if torch.is_tensor(v)]
            if "w" in inputs:            # a dot of shifted rows
                work = _work([(got.shape[0], inputs["w"].shape[0],
                               got.shape[1])], *tensors)
            else:                        # a copy or a max: one op an element
                work = _work([], *tensors, peak=PEAK_FP32,
                             ops=max(t.numel() for t in tensors))
            bound = _account(torch, device, r, work, got, ms, plain_ms)
            r["graph_ms"] = graph_ms(kern)
            beside = (f" (graph replay {r['graph_ms']:.5f} ms), bound "
                      f"{bound:.5f} ms")
            if library:
                r["library_ms"] = _time_ms(torch, library)
                r["library_graph_ms"] = graph_ms(library)
                beside += (f", library call {r['library_ms']:.4f} ms (graph "
                           f"replay {r['library_graph_ms']:.5f} ms)")
        print(f"{name} {label} {tuple(got.shape)}: max |kernel - plain| "
              f"{err:.3g}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
              f"{beside}")

    # the probes' path: their entry point on the card, no plain call
    probe_plain = []
    plain_fns = {fn.__name__: getattr(probes, fn.__name__ + "_plain")
                 for fn in probes.PROBES}
    for name, f in plain_fns.items():
        setattr(probes, name + "_plain",
                lambda *a, _f=f, **kw: probe_plain.append(1) or _f(*a, **kw))
    try:
        for fn in probes.PROBES:
            fn.launches.reset()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = probe_tool.main(["--device", "cuda"])
        torch.cuda.synchronize()
        launches.update({fn.__name__: fn.launches.value
                         for fn in probes.PROBES})
    finally:
        for name, f in plain_fns.items():
            setattr(probes, name + "_plain", f)
    lines = out.getvalue().splitlines()
    for line in lines:
        print(f"  mosaic_probes: {line}")
    assert rc == 0 and lines[0] == f"backend: {kind}", lines[:1]
    assert [l.split()[0] for l in lines[1:]] == ["PASS"] * 7, lines
    assert not probe_plain, "the probe tool ran a plain version"
    for fn in probes.PROBES:
        assert launches[fn.__name__] == 1, f"{fn.__name__} never launched"
    print(f"probe path: 7 PASS, launches "
          f"{ {fn.__name__: launches[fn.__name__] for fn in probes.PROBES} }"
          f", plain calls {len(probe_plain)}")


def _serving_entry_points(torch, images, counters):
    """Phase 15: the HTTP server, /reload, a Frontend over a 'mega' and a
    'direct' backend, `cli bench` and the upload stage, all on the card."""
    from bnn_pynq_tpu_torch import cli
    from bnn_pynq_tpu_torch.ops import conv_direct
    from bnn_pynq_tpu_torch.runtime import http_server
    from bnn_pynq_tpu_torch.runtime.frontend import (BackendHandle,
                                                     Frontend, HttpBackend)
    from bnn_pynq_tpu_torch.runtime.serving import BatchingServer

    servers = []
    backends = []
    fe = None
    try:
        for route in ("mega", "direct"):
            servers.append(http_server.serve(
                _artifact("cnv-w1a1"), device="cuda", route=route, port=0,
                block=False))
        (httpd, batcher), (httpd_d, _) = servers
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        eng = batcher.engine
        x = images[:128]
        want = eng.classify(x)
        for c in counters.values():
            c.reset()
        code, body = _http(url + "/classify", _npz(x))
        torch.cuda.synchronize()
        assert code == 200, (code, body[:200])
        got = json.loads(body)["classes"]
        assert got == want.tolist(), "HTTP /classify != engine.classify"
        http_launches = {k: c.value for k, c in counters.items()}
        assert all(n > 0 for n in http_launches.values()), http_launches
        assert _http(url + "/healthz") == (200, b"ok")
        code, body = _http(url + "/stats")
        stats = json.loads(body)
        assert code == 200 and stats["images"] >= 128, stats
        with open(_artifact("cnv-w1a1"), "rb") as f:
            code, body = _http(url + "/reload", f.read())
        assert code == 200 and json.loads(body) == \
            {"reloaded": "cnv-w1a1"}, (code, body)
        code, body = _http(url + "/classify", _npz(x))
        assert code == 200 and json.loads(body)["classes"] == got, \
            "answers changed after reloading the same artifact"
        with open(_artifact("lfc-w1a1"), "rb") as f:
            code, _ = _http(url + "/reload", f.read())
        assert code == 409, f"/reload lfc-w1a1 gave {code}, not 409"
        body = _npz(x)
        walls = []
        for _ in range(50):
            t0 = time.perf_counter()
            code, _ = _http(url + "/classify", body)
            walls.append((time.perf_counter() - t0) * 1e3)
            assert code == 200
        print(f"http: cnv-w1a1 POST /classify of 128 images == "
              f"engine.classify, launches {http_launches}; /healthz, "
              f"/stats, /reload 200 (same artifact), 409 (lfc-w1a1); round "
              f"trip p50 {np.percentile(walls, 50):.2f} ms, p99 "
              f"{np.percentile(walls, 99):.2f} ms (50 POSTs, host clock)")

        # a Frontend over the two HTTP backends, round robin
        for h, _ in servers:
            hb = HttpBackend(f"http://127.0.0.1:{h.server_address[1]}")
            backends.append(hb)
        fe = Frontend([BackendHandle(r, hb, probe=hb.probe)
                       for r, hb in zip(("mega", "direct"), backends)],
                      heartbeat_s=1.0)
        direct = conv_direct.conv2d_direct.launches
        direct.reset()
        futs = [fe.submit(images[i]) for i in range(64)]
        got = np.array([f.result(timeout=120) for f in futs])
        torch.cuda.synchronize()
        assert (got == want[:64]).all(), "Frontend answers != classify"
        assert direct.value > 0, "the direct backend ran no conv2d_direct"
        assert fe.healthy_backends() == ["mega", "direct"]
        print(f"frontend: 64 requests over a mega and a direct HTTP backend "
              f"== engine.classify (conv2d_direct launches {direct.value})")
    finally:
        if fe is not None:
            fe.stop()
        for hb in backends:
            hb.close()
        for h, b in servers:
            h.shutdown()
            h.server_close()
            b.stop()

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["bench", _artifact("cnv-w1a1"), "--batch", str(BATCH),
                  "--classify"])
    bench = json.loads(out.getvalue().splitlines()[-1])
    assert bench["path"] == "classify" and bench["images_per_sec"] > 0
    print(f"cli bench: {json.dumps(bench)}")

    server = _serve_68(BatchingServer, eng, eng.prepare(images[:128]),
                       "cnv-w1a1 upload stage", upload_pipeline=True)
    assert server.upload_pipeline, "the upload stage was off"


# Phase 16's tolerances (the precision of bnn_pynq_tpu_torch/train/trainer.py:
# float32 with TF32 off). A step on the card against the same step on the
# CPU, each from the same state: the losses within STEP_LOSS_RTOL; the
# batch statistics within STEP_STATS_TOL; each gradient within _grad_delta
# of the CPU's; the card's parameters within STEP_PARAM_ATOL of the CPU's
# trainer.Adam applied to the card's gradients (float32 rounding of Adam's
# arithmetic, whose updates here are at most ~0.03). The float model's
# argmax against the integer engine's on the 1024 test images: at most
# FLOAT_ENGINE_DIFFER images differ.
STEP_LOSS_RTOL = 1e-5
STEP_STATS_TOL = dict(rtol=1e-4, atol=1e-6)
STEP_PARAM_ATOL = 1e-6
FLOAT_ENGINE_DIFFER = 2


def _grad_delta(g):
    """How far a card gradient may lie from the CPU's: 1e-4 relative plus
    1e-4 of the layer's largest gradient. Against float64 on an H100
    (PERF.md §6) cuDNN's float32 weight gradients are off by up to 4.5e-5
    of the layer's largest (conv1), the CPU's by 3.8e-6; with TF32 on they
    are off by 4.2e-4 to 6.7e-4."""
    return 1e-4 * np.abs(g) + 1e-4 * np.abs(g).max()


def _card_vs_cpu(torch, cfg, ds):
    """Three train steps of CNV-W1A1 at batch 50 on the card and on the
    CPU, each from the same state (the card takes the CPU's after each).
    Both sides run trainer.Adam, which the CPU tests hold to optax; Adam
    turns a gradient of rounding noise into a full step, so the parameters
    are held through the gradients: each card gradient within _grad_delta
    of the CPU's, and the card's parameters within STEP_PARAM_ATOL of the
    CPU's Adam applied to the card's gradients. Returns the largest
    differences, each also as a share of its tolerance (`*_ratio`, within
    tolerance at <= 1), the leaf where that share was largest, and the
    parameters' raw difference from the CPU's step (`param`,
    `beyond_1e-6`)."""
    from bnn_pynq_tpu_torch.train import data as data_mod
    from bnn_pynq_tpu_torch.train import model as tmodel
    from bnn_pynq_tpu_torch.train import trainer

    class KeepGrads(trainer.Adam):
        """trainer.Adam that keeps its last gradients, on the CPU."""

        def update(self, grads):
            self.grads = [g.detach().cpu() for g in grads]
            super().update(grads)

    idx = np.random.default_rng(3).permutation(len(ds.x_train))[:150]
    x = torch.from_numpy(data_mod.train_inputs(
        cfg.dataset, ds.x_train[idx], cfg.input_kind))
    y = torch.from_numpy(ds.y_train[idx].astype(np.int64))
    start = tmodel.QuantNet(
        cfg, generator=torch.Generator().manual_seed(1)).variables()
    sides = {}
    for dev in ("cuda", "cpu", "check"):
        m = tmodel.QuantNet(cfg).to("cpu" if dev == "check" else dev)
        m.load_variables(start["params"], start["batch_stats"])
        tx = KeepGrads(m, 81, 1e-3, 1e-6)
        sides[dev] = (m, tx, trainer.make_train_step(cfg, m, tx))
    (mc, txc, step_c), (m0, tx0, step_0) = sides["cuda"], sides["cpu"]
    mk, txk, _ = sides["check"]
    names = [n for n, _ in m0.named_parameters()]
    worst = {"loss_rel": 0.0, "stats": 0.0, "stats_ratio": 0.0,
             "grad_ratio": 0.0, "grad_leaf": "", "adam": 0.0,
             "adam_ratio": 0.0, "param": 0.0, "beyond_1e-6": 0}

    def note(key, value, leaf_key=None, leaf=""):
        if value > worst[key]:
            worst[key] = value
            if leaf_key:
                worst[leaf_key] = leaf

    for s in range(3):
        xb, yb = x[50 * s:50 * (s + 1)], y[50 * s:50 * (s + 1)]
        lc = float(step_c(xb.cuda(), yb.cuda()))
        l0 = float(step_0(xb, yb))
        txk.update(txc.grads)
        note("loss_rel", abs(lc - l0) / abs(l0) if np.isfinite(lc)
             else np.inf)
        vc, v0, vk = mc.variables(), m0.variables(), mk.variables()
        for layer, leaves in v0["batch_stats"].items():
            for leaf, want in leaves.items():
                d = np.abs(vc["batch_stats"][layer][leaf] - want)
                note("stats", float(d.max()))
                note("stats_ratio", float((d / (
                    STEP_STATS_TOL["atol"] + STEP_STATS_TOL["rtol"]
                    * np.abs(want))).max()))
        for i, name in enumerate(names):
            _, layer, leaf = name.split(".")
            g = tx0.grads[i].double().numpy()
            gc = txc.grads[i].double().numpy()
            note("grad_ratio", float((np.abs(gc - g) / _grad_delta(g)).max()),
                 "grad_leaf", f"step {s} {layer}/{leaf}")
            got = vc["params"][layer][leaf]
            note("adam", float(np.abs(got - vk["params"][layer][leaf]).max()))
            d = np.abs(got - v0["params"][layer][leaf])
            note("param", float(d.max()))
            worst["beyond_1e-6"] += int((d > 1e-6).sum())
        # the next step starts from the CPU's state on every side
        for m, tx in ((mc, txc), (mk, txk)):
            m.load_variables(v0["params"], v0["batch_stats"])
            with torch.no_grad():
                for a, b in zip(tx.mu + tx.nu, tx0.mu + tx0.nu):
                    a.copy_(b)
    worst["adam_ratio"] = worst["adam"] / STEP_PARAM_ATOL
    return worst


def _serve_trained(torch, compiled, images, counters, want_kernels):
    """A freshly compiled artifact on `mega` with runtime="kernels" on the
    card: the wanted kernels launched (counted), no plain version called,
    logits equal runtime="ref" on the card, argmax equal. Returns the
    engine's classes and launches."""
    from bnn_pynq_tpu_torch.ops import conv_stack, fused_mlp
    from bnn_pynq_tpu_torch.runtime.engine import InferenceEngine

    eng = InferenceEngine(compiled, device="cuda", route="mega")
    want = InferenceEngine(compiled, device="cuda",
                           runtime="ref").logits(images)
    plain_calls = []
    saved = (conv_stack.conv_chain_plain, conv_stack.dense_block_plain,
             fused_mlp.fused_mlp_forward_plain)

    def counted(fn):
        return lambda *a, **kw: plain_calls.append(1) or fn(*a, **kw)

    (conv_stack.conv_chain_plain, conv_stack.dense_block_plain,
     fused_mlp.fused_mlp_forward_plain) = (counted(f) for f in saved)
    try:
        for c in counters.values():
            c.reset()
        got = eng.logits(images)
        pred = eng.classify(images)
        torch.cuda.synchronize()
        launches = {k: c.value for k, c in counters.items()}
    finally:
        (conv_stack.conv_chain_plain, conv_stack.dense_block_plain,
         fused_mlp.fused_mlp_forward_plain) = saved
    assert not plain_calls, "a trained artifact ran a plain version"
    for k in want_kernels:
        assert launches[k] > 0, f"the trained artifact never launched {k}"
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)
    assert (got.argmax(1) == want.argmax(1)).all() and \
        (pred == want.argmax(1)).all(), "argmax differs from ref"
    return pred, launches, float(np.abs(got - want).max())


def _float_predictions(torch, cfg, result, x_uint8):
    """The float model's classes on the card, from the trained params."""
    from bnn_pynq_tpu_torch.train import data as data_mod
    from bnn_pynq_tpu_torch.train import model as tmodel
    from bnn_pynq_tpu_torch.train import trainer

    model = tmodel.QuantNet(cfg).to("cuda")
    model.load_variables(result.params, result.batch_stats)
    logits_fn = trainer.make_eval_fn(cfg, model)
    x = torch.from_numpy(data_mod.train_inputs(
        cfg.dataset, x_uint8, cfg.input_kind)).cuda()
    return logits_fn(x).argmax(-1).cpu().numpy()


def _step_profile(torch, step, x, y, wall_ms, steps=10):
    """Device time of one train step by kernel (torch.profiler over
    `steps` steps), and its share of the step's wall time `wall_ms`."""
    import collections

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step(x, y)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step(x, y)
        torch.cuda.synchronize()
    by_name = collections.Counter()
    launches = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us() / 1e3 / steps
            launches += 1
    assert by_name, "the profiler's trace holds no device event"
    device_ms = sum(by_name.values())
    top = "; ".join(f"{ms:.4f} {name[:60]}"
                    for name, ms in by_name.most_common(5))
    print(f"train step profile ({steps} steps): device {device_ms:.4f} ms "
          f"per step in {launches / steps:g} launches, "
          f"{100 * device_ms / wall_ms:.1f} % of the {wall_ms:.3f} ms wall "
          f"step; top kernels (ms per step): {top}")


def _training_phase(torch, counters):
    """Phase 16: training on the card, and what it trained served by the
    kernels."""
    import tempfile

    from bnn_pynq_tpu_torch import cli
    from bnn_pynq_tpu_torch.compiler import compile_network
    from bnn_pynq_tpu_torch.models.config import get_config
    from bnn_pynq_tpu_torch.train import data as data_mod
    from bnn_pynq_tpu_torch.train import trainer

    cfg = get_config("cnv-w1a1")
    ds = data_mod.load(cfg.dataset)
    preset = trainer.preset_for(cfg)
    print(f"training precision: float32, TF32 off inside the trainer "
          f"(outside it cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32})")
    with tempfile.TemporaryDirectory() as tmp:
        # 16.1 one epoch of CNV-W1A1 at its published widths
        ckpt = os.path.join(tmp, "cnv-w1a1-checkpoint.npz")
        result = trainer.train(
            cfg, ds, epochs=1, batch_size=preset["batch_size"],
            lr_start=preset["lr_start"], lr_end=preset["lr_end"], seed=0,
            checkpoint_path=ckpt, device="cuda")
        model = result.model
        tensors = list(model.parameters()) + list(model.buffers())
        assert all(t.device.type == "cuda" for t in tensors), \
            "a parameter or buffer of the trained model is not on the card"
        hist = result.history[0]
        losses = np.asarray(hist["losses"])
        steps = len(losses)
        assert steps == len(ds.x_train) // preset["batch_size"], steps
        assert np.isfinite(losses).all(), "non-finite training loss"
        assert losses[-10:].mean() < losses[:10].mean(), \
            f"loss did not fall: {losses[:10].mean()} → {losses[-10:].mean()}"
        for layer, leaves in result.params.items():
            if layer.startswith("quant_"):
                assert np.abs(leaves["kernel"]).max() <= 1.0, layer
        bs = preset["batch_size"]
        print(f"train cnv-w1a1 on the card: 1 epoch, {steps} steps at batch "
              f"{bs}, loss {losses[:10].mean():.4f} (first 10 steps) → "
              f"{losses[-10:].mean():.4f} (last 10), val acc "
              f"{result.best_val_acc:.4f}; {hist['seconds']:.2f} s with "
              f"first-use set-up: {steps / hist['seconds']:.1f} steps/s, "
              f"{steps * bs / hist['seconds']:.1f} images/s (host clock)")
        x_dev = torch.from_numpy(data_mod.train_inputs(
            cfg.dataset, ds.x_train, cfg.input_kind)).cuda()
        y_dev = torch.from_numpy(ds.y_train.astype(np.int64)).cuda()
        tx = trainer.Adam(model, steps, preset["lr_start"], preset["lr_end"])
        epoch = trainer.make_epoch_fn(cfg, model, tx, steps, bs)
        gen = torch.Generator(device="cuda").manual_seed(7)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timed = epoch(x_dev, y_dev, gen).cpu().numpy()
        dt = time.perf_counter() - t0
        assert np.isfinite(timed).all()
        print(f"train cnv-w1a1 on the card, a second epoch timed alone: "
              f"{dt:.3f} s, {steps / dt:.1f} steps/s, "
              f"{steps * bs / dt:.1f} images/s (host clock, ends in the "
              f"loss fetch)")
        _step_profile(torch, trainer.make_train_step(cfg, model, tx),
                      x_dev[:bs], y_dev[:bs], dt / steps * 1e3)
        del x_dev, y_dev, tx, epoch

        # 16.2 the same steps on the card and on the CPU
        worst = _card_vs_cpu(torch, cfg, ds)
        print(f"card vs CPU, 3 steps of cnv-w1a1 at batch 50 from the same "
              f"state: largest differences {json.dumps(worst)}")
        assert worst["loss_rel"] <= STEP_LOSS_RTOL, worst
        for key in ("stats_ratio", "grad_ratio", "adam_ratio"):
            assert worst[key] <= 1.0, (key, worst)

        # 16.3 serve what was trained
        params, stats, meta = trainer.load_checkpoint(ckpt)
        for kind, got, want in (("params", params, result.params),
                                ("batch_stats", stats, result.batch_stats)):
            for layer, leaves in want.items():
                for leaf, arr in leaves.items():
                    assert np.array_equal(got[layer][leaf], arr), \
                        f"checkpoint {kind}/{layer}/{leaf}"
        assert str(meta["config"]) == cfg.name
        compiled = compile_network(cfg, params, stats)
        pred, launches, err = _serve_trained(
            torch, compiled, ds.x_test, counters,
            ("conv_chain", "dense_block", "fused_mlp"))
        fpred = _float_predictions(torch, cfg, result, ds.x_test)
        differ = int((fpred != pred).sum())
        facc = float((fpred == ds.y_test).mean())
        eacc = float((pred == ds.y_test).mean())
        print(f"trained cnv-w1a1 served on mega (kernels, the card): "
              f"launches {launches}, no plain call, logits == ref (max "
              f"|diff| {err:.3g}), argmax equal; accuracy on the "
              f"{len(pred)} test images: float model {facc:.4f}, engine "
              f"{eacc:.4f}, argmax differs on {differ}")
        assert differ <= FLOAT_ENGINE_DIFFER, \
            f"float model and engine differ on {differ} images"

        # 16.4 the 2-bit quantizer on both sides
        for name, want_kernels in (("lfc-w1a2", ("fused_mlp",)),
                                   ("cnv-w2a2", ("conv_chain", "dense_block",
                                                 "fused_mlp"))):
            c2 = get_config(name)
            d2 = data_mod.load(c2.dataset)
            p2 = trainer.preset_for(c2)
            r2 = trainer.train(c2, d2, epochs=1, batch_size=p2["batch_size"],
                               lr_start=p2["lr_start"], lr_end=p2["lr_end"],
                               max_train=10 * p2["batch_size"], device="cuda")
            assert len(r2.history[0]["losses"]) == 10
            assert np.isfinite(r2.history[0]["losses"]).all()
            pred2, launches2, err2 = _serve_trained(
                torch, compile_network(c2, r2.params, r2.batch_stats),
                d2.x_test, counters, want_kernels)
            differ2 = int((_float_predictions(torch, c2, r2, d2.x_test)
                           != pred2).sum())
            print(f"trained {name} (10 steps) served on mega: launches "
                  f"{launches2}, no plain call, logits == ref (max |diff| "
                  f"{err2:.3g}), argmax equal; float model and engine "
                  f"argmax differ on {differ2} of {len(pred2)}")
            assert differ2 <= FLOAT_ENGINE_DIFFER, \
                f"{name}: float model and engine differ on {differ2} images"

        # 16.5 the CLI end to end on the card
        out_dir = os.path.join(tmp, "cli")
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            cli.main(["train", "cnv-w1a1", "--epochs", "1", "--device",
                      "cuda", "--out", out_dir])
            cli.main(["compile", os.path.join(out_dir,
                                              "cnv-w1a1-checkpoint.npz"),
                      "--out", os.path.join(out_dir, "compiled.npz")])
            cli.main(["eval", os.path.join(out_dir, "compiled.npz"),
                      "--device", "cuda"])
        lines = log.getvalue().splitlines()
        assert any(line.startswith("artifact: ") for line in lines)
        ev = json.loads(lines[-1])
        assert ev["network"] == "cnv-w1a1" and ev["n_test"] == len(ds.x_test)
        print(f"cli train → compile → eval on the card: "
              f"{lines[0]}; {json.dumps(ev)}")


# -- phase 17: tensor-parallel inference ------------------------------------

# what the ranks of phase 17 may take: a world past it fails the run
PARALLEL_DEADLINE_S = 300


def _shard_shape_cases(torch, device):
    """Phase 17.0: packed_matmul, conv2d_direct (int32 out) and conv_chain
    (one layer on the raw image) against their plain versions at the shard
    shapes the parallel engines give them, widths no earlier phase held:
    output shards N/m of CNV at m = 2, 4, 8 and of the mini nets
    (tests/test_finnthesizer.py) at m = 2, 4, 8; input-channel shards Cs =
    2-128 on the ring's conv2d_direct. Exact, or the phase raises."""
    from bnn_pynq_tpu_torch.models.params import weight_matrix
    from bnn_pynq_tpu_torch.ops import conv_direct, conv_stack, matmul
    from bnn_pynq_tpu_torch.ops.packing import pack_bits, pack_codes2

    rng = np.random.default_rng(17)
    n_cases = 0

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def thr_for(k, n, nthr):
        return dev(np.sort(rng.integers(-k // 3, k // 3 + 1,
                                        size=(nthr, n)), axis=0)
                   .astype(np.int32))

    # packed_matmul: (K, N/m) of CNV-W1A1 m=2 (conv1 64->32 ... dense 256)
    # and the shards at m=4, 8 and of the mini nets
    for k, n in ((576, 32), (576, 64), (1152, 64), (1152, 128), (2304, 128),
                 (256, 256), (512, 256), (576, 16), (1152, 32), (576, 8),
                 (144, 16), (144, 8), (144, 4), (128, 12), (128, 6),
                 (24, 3), (16, 2), (784, 512), (1024, 256), (1024, 128)):
        for bits, route in ((1, "vpu"), (1, "mxu"), (2, "mxu")):
            vals = rng.integers(0, 2 if bits == 1 else 4, size=(1000, k))
            wv = rng.integers(0, 2 if bits == 1 else 4, size=(k, n))
            pack = pack_bits if bits == 1 else pack_codes2
            a = pack(dev(vals.astype(np.int8)), axis=-1)
            w = pack(dev(wv.astype(np.int8)), axis=0).contiguous()
            thr = thr_for(k, n, 1 if bits == 1 else 3)
            for t in (thr, None):
                got = matmul.packed_matmul(a, w, t, k=k, bits=bits,
                                           route=route)
                want = matmul.packed_matmul_plain(a, w, t, k=k, bits=bits,
                                                  route=route)
                assert torch.equal(got, want), \
                    f"packed_matmul {route} K={k} N={n} shard != plain"
                n_cases += 1

    # conv2d_direct, int32 epilogue, on C-shards (the ring's step) and
    # thresholded on whole C (the blocking arm); (H, Cs, N/m)
    for hw, cs, n, abits in ((30, 32, 32, 1), (14, 32, 64, 1),
                             (12, 64, 64, 1), (5, 64, 128, 1),
                             (3, 128, 128, 1), (28, 16, 16, 1),
                             (12, 32, 32, 1), (8, 8, 16, 1), (4, 4, 8, 1),
                             (4, 2, 4, 1), (4, 8, 16, 2), (4, 2, 4, 2),
                             (12, 32, 64, 2)):
        x = dev(rng.integers(0, 2 ** abits, size=(16, hw, hw, cs))
                .astype(np.int8))
        levels = rng.choice([-1, 1], size=(9 * cs, n)).astype(np.int8)
        w = weight_matrix(dev(levels))
        for t in (None, thr_for(9 * cs, n, 2 ** abits - 1)):
            got = conv_direct.conv2d_direct(x, w, t, kernel=3, abits=abits)
            want = conv_direct.conv2d_direct_plain(x, w, t, kernel=3,
                                                   abits=abits)
            assert torch.equal(got, want), \
                f"conv2d_direct H={hw} Cs={cs} N={n} shard != plain"
            n_cases += 1

    # conv_chain, one layer on the raw image, the first conv's column shard
    for shape, n, abits in (((16, 32, 32, 3), 32, 1), ((16, 32, 32, 3), 16, 1),
                            ((16, 32, 32, 3), 8, 2), ((8, 10, 10, 3), 8, 1),
                            ((8, 10, 10, 3), 4, 1), ((8, 10, 10, 3), 2, 2)):
        x = dev(rng.integers(-128, 128, size=shape).astype(np.int8))
        w = weight_matrix(dev(rng.choice([-1, 1], size=(27, n))
                              .astype(np.int8)))
        t = thr_for(27 * 128, n, 2 ** abits - 1)
        got = conv_stack.conv_chain(x, [w], [t], kernel=3, abits=abits,
                                    input_levels=True)
        want = conv_stack.conv_chain_plain(x, [w], [t], kernel=3,
                                           abits=abits, input_levels=True)
        assert torch.equal(got, want), \
            f"conv_chain first layer N={n} shard != plain"
        n_cases += 1
    return n_cases


def _path_row_cases(torch, device):
    """Phase 17.0, second part: the same kernels at the row counts the
    path of phase 17b gives them (batch 1024 on mesh (1, 2), 512 a rank on
    (2, 1)), whose launchers pick their plans by M: every packed_matmul of
    TPInferenceEngine 'vpu' on CNV-W1A1 and LFC-W1A1 (the epilogue the
    layer has), and on CNV-W1A1 OverlapTPEngine's first conv (conv_chain)
    and its conv2d_direct calls, the ring's int32 step on a C-shard and
    the thresholded call on whole C. Seeded inputs on the card; exact, or
    the phase raises."""
    from bnn_pynq_tpu_torch.compiler.artifacts import load_artifact
    from bnn_pynq_tpu_torch.models.network import make_plan
    from bnn_pynq_tpu_torch.models.params import weight_matrix
    from bnn_pynq_tpu_torch.ops import conv_direct, conv_stack, matmul
    from bnn_pynq_tpu_torch.ops.packing import pack_bits

    gen = torch.Generator(device=device).manual_seed(171)
    done = set()

    def rand(shape, lo, hi, dtype=torch.int8):
        return torch.randint(lo, hi, shape, generator=gen, device=device,
                             dtype=dtype)

    def thr_for(n, sd):
        return rand((1, n), -sd, sd + 1, torch.int32)

    def check(key, got_fn, want_fn):
        if key in done:
            return
        done.add(key)
        assert torch.equal(got_fn(), want_fn()), f"{key} != plain"

    for name, meshes in (("cnv-w1a1", ((1, 2), (2, 1))),
                         ("lfc-w1a1", ((1, 2),))):
        config = load_artifact(_artifact(name)).config
        for data, model in meshes:
            b = BATCH // data
            h, w, _ = config.input_shape
            for lp in make_plan(config):
                if lp.kind == "pool":
                    h, w = h // lp.window, w // lp.window
                    continue
                n = lp.n if lp.last else lp.n // model
                levels = rand((lp.k, n), 0, 2) * 2 - 1
                thr = None if lp.last else thr_for(n, int(lp.k ** .5))
                if lp.kind == "conv_int8":      # OverlapTPEngine's conv 0
                    x = rand((b, h, w, lp.k // lp.kernel ** 2), -128, 128)
                    wm, thr0 = weight_matrix(levels), [thr_for(n, 74 * 6)]
                    check(("conv_chain", tuple(x.shape), n),
                          lambda: conv_stack.conv_chain(
                              x, [wm], thr0, kernel=lp.kernel, abits=1,
                              input_levels=True),
                          lambda: conv_stack.conv_chain_plain(
                              x, [wm], thr0, kernel=lp.kernel, abits=1,
                              input_levels=True))
                elif lp.kind == "conv":
                    c = lp.k // lp.kernel ** 2
                    ring = [(c // model, None)] if model > 1 else []
                    for cs, t in ring + [(c, thr)]:
                        x = rand((b, h, w, cs), 0, 2)
                        wm = weight_matrix(levels[:lp.kernel ** 2 * cs])
                        check(("conv2d_direct", tuple(x.shape), n, t is None),
                              lambda: conv_direct.conv2d_direct(
                                  x, wm, t, kernel=lp.kernel, abits=1),
                              lambda: conv_direct.conv2d_direct_plain(
                                  x, wm, t, kernel=lp.kernel, abits=1))
                if lp.kind != "conv_int8":      # TPInferenceEngine 'vpu'
                    h2 = (h - lp.kernel) // lp.stride + 1 if lp.kernel else 1
                    w2 = (w - lp.kernel) // lp.stride + 1 if lp.kernel else 1
                    a = pack_bits(rand((b * h2 * w2, lp.k), 0, 2), axis=-1)
                    wp = pack_bits(levels.clamp(min=0), axis=0).contiguous()
                    check(("packed_matmul", a.shape[0], lp.k, n, thr is None),
                          lambda: matmul.packed_matmul(
                              a, wp, thr, k=lp.k, bits=1, route="vpu"),
                          lambda: matmul.packed_matmul_plain(
                              a, wp, thr, k=lp.k, bits=1, route="vpu"))
                if lp.kernel:
                    h = (h - lp.kernel) // lp.stride + 1
                    w = (w - lp.kernel) // lp.stride + 1
    return len(done)


def _count_plain():
    """In a rank: count every call of the path's plain versions (a CUDA
    tensor must never reach one)."""
    from bnn_pynq_tpu_torch.ops import conv_direct, conv_stack, matmul
    calls = []
    for mod, name in ((matmul, "packed_matmul_plain"),
                      (conv_direct, "conv2d_direct_plain"),
                      (conv_stack, "conv_chain_plain")):
        fn = getattr(mod, name)
        setattr(mod, name, lambda *a, _fn=fn, _name=name, **kw:
                calls.append(_name) or _fn(*a, **kw))
    return calls


def _path_launches():
    from bnn_pynq_tpu_torch.ops import conv_direct, conv_stack, matmul
    out = {f"packed_matmul[{r}]": c.value
           for r, c in matmul.packed_matmul.launches.items()}
    out["conv_chain"] = conv_stack.conv_chain.launches.value
    out["conv2d_direct"] = conv_direct.conv2d_direct.launches.value
    return out


def _reset_path_launches():
    from bnn_pynq_tpu_torch.ops import conv_direct, conv_stack, matmul
    for c in matmul.packed_matmul.launches.values():
        c.reset()
    conv_stack.conv_chain.launches.reset()
    conv_direct.conv2d_direct.launches.reset()


def _held(torch, label, eng, x, want_logits, want_cls):
    """Classify x (uint8) on a parallel engine with the launches and the
    collectives counted around it, then logits; both against the
    single-card engine's. Returns the row of this configuration."""
    from bnn_pynq_tpu_torch.parallel import comm
    from bnn_pynq_tpu_torch.parallel.overlap import elapsed_s
    _reset_path_launches()
    comm.reset_counts()
    got_cls = eng.classify(x, prepared=False)
    torch.cuda.synchronize()
    launches = {k: v for k, v in _path_launches().items() if v}
    counts = {k: v for k, v in comm.counts().items() if v}
    got = eng.logits(x, prepared=False)
    assert np.array_equal(got_cls, want_cls), f"{label}: classes differ"
    np.testing.assert_allclose(got, want_logits, **TOL, err_msg=label)
    xd = eng.upload(eng._pad_to_bucket(eng.prepare(x))[0])
    eng.launch_prepared(xd)
    ms = elapsed_s(lambda: eng.launch_prepared(xd), 3, eng.device) * 1e3
    return {"label": label, "launches": launches, "collectives": counts,
            "max_abs_err": float(np.abs(got - want_logits).max()),
            "ms": ms}


def _parallel_one_rank(images):
    """Phase 17a, in a world of one rank on NCCL: mesh (1, 1), every
    engine at the published widths of CNV-W1A1 against the single-card
    engine on the same route."""
    import torch
    from bnn_pynq_tpu_torch.compiler.artifacts import load_artifact
    from bnn_pynq_tpu_torch.parallel import make_mesh
    from bnn_pynq_tpu_torch.parallel.overlap import OverlapTPEngine
    from bnn_pynq_tpu_torch.parallel.tp import TPInferenceEngine
    from bnn_pynq_tpu_torch.runtime.engine import InferenceEngine

    plain = _count_plain()
    mesh = make_mesh(data=1, model=1)
    assert mesh.backend == "nccl" and mesh.device.type == "cuda"
    compiled = load_artifact(_artifact("cnv-w1a1"))
    rows = []
    for route in ("vpu", "mxu"):
        single = InferenceEngine(compiled, device="cuda", route=route)
        row = _held(torch, f"cnv-w1a1 TPInferenceEngine {route} (1,1)",
                    TPInferenceEngine(compiled, mesh, route=route), images,
                    single.logits(images), single.classify(images))
        assert row["launches"] == {f"packed_matmul[{route}]": 8}, row
        rows.append(row)
    mega = InferenceEngine(compiled, device="cuda")
    want = mega.logits(images), mega.classify(images)
    for arm in ("ring", "blocking", "auto"):
        eng = OverlapTPEngine(compiled, mesh, arm=arm)
        row = _held(torch, f"cnv-w1a1 OverlapTPEngine {eng.arm} (1,1)"
                    + (" auto" if arm == "auto" else ""), eng, images, *want)
        assert row["launches"] == {"conv_chain": 1, "conv2d_direct": 5}, row
        if arm == "auto":
            row["arm_reason"] = eng.arm_reason
        rows.append(row)
    assert not plain, f"plain versions called: {sorted(set(plain))}"
    return {"rows": rows, "backend": mesh.backend, "device": str(mesh.device)}


def _parallel_two_ranks(images, mnist):
    """Phase 17b, in a world of two ranks sharing one card over gloo:
    meshes (1, 2) and (2, 1), both engines, both arms and 'auto', against
    the single-card engine; then a BatchingServer on rank 0 with rank 1
    following, and a hot swap mid-serve."""
    import torch
    from bnn_pynq_tpu_torch.compiler.artifacts import load_artifact
    from bnn_pynq_tpu_torch.parallel import make_mesh
    from bnn_pynq_tpu_torch.parallel.overlap import OverlapTPEngine
    from bnn_pynq_tpu_torch.parallel.tp import TPInferenceEngine
    from bnn_pynq_tpu_torch.runtime.engine import InferenceEngine

    plain = _count_plain()
    mesh12 = make_mesh(data=1, model=2)
    mesh21 = make_mesh(data=2, model=1)
    assert mesh12.backend == "gloo" and mesh12.device == torch.device(
        "cuda", 0)
    rows = []
    for name, x in (("cnv-w1a1", images), ("lfc-w1a1", mnist)):
        compiled = load_artifact(_artifact(name))
        single = InferenceEngine(compiled, device="cuda")
        want = single.logits(x), single.classify(x)
        for shape, mesh in (("(1,2)", mesh12), ("(2,1)", mesh21)):
            if name == "lfc-w1a1" and shape == "(2,1)":
                continue
            engines = [("TPInferenceEngine vpu",
                        TPInferenceEngine(compiled, mesh, route="vpu"))]
            engines += [(f"OverlapTPEngine {arm}",
                         OverlapTPEngine(compiled, mesh, arm=arm))
                        for arm in (("ring", "blocking", "auto")
                                    if shape == "(1,2)" else ("ring",))]
            for label, eng in engines:
                row = _held(torch, f"{name} {label} {shape}", eng, x, *want)
                if label.startswith("TP"):
                    assert row["launches"] == {"packed_matmul[vpu]": 8
                                               if name == "cnv-w1a1" else 4}
                elif name == "cnv-w1a1":
                    m = mesh.shape["model"]
                    steps = m if getattr(eng, "arm", "") == "ring" else 1
                    assert row["launches"] == {
                        "conv_chain": 1, "conv2d_direct": 5 * steps}, row
                if label.endswith("auto"):
                    row["arm"], row["arm_reason"] = eng.arm, eng.arm_reason
                rows.append(row)
    served = _serve_following(mesh12, images)
    assert not plain, f"plain versions called: {sorted(set(plain))}"
    return {"rows": rows, "served": served, "backend": mesh12.backend,
            "device": str(mesh12.device)}


def _parallel_spread(images):
    """--spread, in each rank of a gloo world of two ranks a card over
    every card: the rank's current device is its mesh device, and both
    engines on mesh (2, cards) equal the single-card engine there."""
    import torch
    from bnn_pynq_tpu_torch.compiler.artifacts import load_artifact
    from bnn_pynq_tpu_torch.parallel import make_mesh
    from bnn_pynq_tpu_torch.parallel.overlap import OverlapTPEngine
    from bnn_pynq_tpu_torch.parallel.tp import TPInferenceEngine
    from bnn_pynq_tpu_torch.runtime.engine import InferenceEngine

    plain = _count_plain()
    mesh = make_mesh(data=2)
    assert mesh.backend == "gloo", mesh.backend
    current = torch.cuda.current_device()
    assert current == mesh.device.index, \
        f"current device cuda:{current}, mesh device {mesh.device}"
    compiled = load_artifact(_artifact("cnv-w1a1"))
    single = InferenceEngine(compiled, device=mesh.device)
    want = single.logits(images), single.classify(images)
    shape = f"({mesh.shape['data']},{mesh.shape['model']})"
    rows = [_held(torch, f"cnv-w1a1 {label} {shape}", eng, images, *want)
            for label, eng in (
                ("TPInferenceEngine vpu",
                 TPInferenceEngine(compiled, mesh, route="vpu")),
                ("OverlapTPEngine ring", OverlapTPEngine(compiled, mesh)),
                ("OverlapTPEngine blocking",
                 OverlapTPEngine(compiled, mesh, arm="blocking")))]
    assert not plain, f"plain versions called: {sorted(set(plain))}"
    return {"rows": rows, "device": str(mesh.device)}


def _spread_phase(torch, smi):
    """--spread: the world of `_parallel_spread` over every card."""
    from bnn_pynq_tpu_torch.parallel.launch import run_world
    cards = torch.cuda.device_count()
    if cards < 2:
        raise RuntimeError(f"--spread needs two cards or more, have {cards}")
    images = np.random.default_rng(1).integers(
        0, 256, size=(BATCH, 32, 32, 3), dtype=np.uint8)
    t0 = time.perf_counter()
    res = run_world(_parallel_spread, 2 * cards, args=(images,),
                    device="cuda", timeout=PARALLEL_DEADLINE_S)
    devices = [r["device"] for r in res]
    assert devices == [f"cuda:{r % cards}" for r in range(2 * cards)], devices
    print(f"parallel spread: a gloo world of {2 * cards} ranks over "
          f"{cards} cards (two a card) in {time.perf_counter() - t0:.1f} s; "
          f"rank devices {devices}")
    for rank, out in enumerate(res):
        for row in out["rows"]:
            print(f"  [rank {rank}, {out['device']}] {row['label']}: logits "
                  f"== single-card engine (max |diff| "
                  f"{row['max_abs_err']:.3g}), classes equal; launches per "
                  f"classify {row['launches']}; collectives "
                  f"{row['collectives']}; {row['ms']:.3f} ms per forward at "
                  f"batch {BATCH} ({smi}; ranks share cards and gloo goes "
                  f"through the host: no scaling figure)")


def _serve_following(mesh, images):
    """68 requests (64 single, 4 of 16) through a BatchingServer on the
    driving rank over an OverlapTPEngine (ring), the other rank following;
    the parameters are swapped live between the singles and the groups."""
    from bnn_pynq_tpu_torch.compiler.artifacts import (CompiledNetwork,
                                                       load_artifact)
    from bnn_pynq_tpu_torch.models.network import init_random_params
    from bnn_pynq_tpu_torch.parallel.overlap import OverlapTPEngine
    from bnn_pynq_tpu_torch.runtime.engine import InferenceEngine
    from bnn_pynq_tpu_torch.runtime.serving import BatchingServer

    ca = load_artifact(_artifact("cnv-w1a1"))
    cb = CompiledNetwork(ca.config, init_random_params(ca.config, seed=99),
                         np.ones(10, np.float32), np.zeros(10, np.float32))
    eng = OverlapTPEngine(ca, mesh)
    if not eng.is_leader:
        eng.follow()
        return {"followed_to_version": eng.version}
    prepared = eng.prepare(images[:128])
    want_a = InferenceEngine(ca, device="cuda").classify(prepared,
                                                          prepared=True)
    want_b = InferenceEngine(cb, device="cuda").classify(prepared,
                                                          prepared=True)
    eng.lead()
    server = BatchingServer(eng, max_batch=256, max_wait_ms=2.0)
    t0 = time.perf_counter()
    try:
        singles = [server.submit(prepared[i]) for i in range(64)]
        got_single = np.array([f.result(timeout=120) for f in singles])
        eng.load_parameters(cb)                 # live hot swap
        groups = [server.submit_many(prepared[64 + 16 * j:80 + 16 * j])
                  for j in range(4)]
        got_many = np.concatenate([f.result(timeout=120) for f in groups])
    finally:
        server.stop()
        eng.close()
    wall = time.perf_counter() - t0
    assert (got_single == want_a[:64]).all(), "served answers before the swap"
    assert (got_many == want_b[64:]).all(), "served answers after the swap"
    return {"requests": 68, "version": eng.version, "wall_s": wall,
            "pipeline_depth": server.pipeline_depth,
            "stats": server.stats.summary()}


def _parallel_phase(torch, smi):
    """Phase 17: tensor-parallel inference (bnn_pynq_tpu_torch/parallel/)
    on the card."""
    from bnn_pynq_tpu_torch.parallel.launch import run_world
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    n = _shard_shape_cases(torch, device)
    n_rows = _path_row_cases(torch, device)
    torch.cuda.synchronize()
    print(f"parallel: {n} shard-shape cases and {n_rows} cases at the path's "
          f"row counts of packed_matmul, conv2d_direct and conv_chain equal "
          f"their plain versions ({time.perf_counter() - t0:.1f} s)")
    rng = np.random.default_rng(1)          # phase 4's draws
    images = rng.integers(0, 256, size=(BATCH, 32, 32, 3), dtype=np.uint8)
    mnist = rng.integers(0, 256, size=(BATCH, 28, 28), dtype=np.uint8)
    t0 = time.perf_counter()
    one = run_world(_parallel_one_rank, 1, args=(images,), device="cuda",
                    timeout=PARALLEL_DEADLINE_S)[0]
    t1 = time.perf_counter()
    two = run_world(_parallel_two_ranks, 2, args=(images, mnist),
                    device="cuda", timeout=PARALLEL_DEADLINE_S)
    assert two[0]["backend"] == "gloo", "two ranks on one card: gloo"
    t2 = time.perf_counter()
    print(f"parallel: a world of 1 rank ({one['backend']}, "
          f"{one['device']}) in {t1 - t0:.1f} s and a world of 2 ranks "
          f"({two[0]['backend']}, both on {two[0]['device']}) in "
          f"{t2 - t1:.1f} s, spawn and kernel load included")
    print(f"parallel: the 2 ranks share one card ({smi}) and gloo moves "
          f"every collective's CUDA tensor through the host "
          f"(comm.host_copies): the times below are of this arrangement, "
          f"no scaling or interconnect figure")
    for rank, res in enumerate([one] + two):
        world = "1-rank nccl" if rank == 0 else f"2-rank gloo, rank {rank - 1}"
        for row in res["rows"]:
            extra = f"; arm {row['arm']}: {row['arm_reason']}" \
                if "arm" in row else (f"; {row['arm_reason']}"
                                      if "arm_reason" in row else "")
            print(f"  [{world}] {row['label']}: logits == single-card "
                  f"engine (max |diff| {row['max_abs_err']:.3g}), classes "
                  f"equal; launches per classify {row['launches']}; "
                  f"collectives {row['collectives']}; {row['ms']:.3f} ms "
                  f"per forward at batch {BATCH} ({smi}){extra}")
    served, follower = two[0]["served"], two[1]["served"]
    assert follower["followed_to_version"] == served["version"] == 1
    print(f"parallel serving: a BatchingServer on rank 0 over "
          f"OverlapTPEngine ring (1,2) answered {served['requests']} "
          f"requests (pipeline depth {served['pipeline_depth']}) in "
          f"{served['wall_s']:.2f} s, the parameters swapped live after 64 "
          f"of them, every answer equal to the single-card engine of its "
          f"parameters; rank 1 followed to version "
          f"{follower['followed_to_version']}; stats "
          f"{json.dumps(served['stats'])}")


def main(argv=None) -> int:
    import argparse
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spread", action="store_true",
                    help="only the gloo world over every card (2+ cards)")
    spread = ap.parse_args(argv).spread

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from bnn_pynq_tpu_torch.ops import (_build, conv_direct, conv_stack,
                                        fused_mlp, matmul)
    from bnn_pynq_tpu_torch.runtime.engine import InferenceEngine
    from bnn_pynq_tpu_torch.runtime.serving import BatchingServer
    from bnn_pynq_tpu_torch.tools.layer_times import graph_ms

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    device = torch.device("cuda", 0)
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"device {kind}, count {torch.cuda.device_count()}")
    if spread:
        _spread_phase(torch, smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0

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
    results = {k: _new_result() for k in counters}
    chain_ms = {}                 # conv_chain's time per case label
    for kname, label, kern, plain, kind_out, work in \
            _kernel_cases(torch, device):
        got, want = kern(), plain()
        torch.cuda.synchronize()
        assert got.shape == want.shape and got.dtype == want.dtype, label
        err = float((got.double() - want.double()).abs().max())
        if kind_out == "codes":
            assert torch.equal(got, want), f"{label}: codes differ"
        else:
            torch.testing.assert_close(got, want, **TOL)
        ms, plain_ms = _time_ms(torch, kern), _time_ms(torch, plain)
        r = results[kname]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        beside = ""
        if label.startswith("cnv-w1a1"):    # main-path time per forward
            bound = _account(torch, device, r, work, got, ms, plain_ms)
            replay_ms = graph_ms(kern)
            r["graph_ms"] = (r["graph_ms"] or 0.0) + replay_ms
            beside = f" (graph replay {replay_ms:.4f} ms), bound {bound:.4f} ms"
        elif work:      # another net's whole MLP: on no row, with its bound
            ops_ms, bytes_ms = _bounds(work, got)
            beside = (f" (graph replay {graph_ms(kern):.4f} ms), bound "
                      f"{max(ops_ms, bytes_ms):.5f} ms "
                      f"({'operations' if ops_ms >= bytes_ms else 'bytes'})")
        print(f"{kname:11s} {label}: max |kernel - plain| {err:.3g}; "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms{beside}")
        if kname == "conv_chain":
            chain_ms[label] = ms

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

    # -- 6. serving -----------------------------------------------------------
    _serve_68(BatchingServer, eng, eng.prepare(images[:128]), "cnv-w1a1")

    # -- 7. packed_matmul against its plain version ---------------------------
    packed = _new_result()            # 'vpu', the kernel's row
    packed_mxu = _new_result()        # the decode arm at the same layers
    vpu_bound_int8 = 0.0              # 'vpu' held to the int8 rate, as before
    for label, route, kern, plain, work, total in \
            _packed_cases(torch, device):
        got, want = kern(), plain()
        torch.cuda.synchronize()
        assert got.shape == want.shape and got.dtype == want.dtype, label
        err = float((got.double() - want.double()).abs().max())
        assert torch.equal(got, want), f"{label}: kernel != plain"
        packed["max_abs_err"] = max(packed["max_abs_err"], err)
        beside = ""
        if label.startswith("odd:"):      # checked, not timed
            print(f"packed_matmul {label}: max |kernel - plain| {err:.3g}")
            continue
        ms, plain_ms = _time_ms(torch, kern), _time_ms(torch, plain)
        if total:                 # cnv-w1a1 'vpu' / 'mxu': time per forward
            r = packed if total == "vpu" else packed_mxu
            bound = _account(torch, device, r, work, got, ms, plain_ms)
            if total == "vpu":
                vpu_bound_int8 += max(work["ops"] / PEAK_INT8 * 1e3, bound)
            replay_ms = graph_ms(kern)
            r["graph_ms"] = (r["graph_ms"] or 0.0) + replay_ms
            beside = f" (graph replay {replay_ms:.4f} ms), bound {bound:.4f} ms"
        elif label.startswith("small:"):  # an event reading is the enqueue
            beside = f" (graph replay {graph_ms(kern):.4f} ms)"
        print(f"packed_matmul {label}: max |kernel - plain| {err:.3g}; "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms{beside}")
    print(f"packed_matmul decode arm, cnv-w1a1 'mxu', the 8 layers: kernel "
          f"{packed_mxu['ms']:.4f} ms (graph replay "
          f"{packed_mxu['graph_ms']:.4f} ms), bound "
          f"{packed_mxu['bound_ms']:.5f} ms, plain "
          f"{packed_mxu['plain_ms']:.4f} ms; popcount arm 'vpu': kernel "
          f"{packed['ms']:.4f} ms (graph replay {packed['graph_ms']:.4f} ms), "
          f"bound {packed['bound_ms']:.5f} ms (operations at the 1-bit rate "
          f"{packed['ops_ms']:.5f}, bytes {packed['bytes_ms']:.5f}; "
          f"{vpu_bound_int8:.5f} with the operations at the int8 rate)")

    # -- 8. the packed routes -------------------------------------------------
    arms = matmul.packed_matmul.launches
    plain_calls = []
    plain_fn = matmul.packed_matmul_plain
    matmul.packed_matmul_plain = \
        lambda *a, **kw: plain_calls.append(1) or plain_fn(*a, **kw)
    try:
        veng = InferenceEngine.from_artifact(_artifact("cnv-w1a1"),
                                             device="cuda", route="vpu")
        for c in arms.values():
            c.reset()
        vpred = veng.classify(images)
        torch.cuda.synchronize()
        arm_launches = {r: c.value for r, c in arms.items()}
        launches["packed_matmul"] = sum(arm_launches.values())
        print(f"packed path: cnv-w1a1 route=vpu classify batch {BATCH}, "
              f"packed_matmul launches {arm_launches}, plain calls "
              f"{len(plain_calls)}")
        assert arm_launches["vpu"] > 0, "packed path never launched vpu"
        assert not plain_calls, "a CUDA route ran the plain version"
        assert vpred.shape == (BATCH,) and vpred.min() >= 0 \
            and vpred.max() < 10
        veng = _engine_check(torch, "cnv-w1a1", images, "cnv-w1a1 vpu",
                             route="vpu")
        assert (veng.classify(images) == vpred).all()
        for c in arms.values():
            c.reset()
        _engine_check(torch, "cnv-w2a2", images, "cnv-w2a2 mxu",
                      route="mxu")
        assert arms["mxu"].value > 0, "mxu arm never launched"
        lfc = _engine_check(torch, "lfc-w1a1", mnist, "lfc-w1a1 vpu",
                            route="vpu")

        # -- 9. packed input --------------------------------------------------
        std = lfc.logits(mnist)
        assert np.array_equal(lfc.logits_packed(mnist), std), \
            "logits_packed != logits"
        assert np.array_equal(lfc.logits_words(mnist), std), \
            "logits_words != logits (vpu)"
        mega = InferenceEngine.from_artifact(_artifact("lfc-w1a1"),
                                             device="cuda")
        assert np.array_equal(mega.logits_words(mnist), mega.logits(mnist)), \
            "logits_words != logits (mega)"
        print("packed input: lfc-w1a1 logits_packed == logits_words == "
              "logits (vpu); logits_words == logits (mega)")

        # -- 10. serving through the packed transport -------------------------
        words_calls = []
        words_device = lfc.words_device
        lfc.words_device = lambda w, **kw: \
            words_calls.append(w.shape) or words_device(w, **kw)
        server = _serve_68(BatchingServer, lfc, lfc.prepare(mnist[:128]),
                           "lfc-w1a1 vpu packed transport")
        assert server.packed_transport and words_calls, \
            "the server did not use words_device"
        print(f"packed transport: {len(words_calls)} words_device batches, "
              f"word shapes {sorted(set(words_calls))}")
        assert not plain_calls, "a CUDA route ran the plain version"
    finally:
        matmul.packed_matmul_plain = plain_fn

    # -- 11. the direct kernels against their plain versions -----------------
    direct_counters = {"conv2d_direct": conv_direct.conv2d_direct.launches,
                       "conv_chain_direct":
                           conv_direct.conv_chain_direct.launches}
    for k in direct_counters:
        results[k] = _new_result()
    layerwise = conv_direct.conv_chain_direct.layerwise
    for kname, label, kern, plain, work, chain in \
            _direct_cases(torch, device):
        layerwise.reset()
        got, want = kern(), plain()
        torch.cuda.synchronize()
        if kname == "conv_chain_direct":
            # one launch with the codes on chip, but for the map that
            # cannot fit there
            assert layerwise.value == ("a layer a launch" in label), \
                f"{label}: layerwise branch taken {layerwise.value} times"
        assert got.shape == want.shape and got.dtype == want.dtype, label
        err = float((got.double() - want.double()).abs().max())
        assert torch.equal(got, want), f"{label}: kernel != plain"
        ms, plain_ms = _time_ms(torch, kern), _time_ms(torch, plain)
        beside = (f"; conv_chain {chain_ms[label]:.4f} ms"
                  if label in chain_ms else "")
        r = results[kname]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if work:       # cnv-w1a1: the five direct layers, the two chains
            bound = _account(torch, device, r, work, got, ms, plain_ms)
            replay_ms = graph_ms(kern)
            r["graph_ms"] = (r["graph_ms"] or 0.0) + replay_ms
            beside = (f" (graph replay {replay_ms:.4f} ms), bound "
                      f"{bound:.4f} ms{beside}")
        if chain:      # conv_chain's kernel on the same layer
            assert torch.equal(chain(), got), f"{label}: != conv_chain"
            beside += (f"; conv_chain on this layer "
                       f"{_time_ms(torch, chain):.4f} ms (graph replay "
                       f"{graph_ms(chain):.4f} ms)")
        print(f"{kname} {label}: max |kernel - plain| {err:.3g}; kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms{beside}")

    # -- 12. the direct route -------------------------------------------------
    direct_plain = []
    plain_fns = (conv_direct.conv2d_direct_plain,
                 conv_direct.conv_chain_direct_plain)
    conv_direct.conv2d_direct_plain = \
        lambda *a, **kw: direct_plain.append(1) or plain_fns[0](*a, **kw)
    conv_direct.conv_chain_direct_plain = \
        lambda *a, **kw: direct_plain.append(1) or plain_fns[1](*a, **kw)
    try:
        deng = InferenceEngine.from_artifact(_artifact("cnv-w1a1"),
                                             device="cuda", route="direct")
        for c in direct_counters.values():
            c.reset()
        dpred = deng.classify(images)
        torch.cuda.synchronize()
        launches.update({k: c.value for k, c in direct_counters.items()})
        print(f"direct path: cnv-w1a1 route=direct classify batch {BATCH}, "
              f"launches conv2d_direct {launches['conv2d_direct']}, "
              f"conv_chain_direct {launches['conv_chain_direct']} (no "
              f"route calls it, as in JAX), plain calls {len(direct_plain)}")
        assert launches["conv2d_direct"] == 5, "direct path: 5 conv layers"
        assert not direct_plain, "a CUDA route ran the plain version"
        assert dpred.shape == (BATCH,) and dpred.min() >= 0 \
            and dpred.max() < 10
        deng = _engine_check(torch, "cnv-w1a1", images, "cnv-w1a1 direct",
                             route="direct")
        assert (deng.classify(images) == dpred).all()
        _engine_check(torch, "cnv-w2a2", images, "cnv-w2a2 direct",
                      route="direct")

        # -- 13. serving on the direct route ----------------------------------
        _serve_68(BatchingServer, deng, deng.prepare(images[:128]),
                  "cnv-w1a1 direct")
        assert not direct_plain, "a CUDA route ran the plain version"
    finally:
        (conv_direct.conv2d_direct_plain,
         conv_direct.conv_chain_direct_plain) = plain_fns

    # -- 12b. batches above the largest bucket ------------------------------
    _big_batch_check(torch, rng)

    # -- 14. the Mosaic probes --------------------------------------------
    _probe_phase(torch, device, kind, results, launches)

    # -- 15. the serving entry points on the card -------------------------
    _serving_entry_points(torch, images, counters)

    # -- 16. training on the card, served by the kernels --------------------
    _training_phase(torch, counters)

    # -- 17. tensor-parallel inference ---------------------------------------
    _parallel_phase(torch, smi)

    src = {"fused_mlp": ("bnn_pynq_tpu_torch/csrc/dense_chain.cu",
                         "bnn_pynq_tpu/ops/fused_mlp.py:30"),
           "dense_block": ("bnn_pynq_tpu_torch/csrc/dense_block.cu",
                           "bnn_pynq_tpu/ops/conv_stack.py:282"),
           "conv_chain": ("bnn_pynq_tpu_torch/csrc/conv_chain.cu",
                          "bnn_pynq_tpu/ops/conv_stack.py:65"),
           "packed_matmul": ("bnn_pynq_tpu_torch/csrc/packed_matmul.cu",
                             "bnn_pynq_tpu/ops/matmul.py:160"),
           "conv2d_direct": ("bnn_pynq_tpu_torch/csrc/conv_direct.cu",
                             "bnn_pynq_tpu/ops/conv_direct.py:54"),
           "conv_chain_direct": ("bnn_pynq_tpu_torch/csrc/conv_direct.cu",
                                 "bnn_pynq_tpu/ops/conv_direct.py:170")}
    for name, line in PROBE_LINES.items():
        src[name] = ("bnn_pynq_tpu_torch/csrc/mosaic_probes.cu",
                     f"tools/mosaic_probes.py:{line}")
    results["packed_matmul"] = packed
    kernels = []
    print("kernel rows (launches on its path per forward; ms summed over "
          "that path's calls at batch 1024; library: the one PyTorch call "
          "that computes the same function, where there is one; int_mm: "
          "torch._int_mm on the same M x K x N, dot only, no im2col, no "
          "thresholds):")
    for k in src:
        r = results[k]
        row = {"name": k, "route": "cuda", "source": src[k][0],
               "replaces": src[k][1], "launches": launches[k],
               "max_abs_err": r["max_abs_err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": "operations" if r["ops_ms"] >= r["bytes_ms"]
               else "bytes",
               "library_ms": r["library_ms"], "int_mm_ms": r["int_mm_ms"],
               "graph_ms": r["graph_ms"],
               "library_graph_ms": r["library_graph_ms"]}
        kernels.append(row)
        int_mm = "none" if row["int_mm_ms"] is None \
            else f"{row['int_mm_ms']:.4f}"
        graph = "" if row["graph_ms"] is None \
            else f" (graph replay {row['graph_ms']:.5f})"
        lib = "none" if row["library_ms"] is None else \
            (f"{row['library_ms']:.4f} (graph replay "
             f"{row['library_graph_ms']:.5f})")
        print(f"  {k}: launches_per_forward {row['launches']}, bound_ms "
              f"{row['bound_ms']:.5f} ({row['bound_by']}), kernel_ms "
              f"{row['ms']:.4f}{graph}, plain_ms {row['plain_ms']:.4f}, "
              f"library_ms {lib}, int_mm_ms {int_mm}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
