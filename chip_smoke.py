#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py          # from the repository root; one CUDA card

Phases (every check raises, so any failure exits non-zero):
1. the card: `nvidia-smi` name and power limit, torch's device name;
   no CUDA is a failure; the host library built (`native.build`, `make -C
   native`) and whether the host ops run in C or numpy;
2. build the kernels from bnn_pynq_tpu_torch/csrc (nvcc, first use);
3. each kernel against its plain version on the card, on seeded inputs at
   the CNV-W1A1 main-path shapes at batch 1024 (and W2A2, LFC cases):
   conv_chain's two chains as the path runs them, the 2×2 max-pool in the
   last conv's epilogue (`pool=True`, one `pooled_epilogue` each; their
   bound counts the pooled write), then unpooled at the same shapes, off
   the row; codes exactly equal, logits within rtol=atol=1e-5; the median
   device time per call of each over 20 runs of 10 back-to-back calls, with
   CUDA events, and for the main-path cases also under CUDA graph
   replay (no host in the way); then ragged and odd cases of conv_chain
   and dense_block (batch 1 and 1023, N = 10 and 100, C = 3 and 24, a
   5×5 kernel, chains of three layers, W2A2 with three thresholds,
   weights too large for shared memory), all exact, and of fused_mlp (1, 7
   and 1023 rows; SFC, LFC and CNV-tail widths, LFC and SFC with their
   bound and graph-replay time; W2A2 with three thresholds; hidden widths
   that are no multiple of 64; thresholds at the ends of int32);
4. the main path: InferenceEngine(cnv-w1a1, device="cuda").classify of
   1024 seeded images, with every kernel's launch count read around it
   (2 pooled epilogues a forward: conv1 and conv4 pool, no pool op);
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
   (and no plain packed_matmul call), its 8-bit first conv one `int_mm`
   (cuBLASLt's int8 GEMM) a forward and no int_matmul_ref, logits against
   runtime="ref";
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
   (5) and no plain call, conv0 and the 3 dense layers 4 `int_mm` a
   forward and no int_matmul_ref, logits against runtime="ref"; the same for
   cnv-w2a2; then batches above the largest bucket: classify of 2048 and
   4096 images on "mega", "direct" and "vpu" equal to runtime="ref" taken
   1024 at a time, with images/s beside the 1024 figure;
13. a BatchingServer over the cnv-w1a1 "direct" engine answering 68
   requests;
14. the launch floor (one one-element `torch.add_` under graph replay);
   the seven Mosaic probes (csrc/mosaic_probes.cu) against their plain
   versions, exactly, at JAX's inputs, at seeded random ones (int8 over
   its full range, int32 over ±2^30) and at ragged random shapes (the
   kernels' scalar paths), the two dots (on the int8 tensor cores) also at
   C = 48 with taps = 9 and m = 1000 and at n = 200, with `_int_mm` on the
   same M × K × N by events and under graph replay; then their entry
   point, `bnn_pynq_tpu_torch.tools.mosaic_probes --device cuda`: 7 PASS
   lines, every probe kernel launched, no plain call;
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
   call and no int_matmul_ref (the first conv of TPInferenceEngine and the
   dense layers of OverlapTPEngine are `int_mm`, counted); then in a world
   of two ranks sharing the card over gloo, meshes
   (1, 2) and (2, 1) on CNV-W1A1 and LFC-W1A1, both engines, every arm, each
   rank's launches and collectives counted, and a BatchingServer on rank 0
   answering 68 requests while rank 1 follows, with the parameters swapped
   live after 64. Each configuration's ms per forward is printed beside
   the card's name and power limit; two ranks on one card, whose gloo
   collectives go through the host, give no scaling figure. A world past
   its deadline (PARALLEL_DEADLINE_S) fails the run; phase 17.0 also holds
   the three kernels against their plain versions at the row counts that
   path gives them (batch 1024, and 512 a rank on (2, 1));
18. sharded (dp x tp) training (parallel/train_sharded.py) on CNV-W1A1 at
   its published widths, the preset batch of 50 of the synthetic CIFAR-10
   set, init_sharded(seed=0): in a world of one rank on NCCL, mesh (1, 1),
   and in a world of two ranks sharing the card over gloo, meshes (1, 2)
   (every layer sharded, the classes-wide last one too) and (2, 1): three
   eager steps (`step.eager`) after a first one timed by CUDA events with
   their collectives counted, then, with
   cuDNN's deterministic algorithms, three make_sharded_train_step steps
   against make_train_step on the same card from the same state with the
   same constant-rate, no-Glorot Adam (loss
   within SHARDED_LOSS_TOL, the gathered parameters and statistics within
   SHARDED_PARAM_TOL), a three-step make_sharded_epoch_fn equal to the
   steps (SHARDED_EPOCH_TOL), every block equal bit for bit on the ranks
   that hold it; the gathered variables compiled and served on `mega`
   (counted launches, no plain call, logits == ref, argmax against the
   float model as phase 16) and by TPInferenceEngine 'vpu' on the mesh
   (== the single-card engine, 8 packed_matmul launches), with the ms per
   step by CUDA events and the collectives per step by kind;
19. the perf tools and the examples (bnn_pynq_tpu_torch/tools/,
   examples/): perf_suite --verify --quick on every route of CNV-W1A1,
   CNV-W2A2 and LFC-W1A1 (each route's int32 accumulators, logits and
   argmax equal to runtime="ref" on the card), layer_table on CNV-W1A1 at
   batch 1024 beside phase 3's kernel times, batch1_latency on `mega`,
   serving_bench at half its measured capacity for 2.5 s; then
   train_compile_serve sfc-w1a1 --epochs 1, workload_demo mnist and
   cifar10, classify and serving_pipeline as subprocesses side by side,
   each exiting 0; every tool's rows printed;
20. the captured programs (runtime/engine.py) and the captured training
   step (train/trainer.py): every route of CNV-W1A1 and LFC-W1A1 at batch
   1024 and 1, in every variant the engine dispatches (logits, argmax and
   for LFC the packed-words pair), the program's output equal to the eager
   forward bit for bit at its first use and at a replay, in distinct
   buffers, its capture's kernel launches and library calls equal to the
   eager forward's ('xla' and 'xlaconv': library calls, no kernel; the
   packed routes and 'direct': their `int_mm` calls; no int_matmul_ref),
   logits within rtol=atol=1e-5 of runtime="ref" and argmax equal; then,
   captured against eager in the same run, classify images/s, the host's
   enqueue of a forward, device ms per forward (and the eager forward
   under graph replay, at 1024 and at 1) and batch-1 µs chained,
   synchronised and host to host (CNV-W1A1 mega, direct, vpu; LFC-W1A1
   mega), and for `direct` and `vpu` the eager forward under graph replay
   with its int8 products on `int_mm` against the float64 int_matmul_ref
   they ran on before, in turns, equal bit for bit; two launches of one
   bucket in flight and a load_parameters between two launches (old, then
   new, never mixed); the memory of one engine's programs; 20 CNV-W1A1
   training steps at batch 50 captured against eager under cuDNN's
   deterministic algorithms, losses, parameters, statistics and moments
   equal bit for bit, with ms a step and the card's busy share; and
   tools/train_cnv_synth at CNV-W1A1's full width for 2 epochs, seconds
   an epoch. Where an engine's forward runs as a program, a wrapper counts
   its launches at the eager run before the capture and at the capture,
   and the program counts its replays: phases 4, 12 and 15 hold both
   (capture launches == the eager forward's, replays > 0);
21. the parallel engines' programs (parallel/spmd.py) and the captured
   sharded step, in a world of one rank on NCCL: a probe that captures an
   all_reduce, an all_gather_into_tensor and a batch_isend_irecv pair in
   one graph and replays them equal to the eager calls (this PyTorch and
   NCCL capture collectives); on mesh (1, 1) TPInferenceEngine 'vpu' and
   'mxu', OverlapTPEngine ring, blocking and 'auto' and make_gspmd_engine
   on phase 4's 1024 images at batch 1024 and 1, each program equal to the
   eager forward bit for bit at its first use and at a replay, its
   capture's kernel launches, library calls and collective calls equal to
   the eager forward's (no int_matmul_ref; make_gspmd_engine, on
   decode_params' arrays, one `int_mm` a conv or dense layer and no kernel),
   replayed, classify and logits equal to the single-card engine
   ('mega''s for make_gspmd_engine; its programs' pool bytes printed);
   captured against eager in the same run: the host's enqueue of
   a forward, device ms per forward (and the eager forward under graph
   replay) and batch-1 µs chained; a load_parameters between two launches
   (old, then new, captured again); 40 sharded CNV-W1A1 steps at batch 50
   captured against eager under cuDNN's deterministic algorithms (losses,
   parameters, statistics, moments bit for bit), ms a step and the card's
   busy share of each (the replayed graph profiled), and a captured
   make_sharded_epoch_fn equal to them, captured again each time Adam's
   table doubles. The
   2-rank gloo worlds of phases 17-18 report their engines as eager, with
   no programs: gloo stages through the host, which no graph can hold.
22. the decoded-integer routes (models/network.py::forward_xla on
   decode_params; ops/int_dot.py): CNV-W1A1, CNV-W2A2 and LFC-W1A1 from
   pretrained/ at batch 1024 and 1 on 'xla' (patches and cuBLASLt's int8
   GEMM) and 'xlaconv' (cuDNN's float64 conv): int32
   accumulators equal runtime="ref"'s, 'native' equal to 'patches' bit
   for bit, logits within rtol=atol=1e-5 of runtime="ref" and of 'mega'
   with argmax equal; the library calls of a forward counted (an int8
   GEMM a dense layer, a GEMM or a cuDNN conv a conv layer; no kernel
   launch, no int_matmul_ref), each program equal to the eager forward
   bit for bit; device ms a forward under graph replay beside 'mega''s;
   then CNV-W1A1 a layer at a time (profile_layers) beside the mega stage
   of the same layers, the memory of one engine's programs, one
   torch.profiler trace by kernel (tools/layer_times.py::forward_profile)
   and the card's clocks and temperature after the timings.
23. strided convs and conv_chain on prebuilt patches (ops/conv_stack.py,
   `input_patches`): (a) CNV-W1A1 from pretrained/ on phase 4's images at
   batch 1024 in JAX's layout of its first chain, `im2col0` (patches of
   levels [1024, 30, 30, 27]) then conv_chain_vmem over conv0-1, its
   valid region equal to the plain version's and to the route's own stage
   chain0-1, each timed under graph replay with and without the im2col
   stage; (b) the same weights at stride 2 (patches [1024, 15, 15, 27]
   to [1024, 13, 13, 64]) against the plain version; each with its events
   ms, graph ms, plain ms and bound on conv_chain's row; (c) strided nets
   (a strided conv on the image, and one on codes after a pool; W1A1 and
   W2A2, random parameters from a seed) on InferenceEngine 'mega' and
   's2d' at batch 1024: the stage list the engine runs (JAX's, `im2col{i}`,
   each chain a 2×2 pool follows fused, `chain0-1+pool2`), logits
   within rtol=atol=1e-5 of runtime="ref" with argmax and classify
   equal, each program equal to the eager forward bit for bit, the kernel
   launches counted from 0 around the engines; a ring step's int32
   partials of a strided conv (`overlap.conv_partial`) equal to the CPU's;
   OverlapTPEngine ring and blocking in a one-rank NCCL world equal to the
   single-card engine.
24. MobileNet-v1 W4A4 (portbench/configs/mobilenetv1-w4a4.npz) at batch
   256 on seeded int8 224×224×3 images, as the benchmark's
   `mobilenetv1-w4a4.resident` runs it: each kernel stage of its 'mega'
   forward against its plain version on the stage's own input, bit for
   bit — the 8-bit image conv on its padded stride-2 patches (conv_chain),
   the 13 depthwise convs (depthwise_conv, `dw_kernel`, 15 thresholds),
   the 13 pointwise convs on 4-bit codes (dense_block on B·H·W rows) and
   the 1024 → 1000 classifier (fused_mlp) — each with its time by events
   and under graph replay, its plain time and its bound, summed by kernel;
   then InferenceEngine on 'mega': the launches of its first use read from
   zero (the eager run and the capture, each 1 conv_chain, 13
   depthwise_conv, 13 dense_block, 1 fused_mlp; no pooled epilogue), the
   program's capture equal to the eager forward's, logits equal to the
   stage walk's and to runtime="ref" on the card bit for bit, argmax and
   `classify` of the uint8 pixels equal. The depthwise kernel gets a row of its own.
25. ResNet-50 v1.5 W1A2 (portbench/configs/resnet50-w1a2.npz) at batch
   256 on seeded int8 224×224×3 images, as the benchmark's
   `resnet50-w1a2.resident` runs it: each kernel call of its 'mega'
   forward against its plain version on the call's own input, bit for
   bit, codes in 0..3 — conv1 on its padded stride-2 patches
   (conv_chain), in each of the 16 bottleneck blocks the first 1×1 conv
   (dense_block on unsigned 2-bit codes), the 3×3 conv (stride 1:
   conv_chain over the map padded with code 0; stride 2: dense_block on
   the padded patches' rows) and the block-closing 1×1 conv with its
   shortcut (dense_residual: the identity's codes added in the epilogue,
   or the projection's product in the K loop), and the 2048 → 1000
   classifier (fused_mlp) — each with its time by events and under graph
   replay, its plain time and its bound, summed by kernel; then
   InferenceEngine on 'mega': the launches of its first use read from
   zero (the eager run and the capture, each 14 conv_chain, 35
   dense_block, 1 fused_mlp, 16 residual epilogues; no pooled epilogue,
   no threshold search), the program's capture equal to the eager
   forward's, logits equal to the walk's and to runtime="ref" on the card
   bit for bit, argmax and `classify` of the uint8 pixels equal.
   dense_residual gets a row of its own.

    python3 chip_smoke.py --spread  # a host with two or more cards

runs, after phase 1, only a gloo world of two ranks a card over every
card, mesh (2, cards): each rank computes on the card make_mesh gave it
(its current device too, which the launchers use), and TPInferenceEngine
'vpu' and OverlapTPEngine ring and blocking on CNV-W1A1 equal the
single-card engine on that card; then phase 18's job in an NCCL world of
one rank a card, mesh (cards / 2, 2): the only run where NCCL carries a
model axis above 1, its sharded steps captured with their collectives;
then phase 21's probe over every card and its engine checks on meshes
(1, cards) and (cards / 2, 2) in an NCCL world of one rank a card, real
collectives in the graphs (the ring's ppermutes, the blocking arm's
all-gathers, counted at the capture), ring against blocking.

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
a yardstick that the port never calls (for the two dot probes also under
graph replay, `int_mm_graph_ms`). `launch_floor_ms`, the same in every
row, is the graph-replay time of a launch that does nothing to speak of.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""

import contextlib
import functools
import io
import itertools
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


def _int_mm_ms(torch, device, gemms, graph=False):
    """torch._int_mm on int8 operands of each (M, K, N), K and N rounded up
    to 8 as it demands: the dot only. Summed over the gemms; by CUDA events,
    or with `graph` under CUDA graph replay."""
    from bnn_pynq_tpu_torch.tools.layer_times import graph_ms
    total = 0.0
    for m, k, n in gemms:
        a = torch.ones((max(m, 32), -(-k // 8) * 8), dtype=torch.int8,
                       device=device)
        b = torch.ones((a.shape[1], -(-n // 8) * 8), dtype=torch.int8,
                       device=device)
        call = functools.partial(torch._int_mm, a, b)
        total += graph_ms(call) if graph else _time_ms(torch, call)
        del a, b
    return total


def _new_result():
    return {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
            "ops_ms": 0.0, "bytes_ms": 0.0, "int_mm_ms": None,
            "int_mm_graph_ms": None, "graph_ms": None, "library_ms": None,
            "library_graph_ms": None}


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
    """(kernel name, case label, wrapper fn, plain fn, output kind, work,
    on the row) at the main-path shapes, from the pretrained weights and
    seeded inputs: CNV's chains as the path runs them, the 2×2 pool after
    each in its last conv's epilogue (`pool=True`), on conv_chain's row
    for CNV-W1A1, then unpooled at the same shapes (on no row: the direct
    kernels' chains are timed beside them); then the ragged and odd cases
    of conv_chain and dense_block (work None: checked and timed, on no
    kernel's row)."""
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
        row = name == "cnv-w1a1"
        chains = [("chain0-1", "+pool2", image, chain01, (64, 64)),
                  ("chain3-4", "+pool5", x34, chain34, (128, 128))]
        for pool in (True, False):
            cases += [
                ("conv_chain",
                 f"{name} {chain}{suffix * pool} {tuple(x.shape)}",
                 lambda x=x, kw=kw, p=pool: conv_stack.conv_chain(
                     x, pool=p, **kw),
                 lambda x=x, kw=kw, p=pool: conv_stack.conv_chain_plain(
                     x, pool=p, **kw),
                 "codes", _work(_conv_gemms(x.shape, 3, widths), x,
                                *_kn(kw["weights"]), *kw["thresholds"]),
                 row and pool)
                for chain, suffix, x, kw, widths in chains]
        cases += [
            ("dense_block", f"{name} block6 {tuple(x6.shape)}",
             lambda x=x6, kw=block6: conv_stack.dense_block(x, **kw),
             lambda x=x6, kw=block6: conv_stack.dense_block_plain(x, **kw),
             "codes", _work(_dense_gemms(len(x6), block6["weights"]), x6,
                            *_kn(block6["weights"]),
                            *block6["thresholds"]), row),
            ("fused_mlp", f"{name} mlp_tail {tuple(xt.shape)}",
             lambda x=xt, kw=tail: fused_mlp.fused_mlp_forward(x, **kw),
             lambda x=xt, kw=tail: fused_mlp.fused_mlp_forward_plain(x, **kw),
             "logits", _work(_dense_gemms(len(xt), tail["weights"]), xt,
                             *_kn(tail["weights"]), *tail["thresholds"],
                             scale, bias), row),
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
                         bias), False))
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
                      "codes", None, False))

    def dense(label, x, ws, ts, **kw):
        kw = dict(weights=ws, thresholds=ts, **kw)
        cases.append(("dense_block", f"odd: {label} {tuple(x.shape)}",
                      lambda: conv_stack.dense_block(x, **kw),
                      lambda: conv_stack.dense_block_plain(x, **kw),
                      "codes", None, False))

    def mlp(label, x, work=False, **kw):
        cases.append(("fused_mlp", f"odd: {label} {tuple(x.shape)}",
                      lambda: fused_mlp.fused_mlp_forward(x, **kw),
                      lambda: fused_mlp.fused_mlp_forward_plain(x, **kw),
                      "logits",
                      _work(_dense_gemms(len(x), kw["weights"]), x,
                            *_kn(kw["weights"]), *kw["thresholds"],
                            kw["out_scale"], kw["out_bias"])
                      if work else None, False))

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
            timed=False, sliced=False):
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
        kind = "small" if timed else "sliced" if sliced else "odd"
        for route in (("vpu", "mxu", "mxu_rm") if bits == 1
                      else ("mxu", "mxu_rm")):
            work = _work([(m, k, n)], a, wp, *([thr] if nthr else []),
                         peak=PEAK_B1 if route == "vpu" else PEAK_INT8) \
                if sliced else None
            add(f"{kind}: {label} {route} M={m} K={k} N={n} bits={bits}"
                f"{'' if nthr else ' int32'}", route, a, wp,
                dict(thr=thr, k=k, bits=bits), work)

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
    # sliced_kernel's three cases: timed, with their bounds
    odd("K=30,000 in slices", 1, 300, 30000, 72, 1, sliced=True)
    odd("K=30,000 in slices, N=10 int32, one row", 1, 1, 30000, 10, 0,
        sliced=True)
    odd("W2A2 K=12,000 in slices, N=300", 2, 77, 12000, 300, 3,
        sliced=True)
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


def _library_moved(label, before):
    """The library calls (`engine.library_calls`) made since `before` by
    an engine of the kernels runtime, which calls no int_matmul_ref: the
    int8 products JAX leaves to XLA are `int_mm` (cuBLASLt) there."""
    from bnn_pynq_tpu_torch.runtime.engine import _moved, library_calls
    lib = _moved(before, library_calls())
    assert "int_matmul_ref" not in lib, \
        f"{label}: the kernels runtime called int_matmul_ref: {lib}"
    return lib


def _engine_check(torch, name, images, label, route="mega"):
    """Kernel engine vs ref engine on the card; returns the kernel engine
    (and prints both img/s). The kernel engine calls no int_matmul_ref."""
    from bnn_pynq_tpu_torch.runtime.engine import (InferenceEngine,
                                                   library_calls)
    eng = InferenceEngine.from_artifact(_artifact(name), device="cuda",
                                        route=route)
    ref = InferenceEngine.from_artifact(_artifact(name), device="cuda",
                                        runtime="ref")
    before = library_calls()
    got = eng.logits(images)
    torch.cuda.synchronize()
    _library_moved(f"engine {label}", before)
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
    random ones at ragged shapes; for the two dots also C = 48 with taps = 9
    and m = 1000 (k32 steps across taps, a partial row tile; x holds just
    the m + taps - 1 rows read) and n = 200 (several column chunks, the
    last of 8 columns)."""
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
        if "w" in arg_shapes:
            cases.append((name, "C=48 taps=9 m=1000 inputs",
                          {"x": draw((1000 + 8, 48), dtype),
                           "w": draw((9 * 48, probes.O), dtype),
                           "m": 1000}))
            cases.append((name, "n=200 inputs",
                          {"x": draw((m + 128, c), dtype),
                           "w": draw((probes.K * c, 200), dtype)}))
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
    """Phase 14: the launch floor; each probe kernel against its plain
    version and, where one PyTorch call computes its function, against that
    call (the dots: `_int_mm` on the same M x K x N, by events and under
    graph replay); then the probes' entry point on the card with every
    plain version counted. Returns the launch floor, ms."""
    from bnn_pynq_tpu_torch.ops import probes
    from bnn_pynq_tpu_torch.tools.layer_times import graph_ms
    from bnn_pynq_tpu_torch.tools import mosaic_probes as probe_tool
    for fn in probes.PROBES:
        results[fn.__name__] = _new_result()
    one = torch.zeros(1, dtype=torch.int32, device=device)
    floor_ms = graph_ms(lambda: one.add_(1))
    print(f"launch floor: one one-element torch.add_ under graph replay "
          f"{floor_ms:.5f} ms")
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
            if work["gemms"]:
                r["int_mm_graph_ms"] = _int_mm_ms(torch, device,
                                                  work["gemms"], graph=True)
                beside += (f", _int_mm {r['int_mm_ms']:.4f} ms (graph "
                           f"replay {r['int_mm_graph_ms']:.5f} ms)")
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
    return floor_ms


def _serving_entry_points(torch, images, counters):
    """Phase 15: the HTTP server, /reload, a Frontend over a 'mega' and a
    'direct' backend, `cli bench` and the upload stage, all on the card."""
    from bnn_pynq_tpu_torch import cli
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
        # serve() warmed every bucket: the POST replays the program of the
        # 256 bucket (argmax), captured there
        key = ((256, 32, 32, 3), torch.int8, True, False)
        replays = eng.programs[key].replays.value
        for c in counters.values():
            c.reset()
        code, body = _http(url + "/classify", _npz(x))
        torch.cuda.synchronize()
        assert code == 200, (code, body[:200])
        got = json.loads(body)["classes"]
        assert got == want.tolist(), "HTTP /classify != engine.classify"
        assert not any(c.value for c in counters.values()), \
            "a warmed server captured or ran eagerly under traffic"
        prog = _hold_program(torch, eng, key, "http")
        assert prog.replays.value > replays, "the POST replayed no program"
        http_launches = prog.launches
        assert all(http_launches.get(k, 0) > 0 for k in counters), \
            http_launches
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
        deng = servers[1][1].engine
        before = {k: p.replays.value for k, p in deng.programs.items()}
        futs = [fe.submit(images[i]) for i in range(64)]
        got = np.array([f.result(timeout=120) for f in futs])
        torch.cuda.synchronize()
        assert (got == want[:64]).all(), "Frontend answers != classify"
        ran = {k: p.replays.value - before.get(k, 0)
               for k, p in deng.programs.items()
               if p.replays.value > before.get(k, 0)}
        assert ran, "the direct backend replayed no program"
        for k in ran:
            assert _hold_program(torch, deng, k, "frontend direct").launches[
                "conv2d_direct"] == 5, "the direct backend's conv2d_direct"
        assert fe.healthy_backends() == ["mega", "direct"]
        print(f"frontend: 64 requests over a mega and a direct HTTP backend "
              f"== engine.classify (direct backend: replays "
              f"{sorted(ran.values())} of programs whose capture launched "
              f"conv2d_direct 5 times)")
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
        # the eager step: KeepGrads sees every update (a captured step
        # replays Adam without calling it; phase 20 holds the two equal)
        sides[dev] = (m, tx, trainer.make_train_step(cfg, m, tx).eager)
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


def _step_profile(torch, step, x, y, wall_ms, steps=10, require=True):
    """Device time of one train step by kernel (torch.profiler over
    `steps` steps), and its share of the step's wall time `wall_ms`;
    returns the device ms a step. require=False: None where the trace
    holds no device event (a replayed graph's kernels, where this
    profiler does not see them)."""
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
    if not by_name and not require:
        print(f"train step profile ({steps} steps): no device event")
        return None
    assert by_name, "the profiler's trace holds no device event"
    device_ms = sum(by_name.values())
    top = "; ".join(f"{ms:.4f} {name[:60]}"
                    for name, ms in by_name.most_common(5))
    print(f"train step profile ({steps} steps): device {device_ms:.4f} ms "
          f"per step in {launches / steps:g} launches, "
          f"{100 * device_ms / wall_ms:.1f} % of the {wall_ms:.3f} ms wall "
          f"step; top kernels (ms per step): {top}")
    return device_ms


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
        tx = trainer.Adam(model, 2 * steps, preset["lr_start"],
                          preset["lr_end"])
        epoch = trainer.make_epoch_fn(cfg, model, tx, steps, bs)
        gen = torch.Generator(device="cuda").manual_seed(7)
        dts = []
        for _ in range(2):      # the first with the step's capture
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            timed = epoch(x_dev, y_dev, gen).cpu().numpy()
            dts.append(time.perf_counter() - t0)
            assert np.isfinite(timed).all()
        dt = dts[1]
        assert epoch.step.replays == 2 * steps - trainer.WARMUP_STEPS
        print(f"train cnv-w1a1 on the card, two more epochs timed alone "
              f"(captured step): {dts[0]:.3f} s with the capture, then "
              f"{dt:.3f} s, {steps / dt:.1f} steps/s, "
              f"{steps * bs / dt:.1f} images/s (host clock, ends in the "
              f"loss fetch)")
        _step_profile(torch, trainer.make_train_step(cfg, model, tx).eager,
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


def _int_mm_calls(eng):
    """The int_mm calls of one forward of a parallel engine, the int8
    products JAX leaves to XLA: TPInferenceEngine's 8-bit first conv;
    OverlapTPEngine's dense layers, each but the first and the last as m
    ring partials on a ring of m > 1."""
    from bnn_pynq_tpu_torch.models.network import make_plan
    plan = [lp for lp in make_plan(eng.config) if lp.kind != "pool"]
    if not hasattr(eng, "arm"):
        n = sum(lp.kind == "conv_int8" for lp in plan)
    else:
        m = eng.mesh.shape["model"]
        ring = m if eng.arm == "ring" else 1
        n = sum(ring if i and not lp.last else 1
                for i, lp in enumerate(plan) if lp.kind == "dense")
    return {"int_mm": n} if n else {}


def _held(torch, label, eng, x, want_logits, want_cls):
    """Classify x (uint8) on a parallel engine with the launches and the
    collectives counted around it, then logits; both against the
    single-card engine's. Returns the row of this configuration: its
    launches per forward (under NCCL a classify's first use of a bucket
    counts the eager run before the capture and the capture, 2 × a
    forward) and its library calls per forward (`_int_mm_calls`, no
    int_matmul_ref) and its execution."""
    from bnn_pynq_tpu_torch.parallel import comm
    from bnn_pynq_tpu_torch.parallel.overlap import elapsed_s
    from bnn_pynq_tpu_torch.runtime.engine import library_calls
    _reset_path_launches()
    comm.reset_counts()
    lib_before = library_calls()
    got_cls = eng.classify(x, prepared=False)
    torch.cuda.synchronize()
    runs = 2 if eng.execution == "graphs" else 1
    launches = {k: v // runs for k, v in _path_launches().items() if v}
    assert all(v * runs == _path_launches()[k] for k, v in launches.items()),\
        f"{label}: launches {_path_launches()} not {runs} forwards"
    lib = _library_moved(label, lib_before)
    library = {k: v // runs for k, v in lib.items()}
    assert library == _int_mm_calls(eng) and all(
        v * runs == lib[k] for k, v in library.items()), \
        f"{label}: library calls {lib}, not {runs} x {_int_mm_calls(eng)}"
    counts = {k: v for k, v in comm.counts().items() if v}
    got = eng.logits(x, prepared=False)
    assert np.array_equal(got_cls, want_cls), f"{label}: classes differ"
    np.testing.assert_allclose(got, want_logits, **TOL, err_msg=label)
    xd = eng.upload(eng._pad_to_bucket(eng.prepare(x))[0])
    eng.launch_prepared(xd)
    ms = elapsed_s(lambda: eng.launch_prepared(xd), 3, eng.device) * 1e3
    return {"label": label, "launches": launches, "collectives": counts,
            "library": library,
            "max_abs_err": float(np.abs(got - want_logits).max()),
            "ms": ms, "execution": eng.execution,
            "programs": len(eng.programs)}


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
        assert row["execution"] == "graphs" and row["programs"] == 2, row
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
                # gloo stages through the host: no graph, no program
                assert row["execution"] == "eager" and \
                    row["programs"] == 0 and "'eager'" in repr(eng), row
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
    """--spread: the world of `_parallel_spread` over every card, then
    phase 18's job in an NCCL world of one rank a card, mesh
    (cards / 2, 2)."""
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
    xs, ys, images = _sharded_inputs()
    t0 = time.perf_counter()
    res = run_world(_sharded_rank, cards,
                    args=([(cards // 2, 2)], xs, ys, images), device="cuda",
                    timeout=PARALLEL_DEADLINE_S)
    assert res[0][0]["backend"] == "nccl", res[0][0]["backend"]
    print(f"sharded training spread: an nccl world of {cards} ranks, one a "
          f"card, in {time.perf_counter() - t0:.1f} s")
    _check_sharded(res, smi, f"{cards}-rank nccl, one rank a card")
    _spread_programs(torch, smi, cards)


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
                  f"equal; launches per forward {row['launches']}; "
                  f"library calls {row['library']} (no int_matmul_ref); "
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


# -- phase 18: sharded (dp x tp) training ---------------------------------

# tests/test_sharding.py:106-141: the loss; the parameters after Adam's
# first steps (about -lr.sign(g) each, so a gradient of rounding noise
# moves a weight by lr either way); the epoch against its steps
SHARDED_LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
SHARDED_PARAM_TOL = dict(rtol=5e-2, atol=2e-3)
SHARDED_EPOCH_TOL = dict(rtol=1e-5, atol=1e-6)
SHARDED_STEPS = 3
SHARDED_LR = 1e-3


def _tree_worst(got, want):
    """Largest |got - want| over the leaves of two flax-layout trees, and
    whether every leaf is within SHARDED_PARAM_TOL."""
    worst, ok = 0.0, True
    for kind in want:
        for layer, leaves in want[kind].items():
            for leaf, w in leaves.items():
                g = got[kind][layer][leaf]
                assert g.shape == w.shape, (kind, layer, leaf)
                worst = max(worst, float(np.abs(g - w).max()))
                ok = ok and np.allclose(g, w, **SHARDED_PARAM_TOL)
    return worst, ok


def _sharded_rank(shapes, xs, ys, images):
    """Phase 18, in each rank: per mesh shape, CNV-W1A1 from
    init_sharded(seed=0): SHARDED_STEPS eager steps timed after a first
    one, with their collectives counted; then, under cuDNN's deterministic
    algorithms, SHARDED_STEPS steps by make_sharded_train_step and, anew,
    by make_sharded_epoch_fn, and the same steps of make_train_step on
    this rank's card from the same state and the same constant-rate,
    no-Glorot Adam; the stepwise result gathered, compiled and served by
    TPInferenceEngine ('vpu') on the mesh and, on rank 0, by the mega
    kernels against the float model."""
    import types

    import torch
    import torch.distributed as dist
    from bnn_pynq_tpu_torch.compiler import compile_network
    from bnn_pynq_tpu_torch.models.config import get_config
    from bnn_pynq_tpu_torch.ops import conv_stack, fused_mlp
    from bnn_pynq_tpu_torch.parallel import (comm, gather_variables,
                                             init_sharded, make_mesh,
                                             make_sharded_epoch_fn,
                                             make_sharded_train_step)
    from bnn_pynq_tpu_torch.parallel.tp import TPInferenceEngine
    from bnn_pynq_tpu_torch.runtime.engine import InferenceEngine
    from bnn_pynq_tpu_torch.train.model import QuantNet
    from bnn_pynq_tpu_torch.train.trainer import Adam, make_train_step

    cfg = get_config("cnv-w1a1")
    out = []
    for data, model in shapes:
        mesh = make_mesh(data=data, model=model)
        dev = mesh.device
        # the eager step (`step.eager`; phase 21 times the captured one),
        # timed with cuDNN's default algorithms, as the trainer runs, after
        # a step that sets them up
        net, tx = init_sharded(cfg, mesh, lr=SHARDED_LR, seed=0)
        step = make_sharded_train_step(cfg, mesh, net, tx)
        step.eager(xs[0], ys[0])
        comm.reset_counts()
        ms = []
        for i in range(SHARDED_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            step.eager(xs[i], ys[i])
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
        counts = comm.counts()
        # compared with cuDNN's deterministic algorithms: its default
        # weight gradients sum in an order that changes from run to run
        # (two runs of the same three steps came out up to 3.7e-5 apart)
        torch.backends.cudnn.deterministic = True
        try:
            ref = QuantNet(cfg, generator=torch.Generator().manual_seed(
                0)).to(dev)
            rstep = make_train_step(cfg, ref, Adam(
                ref, 1, SHARDED_LR, SHARDED_LR, glorot_lr_scale=False))
            ref_losses = [float(rstep(torch.from_numpy(xs[i]).to(dev),
                                      torch.from_numpy(ys[i]).to(dev)))
                          for i in range(SHARDED_STEPS)]
            net, tx = init_sharded(cfg, mesh, lr=SHARDED_LR, seed=0)
            step = make_sharded_train_step(cfg, mesh, net, tx)
            losses = [float(step(xs[i], ys[i]))
                      for i in range(SHARDED_STEPS)]
            local = net.variables()
            stepwise = gather_variables(net, mesh)
            net2, tx2 = init_sharded(cfg, mesh, lr=SHARDED_LR, seed=0)
            epoch_losses = make_sharded_epoch_fn(cfg, mesh, net2, tx2)(
                xs, ys)
            epoch_vars = gather_variables(net2, mesh)
        finally:
            torch.backends.cudnn.deterministic = False

        compiled = compile_network(cfg, stepwise["params"],
                                   stepwise["batch_stats"])
        row = {"mesh": (data, model), "coords": mesh.coords,
               "backend": mesh.backend, "device": str(dev),
               "sharded": sorted(net.sharded), "ref_losses": ref_losses,
               "losses": losses, "step_ms": ms, "counts": counts,
               "local": local, "stepwise": stepwise,
               "ref": ref.variables(), "epoch_losses": epoch_losses,
               "epoch": epoch_vars}
        if dist.get_rank() == 0:
            counters = {"fused_mlp": fused_mlp.fused_mlp_forward.launches,
                        "dense_block": conv_stack.dense_block.launches,
                        "conv_chain": conv_stack.conv_chain.launches}
            pred, row["mega_launches"], row["mega_err"] = _serve_trained(
                torch, compiled, images, counters,
                ("conv_chain", "dense_block", "fused_mlp"))
            fpred = _float_predictions(
                torch, cfg, types.SimpleNamespace(
                    params=stepwise["params"],
                    batch_stats=stepwise["batch_stats"]), images)
            row["float_engine_differ"] = int((fpred != pred).sum())
        single = InferenceEngine(compiled, device=dev, route="vpu")
        plain = _count_plain()
        row["tp"] = _held(torch, f"TPInferenceEngine vpu ({data},{model})",
                          TPInferenceEngine(compiled, mesh, route="vpu"),
                          images, single.logits(images),
                          single.classify(images))
        assert not plain, f"plain versions called: {sorted(set(plain))}"
        out.append(row)
    return out


def _check_sharded(res, smi, world):
    """Phase 18's checks on the rows of every rank of one world."""
    by_mesh = {}
    for rank, rows in enumerate(res):
        for row in rows:
            by_mesh.setdefault(row["mesh"], []).append((rank, row))
    for (data, model), rows in by_mesh.items():
        label = f"{world}, mesh ({data},{model})"
        for rank, row in rows:
            np.testing.assert_allclose(row["losses"], row["ref_losses"],
                                       err_msg=label, **SHARDED_LOSS_TOL)
            worst, ok = _tree_worst(row["stepwise"], row["ref"])
            assert ok, f"{label}: parameters off the single-card step " \
                       f"by {worst}"
            np.testing.assert_allclose(row["epoch_losses"], row["losses"],
                                       err_msg=label, **SHARDED_EPOCH_TOL)
            for kind in row["stepwise"]:
                for layer, leaves in row["stepwise"][kind].items():
                    for leaf, v in leaves.items():
                        np.testing.assert_allclose(
                            row["epoch"][kind][layer][leaf], v,
                            err_msg=f"{label} epoch {layer}/{leaf}",
                            **SHARDED_EPOCH_TOL)
        # the ranks that hold one block hold it bit for bit: every leaf
        # across 'data', the replicated ones across 'model' too
        n_same = 0
        for (ra, a), (rb, b) in itertools.combinations(rows, 2):
            for kind in a["local"]:
                for layer, leaves in a["local"][kind].items():
                    whole = int(layer.split("_")[1]) not in a["sharded"]
                    if a["coords"][1] == b["coords"][1] or whole:
                        for leaf, v in leaves.items():
                            assert np.array_equal(
                                v, b["local"][kind][layer][leaf]), \
                                f"{label}: {layer}/{leaf} differs between " \
                                f"ranks {ra} and {rb}"
                            n_same += 1
        rank0 = rows[0][1]
        worst = _tree_worst(rank0["stepwise"], rank0["ref"])[0]
        assert rank0["mega_launches"] and rank0["float_engine_differ"] <= \
            FLOAT_ENGINE_DIFFER, rank0["float_engine_differ"]
        for rank, row in rows:
            assert row["tp"]["launches"] == {"packed_matmul[vpu]": 8}, row
        counted = {k: v for k, v in rank0["counts"].items() if v}
        print(f"sharded training [{label}, {rank0['backend']}, "
              f"{rank0['device']}]: CNV-W1A1 at batch 50, "
              f"layers sharded {rank0['sharded']}; losses "
              f"{[round(v, 6) for v in rank0['losses']]} against the "
              f"single-card step's {[round(v, 6) for v in rank0['ref_losses']]}"
              f"; gathered parameters within {worst:.3g} of it; epoch == "
              f"steps; {n_same} leaves equal bit for bit "
              f"across ranks; ms per eager step (step.eager, CUDA events) "
              f"{[round(v, 3) for v in rank0['step_ms']]} ({smi}); "
              f"collectives over those {SHARDED_STEPS} eager steps "
              f"{json.dumps(counted)}")
        print(f"  served: mega launches {rank0['mega_launches']}, logits == "
              f"ref (max |diff| {rank0['mega_err']:.3g}), float model and "
              f"engine argmax differ on {rank0['float_engine_differ']} of "
              f"{BATCH}; TPInferenceEngine vpu on the mesh == single-card "
              f"engine (max |diff| {rank0['tp']['max_abs_err']:.3g}), "
              f"launches {rank0['tp']['launches']}, collectives "
              f"{rank0['tp']['collectives']}, {rank0['tp']['ms']:.3f} ms "
              f"per forward")


def _sharded_inputs():
    """Three batches of 50 synthetic CIFAR-10 training images as the
    trainer takes them, and phase 4's 1,024 seeded images."""
    from bnn_pynq_tpu_torch.train import data as data_mod
    ds = data_mod.load("cifar10")
    n = SHARDED_STEPS * 50
    xs = data_mod.train_inputs("cifar10", ds.x_train[:n], "int8").reshape(
        (SHARDED_STEPS, 50, 32, 32, 3))
    ys = ds.y_train[:n].astype(np.int64).reshape(SHARDED_STEPS, 50)
    images = np.random.default_rng(1).integers(
        0, 256, size=(BATCH, 32, 32, 3), dtype=np.uint8)
    return xs, ys, images


def _sharded_training_phase(torch, smi):
    """Phase 18: sharded training on the card, a 1-rank NCCL world and a
    2-rank gloo world sharing the card."""
    from bnn_pynq_tpu_torch.parallel.launch import run_world
    xs, ys, images = _sharded_inputs()
    t0 = time.perf_counter()
    one = run_world(_sharded_rank, 1, args=([(1, 1)], xs, ys, images),
                    device="cuda", timeout=PARALLEL_DEADLINE_S)
    assert one[0][0]["backend"] == "nccl"
    t1 = time.perf_counter()
    two = run_world(_sharded_rank, 2,
                    args=([(1, 2), (2, 1)], xs, ys, images), device="cuda",
                    timeout=PARALLEL_DEADLINE_S)
    assert two[0][0]["backend"] == "gloo"
    t2 = time.perf_counter()
    print(f"sharded training: a world of 1 rank (nccl) in {t1 - t0:.1f} s "
          f"and of 2 ranks sharing the card (gloo, every collective's CUDA "
          f"tensor through the host: no scaling figure) in {t2 - t1:.1f} s")
    _check_sharded(one, smi, "1-rank nccl")
    _check_sharded(two, smi, "2-rank gloo")


# -- phase 19: the perf tools and the examples --------------------------------

def _tool_rows(main, argv, out):
    """Run a tool's main with --out `out`; its rows."""
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        rc = main(argv + ["--out", out])
    assert rc == 0, f"{main.__module__} exited {rc}: {log.getvalue()[-2000:]}"
    with open(out) as f:
        return [json.loads(line) for line in f]


def _tools_phase(torch, smi, results):
    """Phase 19: perf_suite --verify, layer_table, batch1_latency and
    serving_bench in this process, then the four examples as subprocesses
    side by side."""
    import tempfile

    from bnn_pynq_tpu_torch.tools import (batch1_latency, layer_table,
                                          perf_suite, serving_bench)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        rows = _tool_rows(perf_suite.main, [
            "--verify", "--quick", "--nets", "cnv-w1a1,cnv-w2a2,lfc-w1a1",
            "--batches", "1024,4096"], os.path.join(tmp, "perf.jsonl"))
        bad = [r for r in rows if not r["verify_ok"]]
        assert not bad, f"perf_suite --verify: {bad}"
        routes = {(r["network"], r["route"]) for r in rows}
        print(f"tools: perf_suite --verify, {len(rows)} cases: every route "
              f"of cnv-w1a1, cnv-w2a2 and lfc-w1a1 ({len(routes)}) equal to "
              f"runtime='ref' on the card (int32 accumulators, logits, "
              f"argmax) ({smi}):")
        for r in rows:
            print(f"  {json.dumps(r)}")
        rows = _tool_rows(layer_table.main, [
            "--net", "cnv-w1a1", "--batch", str(BATCH), "--iters", "20"],
            os.path.join(tmp, "layers.jsonl"))
        chain_ms = sum(r["ms"] for r in rows
                       if str(r.get("stage", "")).startswith("chain"))
        print(f"tools: layer_table cnv-w1a1 at batch {BATCH}, a stage at a "
              f"time under graph replay ({smi}); the chain stages "
              f"{chain_ms:.4f} ms beside phase 3's conv_chain "
              f"{results['conv_chain']['graph_ms']:.4f} (dense_block "
              f"{results['dense_block']['graph_ms']:.4f}, fused_mlp "
              f"{results['fused_mlp']['graph_ms']:.4f}), graph replay:")
        for r in rows:
            print(f"  {json.dumps(r)}")
        for main, argv, name in (
                (batch1_latency.main, ["--routes", "mega"], "batch1_latency"),
                (serving_bench.main, ["--loads", "0.5", "--duration", "2.5",
                                      "--capacity-seconds", "1"],
                 "serving_bench")):
            rows = _tool_rows(main, argv, os.path.join(tmp, f"{name}.jsonl"))
            print(f"tools: {name} ({smi}):")
            for r in rows:
                print(f"  {json.dumps(r)}")
        t1 = time.perf_counter()

        examples = [
            ["train_compile_serve", "sfc-w1a1", "--epochs", "1", "--out",
             os.path.join(tmp, "artifacts")],
            ["workload_demo", "mnist"], ["workload_demo", "cifar10"],
            ["classify"], ["serving_pipeline"]]
        procs = [(ex, subprocess.Popen(
            [sys.executable, "-m", f"bnn_pynq_tpu_torch.examples.{ex[0]}",
             *ex[1:]], cwd=HERE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)) for ex in examples]
        try:
            outs = [p.communicate(timeout=300) for _, p in procs]
        finally:
            for _, p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for (ex, p), (stdout, stderr) in zip(procs, outs):
        assert p.returncode == 0, \
            f"example {' '.join(ex)} exited {p.returncode}: {stderr[-3000:]}"
        tail = stdout.strip().splitlines()[-3:]
        if ex[0] == "workload_demo":
            report = json.loads(stdout)
            assert report["hw_vs_sw_mismatches"] == 0, report
            tail = [json.dumps(report)]
        print(f"example {' '.join(ex)}: exit 0; {' | '.join(tail)}")
    print(f"tools and examples: {t1 - t0:.1f} s for the tools, "
          f"{time.perf_counter() - t1:.1f} s for the examples side by side")


# -- phase 20: the captured programs and the captured training step ----------

# every route of each net whose programs phase 20 holds to the eager forward
PROGRAM_ROUTES = {"cnv-w1a1": ("mega", "s2d", "xla", "xlaconv", "vpu", "mxu",
                               "mxu_rm", "direct"),
                  "lfc-w1a1": ("mega", "fused", "vpu", "mxu", "mxu_rm",
                               "direct")}
# the int_mm calls (cuBLASLt's int8 GEMM) of one forward of the routes that
# run hand-written kernels and leave a product to the library, as JAX
# leaves it to XLA's int8 dot: the 8-bit first conv, and on 'direct' every
# dense layer
INT_MM_ROUTES = {"vpu": {"cnv-w1a1": 1, "lfc-w1a1": 0},
                 "mxu": {"cnv-w1a1": 1, "lfc-w1a1": 0},
                 "mxu_rm": {"cnv-w1a1": 1, "lfc-w1a1": 0},
                 "direct": {"cnv-w1a1": 4, "lfc-w1a1": 4}}
# the route and net each eager-against-captured timing runs
PROGRAM_TIMINGS = (("cnv-w1a1", "mega"), ("cnv-w1a1", "direct"),
                   ("cnv-w1a1", "vpu"), ("lfc-w1a1", "mega"))
# the routes whose device ms a forward phase 20 also takes "before": conv0
# (and on 'direct' the dense layers) on forward_ref's float64 product
BEFORE_INT_MM = ("direct", "vpu")
TRAIN_STEPS = 20          # captured against eager, bit for bit


def _eager(eng, xd, argmax=False, words=False):
    """The engine's eager forward on its published parameters: what its
    programs capture."""
    return eng._eager(eng._state.params, xd, argmax, words)


def _key(xd, argmax, words=False):
    return (tuple(xd.shape), xd.dtype, argmax, words)


def _launch_delta(before):
    from bnn_pynq_tpu_torch.runtime.engine import kernel_launches
    return {k: n - before[k] for k, n in kernel_launches().items()
            if n != before[k]}


def _hold_program(torch, eng, key, label):
    """The program of `key`: captured (a CUDA graph), its capture counted
    the same kernel launches as one eager forward, and it replayed."""
    from bnn_pynq_tpu_torch.runtime.engine import kernel_launches
    prog = eng.programs[key]
    assert prog.graph is not None, f"{label}: not captured"
    before = kernel_launches()
    _eager(eng, prog.x, key[2], key[3])
    torch.cuda.synchronize()
    eager = _launch_delta(before)
    assert prog.launches == eager, \
        f"{label}: capture launches {prog.launches} != eager {eager}"
    assert prog.replays.value > 0, f"{label}: never replayed"
    return prog


def _programs_held(torch, images, mnist):
    """20.1: every route of CNV-W1A1 and LFC-W1A1 at batch 1024 and 1, in
    each variant the engine dispatches: the program's output equal to the
    eager forward bit for bit (first use and a replay), its capture's
    kernel launches and library calls equal to the eager forward's (on
    'xla' and 'xlaconv' library calls only: no kernel; on the packed
    routes and 'direct' the int_mm calls of INT_MM_ROUTES; no route calls
    int_matmul_ref), logits against runtime="ref"."""
    from bnn_pynq_tpu_torch import native
    from bnn_pynq_tpu_torch.runtime.engine import (XLA_ROUTES,
                                                   InferenceEngine,
                                                   _moved, kernel_launches,
                                                   library_calls)
    n_programs = 0
    for name, routes in PROGRAM_ROUTES.items():
        x_all = images if name.startswith("cnv") else mnist
        ref = InferenceEngine.from_artifact(_artifact(name), device="cuda",
                                            runtime="ref")
        for route in routes:
            eng = InferenceEngine.from_artifact(_artifact(name),
                                                device="cuda", route=route)
            seen = {}
            for batch in (BATCH, 1):
                xd = eng.upload(eng.prepare(x_all[:batch]))
                inputs = {False: xd}
                if eng.config.input_kind == "bipolar":
                    inputs[True] = eng.upload(
                        native.binarize_pack(x_all[:batch]))
                for words, inp in inputs.items():
                    for argmax in (False, True):
                        label = (f"{name} {route} batch {batch} "
                                 f"{'words-' if words else ''}"
                                 f"{'argmax' if argmax else 'logits'}")
                        before = kernel_launches()
                        lib_before = library_calls()
                        want = _eager(eng, inp, argmax, words)
                        eager = _launch_delta(before)
                        lib = _moved(lib_before, library_calls())
                        got = eng.launch_prepared(inp, argmax=argmax,
                                                  words=words)
                        again = eng.launch_prepared(inp, argmax=argmax,
                                                    words=words)
                        torch.cuda.synchronize()
                        assert got.data_ptr() != again.data_ptr(), label
                        assert torch.equal(got, want) and \
                            torch.equal(again, want), \
                            f"{label}: program != eager forward"
                        prog = eng.programs[_key(inp, argmax, words)]
                        assert prog.graph is not None, label
                        assert prog.launches == eager, \
                            f"{label}: capture {prog.launches} != eager {eager}"
                        assert prog.library == lib, \
                            f"{label}: capture {prog.library} != eager {lib}"
                        assert prog.replays.value == 2, label
                        assert "int_matmul_ref" not in lib, \
                            f"{label}: {lib}: the kernels runtime called " \
                            f"int_matmul_ref"
                        if route in XLA_ROUTES:
                            assert not eager and lib, \
                                f"{label}: {eager} {lib}, not the library"
                        elif name != "lfc-w1a1" or route != "direct":
                            assert eager, f"{label}: no kernel launched"
                        if route in INT_MM_ROUTES:
                            # conv0 (and on 'direct' the dense layers)
                            n = INT_MM_ROUTES[route][name]
                            assert lib == ({"int_mm": n} if n else {}), \
                                f"{label}: library calls {lib}"
                        seen[label.split(" ", 2)[2]] = eager or lib
                        n_programs += 1
                logits = eng.fetch(eng.launch_prepared(xd))
                want = ref.logits(eng.prepare(x_all[:batch]), prepared=True)
                np.testing.assert_allclose(logits, want, **TOL)
                assert (logits.argmax(1) == want.argmax(1)).all(), \
                    f"{name} {route} batch {batch}: argmax != ref"
            print(f"programs {name} {route}: {len(eng.programs)} captured "
                  f"(batch 1024 and 1), each == the eager forward bit for "
                  f"bit, capture launches (library calls on xla, "
                  f"xlaconv) == eager "
                  f"{seen[f'batch {BATCH} logits']}, logits == ref")
    return n_programs


@contextlib.contextmanager
def _float64_products():
    """`forward` and `forward_direct` as they ran before their int8
    products moved to cuBLASLt's GEMM: conv0 (and on 'direct' the dense
    layers) through forward_ref's layer, `int_matmul_ref` in float64 on
    the card."""
    from bnn_pynq_tpu_torch.models import network
    xla_layer = network.xla_layer
    network.xla_layer = lambda config, lp, p, act: \
        network._ref_layer(config, lp, p, act)
    try:
        yield
    finally:
        network.xla_layer = xla_layer


def _eager_engine(eng):
    """`eng` with launch_prepared running the eager forward (no program):
    the engine as it ran before the programs, for the timings."""
    eng.launch_prepared = lambda xd, argmax=False, words=False: \
        _eager(eng, xd, argmax, words)
    return eng


def _program_timings(torch, images, mnist, smi):
    """20.2: classify images/s, the host's enqueue of one forward, device
    ms per forward and batch-1 µs, captured against eager in this run."""
    from bnn_pynq_tpu_torch.runtime.engine import InferenceEngine
    from bnn_pynq_tpu_torch.tools.batch1_latency import chained_us, sync_us
    from bnn_pynq_tpu_torch.tools.layer_times import graph_ms
    device = torch.device("cuda", 0)
    rows = []
    for name, route in PROGRAM_TIMINGS:
        x_all = images if name.startswith("cnv") else mnist
        row = {"net": name, "route": route, "device": smi}
        for kind in ("captured", "eager", "eager_again", "captured_again"):
            mode = kind.split("_")[0]
            eng = InferenceEngine.from_artifact(_artifact(name),
                                                device="cuda", route=route)
            if mode == "eager":
                _eager_engine(eng)
            eng.classify(x_all)
            walls = []
            for _ in range(5):
                t0 = time.perf_counter()
                eng.classify(x_all)
                walls.append(time.perf_counter() - t0)
            xd = eng.upload(eng.prepare(x_all))
            eng.fetch(eng.launch_prepared(xd, argmax=True))
            enqueue = []
            for _ in range(20):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng.launch_prepared(xd, argmax=True)
                enqueue.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            one = InferenceEngine.from_artifact(
                _artifact(name), device="cuda", route=route,
                batch_buckets=(1,))
            if mode == "eager":
                _eager_engine(one)
            x1 = eng.prepare(x_all[:1])
            xd1 = one.upload(x1)
            one.fetch(one.launch_prepared(xd1))
            got = {"images_per_s": len(x_all) / float(np.median(walls)),
                   "enqueue_ms": float(np.median(enqueue)),
                   "chained_ms": _time_ms(
                       torch, lambda: eng.launch_prepared(xd, argmax=True)),
                   "b1_chained_us": chained_us(
                       lambda: one.launch_prepared(xd1), 200),
                   "b1_sync_us": sync_us(lambda: one.launch_prepared(xd1),
                                         50, device),
                   "b1_host_us": sync_us(
                       lambda: one.logits(x1, prepared=True), 50, device)}
            if kind == "eager":         # the device time of a forward
                got["graph_ms"] = graph_ms(lambda: _eager(eng, xd, True))
                got["b1_graph_us"] = 1e3 * graph_ms(
                    lambda: _eager(one, xd1))
            if mode == "eager" and route in BEFORE_INT_MM:
                # int_mm against the float64 product, in turns
                order = ("int_mm", "float64") if kind == "eager" \
                    else ("float64", "int_mm")
                for side in order:
                    with (_float64_products() if side == "float64"
                          else contextlib.nullcontext()):
                        got[f"{side}_graph_ms"] = graph_ms(
                            lambda: _eager(eng, xd, True))
                        got[f"{side}_out"] = _eager(eng, xd)
                assert torch.equal(got.pop("int_mm_out"),
                                   got.pop("float64_out")), \
                    f"{name} {route}: int_mm forward != float64 forward"
            for k, v in got.items():
                row.setdefault(k, {})[kind] = v
        rows.append(row)
        print(f"programs timing {json.dumps(row)}")
        if route in BEFORE_INT_MM:
            print(f"programs {name} {route}: device ms a forward at batch "
                  f"{BATCH} under graph replay (the eager forward), conv0"
                  f"{' and the dense layers' if route == 'direct' else ''} "
                  f"on int_mm (cuBLASLt) / on the float64 int_matmul_ref "
                  f"(as before), in turns: "
                  + "; ".join(f"{row['int_mm_graph_ms'][k]:.4f} / "
                              f"{row['float64_graph_ms'][k]:.4f}"
                              for k in ("eager", "eager_again"))
                  + f" ({smi})")
    return rows


def _swap_between_replays(torch, images):
    """20.3: two launches of one bucket in flight without a fetch give
    distinct, right outputs; a load_parameters between two launches
    gives the old parameters' logits, then the new ones', never mixed."""
    from bnn_pynq_tpu_torch.compiler.artifacts import load_artifact
    from bnn_pynq_tpu_torch.runtime.engine import InferenceEngine
    eng = InferenceEngine.from_artifact(_artifact("cnv-w1a1"), device="cuda")
    x1 = eng.upload(eng.prepare(images))
    x2 = eng.upload(eng.prepare(images[::-1].copy()))
    want1, want2 = _eager(eng, x1), _eager(eng, x2)
    a, b = eng.launch_prepared(x1), eng.launch_prepared(x2)
    old_graph = eng.programs[_key(x1, False)].graph
    swapped = load_artifact(_artifact("cnv-w1a1"))
    swapped.out_bias = swapped.out_bias + 1.0
    c = eng.launch_prepared(x1)
    eng.load_parameters(swapped)
    d = eng.launch_prepared(x1)
    torch.cuda.synchronize()
    assert torch.equal(a, want1) and torch.equal(b, want2), \
        "two launches in flight: outputs overwritten"
    assert not torch.equal(want1, want2)
    assert torch.equal(c, want1), "the launch before the swap: not old"
    torch.testing.assert_close(d, want1 + 1.0, **TOL)
    assert torch.equal(d, _eager(eng, x1)), "after the swap: != eager"
    prog = eng.programs[_key(x1, False)]
    assert prog.graph is not old_graph and prog.replays.value == 1
    print("programs swap: cnv-w1a1 mega batch 1024, two launches in flight "
          "without a fetch == their eager forwards; load_parameters "
          "(out_bias + 1) between two launches: old, then new (captured "
          "again), never mixed")


def _graph_pool_bytes(torch, route="mega"):
    """20.4 (and 22 on 'xla', 'xlaconv'): the memory of one CNV-W1A1
    engine's programs on `route`, every bucket in both serving variants
    (one shared pool): the growth of the allocator's reserved bytes over
    the captures, and the pool's own segments where the allocator's
    snapshot names their pool."""
    from bnn_pynq_tpu_torch.runtime.engine import InferenceEngine
    eng = InferenceEngine.from_artifact(_artifact("cnv-w1a1"), device="cuda",
                                        route=route)
    torch.cuda.synchronize()
    reserved0 = torch.cuda.memory_reserved()
    for b in eng.batch_buckets:
        eng.warmup(b)
    torch.cuda.synchronize()
    grown = torch.cuda.memory_reserved() - reserved0
    in_pool = _pool_bytes(torch, eng.programs.pool)
    print(f"programs memory: cnv-w1a1 {route}, {len(eng.programs)} programs "
          f"(buckets {list(eng.batch_buckets)}, logits and argmax of int8 "
          f"and of raw uint8), reserved "
          f"bytes grew {grown} over the captures; the shared pool's segments "
          f"{in_pool[0]} bytes in {in_pool[1]}")


def _pool_bytes(torch, pool):
    """(bytes, segments) of a graph pool's segments, where the allocator's
    snapshot names their pool."""
    segs = torch.cuda.memory._snapshot()["segments"]
    sizes = [s["total_size"] for s in segs
             if tuple(s.get("segment_pool_id") or ()) == tuple(pool)]
    return sum(sizes), len(sizes)


def _captured_training(torch, smi):
    """20.5: TRAIN_STEPS CNV-W1A1 steps at batch 50 on the captured step
    against the eager step from the same state, under cuDNN's
    deterministic algorithms: losses, parameters and statistics equal bit
    for bit; ms a step of each and the card's busy share."""
    from bnn_pynq_tpu_torch.models.config import get_config
    from bnn_pynq_tpu_torch.train import data as data_mod
    from bnn_pynq_tpu_torch.train import model as tmodel
    from bnn_pynq_tpu_torch.train import trainer

    cfg = get_config("cnv-w1a1")
    ds = data_mod.load(cfg.dataset)
    bs = 50
    n = 2 * TRAIN_STEPS * bs
    x = torch.from_numpy(data_mod.train_inputs(
        cfg.dataset, ds.x_train[:n], cfg.input_kind)).cuda()
    y = torch.from_numpy(ds.y_train[:n].astype(np.int64)).cuda()
    start = tmodel.QuantNet(cfg).variables()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        sides = {}
        for kind in ("captured", "eager"):
            m = tmodel.QuantNet(cfg).cuda()
            m.load_variables(start["params"], start["batch_stats"])
            tx = trainer.Adam(m, 2 * TRAIN_STEPS, 1e-3, 1e-6)
            step = trainer.make_train_step(cfg, m, tx)
            sides[kind] = (m, tx, step, step if kind == "captured"
                           else step.eager)
        losses = {}
        for kind, (m, tx, step, call) in sides.items():
            losses[kind] = torch.stack(
                [call(x[i * bs:(i + 1) * bs], y[i * bs:(i + 1) * bs])
                 for i in range(TRAIN_STEPS)]).cpu()
        (mc, txc, stepc, _), (me, txe, _, _) = sides["captured"], \
            sides["eager"]
        assert stepc.graph is not None and \
            stepc.replays == TRAIN_STEPS - trainer.WARMUP_STEPS
        assert torch.equal(losses["captured"], losses["eager"]), \
            (losses["captured"], losses["eager"])
        for (k, a), b in zip(mc.state_dict().items(),
                             me.state_dict().values()):
            assert torch.equal(a, b), f"captured != eager: {k}"
        for a, b in zip(txc.mu + txc.nu, txe.mu + txe.nu):
            assert torch.equal(a, b), "Adam's moments differ"
        assert txc.count == txe.count == TRAIN_STEPS
        # ms a step over the next TRAIN_STEPS batches, host clock
        times = {}
        for kind, (m, tx, step, call) in sides.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(TRAIN_STEPS, 2 * TRAIN_STEPS):
                call(x[i * bs:(i + 1) * bs], y[i * bs:(i + 1) * bs])
            torch.cuda.synchronize()
            times[kind] = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
    finally:
        torch.backends.cudnn.deterministic = deterministic
    device_ms = _step_profile(torch, sides["eager"][2].eager, x[:bs], y[:bs],
                              times["eager"])
    print(f"captured training step: cnv-w1a1 batch {bs}, {TRAIN_STEPS} "
          f"steps ({trainer.WARMUP_STEPS} eager, then captured) == the eager "
          f"steps bit for bit (losses, parameters, statistics, moments; "
          f"cudnn.deterministic); ms a step (host clock, {TRAIN_STEPS} steps "
          f"ending in a synchronise): captured {times['captured']:.3f}, "
          f"eager {times['eager']:.3f}; device {device_ms:.4f} ms a step "
          f"(the eager step's profile): busy {100 * device_ms / times['captured']:.1f} "
          f"% captured, {100 * device_ms / times['eager']:.1f} % eager ({smi})")


def _train_cnv_synth(torch, smi):
    """20.6: the train_cnv_synth tool at CNV-W1A1's full width, cut to 2
    epochs: the loss falls, the engine twin agrees with the float model."""
    import tempfile

    from bnn_pynq_tpu_torch.tools import train_cnv_synth
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "curve.jsonl")
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            rc = train_cnv_synth.main(["--epochs", "2", "--out", out])
        assert rc == 0, log.getvalue()[-2000:]
        with open(out) as f:
            rows = [json.loads(line) for line in f]
    *epochs, summ = rows
    assert summ["loss_decreased"] and summ["device"] == "cuda"
    assert summ["engine_images"] - summ["engine_float_agree"] <= \
        FLOAT_ENGINE_DIFFER, summ
    secs = [round(r["seconds"], 3) for r in epochs]
    print(f"train_cnv_synth --epochs 2 (cnv-w1a1 full width, 16384 "
          f"synthetic images, batch 64, 256 steps an epoch): seconds an "
          f"epoch {secs} (the first with the capture), loss "
          f"{[round(r['loss'], 4) for r in epochs]}; {json.dumps(summ)} "
          f"({smi})")


def _programs_phase(torch, smi):
    """Phase 20: the engine's captured programs and the trainer's captured
    step on the card."""
    rng = np.random.default_rng(1)          # phase 4's draws
    images = rng.integers(0, 256, size=(BATCH, 32, 32, 3), dtype=np.uint8)
    mnist = rng.integers(0, 256, size=(BATCH, 28, 28), dtype=np.uint8)
    t0 = time.perf_counter()
    n = _programs_held(torch, images, mnist)
    print(f"programs: {n} held in {time.perf_counter() - t0:.1f} s")
    _program_timings(torch, images, mnist, smi)
    _swap_between_replays(torch, images)
    _graph_pool_bytes(torch)
    _captured_training(torch, smi)
    _train_cnv_synth(torch, smi)


# -- phase 21: the parallel engines' programs and the captured sharded step --

SPMD_ENGINES = ("TPInferenceEngine vpu", "TPInferenceEngine mxu",
                "OverlapTPEngine ring", "OverlapTPEngine blocking",
                "OverlapTPEngine auto", "make_gspmd_engine")
# the single-card route each engine is held against
SPMD_SINGLE = {"TPInferenceEngine vpu": "vpu", "TPInferenceEngine mxu": "mxu"}
SHARDED_CAPTURE_STEPS = 20


def _nccl_capture_probe(torch):
    """21.1, in a rank of an NCCL world: an all_reduce, an
    all_gather_into_tensor and a batch_isend_irecv pair (to the right
    neighbour, from the left; the rank itself in a world of one) captured
    in one graph in thread-local mode and replayed on new inputs, equal to
    the same calls made eagerly. Integer-valued floats, so the sums are
    exact in any order."""
    import torch.distributed as dist
    n, me = dist.get_world_size(), dist.get_rank()
    device = torch.device("cuda", torch.cuda.current_device())

    def body(x):
        a = x.clone()
        dist.all_reduce(a)
        g = torch.empty((n * x.shape[0],) + x.shape[1:], dtype=x.dtype,
                        device=device)
        dist.all_gather_into_tensor(g, x)
        r = torch.empty_like(x)
        for w in dist.batch_isend_irecv(
                [dist.P2POp(dist.isend, x, (me + 1) % n),
                 dist.P2POp(dist.irecv, r, (me - 1) % n)]):
            w.wait()
        return a, g, r

    def draw(seed):
        gen = torch.Generator().manual_seed(1000 * seed + me)
        return torch.randint(-64, 64, (256, 512), generator=gen).to(
            device, torch.float32)

    static = draw(0)
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        body(static)                        # the communicators, eagerly
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            outs = body(static)
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    for seed in (1, 2):
        x = draw(seed)
        static.copy_(x)
        graph.replay()
        want = body(x)
        torch.cuda.synchronize()
        for name, got, w in zip(("all_reduce", "all_gather_into_tensor",
                                 "batch_isend_irecv"), outs, want):
            assert torch.equal(got, w), \
                f"NCCL capture probe: the replayed {name} != the eager one"
    return {"world": n, "replays": 2}


def _spmd_engine(label, compiled, mesh):
    from bnn_pynq_tpu_torch.parallel.overlap import OverlapTPEngine
    from bnn_pynq_tpu_torch.parallel.tp import (TPInferenceEngine,
                                                make_gspmd_engine)
    kind, _, arg = label.partition(" ")
    if kind == "make_gspmd_engine":
        return make_gspmd_engine(compiled, mesh)
    if kind == "TPInferenceEngine":
        return TPInferenceEngine(compiled, mesh, route=arg)
    return OverlapTPEngine(compiled, mesh, arm=arg)


def _calls_delta(before):
    from bnn_pynq_tpu_torch.parallel import comm
    return {k: n - before[k] for k, n in comm.counts().items()
            if n != before[k]}


def _gspmd_rows(mesh, x):
    """The rows of prepared x that make_gspmd_engine gives this rank, on
    its card (the batch padded to a multiple of 'data')."""
    import torch
    d = mesh.shape["data"]
    x = np.concatenate([x, np.zeros(((-len(x)) % d,) + x.shape[1:],
                                    x.dtype)])
    rows = len(x) // d
    return torch.from_numpy(np.ascontiguousarray(
        x[mesh.coords[0] * rows:][:rows])).to(mesh.device)


def _spmd_held(torch, label, eng, mesh, x_prepared, wants, graph=True):
    """21.2, one engine of a rank: at batch 1024 and 1, in both variants
    (make_gspmd_engine: logits), the program's output equal to the eager
    forward bit for bit at its first use and at a replay, its capture's
    kernel launches and collective calls equal to the eager forward's,
    and it replayed; classify and logits of the batch against the
    single-card engine (`wants`: logits, classes). Then, captured against
    eager: the host's enqueue of a forward at 1024 (ms), device ms per
    forward chained at 1024, batch-1 µs chained, and (graph) the eager
    forward under graph replay at 1024 and at 1."""
    from bnn_pynq_tpu_torch.parallel import comm
    from bnn_pynq_tpu_torch.runtime.engine import (_moved, kernel_launches,
                                                   library_calls)
    from bnn_pynq_tpu_torch.tools.batch1_latency import chained_us
    from bnn_pynq_tpu_torch.tools.layer_times import graph_ms
    gspmd = label == "make_gspmd_engine"
    assert eng.execution == "graphs", (label, eng.execution)
    # make_gspmd_engine: an int8 GEMM a conv or dense layer, nothing else
    want_lib = {"int_mm": sum(1 for p in eng.params if p)} if gspmd \
        else _int_mm_calls(eng)

    def forwards(x):
        """{argmax: (program launch, eager forward, program key)}"""
        if gspmd:
            xl = _gspmd_rows(mesh, x)
            key = tuple(xl.shape)
            return {False: (lambda: eng.programs[key](xl),
                            lambda: eng.forward(xl), key)}
        xd = eng.upload(eng._pad_to_bucket(x)[0])
        xl, params = eng._rows(xd), eng._state.params
        return {am: (lambda am=am: eng.launch_prepared(xd, argmax=am),
                     lambda am=am: eng._eager(params, xl, am, False),
                     (tuple(xl.shape), xl.dtype, am, False))
                for am in (False, True)}

    runs = {}
    for batch in (BATCH, 1):
        first = eng(x_prepared[:batch]) if gspmd else None   # its program
        for argmax, (program, eager, key) in forwards(
                x_prepared[:batch]).items():
            tag = f"{label} batch {batch} {'argmax' if argmax else 'logits'}"
            before, calls = kernel_launches(), comm.counts()
            lib_before = library_calls()
            want = eager()
            torch.cuda.synchronize()
            e_launch, e_calls = _launch_delta(before), _calls_delta(calls)
            e_lib = _moved(lib_before, library_calls())
            replayed = eng.programs[key].replays.value if gspmd else 0
            got, again = program(), program()
            torch.cuda.synchronize()
            p = eng.programs[key]
            assert torch.equal(got, want) and torch.equal(again, want), \
                f"{tag}: program != eager forward"
            if gspmd:                       # its first use, bit for bit
                assert np.array_equal(first, want.cpu().numpy()[:batch]), \
                    f"{tag}: first use != eager forward"
            assert p.graph is not None, f"{tag}: not captured"
            assert p.launches == e_launch and bool(e_launch) != gspmd, \
                f"{tag}: capture launches {p.launches} != eager {e_launch}"
            assert p.library == e_lib == want_lib, \
                f"{tag}: capture library {p.library}, eager {e_lib}, " \
                f"not {want_lib}"
            assert p.collectives == e_calls, \
                f"{tag}: capture collectives {p.collectives} != {e_calls}"
            assert p.replays.value - replayed == 2, f"{tag}: replays"
            runs[tag] = {"launches": p.launches, "library": p.library,
                         "collectives": p.collectives}
    want_logits, want_cls = wants
    if gspmd:
        got = eng(x_prepared)
        assert (got.argmax(1) == want_cls).all(), label
    else:
        assert (eng.classify(x_prepared) == want_cls).all(), label
        got = eng.logits(x_prepared)
    np.testing.assert_allclose(got, want_logits, **TOL, err_msg=label)
    times = {}
    for kind in ("captured", "eager"):
        i = 0 if kind == "captured" else 1
        big = forwards(x_prepared)
        fwd = big[not gspmd][i]             # classify's variant
        fwd1 = forwards(x_prepared[:1])[False][i]
        fwd()
        enqueue = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fwd()
            enqueue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        times[kind] = {"enqueue_ms": float(np.median(enqueue)),
                       "chained_ms": _time_ms(torch, fwd),
                       "b1_chained_us": chained_us(fwd1, 200)}
        if graph and kind == "eager":
            times[kind]["graph_ms"] = graph_ms(fwd)
            times[kind]["b1_graph_us"] = 1e3 * graph_ms(fwd1)
    row = {"label": label, "runs": runs, "times": times,
           "programs": len(eng.programs), "repr": repr(eng)}
    if gspmd:                       # the memory of its two programs
        row["pool_bytes"] = _pool_bytes(torch, eng.programs.pool)
    return row


def _spmd_swap(torch, compiled, mesh):
    """21.3: a load_parameters (out_bias + 1) between two launches of one
    bucket on an OverlapTPEngine: the first launch gives the old
    parameters' output, the second the new ones', captured again."""
    import copy

    from bnn_pynq_tpu_torch.parallel.overlap import OverlapTPEngine
    eng = OverlapTPEngine(compiled, mesh)
    x = np.random.default_rng(4).integers(
        -128, 128, size=(BATCH, 32, 32, 3), dtype=np.int8)
    xd = eng.upload(x)
    a = eng.launch_prepared(xd)
    want_a = eng._eager(eng._state.params, eng._rows(xd), False, False)
    old = next(iter(eng.programs.values())).graph
    swapped = copy.copy(compiled)
    swapped.out_bias = compiled.out_bias + 1.0
    eng.load_parameters(swapped)
    b = eng.launch_prepared(xd)
    want_b = eng._eager(eng._state.params, eng._rows(xd), False, False)
    torch.cuda.synchronize()
    assert torch.equal(a, want_a), "the launch before the swap: not old"
    assert torch.equal(b, want_b), "the launch after the swap: not new"
    torch.testing.assert_close(b, a + 1.0, **TOL)
    prog = next(iter(eng.programs.values()))
    assert prog.graph is not old and prog.replays.value == 1
    return {"version": eng.version}


def _sharded_capture(torch, mesh, xs, ys):
    """21.4: 2·SHARDED_CAPTURE_STEPS sharded CNV-W1A1 steps at batch 50 on
    the captured step against the eager one from init_sharded(seed=0),
    under cuDNN's deterministic algorithms: losses, parameters,
    statistics and Adam's moments equal bit for bit. The captured side's
    Adam table is sized for the whole phase first, so it captures once
    and its timing holds replays only. Then make_sharded_epoch_fn from
    the same state on `init_sharded`'s one-row table, which grows by
    doubling (captures at steps 2, 6, 14, 30): its two epochs' losses
    equal to the captured steps', each fetched once. ms a step (host
    clock over SHARDED_CAPTURE_STEPS steps ending in a synchronise) of
    the captured step, the eager step and a third epoch, none capturing;
    device ms a step (torch.profiler) of the eager step and of the
    replayed graph, both on cuDNN's deterministic algorithms."""
    from bnn_pynq_tpu_torch.models.config import get_config
    from bnn_pynq_tpu_torch.parallel import (init_sharded,
                                             make_sharded_epoch_fn,
                                             make_sharded_train_step)
    from bnn_pynq_tpu_torch.train import trainer
    cfg = get_config("cnv-w1a1")
    n = SHARDED_CAPTURE_STEPS
    xs, ys = (torch.from_numpy(a).to(mesh.device) for a in (xs, ys))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        sides = {}
        for kind in ("captured", "eager"):
            net, tx = init_sharded(cfg, mesh, lr=SHARDED_LR, seed=0)
            step = make_sharded_train_step(cfg, mesh, net, tx)
            sides[kind] = (net, tx, step, step if kind == "captured"
                           else step.eager)
        sides["captured"][1].reserve(4 * n)
        losses = {kind: torch.stack([call(xs[i], ys[i])
                                     for i in range(2 * n)]).cpu()
                  for kind, (_, _, _, call) in sides.items()}
        (nc, txc, stepc, _), (ne, txe, stepe, _) = sides["captured"], \
            sides["eager"]
        assert stepc.captures == 1 and \
            stepc.replays == 2 * n - trainer.WARMUP_STEPS, stepc.replays
        assert torch.equal(losses["captured"], losses["eager"]), losses
        for (k, a), b in zip(nc.state_dict().items(),
                             ne.state_dict().values()):
            assert torch.equal(a, b), f"sharded captured != eager: {k}"
        for a, b in zip(txc.mu + txc.nu, txe.mu + txe.nu):
            assert torch.equal(a, b), "sharded: Adam's moments differ"
        times = {}
        for kind, (_, _, _, call) in sides.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(n):
                call(xs[i], ys[i])
            torch.cuda.synchronize()
            times[kind] = (time.perf_counter() - t0) / n * 1e3
        assert stepc.captures == 1
        net3, tx3 = init_sharded(cfg, mesh, lr=SHARDED_LR, seed=0)
        run = make_sharded_epoch_fn(cfg, mesh, net3, tx3)
        for half in (slice(0, n), slice(n, 2 * n)):
            assert np.array_equal(run(xs[half], ys[half]),
                                  losses["captured"][half].numpy()), \
                f"the epoch != the captured steps at {half}"
        assert run.step.captures == 4, run.step.captures
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(xs[:n], ys[:n])
        times["epoch"] = (time.perf_counter() - t0) / n * 1e3
        assert run.step.captures == 4 and \
            run.step.replays == 3 * n - trainer.WARMUP_STEPS
        # profiled under the deterministic algorithms the graph holds
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            device_ms = {
                "eager": _step_profile(torch, stepe.eager, xs[0], ys[0],
                                       times["eager"]),
                "captured": _step_profile(torch, stepc, xs[0], ys[0],
                                          times["captured"], require=False)}
        assert stepc.captures == 1
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return {"times": times, "device_ms": device_ms,
            "profile": log.getvalue().strip(),
            "losses": [round(float(v), 6) for v in losses["captured"][:3]]}


def _programs_rank(images, xs, ys):
    """Phase 21, in the one rank of an NCCL world on the card: the probe,
    every engine on mesh (1, 1), the swap, the sharded step."""
    import torch
    from bnn_pynq_tpu_torch.compiler.artifacts import load_artifact
    from bnn_pynq_tpu_torch.parallel import make_mesh
    from bnn_pynq_tpu_torch.runtime.engine import (InferenceEngine,
                                                   prepare_host)

    probe = _nccl_capture_probe(torch)
    mesh = make_mesh(data=1, model=1)
    assert mesh.backend == "nccl"
    compiled = load_artifact(_artifact("cnv-w1a1"))
    plain = _count_plain()
    wants = {}
    for route in ("vpu", "mxu", "mega"):
        single = InferenceEngine(compiled, device="cuda", route=route)
        wants[route] = single.logits(images), single.classify(images)
    x = prepare_host(compiled.config, images)
    rows = [_spmd_held(torch, label, _spmd_engine(label, compiled, mesh),
                       mesh, x, wants[SPMD_SINGLE.get(label, "mega")])
            for label in SPMD_ENGINES]
    swap = _spmd_swap(torch, compiled, mesh)
    assert not plain, f"plain versions called: {sorted(set(plain))}"
    return {"probe": probe, "rows": rows, "swap": swap,
            "sharded": _sharded_capture(torch, mesh, xs, ys)}


def _print_spmd_rows(rows, smi, where):
    for row in rows:
        c, e = row["times"]["captured"], row["times"]["eager"]
        first = next(iter(row["runs"].values()))
        replay = b1 = ""
        if "graph_ms" in e:
            replay = f" (eager under graph replay {e['graph_ms']:.4f})"
            b1 = f" (eager under graph replay {e['b1_graph_us']:.2f})"
        pool = "" if "pool_bytes" not in row else (
            f"; its programs' pool {row['pool_bytes'][0]} bytes in "
            f"{row['pool_bytes'][1]} segments")
        print(f"  [{where}] {row['label']}: {len(row['runs'])} programs held "
              f"(batch 1024 and 1) == the eager forward bit for bit, capture "
              f"launches {first['launches']}, library calls "
              f"{first['library']} (no int_matmul_ref) and collectives "
              f"{first['collectives']} == eager's, replayed; == single-card "
              f"engine; enqueue ms captured {c['enqueue_ms']:.4f} / eager "
              f"{e['enqueue_ms']:.4f}; device ms a forward at 1024 captured "
              f"{c['chained_ms']:.4f} / eager {e['chained_ms']:.4f}{replay}; "
              f"batch-1 chained µs captured {c['b1_chained_us']} / eager "
              f"{e['b1_chained_us']}{b1}{pool} ({smi})")


def _spmd_programs_phase(torch, smi):
    """Phase 21: the parallel engines' programs and the captured sharded
    step in a one-rank NCCL world on the card."""
    from bnn_pynq_tpu_torch.parallel.launch import run_world
    from bnn_pynq_tpu_torch.train import data as data_mod
    rng = np.random.default_rng(1)          # phase 4's draws
    images = rng.integers(0, 256, size=(BATCH, 32, 32, 3), dtype=np.uint8)
    ds = data_mod.load("cifar10")
    n = 2 * SHARDED_CAPTURE_STEPS * 50
    xs = data_mod.train_inputs("cifar10", ds.x_train[:n], "int8").reshape(
        (2 * SHARDED_CAPTURE_STEPS, 50, 32, 32, 3))
    ys = ds.y_train[:n].astype(np.int64).reshape(-1, 50)
    t0 = time.perf_counter()
    res = run_world(_programs_rank, 1, args=(images, xs, ys),
                    device="cuda", timeout=PARALLEL_DEADLINE_S)[0]
    print(f"spmd programs: a world of 1 rank (nccl) in "
          f"{time.perf_counter() - t0:.1f} s")
    print(f"  NCCL capture probe: all_reduce, all_gather_into_tensor and a "
          f"batch_isend_irecv pair captured in one graph, replayed "
          f"{res['probe']['replays']} times == the eager calls (a world of "
          f"{res['probe']['world']})")
    _print_spmd_rows(res["rows"], smi, "(1,1) nccl")
    print(f"  swap: load_parameters between two launches of OverlapTPEngine "
          f"ring (1,1): old, then new (captured again), never mixed; "
          f"version {res['swap']['version']}")
    sh = res["sharded"]
    t, dev = sh["times"], sh["device_ms"]
    busy = {k: "not measured (no device event in the trace)" if
            dev[k] is None else f"{dev[k]:.4f} ms a step, busy "
            f"{100 * dev[k] / t[k]:.1f} %" for k in ("captured", "eager")}
    print(f"  captured sharded step: cnv-w1a1 batch 50 on (1,1) nccl, "
          f"{2 * SHARDED_CAPTURE_STEPS} steps ({2} eager, then captured "
          f"once on a table sized first) == the eager steps bit for bit "
          f"(losses {sh['losses']}..., parameters, statistics, moments; "
          f"cudnn.deterministic); make_sharded_epoch_fn from init_sharded's "
          f"one-row table, captured again as the table doubled (4 "
          f"captures), == those steps over two epochs, each fetched once; "
          f"ms a step (host clock, {SHARDED_CAPTURE_STEPS} steps ending in "
          f"a synchronise, no capture among them): captured "
          f"{t['captured']:.3f}, epoch {t['epoch']:.3f}, eager "
          f"{t['eager']:.3f}; device (torch.profiler, deterministic "
          f"algorithms): captured "
          f"{busy['captured']} (the replayed graph's kernels), eager "
          f"{busy['eager']} ({smi})")
    print(f"  {sh['profile']}")
    print("  gloo: the 2-rank gloo worlds of phases 17-18 report their "
          "engines as execution 'eager', with no programs (asserted there)")


# -- phase 22: the decoded-integer routes ------------------------------------

# the nets phase 22 runs from pretrained/ on 'xla' and 'xlaconv'
XLA_NETS = ("cnv-w1a1", "cnv-w2a2", "lfc-w1a1")


def _xla_library(config):
    """The library calls one forward_xla makes, by route: an int8 GEMM a
    dense layer, and a conv layer's on 'xla' (patches) or cuDNN's on
    'xlaconv'; no kernel, no int_matmul_ref."""
    from bnn_pynq_tpu_torch.models.network import make_plan
    kinds = [lp.kind for lp in make_plan(config)]
    convs = sum(k in ("conv", "conv_int8") for k in kinds)
    dense = kinds.count("dense")
    calls = {"xla": {"int_mm": convs + dense},
             "xlaconv": {"int_mm": dense, "conv2d": convs}}
    return {r: {k: n for k, n in c.items() if n} for r, c in calls.items()}


def _xla_held(torch, name, x_all):
    """22.1: one net from pretrained/ at batch 1024 and 1 on 'xla' and
    'xlaconv': int32 accumulators equal runtime="ref"'s (forward_ref),
    'native' equal to 'patches' bit for bit, the library calls counted (no
    kernel launch, no int_matmul_ref), each program (logits, argmax) equal
    to the eager forward at its first use and at a replay, its capture's
    library calls the eager forward's, logits within rtol=atol=1e-5 of
    runtime="ref" and of 'mega' with argmax equal; device ms a forward
    (argmax) under graph replay beside 'mega''s."""
    from bnn_pynq_tpu_torch.models.network import forward_ref, forward_xla
    from bnn_pynq_tpu_torch.runtime.engine import (XLA_ROUTES,
                                                   InferenceEngine, _moved,
                                                   kernel_launches,
                                                   library_calls)
    from bnn_pynq_tpu_torch.tools.layer_times import graph_ms
    ref = InferenceEngine.from_artifact(_artifact(name), device="cuda",
                                        runtime="ref")
    engs = {r: InferenceEngine.from_artifact(_artifact(name), device="cuda",
                                             route=r)
            for r in ("xla", "xlaconv", "mega")}
    want_lib = _xla_library(ref.config)
    row = {"net": name, "library_calls": want_lib}
    for batch in (BATCH, 1):
        xd = ref.upload(ref.prepare(x_all[:batch]))
        want_acc = forward_ref(ref.config, ref._state.params[0], xd)
        want = ref.fetch(ref.launch_prepared(xd))
        mega = engs["mega"].fetch(engs["mega"].launch_prepared(xd))
        accs = {}
        for route, mode in XLA_ROUTES.items():
            eng = engs[route]
            label = f"{name} {route} batch {batch}"
            before, lib_before = kernel_launches(), library_calls()
            accs[route] = forward_xla(eng.config, eng._state.params[0], xd,
                                      conv_mode=mode)
            torch.cuda.synchronize()
            launched = _moved(before, kernel_launches())
            lib = _moved(lib_before, library_calls())
            assert torch.equal(accs[route], want_acc), \
                f"{label}: int32 accumulators != runtime='ref'"
            assert not launched and lib == want_lib[route], \
                f"{label}: launches {launched}, library {lib}"
            for argmax in (False, True):
                want_out = _eager(eng, xd, argmax)
                got = eng.launch_prepared(xd, argmax=argmax)
                again = eng.launch_prepared(xd, argmax=argmax)
                torch.cuda.synchronize()
                assert got.data_ptr() != again.data_ptr(), label
                assert torch.equal(got, want_out) and \
                    torch.equal(again, want_out), \
                    f"{label}: program != eager forward"
                prog = eng.programs[_key(xd, argmax)]
                assert prog.graph is not None and not prog.launches and \
                    prog.library == want_lib[route], \
                    f"{label}: capture {prog.launches} {prog.library}"
            logits = eng.fetch(eng.launch_prepared(xd))
            for other, what in ((want, "ref"), (mega, "mega")):
                np.testing.assert_allclose(logits, other, **TOL)
                assert (logits.argmax(1) == other.argmax(1)).all(), \
                    f"{label}: argmax != {what}"
        assert torch.equal(accs["xla"], accs["xlaconv"]), \
            f"{name} batch {batch}: native != patches"
        for route, eng in engs.items():
            row.setdefault("graph_ms", {}).setdefault(route, {})[batch] = \
                graph_ms(lambda: _eager(eng, xd, True))
    return row


def _xla_layers(torch, smi):
    """22.2: CNV-W1A1 from pretrained/ at batch 1024, a layer at a time
    on 'xla' and 'xlaconv' (profile_layers, graph replay), beside the
    'mega' stage that computes the same layers."""
    from bnn_pynq_tpu_torch.compiler.artifacts import load_artifact
    from bnn_pynq_tpu_torch.utils.layerprof import profile_layers
    compiled = load_artifact(_artifact("cnv-w1a1"))
    rows = {r: profile_layers(compiled, batch=BATCH, iters=20, route=r)
            for r in ("mega", "xla", "xlaconv")}
    print(f"decoded-integer routes, cnv-w1a1 batch {BATCH}, a layer at a "
          f"time under graph replay (profile_layers), beside the mega "
          f"stage of the same layers ({smi}):")
    stages = []
    for st in rows["mega"]:
        idx = st["layers"]
        per = {r: [rows[r][i]["ms"] for i in idx] for r in ("xla",
                                                             "xlaconv")}
        stages.append({"stage": st["stage"], "layers": idx,
                       "mega_ms": st["ms"],
                       **{f"{r}_ms": sum(v) for r, v in per.items()},
                       **{f"{r}_layer_ms": v for r, v in per.items()}})
        print(f"  {st['stage']} (layers {idx}): mega {st['ms']:.4f} ms; "
              f"xla {sum(per['xla']):.4f} "
              f"({', '.join(f'{v:.4f}' for v in per['xla'])}); xlaconv "
              f"{sum(per['xlaconv']):.4f} "
              f"({', '.join(f'{v:.4f}' for v in per['xlaconv'])})")
    totals = {r: sum(x["ms"] for x in rows[r]) for r in rows}
    print(f"  sums: mega {totals['mega']:.4f} ms, xla {totals['xla']:.4f}, "
          f"xlaconv {totals['xlaconv']:.4f}")
    # the layers each hand-written kernel computes on its route, and the
    # decoded-integer route's ms over the same layers (several library
    # calls a layer, not one call)
    kinds = [r["kind"] for r in rows["xla"]]
    spans = {k: [i for st in rows["mega"] if st["stage"].startswith(pre)
                 for i in st["layers"]]
             for k, pre in (("fused_mlp", "mlp_tail"), ("conv_chain", "chain"),
                            ("dense_block", "block"))}
    spans["packed_matmul"] = [i for i, k in enumerate(kinds)
                              if k in ("conv", "dense")]
    spans["conv2d_direct"] = [i for i, k in enumerate(kinds) if k == "conv"]
    # the mega chains take in the pools after them; the direct chains not
    spans["conv_chain_direct"] = [i for i in spans["conv_chain"]
                                  if kinds[i] != "pool"]
    by_kernel = {k: {"layers": idx, **{r: sum(rows[r][i]["ms"] for i in idx)
                                        for r in ("xla", "xlaconv")}}
                 for k, idx in spans.items()}
    print("  over each kernel's layers: " + "; ".join(
        f"{k} (layers {v['layers']}) xla {v['xla']:.4f} ms, xlaconv "
        f"{v['xlaconv']:.4f}" for k, v in by_kernel.items()))
    return stages, totals, by_kernel


def _xla_routes_phase(torch, smi):
    """Phase 22: JAX's decoded-integer routes 'xla' and 'xlaconv' on
    library calls (cuBLASLt's int8 GEMM, cuDNN's float64 conv)."""
    from bnn_pynq_tpu_torch.tools.layer_times import forward_profile
    t0 = time.perf_counter()
    rng = np.random.default_rng(1)          # phase 4's draws
    images = rng.integers(0, 256, size=(BATCH, 32, 32, 3), dtype=np.uint8)
    mnist = rng.integers(0, 256, size=(BATCH, 28, 28), dtype=np.uint8)
    rows = []
    for name in XLA_NETS:
        row = _xla_held(torch, name, images if name.startswith("cnv")
                        else mnist)
        rows.append(row)
        ms = row["graph_ms"]
        print(f"decoded-integer routes {name}: xla and xlaconv at batch "
              f"{BATCH} and 1 == runtime='ref' (int32 accumulators exact, "
              f"logits within 1e-5, argmax) and == mega; native == patches "
              f"bit for bit; library calls a forward {row['library_calls']}"
              f", no kernel, no int_matmul_ref; programs == eager bit for "
              f"bit; device ms a forward under graph replay, batch {BATCH}: "
              + ", ".join(f"{r} {ms[r][BATCH]:.4f}" for r in ms)
              + "; batch 1: " + ", ".join(f"{r} {ms[r][1]:.4f}" for r in ms)
              + f" ({smi})")
    stages, totals, by_kernel = _xla_layers(torch, smi)
    # clocks and heat beside the timings: a card late in a long run reads
    # slower than a fresh one
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,clocks.mem,"
         "temperature.gpu,power.draw", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(f"decoded-integer routes: the card after the timings (clocks.sm, "
          f"clocks.max.sm, clocks.mem, temperature.gpu, power.draw): {card}")
    for route in ("xla", "xlaconv"):
        _graph_pool_bytes(torch, route)
        forward_profile(torch.device("cuda", 0), "cnv-w1a1", route)
    print("decoded-integer routes " + json.dumps(
        {"device": smi, "forwards": rows, "stages": stages,
         "stage_sums": totals, "by_kernel": by_kernel, "card": card}))
    print(f"decoded-integer routes: {time.perf_counter() - t0:.1f} s")


def _spread_programs_rank(images, shapes):
    """--spread, in each rank of an NCCL world of one rank a card: the
    NCCL capture probe over every card, then per mesh shape every engine
    held as in 21.2, real collectives in its graphs."""
    import torch
    from bnn_pynq_tpu_torch.compiler.artifacts import load_artifact
    from bnn_pynq_tpu_torch.parallel import make_mesh
    from bnn_pynq_tpu_torch.runtime.engine import (InferenceEngine,
                                                   prepare_host)

    probe = _nccl_capture_probe(torch)
    compiled = load_artifact(_artifact("cnv-w1a1"))
    device = torch.device("cuda", torch.cuda.current_device())
    wants = {}
    for route in ("vpu", "mxu", "mega"):
        single = InferenceEngine(compiled, device=device, route=route)
        wants[route] = single.logits(images), single.classify(images)
    x = prepare_host(compiled.config, images)
    out = {"probe": probe, "meshes": []}
    for data, model in shapes:
        mesh = make_mesh(data=data, model=model)
        assert mesh.backend == "nccl"
        rows = [_spmd_held(torch, label,
                           _spmd_engine(label, compiled, mesh), mesh, x,
                           wants[SPMD_SINGLE.get(label, "mega")],
                           graph=False)
                for label in SPMD_ENGINES]
        out["meshes"].append({"mesh": (data, model), "rows": rows})
    return out


def _spread_programs(torch, smi, cards):
    """--spread: the engines' programs in an NCCL world of one rank a
    card on meshes (1, cards) and (cards / 2, 2)."""
    from bnn_pynq_tpu_torch.parallel.launch import run_world
    images = np.random.default_rng(1).integers(
        0, 256, size=(BATCH, 32, 32, 3), dtype=np.uint8)
    shapes = list(dict.fromkeys([(1, cards), (cards // 2, 2)]))
    t0 = time.perf_counter()
    res = run_world(_spread_programs_rank, cards, args=(images, shapes),
                    device="cuda", timeout=PARALLEL_DEADLINE_S)
    print(f"spmd programs spread: an nccl world of {cards} ranks, one a "
          f"card, in {time.perf_counter() - t0:.1f} s; the NCCL capture "
          f"probe held on every rank (a world of {res[0]['probe']['world']})")
    for i, (data, model) in enumerate(shapes):
        for rank, out in enumerate(res):
            rows = {r["label"]: r for r in out["meshes"][i]["rows"]}
            ring = next(iter(rows["OverlapTPEngine ring"]["runs"].values()))
            block = next(iter(
                rows["OverlapTPEngine blocking"]["runs"].values()))
            assert ring["collectives"].get("ppermute"), ring
            assert block["collectives"].get("all_gather") and \
                not block["collectives"].get("ppermute"), block
            if rank == 0:
                _print_spmd_rows(out["meshes"][i]["rows"], smi,
                                 f"({data},{model}) nccl, rank 0")
        r0 = {r["label"]: r["times"] for r in res[0]["meshes"][i]["rows"]}
        ring, block = (r0[f"OverlapTPEngine {arm}"]
                       for arm in ("ring", "blocking"))
        print(f"  ring against blocking on ({data},{model}), rank 0, device "
              f"ms a forward at 1024 captured: ring "
              f"{ring['captured']['chained_ms']:.4f}, blocking "
              f"{block['captured']['chained_ms']:.4f}; eager: ring "
              f"{ring['eager']['chained_ms']:.4f}, blocking "
              f"{block['eager']['chained_ms']:.4f} ({smi})")


# -- phase 23: strided convs, conv_chain on prebuilt patches ----------------

def _strided_configs():
    """Phase 23's strided nets (tests/test_torch_input_patches.py holds
    the same topologies against JAX): a strided conv on the image chained
    with a stride-1 conv, and a strided conv on codes after a pool; W1A1
    and W2A2."""
    from bnn_pynq_tpu_torch.models.config import (ConvSpec, DenseSpec,
                                                  NetworkConfig, PoolSpec)
    nets = []
    for wbits, abits in ((1, 1), (2, 2)):
        nets.append(NetworkConfig(
            name=f"strided-first-w{wbits}a{abits}", wbits=wbits,
            abits=abits, input_kind="int8", input_shape=(33, 33, 3),
            layers=(ConvSpec(64, stride=2), ConvSpec(64), PoolSpec(),
                    ConvSpec(128), DenseSpec(256), DenseSpec(10)),
            num_classes=10, dataset="cifar10"))
        nets.append(NetworkConfig(
            name=f"strided-pool-w{wbits}a{abits}", wbits=wbits,
            abits=abits, input_kind="int8", input_shape=(32, 32, 3),
            layers=(ConvSpec(64), ConvSpec(64), PoolSpec(),
                    ConvSpec(128, stride=2), ConvSpec(128),
                    DenseSpec(256), DenseSpec(10)),
            num_classes=10, dataset="cifar10"))
    return nets


STRIDED_STAGES = {
    "strided-first": ["im2col0", "chain0-1+pool2", "block3", "mlp_tail"],
    "strided-pool": ["chain0-1+pool2", "im2col3", "chain3-4", "mlp_tail"]}


def _patch_cases(torch, device, images, smi):
    """23(a)-(b): CNV-W1A1's conv0-1 from pretrained/ on prebuilt patches
    of phase 4's images at batch 1024, stride 1 (JAX's layout of the
    route's first chain) and 2; exact against the plain version, the full
    grid of conv_chain_vmem against the valid region. Returns the rows
    for conv_chain's `input_patches` entry."""
    from bnn_pynq_tpu_torch.compiler.artifacts import load_artifact
    from bnn_pynq_tpu_torch.models.params import params_from_numpy
    from bnn_pynq_tpu_torch.ops import conv_stack
    from bnn_pynq_tpu_torch.ops.conv import sliding_window
    from bnn_pynq_tpu_torch.runtime.engine import prepare_host
    from bnn_pynq_tpu_torch.tools.layer_times import graph_ms
    c = load_artifact(_artifact("cnv-w1a1"))
    layers, _, _ = params_from_numpy(c.config, c.layers, c.out_scale,
                                     c.out_bias, device)
    x = torch.from_numpy(prepare_host(c.config, images)).to(device)
    route_kw = dict(weights=[layers[0]["w"], layers[1]["w"]],
                    thresholds=[layers[0]["thr"], layers[1]["thr"]],
                    kernel=3, abits=c.config.abits, input_levels=True)
    kw = dict(route_kw, input_patches=True)
    rows = []
    for stride in (1, 2):
        patches = sliding_window(x, 3, 3, stride)
        label = (f"cnv-w1a1 conv0-1 on patches {tuple(patches.shape)}, "
                 f"stride {stride}")

        def kern(p=patches):
            return conv_stack.conv_chain(p, **kw)

        def plain(p=patches):
            return conv_stack.conv_chain_plain(p, **kw)

        def vmem(p=patches):
            return conv_stack.conv_chain_vmem(p, **kw)

        got, want, full = kern(), plain(), vmem()
        torch.cuda.synchronize()
        vh = got.shape[1]
        assert got.shape == want.shape == (BATCH, vh, vh, 64), label
        assert torch.equal(got, want), f"{label}: kernel != plain"
        assert full.shape == patches.shape[:3] + (64,) and \
            torch.equal(full[:, :vh, :vh], got) and \
            not full[:, vh:].any().item() and \
            not full[:, :, vh:].any().item(), \
            f"{label}: conv_chain_vmem's grid != the valid region, zero"
        gh = patches.shape[1]
        work = _work([(BATCH * gh * gh, 27, 64), (BATCH * vh * vh, 576, 64)],
                     patches, *_kn(route_kw["weights"]),
                     *route_kw["thresholds"])
        ops_ms, bytes_ms = _bounds(work, got)
        row = {"case": label, "stride": stride,
               "ms": _time_ms(torch, kern), "graph_ms": graph_ms(kern),
               "vmem_graph_ms": graph_ms(vmem),
               "plain_ms": _time_ms(torch, plain),
               "bound_ms": max(ops_ms, bytes_ms),
               "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
               "int_mm_ms": _int_mm_ms(torch, device, work["gemms"])}
        beside = ""
        if stride == 1:
            # JAX's layout of the route's first chain against the route's
            def route():
                return conv_stack.conv_chain(x, **route_kw)

            def with_im2col():
                return conv_stack.conv_chain(sliding_window(x, 3, 3, 1),
                                             **kw)

            assert torch.equal(route(), got), f"{label}: != chain0-1"
            row.update(route_graph_ms=graph_ms(route),
                       with_im2col_graph_ms=graph_ms(with_im2col),
                       im2col_graph_ms=graph_ms(
                           lambda: sliding_window(x, 3, 3, 1)))
            beside = (f"; with the im2col0 stage "
                      f"{row['with_im2col_graph_ms']:.4f} (im2col0 alone "
                      f"{row['im2col_graph_ms']:.4f}) "
                      f"against the route's chain0-1 on the image "
                      f"{row['route_graph_ms']:.4f}, which it equals")
        print(f"conv_chain {label}: == plain (codes) and conv_chain_vmem's "
              f"valid region, its border zero; kernel {row['ms']:.4f} ms "
              f"(graph replay {row['graph_ms']:.4f}; conv_chain_vmem "
              f"{row['vmem_graph_ms']:.4f}), plain {row['plain_ms']:.4f}, "
              f"bound {row['bound_ms']:.5f} ({row['bound_by']}), int_mm "
              f"{row['int_mm_ms']:.4f}{beside} ({smi})")
        rows.append(row)
    return rows


def _strided_overlap_rank(nets):
    """23(c), in the one rank of an NCCL world: OverlapTPEngine ring and
    blocking on mesh (1, 1) for each strided net; their logits."""
    from bnn_pynq_tpu_torch.parallel import make_mesh
    from bnn_pynq_tpu_torch.parallel.overlap import OverlapTPEngine
    mesh = make_mesh(data=1, model=1)
    assert mesh.backend == "nccl"
    out = {}
    for name, compiled, x in nets:
        for arm in ("ring", "blocking"):
            eng = OverlapTPEngine(compiled, mesh, arm=arm)
            out[f"{name} {arm}"] = (eng.logits(x, prepared=True),
                                    eng.execution)
            eng.close()
    return out


def _strided_engines(torch, device, smi):
    """23(c): the strided nets on 'mega' and 's2d' at batch 1024 against
    runtime="ref", their programs against the eager forward, the launches
    counted from 0 around them; a ring step's strided partials; the
    overlap engine's arms in a one-rank NCCL world."""
    from bnn_pynq_tpu_torch.compiler.artifacts import CompiledNetwork
    from bnn_pynq_tpu_torch.models.network import (LayerPlan,
                                                   init_random_params,
                                                   mega_stages)
    from bnn_pynq_tpu_torch.models.params import weight_matrix
    from bnn_pynq_tpu_torch.ops import (conv_direct, conv_stack, fused_mlp,
                                        thresholds)
    from bnn_pynq_tpu_torch.parallel.launch import run_world
    from bnn_pynq_tpu_torch.parallel.overlap import conv_partial
    from bnn_pynq_tpu_torch.runtime.engine import InferenceEngine
    from bnn_pynq_tpu_torch.tools.layer_times import graph_ms
    rng = np.random.default_rng(23)
    counters = {"conv_chain": conv_stack.conv_chain.launches,
                "dense_block": conv_stack.dense_block.launches,
                "fused_mlp": fused_mlp.fused_mlp_forward.launches,
                "pooled_epilogue": thresholds.pooled_epilogue}
    nets, singles = [], {}
    for c in counters.values():
        c.reset()
    for cfg in _strided_configs():
        compiled = CompiledNetwork(
            cfg, init_random_params(cfg, seed=23),
            rng.uniform(0.01, 1.0, size=10).astype(np.float32),
            rng.standard_normal(10).astype(np.float32))
        images = rng.integers(0, 256, size=(BATCH,) + cfg.input_shape,
                              dtype=np.uint8)
        ref = InferenceEngine(compiled, device="cuda", runtime="ref")
        want, want_cls = ref.logits(images), ref.classify(images)
        times = {}
        for route in ("mega", "s2d"):
            eng = InferenceEngine(compiled, device="cuda", route=route)
            label = f"{cfg.name} {route}"
            names = [n for n, _ in mega_stages(cfg, *eng._state.params,
                                               fuse_pools=True)]
            assert names == STRIDED_STAGES[cfg.name.rsplit("-", 1)[0]], \
                f"{label}: stages {names}"
            got, cls = eng.logits(images), eng.classify(images)
            assert np.isfinite(got).all() and \
                got.shape == (BATCH, cfg.num_classes), label
            np.testing.assert_allclose(got, want, **TOL)
            assert (got.argmax(1) == want.argmax(1)).all() and \
                (cls == want_cls).all(), f"{label}: argmax or classify"
            # logits and classify of uint8 made the raw upload's programs
            xd, xr = eng.upload(eng.prepare(images)), eng.upload(images)
            for argmax in (False, True):
                prog = _hold_program(torch, eng, _key(xr, argmax), label)
                want_out = _eager(eng, xd, argmax)
                assert torch.equal(eng.launch_prepared(xr, argmax=argmax),
                                   want_out) and \
                    torch.equal(_eager(eng, xr, argmax), want_out), \
                    f"{label}: program != eager forward"
                assert prog.launches["conv_chain"] > 0, label
            times[route] = graph_ms(lambda: _eager(eng, xd, True))
            if route == "mega":
                singles[cfg.name] = got
                nets.append((cfg.name, compiled, eng.prepare(images)))
        print(f"strided {cfg.name}: stages {names}; mega and s2d at batch "
              f"{BATCH} == runtime='ref' (logits within 1e-5, argmax, "
              f"classify), programs == eager bit for bit; device ms a "
              f"forward under graph replay mega {times['mega']:.4f}, s2d "
              f"{times['s2d']:.4f} ({smi})")
    launches = {k: c.value for k, c in counters.items()}
    for k, n in launches.items():
        assert n > 0, f"the strided path never launched {k}"
    print(f"strided path: kernel launches {launches} (4 nets x 2 routes, "
          f"eager runs and captures; counted from 0)")
    # a ring step's strided partials: int32 at kernel 1 on patches of a
    # channel block (widths no multiple of 32: the gather path)
    before = conv_direct.conv2d_direct.launches.value
    for abits in (1, 2):
        lp = LayerPlan(kind="conv", k=9 * 16, n=64, kernel=3, stride=2)
        codes = rng.integers(0, 2 ** abits, size=(BATCH, 17, 17, 16)) \
            .astype(np.int8)
        levels = rng.choice([-1, 1] if abits == 1 else [-3, -1, 1, 3],
                            size=(9 * 16, 64)).astype(np.int8)
        want = conv_partial(torch.from_numpy(codes),
                            weight_matrix(torch.from_numpy(levels)), lp,
                            abits)
        got = conv_partial(torch.from_numpy(codes).to(device),
                           weight_matrix(torch.from_numpy(levels).to(device)),
                           lp, abits)
        assert got.dtype == torch.int32 and torch.equal(got.cpu(), want), \
            f"conv_partial abits {abits}: card != CPU"
    assert conv_direct.conv2d_direct.launches.value == before + 2
    print(f"ring step on a strided conv (overlap.conv_partial): codes "
          f"[{BATCH}, 17, 17, 16] at stride 2, conv2d_direct at kernel 1 "
          f"on 144-lane patches, int32 == the CPU's, abits 1 and 2")
    t0 = time.perf_counter()
    res = run_world(_strided_overlap_rank, 1, args=(nets,), device="cuda",
                    timeout=PARALLEL_DEADLINE_S)[0]
    for key, (logits, execution) in res.items():
        want = singles[key.split(" ")[0]]
        np.testing.assert_allclose(logits, want, **TOL)
        assert (logits.argmax(1) == want.argmax(1)).all() and \
            execution == "graphs", key
    print(f"strided OverlapTPEngine: ring and blocking on (1,1) nccl, "
          f"captured, == the single-card mega engine for the 4 nets "
          f"(a world of 1 rank in {time.perf_counter() - t0:.1f} s)")
    return launches


def _strided_phase(torch, smi):
    """Phase 23: conv_chain on prebuilt patches, and strided nets on the
    mega route, its captured programs and OverlapTPEngine."""
    t0 = time.perf_counter()
    device = torch.device("cuda", 0)
    rng = np.random.default_rng(1)          # phase 4's draws
    images = rng.integers(0, 256, size=(BATCH, 32, 32, 3), dtype=np.uint8)
    rows = _patch_cases(torch, device, images, smi)
    launches = _strided_engines(torch, device, smi)
    print("strided convs " + json.dumps({"device": smi, "patches": rows,
                                         "launches": launches}))
    print(f"strided convs: {time.perf_counter() - t0:.1f} s")
    return rows, launches


# -- phase 24: MobileNet-v1 W4A4 ---------------------------------------------

MOBILENET = os.path.join(HERE, "portbench", "configs", "mobilenetv1-w4a4.npz")
MOBILENET_BATCH = 256         # the batch of the benchmark's resident cell
# the kernel launches of one MobileNet-v1 forward on 'mega': the image conv
# on its patches, 13 depthwise and 13 pointwise convs, the classifier
MOBILENET_LAUNCHES = {"conv_chain": 1, "depthwise_conv": 13,
                      "dense_block": 13, "fused_mlp": 1}
# the launches whose epilogue searches 15 sorted thresholds: the 13 1×1
# convs and the image conv (the depthwise kernel keeps its own compares)
MOBILENET_SEARCHES = 14


def _mobilenet_stage_cases(torch, act, stages):
    """(stage name, kernel name, wrapper fn, plain fn, kernel input, work)
    for each stage of MobileNet's 'mega' forward that launches a kernel,
    on `act`, the input of its first stage; `stages` walk on as each case
    runs, each fed the previous stage's output (the prebuilt patches and
    the pool are tensor ops, run between the cases)."""
    from bnn_pynq_tpu_torch.ops import conv_stack, depthwise, fused_mlp
    for name, fn in stages:
        kw = dict(fn.keywords)
        if name.startswith("dw"):
            arg, kname = act, "depthwise_conv"
            kern, plain = (depthwise.depthwise_conv,
                           depthwise.depthwise_conv_plain)
            b, h, w, c = act.shape
            oh, ow = -(-h // kw["stride"]), -(-w // kw["stride"])
            work = _work([], act, kw["w"].kn, kw["thr"],
                         ops=2 * 9 * b * oh * ow * c)
        elif name.startswith("pw"):
            arg, kname = act.reshape(-1, act.shape[-1]), "dense_block"
            kern, plain = conv_stack.dense_block, conv_stack.dense_block_plain
            kw = dict(weights=[kw["w"]], thresholds=[kw["thr"]],
                      abits=kw["abits"])
            work = _work(_dense_gemms(len(arg), kw["weights"]), arg,
                         kw["weights"][0].kn, kw["thresholds"][0])
        elif name.startswith("chain"):
            arg, kname = act, "conv_chain"
            kern, plain = conv_stack.conv_chain, conv_stack.conv_chain_plain
            b, oh, ow, k = act.shape
            work = _work([(b * oh * ow, k, kw["weights"][0].kn.shape[1])],
                         act, kw["weights"][0].kn, kw["thresholds"][0])
        elif name == "mlp_tail":
            arg, kname = act.reshape(act.shape[0], -1), "fused_mlp"
            kern, plain = (fused_mlp.fused_mlp_forward,
                           fused_mlp.fused_mlp_forward_plain)
            work = _work(_dense_gemms(len(arg), kw["weights"]), arg,
                         *_kn(kw["weights"]), kw["out_scale"],
                         kw["out_bias"])
        else:
            act = fn(act)
            continue
        yield (name, kname, functools.partial(kern, arg, **kw),
               functools.partial(plain, arg, **kw), arg, work)
        act = fn(act)


def _mobilenet_phase(torch, smi):
    """Phase 24: MobileNet-v1 W4A4 at batch 256 (the benchmark's
    `mobilenetv1-w4a4.resident`): each kernel stage of its 'mega' forward
    bit for bit against its plain version on the stage's own input, timed;
    then InferenceEngine on 'mega', its captured program's launches (the
    counters zeroed just before its first use), logits equal to the stage
    walk's and to runtime='ref' on the card, classes and uint8 pixels.
    Returns (the depthwise kernel's row result, its launches)."""
    from bnn_pynq_tpu_torch.compiler.artifacts import load_artifact
    from bnn_pynq_tpu_torch.models.network import mega_stages, prepare_input
    from bnn_pynq_tpu_torch.models.params import params_from_numpy
    from bnn_pynq_tpu_torch.ops import (conv_stack, depthwise, fused_mlp,
                                        thresholds)
    from bnn_pynq_tpu_torch.runtime.engine import InferenceEngine
    from bnn_pynq_tpu_torch.tools.layer_times import graph_ms
    t0 = time.perf_counter()
    device = torch.device("cuda", 0)
    compiled = load_artifact(MOBILENET)
    cfg = compiled.config
    layers, scale, bias = params_from_numpy(
        cfg, compiled.layers, compiled.out_scale, compiled.out_bias, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(3_000_000_241)
    x = torch.randint(-128, 128, (MOBILENET_BATCH,) + cfg.input_shape,
                      dtype=torch.int8, device=device, generator=gen)

    # -- 24(a): the kernels against their plain versions, stage by stage --
    sums = {k: _new_result() for k in MOBILENET_LAUNCHES}
    walked = None
    for name, kname, kern, plain, arg, work in _mobilenet_stage_cases(
            torch, prepare_input(cfg, x),
            mega_stages(cfg, layers, scale, bias)):
        got, want = kern(), plain()
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and torch.equal(got, want), \
            f"mobilenet {name}: {kname} != plain"
        if got.dtype == torch.int8:
            assert 0 <= int(got.min()) and int(got.max()) <= 15, name
        ms, replay_ms = _time_ms(torch, kern), graph_ms(kern)
        plain_ms = _time_ms(torch, plain, calls=1)
        r = sums[kname]
        ops_ms, bytes_ms = _bounds(work, got)
        for key, v in (("ms", ms), ("plain_ms", plain_ms),
                       ("ops_ms", ops_ms), ("bytes_ms", bytes_ms),
                       ("bound_ms", max(ops_ms, bytes_ms))):
            r[key] += v
        r["graph_ms"] = (r["graph_ms"] or 0.0) + replay_ms
        print(f"mobilenet {name} {kname} {tuple(arg.shape)}: == plain; "
              f"kernel {ms:.4f} ms (graph replay {replay_ms:.4f}), plain "
              f"{plain_ms:.4f}, bound {max(ops_ms, bytes_ms):.5f} "
              f"({'operations' if ops_ms >= bytes_ms else 'bytes'})")
        walked = got
    for kname, r in sums.items():
        print(f"mobilenet {kname}, its {MOBILENET_LAUNCHES[kname]} "
              f"layer(s) at batch {MOBILENET_BATCH}: kernel {r['ms']:.4f} "
              f"ms (graph replay {r['graph_ms']:.4f}), plain "
              f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.5f} "
              f"(operations {r['ops_ms']:.5f}, bytes {r['bytes_ms']:.5f}) "
              f"({smi})")

    # -- 24(b): the engine's captured program ------------------------------
    counters = {"conv_chain": conv_stack.conv_chain.launches,
                "depthwise_conv": depthwise.depthwise_conv.launches,
                "dense_block": conv_stack.dense_block.launches,
                "fused_mlp": fused_mlp.fused_mlp_forward.launches,
                "threshold_search": thresholds.threshold_search}
    want = dict(MOBILENET_LAUNCHES, threshold_search=MOBILENET_SEARCHES)
    eng = InferenceEngine(compiled, device="cuda", route="mega")
    for c in counters.values():
        c.reset()
    pooled = thresholds.pooled_epilogue.value
    logits = eng.fetch(eng.launch_prepared(x))
    torch.cuda.synchronize()
    launches = {k: c.value for k, c in counters.items()}
    # no 2×2 max-pool follows any of its convs
    assert thresholds.pooled_epilogue.value == pooled, "a pooled epilogue"
    prog = _hold_program(torch, eng, ((MOBILENET_BATCH,) + cfg.input_shape,
                                      torch.int8, False, False),
                         "mobilenet")
    assert prog.launches == want, prog.launches
    assert launches == {k: 2 * n for k, n in want.items()}, launches
    np.testing.assert_array_equal(logits, walked.cpu().numpy())
    ref = InferenceEngine(compiled, device="cuda", runtime="ref")
    np.testing.assert_array_equal(ref.fetch(ref.launch_prepared(x)), logits)
    cls = eng.fetch(eng.launch_prepared(x, argmax=True))
    np.testing.assert_array_equal(cls, logits.argmax(1))
    pixels = (x.cpu().numpy().view(np.uint8) ^ 0x80)       # p - 128 == x
    np.testing.assert_array_equal(eng.classify(pixels), cls)
    print(f"mobilenet engine 'mega' batch {MOBILENET_BATCH}: launches "
          f"{launches} (the eager run before the capture and the capture); "
          f"the program's capture {prog.launches} == the eager forward's; "
          f"logits == the stage walk's == runtime='ref' bit for bit, "
          f"argmax and classify of the uint8 pixels equal; "
          f"{time.perf_counter() - t0:.1f} s")
    return sums["depthwise_conv"], launches["depthwise_conv"]


# -- phase 25: ResNet-50 v1.5 W1A2 -------------------------------------------

RESNET = os.path.join(HERE, "portbench", "configs", "resnet50-w1a2.npz")
RESNET_BATCH = 256            # the batch of the benchmark's resident cell
# the kernel launches of one ResNet-50 forward on 'mega': conv1 on its
# patches and the 13 stride-1 3×3 convs (conv_chain); each block's first
# 1×1 conv, the 3 strided 3×3 convs on their patches' rows and the 16
# block-closing 1×1 convs with their shortcut (dense_block's kernel); the
# classifier; the 16 launches whose epilogue adds a shortcut
RESNET_LAUNCHES = {"conv_chain": 14, "dense_block": 35, "fused_mlp": 1,
                   "residual_epilogue": 16}


def _resnet_check(torch, label, kname, kern, plain, work, sums):
    """One kernel call of ResNet's forward: bit for bit its plain
    version's, unsigned 2-bit codes, timed by events and under graph
    replay beside its plain time and its bound, added to `sums[kname]`.
    Returns the kernel's output."""
    from bnn_pynq_tpu_torch.tools.layer_times import graph_ms
    got, want = kern(), plain()
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and torch.equal(got, want), \
        f"resnet {label}: {kname} != plain"
    if got.dtype == torch.int8:
        assert 0 <= int(got.min()) and int(got.max()) <= 3, label
    ms, replay_ms = _time_ms(torch, kern), graph_ms(kern)
    plain_ms = _time_ms(torch, plain, calls=1)
    ops_ms, bytes_ms = _bounds(work, got)
    r = sums[kname]
    for key, v in (("ms", ms), ("plain_ms", plain_ms), ("ops_ms", ops_ms),
                   ("bytes_ms", bytes_ms),
                   ("bound_ms", max(ops_ms, bytes_ms))):
        r[key] += v
    r["graph_ms"] = (r["graph_ms"] or 0.0) + replay_ms
    r["calls"] = r.get("calls", 0) + 1
    print(f"resnet {label} {kname}: == plain; kernel {ms:.4f} ms (graph "
          f"replay {replay_ms:.4f}), plain {plain_ms:.4f}, bound "
          f"{max(ops_ms, bytes_ms):.5f} "
          f"({'operations' if ops_ms >= bytes_ms else 'bytes'})")
    return got


def _resnet_block(torch, name, x, kw, sums):
    """The three kernel calls of bottleneck stage `name` (`_bottleneck`)
    on its input codes x, each checked and timed by `_resnet_check`: the
    first 1×1 conv (dense_block), the 3×3 conv (stride 1: conv_chain over
    the map padded with code 0; stride 2: dense_block on the rows of the
    padded map's patches) and the block-closing 1×1 conv with its
    shortcut (dense_residual). Returns the block's output codes."""
    from bnn_pynq_tpu_torch.models.network import _padded_patches
    from bnn_pynq_tpu_torch.ops import conv_stack
    p, stride, proj = kw["p"], kw["stride"], kw["projection"]
    b, h, w, c = x.shape
    lv = dict(abits=kw["abits"], input_levels=True)

    def dense(label, rows, wt, thr):
        args = (rows, [wt], [thr])
        return _resnet_check(
            torch, f"{name}.{label} {tuple(rows.shape)}", "dense_block",
            functools.partial(conv_stack.dense_block, *args, **lv),
            functools.partial(conv_stack.dense_block_plain, *args, **lv),
            _work(_dense_gemms(len(rows), [wt]), rows, wt.kn, thr), sums)
    a = dense("a", x.reshape(-1, c), p["wa"], p["thr_a"])
    mid = a.shape[-1]
    a = a.reshape(b, h, w, mid)
    if stride == 1:
        inp = torch.nn.functional.pad(a, (0, 0, 1, 1, 1, 1))
        args = (inp, [p["wb"]], [p["thr_b"]])
        out = _resnet_check(
            torch, f"{name}.b {tuple(inp.shape)}", "conv_chain",
            functools.partial(conv_stack.conv_chain, *args, kernel=3, **lv),
            functools.partial(conv_stack.conv_chain_plain, *args, kernel=3,
                              **lv),
            _work([(b * h * w, 9 * mid, mid)], inp, p["wb"].kn,
                  p["thr_b"]), sums)
    else:
        out = dense("b", _padded_patches(a, kernel=3, stride=stride, pad=1)
                    .reshape(-1, 9 * mid), p["wb"], p["thr_b"])
    rows = out.reshape(-1, mid)
    args = (rows, x, p["wc"], p["r"], p["thr"])
    sc = dict(stride=stride, projection=proj)
    # the shortcut's bytes: x's codes at the output's pixels
    y = _resnet_check(
        torch, f"{name}.c {'projection' if proj else 'identity'} "
        f"{tuple(rows.shape)}", "dense_residual",
        functools.partial(conv_stack.dense_residual, *args, **sc),
        functools.partial(conv_stack.dense_residual_plain, *args, **sc),
        _work(_dense_gemms(len(rows), [p["wc"]]), rows,
              x[:, ::stride, ::stride], p["wc"].kn, p["r"], p["thr"]),
        sums)
    return y.reshape(b, (h - 1) // stride + 1, (w - 1) // stride + 1, -1)


def _resnet_phase(torch, smi):
    """Phase 25: ResNet-50 v1.5 W1A2 at batch 256 (the benchmark's
    `resnet50-w1a2.resident`): each kernel call of its 'mega' forward bit
    for bit against its plain version on the call's own input, timed;
    then InferenceEngine on 'mega', its captured program's launches (the
    counters zeroed just before its first use), logits equal to the walk's
    and to runtime='ref' on the card, classes and uint8 pixels. Returns
    (dense_residual's row result, its launches)."""
    from bnn_pynq_tpu_torch.compiler.artifacts import load_artifact
    from bnn_pynq_tpu_torch.models.network import mega_stages, prepare_input
    from bnn_pynq_tpu_torch.models.params import params_from_numpy
    from bnn_pynq_tpu_torch.ops import conv_stack, fused_mlp, thresholds
    from bnn_pynq_tpu_torch.runtime.engine import InferenceEngine
    t0 = time.perf_counter()
    device = torch.device("cuda", 0)
    compiled = load_artifact(RESNET)
    cfg = compiled.config
    layers, scale, bias = params_from_numpy(
        cfg, compiled.layers, compiled.out_scale, compiled.out_bias, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(3_000_000_253)
    x = torch.randint(-128, 128, (RESNET_BATCH,) + cfg.input_shape,
                      dtype=torch.int8, device=device, generator=gen)

    # -- 25(a): the kernels against their plain versions, call by call -----
    sums = {k: _new_result() for k in ("conv_chain", "dense_block",
                                       "dense_residual", "fused_mlp")}
    act = prepare_input(cfg, x)
    for name, fn in mega_stages(cfg, layers, scale, bias):
        kw = dict(fn.keywords)
        if name.startswith("res"):
            act = _resnet_block(torch, name, act, kw, sums)
        elif name.startswith("chain"):
            b, oh, ow, k = act.shape
            w, thr = kw.pop("weights")[0], kw.pop("thresholds")[0]
            args = (act, [w], [thr])
            act = _resnet_check(
                torch, f"{name} {tuple(act.shape)}", "conv_chain",
                functools.partial(conv_stack.conv_chain, *args, **kw),
                functools.partial(conv_stack.conv_chain_plain, *args, **kw),
                _work([(b * oh * ow, k, w.kn.shape[1])], act, w.kn, thr),
                sums)
        elif name == "mlp_tail":
            rows = act.reshape(act.shape[0], -1)
            act = _resnet_check(
                torch, f"{name} {tuple(rows.shape)}", "fused_mlp",
                functools.partial(fused_mlp.fused_mlp_forward, rows, **kw),
                functools.partial(fused_mlp.fused_mlp_forward_plain, rows,
                                  **kw),
                _work(_dense_gemms(len(rows), kw["weights"]), rows,
                      *_kn(kw["weights"]), kw["out_scale"], kw["out_bias"]),
                sums)
        else:
            act = fn(act)
    walked = act
    for kname, r in sums.items():
        print(f"resnet {kname}, its {r['calls']} call(s) at "
              f"batch {RESNET_BATCH}: kernel {r['ms']:.4f} ms (graph replay "
              f"{r['graph_ms']:.4f}), plain {r['plain_ms']:.4f}, bound "
              f"{r['bound_ms']:.5f} (operations {r['ops_ms']:.5f}, bytes "
              f"{r['bytes_ms']:.5f}) ({smi})")

    # -- 25(b): the engine's captured program ------------------------------
    counters = {"conv_chain": conv_stack.conv_chain.launches,
                "dense_block": conv_stack.dense_block.launches,
                "fused_mlp": fused_mlp.fused_mlp_forward.launches,
                "residual_epilogue": thresholds.residual_epilogue}
    eng = InferenceEngine(compiled, device="cuda", route="mega")
    for c in counters.values():
        c.reset()
    others = (thresholds.pooled_epilogue.value,
              thresholds.threshold_search.value)
    logits = eng.fetch(eng.launch_prepared(x))
    torch.cuda.synchronize()
    launches = {k: c.value for k, c in counters.items()}
    # no pooled epilogue, no 15-threshold search: 2-bit codes, no 2×2 pool
    assert (thresholds.pooled_epilogue.value,
            thresholds.threshold_search.value) == others, "pooled or wide"
    prog = _hold_program(torch, eng, ((RESNET_BATCH,) + cfg.input_shape,
                                      torch.int8, False, False), "resnet")
    assert prog.launches == RESNET_LAUNCHES, prog.launches
    assert launches == {k: 2 * n for k, n in RESNET_LAUNCHES.items()}, \
        launches
    np.testing.assert_array_equal(logits, walked.cpu().numpy())
    ref = InferenceEngine(compiled, device="cuda", runtime="ref")
    np.testing.assert_array_equal(ref.fetch(ref.launch_prepared(x)), logits)
    cls = eng.fetch(eng.launch_prepared(x, argmax=True))
    np.testing.assert_array_equal(cls, logits.argmax(1))
    pixels = (x.cpu().numpy().view(np.uint8) ^ 0x80)       # p - 128 == x
    np.testing.assert_array_equal(eng.classify(pixels), cls)
    print(f"resnet engine 'mega' batch {RESNET_BATCH}: launches {launches} "
          f"(the eager run before the capture and the capture); the "
          f"program's capture {prog.launches} == the eager forward's; "
          f"logits == the walk's == runtime='ref' bit for bit, argmax and "
          f"classify of the uint8 pixels equal; "
          f"{time.perf_counter() - t0:.1f} s")
    del eng, ref
    torch.cuda.empty_cache()
    return sums["dense_residual"], launches["residual_epilogue"]


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
    from bnn_pynq_tpu_torch import native
    from bnn_pynq_tpu_torch.ops import (_build, conv_direct, conv_stack,
                                        fused_mlp, matmul, thresholds)
    from bnn_pynq_tpu_torch.runtime.engine import (InferenceEngine,
                                                   library_calls)
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
    # the host library, on a fresh tree not built yet
    if native.build():
        print("host library: native/libbnn_host.so built and bound; "
              "binarize_pack and pack_bits (the packed transport), "
              "center_int8 and resize_nn (Classifier) run in C; "
              "engine.prepare_host is numpy, as in JAX")
    else:
        print("host library: not built (make failed); binarize_pack, "
              "pack_bits, center_int8 and resize_nn run their numpy bodies; "
              "engine.prepare_host is numpy, as in JAX")
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
    for kname, label, kern, plain, kind_out, work, row in \
            _kernel_cases(torch, device):
        pooled = thresholds.pooled_epilogue.value
        got, want = kern(), plain()
        torch.cuda.synchronize()
        # a pooled chain pools in its last launch's epilogue, and only it
        assert thresholds.pooled_epilogue.value - pooled == \
            ("+pool" in label), label
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
        if row:                             # main-path time per forward
            bound = _account(torch, device, r, work, got, ms, plain_ms)
            replay_ms = graph_ms(kern)
            r["graph_ms"] = (r["graph_ms"] or 0.0) + replay_ms
            beside = f" (graph replay {replay_ms:.4f} ms), bound {bound:.4f} ms"
        elif work:      # another net's layers, or an unpooled chain: on no
            # row, with its bound
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
    counters["pooled_epilogue"] = thresholds.pooled_epilogue
    for c in counters.values():
        c.reset()
    pred = eng.classify(images)
    torch.cuda.synchronize()
    launches = {k: c.value for k, c in counters.items()}
    # the forward's first use: one eager run, the capture, one replay, all
    # on the raw uint8 upload, centred inside the program
    prog = _hold_program(torch, eng, ((BATCH, 32, 32, 3), torch.uint8, True,
                                      False), "main path")
    print(f"main path: cnv-w1a1 classify batch {BATCH}, launches {launches} "
          f"(the eager run before the capture and the capture); the "
          f"program's capture {prog.launches} == the eager forward's, "
          f"replays {prog.replays.value}")
    for k, n in launches.items():
        assert n > 0, f"main path never launched {k}"
        assert n == 2 * prog.launches[k], (k, n, prog.launches)
    assert prog.replays.value == 1
    # conv1 and conv4 pool in their epilogue: no pool op is left
    assert prog.launches["pooled_epilogue"] == 2, prog.launches
    assert pred.shape == (BATCH,) and pred.min() >= 0 and pred.max() < 10
    # the host-prepared int8 batch, a program of its own: the same classes
    assert (eng.classify(eng.prepare(images), prepared=True) == pred).all()
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
    sliced_rows = []                  # sliced_kernel: the long-K cases
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
        elif label.startswith("sliced:"):     # sliced_kernel, with its bound
            ops_ms, bytes_ms = _bounds(work, got)
            replay_ms = graph_ms(kern)
            sliced_rows.append((label, ms, replay_ms, max(ops_ms, bytes_ms),
                                "operations" if ops_ms >= bytes_ms
                                else "bytes", plain_ms))
            beside = (f" (graph replay {replay_ms:.4f} ms), bound "
                      f"{max(ops_ms, bytes_ms):.5f} ms ({sliced_rows[-1][4]})")
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
        lib_before = library_calls()
        vpred = veng.classify(images)
        torch.cuda.synchronize()
        arm_launches = {r: c.value for r, c in arms.items()}
        launches["packed_matmul"] = sum(arm_launches.values())
        vlib = _library_moved("packed path", lib_before)
        vprog = _hold_program(torch, veng, ((BATCH, 32, 32, 3), torch.uint8,
                                            True, False), "packed path")
        print(f"packed path: cnv-w1a1 route=vpu classify batch {BATCH}, "
              f"packed_matmul launches {arm_launches}, plain calls "
              f"{len(plain_calls)}; library calls {vlib} (the eager run and "
              f"the capture; the program's {vprog.library}: conv0 on "
              f"cuBLASLt's int8 GEMM, no int_matmul_ref)")
        assert vprog.library == {"int_mm": 1} and \
            vlib == {"int_mm": 2}, (vprog.library, vlib)
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
        lib_before = library_calls()
        dpred = deng.classify(images)
        torch.cuda.synchronize()
        dlib = _library_moved("direct path", lib_before)
        launches.update({k: c.value for k, c in direct_counters.items()})
        print(f"direct path: cnv-w1a1 route=direct classify batch {BATCH}, "
              f"launches conv2d_direct {launches['conv2d_direct']}, "
              f"conv_chain_direct {launches['conv_chain_direct']} (no "
              f"route calls it, as in JAX), plain calls {len(direct_plain)}"
              f"; library calls {dlib} (conv0 and the 3 dense layers on "
              f"cuBLASLt's int8 GEMM, no int_matmul_ref)")
        # the first use: the eager run before the capture, the capture
        dprog = _hold_program(torch, deng, ((BATCH, 32, 32, 3), torch.uint8,
                                            True, False), "direct path")
        assert dprog.launches["conv2d_direct"] == 5, \
            "direct path: 5 conv layers a forward"
        assert dprog.library == {"int_mm": 4} and \
            dlib == {"int_mm": 8}, (dprog.library, dlib)
        assert launches["conv2d_direct"] == 2 * 5 and \
            dprog.replays.value == 1, "direct path: 5 conv layers"
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
    floor_ms = _probe_phase(torch, device, kind, results, launches)

    # -- 15. the serving entry points on the card -------------------------
    _serving_entry_points(torch, images, counters)

    # -- 16. training on the card, served by the kernels --------------------
    _training_phase(torch, counters)

    # -- 17. tensor-parallel inference ---------------------------------------
    _parallel_phase(torch, smi)

    # -- 18. sharded training -------------------------------------------------
    _sharded_training_phase(torch, smi)

    # -- 19. the perf tools and the examples -----------------------------------
    _tools_phase(torch, smi, results)

    # -- 20. the captured programs and the captured training step -------------
    _programs_phase(torch, smi)

    # -- 21. the parallel engines' programs, the captured sharded step ------
    _spmd_programs_phase(torch, smi)

    # -- 22. the decoded-integer routes on library calls --------------------
    _xla_routes_phase(torch, smi)

    # -- 23. strided convs: conv_chain on prebuilt patches ------------------
    patch_rows, strided_launches = _strided_phase(torch, smi)

    # -- 24. MobileNet-v1 W4A4: the depthwise kernel and 4-bit codes --------
    results["depthwise_conv"], launches["depthwise_conv"] = \
        _mobilenet_phase(torch, smi)

    # -- 25. ResNet-50 v1.5 W1A2: the residual epilogue, 2-bit unsigned codes
    results["dense_residual"], launches["dense_residual"] = \
        _resnet_phase(torch, smi)

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
                                 "bnn_pynq_tpu/ops/conv_direct.py:170"),
           "depthwise_conv": ("bnn_pynq_tpu_torch/csrc/depthwise.cu",
                              "none (the JAX package runs no depthwise "
                              "conv)"),
           "dense_residual": ("bnn_pynq_tpu_torch/csrc/dense_block.cu",
                              "none (the JAX package runs no residual "
                              "block)")}
    for name, line in PROBE_LINES.items():
        src[name] = ("bnn_pynq_tpu_torch/csrc/mosaic_probes.cu",
                     f"tools/mosaic_probes.py:{line}")
    results["packed_matmul"] = packed
    kernels = []
    print("kernel rows (launches: counted in the run of its path, phases "
          "4, 8, 12, 14, 24 and 25; an engine's forward counts twice, the "
          "eager run before its capture and the capture, then replays; ms "
          "summed over that path's calls at batch 1024, depthwise_conv's "
          f"(dw_kernel) over MobileNet-v1's at {MOBILENET_BATCH}, "
          "dense_residual's over ResNet-50's 16 block-closing convs at "
          f"{RESNET_BATCH}; library: "
          "the one PyTorch call "
          "that computes the same function, where there is one; int_mm: "
          "torch._int_mm on the same M x K x N, dot only, no im2col, no "
          f"thresholds; launch floor {floor_ms:.5f} ms):")
    for k in src:
        r = results[k]
        row = {"name": k, "route": "cuda", "source": src[k][0],
               "replaces": src[k][1], "launches": launches[k],
               "max_abs_err": r["max_abs_err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": "operations" if r["ops_ms"] >= r["bytes_ms"]
               else "bytes",
               "library_ms": r["library_ms"], "int_mm_ms": r["int_mm_ms"],
               "int_mm_graph_ms": r["int_mm_graph_ms"],
               "graph_ms": r["graph_ms"],
               "library_graph_ms": r["library_graph_ms"],
               "launch_floor_ms": floor_ms}
        if k == "depthwise_conv":   # MobileNet-v1's 13 layers (phase 24)
            row.update(kernel="dw_kernel", batch=MOBILENET_BATCH)
        if k == "dense_residual":   # ResNet-50's 16 junctions (phase 25)
            row.update(kernel="dense_kernel<false, 1|2>", batch=RESNET_BATCH)
        if k == "conv_chain":       # on prebuilt patches (phase 23)
            row["input_patches"] = {"cases": patch_rows,
                                    "launches": strided_launches[k]}
        if k == "packed_matmul":    # sliced_kernel, the long-K arm
            row["sliced"] = [
                {"case": label, "ms": ms, "graph_ms": replay, "bound_ms": bd,
                 "bound_by": by, "plain_ms": pm}
                for label, ms, replay, bd, by, pm in sliced_rows]
        kernels.append(row)
        int_mm = "none" if row["int_mm_ms"] is None \
            else f"{row['int_mm_ms']:.4f}"
        if row["int_mm_graph_ms"] is not None:
            int_mm += f" (graph replay {row['int_mm_graph_ms']:.5f})"
        graph = "" if row["graph_ms"] is None \
            else f" (graph replay {row['graph_ms']:.5f})"
        lib = "none" if row["library_ms"] is None else \
            (f"{row['library_ms']:.4f} (graph replay "
             f"{row['library_graph_ms']:.5f})")
        name = f"{k} ({row['kernel']})" if "kernel" in row else k
        print(f"  {name}: launches {row['launches']}, bound_ms "
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
