"""MobileNet-v1 W4A4's kernels on a card, bit for bit against their plain
versions at MobileNet's own shapes, the whole network on the `mega` route
against the benchmark's plain reference, and CNV-W1A1's `mega` forward
after the epilogues learned 15 thresholds. The 15-threshold epilogue
searches each channel's thresholds, which `params_from_numpy` sorts: its
cases put shuffled tables, repeated thresholds, never / always channels
and accumulators on a threshold through it and hold the codes to
`multithreshold` on the table as it was. Every test takes the `card`
fixture and skips without CUDA. Run on a machine with a card (no JAX
needed):

    python -m pytest tests/test_torch_mobilenet_card.py -q --confcutdir=tests
"""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bnn_pynq_tpu_torch.compiler.artifacts import load_artifact
from bnn_pynq_tpu_torch.models.config import DenseSpec, NetworkConfig
from bnn_pynq_tpu_torch.models.params import params_from_numpy, weight_matrix
from bnn_pynq_tpu_torch.ops import (conv_direct, conv_stack, depthwise,
                                    fused_mlp)
from bnn_pynq_tpu_torch.ops.ref import int_matmul_ref
from bnn_pynq_tpu_torch.ops.thresholds import (THR_ALWAYS, THR_NEVER,
                                               multithreshold,
                                               threshold_search)
from bnn_pynq_tpu_torch.runtime.engine import InferenceEngine

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "portbench/configs/mobilenetv1-w4a4.json"


def _reference():
    name = "mobilenet_v1_reference"
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "portbench/reference/mobilenet_v1.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod           # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _thresholds(rng, n, lo, hi, nthr=15):
    return torch.from_numpy(np.sort(rng.integers(lo, hi, size=(nthr, n)),
                                    axis=0).astype(np.int32))


@pytest.mark.parametrize("h,c,stride", [(112, 32, 1), (112, 64, 2),
                                        (7, 1024, 1), (15, 128, 2)])
def test_depthwise_kernel_equals_plain(card, h, c, stride):
    rng = np.random.default_rng(h * c + stride)
    x = torch.from_numpy(rng.integers(0, 16, size=(8, h, h, c))
                         .astype(np.int8))
    w = weight_matrix(torch.from_numpy(
        rng.integers(-7, 8, size=(9, c)).astype(np.int8)))
    thr = _thresholds(rng, c, -300, 300)
    want = depthwise.depthwise_conv(x, w, thr, stride=stride, abits=4)
    wd = weight_matrix(w.kn.to(card))
    before = depthwise.depthwise_conv.launches.value
    got = depthwise.depthwise_conv(x.to(card), wd, thr.to(card),
                                   stride=stride, abits=4)
    torch.cuda.synchronize()
    assert depthwise.depthwise_conv.launches.value == before + 1
    assert torch.equal(got.cpu(), want)


def _table(kind, rng, acc, span):
    """A 15-row threshold table [15, N] for accumulators `acc` [M, N]:
    "sorted" ascending in each channel; "shuffled" in random order;
    "ties" few distinct values, repeated; "sentinels" whole channels that
    never or always pass and channels with both ends; "on_threshold" each
    threshold an accumulator of the batch, so that codes land on them;
    every kind but "sorted" shuffled within each channel."""
    n = acc.shape[1]
    if kind == "ties":
        t = rng.choice(rng.integers(-span, span, size=4), size=(15, n))
    elif kind == "on_threshold":
        t = acc[rng.integers(0, acc.shape[0], size=(15, n)),
                np.arange(n)]
    else:
        t = rng.integers(-span, span, size=(15, n))
    if kind == "sentinels":
        t[:, 0::7] = THR_NEVER
        t[:, 1::7] = THR_ALWAYS
        t[:5, 2::7] = THR_ALWAYS
        t[10:, 2::7] = THR_NEVER
    t = np.sort(t, axis=0)
    if kind != "sorted":
        t = rng.permuted(t, axis=0)
    return t.astype(np.int32)


def _on_card(card, kn, thr, wbits=4):
    """(WeightMatrix, thresholds) as `params_from_numpy` puts a layer of
    these levels and this table on the card: one thresholded dense layer
    of a 4-bit net."""
    cin, cout = kn.shape
    cfg = NetworkConfig(name="one-layer", wbits=4, abits=4,
                        input_kind="int8", input_shape=(1, 1, cin),
                        layers=(DenseSpec(cout, wbits=wbits),
                                DenseSpec(10, wbits=8)), num_classes=10)
    layers, _, _ = params_from_numpy(
        cfg, [{"w_int8": kn, "thr": thr},
              {"w_int8": np.zeros((cout, 10), np.int8)}],
        np.ones(10, np.float32), np.zeros(10, np.float32), card)
    return layers[0]["w"], layers[0]["thr"]


@pytest.mark.parametrize("h,cin,cout,table", [
    (112, 32, 64, "sorted"), (7, 1024, 1024, "sorted"),
    (14, 512, 512, "sorted"), (56, 64, 128, "shuffled"),
    (28, 128, 256, "ties"), (14, 256, 512, "sentinels"),
    (7, 512, 1024, "on_threshold"), (112, 32, 72, "shuffled")])
def test_pointwise_kernels_equal_plain(card, h, cin, cout, table):
    """A 1x1 conv on 4-bit codes, 15 thresholds through params_from_numpy:
    dense_block on the rows and conv_chain at kernel 1 on the map give
    multithreshold's codes on the table as it was, each launch counted as
    a search."""
    rng = np.random.default_rng(h + cin + cout)
    x = rng.integers(0, 16, size=(4, h, h, cin)).astype(np.int8)
    kn = rng.integers(-7, 8, size=(cin, cout)).astype(np.int8)
    rows = torch.from_numpy(x.reshape(-1, cin))
    acc = int_matmul_ref(rows, torch.from_numpy(kn))
    span = int(120 * cin ** 0.5)           # about 3 deviations of the sum
    thr = _table(table, rng, acc.numpy(), span)
    want = multithreshold(acc, torch.from_numpy(thr))
    wd, td = _on_card(card, kn, thr)
    before = threshold_search.value
    got = conv_stack.dense_block(rows.to(card), [wd], [td], abits=4)
    chain = conv_stack.conv_chain(torch.from_numpy(x).to(card), [wd], [td],
                                  kernel=1, abits=4)
    torch.cuda.synchronize()
    assert threshold_search.value == before + 2
    assert torch.equal(got.cpu(), want)
    assert torch.equal(chain.cpu().reshape(-1, cout), want)
    assert len(torch.unique(want)) > 1, "a degenerate case"


@pytest.mark.parametrize("table", ["shuffled", "sentinels"])
def test_conv2d_direct_searches_too(card, table):
    """conv2d_direct on a 15-row table runs the same searched epilogue
    (conv_tile.cuh's conv_kernel<0, true>): a 1x1 conv through
    params_from_numpy gives multithreshold's codes, counted as a search."""
    rng = np.random.default_rng(41)
    x = rng.integers(0, 16, size=(2, 14, 14, 256)).astype(np.int8)
    kn = rng.integers(-7, 8, size=(256, 512)).astype(np.int8)
    acc = int_matmul_ref(torch.from_numpy(x.reshape(-1, 256)),
                         torch.from_numpy(kn))
    thr = _table(table, rng, acc.numpy(), 1920)
    want = multithreshold(acc, torch.from_numpy(thr))
    wd, td = _on_card(card, kn, thr)
    before = threshold_search.value
    got = conv_direct.conv2d_direct(torch.from_numpy(x).to(card), wd, td,
                                    kernel=1, abits=4)
    torch.cuda.synchronize()
    assert threshold_search.value == before + 1
    assert torch.equal(got.cpu().reshape(-1, 512), want)


@pytest.mark.parametrize("table", ["sorted", "on_threshold"])
def test_first_conv_and_classifier_equal_plain(card, table):
    """The 8-bit image conv on padded stride-2 patches (conv_chain at
    kernel 1 on levels; its 15 thresholds through params_from_numpy, as
    drawn or shuffled with codes on them) and the 1024 → 1000 classifier
    on 4-bit codes (fused_mlp, scale and bias)."""
    rng = np.random.default_rng(7)
    img = torch.from_numpy(rng.integers(-128, 128, size=(4, 224, 224, 3))
                           .astype(np.int8))
    xp = torch.nn.functional.pad(img, (0, 0, 1, 1, 1, 1))
    from bnn_pynq_tpu_torch.ops.conv import sliding_window
    patches = sliding_window(xp, 3, 3, 2)
    kn = rng.integers(-127, 128, size=(27, 32)).astype(np.int8)
    acc = int_matmul_ref(patches.reshape(-1, 27), torch.from_numpy(kn))
    thr = _table(table, rng, acc.numpy(), 200000)
    want = multithreshold(acc, torch.from_numpy(thr)).reshape(
        patches.shape[:3] + (32,))
    wd, td = _on_card(card, kn, thr, wbits=8)
    got = conv_stack.conv_chain(patches.to(card), [wd], [td], kernel=3,
                                abits=4, input_patches=True,
                                input_levels=True)
    codes = torch.from_numpy(rng.integers(0, 12, size=(256, 1024))
                             .astype(np.int8))
    fc = torch.from_numpy(rng.integers(-127, 128, size=(1024, 1000))
                          .astype(np.int8))
    scale = torch.from_numpy(rng.uniform(1e-4, 2e-4, 1000)
                             .astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 1, 1000).astype(np.float32))
    want_lg = fused_mlp.fused_mlp_forward(codes, [weight_matrix(fc)], [],
                                          scale, bias, abits=4)
    got_lg = fused_mlp.fused_mlp_forward(
        codes.to(card), [weight_matrix(fc.to(card))], [], scale.to(card),
        bias.to(card), abits=4)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got_lg.cpu(), want_lg)


def test_mobilenet_mega_equals_reference(card):
    """The network through the engine's captured program at batch 256:
    logits bit for bit the plain reference's, argmax equal."""
    ref = _reference()
    config = json.loads(CONFIG.read_text())
    net = ref.load(str(ROOT / config["artifact"]))
    eng = InferenceEngine(load_artifact(str(ROOT / config["artifact"])),
                          device=card, route="mega")
    gen = torch.Generator(device=card)
    gen.manual_seed(3_000_000_123)
    x = torch.randint(-128, 128, (2, 256, 224, 224, 3), dtype=torch.int8,
                      device=card, generator=gen)
    want = ref.forward(net, x.reshape(-1, 224, 224, 3), device=card).cpu()
    got = torch.cat([torch.from_numpy(eng.fetch(eng.launch_prepared(b)))
                     for b in x])
    cls = np.concatenate([eng.fetch(eng.launch_prepared(b, argmax=True))
                          for b in x])
    assert torch.equal(got, want)
    np.testing.assert_array_equal(cls, want.argmax(1).numpy())
    prog = next(iter(eng.programs.values()))
    assert prog.launches.get("depthwise_conv") == 13
    assert prog.launches.get("dense_block") == 13
    # the 13 1x1 convs and the image conv search their thresholds
    assert prog.launches.get("threshold_search") == 14
    # no max-pool follows any of its convs
    assert prog.launches.get("pooled_epilogue", 0) == 0


def test_cnv_mega_unchanged(card):
    """CNV-W1A1 on `mega` on the card equals its plain stages on the CPU,
    logits bit for bit, after the epilogues learned 15 thresholds."""
    compiled = load_artifact(str(ROOT / "pretrained/cnv-w1a1.npz"))
    rng = np.random.default_rng(11)
    x = rng.integers(-128, 128, size=(256, 32, 32, 3)).astype(np.int8)
    cpu = InferenceEngine(compiled, device="cpu", route="mega")
    gpu = InferenceEngine(compiled, device=card, route="mega")
    want = cpu.fetch(cpu.launch_prepared(torch.from_numpy(x)))
    got = gpu.fetch(gpu.launch_prepared(torch.from_numpy(x).to(card)))
    np.testing.assert_array_equal(got, want)
    prog = next(iter(gpu.programs.values()))
    assert prog.launches.get("conv_chain") == 4
    assert prog.launches.get("threshold_search", 0) == 0
    # conv1 and conv4 pool in their epilogue
    assert prog.launches.get("pooled_epilogue") == 2
