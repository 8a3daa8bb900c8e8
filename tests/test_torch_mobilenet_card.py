"""MobileNet-v1 W4A4's kernels on a card, bit for bit against their plain
versions at MobileNet's own shapes, the whole network on the `mega` route
against the benchmark's plain reference, and CNV-W1A1's `mega` forward
after the epilogues learned 15 thresholds. Every test takes the `card`
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
from bnn_pynq_tpu_torch.models.params import weight_matrix
from bnn_pynq_tpu_torch.ops import conv_stack, depthwise, fused_mlp
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


@pytest.mark.parametrize("h,cin,cout", [(112, 32, 64), (7, 1024, 1024),
                                        (14, 512, 512)])
def test_pointwise_kernels_equal_plain(card, h, cin, cout):
    """A 1x1 conv on 4-bit codes, 15 thresholds: dense_block on the rows
    and conv_chain at kernel 1 on the map."""
    rng = np.random.default_rng(h + cin + cout)
    x = torch.from_numpy(rng.integers(0, 16, size=(4, h, h, cin))
                         .astype(np.int8))
    kn = torch.from_numpy(rng.integers(-7, 8, size=(cin, cout))
                          .astype(np.int8))
    span = int(120 * cin ** 0.5)           # about 3 deviations of the sum
    thr = _thresholds(rng, cout, -span, span)
    rows = x.reshape(-1, cin)
    want = conv_stack.dense_block(rows, [weight_matrix(kn)], [thr], abits=4)
    wd, td = weight_matrix(kn.to(card)), thr.to(card)
    got = conv_stack.dense_block(rows.to(card), [wd], [td], abits=4)
    chain = conv_stack.conv_chain(x.to(card), [wd], [td], kernel=1, abits=4)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert torch.equal(chain.cpu().reshape(-1, cout), want)


def test_first_conv_and_classifier_equal_plain(card):
    """The 8-bit image conv on padded stride-2 patches (conv_chain at
    kernel 1 on levels) and the 1024 → 1000 classifier on 4-bit codes
    (fused_mlp, scale and bias)."""
    rng = np.random.default_rng(7)
    img = torch.from_numpy(rng.integers(-128, 128, size=(4, 224, 224, 3))
                           .astype(np.int8))
    xp = torch.nn.functional.pad(img, (0, 0, 1, 1, 1, 1))
    from bnn_pynq_tpu_torch.ops.conv import sliding_window
    patches = sliding_window(xp, 3, 3, 2)
    kn = torch.from_numpy(rng.integers(-127, 128, size=(27, 32))
                          .astype(np.int8))
    thr = _thresholds(rng, 32, -200000, 200000)
    want = conv_stack.conv_chain(patches, [weight_matrix(kn)], [thr],
                                 kernel=3, abits=4, input_patches=True,
                                 input_levels=True)
    got = conv_stack.conv_chain(patches.to(card), [weight_matrix(kn.to(card))],
                                [thr.to(card)], kernel=3, abits=4,
                                input_patches=True, input_levels=True)
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
