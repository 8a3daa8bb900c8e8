"""ResNet-50 v1.5 W1A2's kernel paths on a card, bit for bit against their
plain versions at ResNet-50's published shapes at batch 256: the residual
epilogue (`dense_residual`: an identity block and the projection block of
every stage, the projection at stride 1 and 2), the padded 3x3 convs
(stride 1 on `conv_chain` over the map padded with code 0, stride 2 on
`dense_block` over the rows of its padded patches), the block's first 1x1
conv on unsigned codes, and the whole network on the `mega` route against
the benchmark's plain reference with the launches its captured program
counts, and `Classifier` on uint8 pixels. The plain versions run on the
card too (float64 products, rounded: exact). Every test takes the `card`
fixture and skips without CUDA. Run on a machine with a card (no JAX
needed):

    python -m pytest tests/test_torch_resnet50_card.py -q --confcutdir=tests
"""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bnn_pynq_tpu_torch.compiler.artifacts import load_artifact
from bnn_pynq_tpu_torch.models import network
from bnn_pynq_tpu_torch.models.params import weight_matrix
from bnn_pynq_tpu_torch.ops import conv_stack
from bnn_pynq_tpu_torch.ops.ref import int_matmul_ref
from bnn_pynq_tpu_torch.ops.thresholds import residual_epilogue
from bnn_pynq_tpu_torch.runtime.classifier import Classifier
from bnn_pynq_tpu_torch.runtime.engine import InferenceEngine

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "portbench/configs/resnet50-w1a2.json"
BATCH = 256
# (stage, input map, its channels, mid, out, stride) of each stage's first
# block; the identity blocks run at the output map with out channels
STAGES = [(2, 56, 64, 64, 256, 1), (3, 56, 256, 128, 512, 2),
          (4, 28, 512, 256, 1024, 2), (5, 14, 1024, 512, 2048, 2)]


def _reference():
    name = "resnet50_reference"
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "portbench/reference/resnet50.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod           # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _codes(g, card, *shape):
    return torch.randint(0, 4, shape, dtype=torch.int8, device=card,
                         generator=g)


def _pm1(g, card, k, n):
    return (2 * torch.randint(0, 2, (k, n), device=card, generator=g)
            - 1).to(torch.int8)


def _thr(g, card, n, k):
    """Sorted thresholds in ±2·sqrt(K): about ±1 deviation of a product of
    K codes (mean 1.5) and ±1 weights."""
    s = int(2 * k ** 0.5)
    t = torch.randint(-s, s + 1, (3, n), device=card, generator=g)
    return t.sort(dim=0).values.to(torch.int32).contiguous()


def _quartiles(acc):
    """int32 [3, N]: each column's quartiles over (up to 4096 of) the
    rows of acc, so that the codes spread over 0..3."""
    q = torch.tensor([0.25, 0.5, 0.75], device=acc.device,
                     dtype=torch.float64)
    t = torch.quantile(acc[:4096].to(torch.float64), q, dim=0)
    return t.round().to(torch.int32).contiguous()


def _residual_case(card, seed, b, h, w, c_in, mid, n, stride, projection):
    g = torch.Generator(device=card).manual_seed(seed)
    x = _codes(g, card, b, h, w, c_in)
    oh, ow = (h - 1) // stride + 1, (w - 1) // stride + 1
    rows = _codes(g, card, b * oh * ow, mid)
    r = torch.randint(1, 40, (n,), device=card, generator=g,
                      dtype=torch.int32)
    wc = _pm1(g, card, mid, n)
    if projection:
        wc = torch.cat([wc, (_pm1(g, card, c_in, n).to(torch.int32) * r)
                        .to(torch.int8)])
    wt = weight_matrix(wc)
    xs = x[:, ::stride, ::stride].reshape(-1, c_in)
    acc = int_matmul_ref(torch.cat([rows, xs], 1), wt.kn) if projection \
        else int_matmul_ref(rows, wt.kn) + r * xs.to(torch.int32)
    thr = _quartiles(acc)
    before = residual_epilogue.value
    got = conv_stack.dense_residual(rows, x, wt, r, thr, stride=stride,
                                    projection=projection)
    assert residual_epilogue.value == before + 1
    want = conv_stack.dense_residual_plain(rows, x, wt, r, thr,
                                           stride=stride,
                                           projection=projection)
    assert torch.equal(got, want)
    assert len(torch.unique(got)) == 4


@pytest.mark.parametrize("stage", STAGES, ids=lambda s: f"res{s[0]}")
def test_residual_epilogue_at_published_shapes(card, stage):
    """Each stage's projection block (stride 1 in stage 2, else 2) and an
    identity block, batch 256: the kernel's codes are the plain
    version's."""
    st, h, c_in, mid, out, stride = stage
    _residual_case(card, st, BATCH, h, h, c_in, mid, out, stride, True)
    oh = (h - 1) // stride + 1
    _residual_case(card, st + 10, BATCH, oh, oh, out, mid, out, 1, False)
    torch.cuda.empty_cache()


@pytest.mark.parametrize("h,w,c_in,mid,n,stride,projection", [
    (7, 5, 48, 32, 80, 2, True),      # a K slice holds both sources
    (5, 7, 12, 20, 24, 2, True),      # rows and pixels staged by bytes
    (6, 5, 40, 24, 40, 1, False),     # columns no multiple of 16
    (3, 3, 130, 64, 130, 1, False),   # odd columns: codes one by one
])
def test_residual_epilogue_ragged(card, h, w, c_in, mid, n, stride,
                                  projection):
    """Odd maps, ragged rows and columns, K that is no multiple of the
    stage slice or of 16 bytes."""
    _residual_case(card, h * w + n, 3, h, w, c_in, mid, n, stride,
                   projection)


@pytest.mark.parametrize("stage", STAGES, ids=lambda s: f"res{s[0]}")
def test_block_convs_at_published_shapes(card, stage):
    """A projection block's first 1x1 conv (`dense_block` on unsigned
    codes) and its 3x3 conv at the block's stride (at 2: `dense_block` on
    the padded patches' rows), and an identity block's 3x3 conv at stride
    1 (`conv_chain` over the map padded with code 0), batch 256: the
    kernels' codes are the plain versions'."""
    st, h, c_in, mid, _, stride = stage
    g = torch.Generator(device=card).manual_seed(st)
    lv = dict(abits=2, input_levels=True)
    x = _codes(g, card, BATCH, h, h, c_in)
    wa, ta = weight_matrix(_pm1(g, card, c_in, mid)), \
        _thr(g, card, mid, c_in)
    a = network._pointwise(x, w=wa, thr=ta, abits=2)
    want = conv_stack.dense_block_plain(x.reshape(-1, c_in), [wa], [ta],
                                        **lv).reshape(a.shape)
    assert torch.equal(a, want)
    for s in sorted({stride, 1}):
        wb = weight_matrix(_pm1(g, card, 9 * mid, mid))
        tb = _thr(g, card, mid, 9 * mid)
        if s == 1:
            inp = torch.nn.functional.pad(a, (0, 0, 1, 1, 1, 1))
            got = conv_stack.conv_chain(inp, [wb], [tb], kernel=3, **lv)
            want = conv_stack.conv_chain_plain(inp, [wb], [tb], kernel=3,
                                               **lv)
        else:
            inp = network._padded_patches(a, kernel=3, stride=s, pad=1)
            got = network._pointwise(inp, w=wb, thr=tb, abits=2)
            want = conv_stack.dense_block_plain(
                inp.reshape(-1, 9 * mid), [wb], [tb], **lv) \
                .reshape(got.shape)
        assert torch.equal(got, want), (st, s)
        assert got.shape[1] == (h - 1) // s + 1
        assert len(torch.unique(got)) == 4
    torch.cuda.empty_cache()


def test_resnet50_mega_equals_reference(card):
    """The committed ResNet-50 v1.5 W1A2 on `mega` through the engine's
    captured program, batch 256: the logits are the plain reference's bit
    for bit, the classes its argmax; the program launches 16 residual
    epilogues, 35 `dense_block` kernels (each block's first and last 1x1
    conv, the three strided 3x3 convs) and 14 `conv_chain` kernels (conv1,
    the 13 stride-1 3x3 convs)."""
    ref = _reference()
    config = json.loads(CONFIG.read_text())
    path = str(ROOT / config["artifact"])
    net = ref.load(path)
    ref.check(net, config)
    eng = InferenceEngine(load_artifact(path), device=card, route="mega")
    g = torch.Generator(device=card).manual_seed(27)
    x = torch.randint(-128, 128, (BATCH, 224, 224, 3), dtype=torch.int8,
                      device=card, generator=g)
    want = ref.forward(net, x, device=card).cpu()
    got = torch.from_numpy(eng.fetch(eng.launch_prepared(x)))
    assert torch.equal(got, want)
    cls = eng.fetch(eng.launch_prepared(x, argmax=True))
    np.testing.assert_array_equal(cls, want.argmax(1).numpy())
    prog = next(iter(eng.programs.values()))
    assert prog.launches.get("residual_epilogue") == 16
    assert prog.launches.get("dense_block") == 35
    assert prog.launches.get("conv_chain") == 14
    assert prog.launches.get("threshold_search", 0) == 0
    assert prog.launches.get("pooled_epilogue", 0) == 0
    torch.cuda.empty_cache()


def test_classifier_on_uint8(card):
    """`Classifier.classify_images` on uint8 pixels on the card (p − 128
    inside the captured program) answers the reference's classes."""
    ref = _reference()
    path = str(ROOT / json.loads(CONFIG.read_text())["artifact"])
    rng = np.random.default_rng(27)
    pixels = rng.integers(0, 256, size=(5, 224, 224, 3)).astype(np.uint8)
    clf = Classifier(InferenceEngine.from_artifact(path, device=card,
                                                   route="mega"))
    want = ref.forward(ref.load(path), torch.from_numpy(pixels),
                       device=card)
    np.testing.assert_array_equal(clf.classify_images(pixels),
                                  want.argmax(1).cpu().numpy())
    torch.cuda.empty_cache()
