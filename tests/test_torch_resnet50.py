"""ResNet-50 v1.5 W1A2 on the port (models/config.py::resnet50_v1_5), on
the CPU: the `mega` stages on their plain versions and runtime='ref'
against the benchmark's plain reference (`portbench/reference/resnet50.py`,
loaded by path: one reference of the network in the repository), exact on
int32 accumulators and float32 logits, at full depth (all 16 bottleneck
blocks: every stage's projection block and its identity blocks) on a
64x64x3 image at width 1/16 (channels 4 to 128) with a 2x2 average pool
and 10 classes, on two seeds of the artifact's generator; the residual
epilogue's plain version against the reference's junction MT(c + r * p);
unsigned 2-bit codes; the 3x3 stride-2 max pool; the refusals; the
residual launches counted; the artifact's format; the committed
artifact's published sizes; the existing configurations unchanged."""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bnn_pynq_tpu_torch.compiler.artifacts import (CompiledNetwork,
                                                   config_from_json,
                                                   config_to_json,
                                                   load_artifact,
                                                   save_artifact)
from bnn_pynq_tpu_torch.models import network
from bnn_pynq_tpu_torch.models.config import (BottleneckSpec, MaxPoolSpec,
                                              get_config, mobilenet_v1,
                                              resnet50_v1_5)
from bnn_pynq_tpu_torch.models.params import params_from_numpy, weight_matrix
from bnn_pynq_tpu_torch.ops.conv_stack import (dense_block_plain,
                                               dense_residual)
from bnn_pynq_tpu_torch.ops.ref import int_matmul_ref
from bnn_pynq_tpu_torch.ops.thresholds import (codes_are_levels,
                                               codes_to_values, level_offset,
                                               level_scale,
                                               residual_epilogue)
from bnn_pynq_tpu_torch.runtime.classifier import Classifier
from bnn_pynq_tpu_torch.runtime.engine import InferenceEngine

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ROOT / "portbench" / "configs"
SEEDS = (5, 6)
IMAGE = 64


def _by_path(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod           # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


REF = _by_path("resnet50_reference", ROOT / "portbench/reference/resnet50.py")
GEN = _by_path("make_resnet50_w1a2", CONFIGS / "make_resnet50_w1a2.py")


def _small_config():
    return resnet50_v1_5(1 / 16, 10, IMAGE)


@pytest.fixture(scope="module", params=SEEDS)
def small(request, tmp_path_factory):
    """(path, CompiledNetwork, reference net) of ResNet-50 at width 1/16,
    64x64 images and 10 classes, its weights and thresholds from the
    generator on one seed."""
    path = str(tmp_path_factory.mktemp("resnet50") / "small.npz")
    save_artifact(path, GEN.build(_small_config(), seed=request.param,
                                  calib=8))
    return path, load_artifact(path), REF.load(path)


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(2027)
    return rng.integers(-128, 128, size=(3, IMAGE, IMAGE, 3)).astype(np.int8)


def _params(compiled):
    return params_from_numpy(compiled.config, compiled.layers,
                             compiled.out_scale, compiled.out_bias, "cpu")


@pytest.mark.parametrize("runtime", ["kernels", "ref"])
def test_engine_equals_reference(small, images, runtime):
    """`mega` (the kernels' plain versions on the CPU) and runtime='ref'
    through launch_prepared and fetch: the logits are the reference's bit
    for bit, and so are the classes."""
    _, compiled, net = small
    eng = InferenceEngine(compiled, device="cpu", route="mega",
                          runtime=runtime)
    x = torch.from_numpy(images)
    want = REF.forward(net, x, device="cpu")
    got = eng.fetch(eng.launch_prepared(x))
    np.testing.assert_array_equal(got, want.numpy())
    cls = eng.fetch(eng.launch_prepared(x, argmax=True))
    np.testing.assert_array_equal(cls, want.argmax(1).numpy())


def test_accumulators_equal_reference(small, images):
    """The port's reference forward gives the reference's int32 logits
    accumulators; `forward_mega` gives its logits; and every stage's codes
    of the `mega` stages lie in 0..3 and use all four codes."""
    _, compiled, net = small
    layers, scale, bias = _params(compiled)
    x = torch.from_numpy(images)
    acc = network.forward_ref(compiled.config, layers, x)
    assert acc.dtype == torch.int32
    assert torch.equal(acc.to(torch.int64),
                       REF.accumulators(net, x, device="cpu"))
    assert torch.equal(network.forward_mega(compiled.config, layers, x,
                                            scale, bias),
                       REF.forward(net, x, device="cpu"))
    a = network.prepare_input(compiled.config, x)
    for name, fn in network.mega_stages(compiled.config, layers, scale,
                                        bias):
        a = fn(a)
        if name.startswith(("chain", "res")):
            assert a.dtype == torch.int8, name
            assert sorted(np.unique(a.numpy())) == [0, 1, 2, 3], name


def _codes(rng, *shape):
    return torch.from_numpy(rng.integers(0, 4, size=shape).astype(np.int8))


def _pm1(rng, k, n):
    return (2 * rng.integers(0, 2, size=(k, n)) - 1).astype(np.int8)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("projection,stride,h,w", [
    (False, 1, 5, 6), (True, 1, 6, 5), (True, 2, 8, 6), (True, 2, 7, 5)])
def test_residual_plain_equals_reference(seed, projection, stride, h, w):
    """`dense_residual`'s plain version (the residual epilogue's twin) on
    rows of a block's 3x3 codes and the block input's codes equals the
    reference's junction MT(c + r * p): c = conv1x1(b; W_c), p = x or
    conv1x1(x; W_p, stride), even and odd maps."""
    rng = np.random.default_rng(seed * 100 + stride * 10 + h)
    mid, c_in, n = 12, 20 if projection else 16, 16
    x = _codes(rng, 2, h, w, c_in)
    oh, ow = (h - 1) // stride + 1, (w - 1) // stride + 1
    b = _codes(rng, 2, oh, ow, mid)
    wc, wp = _pm1(rng, mid, n), _pm1(rng, c_in, n)
    r = rng.integers(1, 40, size=n).astype(np.int32)
    thr = np.sort(rng.integers(-60, 120, size=(3, n)), axis=0) \
        .astype(np.int32)
    w = np.concatenate([wc, (wp * r).astype(np.int8)]) if projection else wc
    got = dense_residual(b.reshape(-1, mid), x,
                         weight_matrix(torch.from_numpy(w)),
                         torch.from_numpy(r), torch.from_numpy(thr),
                         stride=stride, projection=projection)

    def nchw(t):
        return t.permute(0, 3, 1, 2).to(torch.float64)

    def w1x1(m):
        return torch.from_numpy(m.T.astype(np.float64))[:, :, None, None]
    c = REF.conv(nchw(b), w1x1(wc))
    p = REF.conv(nchw(x), w1x1(wp), stride) if projection else nchw(x)
    want = REF.junction(c, p, torch.from_numpy(r.astype(np.float64)),
                        torch.from_numpy(thr.astype(np.int64)))
    assert torch.equal(got.reshape(2, oh, ow, n).to(torch.float64),
                       want.permute(0, 2, 3, 1))
    assert len(np.unique(got.numpy())) == 4


def test_unsigned_two_bit_codes():
    """Unsigned 2-bit codes are their own levels, as the config states
    (`NetworkConfig.unsigned`, written to the manifest, and read with the
    width by `codes_are_levels` alone); bipolar 2-bit codes and the
    widths' other forms map as before; a dense layer on unsigned codes
    multiplies the codes themselves."""
    codes = torch.arange(4, dtype=torch.int8)
    assert (level_offset(2, True), level_scale(2, True)) == (0, 1)
    assert torch.equal(codes_to_values(codes, 2, unsigned=True), codes)
    assert codes_to_values(codes, 2).tolist() == [-3, -1, 1, 3]
    assert codes_are_levels(2, True) and codes_are_levels(4)
    assert not codes_are_levels(2) and not codes_are_levels(1)
    with pytest.raises(ValueError):
        level_offset(1, True)
    cfg = resnet50_v1_5()
    assert cfg.unsigned and cfg.abits == 2 and cfg.nthr == 3
    assert cfg.codes_are_levels
    assert config_to_json(cfg)["unsigned"] is True
    assert config_from_json(config_to_json(cfg)) == cfg
    assert "unsigned" not in config_to_json(mobilenet_v1())
    assert mobilenet_v1().codes_are_levels
    assert not get_config("cnv-w1a2").codes_are_levels
    rng = np.random.default_rng(3)
    x = _codes(rng, 9, 40)
    wt = weight_matrix(torch.from_numpy(_pm1(rng, 40, 8)))
    thr = torch.from_numpy(np.sort(rng.integers(-20, 40, size=(3, 8)),
                                   axis=0).astype(np.int32))
    got = dense_block_plain(x, [wt], [thr], abits=2, input_levels=True)
    acc = int_matmul_ref(x, wt.kn)
    assert torch.equal(got, (acc[:, None] >= thr).sum(1).to(torch.int8))


@pytest.mark.parametrize("h,w", [(16, 16), (7, 7), (9, 6), (2, 2)])
def test_maxpool_equals_reference(h, w):
    """The 3x3, stride-2, pad-1 max pool on codes, padded with code 0,
    equals the reference's (padding below every code)."""
    rng = np.random.default_rng(h * 10 + w)
    x = _codes(rng, 2, h, w, 5)
    got = network.maxpool_padded(x, kernel=3, stride=2, pad=1)
    layer = REF.Layer("maxpool", kernel=3, stride=2, pad=1)
    want = REF.layer_out(layer, {}, x.permute(0, 3, 1, 2)
                         .to(torch.float64))
    assert tuple(got.shape) == (2, (h - 1) // 2 + 1, (w - 1) // 2 + 1, 5)
    assert torch.equal(got.to(torch.float64), want.permute(0, 2, 3, 1))


def test_stage_names(small):
    _, compiled, _ = small
    layers, scale, bias = _params(compiled)
    names = [n for n, _ in network.mega_stages(compiled.config, layers,
                                               scale, bias)]
    blocks = [f"res{s}.{b}" for s, n in zip(range(2, 6), (3, 4, 6, 3))
              for b in range(1, n + 1)]
    assert names == ["im2col0", "chain0-0", "pool1"] + blocks + \
        ["gap18", "mlp_tail"]


def test_classifier_on_uint8(small):
    """Classifier.classify_images on uint8 pixels (p − 128 inside the
    program) answers the reference's classes on the same pixels."""
    _, compiled, net = small
    rng = np.random.default_rng(7)
    pixels = rng.integers(0, 256, size=(5, IMAGE, IMAGE, 3)) \
        .astype(np.uint8)
    clf = Classifier(InferenceEngine(compiled, device="cpu", route="mega",
                                     batch_buckets=(2, 4)))
    want = REF.forward(net, torch.from_numpy(pixels), device="cpu")
    np.testing.assert_array_equal(clf.classify_images(pixels),
                                  want.argmax(1).numpy())


@pytest.mark.parametrize("route", ["direct", "mxu", "mxu_rm", "vpu", "xla",
                                   "xlaconv", "fused"])
def test_other_routes_raise(small, route):
    _, compiled, _ = small
    with pytest.raises(NotImplementedError, match="route='mega'"):
        InferenceEngine(compiled, device="cpu", route=route)


@pytest.mark.parametrize("fn", ["forward", "forward_direct", "forward_xla",
                                "decode_params", "init_random_params"])
def test_other_forwards_raise(small, images, fn):
    _, compiled, _ = small
    layers, _, _ = _params(compiled)
    args = {"forward": (layers, torch.from_numpy(images)),
            "forward_direct": (layers, torch.from_numpy(images)),
            "forward_xla": (layers, torch.from_numpy(images)),
            "decode_params": (layers,), "init_random_params": ()}[fn]
    with pytest.raises(NotImplementedError, match=compiled.config.name):
        getattr(network, fn)(compiled.config, *args)


def test_residual_epilogue_counts(small, images, monkeypatch):
    """16 shortcuts join an accumulator a ResNet-50 forward at full depth:
    its stages call `dense_residual` 16 times, each a launch on a card
    that `residual_epilogue` counts (tests/test_torch_resnet50_card.py
    holds the count there); none a CNV or a MobileNet forward. On the CPU
    the calls launch nothing, and the counter stays where it was."""
    _, compiled, _ = small
    calls = []

    def counted(*args, **kwargs):
        calls.append(kwargs["projection"])
        return dense_residual(*args, **kwargs)
    monkeypatch.setattr(network, "dense_residual", counted)

    def count(compiled, x):
        layers, scale, bias = _params(compiled)
        before, first = residual_epilogue.value, len(calls)
        network.forward_mega(compiled.config, layers, torch.from_numpy(x),
                             scale, bias)
        assert residual_epilogue.value == before
        return len(calls) - first
    assert count(compiled, images[:1]) == 16
    assert calls.count(True) == 4          # a projection a stage
    cnv = load_artifact(str(ROOT / "pretrained/cnv-w1a1.npz"))
    assert count(cnv, images[:1, :32, :32]) == 0
    mgen = _by_path("make_mobilenetv1_w4a4",
                    CONFIGS / "make_mobilenetv1_w4a4.py")
    mob = mgen.build(mobilenet_v1(1 / 16, 10), seed=5, calib=2)
    assert count(mob, np.zeros((1, 224, 224, 3), np.int8)) == 0


def test_params_refuse_bad_multipliers(small):
    """r must fit W_p·diag(r) in int8 and be at least 1."""
    _, compiled, _ = small
    for bad in (0, 128):
        layers = [dict(p) for p in compiled.layers]
        layers[2]["r"] = np.full_like(layers[2]["r"], bad)
        with pytest.raises(ValueError, match="shortcut multipliers"):
            params_from_numpy(compiled.config, layers, compiled.out_scale,
                              compiled.out_bias, "cpu")


def test_artifact_round_trip(small, tmp_path):
    """A ResNet artifact saves and loads whole: its config (the max pool,
    the bottleneck blocks, unsigned codes, per-layer widths), every array,
    the packed 1-bit weights, and the manifest's layer kinds."""
    path, compiled, _ = small
    again = tmp_path / "again.npz"
    save_artifact(str(again), compiled)
    loaded = load_artifact(str(again))
    assert loaded.config == compiled.config == _small_config()
    assert config_from_json(config_to_json(resnet50_v1_5())) == \
        resnet50_v1_5()
    for a, b in zip(loaded.layers, compiled.layers):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert sorted(compiled.layers[2]) == ["r", "thr", "thr_a", "thr_b",
                                          "wa_packed", "wb_packed",
                                          "wc_packed", "wp_packed"]
    assert compiled.layers[2]["wb_packed"].dtype == np.uint32
    with np.load(again) as z:
        kinds = [s["kind"] for s in json.loads(
            bytes(z["manifest"]).decode())["config"]["layers"]]
    assert kinds.count("bottleneck") == 16 and kinds[:2] == ["conv",
                                                             "maxpool"]
    cfg = resnet50_v1_5()
    assert cfg.layers[1] == MaxPoolSpec(3, 2, 1)
    assert cfg.layers[2] == BottleneckSpec(64, 256, 1, True, 1)
    assert cfg.layers[5] == BottleneckSpec(128, 512, 2, True, 1)
    assert json.dumps(config_to_json(cfg)["layers"][2]) == (
        '{"kind": "bottleneck", "mid": 64, "out_ch": 256, "stride": 1, '
        '"projection": true, "wbits": 1}')


def test_committed_artifact_is_the_published_network():
    """portbench's artifact is ResNet-50 v1.5 W1A2 at width 1: its config
    is `resnet50_v1_5()`, the reference's check passes against the
    configuration file, and it holds 4,089,184,256 MACs an image,
    23,445,504 1-bit weights stored packed (32 to a word) and 2,057,408
    8-bit weights (conv1 and the classifier, in ±127), three thresholds a
    channel on every thresholded channel, and r in [1, 127]; the file is
    under 8 MB."""
    config_file = json.loads((CONFIGS / "resnet50-w1a2.json").read_text())
    path = ROOT / config_file["artifact"]
    assert path.stat().st_size < 8_000_000
    compiled = load_artifact(str(path))
    assert compiled.config == resnet50_v1_5()
    assert config_file["reduced"] == []
    REF.check(REF.load(str(path)), config_file)
    h, macs, bits, bytes8, chans = 224, 0, 0, 0, 0
    for lp, p in zip(network.make_plan(compiled.config), compiled.layers):
        if lp.kind == "conv_int8":
            h = (h + 2 * lp.pad - lp.kernel) // lp.stride + 1
            macs += h * h * lp.k * lp.n
        elif lp.kind == "maxpool":
            h = (h + 2 * lp.pad - lp.kernel) // lp.stride + 1
        elif lp.kind == "bottleneck":
            oh = (h - 1) // lp.stride + 1
            k = lp.k * lp.mid + 9 * lp.mid * lp.mid + lp.mid * lp.n + \
                (lp.k * lp.n if lp.projection else 0)
            macs += h * h * lp.k * lp.mid + oh * oh * (k - lp.k * lp.mid)
            bits += k
            h = oh
        elif lp.kind == "dense":
            macs += lp.k * lp.n
        for name, a in p.items():
            if name.endswith("_packed"):
                assert a.dtype == np.uint32
            elif name == "w_int8":
                bytes8 += a.size
                assert np.abs(a.astype(np.int16)).max() <= 127
            elif name.startswith("thr"):
                assert a.shape[0] == 3
                chans += a.shape[1]
            elif name == "r":
                assert 1 <= a.min() and a.max() <= 127
    assert macs == 4_089_184_256
    assert bits == 23_445_504 and bytes8 == 2_057_408
    packed = sum(a.size for p in compiled.layers for n, a in p.items()
                 if n.endswith("_packed"))
    assert packed * 32 < bits * 1.01
    assert chans == 64 + 2 * (3 * 64 + 4 * 128 + 6 * 256 + 3 * 512) + \
        (3 * 256 + 4 * 512 + 6 * 1024 + 3 * 2048) + 2048


@pytest.mark.parametrize("name", ["cnv-w1a1", "lfc-w1a1",
                                  "mobilenetv1-w4a4"])
def test_existing_configs_load_unchanged(name):
    """The benchmark's other configurations: their artifacts' manifests
    round-trip byte for byte, and their configs keep signedness and the
    routes that run them."""
    config_file = json.loads((CONFIGS / f"{name}.json").read_text())
    with np.load(ROOT / config_file["artifact"]) as z:
        manifest = json.loads(bytes(z["manifest"]).decode())
    cfg = config_from_json(manifest["config"])
    assert json.dumps(config_to_json(cfg)) == json.dumps(manifest["config"])
    if name.startswith("mobilenet"):
        assert cfg == mobilenet_v1() and cfg.codes_are_levels
        assert cfg.mega_only
    else:
        assert cfg == get_config(name) and not cfg.codes_are_levels
        assert not cfg.mega_only
    assert isinstance(load_artifact(str(ROOT / config_file["artifact"])),
                      CompiledNetwork)
