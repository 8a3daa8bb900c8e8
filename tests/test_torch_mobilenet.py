"""MobileNet-v1 W4A4 on the port (models/config.py::mobilenet_v1), on the
CPU: the `mega` stages on their plain versions and runtime='ref' against
the benchmark's plain reference (`portbench/reference/mobilenet_v1.py`,
loaded by path: one reference of the network in the repository), exact
on int32 accumulators and float32 logits, at the real topology and input
(28 convs, 224x224x3, so the strides and the 7x7 pool are the real ones)
at width multiplier 1/16 (channels 2 to 64) and 10 classes, with seeded
random weights and calibrated thresholds from the artifact's generator;
the depthwise conv's plain version against the reference's equations;
4-bit codes; the pool's floor(sum / 64); the artifact's format; the
committed artifact's published sizes."""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bnn_pynq_tpu.compiler.artifacts import config_to_json as jax_to_json
from bnn_pynq_tpu.models.config import get_config as jax_get_config
from bnn_pynq_tpu_torch.compiler.artifacts import (config_from_json,
                                                   config_to_json,
                                                   load_artifact,
                                                   save_artifact)
from bnn_pynq_tpu_torch.models import network
from bnn_pynq_tpu_torch.models.config import (AVAILABLE_CONFIGS, get_config,
                                              mobilenet_v1)
from bnn_pynq_tpu_torch.models.params import (params_from_numpy,
                                              weight_matrix)
from bnn_pynq_tpu_torch.ops.depthwise import depthwise_conv
from bnn_pynq_tpu_torch.ops.thresholds import (SEARCHED_THRESHOLDS,
                                               THR_ALWAYS, THR_NEVER,
                                               codes_to_values, level_offset,
                                               level_scale, multithreshold,
                                               sort_thresholds)
from bnn_pynq_tpu_torch.runtime.classifier import Classifier
from bnn_pynq_tpu_torch.runtime.engine import InferenceEngine

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ROOT / "portbench" / "configs"


def _by_path(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod           # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


REF = _by_path("mobilenet_v1_reference",
               ROOT / "portbench/reference/mobilenet_v1.py")
GEN = _by_path("make_mobilenetv1_w4a4", CONFIGS / "make_mobilenetv1_w4a4.py")


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """(path, CompiledNetwork, reference net) of MobileNet-v1 at width 1/16
    with 10 classes, its weights and thresholds from the generator."""
    config = mobilenet_v1(1 / 16, 10)
    path = str(tmp_path_factory.mktemp("mobilenet") / "small.npz")
    save_artifact(path, GEN.build(config, seed=5, calib=8))
    return path, load_artifact(path), REF.load(path)


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(2024)
    return rng.integers(-128, 128, size=(3, 224, 224, 3)).astype(np.int8)


@pytest.mark.parametrize("runtime", ["kernels", "ref"])
def test_engine_equals_reference(small, images, runtime):
    """`mega` (the kernels' plain versions on the CPU) and runtime='ref'
    through launch_prepared and fetch: the logits are the reference's bit
    for bit, and so are the classes."""
    path, compiled, net = small
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
    accumulators, and the `mega` stages' codes stay in 0..15."""
    _, compiled, net = small
    layers, scale, bias = params_from_numpy(
        compiled.config, compiled.layers, compiled.out_scale,
        compiled.out_bias, "cpu")
    x = torch.from_numpy(images)
    acc = network.forward_ref(compiled.config, layers, x)
    assert acc.dtype == torch.int32
    assert torch.equal(acc.to(torch.int64),
                       REF.accumulators(net, x, device="cpu"))
    a = network.prepare_input(compiled.config, x)
    for name, fn in network.mega_stages(compiled.config, layers, scale,
                                        bias):
        a = fn(a)
        if name.startswith(("chain", "dw", "pw", "gap")):
            assert a.dtype == torch.int8 and 0 <= int(a.min()) and \
                int(a.max()) <= 15, name


def test_stage_names(small):
    _, compiled, _ = small
    layers, scale, bias = params_from_numpy(
        compiled.config, compiled.layers, compiled.out_scale,
        compiled.out_bias, "cpu")
    names = [n for n, _ in network.mega_stages(compiled.config, layers,
                                               scale, bias)]
    blocks = [f"{k}{i}" for j in range(13)
              for k, i in (("dw", 2 * j + 1), ("pw", 2 * j + 2))]
    assert names == ["im2col0", "chain0-0"] + blocks + ["gap27", "mlp_tail"]


def test_classifier_on_uint8(small):
    """Classifier.classify_images on uint8 pixels (p − 128 inside the
    program) answers the reference's classes on the same pixels."""
    _, compiled, net = small
    rng = np.random.default_rng(7)
    pixels = rng.integers(0, 256, size=(5, 224, 224, 3)).astype(np.uint8)
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
    layers, _, _ = params_from_numpy(compiled.config, compiled.layers,
                                     compiled.out_scale, compiled.out_bias,
                                     "cpu")
    args = {"forward": (layers, torch.from_numpy(images)),
            "forward_direct": (layers, torch.from_numpy(images)),
            "forward_xla": (layers, torch.from_numpy(images)),
            "decode_params": (layers,), "init_random_params": ()}[fn]
    with pytest.raises(NotImplementedError, match=compiled.config.name):
        getattr(network, fn)(compiled.config, *args)


@pytest.mark.parametrize("stride,h,w", [(1, 7, 7), (1, 8, 6), (2, 7, 7),
                                        (2, 8, 8), (2, 9, 6)])
def test_depthwise_plain_equals_reference(stride, h, w):
    """depthwise_conv's plain version against the reference's equations
    (a float64 conv2d with groups = channels, padding 1, rounded, then the
    MultiThreshold), odd and even sizes at stride 1 and 2."""
    rng = np.random.default_rng(stride * 100 + h * 10 + w)
    c = 12
    codes = rng.integers(0, 16, size=(2, h, w, c)).astype(np.int8)
    kn = rng.integers(-7, 8, size=(9, c)).astype(np.int8)
    thr = np.sort(rng.integers(-200, 200, size=(15, c)), axis=0) \
        .astype(np.int32)
    got = depthwise_conv(torch.from_numpy(codes),
                         weight_matrix(torch.from_numpy(kn)),
                         torch.from_numpy(thr), stride=stride, abits=4)
    layer = REF.Layer("dwconv", out=c, kernel=3, stride=stride, pad=1,
                      wbits=4, w=kn)
    acc = REF.layer_acc(layer, REF.torch_weight(layer, "cpu"),
                        torch.from_numpy(codes).permute(0, 3, 1, 2)
                        .to(torch.float64))
    want = REF.threshold(acc, torch.from_numpy(thr.astype(np.int64)))
    assert tuple(got.shape) == (2, (h - 1) // stride + 1,
                                (w - 1) // stride + 1, c)
    assert torch.equal(got.to(torch.float64), want.permute(0, 2, 3, 1))


def test_four_bit_codes():
    """Unsigned 4-bit codes are their own levels; 15 thresholds give codes
    0..15, an accumulator at a threshold passing it; 1- and 2-bit codes map
    as before."""
    codes = torch.arange(16, dtype=torch.int8)
    assert (level_offset(4), level_scale(4)) == (0, 1)
    assert torch.equal(codes_to_values(codes, 4), codes)
    assert codes_to_values(codes[:2], 1).tolist() == [-1, 1]
    assert codes_to_values(codes[:4], 2).tolist() == [-3, -1, 1, 3]
    thr = (10 * torch.arange(1, 16, dtype=torch.int32))[:, None]
    acc = torch.arange(-5, 165, dtype=torch.int32)[:, None]
    got = multithreshold(acc, thr)[:, 0]
    assert torch.equal(got.long(), torch.clamp(acc[:, 0] // 10, 0, 15).long())
    assert torch.equal(codes_to_values(got, 4), got)
    with pytest.raises(ValueError):
        level_offset(3)


def _shuffled(thr, rng):
    """The table with each channel's thresholds in random order."""
    return rng.permuted(np.asarray(thr), axis=0).astype(np.int32)


def test_params_sort_searched_tables(small):
    """params_from_numpy puts every 15-row table (the convs', the pool's)
    on the device with each channel ascending, whatever order the
    artifact gives; the artifact's arrays are left as they were."""
    _, compiled, _ = small
    rng = np.random.default_rng(23)
    layers = [dict(p) for p in compiled.layers]
    for p in layers:
        if "thr" in p:
            p["thr"] = _shuffled(p["thr"], rng)
    kept = [p["thr"].copy() for p in layers if "thr" in p]
    got, _, _ = params_from_numpy(compiled.config, layers, compiled.out_scale,
                                  compiled.out_bias, "cpu")
    tables = [(p["thr"], q["thr"]) for p, q in zip(layers, got) if "thr" in p]
    assert len(tables) == 28          # the image conv, 26 convs, the pool
    for (thr, dev), was in zip(tables, kept):
        assert thr.shape[0] == SEARCHED_THRESHOLDS
        np.testing.assert_array_equal(dev.numpy(), np.sort(thr, axis=0))
        np.testing.assert_array_equal(thr, was)
    assert any((np.diff(t, axis=0) < 0).any() for t, _ in tables)


@pytest.mark.parametrize("name", ["cnv-w1a1", "cnv-w2a2", "lfc-w1a2"])
def test_params_keep_compared_tables(name):
    """1- and 3-row tables (1- and 2-bit codes, compared one by one) reach
    the device byte for byte as the artifact has them, in any order."""
    compiled = load_artifact(str(ROOT / "pretrained" / f"{name}.npz"))
    rng = np.random.default_rng(29)
    layers = [dict(p) for p in compiled.layers]
    for p in layers:
        if "thr" in p:
            p["thr"] = _shuffled(p["thr"], rng)
    got, _, _ = params_from_numpy(compiled.config, layers, compiled.out_scale,
                                  compiled.out_bias, "cpu")
    nthrs = set()
    for p, q in zip(layers, got):
        if "thr" in p:
            nthrs.add(p["thr"].shape[0])
            assert q["thr"].numpy().tobytes() == p["thr"].tobytes()
    assert nthrs == {compiled.config.nthr} and compiled.config.nthr <= 3


def _ties(rng, nthr, n, m):
    """A table [nthr, N] drawn from few values, with never / always
    channels, and accumulators [M, N] drawn from the same values, their
    neighbours and the int32 ends."""
    vals = rng.integers(-40, 40, size=6)
    thr = rng.choice(vals, size=(nthr, n))
    thr[:, 0] = THR_NEVER
    thr[:, 1] = THR_ALWAYS
    thr[: nthr // 2, 2] = THR_ALWAYS
    thr[nthr // 2:, 2] = THR_NEVER
    thr[:, 3] = -2 ** 31
    thr[:, 4] = 2 ** 31 - 1
    pool = np.concatenate([vals, vals - 1, vals + 1,
                           [-2 ** 31, 2 ** 31 - 1, THR_NEVER, THR_ALWAYS]])
    acc = rng.choice(pool, size=(m, n))
    return thr.astype(np.int32), acc.astype(np.int32)


@pytest.mark.parametrize("nthr", [1, 3, 15])
def test_multithreshold_is_order_free(nthr):
    """The code counts the thresholds at or below the accumulator, so a
    table and its sorted copy give the same codes, ties included."""
    rng = np.random.default_rng(31 + nthr)
    thr, acc = _ties(rng, nthr, 40, 500)
    a = torch.from_numpy(acc)
    want = multithreshold(a, torch.from_numpy(thr))
    assert torch.equal(multithreshold(a, torch.from_numpy(
        np.sort(thr, axis=0))), want)
    assert torch.equal(multithreshold(a, torch.from_numpy(
        sort_thresholds(thr))), want)
    assert len(np.unique(want.numpy())) > min(nthr, 3)


def _search(acc, thr):
    """The kernels' 15-threshold epilogue (csrc/mma_tile.cuh::block_codes)
    in numpy: a branch-free search of each channel's ascending table,
    pos += acc >= t[pos + s - 1] ? s : 0 for s = 8, 4, 2, 1."""
    cols = np.arange(acc.shape[1])
    pos = np.where(acc >= thr[7], 8, 0)
    for s in (4, 2, 1):
        pos += np.where(acc >= thr[pos + s - 1, cols], s, 0)
    return pos


@pytest.mark.parametrize("case", ["ties", "spread", "all_equal"])
def test_search_equals_multithreshold(case):
    """The 4-step search on a sorted table gives multithreshold's code for
    every accumulator: ties, accumulators on thresholds and next to them,
    never / always channels and the int32 ends."""
    rng = np.random.default_rng(sum(map(ord, case)))
    thr, acc = _ties(rng, 15, 64, 700)
    if case == "spread":
        thr[:, 5:] = rng.integers(-10 ** 6, 10 ** 6, size=(15, 59))
        acc[:350, 5:] = thr[rng.integers(0, 15, size=(350, 59)),
                            np.arange(5, 64)]
        acc[350:, 5:] = rng.integers(-2 * 10 ** 6, 2 * 10 ** 6,
                                     size=(350, 59))
    elif case == "all_equal":
        thr[:, 5:] = 17
        acc[:, 5:] = rng.integers(15, 20, size=(700, 59))
    srt = sort_thresholds(thr)
    want = multithreshold(torch.from_numpy(acc), torch.from_numpy(thr))
    np.testing.assert_array_equal(_search(acc, srt), want.numpy())
    assert set(np.unique(want.numpy())) >= {0, 15}


def test_pool_is_floor_of_sum_over_64():
    """The thresholded 7x7 pool (`mega`'s gap stage and the reference's)
    gives floor(sum / 64) of a channel's 49 codes, 64 t being its
    thresholds: every code 15 (735 → 11), every code 0, and sums at and
    next to multiples of 64."""
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 16, size=(6, 7, 7, 9)).astype(np.int8)
    codes[0] = 15
    codes[1] = 0
    codes[2, :, :, :] = 0
    codes[2, 0, :4, :] = 15
    codes[2, 0, 4, :] = np.arange(1, 10)     # sums 61..69 around 64
    thr = np.repeat((64 * np.arange(1, 16, dtype=np.int32))[:, None], 9, 1)
    x = torch.from_numpy(codes)
    want = torch.from_numpy(codes.astype(np.int64).sum(axis=(1, 2)) // 64)
    got = network._avgpool_threshold(x, window=7, thr=torch.from_numpy(thr))
    assert torch.equal(got.long(), want)
    assert want[0, 0] == 11 and bool((want[2] == torch.tensor(
        [0, 0, 0, 1, 1, 1, 1, 1, 1])).all())
    layer = REF.Layer("avgpool", out=9, window=7)
    acc = REF.layer_acc(layer, None, x.permute(0, 3, 1, 2).to(torch.float64))
    ref = REF.threshold(acc, torch.from_numpy(thr.astype(np.int64)))
    assert torch.equal(ref.reshape(6, 9).long(), want)


def test_artifact_round_trip(small, tmp_path):
    """A MobileNet artifact saves and loads whole: its config (depthwise,
    padding, per-layer widths, the pool), every array, and the manifest's
    layer kinds."""
    path, compiled, _ = small
    again = tmp_path / "again.npz"
    save_artifact(str(again), compiled)
    loaded = load_artifact(str(again))
    assert loaded.config == compiled.config == mobilenet_v1(1 / 16, 10)
    assert config_from_json(config_to_json(mobilenet_v1())) == mobilenet_v1()
    for a, b in zip(loaded.layers, compiled.layers):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    with np.load(again) as z:
        kinds = [s["kind"] for s in json.loads(
            bytes(z["manifest"]).decode())["config"]["layers"]]
    assert kinds.count("dwconv") == 13 and kinds.count("avgpool") == 1
    assert json.dumps(config_to_json(mobilenet_v1())["layers"][0]) == (
        '{"kind": "conv", "out_ch": 32, "kernel": 3, "stride": 2, '
        '"pad": 1, "wbits": 8}')


@pytest.mark.parametrize("name", sorted(AVAILABLE_CONFIGS))
def test_existing_config_json_unchanged(name):
    """Every BNN-PYNQ config's manifest form is the JAX package's, byte for
    byte, so their artifacts load as before."""
    ours = json.dumps(config_to_json(get_config(name)))
    assert ours == json.dumps(jax_to_json(jax_get_config(name)))
    assert config_from_json(json.loads(ours)) == get_config(name)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in (ROOT / "pretrained").glob("*.npz")))
def test_existing_artifacts_load_unchanged(path):
    with np.load(ROOT / path) as z:
        manifest = json.loads(bytes(z["manifest"]).decode())
    cfg = config_from_json(manifest["config"])
    assert json.dumps(config_to_json(cfg)) == json.dumps(manifest["config"])
    assert not cfg.mega_only


def test_committed_artifact_is_the_published_network():
    """portbench's artifact is MobileNet-v1 W4A4 at width 1: its config is
    `mobilenet_v1()`, the reference's check passes against the
    configuration file, and it holds 568,740,352 MACs an image, 4,209,088
    weights (8-bit in ±127 first and last, 4-bit in ±7 between) and
    11,968 thresholded channels of 15 thresholds each."""
    config_file = json.loads((CONFIGS / "mobilenetv1-w4a4.json").read_text())
    path = ROOT / config_file["artifact"]
    compiled = load_artifact(str(path))
    assert compiled.config == mobilenet_v1()
    REF.check(REF.load(str(path)), config_file)
    plan = network.make_plan(compiled.config)
    h, macs = 224, 0
    for lp in plan:
        if lp.kind in ("conv_int8", "conv", "dwconv"):
            h = (h + 2 * lp.pad - lp.kernel) // lp.stride + 1
            macs += h * h * lp.k * lp.n     # a depthwise conv: K² a channel
        elif lp.kind == "dense":
            macs += lp.k * lp.n
    assert macs == 568_740_352
    ws = [p["w_int8"] for p in compiled.layers if "w_int8" in p]
    assert sum(w.size for w in ws) == 4_209_088
    assert np.abs(ws[0]).max() <= 127 and np.abs(ws[-1]).max() <= 127
    assert max(np.abs(w).max() for w in ws[1:-1]) <= 7
    thr = [p["thr"] for p in compiled.layers if "thr" in p]
    assert sum(t.shape[1] for t in thr) == 11_968
    assert {t.shape[0] for t in thr} == {15}
    assert all((np.diff(t, axis=0) >= 0).all() for t in thr)


def _byte_perm(x, y, s):
    """CUDA's __byte_perm on Python ints: byte i of the result is byte
    (nibble i of s) & 7 of the 8 bytes of (x, y)."""
    src = [(x >> (8 * i)) & 0xFF for i in range(4)] + \
        [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(src[(s >> (4 * i)) & 7] << (8 * i) for i in range(4))


def _dp4a(x, w, acc):
    sb = [np.int8(np.uint8((v >> (8 * i)) & 0xFF)) for v in (x, w)
          for i in range(4)]
    return acc + sum(int(a) * int(b) for a, b in zip(sb[:4], sb[4:]))


def _gather3(a, b, c, k):
    ab = _byte_perm(a, b, k | ((k + 4) << 4))
    return _byte_perm(ab, c, 0x4010 | ((k + 4) << 8))


def _dw_kernel(x, kn, thr, stride, grid=3, threads=256):
    """csrc/depthwise.cu::dw_kernel transliterated, thread by thread: the
    word and pixels each thread owns, the tap loads with the padding read
    as 0, the byte permutes and dp4a, the threshold count and the store."""
    b, h, w, c = x.shape
    oh, ow = (h - 1) // stride + 1, (w - 1) // stride + 1
    cq = c // 4
    words = x.view(np.uint32).astype(np.int64)          # [b, h, w, cq]
    wwords = kn.view(np.uint32).astype(np.int64).reshape(9, cq)
    out = np.zeros((b * oh, ow, cq), dtype=np.int64)
    for blk in range(grid):
        for tid in range(threads):
            q, px0, pstep = tid % cq, tid // cq, threads // cq
            wr = [[_gather3(*wwords[3 * ki:3 * ki + 3, q], k) & 0x00FFFFFF
                   for k in range(4)] for ki in range(3)]
            for r in range(blk, b * oh, grid):
                n, oy = divmod(r, oh)
                for ox0 in range(px0, ow, 2 * pstep):
                    for ox in (ox0, ox0 + pstep):
                        xv = [[words[n, oy * stride - 1 + ki,
                                     ox * stride - 1 + kj, q]
                               if 0 <= oy * stride - 1 + ki < h and ox < ow
                               and 0 <= ox * stride - 1 + kj < w else 0
                               for kj in range(3)] for ki in range(3)]
                        if ox >= ow:
                            continue
                        acc = [0, 0, 0, 0]
                        for ki in range(3):
                            for k in range(4):
                                acc[k] = _dp4a(_gather3(*xv[ki], k),
                                               wr[ki][k], acc[k])
                        codes = [int((acc[k] >= thr[:, 4 * q + k]).sum())
                                 for k in range(4)]
                        out[r, ox, q] = sum(v << (8 * k)
                                            for k, v in enumerate(codes))
    return out.astype(np.uint32).view(np.int8).reshape(b, oh, ow, c)


@pytest.mark.parametrize("stride,h,w,c", [(1, 5, 6, 16), (2, 7, 6, 8)])
def test_dw_kernel_transliteration_equals_plain(stride, h, w, c):
    """The index arithmetic of csrc/depthwise.cu off the card: its
    transliteration equals depthwise_conv's plain version."""
    rng = np.random.default_rng(c + h)
    codes = rng.integers(0, 16, size=(2, h, w, c)).astype(np.int8)
    kn = rng.integers(-7, 8, size=(9, c)).astype(np.int8)
    thr = np.sort(rng.integers(-150, 150, size=(15, c)), axis=0) \
        .astype(np.int32)
    want = depthwise_conv(torch.from_numpy(codes),
                          weight_matrix(torch.from_numpy(kn)),
                          torch.from_numpy(thr), stride=stride, abits=4)
    np.testing.assert_array_equal(_dw_kernel(codes, kn, thr, stride),
                                  want.numpy())
