"""The port's `direct` route on the CPU, held against the JAX package:
`conv2d_int_ref`, `conv2d_direct` and `conv_chain_direct` against the JAX
functions (the Pallas kernels in interpret mode, as tests/test_conv_direct.py
runs them), `forward_direct` prefix by prefix, the `direct` engine against
the JAX engine, the golden fixture and the reference engine, the server,
and the wrappers' rejections. Codes and int32 accumulators must be equal;
float logits within rtol=atol=1e-5, the JAX tolerance
(tests/test_golden_fixtures.py:36).

The CUDA kernel itself runs only on a card: chip_smoke.py holds it against
`conv2d_direct_plain` and `conv_chain_direct_plain` there."""

import dataclasses
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bnn_pynq_tpu.models import network as jax_net
from bnn_pynq_tpu.ops import ref as jax_ref
from bnn_pynq_tpu.ops.conv import conv_weight_matrix
from bnn_pynq_tpu.ops.conv_direct import conv2d_direct as jax_conv2d_direct
from bnn_pynq_tpu.ops.conv_direct import \
    conv_chain_direct as jax_conv_chain_direct
from bnn_pynq_tpu.runtime.engine import InferenceEngine as JaxEngine
from bnn_pynq_tpu_torch.compiler.artifacts import load_artifact
from bnn_pynq_tpu_torch.models import network as port_net
from bnn_pynq_tpu_torch.models.params import params_from_numpy, weight_matrix
from bnn_pynq_tpu_torch.ops import conv_direct, ref
from bnn_pynq_tpu_torch.runtime.engine import InferenceEngine
from bnn_pynq_tpu_torch.runtime.serving import BatchingServer
from tests.test_torch_packed import _images, _mini

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures"
PRETRAINED = sorted(p.stem for p in (REPO / "pretrained").glob("*.npz"))
TOL = dict(rtol=1e-5, atol=1e-5)    # tests/test_golden_fixtures.py:36


def _levels(abits):
    return [-1, 1] if abits == 1 else [-3, -1, 1, 3]


def _hwio(rng, k, c, o, abits):
    return rng.choice(_levels(abits), size=(k, k, c, o)).astype(np.int8)


def _thr(rng, nthr, o, scale):
    return np.sort(rng.integers(-scale, scale, size=(nthr, o)),
                   axis=0).astype(np.int32)


def _wm(hwio):
    """The port's WeightMatrix of HWIO levels ((ki,kj,c) rows)."""
    return weight_matrix(torch.from_numpy(np.array(conv_weight_matrix(hwio))))


# -- conv2d_int_ref -----------------------------------------------------------

@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("stride", [1, 2, 3])
def test_conv2d_int_ref_matches_jax(stride, k):
    """int8 image levels (the raw-image range) and ±3 weight levels."""
    rng = np.random.default_rng(10 * stride + k)
    x = rng.integers(-128, 128, size=(2, 13, 11, 3)).astype(np.int8)
    w = _hwio(rng, k, 3, 8, 2)
    got = ref.conv2d_int_ref(torch.from_numpy(x), torch.from_numpy(w), stride)
    want = jax_ref.conv2d_int_ref(x, w, stride)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- conv2d_direct: the cases of tests/test_conv_direct.py and strides -------

@pytest.mark.parametrize("b,h,c,o,k,abits,nthr,stride", [
    (2, 10, 32, 64, 3, 1, 0, 1),      # W1A1, int32 out
    (3, 8, 64, 128, 3, 1, 0, 1),      # ragged batch for the JAX block
    (1, 6, 128, 256, 3, 1, 0, 1),
    (2, 9, 32, 64, 3, 2, 3, 1),       # W2A2 thresholds
    (1, 12, 8, 16, 5, 1, 0, 1),       # 5×5
    (2, 11, 32, 64, 3, 1, 1, 2),      # tests/test_conv_stack.py strides
    (2, 11, 32, 64, 3, 1, 1, 3),
])
def test_conv2d_direct_matches_jax(b, h, c, o, k, abits, nthr, stride):
    rng = np.random.default_rng(b * h + c + k + stride)
    codes = rng.integers(0, 2 ** abits, size=(b, h, h, c)).astype(np.int8)
    w = _hwio(rng, k, c, o, abits)
    thr = _thr(rng, nthr, o, 50 * abits ** 2) if nthr else None
    want = jax_conv2d_direct(jnp.asarray(codes),
                             jnp.asarray(conv_weight_matrix(w)),
                             None if thr is None else jnp.asarray(thr),
                             kernel=k, abits=abits, stride=stride,
                             interpret=True)
    got = conv_direct.conv2d_direct(
        torch.from_numpy(codes), _wm(w),
        None if thr is None else torch.from_numpy(thr), kernel=k,
        abits=abits, stride=stride)
    assert got.dtype == (torch.int32 if thr is None else torch.int8)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_strided_without_thresholds_raises_as_jax():
    codes = np.zeros((1, 7, 7, 8), np.int8)
    w = np.ones((3, 3, 8, 4), np.int8)
    with pytest.raises(ValueError, match="requires thresholds"):
        jax_conv2d_direct(jnp.asarray(codes),
                          jnp.asarray(conv_weight_matrix(w)), kernel=3,
                          abits=1, stride=2, interpret=True)
    with pytest.raises(ValueError, match="requires thresholds"):
        conv_direct.conv2d_direct(torch.from_numpy(codes), _wm(w), kernel=3,
                                  abits=1, stride=2)


# -- conv_chain_direct --------------------------------------------------------

@pytest.mark.parametrize("abits,chans,input_levels", [
    (1, (32, 64, 64), False),
    (2, (16, 32, 64), False),
    (1, (3, 16, 32), True),           # CNV's first conv: the raw image, C=3
    (2, (3, 16, 32), True),
])
def test_conv_chain_direct_matches_jax(abits, chans, input_levels):
    rng = np.random.default_rng(abits + chans[0])
    b, h = 2, 12
    if input_levels:
        x = rng.integers(-128, 128, size=(b, h, h, chans[0])).astype(np.int8)
    else:
        x = rng.integers(0, 2 ** abits, size=(b, h, h, chans[0])) \
            .astype(np.int8)
    ws = [_hwio(rng, 3, ci, co, abits) for ci, co in zip(chans, chans[1:])]
    ts = [_thr(rng, 2 ** abits - 1, co, 30 * abits * ci)
          for ci, co in zip(chans, chans[1:])]
    if input_levels:
        ts[0] = _thr(rng, 2 ** abits - 1, chans[1], 3000)
    want = jax_conv_chain_direct(
        jnp.asarray(x), [jnp.asarray(conv_weight_matrix(w)) for w in ws],
        [jnp.asarray(t) for t in ts], kernel=3, abits=abits,
        input_levels=input_levels, interpret=True)
    got = conv_direct.conv_chain_direct(
        torch.from_numpy(x), [_wm(w) for w in ws],
        [torch.from_numpy(t) for t in ts], kernel=3, abits=abits,
        input_levels=input_levels)
    assert got.dtype == torch.int8
    assert got.shape == (b, h - 4, h - 4, chans[-1])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_direct_wrappers_on_cpu_run_plain_and_launch_nothing():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(0, 2, size=(2, 7, 7, 8))
                         .astype(np.int8))
    w1, w2 = _wm(_hwio(rng, 3, 8, 12, 1)), _wm(_hwio(rng, 3, 12, 4, 1))
    t1 = torch.from_numpy(_thr(rng, 1, 12, 20))
    t2 = torch.from_numpy(_thr(rng, 1, 4, 20))
    before = (conv_direct.conv2d_direct.launches.value,
              conv_direct.conv_chain_direct.launches.value)
    for thr in (t1, None):
        assert torch.equal(
            conv_direct.conv2d_direct(x, w1, thr, kernel=3, abits=1),
            conv_direct.conv2d_direct_plain(x, w1, thr, kernel=3, abits=1))
    assert torch.equal(
        conv_direct.conv_chain_direct(x, [w1, w2], [t1, t2], kernel=3,
                                      abits=1),
        conv_direct.conv_chain_direct_plain(x, [w1, w2], [t1, t2], kernel=3,
                                            abits=1))
    assert (conv_direct.conv2d_direct.launches.value,
            conv_direct.conv_chain_direct.launches.value) == before


def test_direct_wrappers_reject_bad_operands():
    """JAX's checks (weight rows K²C, one table per layer, no erased map),
    one nthr for a chain, and no fallback for a non-CUDA device."""
    rng = np.random.default_rng(6)
    x = torch.zeros((1, 6, 6, 8), dtype=torch.int8)
    w = _wm(_hwio(rng, 3, 8, 4, 1))
    w4 = _wm(_hwio(rng, 3, 4, 4, 1))
    t1 = torch.zeros((1, 4), dtype=torch.int32)
    t3 = torch.zeros((3, 4), dtype=torch.int32)
    cd = conv_direct
    with pytest.raises(ValueError, match="weight rows"):
        cd.conv2d_direct(x[..., :6], w, t1, kernel=3, abits=1)
    with pytest.raises(ValueError, match="int8"):
        cd.conv2d_direct(x.to(torch.int32), w, t1, kernel=3, abits=1)
    with pytest.raises(ValueError, match="thresholds"):
        cd.conv2d_direct(x, w, t1.to(torch.int64), kernel=3, abits=1)
    with pytest.raises(ValueError, match="no valid region"):
        cd.conv2d_direct(x[:, :2], w, t1, kernel=3, abits=1)
    with pytest.raises(ValueError, match="one threshold table"):
        cd.conv_chain_direct(x, [w, w4], [t1], kernel=3, abits=1)
    with pytest.raises(ValueError, match="same number"):
        cd.conv_chain_direct(x, [w, w4], [t1, t3], kernel=3, abits=2)
    with pytest.raises(ValueError, match="erases"):
        cd.conv_chain_direct(x, [w, w4, w4], [t1] * 3, kernel=3, abits=1)
    with pytest.raises(ValueError, match="weight rows"):
        cd.conv_chain_direct(x, [w, w], [t1, t1], kernel=3, abits=1)
    with pytest.raises(ValueError, match="no kernel for device"):
        cd.conv2d_direct(x.to("meta"), w, t1, kernel=3, abits=1)
    with pytest.raises(ValueError, match="no kernel for device"):
        cd.conv_chain_direct(x.to("meta"), [w, w4], [t1, t1], kernel=3,
                             abits=1)


# -- forward_direct and the engine -------------------------------------------

@pytest.mark.parametrize("wbits,abits", [(1, 1), (2, 2)])
def test_forward_direct_prefixes_match_jax(wbits, abits):
    """Every prefix of the mini CNV: each ends in int32 accumulators (a
    last conv comes back as int32) or a pool of them, equal to JAX
    forward_direct(interpret=True)."""
    jcfg, jc, port = _mini("cnv", wbits, abits)
    x = InferenceEngine(port, device="cpu").prepare(_images(jcfg, 3, 7))
    decoded = jax_net.decode_params(
        jcfg, [{k: jnp.asarray(v) for k, v in p.items()} for p in jc.layers])
    for i in range(len(jcfg.layers)):
        jsub = dataclasses.replace(jcfg, layers=jcfg.layers[:i + 1])
        psub = dataclasses.replace(port.config,
                                   layers=port.config.layers[:i + 1])
        want = jax_net.forward_direct(jsub, decoded[:i + 1], jnp.asarray(x),
                                      interpret=True)
        layers = params_from_numpy(psub, port.layers[:i + 1],
                                   port.out_scale, port.out_bias, "cpu")[0]
        got = port_net.forward_direct(psub, layers, torch.from_numpy(x))
        assert got.dtype == torch.int32, i
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=f"layer {i}")


@pytest.mark.parametrize("kind,wbits,abits", [
    ("cnv", 1, 1), ("cnv", 2, 2), ("mlp", 1, 2)])
def test_direct_engine_matches_jax_engine(kind, wbits, abits):
    jcfg, jc, port = _mini(kind, wbits, abits)
    imgs = _images(jcfg, 5, 8)
    want = JaxEngine(jc, runtime="interpret", route="direct",
                     batch_buckets=(8,)).logits(imgs)
    got = InferenceEngine(port, device="cpu", route="direct",
                          batch_buckets=(8,)).logits(imgs)
    np.testing.assert_allclose(got, want, **TOL)
    assert (got.argmax(1) == want.argmax(1)).all()


def test_golden_fixture_direct_route():
    engine = InferenceEngine.from_artifact(
        str(FIXTURES / "golden_cnv_w2a2.npz"), device="cpu", route="direct")
    io = np.load(FIXTURES / "golden_cnv_w2a2_io.npz")
    np.testing.assert_allclose(engine.logits(io["x"]), io["logits"], **TOL)


@pytest.mark.parametrize("name", PRETRAINED)
def test_pretrained_direct_route_matches_ref(name):
    path = str(REPO / "pretrained" / f"{name}.npz")
    cfg = load_artifact(path).config
    shape = (3,) + (cfg.input_shape if cfg.input_kind == "int8"
                    else (28, 28))
    x = np.random.default_rng(len(name) + 2).integers(
        0, 256, size=shape, dtype=np.uint8)
    want = InferenceEngine.from_artifact(path, device="cpu", runtime="ref",
                                         batch_buckets=(4,)).logits(x)
    got = InferenceEngine.from_artifact(path, device="cpu", route="direct",
                                        batch_buckets=(4,)).logits(x)
    np.testing.assert_array_equal(got, want)


def test_direct_engine_surface_hot_swap_and_server(monkeypatch):
    """logits_device/classify/warmup on the route; a hot swap moves the
    logits; a BatchingServer answers as classify; logits_words works on
    a bipolar net; device='cuda' without CUDA raises."""
    path = str(REPO / "pretrained" / "cnv-w1a1.npz")
    engine = InferenceEngine.from_artifact(path, device="cpu",
                                           route="direct",
                                           batch_buckets=(4, 8))
    x = np.random.default_rng(9).integers(0, 256, size=(6, 32, 32, 3),
                                          dtype=np.uint8)
    logits = engine.warmup(2).logits(x)
    np.testing.assert_array_equal(engine.classify(x), logits.argmax(1))
    out, n = engine.logits_device(x, argmax=True)
    np.testing.assert_array_equal(engine.fetch(out)[:n], logits.argmax(1))
    swapped = load_artifact(path)
    swapped.out_bias = swapped.out_bias + 1.0
    engine.load_parameters(swapped)
    np.testing.assert_allclose(engine.logits(x), logits + 1.0, **TOL)
    prepared = engine.prepare(x)
    want = engine.classify(prepared, prepared=True)
    server = BatchingServer(engine, max_batch=8, max_wait_ms=5.0)
    try:
        singles = [server.submit(prepared[i]) for i in range(2)]
        many = server.submit_many(prepared[2:])
        got = [f.result(60) for f in singles] + list(many.result(60))
    finally:
        server.stop()
    np.testing.assert_array_equal(got, want)

    mlp = InferenceEngine.from_artifact(
        str(REPO / "pretrained" / "sfc-w1a1.npz"), device="cpu",
        route="direct", batch_buckets=(4,))
    digits = np.random.default_rng(10).integers(0, 256, size=(3, 28, 28),
                                                dtype=np.uint8)
    np.testing.assert_array_equal(mlp.logits_words(digits),
                                  mlp.logits(digits))
    with pytest.raises(ValueError, match="packed route"):
        mlp.logits_packed(digits)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceEngine.from_artifact(path, device="cuda", route="direct")


@pytest.mark.parametrize("rc,may_decline,want", [
    (0, False, True), (0, True, True), (-1, True, False),
    (-1, False, RuntimeError), (1, True, RuntimeError)])
def test_library_call_lets_a_launcher_decline_only_where_asked(rc, may_decline,
                                                               want):
    """`bnn_conv_chain_direct` answers DECLINED where no image fits on chip:
    `conv_chain_direct` asks for that answer and runs `conv_chain`; to any
    other caller, and for any CUDA error, the call raises."""
    from types import SimpleNamespace

    from bnn_pynq_tpu_torch.ops import _build
    fake = SimpleNamespace(entry=lambda *args: rc,
                           bnn_error_string=lambda code: b"refused")
    lib = _build.KernelLibrary(lib=fake, path=Path("none"), build_seconds=0.0,
                               build_log="")
    assert _build.DECLINED == -1
    if want is RuntimeError:
        with pytest.raises(RuntimeError, match="entry: CUDA error"):
            lib.call("entry", 1, 2, may_decline=may_decline)
    else:
        assert lib.call("entry", 1, 2, may_decline=may_decline) is want
