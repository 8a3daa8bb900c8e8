"""The packed routes of the port ('vpu', 'mxu', 'mxu_rm') on the CPU,
held against the JAX package: `packed_matmul` against JAX's Pallas
kernel in interpret mode (as tests/test_matmul.py runs it),
`conv2d_packed`, the packed `forward` layer by layer, the engine's packed
inputs and their rejections, the server's packed transport, the golden
fixtures and every pretrained artifact. Codes and int32 accumulators must
be equal; float logits within rtol=atol=1e-5, the JAX tolerance
(tests/test_golden_fixtures.py:36).

The CUDA kernel itself runs only on a card: chip_smoke.py holds each arm
against `packed_matmul_plain` there."""

import dataclasses
import functools
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bnn_pynq_tpu.compiler import compile_network
from bnn_pynq_tpu.models import network as jax_net
from bnn_pynq_tpu.ops import packing as jax_packing
from bnn_pynq_tpu.ops import ref as jax_ref
from bnn_pynq_tpu.ops.conv import conv2d_packed as jax_conv2d_packed
from bnn_pynq_tpu.ops.matmul import packed_matmul as jax_packed_matmul
from bnn_pynq_tpu.ops.matmul import \
    packed_matmul_padded as jax_packed_matmul_padded
from bnn_pynq_tpu.runtime.engine import InferenceEngine as JaxEngine
from bnn_pynq_tpu_torch import native
from bnn_pynq_tpu_torch.compiler.artifacts import (CompiledNetwork,
                                                   load_artifact)
from bnn_pynq_tpu_torch.models import config as pc
from bnn_pynq_tpu_torch.models import network as port_net
from bnn_pynq_tpu_torch.models.params import params_from_numpy
from bnn_pynq_tpu_torch.ops import matmul, ref
from bnn_pynq_tpu_torch.ops.conv import conv2d_packed
from bnn_pynq_tpu_torch.ops.thresholds import THR_ALWAYS, THR_NEVER
from bnn_pynq_tpu_torch.runtime.engine import InferenceEngine
from bnn_pynq_tpu_torch.runtime.serving import BatchingServer
from tests.test_finnthesizer import init_perturbed, mini_cnv, mini_mlp

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures"
PRETRAINED = sorted(p.stem for p in (REPO / "pretrained").glob("*.npz"))
TOL = dict(rtol=1e-5, atol=1e-5)    # tests/test_golden_fixtures.py:36
SCHEMES = [(1, 1), (1, 2), (2, 2)]          # (wbits, abits)
ROUTES = ["mxu", "mxu_rm", "vpu"]


def _routes(bits):
    return ROUTES if bits == 1 else ["mxu", "mxu_rm"]


def _i32(words):
    """JAX uint32 words → the port's int32 tensor of the same bits."""
    return torch.from_numpy(np.asarray(words, dtype=np.uint32)
                            .view(np.int32).copy())


def _w1a1(rng, m, k, n):
    return (rng.choice([-1, 1], size=(m, k)).astype(np.int8),
            rng.choice([-1, 1], size=(k, n)).astype(np.int8))


def _codes2(rng, m, k, n, w_binary):
    a = rng.integers(0, 4, size=(m, k)).astype(np.int8)
    w = (rng.choice([1, 2], size=(k, n)) if w_binary
         else rng.integers(0, 4, size=(k, n))).astype(np.int8)
    return a, w


def _both(a_p, w_p, thr, *, k, bits, route):
    """(port, JAX) outputs of packed_matmul on the same words."""
    got = matmul.packed_matmul(
        _i32(a_p), _i32(w_p), None if thr is None else torch.from_numpy(thr),
        k=k, bits=bits, route=route)
    want = jax_packed_matmul(a_p, w_p, None if thr is None
                             else jnp.asarray(thr), k=k, bits=bits,
                             route=route, interpret=True)
    return got.numpy(), np.asarray(want)


# -- packed_matmul: the cases of tests/test_matmul.py ----------------------

@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("m,k,n", [(128, 256, 128), (128, 100, 128),
                                   (256, 784, 256)])
def test_w1a1_acc_exact(route, m, k, n):
    rng = np.random.default_rng(m + k + n)
    a, w = _w1a1(rng, m, k, n)
    got, want = _both(jax_packing.pack_bits(a, axis=-1),
                      jax_packing.pack_bits(w, axis=0), None, k=k, bits=1,
                      route=route)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, ref.binary_matmul_ref(torch.from_numpy(a),
                                   torch.from_numpy(w)).numpy())


@pytest.mark.parametrize("route", ROUTES)
def test_w1a1_threshold_fused(route):
    rng = np.random.default_rng(11)
    m, k, n = 128, 200, 128
    a, w = _w1a1(rng, m, k, n)
    thr = np.sort(rng.integers(-k, k, size=(1, n)), axis=0).astype(np.int32)
    got, want = _both(jax_packing.pack_bits(a, axis=-1),
                      jax_packing.pack_bits(w, axis=0), thr, k=k, bits=1,
                      route=route)
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("route", ["mxu", "mxu_rm"])
@pytest.mark.parametrize("w_binary", [True, False])
def test_2bit_acc_exact(w_binary, route):
    """W1A2 (binary weights stored as 2-bit codes) and W2A2."""
    rng = np.random.default_rng(12 + w_binary)
    m, k, n = 128, 150, 128
    a, w = _codes2(rng, m, k, n, w_binary)
    got, want = _both(jax_packing.pack_codes2(a, axis=-1),
                      jax_packing.pack_codes2(w, axis=0), None, k=k, bits=2,
                      route=route)
    np.testing.assert_array_equal(got, want)
    golden = jax_ref.int_matmul_ref(jax_packing.codes2_to_levels(a),
                                    jax_packing.codes2_to_levels(w))
    np.testing.assert_array_equal(got, np.asarray(golden))


@pytest.mark.parametrize("route", ["mxu", "mxu_rm"])
def test_2bit_threshold_fused(route):
    rng = np.random.default_rng(13)
    m, k, n = 128, 90, 128
    a, w = _codes2(rng, m, k, n, w_binary=False)
    thr = np.sort(rng.integers(-3 * k, 3 * k, size=(3, n)), axis=0) \
        .astype(np.int32)
    got, want = _both(jax_packing.pack_codes2(a, axis=-1),
                      jax_packing.pack_codes2(w, axis=0), thr, k=k, bits=2,
                      route=route)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("route", ROUTES)
def test_padded_wrapper_arbitrary_m(route):
    """Ragged M (37): the JAX wrapper pads M to its block; the port's
    kernel masks it."""
    rng = np.random.default_rng(14)
    m, k, n = 37, 64, 128
    a, w = _w1a1(rng, m, k, n)
    a_p, w_p = jax_packing.pack_bits(a, axis=-1), jax_packing.pack_bits(w, 0)
    got = matmul.packed_matmul_padded(_i32(a_p), _i32(w_p), k=k, bits=1,
                                      route=route)
    want = jax_packed_matmul_padded(a_p, w_p, k=k, bits=1, route=route,
                                    interpret=True)
    assert tuple(got.shape) == (m, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("route", ROUTES)
def test_padded_n_columns_with_sentinel_thresholds(route):
    """N=10 classes padded to 128 columns with THR_NEVER (always 0) and one
    THR_ALWAYS column (always 1)."""
    rng = np.random.default_rng(15)
    m, k, n_true, n_pad = 128, 64, 10, 128
    a, w = _w1a1(rng, m, k, n_true)
    w_full = np.zeros((k, n_pad), dtype=np.int8)
    w_full[:, :n_true] = w
    thr = np.full((1, n_pad), THR_NEVER, dtype=np.int32)
    thr[0, :n_true] = 0
    thr[0, n_true] = THR_ALWAYS
    got, want = _both(jax_packing.pack_bits(a, axis=-1),
                      jax_packing.pack_bits(w_full, axis=0), thr, k=k,
                      bits=1, route=route)
    np.testing.assert_array_equal(got, want)
    assert (got[:, n_true + 1:] == 0).all() and (got[:, n_true] == 1).all()
    golden = a.astype(np.int32) @ w.astype(np.int32)
    np.testing.assert_array_equal(got[:, :n_true],
                                  (golden >= 0).astype(np.int8))


@pytest.mark.parametrize("k", [27, 45, 1])
def test_ragged_k_routes_agree(k):
    """K not a multiple of 32 or 16: the popcount arm (k − 2·popc) and the
    decode arm (minus n_pad·padval²) give the same int32 as the plain
    version, for bits 1 and 2."""
    rng = np.random.default_rng(k)
    m, n = 19, 10
    a, w = _w1a1(rng, m, k, n)
    want = a.astype(np.int32) @ w.astype(np.int32)
    a_p = _i32(jax_packing.pack_bits(a, axis=-1))
    w_p = _i32(jax_packing.pack_bits(w, axis=0))
    for route in ROUTES:
        got = matmul.packed_matmul(a_p, w_p, k=k, bits=1, route=route)
        np.testing.assert_array_equal(got.numpy(), want)
    a2, w2 = _codes2(rng, m, k, n, w_binary=False)
    want2 = (2 * a2.astype(np.int32) - 3) @ (2 * w2.astype(np.int32) - 3)
    for route in ("mxu", "mxu_rm"):
        got = matmul.packed_matmul(_i32(jax_packing.pack_codes2(a2, -1)),
                                   _i32(jax_packing.pack_codes2(w2, 0)),
                                   k=k, bits=2, route=route)
        np.testing.assert_array_equal(got.numpy(), want2)


def test_packed_matmul_checks_and_counts():
    """JAX's argument checks; a CPU tensor runs the plain version and
    launches nothing; any other non-CUDA device raises."""
    w = torch.zeros((2, 8), dtype=torch.int32)
    a = torch.zeros((5, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="packed K mismatch"):
        matmul.packed_matmul(a, torch.zeros((3, 8), dtype=torch.int32),
                             k=64, bits=1)
    with pytest.raises(ValueError, match="implies Kw"):
        matmul.packed_matmul(a, w, k=100, bits=1)
    with pytest.raises(ValueError, match="requires bits=1"):
        matmul.packed_matmul(a, w, k=32, bits=2, route="vpu")
    with pytest.raises(ValueError, match="unknown route"):
        matmul.packed_matmul(a, w, k=64, bits=1, route="xla")
    with pytest.raises(ValueError):
        matmul.packed_matmul(a.to(torch.int64), w, k=64, bits=1)
    with pytest.raises(ValueError, match="thr"):
        matmul.packed_matmul(a, w, torch.zeros((4, 8), dtype=torch.int32),
                             k=64, bits=1)
    arms = matmul.packed_matmul.launches
    before = {r: c.value for r, c in arms.items()}
    for route in ROUTES:
        out = matmul.packed_matmul(a, w, k=64, bits=1, route=route)
        assert torch.equal(out, matmul.packed_matmul_plain(a, w, k=64,
                                                           bits=1))
    assert {r: c.value for r, c in arms.items()} == before
    with pytest.raises(ValueError, match="no kernel for device"):
        matmul.packed_matmul(a.to("meta"), w.to("meta"), k=64, bits=1)


# -- conv2d_packed -----------------------------------------------------------

@pytest.mark.parametrize("bits,c,stride", [(1, 32, 1), (1, 12, 1),
                                           (2, 16, 1), (2, 6, 2)])
def test_conv2d_packed_matches_jax(bits, c, stride):
    """Both branches: C a multiple of the word's capacity (pack along C,
    then window the words) and not (window the codes, then pack)."""
    rng = np.random.default_rng(bits * 100 + c)
    b, h, kernel, o = 2, 7, 3, 24
    x = rng.integers(0, 2 ** bits, size=(b, h, h, c)).astype(np.int8)
    k = kernel * kernel * c
    wc = rng.integers(0, 2 ** bits, size=(k, o)).astype(np.int8)
    w_p = (jax_packing.np_pack_bits(wc, axis=0) if bits == 1
           else jax_packing.np_pack_codes2(wc, axis=0))
    scale = k * (1 if bits == 1 else 9)
    thr = np.sort(rng.integers(-scale // 4, scale // 4,
                               size=(2 ** bits - 1, o)), axis=0) \
        .astype(np.int32)
    thr[:, 0] = THR_NEVER
    for route in _routes(bits):
        for t in (thr, None):
            got = conv2d_packed(torch.from_numpy(x), _i32(w_p),
                                None if t is None else torch.from_numpy(t),
                                kernel=kernel, stride=stride, bits=bits,
                                route=route)
            want = jax_conv2d_packed(jnp.asarray(x), jnp.asarray(w_p),
                                     None if t is None else jnp.asarray(t),
                                     kernel=kernel, stride=stride,
                                     bits=bits, route=route, interpret=True)
            assert got.shape == want.shape, route
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the packed forward and the engine ---------------------------------------

def _port_config(jcfg):
    layers = tuple(getattr(pc, type(s).__name__)(**dataclasses.asdict(s))
                   for s in jcfg.layers)
    return pc.NetworkConfig(
        name=jcfg.name, wbits=jcfg.wbits, abits=jcfg.abits,
        input_kind=jcfg.input_kind, input_shape=tuple(jcfg.input_shape),
        layers=layers, num_classes=jcfg.num_classes, dataset=jcfg.dataset)


@functools.lru_cache(maxsize=None)
def _mini(kind, wbits, abits):
    """A mini config (tests/test_finnthesizer.py) compiled from perturbed
    float params: (JAX config, JAX CompiledNetwork, port CompiledNetwork)."""
    jcfg = (mini_mlp if kind == "mlp" else mini_cnv)(wbits, abits)
    _, params, stats = init_perturbed(jcfg, seed=40 + 10 * wbits + abits)
    jc = compile_network(jcfg, params, stats)
    port = CompiledNetwork(
        config=_port_config(jcfg),
        layers=[{k: np.asarray(v) for k, v in p.items()} for p in jc.layers],
        out_scale=np.asarray(jc.out_scale), out_bias=np.asarray(jc.out_bias))
    return jcfg, jc, port


def _images(cfg, n, seed):
    return np.random.default_rng(seed).integers(
        0, 256, size=(n,) + tuple(cfg.input_shape)).astype(np.uint8)


@pytest.mark.parametrize("wbits,abits", SCHEMES)
@pytest.mark.parametrize("kind", ["mlp", "cnv"])
def test_forward_layer_by_layer_matches_jax(kind, wbits, abits):
    """Every prefix of the network ends in its int32 accumulators (or a
    pool of them): the port's packed forward equals JAX
    forward(impl="pallas", interpret=True) on each, on every route."""
    jcfg, jc, port = _mini(kind, wbits, abits)
    eng = InferenceEngine(port, device="cpu")
    x = eng.prepare(_images(jcfg, 3, 7))
    for route in _routes(jcfg.bits):
        for i in range(len(jcfg.layers)):
            jsub = dataclasses.replace(jcfg, layers=jcfg.layers[:i + 1])
            psub = dataclasses.replace(port.config,
                                       layers=port.config.layers[:i + 1])
            want = jax_net.forward(
                jsub, [{k: jnp.asarray(v) for k, v in p.items()}
                       for p in jc.layers[:i + 1]],
                jnp.asarray(x), impl="pallas", route=route, interpret=True)
            layers = params_from_numpy(psub, port.layers[:i + 1],
                                       port.out_scale, port.out_bias,
                                       "cpu")[0]
            got = port_net.make_forward_fn(psub, route=route)(
                layers, torch.from_numpy(x))
            assert got.dtype == torch.int32, (route, i)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f"{route} layer {i}")


@pytest.mark.parametrize("wbits,abits", SCHEMES)
@pytest.mark.parametrize("kind", ["mlp", "cnv"])
def test_engine_routes_match_jax_engine(kind, wbits, abits):
    """Float logits of the port's engine on every route against the JAX
    engine on the same route in interpret mode."""
    jcfg, jc, port = _mini(kind, wbits, abits)
    imgs = _images(jcfg, 5, 8)
    for route in _routes(jcfg.bits):
        want = JaxEngine(jc, runtime="interpret", route=route,
                         batch_buckets=(8,)).logits(imgs)
        got = InferenceEngine(port, device="cpu", route=route,
                              batch_buckets=(8,)).logits(imgs)
        np.testing.assert_allclose(got, want, **TOL)
        assert (got.argmax(1) == want.argmax(1)).all()


@pytest.mark.parametrize("wbits,abits", SCHEMES)
def test_engine_packed_inputs_match_logits(wbits, abits):
    """logits_words / words_device on every route, and logits_packed on
    the W1A1 'mxu'/'vpu' routes, equal prepare() + logits()."""
    jcfg, jc, port = _mini("mlp", wbits, abits)
    imgs = _images(jcfg, 6, 9)
    words = native.binarize_pack(imgs)
    for route in ["mega"] + _routes(jcfg.bits):
        e = InferenceEngine(port, device="cpu", route=route,
                            batch_buckets=(8,))
        standard = e.logits(imgs)
        np.testing.assert_array_equal(e.logits_words(imgs), standard)
        out, b = e.words_device(words)
        assert b == 6 and tuple(out.shape) == (8, 10)
        np.testing.assert_array_equal(e.fetch(out)[:b], standard)
        out, b = e.words_device(words, argmax=True)
        np.testing.assert_array_equal(e.fetch(out)[:b], standard.argmax(1))
        xd = e.upload(e._pad_to_bucket(words)[0])
        assert xd.dtype == torch.int32
        np.testing.assert_array_equal(
            e.fetch(e.launch_prepared(xd, words=True))[:6], standard)
        if jcfg.bits == 1 and route in ("mxu", "vpu"):
            np.testing.assert_array_equal(e.logits_packed(imgs), standard)
    if jcfg.bits == 1:
        want = JaxEngine(jc, runtime="interpret", route="mxu",
                         batch_buckets=(8,)).logits_packed(imgs)
        np.testing.assert_allclose(standard, want, **TOL)


def test_packed_inputs_reject_what_jax_rejects():
    _, _, w1a1 = _mini("mlp", 1, 1)
    _, _, w1a2 = _mini("mlp", 1, 2)
    _, _, cnv = _mini("cnv", 1, 1)
    imgs = np.zeros((1, 8, 8, 1), np.uint8)
    # packed input needs a W1A1 net on 'mxu'/'vpu' (JAX also rejects
    # 'mxu_rm' and every code route) and a kernel runtime
    for kw in (dict(route="mega"), dict(route="mxu_rm"),
               dict(route="mxu", runtime="ref")):
        with pytest.raises(ValueError):
            InferenceEngine(w1a1, device="cpu", **kw).logits_packed(imgs)
    with pytest.raises(ValueError, match="W1A1"):
        InferenceEngine(w1a2, device="cpu", route="mxu").logits_packed(imgs)
    layers = params_from_numpy(w1a2.config, w1a2.layers, w1a2.out_scale,
                               w1a2.out_bias, "cpu")[0]
    with pytest.raises(ValueError, match="W1A1"):
        port_net.forward(w1a2.config, layers,
                         torch.zeros((1, 2), dtype=torch.int32), route="mxu")
    # image-input nets take no words
    e = InferenceEngine(cnv, device="cpu", route="mxu")
    cimgs = np.zeros((1, 10, 10, 3), np.uint8)
    for call in (lambda: e.logits_words(cimgs),
                 lambda: e.logits_packed(cimgs),
                 lambda: e.words_device(np.zeros((1, 10), np.uint32))):
        with pytest.raises(ValueError):
            call()
    with pytest.raises(ValueError, match="route"):
        InferenceEngine(w1a1, device="cpu", route="bogus")
    with pytest.raises(ValueError, match="W1A1"):
        InferenceEngine(w1a2, device="cpu", route="vpu")


@pytest.mark.parametrize("pipeline_depth", [1, 2])
def test_batching_server_packed_transport(pipeline_depth):
    """A pipelined server over a bipolar engine packs each batch on the
    host and launches through words_device; the answers are classify's."""
    engine = InferenceEngine.from_artifact(
        str(REPO / "pretrained" / "sfc-w1a1.npz"), device="cpu",
        route="vpu", batch_buckets=(16,))
    x = engine.prepare(_images(engine.config, 20, 10))
    want = engine.classify(x, prepared=True)
    calls = []
    words_device = engine.words_device

    def counted(words, **kw):
        calls.append(words.shape)
        return words_device(words, **kw)

    engine.words_device = counted
    server = BatchingServer(engine, max_batch=16, max_wait_ms=20.0,
                            pipeline_depth=pipeline_depth)
    assert server.packed_transport == (pipeline_depth > 1)
    try:
        got = server.submit_many(x).result(60)
        one = server.submit(x[3]).result(60)
    finally:
        server.stop()
    np.testing.assert_array_equal(got, want)
    assert one == want[3]
    if pipeline_depth > 1:
        assert calls and all(s[1] == 25 for s in calls)   # 784 bits
    else:
        assert not calls


@pytest.mark.parametrize("tag,route", [
    ("mlp_w1a1", "mxu"), ("mlp_w1a1", "vpu"), ("mlp_w1a1", "mxu_rm"),
    ("cnv_w2a2", "mxu"), ("cnv_w2a2", "mxu_rm")])
def test_golden_fixtures_packed_routes(tag, route):
    engine = InferenceEngine.from_artifact(
        str(FIXTURES / f"golden_{tag}.npz"), device="cpu", route=route)
    io = np.load(FIXTURES / f"golden_{tag}_io.npz")
    np.testing.assert_allclose(engine.logits(io["x"]), io["logits"], **TOL)


@pytest.mark.parametrize("name", PRETRAINED)
def test_pretrained_packed_routes_match_ref(name):
    """Every pretrained artifact on every packed route it takes gives the
    reference engine's logits (which tests/test_torch_network.py holds
    against JAX)."""
    path = str(REPO / "pretrained" / f"{name}.npz")
    cfg = load_artifact(path).config
    shape = (3,) + (cfg.input_shape if cfg.input_kind == "int8"
                    else (28, 28))
    x = np.random.default_rng(len(name) + 1).integers(
        0, 256, size=shape, dtype=np.uint8)
    want = InferenceEngine.from_artifact(path, device="cpu", runtime="ref",
                                         batch_buckets=(4,)).logits(x)
    for route in _routes(cfg.bits):
        got = InferenceEngine.from_artifact(path, device="cpu", route=route,
                                            batch_buckets=(4,)).logits(x)
        np.testing.assert_array_equal(got, want, err_msg=route)
