"""The decoded-integer routes (`xla`, `xlaconv`) of the port on the CPU,
held against the JAX package: `decode_params` array for array,
`forward_xla` in every conv_mode int32 for int32, the engine's logits
within rtol=atol=1e-5 (tests/test_golden_fixtures.py:36) with argmax
equal, the library products (`ops/int_dot.py`) against the references,
the functions the port took over with this route, and `profile_layers`'
rows of it. Mini SFC, LFC and CNV configs × W1A1, W1A2, W2A2, seeded
numpy inputs. What only a card shows (cuBLASLt, cuDNN, the graphs) is
`chip_smoke.py` phase 22."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnn_pynq_tpu import native as jax_native
from bnn_pynq_tpu.compiler.finnthesizer import \
    CompiledNetwork as JaxCompiledNetwork
from bnn_pynq_tpu.models import config as jc
from bnn_pynq_tpu.models import network as jax_net
from bnn_pynq_tpu.ops import conv as jax_conv
from bnn_pynq_tpu.ops import ref as jax_ref
from bnn_pynq_tpu.runtime.engine import InferenceEngine as JaxEngine
from bnn_pynq_tpu.utils.layerprof import profile_layers as jax_profile
from bnn_pynq_tpu_torch import native
from bnn_pynq_tpu_torch.compiler.artifacts import CompiledNetwork
from bnn_pynq_tpu_torch.models import config as pc
from bnn_pynq_tpu_torch.models import network as port_net
from bnn_pynq_tpu_torch.models.params import params_from_numpy
from bnn_pynq_tpu_torch.ops import conv, int_dot, ref
from bnn_pynq_tpu_torch.runtime import engine as engine_mod
from bnn_pynq_tpu_torch.runtime.engine import InferenceEngine
from bnn_pynq_tpu_torch.tools import layer_table
from bnn_pynq_tpu_torch.utils import layerprof

TOL = dict(rtol=1e-5, atol=1e-5)    # tests/test_golden_fixtures.py:36
NETS = ("sfc", "lfc", "cnv")
BITS = ((1, 1), (1, 2), (2, 2))


def _config(mod, net, wbits, abits):
    """Mini configs: SFC and CNV as tests/test_finnthesizer.py's mini_mlp
    and mini_cnv; LFC with three equal hidden layers, as LFC has."""
    if net == "cnv":
        return mod.NetworkConfig(
            name=f"cnv-mini-w{wbits}a{abits}", wbits=wbits, abits=abits,
            input_kind="int8", input_shape=(10, 10, 3),
            layers=(mod.ConvSpec(16), mod.PoolSpec(), mod.ConvSpec(32),
                    mod.DenseSpec(24), mod.DenseSpec(10)),
            num_classes=10, dataset="cifar10")
    hidden = (64, 32) if net == "sfc" else (48, 48, 48)
    shape = (8, 8, 1) if net == "sfc" else (12, 12, 1)
    return mod.NetworkConfig(
        name=f"{net}-mini-w{wbits}a{abits}", wbits=wbits, abits=abits,
        input_kind="bipolar", input_shape=shape,
        layers=tuple(mod.DenseSpec(n) for n in hidden + (10,)),
        num_classes=10, dataset="mnist")


def _params(net, wbits, abits, seed):
    """(JAX config, port config, JAX numpy layers, port layers, scale,
    bias) from `init_random_params` and a seeded scale and bias."""
    jcfg, pcfg = _config(jc, net, wbits, abits), _config(pc, net, wbits,
                                                         abits)
    layers = [{k: np.asarray(v) for k, v in p.items()}
              for p in jax_net.init_random_params(jcfg, seed=seed)]
    rng = np.random.default_rng(seed)
    scale = rng.uniform(0.01, 1.0, size=10).astype(np.float32)
    bias = rng.standard_normal(10).astype(np.float32)
    port = params_from_numpy(pcfg, layers, scale, bias, "cpu")[0]
    return jcfg, pcfg, layers, port, scale, bias


def _inputs(cfg, batch, seed):
    """Seeded prepared input: ±1 for bipolar nets, int8 levels else."""
    rng = np.random.default_rng(seed)
    if cfg.input_kind == "bipolar":
        return rng.choice([-1, 1], size=(
            batch, int(np.prod(cfg.input_shape)))).astype(np.int8)
    return rng.integers(-128, 128, size=(batch,) + tuple(cfg.input_shape)
                        ).astype(np.int8)


def _images(cfg, batch, seed):
    return np.random.default_rng(seed).integers(
        0, 256, size=(batch,) + tuple(cfg.input_shape)).astype(np.uint8)


@pytest.mark.parametrize("wbits,abits", BITS)
@pytest.mark.parametrize("net", NETS)
def test_decode_params_equals_jax(net, wbits, abits):
    jcfg, pcfg, layers, port, _, _ = _params(net, wbits, abits, 1)
    want = jax_net.decode_params(jcfg, [{k: jnp.asarray(v) for k, v in
                                         p.items()} for p in layers])
    got = port_net.decode_params(pcfg, port)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == (torch.int32 if k == "thr"
                                  else torch.int8)
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]),
                                          err_msg=k)


@pytest.mark.parametrize("mode", ["patches", "native", "s2d", "force"])
@pytest.mark.parametrize("wbits,abits", BITS)
@pytest.mark.parametrize("net", NETS)
def test_forward_xla_equals_jax(net, wbits, abits, mode):
    """Every conv_mode, and force_thresholds on 'patches': int32 for
    int32."""
    jcfg, pcfg, layers, port, _, _ = _params(net, wbits, abits, 2)
    x = _inputs(pcfg, 3, 2)
    kw = dict(conv_mode="patches", force_thresholds=True) \
        if mode == "force" else dict(conv_mode=mode)
    want = jax_net.forward_xla(
        jcfg, jax_net.decode_params(jcfg, [{k: jnp.asarray(v) for k, v in
                                            p.items()} for p in layers]),
        jnp.asarray(x), **kw)
    got = port_net.forward_xla(pcfg, port_net.decode_params(pcfg, port),
                               torch.from_numpy(x), **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_forward_xla_rejects_an_unknown_conv_mode():
    _, pcfg, _, port, _, _ = _params("cnv", 1, 1, 2)
    with pytest.raises(ValueError, match="conv_mode"):
        port_net.forward_xla(pcfg, port_net.decode_params(pcfg, port),
                             torch.zeros((1, 10, 10, 3), dtype=torch.int8),
                             conv_mode="bf16")


@pytest.mark.parametrize("route", ["xla", "xlaconv"])
@pytest.mark.parametrize("wbits,abits", BITS)
@pytest.mark.parametrize("net", NETS)
def test_engine_routes_equal_jax_engine(net, wbits, abits, route):
    """Batch 6 over buckets (1, 4): a conv net runs it 4 + 2, an MLP
    padded to 8; then load_parameters with another seed's parameters."""
    outs = []
    x = _images(_config(pc, net, wbits, abits), 6, 3)
    for seed in (3, 4):
        jcfg, pcfg, layers, _, scale, bias = _params(net, wbits, abits,
                                                     seed)
        jax_c = JaxCompiledNetwork(jcfg, layers, scale, bias)
        port_c = CompiledNetwork(pcfg, layers, scale, bias)
        if seed == 3:
            jeng = JaxEngine(jax_c, runtime="interpret", route=route,
                             batch_buckets=(1, 4))
            eng = InferenceEngine(port_c, device="cpu", route=route,
                                  batch_buckets=(1, 4))
        else:
            jeng.load_parameters(jax_c)
            eng.load_parameters(port_c)
        want = jeng.logits(x)
        got = eng.logits(x)
        np.testing.assert_allclose(got, want, **TOL)
        assert (got.argmax(1) == want.argmax(1)).all()
        np.testing.assert_array_equal(eng.classify(x), want.argmax(1))
        outs.append(got)
    assert not np.array_equal(outs[0], outs[1])    # the swap took


@pytest.mark.parametrize("route", ["xla", "xlaconv"])
@pytest.mark.parametrize("net", ["sfc", "cnv"])
def test_programs_equal_the_eager_forward(net, route):
    """On the CPU a program runs the eager forward into fixed buffers:
    equal bit for bit, the clone a buffer of its own; the engine's
    parameters are the decoded ones."""
    _, pcfg, layers, _, scale, bias = _params(net, 2, 2, 5)
    eng = InferenceEngine(CompiledNetwork(pcfg, layers, scale, bias),
                          device="cpu", route=route, batch_buckets=(4,))
    assert all(set(p) <= {"w_int8", "w_hwio", "thr"}
               for p in eng._state.params[0])
    xd = eng.upload(_inputs(pcfg, 4, 5))
    for argmax in (False, True):
        want = eng._eager(eng._state.params, xd, argmax, False)
        got = eng.launch_prepared(xd, argmax=argmax)
        again = eng.launch_prepared(xd, argmax=argmax)
        prog = eng.programs[(tuple(xd.shape), xd.dtype, argmax, False)]
        assert torch.equal(got, want) and torch.equal(again, want)
        assert got.data_ptr() != again.data_ptr() != prog.out.data_ptr()
        assert prog.graph is None and prog.launches == {} and \
            prog.library == {}


@pytest.mark.parametrize("route,calls", [
    ("xla", {"int_mm": 4}), ("xlaconv", {"int_mm": 2, "conv2d": 2})])
def test_routes_call_the_library_only(route, calls):
    """A forward of the mini CNV: one library call a conv or dense layer
    (the convs cuDNN's on 'xlaconv'), no kernel launch, no call of the
    float64 int_matmul_ref; the ref runtime keeps the params'
    layers."""
    _, pcfg, layers, _, scale, bias = _params("cnv", 1, 1, 6)
    compiled = CompiledNetwork(pcfg, layers, scale, bias)
    eng = InferenceEngine(compiled, device="cpu", route=route)
    xd = eng.upload(_inputs(pcfg, 2, 6))
    before = (engine_mod.library_calls(), engine_mod.kernel_launches())
    eng._eager(eng._state.params, xd, False, False)
    moved = engine_mod._moved(before[0], engine_mod.library_calls())
    assert moved == calls
    assert engine_mod.kernel_launches() == before[1]
    refeng = InferenceEngine(compiled, device="cpu", route=route,
                             runtime="ref")
    assert all("w" in p for p in refeng._state.params[0] if p)
    before = engine_mod.library_calls()
    refeng.logits(_images(pcfg, 2, 6))
    assert engine_mod._moved(before, engine_mod.library_calls()) == \
        {"int_matmul_ref": 4}


def test_the_route_names():
    assert engine_mod.XLA_ROUTES == {"xla": "patches", "xlaconv": "native"}
    assert not set(engine_mod.XLA_ROUTES) & set(engine_mod.MEGA_ROUTES)
    assert "s2d" in engine_mod.MEGA_ROUTES
    assert set(engine_mod.ROUTES) >= {"mega", "s2d", "fused", "xla",
                                      "xlaconv", "mxu", "mxu_rm", "vpu",
                                      "direct"}


# -- the library products ------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(1, 27, 10), (1, 27, 64), (5, 576, 10),
                                   (17, 32, 16), (40, 2304, 256),
                                   (3, 784, 1024)])
def test_int_matmul_equals_int_matmul_ref(m, k, n):
    """Ragged K (27: CNV's first conv) and N (10: the last layer), batch-1
    rows, and K-aligned shapes, on both weight layouts."""
    rng = np.random.default_rng(m * k + n)
    a = rng.integers(-128, 128, size=(m, k)).astype(np.int8)
    w = rng.choice([-3, -1, 1, 3], size=(k, n)).astype(np.int8)
    want = np.asarray(jax_ref.int_matmul_ref(jnp.asarray(a), jnp.asarray(w)))
    ta, tw = torch.from_numpy(a), torch.from_numpy(w)
    np.testing.assert_array_equal(ref.int_matmul_ref(ta, tw).numpy(), want)
    for weights in (tw, int_dot.k_contiguous(tw)):
        got = int_dot.int_matmul(ta, weights)
        assert got.dtype == torch.int32 and got.shape == (m, n)
        np.testing.assert_array_equal(got.numpy(), want)


def test_int_matmul_counts_its_calls_and_takes_int8_only():
    a = torch.ones((2, 8), dtype=torch.int8)
    before = int_dot.int_matmul.calls.value
    int_dot.int_matmul(a, torch.ones((8, 8), dtype=torch.int8))
    assert int_dot.int_matmul.calls.value == before + 1
    with pytest.raises(TypeError, match="int8"):
        int_dot.int_matmul(a.to(torch.int32),
                           torch.ones((8, 8), dtype=torch.int8))


@pytest.mark.parametrize("c,n,kernel,stride,amax", [
    (3, 16, 3, 1, 128), (16, 8, 3, 2, 3), (64, 32, 3, 1, 3),
    (5, 7, 5, 1, 3)])
def test_int_conv2d_equals_conv2d_int_ref(c, n, kernel, stride, amax):
    rng = np.random.default_rng(c + n)
    x = rng.integers(-amax, amax, size=(2, 11, 9, c)).astype(np.int8)
    w = rng.choice([-3, -1, 1, 3], size=(kernel, kernel, c, n)) \
        .astype(np.int8)
    want = np.asarray(jax_ref.conv2d_int_ref(jnp.asarray(x), jnp.asarray(w),
                                             stride))
    got = int_dot.int_conv2d(torch.from_numpy(x), torch.from_numpy(w),
                             stride)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ref.conv2d_int_ref(torch.from_numpy(x), torch.from_numpy(w),
                           stride).numpy(), want)


# -- the functions the port lacked ------------------------------------------

def test_int_matmul_wide_ref_equals_jax():
    rng = np.random.default_rng(7)
    a = rng.integers(-40_000, 40_000, size=(6, 33)).astype(np.int32)
    w = rng.integers(-300, 300, size=(33, 5)).astype(np.int32)
    want = np.asarray(jax_ref.int_matmul_wide_ref(jnp.asarray(a),
                                                  jnp.asarray(w)))
    got = ref.int_matmul_wide_ref(torch.from_numpy(a), torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32


@pytest.mark.parametrize("nthr", [1, 3])
def test_binary_layer_ref_equals_jax(nthr):
    rng = np.random.default_rng(nthr)
    a = rng.choice([-3, -1, 1, 3], size=(7, 40)).astype(np.int8)
    w = rng.choice([-1, 1], size=(40, 12)).astype(np.int8)
    thr = np.sort(rng.integers(-30, 30, size=(nthr, 12)), axis=0) \
        .astype(np.int32)
    want = np.asarray(jax_ref.binary_layer_ref(
        jnp.asarray(a), jnp.asarray(w), jnp.asarray(thr)))
    got = ref.binary_layer_ref(torch.from_numpy(a), torch.from_numpy(w),
                               torch.from_numpy(thr))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape,window", [((2, 8, 8, 3), 2),
                                          ((1, 7, 9, 5), 2),
                                          ((3, 9, 9, 2), 3)])
def test_maxpool2d_codes_ref_equals_jax(shape, window):
    codes = np.random.default_rng(window).integers(0, 4, size=shape) \
        .astype(np.int8)
    want = np.asarray(jax_ref.maxpool2d_codes_ref(jnp.asarray(codes),
                                                  window))
    got = ref.maxpool2d_codes_ref(torch.from_numpy(codes), window)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        conv.maxpool2d(torch.from_numpy(codes), window).numpy(), want)


def test_conv_weight_matrix_equals_jax():
    w = np.random.default_rng(8).choice([-1, 1], size=(3, 3, 5, 7)) \
        .astype(np.int8)
    want = np.asarray(jax_conv.conv_weight_matrix(jnp.asarray(w)))
    got = conv.conv_weight_matrix(torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), want)
    # the patch order of sliding_window: patches · matrix == the conv
    x = np.random.default_rng(9).choice([-1, 1], size=(1, 4, 4, 5)) \
        .astype(np.int8)
    patches = conv.sliding_window(torch.from_numpy(x), 3, 3)
    np.testing.assert_array_equal(
        ref.int_matmul_ref(patches.reshape(4, 45), got).numpy().reshape(
            1, 2, 2, 7),
        np.asarray(jax_ref.conv2d_int_ref(jnp.asarray(x), jnp.asarray(w))))


def test_native_build_binds_the_library(monkeypatch):
    """The port's build() runs the repo's make and binds what it built;
    its ops then give JAX's; a failed make returns False."""
    monkeypatch.setattr(native, "_lib", None)
    assert native.build(), "native toolchain unavailable"
    assert native.available() and native._lib is not None
    imgs = np.random.default_rng(10).integers(0, 256, size=(5, 28, 28)) \
        .astype(np.uint8)
    np.testing.assert_array_equal(native.binarize_pack(imgs),
                                  jax_native.binarize_pack(imgs))
    monkeypatch.setattr(native, "_NATIVE_DIR", "/nonexistent")
    assert not native.build()


# -- profiling -------------------------------------------------------------

@pytest.mark.parametrize("route", ["xla", "xlaconv"])
@pytest.mark.parametrize("net", ["sfc", "cnv"])
def test_profile_layers_a_row_a_layer(net, route):
    """JAX's rows of the decoded-integer route: a row a layer of the plan,
    its kind, k, n and MACs JAX's; the layer functions compose to
    forward_xla."""
    jcfg, pcfg, layers, port, scale, bias = _params(net, 1, 1, 11)
    compiled = CompiledNetwork(pcfg, layers, scale, bias)
    rows = layerprof.profile_layers(compiled, batch=2, iters=1,
                                    device="cpu", route=route)
    jrows = jax_profile(JaxCompiledNetwork(jcfg, layers, scale, bias),
                        batch=2, iters=1)
    assert [r["layers"] for r in rows] == [[i] for i in range(len(jrows))]
    assert [r["stage"] for r in rows] == [f"layer{i}"
                                          for i in range(len(jrows))]
    for r, j in zip(rows, jrows):
        assert {k: r[k] for k in ("layer", "kind", "k", "n", "macs")} == \
            {k: j[k] for k in ("layer", "kind", "k", "n", "macs")}
        assert r["ms"] > 0
    plan = port_net.make_plan(pcfg)
    decoded = port_net.decode_params(pcfg, port)
    x = torch.from_numpy(_inputs(pcfg, 2, 11))
    act = port_net.prepare_input(pcfg, x)
    for fn in layerprof._layer_fns(pcfg, plan, decoded,
                                   engine_mod.XLA_ROUTES[route]):
        act = fn(act)
    assert torch.equal(act, port_net.forward_xla(
        pcfg, decoded, x, conv_mode=engine_mod.XLA_ROUTES[route]))


def test_layer_table_takes_the_route(tmp_path):
    out = tmp_path / "layers.jsonl"
    assert layer_table.main(["--device", "cpu", "--net", "cnv-w1a1",
                             "--route", "xla", "--batch", "1", "--iters",
                             "1", "--out", str(out)]) == 0
    *rows, total = [json.loads(line) for line in
                    out.read_text().splitlines()]
    assert [r["stage"] for r in rows] == [f"layer{i}" for i in range(11)]
    assert all(r["route"] == "xla" and r["device"] == "cpu" for r in rows)
    assert total["layer"] == "__total__" and total["route"] == "xla"
