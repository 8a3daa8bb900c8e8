"""The port's compiler against the JAX package's, on the CPU.

The same trained-style parameters (random flax params with BatchNorm
perturbed so that negative and zero slopes occur) go through both
`compile_network`s: every layer array, `out_scale` and `out_bias` must be
equal byte for byte. Artifacts written by either package load in the
other, and `InferenceEngine.from_training` gives the JAX engine's logits
(`rtol=atol=1e-5`, argmax equal: the port's own tolerance for float
logits; the integer arrays are compared exactly).
"""

import json

import numpy as np
import jax
import pytest
from flax import traverse_util
from flax.core import freeze, unfreeze

from bnn_pynq_tpu.compiler import artifacts as jax_art
from bnn_pynq_tpu.compiler import finnthesizer as jax_fin
from bnn_pynq_tpu.models import config as jc
from bnn_pynq_tpu.runtime.engine import InferenceEngine as JaxEngine
from bnn_pynq_tpu.train.model import BN_EPS as JAX_BN_EPS
from bnn_pynq_tpu.train.model import QuantNet
import bnn_pynq_tpu_torch.compiler as port_compiler
from bnn_pynq_tpu_torch.compiler import artifacts as port_art
from bnn_pynq_tpu_torch.compiler import finnthesizer as port_fin
from bnn_pynq_tpu_torch.models import config as pc
from bnn_pynq_tpu_torch.ops.thresholds import THR_ALWAYS, THR_NEVER
from bnn_pynq_tpu_torch.runtime.engine import InferenceEngine
from bnn_pynq_tpu_torch.train.model import BN_EPS

TOL = dict(rtol=1e-5, atol=1e-5)


def _sfc(mod, wbits, abits):
    return mod.NetworkConfig(
        name=f"sfc-w{wbits}a{abits}", wbits=wbits, abits=abits,
        input_kind="bipolar", input_shape=(8, 8, 1),
        layers=(mod.DenseSpec(64), mod.DenseSpec(32), mod.DenseSpec(10)),
        num_classes=10, dataset="mnist")


def _lfc(mod, wbits, abits):
    return mod.NetworkConfig(
        name=f"lfc-w{wbits}a{abits}", wbits=wbits, abits=abits,
        input_kind="bipolar", input_shape=(8, 8, 1),
        layers=(mod.DenseSpec(96), mod.DenseSpec(96), mod.DenseSpec(96),
                mod.DenseSpec(10)),
        num_classes=10, dataset="mnist")


def _cnv(mod, wbits, abits):
    return mod.NetworkConfig(
        name=f"cnv-w{wbits}a{abits}", wbits=wbits, abits=abits,
        input_kind="int8", input_shape=(10, 10, 3),
        layers=(mod.ConvSpec(16), mod.PoolSpec(), mod.ConvSpec(32),
                mod.DenseSpec(24), mod.DenseSpec(10)),
        num_classes=10, dataset="cifar10")


NETS = {"sfc": _sfc, "lfc": _lfc, "cnv": _cnv}
GRID = [(net, w, a) for net in NETS for (w, a) in ((1, 1), (1, 2), (2, 2))]


def _perturbed(jcfg, seed):
    """Flax params of the training model, BatchNorm perturbed as
    `tests/test_finnthesizer.py::init_perturbed` does: channel 0 of every
    scale negative, channel 1 zero."""
    model = QuantNet(jcfg)
    shape = ((2, int(np.prod(jcfg.input_shape)))
             if jcfg.input_kind == "bipolar" else (2,) + jcfg.input_shape)
    variables = model.init(jax.random.PRNGKey(seed),
                           np.zeros(shape, np.float32), train=False)
    rng = np.random.default_rng(seed)
    flat_p = traverse_util.flatten_dict(unfreeze(variables["params"]))
    for path, leaf in flat_p.items():
        if path[-1] == "scale":
            v = rng.normal(1.0, 0.6, size=leaf.shape).astype(np.float32)
            v[0], v[1] = -0.5, 0.0
            flat_p[path] = v
        elif path[-1] == "bias":
            flat_p[path] = rng.normal(
                0.0, 1.0, size=leaf.shape).astype(np.float32)
    flat_s = traverse_util.flatten_dict(unfreeze(variables["batch_stats"]))
    for path, leaf in flat_s.items():
        if path[-1] == "mean":
            flat_s[path] = rng.normal(
                0.0, 3.0, size=leaf.shape).astype(np.float32)
        elif path[-1] == "var":
            flat_s[path] = np.abs(rng.normal(
                1.0, 0.5, size=leaf.shape)).astype(np.float32) + 0.01
    return (freeze(traverse_util.unflatten_dict(flat_p)),
            freeze(traverse_util.unflatten_dict(flat_s)))


def _assert_same_bytes(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert got.tobytes() == want.tobytes(), what


def _assert_compiled_equal(got, want):
    assert len(got.layers) == len(want.layers)
    for i, (g, w) in enumerate(zip(got.layers, want.layers)):
        assert sorted(g) == sorted(w), i
        for name in w:
            _assert_same_bytes(g[name], w[name], f"layer {i} {name}")
    _assert_same_bytes(got.out_scale, want.out_scale, "out_scale")
    _assert_same_bytes(got.out_bias, want.out_bias, "out_bias")


def _compile_both(net, wbits, abits, seed, meta=None):
    jcfg, pcfg = NETS[net](jc, wbits, abits), NETS[net](pc, wbits, abits)
    params, stats = _perturbed(jcfg, seed)
    return (jax_fin.compile_network(jcfg, params, stats, meta=meta),
            port_fin.compile_network(pcfg, params, stats, meta=meta),
            (jcfg, pcfg, params, stats))


def _uint8_batch(cfg, seed, b=8):
    return np.random.default_rng(seed).integers(
        0, 256, size=(b,) + cfg.input_shape).astype(np.uint8)


def test_bn_eps_is_the_training_models():
    assert BN_EPS == JAX_BN_EPS


def test_compiler_exports_match_the_reference_package():
    for name in ("CompiledNetwork", "compile_network", "save_artifact",
                 "load_artifact"):
        assert hasattr(port_compiler, name), name


@pytest.mark.parametrize("net,wbits,abits", GRID)
def test_compile_network_equals_jax_byte_for_byte(net, wbits, abits):
    want, got, (_, _, params, _) = _compile_both(
        net, wbits, abits, seed=40 + wbits * 10 + abits)
    scales = [np.asarray(v) for k, v in
              traverse_util.flatten_dict(unfreeze(params)).items()
              if k[-1] == "scale"]
    assert all((s < 0).any() and (s == 0).any() for s in scales)
    _assert_compiled_equal(got, want)
    thr = [l["thr"] for l in got.layers if "thr" in l]
    assert any(((t == THR_ALWAYS) | (t == THR_NEVER)).any() for t in thr)


@pytest.mark.parametrize("net,wbits,abits", GRID)
def test_compile_network_takes_plain_dicts(net, wbits, abits):
    """A plain nested dict of numpy arrays (no `.unfreeze()`) compiles to
    the same arrays as the frozen tree."""
    want, _, (_, pcfg, params, stats) = _compile_both(net, wbits, abits, 3)
    plain = lambda t: {k: (plain(v) if hasattr(v, "items")
                           else np.asarray(v)) for k, v in t.items()}
    got = port_fin.compile_network(pcfg, plain(params), plain(stats))
    _assert_compiled_equal(got, want)


@pytest.mark.parametrize("wbits", [1, 2])
def test_quantize_weights_equals_jax(wbits):
    rng = np.random.default_rng(wbits)
    w = rng.normal(0.0, 0.6, size=(3, 3, 5, 7)).astype(np.float32)
    # Values on the quantizer's float32 boundaries.
    w.reshape(-1)[:6] = np.float32([0.0, -0.0, 1 / 3, -1 / 3, 2 / 3, -2 / 3])
    _assert_same_bytes(port_fin._quantize_weights_np(w, wbits),
                       jax_fin._quantize_weights_np(w, wbits), "levels")


@pytest.mark.parametrize("abits", [1, 2])
@pytest.mark.parametrize("s", [1.0, 1.0 / 3.0, 1.0 / 128.0, 1.0 / 9.0])
def test_fold_equals_jax(abits, s):
    """The inputs of `tests/test_fold_exhaustive.py`: negative, zero and
    near-zero slopes."""
    rng = np.random.default_rng(42)
    n_ch = 64
    gamma = rng.normal(0.8, 1.0, n_ch).astype(np.float32)
    gamma[:4] = [-1.3, 0.0, 1e-6, -1e-6]
    beta = rng.normal(0.0, 1.5, n_ch).astype(np.float32)
    mean = rng.normal(0.0, 5.0, n_ch).astype(np.float32)
    var = np.abs(rng.normal(1.0, 0.5, n_ch)).astype(np.float32) + 1e-3
    _assert_same_bytes(port_fin._activation_boundaries(abits),
                       jax_fin._activation_boundaries(abits), "boundaries")
    b = port_fin._activation_boundaries(abits)
    want_thr, want_flip = jax_fin._fold_bn_to_thresholds(
        gamma, beta, mean, var, s, b)
    thr, flip = port_fin._fold_bn_to_thresholds(gamma, beta, mean, var, s, b)
    _assert_same_bytes(thr, want_thr, "thr")
    _assert_same_bytes(flip, want_flip, "flip")
    assert flip[0] and not flip[1]


def test_unsupported_abits_raises_as_jax():
    for fin in (jax_fin, port_fin):
        with pytest.raises(ValueError):
            fin._activation_boundaries(3)


def test_overflow_guard_raises_where_jax_does():
    """A dense layer whose K × 3 × 127 reaches 2^30 is refused by both;
    one step narrower is taken by both."""
    def cfg(mod, side):
        return mod.NetworkConfig(
            name="wide", wbits=1, abits=1, input_kind="int8",
            input_shape=(side, side, 1),
            layers=(mod.DenseSpec(1), mod.DenseSpec(2)), num_classes=2,
            dataset="cifar10")

    def trees(k):
        bn = lambda n: {"scale": np.ones(n, np.float32),
                        "bias": np.zeros(n, np.float32)}
        st = lambda n: {"mean": np.zeros(n, np.float32),
                        "var": np.ones(n, np.float32)}
        params = {"quant_0": {"kernel": np.ones((k, 1), np.float32)},
                  "bn_0": bn(1),
                  "quant_1": {"kernel": np.ones((1, 2), np.float32)},
                  "bn_1": bn(2)}
        return params, {"bn_0": st(1), "bn_1": st(2)}

    side = 1679                      # 1679² × 381 >= 2^30 > 1678² × 381
    assert side * side * 3 * 127 >= (1 << 30) > (side - 1) ** 2 * 3 * 127
    params, stats = trees(side * side)
    for fin, mod in ((jax_fin, jc), (port_fin, pc)):
        with pytest.raises(OverflowError):
            fin.compile_network(cfg(mod, side), params, stats)
    params, stats = trees((side - 1) ** 2)
    _assert_compiled_equal(
        port_fin.compile_network(cfg(pc, side - 1), params, stats),
        jax_fin.compile_network(cfg(jc, side - 1), params, stats))


@pytest.mark.parametrize("net,wbits,abits", GRID)
def test_config_to_json_equals_jax(net, wbits, abits):
    jcfg, pcfg = NETS[net](jc, wbits, abits), NETS[net](pc, wbits, abits)
    want = jax_art.config_to_json(jcfg)
    assert port_art.config_to_json(pcfg) == want
    assert json.dumps(port_art.config_to_json(pcfg)) == json.dumps(want)
    assert port_art.config_from_json(want) == pcfg


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("net,wbits,abits",
                         [("sfc", 1, 1), ("lfc", 1, 2), ("cnv", 2, 2)])
def test_artifacts_cross_load(tmp_path, writer, net, wbits, abits):
    """An artifact saved by either package loads in the other with equal
    arrays and manifest; the two files hold the same members and bytes."""
    meta = {"val_acc": np.float32(0.5), "epochs": np.int64(3),
            "hist": np.arange(3), "note": "x"}
    want, got, _ = _compile_both(net, wbits, abits, seed=9, meta=meta)
    pj, pp = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jax_art.save_artifact(pj, want)
    port_art.save_artifact(pp, got)
    with np.load(pj) as zj, np.load(pp) as zp:
        assert zj.files == zp.files
        for key in zj.files:
            _assert_same_bytes(zp[key], zj[key], key)
    path = pj if writer == "jax" else pp
    in_port, in_jax = port_art.load_artifact(path), jax_art.load_artifact(path)
    _assert_compiled_equal(in_port, want)
    _assert_compiled_equal(in_jax, got)
    assert in_port.meta == in_jax.meta == {
        "val_acc": 0.5, "epochs": 3, "hist": [0, 1, 2], "note": "x"}
    assert port_art.config_to_json(in_port.config) == \
        jax_art.config_to_json(in_jax.config)


def test_save_artifact_makes_its_directory(tmp_path):
    _, got, _ = _compile_both("sfc", 1, 1, seed=1)
    path = str(tmp_path / "deep" / "er" / "a.npz")
    port_art.save_artifact(path, got)
    _assert_compiled_equal(port_art.load_artifact(path), got)


@pytest.mark.parametrize("net,wbits,abits", GRID)
def test_from_training_equals_jax_engine(net, wbits, abits):
    jcfg, pcfg = NETS[net](jc, wbits, abits), NETS[net](pc, wbits, abits)
    params, stats = _perturbed(jcfg, seed=50 + wbits * 10 + abits)
    x = _uint8_batch(jcfg, seed=0)
    want = np.asarray(JaxEngine.from_training(
        jcfg, params, stats, runtime="ref").logits(x))
    engine = InferenceEngine.from_training(
        pcfg, params, stats, device="cpu", runtime="ref")
    got = engine.logits(x)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    # The kernel route on the CPU (plain versions) gives the same logits.
    kernels = InferenceEngine.from_training(
        pcfg, params, stats, device="cpu", runtime="kernels").logits(x)
    np.testing.assert_allclose(kernels, want, **TOL)


@pytest.mark.parametrize("net", ["sfc", "cnv"])
def test_from_training_matches_the_float_model(net):
    """The compiled integer engine reproduces the float model it was
    compiled from (the tolerance of `tests/test_finnthesizer.py`)."""
    from bnn_pynq_tpu.train import data as data_mod
    jcfg, pcfg = NETS[net](jc, 1, 2), NETS[net](pc, 1, 2)
    params, stats = _perturbed(jcfg, seed=52)
    x = _uint8_batch(jcfg, seed=0, b=16)
    xf = data_mod.train_inputs(jcfg.dataset, x, jcfg.input_kind)
    want = np.asarray(QuantNet(jcfg).apply(
        {"params": params, "batch_stats": stats}, xf, train=False))
    got = InferenceEngine.from_training(
        pcfg, params, stats, device="cpu", runtime="ref").logits(x)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
