"""The PyTorch port's integer ops and parameter carry-over, held exactly
against the JAX package on the CPU. Inputs are made with numpy from a
seed and handed to both."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bnn_pynq_tpu.compiler.artifacts import load_artifact as jax_load
from bnn_pynq_tpu.models import config as jax_config
from bnn_pynq_tpu.models.network import decode_params, init_random_params
from bnn_pynq_tpu.ops import conv as jax_conv
from bnn_pynq_tpu.ops import ref as jax_ref
from bnn_pynq_tpu.ops import thresholds as jax_thr
from bnn_pynq_tpu_torch.compiler.artifacts import load_artifact
from bnn_pynq_tpu_torch.models import config as port_config
from bnn_pynq_tpu_torch.models.network import make_plan
from bnn_pynq_tpu_torch.models.params import (K_ALIGN_MMA, params_from_numpy,
                                              unpack_levels, weight_matrix)
from bnn_pynq_tpu_torch.ops import conv, ref, thresholds


def _np(a):
    return np.asarray(a)


def test_configs_are_copies():
    assert sorted(port_config.AVAILABLE_CONFIGS) == \
        sorted(jax_config.AVAILABLE_CONFIGS)
    for name in jax_config.AVAILABLE_CONFIGS:
        assert repr(port_config.get_config(name)) == \
            repr(jax_config.get_config(name))


def test_load_artifact_matches_jax():
    for name in ("cnv-w2a2", "lfc-w1a1"):
        path = f"pretrained/{name}.npz"
        got, want = load_artifact(path), jax_load(path)
        assert repr(got.config) == repr(want.config)
        assert got.meta == want.meta
        np.testing.assert_array_equal(got.out_scale, want.out_scale)
        np.testing.assert_array_equal(got.out_bias, want.out_bias)
        for g, w in zip(got.layers, want.layers):
            assert sorted(g) == sorted(w)
            for k in g:
                np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("name", ["sfc-w1a1", "sfc-w1a2", "cnv-w1a1",
                                  "cnv-w2a2"])
def test_params_from_numpy_matches_decode_params(name):
    """bits=1 (W1A1) and bits=2 (W1A2, W2A2) words decode to the same
    int8 levels as the JAX package's decode_params."""
    jcfg = jax_config.get_config(name)
    params = init_random_params(jcfg, seed=5)
    decoded = decode_params(jcfg, params)
    layers_np = [{k: _np(v) for k, v in p.items()} for p in params]
    rng = np.random.default_rng(0)
    scale = rng.standard_normal(jcfg.num_classes).astype(np.float32)
    bias = rng.standard_normal(jcfg.num_classes).astype(np.float32)
    pcfg = port_config.get_config(name)
    layers, t_scale, t_bias = params_from_numpy(pcfg, layers_np, scale,
                                                bias, "cpu")
    np.testing.assert_array_equal(t_scale.numpy(), scale)
    np.testing.assert_array_equal(t_bias.numpy(), bias)
    for lp, got, want in zip(make_plan(pcfg), layers, decoded):
        if lp.kind == "pool":
            assert got == {}
            continue
        w = want["w_int8"] if "w_int8" in want else \
            _np(want["w_hwio"]).reshape(lp.k, lp.n)
        np.testing.assert_array_equal(got["w"].kn.numpy(), _np(w))
        nk = got["w"].nk32.numpy()
        assert nk.shape == (lp.n, -(-lp.k // K_ALIGN_MMA) * K_ALIGN_MMA)
        np.testing.assert_array_equal(nk[:, :lp.k], _np(w).T)
        assert not nk[:, lp.k:].any()
        if "thr" in want:
            np.testing.assert_array_equal(got["thr"].numpy(),
                                          _np(want["thr"]))
        else:
            assert "thr" not in got


@pytest.mark.parametrize("bits", [1, 2])
def test_unpack_levels_drops_padding(bits):
    from bnn_pynq_tpu.ops import packing
    rng = np.random.default_rng(bits)
    k, n = 45, 7                     # 45 is not a multiple of 16 or 32
    if bits == 1:
        lev = rng.choice([-1, 1], size=(k, n)).astype(np.int8)
        words = packing.np_pack_bits(lev, axis=0)
    else:
        codes = rng.integers(0, 4, size=(k, n)).astype(np.int8)
        lev = (2 * codes - 3).astype(np.int8)
        words = packing.np_pack_codes2(codes, axis=0)
    np.testing.assert_array_equal(unpack_levels(words, k, bits), lev)


def test_weight_matrix_layouts():
    kn = torch.from_numpy(np.random.default_rng(1).integers(
        -3, 4, size=(27, 5)).astype(np.int8))
    w = weight_matrix(kn)
    assert w.nk32.shape == (5, 32) and w.nk32.is_contiguous()
    assert torch.equal(w.nk32[:, :27].t(), kn) and not w.nk32[:, 27:].any()
    with pytest.raises(TypeError):
        weight_matrix(kn.to(torch.int32))


@pytest.mark.parametrize("nthr", [1, 3])
def test_multithreshold_matches(nthr):
    rng = np.random.default_rng(nthr)
    acc = rng.integers(-300, 300, size=(4, 6, 33)).astype(np.int32)
    thr = np.sort(rng.integers(-200, 200, size=(nthr, 33)), axis=0) \
        .astype(np.int32)
    thr[:, 0] = thresholds.THR_NEVER     # degenerate channels
    thr[:, 1] = thresholds.THR_ALWAYS
    got = thresholds.multithreshold(torch.from_numpy(acc),
                                    torch.from_numpy(thr))
    want = jax_thr.multithreshold(jnp.asarray(acc), jnp.asarray(thr))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), _np(want))
    assert (got[..., 0] == 0).all() and (got[..., 1] == nthr).all()
    with pytest.raises(TypeError):
        thresholds.multithreshold(torch.from_numpy(acc).float(),
                                  torch.from_numpy(thr))


@pytest.mark.parametrize("abits", [1, 2])
def test_codes_to_values_matches(abits):
    codes = np.random.default_rng(abits).integers(
        0, 2 ** abits, size=(3, 17)).astype(np.int8)
    got = thresholds.codes_to_values(torch.from_numpy(codes), abits)
    want = jax_thr.codes_to_values(jnp.asarray(codes), abits)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), _np(want))


@pytest.mark.parametrize("k,stride", [(3, 1), (2, 2), (3, 2)])
def test_sliding_window_matches(k, stride):
    x = np.random.default_rng(k).integers(
        -128, 128, size=(2, 9, 8, 5)).astype(np.int8)
    got = conv.sliding_window(torch.from_numpy(x), k, k, stride)
    want = jax_conv.sliding_window(jnp.asarray(x), k, k, stride)
    np.testing.assert_array_equal(got.numpy(), _np(want))


@pytest.mark.parametrize("shape", [(2, 10, 10, 4), (1, 11, 7, 3)])
def test_maxpool2d_matches(shape):
    codes = np.random.default_rng(2).integers(
        0, 4, size=shape).astype(np.int8)
    got = conv.maxpool2d(torch.from_numpy(codes), 2)
    want = jax_conv.maxpool2d(jnp.asarray(codes), 2)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), _np(want))


def test_int_matmul_ref_exact():
    """Raw-image magnitudes (|a| ≤ 128) against ±3 weights, CNV's widest
    contraction: exact against the JAX reference."""
    rng = np.random.default_rng(3)
    a = rng.integers(-128, 128, size=(9, 2304)).astype(np.int8)
    w = rng.choice([-3, -1, 1, 3], size=(2304, 11)).astype(np.int8)
    got = ref.int_matmul_ref(torch.from_numpy(a), torch.from_numpy(w))
    want = jax_ref.int_matmul_ref(jnp.asarray(a), jnp.asarray(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _np(want))
