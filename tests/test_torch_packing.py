"""The port's bit packing (ops/packing.py), host packers (native.py) and
packed max-pool, held bit for bit against the JAX package on the CPU.
The port's words are int32 tensors holding the uint32 bit pattern, so
each comparison views the JAX words as int32. Inputs are made with numpy
from a seed and handed to both."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bnn_pynq_tpu.ops import conv as jax_conv
from bnn_pynq_tpu.ops import packing as jax_packing
from bnn_pynq_tpu_torch import native
from bnn_pynq_tpu_torch.ops import conv, packing


def _i32(words):
    """JAX/numpy uint32 words → their int32 bit pattern."""
    return np.asarray(words, dtype=np.uint32).view(np.int32)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 64, 100, 784, 1024])
def test_pack_unpack_bits_match_jax(n):
    vals = np.random.default_rng(n).choice([-1, 1], size=(5, n)) \
        .astype(np.int8)
    got = packing.pack_bits(torch.from_numpy(vals), axis=-1)
    assert got.dtype == torch.int32
    assert tuple(got.shape) == (5, packing.packed_len(n, 1))
    np.testing.assert_array_equal(
        got.numpy(), _i32(jax_packing.pack_bits(jnp.asarray(vals), axis=-1)))
    back = packing.unpack_bits(got, n, axis=-1)
    assert back.dtype == torch.int8
    np.testing.assert_array_equal(back.numpy(), vals)


def test_pack_bits_axis0_matches_jax():
    vals = np.random.default_rng(2).choice([-1, 1], size=(100, 7)) \
        .astype(np.int8)
    got = packing.pack_bits(torch.from_numpy(vals), axis=0)
    assert tuple(got.shape) == (packing.packed_len(100, 1), 7)
    np.testing.assert_array_equal(
        got.numpy(), _i32(jax_packing.pack_bits(jnp.asarray(vals), axis=0)))
    np.testing.assert_array_equal(
        packing.unpack_bits(got, 100, axis=0).numpy(), vals)


@pytest.mark.parametrize("n", [1, 15, 16, 17, 50, 576])
def test_pack_unpack_codes2_match_jax(n):
    codes = np.random.default_rng(n).integers(0, 4, size=(4, n)) \
        .astype(np.int8)
    got = packing.pack_codes2(torch.from_numpy(codes), axis=-1)
    assert tuple(got.shape) == (4, packing.packed_len(n, 2))
    np.testing.assert_array_equal(
        got.numpy(),
        _i32(jax_packing.pack_codes2(jnp.asarray(codes), axis=-1)))
    np.testing.assert_array_equal(
        packing.unpack_codes2(got, n, axis=-1).numpy(), codes)
    want = jax_packing.unpack_codes2(
        jax_packing.pack_codes2(jnp.asarray(codes), axis=-1), n, axis=-1)
    np.testing.assert_array_equal(
        packing.unpack_codes2(got, n, axis=-1).numpy(), np.asarray(want))


def test_bit31_and_top_code():
    """Bit 31 makes the int32 word negative: packing must not overflow a
    signed sum, and unpacking must read it back as a set bit."""
    ones = torch.ones((2, 64), dtype=torch.int8)
    words = packing.pack_bits(ones)
    assert (words == -1).all()                   # 0xFFFFFFFF
    assert (packing.unpack_bits(words, 64) == 1).all()
    top = torch.zeros((1, 32), dtype=torch.int8)
    top[0, 31] = 1
    assert packing.pack_bits(top).item() == -2 ** 31
    codes = torch.zeros((1, 16), dtype=torch.int8)
    codes[0, 15] = 3                              # bits 30 and 31
    w = packing.pack_codes2(codes)
    assert w.item() == np.array([3 << 30], np.uint32).view(np.int32)[0]
    assert packing.unpack_codes2(w, 16)[0, 15] == 3
    assert (packing.unpack_codes2(w, 16)[0, :15] == 0).all()


def test_codes_levels_bijection():
    codes = torch.tensor([0, 1, 2, 3], dtype=torch.int8)
    levels = packing.codes2_to_levels(codes)
    np.testing.assert_array_equal(levels.numpy(), [-3, -1, 1, 3])
    np.testing.assert_array_equal(
        levels.numpy(),
        np.asarray(jax_packing.codes2_to_levels(jnp.asarray(codes.numpy()))))
    np.testing.assert_array_equal(packing.levels_to_codes2(levels).numpy(),
                                  codes.numpy())


def test_np_packers_match_jax():
    rng = np.random.default_rng(3)
    vals = rng.choice([-1, 1], size=(9, 77)).astype(np.int8)
    got = packing.np_pack_bits(vals, axis=-1)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, jax_packing.np_pack_bits(vals, -1))
    codes = rng.integers(0, 4, size=(9, 77)).astype(np.int8)
    np.testing.assert_array_equal(packing.np_pack_codes2(codes, axis=1),
                                  jax_packing.np_pack_codes2(codes, axis=1))
    np.testing.assert_array_equal(
        packing.words_to_tensor(got).numpy(),
        packing.pack_bits(torch.from_numpy(vals)).numpy())


def test_pad_bits_are_zero():
    vals = torch.ones((1, 33), dtype=torch.int8)  # 2 words, 31 pad bits
    assert packing.pack_bits(vals)[0, 1].item() == 1
    codes = torch.full((1, 17), 3, dtype=torch.int8)   # 15 pad codes
    assert packing.pack_codes2(codes)[0, 1].item() == 3


@pytest.mark.parametrize("use_lib", [True, False])
def test_native_packers_match_numpy(use_lib, monkeypatch):
    """The C++ library where it is built, else the numpy bodies: both
    give JAX's words."""
    if use_lib and not native.available():
        monkeypatch.setattr(native, "_lib", None)
        assert native.build(), "native toolchain unavailable"
        assert native.available()
    if not use_lib:
        monkeypatch.setattr(native, "_LIB_PATH", "/nonexistent")
        monkeypatch.setattr(native, "_lib", None)
        assert not native.available()
    rng = np.random.default_rng(4)
    imgs = rng.integers(0, 256, size=(17, 28, 28)).astype(np.uint8)
    bipolar = np.where(imgs.reshape(17, -1) >= 128, 1, -1).astype(np.int8)
    want = jax_packing.np_pack_bits(bipolar, axis=-1)
    got = native.binarize_pack(imgs)
    assert got.dtype == np.uint32 and got.shape == (17, 25)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(native.pack_bits(bipolar), want)
    vals = rng.choice([-1, 1], size=(9, 100)).astype(np.int8)
    np.testing.assert_array_equal(native.pack_bits(vals),
                                  jax_packing.np_pack_bits(vals, axis=-1))


@pytest.mark.parametrize("shape", [(2, 8, 8, 3), (1, 9, 7, 2)])
def test_maxpool2d_packed_or_matches_jax(shape):
    words = np.random.default_rng(5).integers(
        0, 2 ** 32, size=shape, dtype=np.uint64).astype(np.uint32)
    got = conv.maxpool2d_packed_or(packing.words_to_tensor(words), 2)
    want = jax_conv.maxpool2d_packed_or(jnp.asarray(words), 2)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _i32(want))


def test_packed_or_pool_equals_code_pool():
    """On 1-bit codes, OR over packed words is the max-pool of the codes
    (the reference's binary max-pool)."""
    codes = torch.from_numpy(np.random.default_rng(6).integers(
        0, 2, size=(2, 6, 6, 64)).astype(np.int8))
    pooled = conv.maxpool2d_packed_or(packing.pack_bits(codes), 2)
    assert torch.equal(packing.pack_bits(conv.maxpool2d(codes, 2)), pooled)
