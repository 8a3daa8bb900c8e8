"""The port's kernel wrappers on the CPU (their plain versions) against the
JAX package's Pallas kernels in interpret mode, as tests/test_conv_stack.py
runs them. Codes must be equal; float logits within rtol=atol=1e-5 (the
JAX test tolerance for logits, tests/test_golden_fixtures.py).

The CUDA kernels themselves run only on a card: chip_smoke.py holds each
against its plain version there."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bnn_pynq_tpu.ops.conv import sliding_window as jax_sliding_window
from bnn_pynq_tpu.ops.conv_stack import conv_chain_vmem
from bnn_pynq_tpu.ops.conv_stack import dense_block as jax_dense_block
from bnn_pynq_tpu.ops.fused_mlp import fused_mlp_forward_padded
from bnn_pynq_tpu_torch.models.params import weight_matrix
from bnn_pynq_tpu_torch.ops import conv_stack, fused_mlp

SCHEMES = [(1, 1), (1, 2), (2, 2)]          # (wbits, abits)


def _layers(rng, widths, wbits, abits, k=1):
    """Random int8 levels [k²·C_in, C_out] and sorted int32 thresholds."""
    wl = [-1, 1] if wbits == 1 else [-3, -1, 1, 3]
    nthr = 2 ** abits - 1
    ws, ts = [], []
    for cin, cout in zip(widths[:-1], widths[1:]):
        ws.append(rng.choice(wl, size=(k * k * cin, cout)).astype(np.int8))
        scale = k * k * cin * (3 if wbits == 2 else 1)
        ts.append(np.sort(rng.integers(-scale // 2, scale // 2,
                                       size=(nthr, cout)), axis=0)
                  .astype(np.int32))
    return ws, ts


def _port(ws, ts):
    return ([weight_matrix(torch.from_numpy(w)) for w in ws],
            [torch.from_numpy(t) for t in ts])


def _jax(arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("wbits,abits", SCHEMES)
def test_fused_mlp_matches_jax(wbits, abits):
    rng = np.random.default_rng(10 * wbits + abits)
    b, widths = 13, [96, 64, 48, 10]          # ragged batch
    ws, ts = _layers(rng, widths, wbits, abits)
    x = rng.integers(0, 2 ** abits, size=(b, widths[0])).astype(np.int8)
    scale = rng.uniform(0.01, 1.0, size=10).astype(np.float32)
    bias = rng.standard_normal(10).astype(np.float32)
    want = fused_mlp_forward_padded(
        jnp.asarray(x), _jax(ws), _jax(ts[:-1]), jnp.asarray(scale),
        jnp.asarray(bias), abits=abits, interpret=True)
    pw, pt = _port(ws, ts[:-1])
    got = fused_mlp.fused_mlp_forward(
        torch.from_numpy(x), pw, pt, torch.from_numpy(scale),
        torch.from_numpy(bias), abits=abits)
    assert got.dtype == torch.float32 and got.shape == (b, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("wbits,abits", SCHEMES)
def test_dense_block_matches_jax(wbits, abits):
    rng = np.random.default_rng(20 + 10 * wbits + abits)
    m, widths = 37, [96, 64, 48]
    ws, ts = _layers(rng, widths, wbits, abits)
    x = rng.integers(0, 2 ** abits, size=(m, widths[0])).astype(np.int8)
    want = jax_dense_block(jnp.asarray(x), _jax(ws), _jax(ts), abits=abits,
                           interpret=True)
    got = conv_stack.dense_block(torch.from_numpy(x), *_port(ws, ts),
                                 abits=abits)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("wbits,abits", SCHEMES)
def test_conv_chain_on_codes_matches_jax(wbits, abits):
    """Two chained convs on codes; the JAX kernel's full-grid output is
    sliced to the valid region the port returns."""
    rng = np.random.default_rng(40 + 10 * wbits + abits)
    b, h, k, chans = 3, 12, 3, [32, 64, 32]
    ws, ts = _layers(rng, chans, wbits, abits, k=k)
    x = rng.integers(0, 2 ** abits, size=(b, h, h, chans[0])).astype(np.int8)
    full = conv_chain_vmem(jnp.asarray(x), _jax(ws), _jax(ts), kernel=k,
                           abits=abits, interpret=True)
    want = np.asarray(full)[:, :h - 4, :h - 4, :]
    got = conv_stack.conv_chain(torch.from_numpy(x), *_port(ws, ts),
                                kernel=k, abits=abits)
    assert got.shape == (b, h - 4, h - 4, chans[-1])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("wbits,abits", SCHEMES)
def test_conv_chain_on_raw_image_matches_jax(wbits, abits):
    """First conv on the raw int8 image (levels, C=3): the JAX route
    prebuilds its patches (im2col0); the port reads the image directly."""
    rng = np.random.default_rng(60 + 10 * wbits + abits)
    b, h, k, chans = 2, 12, 3, [3, 32, 32]
    ws, ts = _layers(rng, chans, wbits, abits, k=k)
    scale = 27 * 128 * (3 if wbits == 2 else 1)
    ts[0] = np.sort(rng.integers(-scale // 8, scale // 8,
                                 size=ts[0].shape), axis=0).astype(np.int32)
    img = rng.integers(-128, 128, size=(b, h, h, 3)).astype(np.int8)
    patches = jax_sliding_window(jnp.asarray(img), k, k, 1)
    full = conv_chain_vmem(patches, _jax(ws), _jax(ts), kernel=k,
                           abits=abits, input_patches=True,
                           input_levels=True, interpret=True)
    want = np.asarray(full)[:, :h - 4, :h - 4, :]
    got = conv_stack.conv_chain(torch.from_numpy(img), *_port(ws, ts),
                                kernel=k, abits=abits, input_levels=True)
    np.testing.assert_array_equal(got.numpy(), want)


# odd shapes the tensor-core kernels mask or run on their slower paths:
# (widths, m) with N not a multiple of 8 or 16, K not a multiple of 32
@pytest.mark.parametrize("widths,m", [([96, 10], 1), ([96, 100], 1023),
                                      ([40, 72, 10], 37)])
@pytest.mark.parametrize("wbits,abits", [(1, 1), (2, 2)])
def test_dense_block_odd_shapes_match_jax(wbits, abits, widths, m):
    rng = np.random.default_rng(80 + 10 * wbits + abits + m)
    ws, ts = _layers(rng, widths, wbits, abits)
    x = rng.integers(0, 2 ** abits, size=(m, widths[0])).astype(np.int8)
    want = jax_dense_block(jnp.asarray(x), _jax(ws), _jax(ts), abits=abits,
                           interpret=True)
    got = conv_stack.dense_block(torch.from_numpy(x), *_port(ws, ts),
                                 abits=abits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# (kernel, channels, h): C = 24 (no 32-byte steps per tap; the JAX kernel
# takes such a first layer as prebuilt patches), a 5×5 kernel, N = 10 and 100
@pytest.mark.parametrize("k,chans,h", [(3, [24, 10], 8), (5, [32, 100], 9),
                                       (5, [24, 32, 8], 11)])
@pytest.mark.parametrize("wbits,abits", [(1, 1), (2, 2)])
def test_conv_chain_odd_shapes_match_jax(wbits, abits, k, chans, h):
    rng = np.random.default_rng(90 + 10 * wbits + abits + k + h)
    b = 1 if h == 8 else 3
    ws, ts = _layers(rng, chans, wbits, abits, k=k)
    x = rng.integers(0, 2 ** abits, size=(b, h, h, chans[0])).astype(np.int8)
    patches = chans[0] % 32 != 0
    xin = jax_sliding_window(jnp.asarray(x), k, k, 1) if patches \
        else jnp.asarray(x)
    full = conv_chain_vmem(xin, _jax(ws), _jax(ts), kernel=k, abits=abits,
                           input_patches=patches, interpret=True)
    oh = h - (len(chans) - 1) * (k - 1)
    want = np.asarray(full)[:, :oh, :oh, :]
    got = conv_stack.conv_chain(torch.from_numpy(x), *_port(ws, ts),
                                kernel=k, abits=abits)
    assert got.shape == (b, oh, oh, chans[-1])
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrappers_on_cpu_run_plain_and_launch_nothing():
    rng = np.random.default_rng(7)
    ws, ts = _layers(rng, [48, 32, 16], 1, 1)
    pw, pt = _port(ws, ts)
    x = torch.from_numpy(rng.integers(0, 2, size=(5, 48)).astype(np.int8))
    counters = [fused_mlp.fused_mlp_forward.launches,
                conv_stack.dense_block.launches,
                conv_stack.conv_chain.launches]
    before = [c.value for c in counters]
    assert torch.equal(conv_stack.dense_block(x, pw, pt, abits=1),
                       conv_stack.dense_block_plain(x, pw, pt, abits=1))
    s, bb = torch.ones(16), torch.zeros(16)
    assert torch.equal(
        fused_mlp.fused_mlp_forward(x, pw, pt[:1], s, bb, abits=1),
        fused_mlp.fused_mlp_forward_plain(x, pw, pt[:1], s, bb, abits=1))
    assert [c.value for c in counters] == before


def test_wrappers_reject_other_devices_and_bad_operands():
    """Only a CPU tensor reaches a plain version; any other non-CUDA
    device raises instead of falling back."""
    rng = np.random.default_rng(8)
    ws, ts = _layers(rng, [48, 32], 1, 1)
    pw, pt = _port(ws, ts)
    meta = torch.empty((4, 48), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        conv_stack.dense_block(meta, pw, pt, abits=1)
    x = torch.zeros((4, 48), dtype=torch.int8)
    with pytest.raises(ValueError):
        conv_stack.dense_block(x.to(torch.int32), pw, pt, abits=1)
    with pytest.raises(ValueError):
        conv_stack.dense_block(x[:, :40], pw, pt, abits=1)
    with pytest.raises(ValueError):
        conv_stack.dense_block(x, pw, [pt[0].to(torch.int64)], abits=1)
    img = torch.zeros((1, 4, 4, 3), dtype=torch.int8)
    w27 = weight_matrix(torch.ones((27, 8), dtype=torch.int8))
    t8 = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="no valid region"):
        conv_stack.conv_chain(img, [w27, weight_matrix(
            torch.ones((72, 8), dtype=torch.int8))], [t8, t8], kernel=3,
            abits=1)
