"""Strided convs in the port, against the JAX package on the CPU:
`conv_chain_vmem` and its prebuilt-patch input (`input_patches`), the
`mega` stage list of nets whose convs stride (their `im2col{i}` stages),
the engine's `mega` and `s2d` routes on a compiled strided artifact,
OverlapTPEngine's strided convs on both arms in a gloo world of 2 CPU
ranks, `fused_mlp_forward_padded`, and the quantizers called as JAX
calls them.

JAX's Pallas kernels run in interpret mode, as tests/test_conv_stack.py
runs them; the port's wrappers run their plain versions (CPU tensors).
Codes and int32 logits must be equal; float logits within rtol=atol=1e-5
(tests/test_golden_fixtures.py:36). The world's ranks run this file's
module-level job function, so JAX is imported inside the tests only.
"""

import warnings

import numpy as np
import pytest
import torch

from bnn_pynq_tpu_torch.compiler.artifacts import (CompiledNetwork,
                                                   load_artifact)
from bnn_pynq_tpu_torch.models import config as pc
from bnn_pynq_tpu_torch.models import network as port_net
from bnn_pynq_tpu_torch.models.params import (params_from_numpy,
                                              weight_matrix)
from bnn_pynq_tpu_torch.ops import conv_stack, fused_mlp
from bnn_pynq_tpu_torch.ops.conv import sliding_window
from bnn_pynq_tpu_torch.parallel.launch import run_world
from bnn_pynq_tpu_torch.parallel.overlap import OverlapTPEngine
from bnn_pynq_tpu_torch.runtime.engine import InferenceEngine
from bnn_pynq_tpu_torch.train import quant as pq

TOL = dict(rtol=1e-5, atol=1e-5)    # tests/test_golden_fixtures.py:36


def _codes_to_levels(codes, abits):
    return 2 * codes.astype(np.int32) - (1 if abits == 1 else 3)


def _rand_net(rng, chans, k, abits, wbits):
    """tests/test_conv_stack.py's random chain: levels [K²C_in, C_out] and
    sorted thresholds."""
    weights, thrs = [], []
    wl = [-1, 1] if wbits == 1 else [-3, -1, 1, 3]
    nthr = 1 if abits == 1 else 3
    for cin, cout in zip(chans[:-1], chans[1:]):
        weights.append(rng.choice(wl, size=(k * k * cin, cout))
                       .astype(np.int8))
        scale = k * k * cin * (3 if wbits == 2 else 1)
        thrs.append(np.sort(rng.integers(-scale, scale,
                                         size=(nthr, cout)), axis=0)
                    .astype(np.int32))
    return weights, thrs


def _port(weights, thrs):
    return ([weight_matrix(torch.from_numpy(w)) for w in weights],
            [torch.from_numpy(t) for t in thrs])


def _jax_chain(x, weights, thrs, **kw):
    import jax.numpy as jnp
    from bnn_pynq_tpu.ops.conv_stack import conv_chain_vmem as jax_vmem
    return np.asarray(jax_vmem(jnp.asarray(x),
                               [jnp.asarray(w) for w in weights],
                               [jnp.asarray(t) for t in thrs],
                               interpret=True, **kw))


# -- conv_chain_vmem -------------------------------------------------------

@pytest.mark.parametrize("abits,wbits", [(1, 1), (2, 2)])
@pytest.mark.parametrize("input_patches", [False, True])
def test_conv_chain_vmem_matches_jax(abits, wbits, input_patches):
    """tests/test_conv_stack.py:42-80's chain: two 3×3 layers 32→64→32 on
    codes, or on the first layer's prebuilt patches."""
    import jax.numpy as jnp
    from bnn_pynq_tpu.ops.conv import sliding_window as jax_window
    rng = np.random.default_rng(42)
    b, h, w, k = 3, 12, 12, 3
    weights, thrs = _rand_net(rng, [32, 64, 32], k, abits, wbits)
    codes = rng.integers(0, 2 ** abits,
                         size=(b, h, w, 32)).astype(np.int8)
    x = np.array(jax_window(jnp.asarray(codes), k, k, 1)) \
        if input_patches else codes
    kw = dict(kernel=k, abits=abits, input_patches=input_patches)
    want = _jax_chain(x, weights, thrs, **kw)
    pw, pt = _port(weights, thrs)
    got = conv_stack.conv_chain_vmem(torch.from_numpy(x), pw, pt, **kw)
    assert tuple(got.shape) == want.shape == x.shape[:3] + (32,)
    valid = x.shape[1] - (1 if input_patches else 2) * (k - 1)
    np.testing.assert_array_equal(got[:, :valid, :valid].numpy(),
                                  want[:, :valid, :valid])
    assert not got[:, valid:].any() and not got[:, :, valid:].any()
    # the routes' form: the valid region alone
    np.testing.assert_array_equal(
        conv_stack.conv_chain(torch.from_numpy(x), pw, pt, **kw).numpy(),
        want[:, :valid, :valid])


@pytest.mark.parametrize("stride", [1, 2])
def test_conv_chain_vmem_input_levels_int8(stride):
    """tests/test_conv_stack.py:83-96: prebuilt patches of a raw int8
    image (levels), one layer; at stride 2 a second, in-kernel layer."""
    import jax.numpy as jnp
    from bnn_pynq_tpu.ops.conv import sliding_window as jax_window
    rng = np.random.default_rng(7)
    b, h, k = 2, 11, 3
    x_img = rng.integers(-128, 128, size=(b, h, h, 3)).astype(np.int8)
    chans = [3, 32] if stride == 1 else [3, 32, 32]
    weights, thrs = _rand_net(rng, chans, k, 1, 1)
    patches = np.array(jax_window(jnp.asarray(x_img), k, k, stride))
    kw = dict(kernel=k, abits=1, input_patches=True, input_levels=True)
    want = _jax_chain(patches, weights, thrs, **kw)
    pw, pt = _port(weights, thrs)
    got = conv_stack.conv_chain_vmem(torch.from_numpy(patches), pw, pt, **kw)
    valid = patches.shape[1] - (len(weights) - 1) * (k - 1)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got[:, :valid, :valid].numpy(),
                                  want[:, :valid, :valid])
    # the patches the port builds itself are JAX's
    np.testing.assert_array_equal(
        sliding_window(torch.from_numpy(x_img), k, k, stride).numpy(),
        patches)


def test_conv_chain_input_patches_checks():
    """Layer 0's weight rows must equal the patch lanes."""
    rng = np.random.default_rng(3)
    weights, thrs = _rand_net(rng, [8, 16], 3, 1, 1)
    pw, pt = _port(weights, thrs)
    x = torch.zeros((1, 5, 5, 71), dtype=torch.int8)
    with pytest.raises(ValueError, match="weight rows"):
        conv_stack.conv_chain(x, pw, pt, kernel=3, abits=1,
                              input_patches=True)


# -- strided nets on the mega route ---------------------------------------

def _strided_first(mod, wbits, abits):
    """A strided conv on the image, chained with a stride-1 conv; a
    small-spatial conv (a block stage); a dense tail."""
    return mod.NetworkConfig(
        name=f"strided-first-w{wbits}a{abits}", wbits=wbits, abits=abits,
        input_kind="int8", input_shape=(33, 33, 3),
        layers=(mod.ConvSpec(32, stride=2), mod.ConvSpec(32),
                mod.PoolSpec(), mod.ConvSpec(32), mod.DenseSpec(24),
                mod.DenseSpec(10)),
        num_classes=10, dataset="cifar10")


def _strided_after_pool(mod, wbits, abits):
    """Stride-1 convs on the image, a pool, then a strided conv on codes
    chained with a stride-1 conv; a dense tail."""
    return mod.NetworkConfig(
        name=f"strided-pool-w{wbits}a{abits}", wbits=wbits, abits=abits,
        input_kind="int8", input_shape=(20, 20, 3),
        layers=(mod.ConvSpec(32), mod.ConvSpec(32), mod.PoolSpec(),
                mod.ConvSpec(32, stride=2), mod.ConvSpec(32),
                mod.DenseSpec(24), mod.DenseSpec(10)),
        num_classes=10, dataset="cifar10")


NETS = {"first": _strided_first, "pool": _strided_after_pool}
# the port's stage list; JAX's adds im2col0, for it prebuilds the patches
# of every image conv, where the port's kernel reads a stride-1 one in place
STAGES = {"first": ["im2col0", "chain0-1", "pool2", "block3", "mlp_tail"],
          "pool": ["chain0-1", "pool2", "im2col3", "chain3-4", "mlp_tail"]}


def _random_both(net, wbits, abits, seed, batch=2):
    from bnn_pynq_tpu.models import config as jc
    from bnn_pynq_tpu.models import network as jax_net
    jcfg, pcfg = NETS[net](jc, wbits, abits), NETS[net](pc, wbits, abits)
    params = jax_net.init_random_params(jcfg, seed=seed)
    rng = np.random.default_rng(seed)
    scale = rng.uniform(0.01, 1.0, size=10).astype(np.float32)
    bias = rng.standard_normal(10).astype(np.float32)
    x = rng.integers(-128, 128, size=(batch,) + pcfg.input_shape) \
        .astype(np.int8)
    layers_np = [{k: np.asarray(v) for k, v in p.items()} for p in params]
    return jcfg, pcfg, params, layers_np, scale, bias, x


@pytest.mark.parametrize("wbits,abits", [(1, 1), (2, 2)])
@pytest.mark.parametrize("net", sorted(NETS))
def test_strided_mega_matches_jax(net, wbits, abits):
    import jax.numpy as jnp
    from bnn_pynq_tpu.models import network as jax_net
    jcfg, pcfg, params, layers_np, scale, bias, x = \
        _random_both(net, wbits, abits, seed=5)
    decoded = jax_net.decode_params(jcfg, params)
    jax_out = {}
    act = jax_net.prepare_input(jcfg, jnp.asarray(x))
    for name, fn in jax_net.mega_stages(jcfg, decoded, jnp.asarray(scale),
                                        jnp.asarray(bias), interpret=True):
        act = fn(act)
        jax_out[name] = np.asarray(act)
    layers, t_scale, t_bias = params_from_numpy(pcfg, layers_np, scale,
                                                bias, "cpu")
    stages = port_net.mega_stages(pcfg, layers, t_scale, t_bias)
    names = [n for n, _ in stages]
    assert names == STAGES[net]
    assert names == [n for n in jax_out if n in names]
    assert set(jax_out) - set(names) <= {"im2col0"}
    act = port_net.prepare_input(pcfg, torch.from_numpy(x))
    for name, fn in stages:
        act = fn(act)
        want = jax_out[name]
        assert act.shape == want.shape, name
        if name == "mlp_tail":
            np.testing.assert_allclose(act.numpy(), want, **TOL)
        else:
            np.testing.assert_array_equal(act.numpy(), want, err_msg=name)
    # the whole forward; int32 logits of the reference forwards
    logits = port_net.forward_mega(pcfg, layers, torch.from_numpy(x),
                                   t_scale, t_bias)
    want_acc = np.asarray(jax_net.forward_xla(jcfg, decoded,
                                              jnp.asarray(x)))
    got_acc = port_net.forward_ref(pcfg, layers, torch.from_numpy(x))
    assert got_acc.dtype == torch.int32
    np.testing.assert_array_equal(got_acc.numpy(), want_acc)
    np.testing.assert_allclose(logits.numpy(), jax_out["mlp_tail"], **TOL)
    np.testing.assert_allclose(
        logits.numpy(), want_acc.astype(np.float32) * scale + bias, **TOL)


@pytest.fixture(scope="module")
def strided_artifacts(tmp_path_factory):
    """Per net: JAX's compiler on perturbed W2A2 BatchNorms
    (tests/test_finnthesizer.py), saved by JAX and loaded by the port; a
    seeded batch of images and JAX's engine's logits and classes."""
    from bnn_pynq_tpu.compiler import compile_network
    from bnn_pynq_tpu.compiler.artifacts import save_artifact
    from bnn_pynq_tpu.models import config as jc
    from bnn_pynq_tpu.runtime.engine import InferenceEngine as JaxEngine
    from tests.test_finnthesizer import init_perturbed
    out = {}
    for net in sorted(NETS):
        cfg = NETS[net](jc, 2, 2)
        _, params, stats = init_perturbed(cfg, seed=1)
        jcompiled = compile_network(cfg, params, stats)
        path = tmp_path_factory.mktemp("strided") / f"{net}.npz"
        save_artifact(str(path), jcompiled)
        images = np.random.default_rng(4).integers(
            0, 256, size=(5,) + cfg.input_shape).astype(np.uint8)
        jeng = JaxEngine(jcompiled, runtime="ref", batch_buckets=(8,))
        out[net] = (load_artifact(str(path)), images,
                    np.asarray(jeng.logits(images)),
                    np.asarray(jeng.classify(images)))
    return out


@pytest.mark.parametrize("route", ["mega", "s2d"])
@pytest.mark.parametrize("net", sorted(NETS))
def test_strided_engine_routes_match_jax(net, route, strided_artifacts):
    compiled, images, want, want_cls = strided_artifacts[net]
    eng = InferenceEngine(compiled, device="cpu", route=route,
                          batch_buckets=(8,))
    np.testing.assert_allclose(eng.logits(images), want, **TOL)
    np.testing.assert_array_equal(eng.classify(images), want_cls)


# -- OverlapTPEngine on strided convs ---------------------------------------

def _overlap_worker(jobs):
    from bnn_pynq_tpu_torch.parallel import make_mesh
    mesh = make_mesh(data=1, model=2, device="cpu")
    return {key: OverlapTPEngine(compiled, mesh, arm=arm).logits(x)
            for key, (compiled, arm, x) in jobs.items()}


@pytest.fixture(scope="module")
def overlap_world():
    """Both nets W1A1 (random parameters, test_strided_mega_matches_jax's
    draws) on both arms, mesh (1, 2); and JAX's logits of each."""
    import jax.numpy as jnp
    from bnn_pynq_tpu.models import network as jax_net
    jobs, wants = {}, {}
    for net in sorted(NETS):
        jcfg, pcfg, params, layers_np, scale, bias, x = \
            _random_both(net, 1, 1, seed=5)
        acc = np.asarray(jax_net.forward_xla(
            jcfg, jax_net.decode_params(jcfg, params), jnp.asarray(x)))
        wants[net] = acc.astype(np.float32) * scale + bias
        compiled = CompiledNetwork(pcfg, layers_np, scale, bias)
        for arm in ("ring", "blocking"):
            jobs[f"{net}-{arm}"] = (compiled, arm, x)
    return run_world(_overlap_worker, 2, args=(jobs,), device="cpu",
                     timeout=240.0), wants


@pytest.mark.parametrize("arm", ["ring", "blocking"])
@pytest.mark.parametrize("net", sorted(NETS))
def test_overlap_strided_matches_jax(net, arm, overlap_world):
    """Against JAX's forward_xla: a strided first conv (conv_chain on
    patches) and a strided ring layer (int32 partials on patches)."""
    results, wants = overlap_world
    want = wants[net]
    for rank, out in enumerate(results):
        np.testing.assert_allclose(out[f"{net}-{arm}"], want, **TOL,
                                   err_msg=f"rank {rank}")


# -- fused_mlp_forward_padded ----------------------------------------------

@pytest.mark.parametrize("batch", [1, 7, 257])
def test_fused_mlp_forward_padded_matches_jax(batch):
    import jax.numpy as jnp
    from bnn_pynq_tpu.ops.fused_mlp import \
        fused_mlp_forward_padded as jax_padded
    rng = np.random.default_rng(batch)
    weights, thrs = _rand_net(rng, [64, 48, 10], 1, 2, 2)
    x = rng.integers(0, 4, size=(batch, 64)).astype(np.int8)
    scale = rng.uniform(0.01, 1.0, size=10).astype(np.float32)
    bias = rng.standard_normal(10).astype(np.float32)
    want = np.asarray(jax_padded(
        jnp.asarray(x), [jnp.asarray(w) for w in weights],
        [jnp.asarray(thrs[0])], jnp.asarray(scale), jnp.asarray(bias),
        abits=2, interpret=True))
    pw, pt = _port(weights, thrs[:1])
    got = fused_mlp.fused_mlp_forward_padded(
        torch.from_numpy(x), pw, pt, torch.from_numpy(scale),
        torch.from_numpy(bias), abits=2)
    assert tuple(got.shape) == want.shape == (batch, 10)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# -- the quantizers, called as JAX calls them ---------------------------------

@pytest.mark.parametrize("name,x,grad", [
    ("binarize", [0.5, -2.0, 0.9], [1.0, 0.0, 1.0]),
    ("quantize2", [0.1, 1.5], [1.0, 0.0]),
    ("quantize2", [-1.0, -0.7, -0.5, -0.1, 0.0, 0.4, 0.7, 1.0], None)])
def test_quantizer_call_form_matches_jax(name, x, grad):
    """tests/test_training.py:49-62's cases: values and STE gradients
    equal JAX's, with no warning; `.apply` gives the same."""
    import jax
    import jax.numpy as jnp
    from bnn_pynq_tpu.train import quant as jq
    jfn, pfn = getattr(jq, name), getattr(pq, name)
    xs = np.asarray(x, np.float32)
    want = np.asarray(jfn(jnp.asarray(xs)))
    want_g = np.asarray(jax.grad(lambda v: jnp.sum(jfn(v)))(
        jnp.asarray(xs)))
    if grad is not None:
        np.testing.assert_array_equal(want_g, grad)
    for call in (pfn, pfn.apply):
        t = torch.from_numpy(xs.copy()).requires_grad_()
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            got = call(t)
            got.sum().backward()
        assert isinstance(got, torch.Tensor)
        assert got.detach().numpy().tobytes() == want.tobytes()
        assert t.grad.numpy().tobytes() == want_g.tobytes()
