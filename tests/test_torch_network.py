"""The port's slice end to end on the CPU, against the JAX package: the
kernel route stage by stage, the reference forward, the golden fixtures,
every pretrained artifact, the batching server, and the port's promises
(no CPU fallback for a CUDA engine, no jax import)."""

import os
import re
import subprocess
import sys
import threading
from concurrent.futures import wait
from dataclasses import replace
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bnn_pynq_tpu.models import config as jc
from bnn_pynq_tpu.models import network as jax_net
from bnn_pynq_tpu.runtime.engine import InferenceEngine as JaxEngine
from bnn_pynq_tpu.compiler.finnthesizer import \
    CompiledNetwork as JaxCompiledNetwork
from bnn_pynq_tpu_torch.compiler.artifacts import (CompiledNetwork,
                                                   load_artifact)
from bnn_pynq_tpu_torch.models import config as pc
from bnn_pynq_tpu_torch.models import network as port_net
from bnn_pynq_tpu_torch.models.params import (params_from_numpy,
                                              weight_matrix)
from bnn_pynq_tpu_torch.ops.conv import maxpool2d
from bnn_pynq_tpu_torch.ops.conv_stack import conv_chain
from bnn_pynq_tpu_torch.runtime.engine import InferenceEngine
from bnn_pynq_tpu_torch.runtime.serving import BatchingServer

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures"
PRETRAINED = sorted(p.stem for p in (REPO / "pretrained").glob("*.npz"))
TOL = dict(rtol=1e-5, atol=1e-5)    # tests/test_golden_fixtures.py:36


def _narrow_cnv(mod, wbits, abits):
    """CNV topology at 32×32×3, narrowed: every mega stage kind occurs
    (chain on the raw image, pool, chain on codes, pool, small-spatial
    block, conv folded into the MLP tail, dense tail)."""
    return mod.NetworkConfig(
        name=f"cnv-narrow-w{wbits}a{abits}", wbits=wbits, abits=abits,
        input_kind="int8", input_shape=(32, 32, 3),
        layers=(mod.ConvSpec(32), mod.ConvSpec(32), mod.PoolSpec(),
                mod.ConvSpec(32), mod.ConvSpec(32), mod.PoolSpec(),
                mod.ConvSpec(64), mod.ConvSpec(64),
                mod.DenseSpec(64), mod.DenseSpec(64), mod.DenseSpec(10)),
        num_classes=10, dataset="cifar10")


def _both(wbits, abits, seed):
    """The narrow CNV's random params in both packages + a seeded batch."""
    jcfg = _narrow_cnv(jc, wbits, abits)
    pcfg = _narrow_cnv(pc, wbits, abits)
    params = jax_net.init_random_params(jcfg, seed=seed)
    rng = np.random.default_rng(seed)
    scale = rng.uniform(0.01, 1.0, size=10).astype(np.float32)
    bias = rng.standard_normal(10).astype(np.float32)
    x = rng.integers(-128, 128, size=(2, 32, 32, 3)).astype(np.int8)
    layers_np = [{k: np.asarray(v) for k, v in p.items()} for p in params]
    port = params_from_numpy(pcfg, layers_np, scale, bias, "cpu")
    return jcfg, pcfg, params, port, scale, bias, x


@pytest.mark.parametrize("wbits,abits", [(1, 1), (2, 2)])
def test_mega_stages_match_jax(wbits, abits):
    jcfg, pcfg, params, port, scale, bias, x = _both(wbits, abits, 3)
    decoded = jax_net.decode_params(jcfg, params)
    jax_out = {}
    act = jax_net.prepare_input(jcfg, jnp.asarray(x))
    for name, fn in jax_net.mega_stages(jcfg, decoded, jnp.asarray(scale),
                                        jnp.asarray(bias), interpret=True):
        act = fn(act)
        jax_out[name] = np.asarray(act)
    layers, t_scale, t_bias = port
    stages = port_net.mega_stages(pcfg, layers, t_scale, t_bias)
    assert [n for n, _ in stages] == \
        [n for n in jax_out if n != "im2col0"] == \
        ["chain0-1", "pool2", "chain3-4", "pool5", "block6", "mlp_tail"]
    act = port_net.prepare_input(pcfg, torch.from_numpy(x))
    for name, fn in stages:
        act = fn(act)
        want = jax_out[name]
        assert act.shape == want.shape, name
        if name == "mlp_tail":
            np.testing.assert_allclose(act.numpy(), want, **TOL)
        else:
            np.testing.assert_array_equal(act.numpy(), want, err_msg=name)


def _pretrained(name):
    """(config, layers, scale, bias) of a pretrained artifact on the CPU."""
    compiled = load_artifact(str(REPO / "pretrained" / f"{name}.npz"))
    return (compiled.config,) + tuple(params_from_numpy(
        compiled.config, compiled.layers, compiled.out_scale,
        compiled.out_bias, "cpu"))


def _narrow_cnv_33(seed, strided=False):
    """The narrow CNV on a 33×33 image: chain0-1's map is 29×29, odd, so
    its pool stays a stage; chain3-4's is 10×10 and pools in the chain.
    strided: a stride-2 conv on the image (its prebuilt patches) chained
    with a stride-1 conv to a 14×14 map, which pools in the chain."""
    cfg = replace(_narrow_cnv(pc, 1, 1), input_shape=(33, 33, 3))
    if strided:
        cfg = replace(cfg, name="cnv-strided-w1a1", layers=(
            pc.ConvSpec(32, stride=2), pc.ConvSpec(32), pc.PoolSpec(),
            pc.ConvSpec(32), pc.DenseSpec(64), pc.DenseSpec(10)))
    rng = np.random.default_rng(seed)
    return (cfg,) + tuple(params_from_numpy(
        cfg, port_net.init_random_params(cfg, seed=seed),
        rng.uniform(0.01, 1.0, 10).astype(np.float32),
        rng.standard_normal(10).astype(np.float32), "cpu"))


CNV_NETS = ["cnv-w1a1", "cnv-w1a2", "cnv-w2a2"]


@pytest.mark.parametrize("name", CNV_NETS)
def test_pooled_chain_plain_equals_maxpool_of_chain(name):
    """conv_chain(pool=True) on the CPU (its plain twin) is maxpool2d of the
    unpooled chain, bit for bit, on both of CNV's pooled chains."""
    cfg, layers, scale, bias = _pretrained(name)
    stages = dict(port_net.mega_stages(cfg, layers, scale, bias))
    x = np.random.default_rng(26).integers(-128, 128, size=(3, 32, 32, 3))
    act = port_net.prepare_input(cfg, torch.from_numpy(x.astype(np.int8)))
    for chain, pool in (("chain0-1", "pool2"), ("chain3-4", "pool5")):
        want = stages[pool](stages[chain](act))
        got = stages[chain](act, pool=True)
        assert torch.equal(got, want), chain
        assert torch.equal(want, maxpool2d(stages[chain](act)))
        assert len(torch.unique(want)) > 1, "a degenerate case"
        act = want


@pytest.mark.parametrize("name", CNV_NETS + ["narrow, 33x33",
                                             "strided, 33x33"])
def test_forward_mega_pools_in_the_chains(name):
    """forward_mega runs each chain that a 2×2 pool follows on an even map
    as one pooled stage, and gives the logits of mega_stages' stages one
    by one, bit for bit, argmax equal; an odd map keeps its pool stage."""
    if name.startswith("narrow"):
        cfg, layers, scale, bias = _narrow_cnv_33(5)
        names = ["chain0-1", "pool2", "chain3-4+pool5", "block6",
                 "mlp_tail"]
        size = 33
    elif name.startswith("strided"):
        cfg, layers, scale, bias = _narrow_cnv_33(6, strided=True)
        names = ["im2col0", "chain0-1+pool2", "block3", "mlp_tail"]
        size = 33
    else:
        cfg, layers, scale, bias = _pretrained(name)
        names = ["chain0-1+pool2", "chain3-4+pool5", "block6", "mlp_tail"]
        size = 32
    fused = port_net.mega_stages(cfg, layers, scale, bias, fuse_pools=True)
    assert [n for n, _ in fused] == names
    x = torch.from_numpy(np.random.default_rng(27).integers(
        -128, 128, size=(4, size, size, 3)).astype(np.int8))
    act = port_net.prepare_input(cfg, x)
    for _, fn in port_net.mega_stages(cfg, layers, scale, bias):
        act = fn(act)
    got = port_net.forward_mega(cfg, layers, x, scale, bias)
    assert torch.equal(got, act)
    assert torch.equal(got.argmax(1), act.argmax(1))


@pytest.mark.parametrize("h,w,kernel", [(9, 10, 1), (10, 9, 1), (11, 11, 3),
                                        (12, 11, 3)])
def test_pooled_chain_refuses_an_odd_map(h, w, kernel):
    """A 2×2 pool of an odd map would drop its edge: conv_chain(pool=True)
    raises instead."""
    rng = np.random.default_rng(h * w)
    x = torch.from_numpy(rng.integers(0, 2, size=(1, h, w, 32))
                         .astype(np.int8))
    wt = weight_matrix(torch.from_numpy(
        rng.choice([-1, 1], size=(kernel * kernel * 32, 16)).astype(np.int8)))
    thr = torch.zeros((1, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="odd"):
        conv_chain(x, [wt], [thr], kernel=kernel, abits=1, pool=True)


@pytest.mark.parametrize("wbits,abits", [(1, 1), (2, 2)])
def test_forward_ref_matches_forward_xla_patches(wbits, abits):
    jcfg, pcfg, params, port, _, _, x = _both(wbits, abits, 4)
    want = jax_net.forward_xla(jcfg, jax_net.decode_params(jcfg, params),
                               jnp.asarray(x), conv_mode="patches")
    got = port_net.forward_ref(pcfg, port[0], torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_forward_ref_matches_forward_xla_mlp():
    jcfg, pcfg = jc.get_config("sfc-w1a2"), pc.get_config("sfc-w1a2")
    params = jax_net.init_random_params(jcfg, seed=6)
    x = np.random.default_rng(6).choice([-1, 1], size=(3, 784)) \
        .astype(np.int8)
    want = jax_net.forward_xla(jcfg, jax_net.decode_params(jcfg, params),
                               jnp.asarray(x))
    layers = params_from_numpy(
        pcfg, [{k: np.asarray(v) for k, v in p.items()} for p in params],
        np.ones(10), np.zeros(10), "cpu")[0]
    got = port_net.forward_ref(pcfg, layers, torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _random_engines(name, seed, **engine_kw):
    """(port engine kwargs → engine, JAX engine) on `init_random_params` of
    each package for one (config, seed), with one seeded scale and bias."""
    if name.startswith("cnv-narrow"):
        wbits, abits = int(name[-3]), int(name[-1])
        jcfg, pcfg = _narrow_cnv(jc, wbits, abits), \
            _narrow_cnv(pc, wbits, abits)
    else:
        jcfg, pcfg = jc.get_config(name), pc.get_config(name)
    rng = np.random.default_rng(seed)
    scale = rng.uniform(0.01, 1.0, size=pcfg.num_classes).astype(np.float32)
    bias = rng.standard_normal(pcfg.num_classes).astype(np.float32)
    jparams = [{k: np.asarray(v) for k, v in p.items()}
               for p in jax_net.init_random_params(jcfg, seed=seed)]
    pparams = port_net.init_random_params(pcfg, seed=seed)

    def port_engine(**kw):
        return InferenceEngine(CompiledNetwork(pcfg, pparams, scale, bias),
                               device="cpu", **engine_kw, **kw)

    jax_engine = JaxEngine(JaxCompiledNetwork(jcfg, jparams, scale, bias),
                           runtime="ref", **engine_kw)
    return pcfg, jparams, pparams, port_engine, jax_engine


@pytest.mark.parametrize("name", ["sfc-w1a1", "cnv-w1a1", "cnv-w2a2"])
def test_init_random_params_equals_jax(name):
    """One (config, seed) holds equal arrays in both packages, layer by
    layer and key by key, and an engine built from them answers as JAX's."""
    pcfg, jparams, pparams, port_engine, jax_engine = _random_engines(
        name, 7, batch_buckets=(2,))
    assert len(pparams) == len(jparams) == len(pcfg.layers)
    for i, (got, want) in enumerate(zip(pparams, jparams)):
        assert sorted(got) == sorted(want), f"layer {i}: keys"
        for key in want:
            assert isinstance(got[key], np.ndarray)
            assert got[key].dtype == want[key].dtype, (i, key)
            np.testing.assert_array_equal(got[key], want[key],
                                          err_msg=f"layer {i} {key}")
    assert port_net.init_random_params(pcfg, seed=8)[0].keys() == \
        pparams[0].keys()
    assert not np.array_equal(
        next(iter(port_net.init_random_params(pcfg, seed=8)[0].values())),
        next(iter(pparams[0].values()))), "the seed must matter"
    shape = (2,) + (pcfg.input_shape if pcfg.input_kind == "int8"
                    else (28, 28))
    x = np.random.default_rng(9).integers(0, 256, size=shape, dtype=np.uint8)
    want = jax_engine.logits(x)
    for runtime in ("kernels", "ref"):
        got = port_engine(runtime=runtime).logits(x)
        np.testing.assert_allclose(got, want, **TOL)
        assert (got.argmax(1) == want.argmax(1)).all()


@pytest.mark.parametrize("name,route", [
    ("cnv-narrow-w1a1", "mega"), ("cnv-narrow-w1a1", "direct"),
    ("cnv-narrow-w1a1", "vpu"), ("cnv-narrow-w1a1", "mxu"),
    ("cnv-narrow-w1a1", "mxu_rm"), ("cnv-narrow-w2a2", "mega"),
    ("cnv-narrow-w2a2", "direct"), ("cnv-narrow-w2a2", "mxu")])
def test_batches_above_the_largest_bucket(name, route):
    """A conv net takes a batch above its largest bucket (5, 8 and 9 images
    on buckets (1, 4)): every image gets the answer it gets alone in a
    bucket, from the route's kernels, from the reference, and from the JAX
    engine."""
    _, _, _, port_engine, jax_engine = _random_engines(
        name, 11, batch_buckets=(1, 4))
    x = np.random.default_rng(12).integers(0, 256, size=(9, 32, 32, 3),
                                           dtype=np.uint8)
    eng, ref = port_engine(route=route), port_engine(runtime="ref")
    # one largest bucket at a time, the rest in its own bucket
    uploads = []
    upload = eng.upload
    eng.upload = lambda xp: uploads.append(len(xp)) or upload(xp)
    eng.logits(x)
    eng.logits(x[:5])
    eng.logits(x[:8])
    eng.upload = upload
    assert uploads == [4, 4, 1, 4, 1, 4, 4]
    want = jax_engine.logits(x)
    in_bucket = np.concatenate([eng.logits(x[i:i + 4])
                                for i in range(0, 9, 4)])
    np.testing.assert_allclose(in_bucket, want, **TOL)
    for b in (5, 8, 9):
        got = eng.logits(x[:b])
        assert got.shape == (b, 10)
        np.testing.assert_array_equal(got, in_bucket[:b])
        np.testing.assert_array_equal(ref.logits(x[:b]), got)
        np.testing.assert_array_equal(eng.classify(x[:b]),
                                      want[:b].argmax(1))


def test_mlp_above_the_largest_bucket_runs_one_forward():
    """An MLP never chunks (as in JAX): 9 rows on buckets (1, 4) are one
    forward of 12, and every row answers as alone in a bucket."""
    _, _, _, port_engine, jax_engine = _random_engines(
        "sfc-w1a1", 13, batch_buckets=(1, 4))
    x = np.random.default_rng(14).integers(0, 256, size=(9, 28, 28),
                                           dtype=np.uint8)
    eng = port_engine()
    uploads = []
    upload = eng.upload
    eng.upload = lambda xp: uploads.append(len(xp)) or upload(xp)
    got = eng.logits(x)
    eng.upload = upload
    assert uploads == [12] and got.shape == (9, 10)
    np.testing.assert_allclose(got, jax_engine.logits(x), **TOL)
    np.testing.assert_array_equal(
        got, np.concatenate([eng.logits(x[i:i + 4])
                             for i in range(0, 9, 4)]))
    np.testing.assert_array_equal(eng.classify(x), got.argmax(1))


@pytest.mark.parametrize("runtime", ["kernels", "ref"])
@pytest.mark.parametrize("tag", ["mlp_w1a1", "cnv_w2a2"])
def test_golden_fixtures(tag, runtime):
    engine = InferenceEngine.from_artifact(
        str(FIXTURES / f"golden_{tag}.npz"), device="cpu", runtime=runtime)
    io = np.load(FIXTURES / f"golden_{tag}_io.npz")
    np.testing.assert_allclose(engine.logits(io["x"]), io["logits"], **TOL)


@pytest.mark.parametrize("name", PRETRAINED)
def test_pretrained_matches_jax_ref(name):
    path = str(REPO / "pretrained" / f"{name}.npz")
    cfg = load_artifact(path).config
    shape = (2,) + (cfg.input_shape if cfg.input_kind == "int8"
                    else (28, 28))
    x = np.random.default_rng(len(name)).integers(0, 256, size=shape,
                                                  dtype=np.uint8)
    want = JaxEngine.from_artifact(path, runtime="ref",
                                   batch_buckets=(2,)).logits(x)
    for runtime in ("kernels", "ref"):
        got = InferenceEngine.from_artifact(
            path, device="cpu", runtime=runtime,
            batch_buckets=(2,)).logits(x)
        np.testing.assert_allclose(got, want, **TOL)
        assert (got.argmax(1) == want.argmax(1)).all()


@pytest.mark.parametrize("pipeline_depth", [1, 2])
def test_batching_server_matches_engine(pipeline_depth):
    engine = InferenceEngine.from_artifact(
        str(REPO / "pretrained" / "sfc-w1a1.npz"), device="cpu")
    rng = np.random.default_rng(pipeline_depth)
    x = engine.prepare(rng.integers(0, 256, size=(40, 28, 28),
                                    dtype=np.uint8))
    want = engine.classify(x, prepared=True)
    server = BatchingServer(engine, max_batch=16, max_wait_ms=1.0,
                            pipeline_depth=pipeline_depth)
    try:
        singles = [server.submit(x[i]) for i in range(10)]
        small = server.submit_many(x[10:15])
        split = server.submit_many(x[15:40])        # > max_batch: chunked
        done, pending = wait(singles + [small, split], timeout=60)
        assert not pending
    finally:
        server.stop()
    assert [f.result() for f in singles] == list(want[:10])
    np.testing.assert_array_equal(small.result(), want[10:15])
    np.testing.assert_array_equal(split.result(), want[15:40])
    assert server.stats.requests == 13 and server.stats.images == 40
    assert server._busy == 0
    with pytest.raises(RuntimeError, match="stopped"):
        server.submit(x[0]).result(timeout=1)


def test_busy_counter_survives_thread_contention():
    """The dispatcher and collector threads both update the busy count; a
    lost read-modify-write would leave it non-zero. (CPython 3.12 has no
    thread switch point inside `x += d` on an attribute, so there an
    unlocked update happens not to lose counts; the lock keeps the
    contract on interpreters that do switch there.)"""
    engine = InferenceEngine.from_artifact(
        str(REPO / "pretrained" / "sfc-w1a1.npz"), device="cpu")
    server = BatchingServer(engine, pipeline_depth=1)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                server._add_busy(1)
                server._add_busy(-1)
        threads = [threading.Thread(target=work)
                   for _ in range(4 * (os.cpu_count() or 4))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
        server.stop()
    assert server._busy == 0


def test_engine_surface_and_hot_swap():
    a = load_artifact(str(REPO / "pretrained" / "sfc-w1a1.npz"))
    b = load_artifact(str(REPO / "pretrained" / "sfc-w1a2.npz"))
    engine = InferenceEngine(a, device="cpu", batch_buckets=(4, 16))
    assert engine._bucket(3) == 4 and engine._bucket(17) == 32
    padded, n = engine._pad_to_bucket(np.ones((5, 784), np.int8))
    assert padded.shape == (16, 784) and n == 5 and not padded[5:].any()
    x = np.random.default_rng(0).integers(0, 256, size=(6, 28, 28),
                                          dtype=np.uint8)
    logits = engine.warmup(2).logits(x)
    assert logits.shape == (6, 10) and engine.usecPerImage > 0
    np.testing.assert_array_equal(engine.classify(x), logits.argmax(1))
    assert engine.classify_one(x[2]) == logits[2].argmax()
    dev_out, n = engine.logits_device(x, argmax=True)
    np.testing.assert_array_equal(engine.fetch(dev_out)[:n], logits.argmax(1))
    with pytest.raises(ValueError, match="topology"):
        engine.load_parameters(b)              # W1A2 into a W1A1 engine
    other = InferenceEngine.from_artifact(
        str(REPO / "pretrained" / "sfc-w1a1.npz"), device="cpu")
    swapped = load_artifact(str(REPO / "pretrained" / "sfc-w1a1.npz"))
    swapped.out_bias = swapped.out_bias + 1.0
    other.load_parameters(swapped)
    np.testing.assert_allclose(other.logits(x), logits + 1.0, **TOL)


def test_cuda_engine_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceEngine.from_artifact(
            str(REPO / "pretrained" / "sfc-w1a1.npz"), device="cuda")
    # an unknown runtime raises; the JAX engine's 'tpu' names the kernels
    with pytest.raises(ValueError, match="runtime"):
        InferenceEngine.from_artifact(
            str(REPO / "pretrained" / "sfc-w1a1.npz"), device="cpu",
            runtime="gpu")
    assert InferenceEngine.from_artifact(
        str(REPO / "pretrained" / "sfc-w1a1.npz"), device="cpu",
        runtime="tpu").runtime == "kernels"


def test_port_never_imports_jax():
    code = ("import sys\n"
            "import bnn_pynq_tpu_torch.runtime.engine\n"
            "import bnn_pynq_tpu_torch.runtime.serving\n"
            "import bnn_pynq_tpu_torch.ops.conv_stack\n"
            "import bnn_pynq_tpu_torch.ops.conv_direct\n"
            "import bnn_pynq_tpu_torch.ops.matmul\n"
            "import bnn_pynq_tpu_torch.native\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'bnn_pynq_tpu.')) or m == 'bnn_pynq_tpu']\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)
    # no import of either, lazy ones included, anywhere in the port
    pattern = re.compile(r"^\s*(import|from)\s+(jax|bnn_pynq_tpu)\b(?!_torch)",
                         re.M)
    files = list((REPO / "bnn_pynq_tpu_torch").rglob("*.py")) + \
        [REPO / "chip_smoke.py"]
    assert not [str(f) for f in files if pattern.search(f.read_text())]
