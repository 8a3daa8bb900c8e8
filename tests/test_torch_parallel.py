"""The port's tensor-parallel inference (bnn_pynq_tpu_torch/parallel/) on
gloo worlds of CPU ranks, against the JAX package's `parallel/` on the
virtual CPU mesh at the same mesh shape, and against the port's
single-device reference engine: mesh construction, TPInferenceEngine on
the packed kernels' plain versions, the GSPMD-style engine, the serving
hooks, a two-process world, the world's deadline and the scaling harness.
tests/test_torch_overlap.py holds OverlapTPEngine.

Each world is spawned by parallel/launch.py and runs module-level job
functions from this file; the ranks import torch and the port only (JAX
is imported inside fixtures and tests, in the pytest process). Tolerance:
logits rtol=atol=1e-5 (tests/test_golden_fixtures.py:36), argmax equal.
"""

import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from bnn_pynq_tpu_torch.compiler.artifacts import (CompiledNetwork,
                                                   config_from_json)
from bnn_pynq_tpu_torch.parallel import comm, make_mesh
from bnn_pynq_tpu_torch.parallel.launch import WorldError, run_world
from bnn_pynq_tpu_torch.parallel.tp import (TPInferenceEngine,
                                            make_gspmd_engine, param_specs,
                                            shard_params)
from bnn_pynq_tpu_torch.runtime.engine import InferenceEngine

TOL = dict(rtol=1e-5, atol=1e-5)    # tests/test_golden_fixtures.py:36
# seconds, every world of these files: an 8-rank world that takes ~20 s
# alone took 3× that beside five other test workers on a shared host
DEADLINE = 240.0


# -- helpers shared with tests/test_torch_overlap.py ---------------------

def port_compiled(jcompiled) -> CompiledNetwork:
    """A JAX CompiledNetwork as the port's (config by its JSON form)."""
    from bnn_pynq_tpu.compiler.artifacts import config_to_json
    return CompiledNetwork(
        config=config_from_json(config_to_json(jcompiled.config)),
        layers=[{k: np.asarray(v) for k, v in layer.items()}
                for layer in jcompiled.layers],
        out_scale=np.asarray(jcompiled.out_scale, np.float32),
        out_bias=np.asarray(jcompiled.out_bias, np.float32))


def random_pair(name, seed=0):
    """(JAX, port) CompiledNetwork of `init_random_params(name, seed)`
    with unit scale and zero bias, as tests/test_overlap.py builds it."""
    from bnn_pynq_tpu.compiler.finnthesizer import \
        CompiledNetwork as JaxCompiled
    from bnn_pynq_tpu.models import get_config as jax_config
    from bnn_pynq_tpu.models.network import \
        init_random_params as jax_random
    cfg = jax_config(name)
    jc = JaxCompiled(
        config=cfg,
        layers=[{k: np.asarray(v) for k, v in layer.items()}
                for layer in jax_random(cfg, seed=seed)],
        out_scale=np.ones(cfg.num_classes, np.float32),
        out_bias=np.zeros(cfg.num_classes, np.float32))
    return jc, port_compiled(jc)


def mini_pair(kind, wbits, abits, seed):
    """(JAX, port) CompiledNetwork of tests/test_finnthesizer.py's mini
    MLP or CNV with perturbed BatchNorm, compiled by the JAX compiler."""
    from bnn_pynq_tpu.compiler import compile_network
    from tests.test_finnthesizer import init_perturbed, mini_cnv, mini_mlp
    cfg = {"mlp": mini_mlp, "cnv": mini_cnv}[kind](wbits, abits)
    _, params, stats = init_perturbed(cfg, seed=seed)
    jc = compile_network(cfg, params, stats)
    return jc, port_compiled(jc)


def jax_mesh(data, model):
    import jax
    from bnn_pynq_tpu.parallel.mesh import make_mesh as jax_make_mesh
    return jax_make_mesh(data=data, model=model,
                         devices=jax.devices()[:data * model])


def ref_engine(compiled, **kw):
    """The port's single-device reference engine on the CPU."""
    return InferenceEngine(compiled, device="cpu", runtime="ref", **kw)


def images(cfg, b, seed):
    return np.random.default_rng(seed).integers(
        0, 256, size=(b,) + tuple(cfg.input_shape)).astype(np.uint8)


def _jobs_worker(data, model, jobs):
    mesh = make_mesh(data=data, model=model, device="cpu")
    return {name: fn(mesh, *args) for name, fn, args in jobs}


def run_jobs(data, model, jobs):
    """Run [(name, fn, args)] in a world of data·model CPU ranks on a
    (data, model) mesh, fn(mesh, *args) in order on every rank; returns
    each rank's {name: result}."""
    return run_world(_jobs_worker, data * model, args=(data, model, jobs),
                     device="cpu", timeout=DEADLINE)


# -- job functions (they run in the ranks) -------------------------------

def job_mesh_shapes(mesh):
    out = {"given": mesh.shape, "coords": mesh.coords,
           "model4": make_mesh(model=4, device="cpu").shape,
           "default": make_mesh(device="cpu").shape}
    try:
        make_mesh(data=4, model=2, device="cpu")
    except ValueError as e:
        out["too_large"] = str(e)
    return out


def job_tp_logits(mesh, compiled, x, route="mxu", **kw):
    comm.reset_counts()
    eng = TPInferenceEngine(compiled, mesh, route=route, **kw)
    return {"logits": eng.logits(x), "classify": eng.classify(x),
            "counts": comm.counts()}


def job_gspmd(mesh, compiled, x):
    return make_gspmd_engine(compiled, mesh)(x)


def job_tp_hooks(mesh, compiled, x, other):
    eng = TPInferenceEngine(compiled, mesh, batch_buckets=(16,))
    dev, b = eng.logits_device(x, argmax=True)
    out = {"b": b, "argmax": eng.fetch(dev)[:b], "classify": eng.classify(x),
           "words_refused": None}
    try:
        eng.launch_prepared(eng.upload(np.zeros((16, 25), np.uint32)),
                            words=True)
    except ValueError as e:
        out["words_refused"] = str(e)
    eng.load_parameters(compiled)              # same topology: fine
    try:
        eng.load_parameters(other)
    except ValueError as e:
        out["topology"] = str(e)
    out["after_swap"] = eng.classify(x)
    return out


def job_shards(mesh, compiled):
    return [{k: v.numpy() for k, v in layer.items()}
            for layer in shard_params(compiled.layers, mesh,
                                      compiled.config)]


# -- mesh ------------------------------------------------------------------

def test_mesh_shapes():
    res = run_jobs(2, 2, [("m", job_mesh_shapes, ())])
    r0 = res[0]
    assert jax_mesh(2, 2).shape == r0["m"]["given"] == \
        {"data": 2, "model": 2}
    assert r0["m"]["model4"] == {"data": 1, "model": 4}
    assert r0["m"]["model4"] == dict(jax_mesh(1, 4).shape)
    assert r0["m"]["default"] == {"data": 4, "model": 1}
    assert "needs 8 devices, have 4" in r0["m"]["too_large"]
    assert [r["m"]["coords"] for r in res] == [(0, 0), (0, 1), (1, 0),
                                               (1, 1)]


def test_make_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(model=2, device="cpu")


# -- TPInferenceEngine -----------------------------------------------------

@pytest.fixture(scope="module")
def mini_nets():
    """The three mini nets of tests/test_sharding.py with a 16-image
    batch each: {(kind, wbits, abits): (jax, port, x_uint8)}."""
    out = {}
    for kind, wb, ab in (("mlp", 1, 1), ("cnv", 1, 1), ("cnv", 2, 2)):
        jc, pc_ = mini_pair(kind, wb, ab, seed=11)
        out[(kind, wb, ab)] = (jc, pc_, images(pc_.config, 16, 0))
    return out


@pytest.fixture(scope="module")
def world_2x2(mini_nets):
    """One (2, 2) world: TPInferenceEngine on the three mini nets, the
    GSPMD-style engine on the mini CNV, and the shards of the mini MLP."""
    jobs = []
    for key, (_, pcomp, x) in mini_nets.items():
        xp = ref_engine(pcomp).prepare(x)
        jobs.append((f"tp{key}", job_tp_logits, (pcomp, xp)))
    _, cnv, x = mini_nets[("cnv", 1, 1)]
    jobs.append(("gspmd", job_gspmd, (cnv, ref_engine(cnv).prepare(x))))
    jobs.append(("shards", job_shards, (mini_nets[("mlp", 1, 1)][1],)))
    return run_jobs(2, 2, jobs)


@pytest.mark.parametrize("key", [("mlp", 1, 1), ("cnv", 1, 1),
                                 ("cnv", 2, 2)])
def test_tp_inference_matches_single_device(key, mini_nets, world_2x2):
    from bnn_pynq_tpu.parallel.tp import TPInferenceEngine as JaxTP
    jc, pcomp, x = mini_nets[key]
    single = ref_engine(pcomp)
    expected = single.logits(x)
    want_jax = np.asarray(JaxTP(jc, jax_mesh(2, 2)).logits(
        single.prepare(x)))
    np.testing.assert_allclose(want_jax, expected, **TOL)
    for r, res in enumerate(world_2x2):
        got = res[f"tp{key}"]
        np.testing.assert_allclose(got["logits"], expected, **TOL,
                                   err_msg=f"rank {r}")
        np.testing.assert_allclose(got["logits"], want_jax, **TOL)
        np.testing.assert_array_equal(got["classify"], expected.argmax(-1))
        # one gather of the codes after every non-last compute layer
        n_hidden = sum(1 for s in pcomp.config.layers
                       if type(s).__name__ != "PoolSpec") - 1
        assert got["counts"]["all_gather"] == 2 * n_hidden   # logits+cls
        assert got["counts"]["gather_batch"] == 2


def test_shard_params_are_column_slices(mini_nets, world_2x2):
    """Each rank's shards are the column block of its model index (the
    last layer whole), as JAX's param_specs lay them out."""
    from bnn_pynq_tpu.parallel.tp import param_specs as jax_specs
    jc, pcomp, _ = mini_nets[("mlp", 1, 1)]
    jspecs = jax_specs(jc.config)
    specs = param_specs(pcomp.config)
    assert [{k: tuple(v) for k, v in s.items()} for s in jspecs] == specs
    for r, res in enumerate(world_2x2):
        j = r % 2
        for layer, spec, full in zip(res["shards"], specs, pcomp.layers):
            for k, v in layer.items():
                want = np.asarray(full[k])
                if spec[k] == (None, "model"):
                    n = want.shape[-1] // 2
                    want = want[:, j * n:(j + 1) * n]
                if want.dtype == np.uint32:
                    want = want.view(np.int32)
                np.testing.assert_array_equal(v, want)


def test_tp_pure_model_axis():
    from bnn_pynq_tpu.parallel.tp import TPInferenceEngine as JaxTP
    jc, pcomp = mini_pair("mlp", 1, 1, seed=2)
    x = images(pcomp.config, 8, 3)
    single = ref_engine(pcomp)
    xp = single.prepare(x)
    want = single.logits(x)
    np.testing.assert_allclose(
        np.asarray(JaxTP(jc, jax_mesh(1, 4)).logits(xp)), want, **TOL)
    routes = ("mxu", "vpu")
    for res in run_jobs(1, 4, [(r, job_tp_logits, (pcomp, xp, r))
                               for r in routes]):
        for r in routes:
            np.testing.assert_allclose(res[r]["logits"], want, **TOL)


def test_gspmd_engine_matches_single_device(mini_nets, world_2x2):
    from bnn_pynq_tpu.parallel.tp import make_gspmd_engine as jax_gspmd
    jc, pcomp, x = mini_nets[("cnv", 1, 1)]
    single = ref_engine(pcomp)
    expected = single.logits(x)
    np.testing.assert_allclose(
        jax_gspmd(jc, jax_mesh(2, 2))(single.prepare(x)), expected, **TOL)
    for res in world_2x2:
        np.testing.assert_allclose(res["gspmd"], expected, **TOL)


def test_tpinference_engine_serving_hooks():
    """logits_device(argmax=True) is classify, launch_prepared(words=True)
    raises as JAX's does, and the swap refuses another topology."""
    from bnn_pynq_tpu.parallel.tp import TPInferenceEngine as JaxTP
    jc, pcomp = random_pair("lfc-w1a1")
    _, other = mini_pair("cnv", 1, 1, seed=11)
    x = np.random.default_rng(14).choice([-1, 1], size=(10, 784)) \
        .astype(np.int8)
    jeng = JaxTP(jc, jax_mesh(2, 2), batch_buckets=(16,))
    want = np.asarray(jeng.classify(x))
    jdev, jb = jeng.logits_device(x, argmax=True)
    np.testing.assert_array_equal(np.asarray(jdev)[:jb], want)
    for res in run_jobs(2, 2, [("h", job_tp_hooks, (pcomp, x, other))]):
        h = res["h"]
        assert h["b"] == 10
        np.testing.assert_array_equal(h["argmax"], want)
        np.testing.assert_array_equal(h["classify"], want)
        np.testing.assert_array_equal(h["after_swap"], want)
        assert "no packed-words path" in h["words_refused"]
        assert "topology" in h["topology"]


# -- two processes -----------------------------------------------------------

def job_local_rows(mesh, compiled, x):
    """The overlap forward's rows of this rank ('data' index) and the
    gathered whole."""
    from bnn_pynq_tpu_torch.parallel.overlap import (make_overlap_tp_forward,
                                                     shard_overlap_params)
    state = shard_overlap_params(compiled, mesh)
    fwd = make_overlap_tp_forward(compiled.config, mesh)
    rows = len(x) // mesh.shape["data"]
    lo = mesh.coords[0] * rows
    local = torch.from_numpy(x[lo:lo + rows])
    whole = fwd(*state, local).numpy()
    return {"rows": (lo, lo + rows), "shard": whole[lo:lo + rows],
            "whole": whole, "world": dist.get_world_size()}


def test_two_process_world():
    """The counterpart of tests/test_multihost.py: two spawned ranks on a
    (2, 1) mesh, each with a model axis of one; each rank's rows of the
    output equal the single-process golden reference."""
    _, pcomp = random_pair("lfc-w1a1")
    x = np.random.default_rng(0).choice([-1, 1], size=(64, 784)) \
        .astype(np.int8)
    golden = ref_engine(pcomp).logits(x, prepared=True)
    res = run_jobs(2, 1, [("rows", job_local_rows, (pcomp, x))])
    assert [r["rows"]["rows"] for r in res] == [(0, 32), (32, 64)]
    for r in res:
        lo, hi = r["rows"]["rows"]
        assert r["rows"]["world"] == 2
        np.testing.assert_allclose(r["rows"]["shard"], golden[lo:hi], **TOL)
        np.testing.assert_allclose(r["rows"]["whole"], golden, **TOL)


# -- the world's deadline --------------------------------------------------

def job_raise_on_rank1(mesh):
    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    time.sleep(3600)        # rank 0 stands for a collective that never ends


def job_hang(mesh):
    time.sleep(3600)


def job_exit_on_rank1(mesh):
    if dist.get_rank() == 1:
        os._exit(3)
    time.sleep(3600)


def test_world_ends_when_a_rank_raises():
    t0 = time.monotonic()
    with pytest.raises(WorldError) as err:
        run_jobs(2, 1, [("x", job_raise_on_rank1, ())])
    assert time.monotonic() - t0 < DEADLINE
    text = str(err.value)
    assert "rank 1 raised" in text
    assert "ValueError: rank 1 fails on purpose" in text
    assert "--- rank 0" in text and "--- rank 1" in text


def test_world_ends_when_a_rank_dies():
    t0 = time.monotonic()
    with pytest.raises(WorldError,
                       match="rank 1 exited with code 3 and no result"):
        run_jobs(2, 1, [("x", job_exit_on_rank1, ())])
    assert time.monotonic() - t0 < DEADLINE


def test_run_world_defaults_to_the_card(monkeypatch):
    """Without device=, run_world asks for the card and raises where
    there is none: it never falls back to CPU ranks."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_world(_jobs_worker, 1, args=(1, 1, []), timeout=10)


def test_world_deadline_kills_a_hung_world():
    t0 = time.monotonic()
    with pytest.raises(WorldError, match="deadline of 10 s passed"):
        run_world(_jobs_worker, 2, args=(2, 1, [("x", job_hang, ())]),
                  device="cpu", timeout=10)
    assert time.monotonic() - t0 < 10 + 15


# -- the scaling harness -----------------------------------------------------

def test_scaling_harness_runs():
    from bnn_pynq_tpu.parallel.benchmark import \
        measure_tp_scaling as jax_scaling
    from bnn_pynq_tpu_torch.parallel.benchmark import measure_tp_scaling
    jc, pcomp = random_pair("sfc-w1a1")
    rows = measure_tp_scaling(pcomp, device_counts=[1, 2],
                              batch_per_device=8, iters=1, device="cpu")
    jrows = jax_scaling(jc, device_counts=[1, 2], batch_per_device=8,
                        iters=1)
    assert [r["devices"] for r in rows] == [1, 2]
    assert [(r["mesh"], r["batch"]) for r in rows] == \
        [(r["mesh"], r["batch"]) for r in jrows]
    assert set(jrows[0]) < set(rows[0])
    assert all(r["images_per_sec"] > 0 for r in rows)
    assert rows[0]["scaling_efficiency"] == 1.0
    assert all(r["ranks_per_card"] is None for r in rows)     # CPU ranks


def test_no_jax_in_the_parallel_package():
    """The parallel modules import torch, never jax or bnn_pynq_tpu."""
    import re
    from pathlib import Path
    pkg = Path(__file__).resolve().parents[1] / "bnn_pynq_tpu_torch" / \
        "parallel"
    bad = re.compile(r"^\s*(import jax|from jax|import bnn_pynq_tpu\b|"
                     r"from bnn_pynq_tpu(\.|\s))", re.M)
    names = sorted(p.name for p in pkg.glob("*.py"))
    assert {"mesh.py", "tp.py", "overlap.py", "benchmark.py"} <= set(names)
    for p in pkg.glob("*.py"):
        assert not bad.search(p.read_text()), p.name
