"""The port's OverlapTPEngine (bnn_pynq_tpu_torch/parallel/overlap.py) on
gloo worlds of CPU ranks, against the JAX package's OverlapTPEngine on the
virtual CPU mesh at the same mesh shape and against the port's
single-device reference engine: both arms and 'auto', the collectives each
arm issues (the counters of parallel/comm.py take the place of JAX's HLO
checks), conv networks, the row reorder, and serving led from
rank 0 (pipelined, packed words, a hot swap mid-serve).

As in tests/test_torch_parallel.py, the ranks run this file's module-level
job functions and import torch and the port only. Tolerance: logits
rtol=atol=1e-5 (tests/test_golden_fixtures.py:36), argmax equal.
"""

import numpy as np
import pytest

from bnn_pynq_tpu_torch import native
from bnn_pynq_tpu_torch.parallel import comm
from bnn_pynq_tpu_torch.parallel.overlap import (
    OverlapTPEngine, reorder_dense_rows_for_csharding)
from bnn_pynq_tpu_torch.runtime.serving import BatchingServer
from tests.test_torch_parallel import (TOL, jax_mesh, mini_pair,
                                       random_pair, ref_engine, run_jobs)


def _bipolar(b, seed):
    return np.random.default_rng(seed).choice([-1, 1], size=(b, 784)) \
        .astype(np.int8)


def _image_levels(b, shape, seed):
    return np.random.default_rng(seed).integers(
        -128, 128, size=(b,) + tuple(shape)).astype(np.int8)


# -- job functions (they run in the ranks) -------------------------------

def job_overlap(mesh, compiled, x, arm="ring", **kw):
    eng = OverlapTPEngine(compiled, mesh, arm=arm, **kw)
    comm.reset_counts()
    logits = eng.logits(x)
    return {"logits": logits, "counts": comm.counts(), "arm": eng.arm,
            "reason": eng.arm_reason, "repr": repr(eng)}


def job_forced(mesh, compiled):
    out = {"blocking": OverlapTPEngine(compiled, mesh, blocking=True).arm,
           "default": OverlapTPEngine(compiled, mesh).arm}
    try:
        OverlapTPEngine(compiled, mesh, arm="nope")
    except ValueError as e:
        out["nope"] = str(e)
    return out


def job_words(mesh, compiled, x):
    eng = OverlapTPEngine(compiled, mesh).warmup(len(x))
    words = native.pack_bits(x)
    dev, b = eng.words_device(words, argmax=False)
    cls, bc = eng.words_device(words, argmax=True)
    return {"words": eng.fetch(dev)[:b], "words_cls": eng.fetch(cls)[:bc],
            "logits": eng.logits(x)}


def job_serve(mesh, compiled, x, swap=None, other=None):
    """A BatchingServer over the engine on the driving rank, the others
    following: one request an image, or (with `swap`) a batch before and
    after a live `load_parameters(swap)` and a refused `other`."""
    eng = OverlapTPEngine(compiled, mesh)
    if not eng.is_leader:
        eng.follow()
        return {"version": eng.version}
    eng.lead()
    server = BatchingServer(eng, max_batch=16, max_wait_ms=5.0)
    out = {"pipeline_depth": server.pipeline_depth,
           "packed": server.packed_transport}
    try:
        if swap is None:
            futures = [server.submit(x[i]) for i in range(len(x))]
            out["got"] = np.asarray([f.result(60) for f in futures])
        else:
            out["got_a"] = server.submit_many(x).result(60)
            eng.load_parameters(swap)              # live hot swap
            out["got_b"] = server.submit_many(x).result(60)
            try:
                eng.load_parameters(other)
            except ValueError as e:
                out["topology"] = str(e)
    finally:
        server.stop()
        eng.close()
    out["version"] = eng.version
    out["batches"] = server.stats.batches
    return out


# -- the worlds ------------------------------------------------------------

@pytest.fixture(scope="module")
def nets():
    lfc = random_pair("lfc-w1a1")
    return {"lfc": lfc, "lfc-w1a2": random_pair("lfc-w1a2"),
            "cnv-w1a1": random_pair("cnv-w1a1"),
            "mini11": mini_pair("cnv", 1, 1, seed=11),
            "mini22": mini_pair("cnv", 2, 2, seed=11),
            "mini99": random_pair_mini(seed=99)}


def random_pair_mini(seed):
    """The mini CNV with `init_random_params` (the swap's second set)."""
    from bnn_pynq_tpu.compiler.finnthesizer import \
        CompiledNetwork as JaxCompiled
    from bnn_pynq_tpu.models.network import init_random_params
    from tests.test_finnthesizer import mini_cnv
    from tests.test_torch_parallel import port_compiled
    cfg = mini_cnv(1, 1)
    jc = JaxCompiled(
        config=cfg,
        layers=[{k: np.asarray(v) for k, v in layer.items()}
                for layer in init_random_params(cfg, seed=seed)],
        out_scale=np.ones(cfg.num_classes, np.float32),
        out_bias=np.zeros(cfg.num_classes, np.float32))
    return jc, port_compiled(jc)


X64 = _bipolar(64, 0)
X32 = _bipolar(32, 2)
XMINI = _image_levels(8, (10, 10, 3), 2)


@pytest.fixture(scope="module")
def world_1x4(nets):
    lfc, mini, cnv = nets["lfc"][1], nets["mini11"][1], nets["cnv-w1a1"][1]
    return run_jobs(1, 4, [
        ("lfc", job_overlap, (lfc, X64)),
        ("lfc_blocking", job_overlap, (lfc, X64, "blocking")),
        ("mini_ring", job_overlap, (mini, XMINI)),
        ("mini_blocking", job_overlap, (mini, XMINI, "blocking")),
        ("cnv", job_overlap, (cnv, _image_levels(4, (32, 32, 3), 5))),
    ])


@pytest.fixture(scope="module")
def world_2x2(nets):
    lfc = nets["lfc"][1]
    jobs = [("lfc", job_overlap, (lfc, X64)),
            ("auto", job_overlap, (lfc, X32, "auto"), ),
            ("forced", job_forced, (lfc,)),
            ("w1a2", job_overlap, (nets["lfc-w1a2"][1], X32)),
            ("words", job_words, (lfc, _bipolar(16, 12))),
            ("serve_lfc", job_serve, (lfc, _bipolar(13, 11))),
            ("serve_mini", job_serve,
             (nets["mini11"][1], _image_levels(13, (10, 10, 3), 4))),
            ("swap", job_serve,
             (nets["mini11"][1], _image_levels(6, (10, 10, 3), 13),
              nets["mini99"][1], lfc))]
    for key in ("mini11", "mini22"):
        for arm in ("ring", "blocking"):
            jobs.append((f"{key}_{arm}", job_overlap,
                         (nets[key][1], XMINI, arm)))
    return run_jobs(2, 2, jobs)


def _jax_overlap(jc, data, model, x, **kw):
    from bnn_pynq_tpu.parallel.overlap import OverlapTPEngine as JaxOverlap
    eng = JaxOverlap(jc, jax_mesh(data, model), **kw)
    return eng, np.asarray(eng.logits(x))


# -- equal to one device and to JAX ------------------------------------------

@pytest.mark.parametrize("data,model", [(1, 4), (2, 2), (4, 1), (2, 4)])
def test_overlap_tp_matches_single_device(data, model, nets, request):
    jc, pcomp = nets["lfc"]
    want = ref_engine(pcomp, batch_buckets=(64,)).logits(X64, prepared=True)
    _, want_jax = _jax_overlap(jc, data, model, X64)
    np.testing.assert_allclose(want_jax, want, **TOL)
    if (data, model) in ((1, 4), (2, 2)):
        res = request.getfixturevalue(f"world_{data}x{model}")
    else:
        res = run_jobs(data, model, [("lfc", job_overlap, (pcomp, X64))])
    assert len(res) == data * model
    for r, out in enumerate(res):
        np.testing.assert_allclose(out["lfc"]["logits"], want, **TOL,
                                   err_msg=f"rank {r}")
        np.testing.assert_allclose(out["lfc"]["logits"], want_jax, **TOL)


def test_ring_and_blocking_collectives(world_1x4):
    """The ring arm issues ppermutes and no all_gather between hidden
    layers, and psums only the logits; the blocking arm gathers before
    every ring layer and permutes nothing. LFC: 3 hidden layers, of which
    the 2 after the first ring; mini CNV: conv1 and dense0 ring."""
    for out in world_1x4:
        for net, ring_layers in (("lfc", 2), ("mini", 2)):
            ring = out["lfc" if net == "lfc" else "mini_ring"]["counts"]
            block = out[f"{net}_blocking"]["counts"]
            assert ring["all_gather"] == 0
            assert ring["ppermute"] == 3 * ring_layers      # d - 1 steps
            assert ring["psum"] == 1 and block["psum"] == 1
            assert block["all_gather"] == ring_layers
            assert block["ppermute"] == 0
            assert ring["host_copies"] == block["host_copies"] == 0
            np.testing.assert_allclose(
                out[f"{net}_blocking"]["logits"],
                out["lfc" if net == "lfc" else "mini_ring"]["logits"], **TOL)


def test_arm_auto_selection_exact_and_recorded(nets, world_2x2):
    jc, pcomp = nets["lfc"]
    jeng, want_jax = _jax_overlap(jc, 2, 2, X32, arm="auto", calib_iters=3)
    assert jeng.arm in ("ring", "blocking")
    want = ref_engine(pcomp, batch_buckets=(32,)).logits(X32, prepared=True)
    np.testing.assert_allclose(want_jax, want, **TOL)
    arms = {out["auto"]["arm"] for out in world_2x2}
    reasons = {out["auto"]["reason"] for out in world_2x2}
    assert len(arms) == 1 and len(reasons) == 1, "ranks chose differently"
    for out in world_2x2:
        auto = out["auto"]
        assert auto["arm"] in ("ring", "blocking")
        assert "measured ring" in auto["reason"]
        assert auto["arm"] in auto["repr"]
        np.testing.assert_allclose(auto["logits"], want, **TOL)


def test_arm_forced_matches_blocking_kwarg(world_2x2):
    for out in world_2x2:
        assert out["forced"]["blocking"] == "blocking"
        assert out["forced"]["default"] == "ring"
        assert "ring|blocking|auto" in out["forced"]["nope"]


def test_overlap_tp_w1a2(nets, world_2x2):
    jc, pcomp = nets["lfc-w1a2"]
    want = ref_engine(pcomp, batch_buckets=(32,)).logits(X32, prepared=True)
    np.testing.assert_allclose(_jax_overlap(jc, 2, 2, X32)[1], want, **TOL)
    for out in world_2x2:
        np.testing.assert_allclose(out["w1a2"]["logits"], want, **TOL)


@pytest.mark.parametrize("key", ["mini11", "mini22"])
def test_overlap_tp_conv_matches_ref(key, nets, world_2x2):
    """Mini CNV W1A1 and W2A2, both arms, on (2, 2)."""
    jc, pcomp = nets[key]
    want = ref_engine(pcomp, batch_buckets=(8,)).logits(XMINI,
                                                        prepared=True)
    for arm in ("ring", "blocking"):
        _, want_jax = _jax_overlap(jc, 2, 2, XMINI,
                                   blocking=(arm == "blocking"))
        np.testing.assert_allclose(want_jax, want, **TOL)
        for out in world_2x2:
            np.testing.assert_allclose(out[f"{key}_{arm}"]["logits"], want,
                                       **TOL, err_msg=arm)
            np.testing.assert_array_equal(
                out[f"{key}_{arm}"]["logits"].argmax(-1), want.argmax(-1))


def test_overlap_tp_model_axis_of_one(nets):
    """On (2, 1) a rank holds every shard: the ring arm runs the one
    thresholded product a layer (no ppermute, no gather) and equals the
    blocking arm, JAX's engine and the reference on the mini CNV."""
    jc, pcomp = nets["mini11"]
    want = ref_engine(pcomp, batch_buckets=(8,)).logits(XMINI,
                                                        prepared=True)
    res = run_jobs(2, 1, [(arm, job_overlap, (pcomp, XMINI, arm))
                          for arm in ("ring", "blocking")])
    for arm in ("ring", "blocking"):
        _, want_jax = _jax_overlap(jc, 2, 1, XMINI,
                                   blocking=(arm == "blocking"))
        np.testing.assert_allclose(want_jax, want, **TOL)
        for out in res:
            np.testing.assert_allclose(out[arm]["logits"], want, **TOL,
                                       err_msg=arm)
    for out in res:
        ring, block = out["ring"]["counts"], out["blocking"]["counts"]
        assert ring["ppermute"] == ring["all_gather"] == 0
        assert block["all_gather"] == 2 and block["ppermute"] == 0


def test_overlap_tp_full_cnv_w1a1(nets, world_1x4):
    """Full-size CNV-W1A1 on (1, 4): the shapes a serving deployment runs
    (C-shards of 16-64 channels on the ring's conv2d_direct)."""
    jc, pcomp = nets["cnv-w1a1"]
    x = _image_levels(4, (32, 32, 3), 5)
    want = ref_engine(pcomp, batch_buckets=(4,)).logits(x, prepared=True)
    np.testing.assert_allclose(_jax_overlap(jc, 1, 4, x)[1], want, **TOL)
    for out in world_1x4:
        np.testing.assert_allclose(out["cnv"]["logits"], want, **TOL)
        assert out["cnv"]["counts"]["all_gather"] == 0


def test_reorder_matches_jax():
    from bnn_pynq_tpu.parallel.overlap import \
        reorder_dense_rows_for_csharding as jax_reorder
    rng = np.random.default_rng(0)
    for hw, c, d in ((1, 8, 2), (4, 6, 3), (9, 16, 4), (25, 256, 8)):
        w = rng.integers(-3, 4, size=(hw * c, 5)).astype(np.int8)
        np.testing.assert_array_equal(
            reorder_dense_rows_for_csharding(w, hw, c, d),
            jax_reorder(w, hw, c, d))
    for hw, c, d in ((4, 6, 4), (3, 7, 1)):       # C % d, rows != hw·c
        w = np.zeros((4 * 6, 2), np.int8)
        with pytest.raises(ValueError):
            reorder_dense_rows_for_csharding(w, hw, c, d)
        with pytest.raises(ValueError):
            jax_reorder(w, hw, c, d)


# -- serving from rank 0 ---------------------------------------------

def test_tp_serving_pipelined_and_packed(nets, world_2x2):
    """A BatchingServer on the driving rank over the LFC engine pipelines
    (logits_device) and ships packed words (words_device); the other
    ranks follow to the end."""
    _, pcomp = nets["lfc"]
    x = _bipolar(13, 11)
    want = ref_engine(pcomp, batch_buckets=(16,)).classify(x, prepared=True)
    lead, *followers = world_2x2
    s = lead["serve_lfc"]
    assert s["pipeline_depth"] == 2, "TP engine must pipeline"
    assert s["packed"], "bipolar TP engine must ship words"
    np.testing.assert_array_equal(s["got"], want)
    assert s["batches"] >= 1
    assert all(f["serve_lfc"] == {"version": 0} for f in followers)


def test_batching_server_owns_tp_engine(nets, world_2x2):
    _, pcomp = nets["mini11"]
    x = _image_levels(13, (10, 10, 3), 4)
    want = ref_engine(pcomp, batch_buckets=(16,)).classify(x, prepared=True)
    np.testing.assert_array_equal(world_2x2[0]["serve_mini"]["got"], want)
    assert not world_2x2[0]["serve_mini"]["packed"]


def test_tp_words_device_exact(world_2x2):
    for out in world_2x2:
        w = out["words"]
        np.testing.assert_allclose(w["words"], w["logits"], **TOL)
        np.testing.assert_array_equal(w["words_cls"],
                                      w["logits"].argmax(-1))


def test_tp_hot_swap_mid_serve(nets, world_2x2):
    """load_parameters on the serving leader: the batch after the swap sees
    the new parameters on every rank (each follower ends at the leader's
    version), and the swap refuses another topology before any
    collective."""
    _, ca = nets["mini11"]
    _, cb = nets["mini99"]
    x = _image_levels(6, (10, 10, 3), 13)
    want_a = ref_engine(ca, batch_buckets=(16,)).classify(x, prepared=True)
    want_b = ref_engine(cb, batch_buckets=(16,)).classify(x, prepared=True)
    assert not np.array_equal(want_a, want_b)
    lead, *followers = world_2x2
    s = lead["swap"]
    np.testing.assert_array_equal(s["got_a"], want_a)
    np.testing.assert_array_equal(s["got_b"], want_b)
    assert "topology" in s["topology"]
    assert s["version"] == 1
    assert all(f["swap"] == {"version": 1} for f in followers)
