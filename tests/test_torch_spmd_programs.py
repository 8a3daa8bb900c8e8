"""The parallel engines' programs and the captured sharded step
(parallel/spmd.py, tp.py, overlap.py, train_sharded.py) on gloo worlds of
CPU ranks, where a program runs the eager forward into its fixed buffers
and the sharded step runs eagerly; what only a card shows (the graphs,
their collectives at capture, the replays) is `chip_smoke.py` phase 21.

- TPInferenceEngine ('vpu', 'mxu'), OverlapTPEngine (ring, blocking,
  'auto') and make_gspmd_engine on meshes (1, 2), (2, 1) and (2, 2) on the
  mini CNV of tests/test_finnthesizer.py: each program's output equal to
  the engine's eager forward bit for bit, the logits within rtol=atol=1e-5
  of the JAX engine on the same mesh (tests/test_golden_fixtures.py:36),
  classes equal; one program per (bucket, variant), the same keys on every
  rank; the packed-words variants on the mini MLP;
- a load_parameters between two launches: old, then new, on the leader
  and on a follower, every program made again on the new shards;
- the sharded step as a TrainStep equal bit for bit to the step as it ran
  before (`_eager_step` below), and its epoch within the tolerances of
  tests/test_torch_train_sharded.py of JAX's make_sharded_epoch_fn on the
  mini CNV and the mini MLP; Adam's table growing by doubling at the
  captured step's end, the graph dropped for a new capture;
- a gloo collective inside a capture raising before it stages anything,
  and a failed capture naming the engine, the mesh, the bucket and the
  variant, with no eager fallback.

The ranks run this file's module-level job functions and import torch and
the port only; JAX runs in the pytest process.
"""

import numpy as np
import pytest
import torch

from bnn_pynq_tpu_torch import native
from bnn_pynq_tpu_torch.parallel import comm
from bnn_pynq_tpu_torch.parallel.overlap import OverlapTPEngine
from bnn_pynq_tpu_torch.parallel.tp import (TPInferenceEngine,
                                            make_gspmd_engine)
from bnn_pynq_tpu_torch.runtime.engine import EXECUTIONS
from tests.test_torch_parallel import (TOL, images, jax_mesh, mini_pair,
                                       ref_engine, run_jobs)
from tests.test_torch_train_sharded import (EPOCH_TOL, LOSS_TOL, LR,
                                            PARAM_TOL, _assert_trees,
                                            _np_tree)

MESHES = [(1, 2), (2, 1), (2, 2)]
ENGINES = ["tp-vpu", "tp-mxu", "ring", "blocking", "auto", "gspmd"]
BUCKETS = (8,)
STEPS = 2


def _engine(name, compiled, mesh):
    if name == "gspmd":
        return make_gspmd_engine(compiled, mesh)
    if name.startswith("tp-"):
        return TPInferenceEngine(compiled, mesh, route=name[3:],
                                 batch_buckets=BUCKETS)
    return OverlapTPEngine(compiled, mesh, arm=name, calib_iters=1,
                           batch_buckets=BUCKETS)


def _keys(eng):
    return sorted((k[0], str(k[1]), k[2], k[3]) for k in eng.programs)


# -- job functions (they run in the ranks) -------------------------------

def _held(eng, xd, argmax, words=False):
    """A launch through the program, and whether it equals the eager
    forward of this rank's rows bit for bit."""
    got = eng.launch_prepared(xd, argmax=argmax, words=words)
    want = eng._eager(eng._state.params, eng._rows(xd), argmax, words)
    return got, torch.equal(got, want)


def job_engine(mesh, name, compiled, x):
    """One engine on the mini CNV: logits and classes of x (a second batch
    of the same bucket in between), each program against the eager
    forward, the program keys."""
    eng = _engine(name, compiled, mesh)
    if name == "gspmd":
        logits = eng(x)
        eng(x[:3])                                  # a new padded shape
        (shape, prog), = [(s, p) for s, p in eng.programs.items()
                          if s[0] * mesh.shape["data"] == len(x)]
        rows = shape[0]
        xl = torch.from_numpy(x[mesh.coords[0] * rows:][:rows])
        return {"logits": logits, "equal": [torch.equal(
            prog(xl), eng.forward(xl))], "keys": sorted(eng.programs),
            "execution": eng.execution}
    logits = eng.logits(x)
    eng.logits(x[:3])                               # the same bucket
    classes = eng.classify(x)
    xd = eng.upload(eng._pad_to_bucket(x)[0])
    equal = [_held(eng, xd, argmax)[1] for argmax in (False, True)]
    prog = eng.programs[(tuple(eng._rows(xd).shape), torch.int8, False,
                         False)]
    return {"logits": logits, "classes": classes, "equal": equal,
            "keys": _keys(eng), "execution": eng.execution,
            "repr": repr(eng), "replays": prog.replays.value,
            "graph": prog.graph, "collectives": prog.collectives}


def job_words(mesh, compiled, x):
    """OverlapTPEngine's packed-words variants on the mini MLP."""
    eng = OverlapTPEngine(compiled, mesh, batch_buckets=BUCKETS)
    words = native.pack_bits(x)
    dev, b = eng.words_device(words)
    cls, _ = eng.words_device(words, argmax=True)
    wd = eng.upload(eng._pad_to_bucket(np.asarray(words, np.uint32))[0])
    equal = [_held(eng, wd, argmax, True)[1] for argmax in (False, True)]
    return {"words": eng.fetch(dev)[:b], "words_cls": eng.fetch(cls)[:b],
            "logits": eng.logits(x), "equal": equal, "keys": _keys(eng)}


def job_swap(mesh, compiled, other, x):
    """Serving: the leader launches, swaps to `other`, launches again; a
    follower records the outputs of the launches it follows."""
    eng = OverlapTPEngine(compiled, mesh, batch_buckets=BUCKETS)
    eng.logits(x)                           # a program before serving
    if not eng.is_leader:
        outs, run = [], eng._run
        eng._run = lambda *a: outs.append(run(*a)) or outs[-1]
        before = list(eng.programs.values())
        eng.follow()
    else:
        eng.lead()
        before = list(eng.programs.values())
        outs = [eng.launch_prepared(eng.upload(eng._pad_to_bucket(x)[0]))]
        eng.load_parameters(other)
        outs.append(eng.launch_prepared(
            eng.upload(eng._pad_to_bucket(x)[0])))
        eng.close()
    after = list(eng.programs.values())
    return {"outs": [o.numpy()[:len(x)] for o in outs],
            "version": eng.version, "keys": _keys(eng),
            "fresh": not any(a is b for a in after for b in before)}


def _eager_step(config, mesh, model, tx):
    """The sharded step as it ran before it became a TrainStep: the rows
    moved to the device, the forward, the gradients' flat psum, the
    update, then the loss's psum."""
    from bnn_pynq_tpu_torch.parallel.train_sharded import _rows
    from bnn_pynq_tpu_torch.train.model import full_fp32
    from bnn_pynq_tpu_torch.train.trainer import squared_hinge_loss
    group, d = mesh.data_group, mesh.shape["data"]

    def step(x, y):
        x, y = _rows(x, mesh).to(mesh.device), _rows(y, mesh).to(mesh.device)
        with full_fp32():
            loss = squared_hinge_loss(model(x, train=True), y,
                                      config.num_classes)
            grads = torch.autograd.grad(loss, tx.params)
        flat = comm.psum(torch.cat([g.reshape(-1) for g in grads]),
                         group) / d
        tx.update([f.view_as(g) for f, g in zip(
            flat.split([g.numel() for g in grads]), grads)])
        return comm.psum(loss.detach(), group) / d

    return step


def job_sharded(mesh, cfg, params, stats, xs, ys):
    """From the given full state: STEPS steps of the step as it ran
    before, of make_sharded_train_step and make_sharded_epoch_fn; the
    losses and gathered variables of each."""
    from bnn_pynq_tpu_torch.parallel import (gather_variables,
                                             make_sharded_epoch_fn,
                                             make_sharded_train_step)
    from bnn_pynq_tpu_torch.parallel.train_sharded import ShardedQuantNet
    from bnn_pynq_tpu_torch.train.trainer import Adam, TrainStep
    out = {}
    for kind in ("before", "step", "epoch"):
        model = ShardedQuantNet(cfg, mesh, params, stats)
        tx = Adam(model, total_steps=1, lr_start=LR, lr_end=LR,
                  glorot_lr_scale=False)
        if kind == "epoch":
            run = make_sharded_epoch_fn(cfg, mesh, model, tx)
            losses = run(xs, ys)
            assert isinstance(run.step, TrainStep)
        else:
            step = (_eager_step if kind == "before"
                    else make_sharded_train_step)(cfg, mesh, model, tx)
            losses = [float(step(x, y)) for x, y in zip(xs, ys)]
        out[kind] = {"losses": np.asarray(losses, np.float32),
                     "variables": gather_variables(model, mesh),
                     "count": tx.count}
    return out


def job_table(mesh, cfg, params, stats, xs, ys):
    """Adam's table at the captured step's end, from `Adam(total_steps=1)`:
    after two eager steps (the table grown to 2 rows by the updates) a
    graph standing is dropped and the table grows to twice the steps
    taken, a new tensor whose rows keep their values, the old one as the
    graph saw it; with rows to spare a graph stays; the eager step runs
    on past every table end."""
    from bnn_pynq_tpu_torch.parallel import make_sharded_train_step
    from bnn_pynq_tpu_torch.parallel.train_sharded import ShardedQuantNet
    from bnn_pynq_tpu_torch.train.trainer import Adam
    model = ShardedQuantNet(cfg, mesh, params, stats)
    tx = Adam(model, total_steps=1, lr_start=LR, lr_end=LR,
              glorot_lr_scale=False)
    step = make_sharded_train_step(cfg, mesh, model, tx)
    step(xs[0], ys[0])
    step(xs[1], ys[1])
    old, seen = tx.table, tx.table.clone()
    step.graph = graph = object()           # a captured step, simulated
    step._fit_table()
    out = {"graphs": step.graphs, "rows": (seen.shape[0], tx.table.shape[0]),
           "dropped": step.graph is None, "new_tensor": tx.table is not old,
           "old_kept": torch.equal(old, seen),
           "values": torch.equal(tx.table, torch.tensor(
               [tx._row(c) for c in range(tx.table.shape[0])]))}
    step.graph = graph
    step._fit_table()
    out["kept"] = step.graph is graph
    step.graph = None
    for i in range(8):
        step(xs[i % len(xs)], ys[i % len(ys)])
    out["count"] = tx.count
    return out


def job_gloo_capture(mesh):
    """Every collective on this gloo mesh while a capture is running (the
    flag simulated) raises before it stages anything."""
    t = torch.ones(2, 3)
    calls = {
        "all_gather": lambda: comm.all_gather(t, mesh.model_group),
        "gather_batch": lambda: comm.gather_batch(t, mesh.data_group),
        "psum": lambda: comm.psum(t, mesh.data_group),
        "ppermute": lambda: comm.ppermute_start(t, mesh.model_group),
        "broadcast": lambda: comm.broadcast(t, mesh.leader, mesh.group),
        "mean_over_data": lambda: comm.mean_over_data(t, mesh.data_group)}
    out = {}
    capturing, comm._capturing = comm._capturing, lambda: True
    try:
        for name, call in calls.items():
            try:
                call()
                out[name] = None
            except RuntimeError as e:
                out[name] = str(e)
    finally:
        comm._capturing = capturing
    out["host_copies"] = comm.counts()["host_copies"]
    return out


def job_failed_capture(mesh, compiled, x):
    """A capture that fails raises, naming what it captured; nothing
    falls back to the eager forward."""
    class Broken:
        def wait_stream(self, other):
            raise RuntimeError("no capture here")

    eng = TPInferenceEngine(compiled, mesh, route="vpu",
                            batch_buckets=BUCKETS)
    eng.programs.execution, eng.programs.stream = "graphs", Broken()
    try:
        eng.logits(x)
        return {"raised": None}
    except RuntimeError as e:
        return {"raised": str(e), "programs": len(eng.programs)}


# -- the worlds ------------------------------------------------------------

def _jax_step_state(make_cfg, wbits, abits, data, model, bias_seed=None):
    """JAX's init_sharded(seed=0) state on the mesh (BatchNorm biases drawn
    first with bias_seed, as tests/test_torch_train_sharded.py does), and
    JAX's make_sharded_epoch_fn over STEPS seeded batches of 8."""
    import jax
    from bnn_pynq_tpu.compiler.artifacts import config_to_json as jax_json
    from bnn_pynq_tpu.parallel.train_sharded import (
        init_sharded as jax_init, make_sharded_epoch_fn as jax_epoch,
        shard_train_state as jax_shard)
    from bnn_pynq_tpu_torch.compiler.artifacts import config_from_json
    cfg = make_cfg(wbits, abits)
    mesh = jax_mesh(data, model)
    _, params, stats, opt, tx = jax_init(cfg, mesh, seed=0)
    if bias_seed is not None:
        params = _np_tree(jax.device_get(params))
        draw = np.random.default_rng(bias_seed)
        for layer, leaves in params.items():
            if layer.startswith("bn_"):
                leaves["bias"] = draw.normal(
                    0, 0.3, size=leaves["bias"].shape).astype(np.float32)
        params, stats, opt = jax_shard(params, stats, tx.init(params), mesh)
    rng = np.random.default_rng(6)
    shape = (STEPS, 8, int(np.prod(cfg.input_shape))) \
        if cfg.input_kind == "bipolar" else (STEPS, 8) + cfg.input_shape
    xs = rng.normal(size=shape).astype(np.float32)
    ys = rng.integers(0, cfg.num_classes, size=(STEPS, 8)).astype(np.int32)
    before = (_np_tree(jax.device_get(params)),
              _np_tree(jax.device_get(stats)))
    p1, s1, _, losses = jax_epoch(cfg, mesh, tx)(params, stats, opt, xs, ys)
    return {"cfg": config_from_json(jax_json(cfg)), "before": before,
            "xs": xs, "ys": ys, "losses": np.asarray(losses),
            "after": {"params": _np_tree(jax.device_get(p1)),
                      "batch_stats": _np_tree(jax.device_get(s1))}}


def _random_pair(make_cfg, seed):
    """(JAX, port) CompiledNetwork of JAX's `init_random_params` on a mini
    net of tests/test_finnthesizer.py (W1A1), unit scale, zero bias."""
    from bnn_pynq_tpu.compiler.finnthesizer import \
        CompiledNetwork as JaxCompiled
    from bnn_pynq_tpu.models.network import init_random_params
    from tests.test_torch_parallel import port_compiled
    cfg = make_cfg(1, 1)
    jc = JaxCompiled(
        config=cfg,
        layers=[{k: np.asarray(v) for k, v in layer.items()}
                for layer in init_random_params(cfg, seed=seed)],
        out_scale=np.ones(cfg.num_classes, np.float32),
        out_bias=np.zeros(cfg.num_classes, np.float32))
    return jc, port_compiled(jc)


@pytest.fixture(scope="module")
def nets():
    """The mini CNV (perturbed BatchNorm, JAX's compiler), a second
    parameter set for it and the mini MLP (random parameters), each with
    a prepared batch of 6."""
    from tests.test_finnthesizer import mini_cnv, mini_mlp
    jc, pc = mini_pair("cnv", 1, 1, seed=11)
    jm, pm = _random_pair(mini_mlp, 11)
    _, other = _random_pair(mini_cnv, 12)
    x = ref_engine(pc).prepare(images(pc.config, 6, 0))
    xm = ref_engine(pm).prepare(images(pm.config, 6, 1))
    return {"cnv": (jc, pc, x), "mlp": (jm, pm, xm), "other": other}


@pytest.fixture(scope="module")
def sharded_states():
    from tests.test_finnthesizer import mini_cnv, mini_mlp
    """JAX's states and epochs. The BatchNorm biases are drawn off flax's
    0 first, as tests/test_torch_train_sharded.py does for the mini MLP:
    at bias 0 a channel constant over the batch sits on a quantizer
    boundary, where float32 summation order picks its code, and by the
    second step a statistic of the mini CNV follows the code picked."""
    return {"cnv": _jax_step_state(mini_cnv, 1, 1, 2, 2, bias_seed=7),
            "mlp": _jax_step_state(mini_mlp, 2, 2, 1, 2, bias_seed=7)}


def _state_args(st):
    return (st["cfg"], *st["before"], st["xs"], st["ys"])


@pytest.fixture(scope="module")
def worlds(nets, sharded_states):
    """One world a mesh: every engine, and on (1, 2) the words, the swap,
    the mini MLP's sharded step, Adam's table and the capture checks; on
    (2, 2) the mini CNV's sharded step."""
    _, cnv, x = nets["cnv"]
    out = {}
    for data, model in MESHES:
        jobs = [(name, job_engine, (name, cnv, x)) for name in ENGINES]
        if (data, model) == (1, 2):
            jobs += [("words", job_words, (nets["mlp"][1], nets["mlp"][2])),
                     ("swap", job_swap, (cnv, nets["other"], x)),
                     ("sharded", job_sharded,
                      _state_args(sharded_states["mlp"])),
                     ("table", job_table,
                      _state_args(sharded_states["mlp"])),
                     ("gloo", job_gloo_capture, ()),
                     ("failed", job_failed_capture, (cnv, x))]
        if (data, model) == (2, 2):
            jobs.append(("sharded", job_sharded,
                         _state_args(sharded_states["cnv"])))
        out[(data, model)] = run_jobs(data, model, jobs)
    return out


def _jax_engine(name, jc, data, model):
    from bnn_pynq_tpu.parallel.overlap import OverlapTPEngine as JaxOverlap
    from bnn_pynq_tpu.parallel.tp import TPInferenceEngine as JaxTP
    from bnn_pynq_tpu.parallel.tp import make_gspmd_engine as jax_gspmd
    mesh = jax_mesh(data, model)
    if name == "gspmd":
        return jax_gspmd(jc, mesh)
    if name.startswith("tp-"):
        return JaxTP(jc, mesh, route=name[3:], batch_buckets=BUCKETS)
    return JaxOverlap(jc, mesh, arm=name, calib_iters=1,
                      batch_buckets=BUCKETS)


# -- the engines' programs ---------------------------------------------------

@pytest.mark.parametrize("name", ENGINES)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_programs_equal_eager_and_jax(name, mesh, nets, worlds):
    """Each program's output is the eager forward bit for bit; the logits
    are JAX's engine's on the same mesh, the classes equal; one program a
    (bucket, variant), the same on every rank."""
    jc, _, x = nets["cnv"]
    jeng = _jax_engine(name, jc, *mesh)
    want = np.asarray(jeng(x) if name == "gspmd" else jeng.logits(x))
    res = [r[name] for r in worlds[mesh]]
    d = mesh[0]
    for rank, got in enumerate(res):
        assert all(got["equal"]), (rank, got["equal"])
        np.testing.assert_allclose(got["logits"], want, **TOL,
                                   err_msg=f"rank {rank}")
        assert got["execution"] == "programs"
        assert got["keys"] == res[0]["keys"]
        if name == "gspmd":         # padded to a multiple of 'data' only
            assert got["keys"] == sorted(
                (-(-b // d), 10, 10, 3) for b in (len(x), 3))
            continue
        np.testing.assert_array_equal(
            got["classes"], np.asarray(jeng.classify(x)))
        local = (8 // d, 10, 10, 3)
        assert got["keys"] == [(local, "torch.int8", False, False),
                               (local, "torch.int8", True, False)]
        assert got["graph"] is None and got["replays"] == 0    # the CPU
        assert got["collectives"] == {}     # counted at a capture only
        assert "'programs'" in got["repr"] and \
            EXECUTIONS["programs"] in got["repr"]


def test_words_programs(nets, worlds):
    """The packed-words variants of OverlapTPEngine on the mini MLP: the
    words logits and classes equal the int8 input's, the programs the
    eager forward; one program a variant."""
    jm, pm, xm = nets["mlp"]
    want = np.asarray(_jax_engine("ring", jm, 1, 2).logits(xm))
    for got in (r["words"] for r in worlds[(1, 2)]):
        np.testing.assert_allclose(got["logits"], want, **TOL)
        np.testing.assert_array_equal(got["words"], got["logits"])
        np.testing.assert_array_equal(got["words_cls"],
                                      got["logits"].argmax(-1))
        assert all(got["equal"])
        assert [k[2:] for k in got["keys"]] == [
            (False, True), (True, True), (False, False)]


def test_swap_between_launches_leader_and_follower(nets, worlds):
    """load_parameters between two launches on the serving leader: the
    first launch is the old parameters', the second the new ones', on
    the leader and on the follower, whose programs were all made again."""
    _, cnv, x = nets["cnv"]
    want_a = ref_engine(cnv, batch_buckets=BUCKETS).logits(x, prepared=True)
    want_b = ref_engine(nets["other"], batch_buckets=BUCKETS).logits(
        x, prepared=True)
    assert not np.allclose(want_a, want_b)
    leader, follower = (r["swap"] for r in worlds[(1, 2)])
    for side in (leader, follower):
        assert len(side["outs"]) == 2
        np.testing.assert_allclose(side["outs"][0], want_a, **TOL)
        np.testing.assert_allclose(side["outs"][1], want_b, **TOL)
        assert side["version"] == 1 and side["fresh"]
        assert side["keys"] == leader["keys"]


# -- the sharded step --------------------------------------------------------

@pytest.mark.parametrize("net,mesh", [("cnv", (2, 2)), ("mlp", (1, 2))])
def test_sharded_step_equals_before_and_jax_epoch(net, mesh,
                                                  sharded_states, worlds):
    """The TrainStep sharded step equals the step as it ran before bit for
    bit; its epoch equals its steps and JAX's make_sharded_epoch_fn (loss
    within LOSS_TOL, parameters and statistics within PARAM_TOL)."""
    st = sharded_states[net]
    for rank, res in enumerate(r["sharded"] for r in worlds[mesh]):
        before, step, epoch = res["before"], res["step"], res["epoch"]
        assert np.array_equal(step["losses"], before["losses"]), rank
        _assert_trees(step["variables"], before["variables"], rtol=0,
                      atol=0)
        np.testing.assert_allclose(epoch["losses"], step["losses"],
                                   **EPOCH_TOL)
        _assert_trees(epoch["variables"], step["variables"], **EPOCH_TOL)
        np.testing.assert_allclose(epoch["losses"], st["losses"],
                                   **LOSS_TOL)
        _assert_trees(epoch["variables"], st["after"], **PARAM_TOL)
        assert before["count"] == step["count"] == epoch["count"] == STEPS


def test_sharded_step_grows_adam_table(worlds):
    """At the table's end the captured step's graph is dropped and the
    table grows to twice the steps taken (2 → 6 rows), the old table left
    as its graph saw it; short of the end nothing changes; the eager step
    (the CPU's) runs on past the table's end without limit."""
    for res in (r["table"] for r in worlds[(1, 2)]):
        assert res["graphs"] is False
        assert res["rows"] == (2, 6)
        assert res["dropped"] and res["new_tensor"] and res["old_kept"]
        assert res["values"]
        assert res["kept"]
        assert res["count"] == 10


# -- captures that cannot be -------------------------------------------------

def test_gloo_collective_inside_a_capture_raises(worlds):
    for res in (r["gloo"] for r in worlds[(1, 2)]):
        for name in ("all_gather", "gather_batch", "psum", "ppermute",
                     "broadcast", "mean_over_data"):
            assert "gloo collective inside a CUDA graph capture" in \
                res[name], name
        assert res["host_copies"] == 0


def test_failed_capture_names_engine_mesh_bucket_variant(worlds):
    for rank, res in enumerate(r["failed"] for r in worlds[(1, 2)]):
        msg = res["raised"]
        assert msg is not None, "a failed capture ran the eager forward"
        assert f"TPInferenceEngine on mesh {{'data': 1, 'model': 2}} " \
               f"(rank {rank}), bucket 8" in msg
        assert "variant logits failed" in msg
        assert res["programs"] == 0

