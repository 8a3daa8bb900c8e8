"""The port's sharded (dp × tp) training (parallel/train_sharded.py) on gloo
worlds of CPU ranks, against the JAX package's sharded step on the virtual
CPU mesh at the same mesh shape, from the same state:

- one step from JAX's `init_sharded` on mini CNV-W1A1 at mesh (2, 4) and
  on mini MLP-W2A2 at (1, 2) (where the classes-wide last layer is sharded
  too): loss rtol=1e-5, atol=1e-6; parameters and batch statistics
  rtol=5e-2, atol=2e-3 (tests/test_sharding.py:106-118: Adam's first step
  is about -lr·sign(g), so a gradient of rounding noise moves a weight by
  lr either way);
- the epoch equals the steps one by one, rtol=1e-5, atol=1e-6
  (tests/test_sharding.py:121-146), and the parameters replicated over
  'model' stay bitwise equal across the model ranks;
- the spec rule equals JAX's `_param_spec`; the gathered variables compile
  to JAX's artifact;
- the three autograd collectives against single-process autograd on the
  whole tensors, for a column-parallel and for a replicated consumer, and
  the summing backward of `torch.distributed.nn`'s all-gather shown m
  times too large on the replicated one.

The ranks run module-level job functions of this file and import torch and
the port only; JAX runs in the pytest process.
"""

import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from bnn_pynq_tpu_torch.compiler.artifacts import (config_from_json,
                                                   config_to_json)
from bnn_pynq_tpu_torch.compiler.finnthesizer import compile_network
from bnn_pynq_tpu_torch.models.config import get_config
from bnn_pynq_tpu_torch.parallel import (comm, gather_variables,
                                         init_sharded, make_mesh,
                                         make_sharded_epoch_fn,
                                         make_sharded_train_step)
from bnn_pynq_tpu_torch.parallel.launch import run_world
from bnn_pynq_tpu_torch.parallel.train_sharded import (ShardedQuantNet,
                                                       make_param_shardings,
                                                       shard_train_state)
from bnn_pynq_tpu_torch.train.trainer import Adam
from tests.test_torch_parallel import DEADLINE, jax_mesh

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)       # tests/test_sharding.py:106
PARAM_TOL = dict(rtol=5e-2, atol=2e-3)      # tests/test_sharding.py:114
EPOCH_TOL = dict(rtol=1e-5, atol=1e-6)      # tests/test_sharding.py:141
LR = 1e-3


def _np_tree(tree):
    return {k: _np_tree(v) if hasattr(v, "items") else np.asarray(v)
            for k, v in tree.items()}


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if hasattr(v, "items"):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _assert_trees(got, want, **tol):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_allclose(g[k], w[k], err_msg=k, **tol)


# -- job functions (they run in the ranks) -------------------------------

def _mesh_job(data, model, fn, args):
    return fn(make_mesh(data=data, model=model, device="cpu"), *args)


def _world(data, model, fn, *args):
    return run_world(_mesh_job, data * model, args=(data, model, fn, args),
                     device="cpu", timeout=DEADLINE)


def job_one_step(mesh, cfg, params, stats, x, y):
    """One sharded step from the given (full) state: the global loss, the
    gathered variables, the collectives it called."""
    model = ShardedQuantNet(cfg, mesh, params, stats)
    tx = Adam(model, total_steps=1, lr_start=LR, lr_end=LR,
              glorot_lr_scale=False)
    step = make_sharded_train_step(cfg, mesh, model, tx)
    comm.reset_counts()
    loss = float(step(x, y))
    counts = comm.counts()
    return {"loss": loss, "variables": gather_variables(model, mesh),
            "counts": counts, "sharded": sorted(model.sharded)}


def sharded_grads(mesh, cfg, params, stats, x, y):
    """The gradients of the global loss from the given state, averaged
    over 'data' and gathered over 'model': {parameter name: array}."""
    from bnn_pynq_tpu_torch.parallel.train_sharded import _rows
    from bnn_pynq_tpu_torch.train.trainer import squared_hinge_loss
    model = ShardedQuantNet(cfg, mesh, params, stats)
    loss = squared_hinge_loss(model(_rows(x, mesh), train=True),
                              _rows(y, mesh), cfg.num_classes)
    named = list(model.named_parameters())
    out = {}
    for (name, _), g in zip(named, torch.autograd.grad(
            loss, [p for _, p in named])):
        g = comm.psum(g, mesh.data_group) / mesh.shape["data"]
        if int(name.split(".")[1].split("_")[1]) in model.sharded:
            g = comm.all_gather(g, mesh.model_group, axis=-1)
        out[name] = g.numpy()
    return out


def job_steps_and_epoch(mesh, cfg, params, stats, x, y, xs, ys):
    """The gradients and the one step of job_one_step, then from
    `init_sharded(seed=3)` three steps one by one and the same three as an
    epoch, each rank's local state after the steps, and the error of an
    odd batch."""
    grads = sharded_grads(mesh, cfg, params, stats, x, y)
    out = job_one_step(mesh, cfg, params, stats, x, y)
    out["grads"] = grads
    model, tx = init_sharded(cfg, mesh, lr=LR, seed=3)
    step = make_sharded_train_step(cfg, mesh, model, tx)
    out["step_losses"] = [float(step(xs[i], ys[i])) for i in range(3)]
    out["local"] = model.variables()
    out["stepwise"] = gather_variables(model, mesh)
    model, tx = init_sharded(cfg, mesh, lr=LR, seed=3)
    out["epoch_losses"] = make_sharded_epoch_fn(cfg, mesh, model, tx)(xs, ys)
    out["epoch"] = gather_variables(model, mesh)
    try:
        step(x[:7], y[:7])
    except ValueError as e:
        out["odd_batch"] = str(e)
    return out


class _SummingGather(torch.autograd.Function):
    """What `torch.distributed.nn.functional.all_gather` does: all-gather
    forward, the gradient summed over the group and sliced (a
    reduce-scatter) backward."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group, ctx.width = group, t.shape[1]
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size(
            group))]
        dist.all_gather(parts, t.contiguous(), group=group)
        return torch.cat(parts, 1)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        me = dist.get_rank(ctx.group)
        return g[:, me * ctx.width:(me + 1) * ctx.width], None


def _collective_net(x, w1, consumer, gather, copy, mean):
    """x @ w1 (column-parallel), minus its batch mean, tanh, gathered;
    then a column-parallel or a replicated consumer; the loss."""
    h = copy(x) @ w1
    h = torch.tanh(h - mean(h.mean(0)))
    h = gather(h)
    kind, w = consumer
    out = gather(copy(h) @ w) if kind == "column" else h @ w
    return torch.square(out).mean()


def job_collectives(mesh, full):
    """Per consumer, the local gradients of the sharded net (averaged over
    'data'), and the replicated consumer's through the summing gather."""
    mg, dg = mesh.model_group, mesh.data_group
    (i, j), (d, m) = mesh.coords, (mesh.shape["data"], mesh.shape["model"])
    x, w1, w2, w3 = (torch.from_numpy(a) for a in full)
    rows = x.shape[0] // d
    x = x[i * rows:(i + 1) * rows]

    def cols(w):
        n = w.shape[1] // m
        return w[:, j * n:(j + 1) * n].clone().requires_grad_()

    def run(consumer_kind, gather):
        a = cols(w1)
        b = cols(w2) if consumer_kind == "column" else \
            w3.clone().requires_grad_()
        loss = _collective_net(
            x, a, (consumer_kind, b), gather,
            lambda t: comm.copy_to_model(t, mg),
            lambda t: comm.mean_over_data(t, dg))
        grads = torch.autograd.grad(loss, [a, b])
        return [(comm.psum(g, dg) / d).numpy() for g in grads]

    comm.reset_counts()
    out = {"column": run("column", lambda t: comm.gather_model(t, mg, 1)),
           "counts": comm.counts()}
    out["replicated"] = run("replicated",
                            lambda t: comm.gather_model(t, mg, 1))
    out["summing"] = run("replicated",
                         lambda t: _SummingGather.apply(t, mg))
    return out


# -- JAX's side ----------------------------------------------------------

def _jax_step(make_cfg, wbits, abits, data, model, bias_seed=None):
    """JAX's init_sharded(seed=0) and one sharded step on default_rng(0)
    x, y at batch 8: (port config, state before, x, y, loss, state
    after). bias_seed: first draw the BatchNorm biases from N(0, 0.3)
    (and shard the state again with JAX's shard_train_state)."""
    import jax
    from bnn_pynq_tpu.compiler.artifacts import config_to_json as jax_json
    from bnn_pynq_tpu.parallel.train_sharded import (
        init_sharded as jax_init, make_sharded_train_step as jax_step,
        shard_train_state as jax_shard)
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
    rng = np.random.default_rng(0)
    shape = (8, int(np.prod(cfg.input_shape))) \
        if cfg.input_kind == "bipolar" else (8,) + cfg.input_shape
    x = rng.normal(size=shape).astype(np.float32)
    y = rng.integers(0, cfg.num_classes, size=8).astype(np.int32)
    before = _np_tree(jax.device_get(params)), \
        _np_tree(jax.device_get(stats))
    p1, s1, _, loss = jax_step(cfg, mesh, tx)(params, stats, opt, x, y)
    return (config_from_json(jax_json(cfg)), before, x, y, float(loss),
            (_np_tree(jax.device_get(p1)), _np_tree(jax.device_get(s1))))


@pytest.fixture(scope="module")
def cnv_world():
    """JAX's step on mini CNV-W1A1 at (2, 4), and the port's world of 8
    ranks at (2, 4) on the same state and batch."""
    from tests.test_finnthesizer import mini_cnv
    cfg, (p0, s0), x, y, loss, after = _jax_step(mini_cnv, 1, 1, 2, 4)
    rng = np.random.default_rng(5)
    xs = rng.normal(size=(3, 4) + tuple(cfg.input_shape)).astype(np.float32)
    ys = rng.integers(0, 10, size=(3, 4)).astype(np.int32)
    res = _world(2, 4, job_steps_and_epoch, cfg, p0, s0, x, y, xs, ys)
    return {"cfg": cfg, "loss": loss, "after": after, "res": res,
            "before": (p0, s0, x, y)}


def test_step_matches_jax_cnv_2x4(cnv_world):
    want_p, want_s = cnv_world["after"]
    for out in cnv_world["res"]:
        np.testing.assert_allclose(out["loss"], cnv_world["loss"],
                                   **LOSS_TOL)
        _assert_trees(out["variables"]["params"], want_p, **PARAM_TOL)
        _assert_trees(out["variables"]["batch_stats"], want_s, **PARAM_TOL)
    # m = 4: the 10-wide last layer (index 4) stays whole
    assert cnv_world["res"][0]["sharded"] == [0, 2, 3]


def test_gradients_match_one_process_cnv_2x4(cnv_world):
    """Before Adam (which is blind to a gradient's scale, so a step cannot
    show a backward m times too large): the sharded gradients, averaged
    over 'data' and gathered over 'model', equal the whole model's in one
    process from the same state and batch."""
    from bnn_pynq_tpu_torch.train.model import QuantNet
    from bnn_pynq_tpu_torch.train.trainer import squared_hinge_loss
    p0, s0, x, y = cnv_world["before"]
    model = QuantNet(cnv_world["cfg"])
    model.load_variables(p0, s0)
    loss = squared_hinge_loss(model(torch.from_numpy(x), train=True),
                              torch.from_numpy(y), 10)
    named = list(model.named_parameters())
    want = dict(zip([n for n, _ in named], torch.autograd.grad(
        loss, [p for _, p in named])))
    for out in cnv_world["res"]:
        assert out["grads"].keys() == want.keys()
        for name, g in out["grads"].items():
            np.testing.assert_allclose(g, want[name].numpy(), rtol=1e-4,
                                       atol=1e-7, err_msg=name)


def test_step_collectives_cnv_2x4(cnv_world):
    """Per step: a gather and a mean each way per sharded layer, a copy's
    backward per sharded layer after the first, a mean each way per
    whole layer's BatchNorm, two psums (gradients, loss)."""
    counts = cnv_world["res"][0]["counts"]
    assert counts["gather_model"] == 3
    assert counts["copy_to_model"] == 2
    assert counts["mean_over_data"] == 2 * 4
    assert counts["psum"] == 2
    assert counts["all_gather"] == counts["host_copies"] == 0


def test_epoch_equals_stepwise_2x4(cnv_world):
    for out in cnv_world["res"]:
        np.testing.assert_allclose(out["epoch_losses"], out["step_losses"],
                                   **EPOCH_TOL)
        _assert_trees(out["epoch"], out["stepwise"], **EPOCH_TOL)


def test_replicated_params_bitwise_equal_across_model_ranks(cnv_world):
    """After three steps: the last layer (whole on every rank) and every
    block of a sharded layer equal their copies on the other ranks bit for
    bit (the same bytes in, the same summation out)."""
    res = cnv_world["res"]
    ranks = np.arange(8).reshape(2, 4)
    for layer in ("quant_4", "bn_4"):
        for r in range(1, 8):
            for leaf, v in res[r]["local"]["params"][layer].items():
                assert np.array_equal(
                    v, res[0]["local"]["params"][layer][leaf]), (r, layer)
    for j in range(4):           # across 'data', every leaf
        a, b = res[ranks[0, j]]["local"], res[ranks[1, j]]["local"]
        for (k, u), (_, v) in zip(_leaves(a), _leaves(b)):
            assert np.array_equal(u, v), (j, k)


def test_odd_batch_raises(cnv_world):
    assert "does not split over 'data' = 2" in \
        cnv_world["res"][0]["odd_batch"]


def test_gathered_variables_compile_as_jax(cnv_world):
    """The gathered variables → the port's compile_network equals JAX's
    compile_network on the same arrays."""
    from bnn_pynq_tpu.compiler import compile_network as jax_compile
    from tests.test_finnthesizer import mini_cnv
    v = cnv_world["res"][0]["variables"]
    got = compile_network(cnv_world["cfg"], v["params"], v["batch_stats"])
    want = jax_compile(mini_cnv(1, 1), v["params"], v["batch_stats"])
    assert len(got.layers) == len(want.layers)
    for a, b in zip(got.layers, want.layers):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], np.asarray(b[k]))
    np.testing.assert_array_equal(got.out_scale, np.asarray(want.out_scale))
    np.testing.assert_array_equal(got.out_bias, np.asarray(want.out_bias))


def test_step_matches_jax_mlp_w2a2_1x2():
    """m = 2 shards the 10-wide last layer as well: the loss consumes
    gathered logits, a replicated consumer of `gather_model`.

    The BatchNorm biases are drawn off flax's 0 first. At bias 0 a channel
    that is constant over the batch normalises to rounding noise around
    0, the 2-bit quantizer's middle boundary, so float32 summation order
    picks its code: there JAX's own sharded step differs from JAX's
    unsharded step (loss 1.6941 against 1.6591 at (1, 2)), and the port's
    sharded step equals the unsharded one."""
    from tests.test_finnthesizer import mini_mlp
    cfg, (p0, s0), x, y, loss, (want_p, want_s) = _jax_step(
        mini_mlp, 2, 2, 1, 2, bias_seed=7)
    res = _world(1, 2, job_one_step, cfg, p0, s0, x, y)
    for out in res:
        assert out["sharded"] == [0, 1, 2]
        np.testing.assert_allclose(out["loss"], loss, **LOSS_TOL)
        _assert_trees(out["variables"]["params"], want_p, **PARAM_TOL)
        _assert_trees(out["variables"]["batch_stats"], want_s, **PARAM_TOL)
    assert res[0]["counts"]["gather_model"] == 3


@pytest.mark.parametrize("m", [1, 2, 4])
def test_param_specs_match_jax(m):
    """The spec of every CNV-W1A1 leaf equals JAX's `_param_spec`."""
    import jax
    from bnn_pynq_tpu.models import get_config as jax_config
    from bnn_pynq_tpu.parallel.train_sharded import _param_spec
    from bnn_pynq_tpu.train.model import QuantNet as JaxQuantNet
    from flax import traverse_util
    cfg = jax_config("cnv-w1a1")
    params = JaxQuantNet(cfg).init(
        jax.random.PRNGKey(0), np.zeros((1,) + cfg.input_shape, np.float32),
        train=False)["params"]
    got = make_param_shardings(_np_tree(params), types.SimpleNamespace(
        shape={"data": 1, "model": m}))
    flat = traverse_util.flatten_dict(_np_tree(params))
    want = {"/".join(k): tuple(_param_spec(k, v, m)) for k, v in flat.items()}
    assert dict(_leaves(got)) == want
    n_sharded = sum("model" in s for s in want.values())
    assert n_sharded == {1: 27, 2: 27, 4: 24}[m]


def test_shard_train_state_slices_columns():
    """Each rank's blocks: a sharded kernel's N/m columns, the BatchNorm
    vectors and statistics the same channels, the moments as their
    parameters; whole leaves untouched."""
    cfg = get_config("cnv-w1a1")
    from bnn_pynq_tpu_torch.train.model import QuantNet
    v = QuantNet(cfg).variables()
    opt = {"count": 3, "mu": v["params"], "nu": v["params"]}
    for j in range(2):
        mesh = types.SimpleNamespace(shape={"data": 1, "model": 2},
                                     coords=(0, j), device=torch.device("cpu"))
        p, bs, o = shard_train_state(v["params"], v["batch_stats"], opt, mesh)
        k = v["params"]["quant_0"]["kernel"]
        assert torch.equal(p["quant_0"]["kernel"],
                           torch.from_numpy(k[..., 32 * j:32 * (j + 1)]))
        assert tuple(bs["bn_10"]["mean"].shape) == (5,)
        assert torch.equal(o["mu"]["quant_8"]["kernel"],
                           p["quant_8"]["kernel"])
        assert o["count"] == 3


def test_autograd_collectives_against_one_process():
    """On a (2, 2) world in float64: the sharded net's gradients equal the
    whole net's, for a column-parallel consumer (`copy_to_model` in front,
    `gather_model` after) and for a replicated one; the summing gather
    gives the replicated consumer's input layer m = 2 times its gradient,
    so this check would catch it."""
    rng = np.random.default_rng(4)
    full = (rng.normal(size=(6, 5)), rng.normal(size=(5, 8)),
            rng.normal(size=(8, 6)), rng.normal(size=(8, 3)))
    res = _world(2, 2, job_collectives, full)
    ranks = np.arange(4).reshape(2, 2)

    def whole(kind):
        t = [torch.from_numpy(a).requires_grad_() for a in full]
        w = t[2] if kind == "column" else t[3]
        loss = _collective_net(t[0], t[1], (kind, w), lambda h: h,
                               lambda h: h, lambda h: h)
        return [g.numpy() for g in torch.autograd.grad(loss, [t[1], w])]

    for kind in ("column", "replicated"):
        want = whole(kind)
        for j in range(2):
            g1, g2 = res[ranks[0, j]][kind]
            assert np.array_equal(g1, res[ranks[1, j]][kind][0])
            np.testing.assert_allclose(g1, want[0][:, 4 * j:4 * (j + 1)],
                                       rtol=1e-12, atol=1e-14)
            cols = want[1][:, 3 * j:3 * (j + 1)] if kind == "column" \
                else want[1]
            np.testing.assert_allclose(g2, cols, rtol=1e-12, atol=1e-14)
    for j in range(2):
        trap = res[ranks[0, j]]["summing"][0]
        right = want[0][:, 4 * j:4 * (j + 1)]
        assert not np.allclose(trap, right, rtol=1e-3)
        np.testing.assert_allclose(trap, 2 * right, rtol=1e-12, atol=1e-14)
    counts = res[0]["counts"]        # the column-parallel net alone
    assert counts["gather_model"] == 2
    assert counts["copy_to_model"] == 1     # x needs no gradient
    assert counts["mean_over_data"] == 2
