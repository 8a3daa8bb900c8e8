"""The port's training stack against the JAX package's, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX function
and its port; parameters are carried across from flax's init (the two
packages' generators differ, so no test compares seeds). Tolerances:

- STE forward and backward: bitwise (the port repeats JAX's operations in
  JAX's order).
- QuantNet logits: atol 1e-5. Batch statistics: atol 1e-6 plus rtol 1e-5;
  the relative part is for a CNV's first BatchNorm, whose int8/128 inputs
  make float32 sums round (XLA sums in another order). The unbiased
  variance would be off by n/(n-1), 4e-4 relative at n = 1152 and 3 % at
  n = 32.
- Gradients: rtol 1e-4, atol 1e-6.
- The optimizer alone, on the same gradients: float32 rounding (rtol
  1e-6).
- Whole train steps, each from the same state: loss rtol 1e-6;
  batch_stats as above; Adam's moments and the params within what Adam
  makes of the gradient tolerance, element by element: the largest
  |u(g') − u(g)| × lr × scale over g' within δ = 1e-6 + 1e-4·|g| of g
  (Adam's direction u is not monotone in g, so g' is sampled). Adam
  divides by sqrt(nu): where a gradient's true value is 0 (a feature
  constant over the batch feeds a layer followed by BatchNorm, which
  removes the batch mean) each package computes its own rounding noise of
  ~1e-8, and Adam turns it into a step of up to lr × scale, which that
  bound allows.
- Training-mode forwards of 2-bit nets and the steps start from
  trained-like BatchNorms (see FORWARD_CASES).
"""

import itertools
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from flax import traverse_util

from bnn_pynq_tpu.compiler import artifacts as jax_art
from bnn_pynq_tpu.compiler import finnthesizer as jax_fin
from bnn_pynq_tpu.models import config as jc
from bnn_pynq_tpu.runtime.engine import InferenceEngine as JaxEngine
from bnn_pynq_tpu.train import data as jax_data
from bnn_pynq_tpu.train import model as jm
from bnn_pynq_tpu.train import quant as jq
from bnn_pynq_tpu.train import trainer as jt
from bnn_pynq_tpu_torch import cli
from bnn_pynq_tpu_torch.compiler import artifacts as port_art
from bnn_pynq_tpu_torch.compiler import finnthesizer as port_fin
from bnn_pynq_tpu_torch.models import config as pc
from bnn_pynq_tpu_torch.runtime.engine import InferenceEngine
from bnn_pynq_tpu_torch.train import data as port_data
from bnn_pynq_tpu_torch.train import model as pm
from bnn_pynq_tpu_torch.train import quant as pq
from bnn_pynq_tpu_torch.train import trainer as pt

LOGIT_TOL = dict(rtol=0, atol=1e-5)
STAT_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def tiny_mlp(mod, wbits=1, abits=1):
    """JAX's `tests/test_training.py::tiny_mlp`: 8×8×1 bipolar, 64-64-4."""
    return mod.NetworkConfig(
        name=f"tiny-w{wbits}a{abits}", wbits=wbits, abits=abits,
        input_kind="bipolar", input_shape=(8, 8, 1),
        layers=(mod.DenseSpec(64), mod.DenseSpec(64), mod.DenseSpec(4)),
        num_classes=4, dataset="mnist")


def tiny_cnv(mod, wbits=1, abits=1):
    """8×8×3 int8 input, two 3×3 convs of 16 channels, a 2×2 pool, a dense
    layer."""
    return mod.NetworkConfig(
        name=f"tiny-cnv-w{wbits}a{abits}", wbits=wbits, abits=abits,
        input_kind="int8", input_shape=(8, 8, 3),
        layers=(mod.ConvSpec(16), mod.ConvSpec(16), mod.PoolSpec(),
                mod.DenseSpec(4)),
        num_classes=4, dataset="cifar10")


NETS = {"mlp": tiny_mlp, "cnv": tiny_cnv}


def tiny_dataset(mod, n_train=512, n_test=256, ncls=4):
    """JAX's `tests/test_training.py::tiny_dataset`, as `mod.Dataset`."""
    rng = np.random.default_rng(0)
    protos = rng.choice([0, 255], size=(ncls, 8, 8, 1), p=[0.5, 0.5])

    def make(n, seed):
        r = np.random.default_rng(seed)
        y = r.integers(0, ncls, size=n).astype(np.int32)
        flips = r.random((n, 8, 8, 1)) < 0.05
        x = np.where(flips, 255 - protos[y], protos[y]).astype(np.uint8)
        return x, y

    xtr, ytr = make(n_train, 1)
    xte, yte = make(n_test, 2)
    return mod.Dataset("mnist", xtr, ytr, xte, yte, synthetic=True)


def _inputs(cfg, rng, n):
    if cfg.input_kind == "bipolar":
        x = rng.choice([-1.0, 1.0], size=(n, int(np.prod(cfg.input_shape))))
    else:
        x = rng.integers(-128, 128, size=(n,) + cfg.input_shape) / 128.0
    return x.astype(np.float32), \
        rng.integers(0, cfg.num_classes, n).astype(np.int32)


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, traverse_util.unflatten_dict(
        traverse_util.flatten_dict(dict(tree))))


def _pair(net, wbits, abits, seed=0, perturb=False):
    """(jax config, flax model, flax variables, port config, port model)
    with the flax init carried across; `perturb` gives the BatchNorms a
    trained network's spread (scale, bias, running mean and variance)."""
    jcfg, pcfg = NETS[net](jc, wbits, abits), NETS[net](pc, wbits, abits)
    jmodel = jm.QuantNet(jcfg)
    x, _ = _inputs(jcfg, np.random.default_rng(seed), 2)
    variables = jmodel.init(jax.random.PRNGKey(seed), x, train=False)
    variables = {k: _numpy_tree(v) for k, v in variables.items()}
    if perturb:
        rng = np.random.default_rng(seed + 100)
        for kind in ("params", "batch_stats"):
            for layer, leaves in variables[kind].items():
                for leaf, v in leaves.items():
                    draw = {"scale": lambda n: rng.normal(1.0, 0.3, n),
                            "bias": lambda n: rng.normal(0.0, 0.5, n),
                            "mean": lambda n: rng.normal(0.0, 2.0, n),
                            "var": lambda n: rng.uniform(0.5, 4.0, n)}
                    if leaf in draw:
                        leaves[leaf] = draw[leaf](v.shape).astype(np.float32)
    pmodel = pm.QuantNet(pcfg)
    pmodel.load_variables(variables["params"], variables["batch_stats"])
    return jcfg, jmodel, variables, pcfg, pmodel


def _assert_tree_close(got, want, what, **tol):
    flat_w = traverse_util.flatten_dict(dict(want))
    flat_g = traverse_util.flatten_dict(got)
    assert set(flat_g) == set(flat_w), (what, set(flat_g) ^ set(flat_w))
    for k, w in flat_w.items():
        np.testing.assert_allclose(flat_g[k], np.asarray(w), **tol,
                                   err_msg=f"{what} {k}")


# -- quantizers --------------------------------------------------------------

BOUNDARY = np.array([-2 / 3, 0.0, 2 / 3, 1.0, -1.0, 1 / 3, -1 / 3, 0.5,
                     -0.5, 1.5, -1.5, 2.0, -2.0, 1e-8, -1e-8, -0.0],
                    np.float32)


def _ste_inputs():
    """The boundaries, their float32 neighbours, random values. Next to 0
    the neighbours are the smallest normals: XLA on the CPU flushes
    subnormals to zero, so -1e-45 is 0 (→ +1) there and below 0 in torch."""
    near = np.concatenate([np.nextafter(BOUNDARY, np.float32(np.inf)),
                           np.nextafter(BOUNDARY, np.float32(-np.inf))])
    tiny = np.finfo(np.float32).tiny
    near = np.where(np.abs(near) < tiny, np.sign(near) * tiny, near)
    rand = np.random.default_rng(0).uniform(-1.5, 1.5, 2000)
    return np.concatenate([BOUNDARY, near, rand]).astype(np.float32)


@pytest.mark.parametrize("name", ["binarize", "quantize2"])
def test_ste_forward_backward_bitwise(name):
    x = _ste_inputs()
    weights = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)
    jfn, pfn = getattr(jq, name), getattr(pq, name)
    want = np.asarray(jfn(jnp.asarray(x)))
    want_g = np.asarray(jax.grad(lambda v: jnp.sum(jfn(v) * weights))(
        jnp.asarray(x)))
    t = torch.from_numpy(x).requires_grad_()
    got = pfn.apply(t)
    (got * torch.from_numpy(weights)).sum().backward()
    assert got.detach().numpy().tobytes() == want.tobytes()
    assert t.grad.numpy().tobytes() == want_g.tobytes()


def test_stochastic_ste_bitwise_with_the_same_u():
    x = _ste_inputs()
    u = np.random.default_rng(2).random(x.shape).astype(np.float32)
    weights = np.random.default_rng(3).normal(size=x.shape).astype(np.float32)
    want = np.asarray(jq._binarize_stochastic(jnp.asarray(x),
                                              jnp.asarray(u)))
    want_g = np.asarray(jax.grad(lambda v: jnp.sum(
        jq._binarize_stochastic(v, jnp.asarray(u)) * weights))(
            jnp.asarray(x)))
    t = torch.from_numpy(x).requires_grad_()
    tu = torch.from_numpy(u).requires_grad_()
    got = pq._binarize_stochastic.apply(t, tu)
    (got * torch.from_numpy(weights)).sum().backward()
    assert got.detach().numpy().tobytes() == want.tobytes()
    assert t.grad.numpy().tobytes() == want_g.tobytes()
    assert tu.grad is None                     # no gradient for u


def test_quantizers_are_autograd_functions():
    """binarize and quantize2 are JAX's call form over Functions, whose
    `.apply` they carry; the stochastic one is a Function itself."""
    for name in ("binarize", "quantize2"):
        apply = getattr(pq, name).apply
        assert issubclass(apply.__self__, torch.autograd.Function), name
    assert issubclass(pq._binarize_stochastic, torch.autograd.Function)


def test_binarize_stochastic_draws_from_its_generator():
    x = torch.zeros(10000)                      # p(+1) = 0.5
    a = pq.binarize_stochastic(x, torch.Generator().manual_seed(0))
    b = pq.binarize_stochastic(x, torch.Generator().manual_seed(0))
    assert torch.equal(a, b)
    assert 0.45 < float((a > 0).float().mean()) < 0.55
    assert set(a.unique().tolist()) <= {-1.0, 1.0}
    hi = pq.binarize_stochastic(torch.full((100,), 2.0),
                                torch.Generator().manual_seed(1))
    assert float(hi.min()) == 1.0
    v = torch.tensor([0.5, 3.0], requires_grad=True)
    pq.binarize_stochastic(v, torch.Generator().manual_seed(2)).sum() \
        .backward()
    assert v.grad.tolist() == [1.0, 0.0]


@pytest.mark.parametrize("bits", [1, 2])
def test_quantize_helpers_match_jax(bits):
    x = _ste_inputs()
    for jfn, pfn in ((jq.quantize_weights, pq.quantize_weights),
                     (jq.quantize_activations, pq.quantize_activations)):
        want = np.asarray(jfn(jnp.asarray(x), bits))
        got = pfn(torch.from_numpy(x), bits).numpy()
        assert got.tobytes() == want.tobytes()
        np.testing.assert_array_equal(pq.weight_levels(got, bits),
                                      jq.weight_levels(want, bits))
        np.testing.assert_array_equal(
            pq.weight_levels(torch.from_numpy(got), bits),
            jq.weight_levels(want, bits))
    with pytest.raises(ValueError):
        pq.quantize_weights(torch.from_numpy(x), 3)


# -- the model ---------------------------------------------------------------

# At flax's init (BatchNorm bias 0) a batch whose mean equals one of the
# discrete pre-activations puts a normalised value exactly on the
# quantizer's boundary at 0. With 1-bit weights and activations the sums
# are exact and both packages get 0 (→ +1); with ±1/3 levels they round,
# and float32 rounding decides the level in either package. So the
# training-mode forward of 2-bit nets is held from trained-like BatchNorms.
FORWARD_CASES = [
    (net, w, a, train, perturb)
    for net in NETS for (w, a) in ((1, 1), (1, 2), (2, 2))
    for train, perturb in ((False, False), (False, True), (True, True))
] + [(net, 1, 1, True, False) for net in NETS]


@pytest.mark.parametrize("net,wbits,abits,train_mode,perturb",
                         FORWARD_CASES)
def test_quantnet_forward_matches_flax(net, wbits, abits, train_mode,
                                       perturb):
    jcfg, jmodel, variables, _, pmodel = _pair(net, wbits, abits,
                                               perturb=perturb)
    x, _ = _inputs(jcfg, np.random.default_rng(5), 32)
    if train_mode:
        want, upd = jmodel.apply(variables, x, train=True,
                                 mutable=["batch_stats"])
        want_stats = upd["batch_stats"]
    else:
        want = jmodel.apply(variables, x, train=False)
        want_stats = variables["batch_stats"]
    got = pmodel(torch.from_numpy(x), train=train_mode)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **LOGIT_TOL)
    _assert_tree_close(pmodel.variables()["batch_stats"], want_stats,
                       "batch_stats", **STAT_TOL)


def test_variables_layout_is_flax_init():
    """Names, shapes and the params / batch_stats split of flax's init;
    load_variables → variables gives the arrays back."""
    for net in NETS:
        _, _, variables, _, pmodel = _pair(net, 1, 1)
        v = pmodel.variables()
        for kind in ("params", "batch_stats"):
            want = traverse_util.flatten_dict(dict(variables[kind]))
            got = traverse_util.flatten_dict(v[kind])
            assert set(got) == set(want)
            for k in want:
                assert got[k].dtype == np.float32
                np.testing.assert_array_equal(got[k], np.asarray(want[k]))
        bad = _numpy_tree(variables["params"])
        bad["quant_0"]["kernel"] = bad["quant_0"]["kernel"][..., :1]
        with pytest.raises(ValueError):
            pmodel.load_variables(bad, _numpy_tree(variables["batch_stats"]))


def test_glorot_init_from_an_explicit_generator():
    """Same generator seed, same network; kernels within flax's Glorot
    limit and filling it; BatchNorm starts at (1, 0, 0, 1)."""
    cfg = tiny_cnv(pc)
    a = pm.QuantNet(cfg, generator=torch.Generator().manual_seed(3))
    b = pm.QuantNet(cfg, generator=torch.Generator().manual_seed(3))
    c = pm.QuantNet(cfg, generator=torch.Generator().manual_seed(4))
    for (n, p), q, r in zip(a.state_dict().items(), b.state_dict().values(),
                            c.state_dict().values()):
        assert torch.equal(p, q), n
        if n.endswith("kernel"):
            assert not torch.equal(p, r)
            shape = p.shape
            rf = int(np.prod(shape[:-2]))
            limit = np.sqrt(6.0 / (shape[-2] * rf + shape[-1] * rf))
            assert float(p.abs().max()) <= limit
            assert float(p.abs().max()) > 0.9 * limit
    v = a.variables()
    assert (v["params"]["bn_0"]["scale"] == 1).all()
    assert (v["batch_stats"]["bn_0"]["var"] == 1).all()


def test_batchnorm_running_stats_are_flax_biased_ones():
    """The trap: torch's BatchNorm stores the unbiased variance. Ours holds
    0.9·1 + 0.1·biased var (float64 numpy) within 1e-6 relative, and the
    unbiased one is far off."""
    x = np.random.default_rng(6).normal(2.0, 3.0, (8, 5, 3, 3)) \
        .astype(np.float32)
    bn = pm.BatchNorm(5)
    bn(torch.from_numpy(x), train=True)
    x64 = x.astype(np.float64).transpose(1, 0, 2, 3).reshape(5, -1)
    want = 0.9 + 0.1 * x64.var(axis=1)
    np.testing.assert_allclose(bn.var.numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(bn.mean.numpy(), 0.1 * x64.mean(axis=1),
                               rtol=1e-6, atol=1e-7)
    tbn = torch.nn.BatchNorm2d(5, momentum=0.1)
    tbn(torch.from_numpy(x))
    assert np.abs(tbn.running_var.numpy() - want).max() > 1e-3


def test_maxpool_gradient_follows_xla_tie_breaking():
    """±1 codes tie in every window: the gradient goes where XLA's
    select_and_scatter sends it."""
    rng = np.random.default_rng(7)
    x = rng.choice([-1.0, 1.0], size=(4, 6, 6, 3)).astype(np.float32)
    g = rng.normal(size=(4, 3, 3, 3)).astype(np.float32)
    import flax.linen as nn
    want = np.asarray(jax.grad(lambda v: jnp.sum(
        nn.max_pool(v, (2, 2), strides=(2, 2)) * g))(jnp.asarray(x)))
    t = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    out = torch.nn.functional.max_pool2d(t, 2, 2)
    (out.permute(0, 2, 3, 1) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(t.grad.permute(0, 2, 3, 1).numpy(), want)


def test_stochastic_quantnet_needs_a_generator():
    cfg = tiny_mlp(pc)
    model = pm.QuantNet(cfg, stochastic=True)
    x = torch.from_numpy(_inputs(cfg, np.random.default_rng(8), 8)[0])
    out = model(x, train=True, generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(out).all()
    with pytest.raises(ValueError):
        model(x, train=True)
    # evaluation is deterministic whatever the flag
    assert torch.equal(model(x), model(x))


# -- loss, gradients, steps ----------------------------------------------------

def test_squared_hinge_loss_matches_jax():
    rng = np.random.default_rng(9)
    logits = rng.normal(size=(16, 10)).astype(np.float32)
    y = rng.integers(0, 10, 16).astype(np.int32)
    want = float(jt.squared_hinge_loss(jnp.asarray(logits), y, 10))
    got = float(pt.squared_hinge_loss(torch.from_numpy(logits),
                                      torch.from_numpy(y), 10))
    assert got == pytest.approx(want, rel=1e-6)


def _loss_grads_jax(jcfg, jmodel, params, stats, x, y):
    def loss_fn(p):
        out, _ = jmodel.apply({"params": p, "batch_stats": stats}, x,
                              train=True, mutable=["batch_stats"])
        return jt.squared_hinge_loss(out, y, jcfg.num_classes)
    return jax.value_and_grad(loss_fn)(params)


@pytest.mark.parametrize("net,wbits,abits",
                         [("cnv", 1, 1), ("cnv", 2, 2), ("mlp", 1, 2)])
def test_gradients_match_jax_grad(net, wbits, abits):
    jcfg, jmodel, variables, pcfg, pmodel = _pair(net, wbits, abits)
    x, y = _inputs(jcfg, np.random.default_rng(10), 32)
    want_loss, want = _loss_grads_jax(jcfg, jmodel, variables["params"],
                                      variables["batch_stats"], x, y)
    loss = pt.squared_hinge_loss(pmodel(torch.from_numpy(x), train=True),
                                 torch.from_numpy(y), pcfg.num_classes)
    names = [n for n, _ in pmodel.named_parameters()]
    grads = torch.autograd.grad(loss, list(pmodel.parameters()))
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-6)
    flat = traverse_util.flatten_dict(dict(want))
    assert {pt._path(n) for n in names} == set(flat)
    for n, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(flat[pt._path(n)]),
                                   **GRAD_TOL, err_msg=n)


def test_glorot_scale_tree_matches_jax():
    _, _, variables, _, pmodel = _pair("cnv", 1, 1)
    want = traverse_util.flatten_dict(jt._glorot_scale_tree(
        variables["params"]))
    got = traverse_util.flatten_dict(pt._glorot_scale_tree(
        pmodel.variables()["params"]))
    assert got == want
    assert pt._is_quant_kernel(("quant_3", "kernel"))
    assert not pt._is_quant_kernel(("bn_3", "scale"))


def test_learning_rate_schedule_matches_optax():
    model = pm.QuantNet(tiny_mlp(pc))
    tx = pt.Adam(model, 37, 5e-3, 1e-4)
    sched = optax.exponential_decay(5e-3, 37, 1e-4 / 5e-3)
    for t in (0, 1, 2, 10, 36, 37, 50):
        assert tx.learning_rate(t) == pytest.approx(float(sched(t)),
                                                    rel=1e-6), t
    assert tx.learning_rate(0) == float(np.float32(5e-3))


def _adam_state(opt_state):
    return next(s for s in jax.tree.leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))


def _adam_update(g, mu, nu, count):
    """optax's Adam direction for gradient g from moments (mu, nu) at the
    incremented count, in float64."""
    b1, b2, eps = pt.ADAM_B1, pt.ADAM_B2, pt.ADAM_EPS
    mu = b1 * mu + (1 - b1) * g
    nu = b2 * nu + (1 - b2) * g * g
    return (mu / (1 - b1 ** count)) / (np.sqrt(nu / (1 - b2 ** count))
                                       + eps), mu, nu


def test_adam_matches_optax_on_the_same_gradients():
    """The optimizer alone, on gradients given to both: optax.chain(adam(
    exponential_decay), per-leaf Glorot scale) and the clip, three steps
    without re-syncing: params, moments and count agree to float32
    rounding (rtol 1e-6, atol 1e-7). The gradients include zeros and
    values far below Adam's eps."""
    _, _, variables, _, pmodel = _pair("cnv", 1, 1)
    params = variables["params"]
    total, lr0, lr1 = 7, 0.05, 1e-4
    scales = jt._glorot_scale_tree(params)
    tx = optax.chain(optax.adam(optax.exponential_decay(lr0, total,
                                                        lr1 / lr0)),
                     jt._per_leaf_scale(scales))
    state = tx.init(params)
    ptx = pt.Adam(pmodel, total, lr0, lr1)
    paths = [pt._path(n) for n, _ in pmodel.named_parameters()]
    rng = np.random.default_rng(14)
    flat = traverse_util.flatten_dict(dict(params))
    for _ in range(3):
        g = {k: (rng.normal(size=v.shape) * 10.0 ** rng.integers(
            -12, 0, size=v.shape) * (rng.random(v.shape) > 0.1))
            .astype(np.float32) for k, v in flat.items()}
        upd, state = tx.update(traverse_util.unflatten_dict(
            {k: jnp.asarray(v) for k, v in g.items()}), state,
            traverse_util.unflatten_dict(flat))
        flat = traverse_util.flatten_dict(optax.apply_updates(
            traverse_util.unflatten_dict(flat), upd))
        flat = {k: (jnp.clip(v, -1.0, 1.0) if jt._is_quant_kernel(k)
                    else v) for k, v in flat.items()}
        ptx.update([torch.from_numpy(g[k]) for k in paths])
    adam = _adam_state(state)
    mu = traverse_util.flatten_dict(dict(adam.mu))
    nu = traverse_util.flatten_dict(dict(adam.nu))
    assert ptx.count == int(adam.count) == 3
    got = pmodel.variables()["params"]
    for i, k in enumerate(paths):
        np.testing.assert_allclose(got[k[0]][k[1]], np.asarray(flat[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=str(k))
        np.testing.assert_allclose(ptx.mu[i].numpy(), np.asarray(mu[k]),
                                   rtol=1e-6, atol=0, err_msg=str(k))
        np.testing.assert_allclose(ptx.nu[i].numpy(), np.asarray(nu[k]),
                                   rtol=1e-6, atol=0, err_msg=str(k))


@pytest.mark.parametrize("net,wbits,abits,glorot",
                         [("mlp", 1, 1, True), ("cnv", 1, 1, True),
                          ("cnv", 2, 2, True), ("cnv", 1, 1, False),
                          ("mlp", 1, 2, True)])
def test_three_steps_match_optax(net, wbits, abits, glorot):
    """Whole train steps (forward, loss, gradients, Adam, schedule, Glorot
    scale, clip) of the port against `_make_raw_step` with optax on the
    same batches, each step from the same state (params, batch_stats,
    Adam's moments and count): after each comparison the port takes JAX's
    state, since a step within tolerance can still flip the sign of a
    latent weight and with it the next forward."""
    jcfg, jmodel, variables, pcfg, pmodel = _pair(net, wbits, abits,
                                                  perturb=True)
    total, lr0, lr1 = 10, 3e-3, 1e-5
    params, stats = variables["params"], variables["batch_stats"]
    tx = optax.adam(optax.exponential_decay(lr0, total, lr1 / lr0))
    scales = jt._glorot_scale_tree(params) if glorot else {}
    if glorot:
        tx = optax.chain(tx, jt._per_leaf_scale(scales))
    opt_state = tx.init(params)
    jstep = jax.jit(jt._make_raw_step(jcfg, jmodel, tx))
    ptx = pt.Adam(pmodel, total, lr0, lr1, glorot_lr_scale=glorot)
    pstep = pt.make_train_step(pcfg, pmodel, ptx)
    paths = [pt._path(n) for n, _ in pmodel.named_parameters()]
    flat_s = traverse_util.flatten_dict(scales)
    rng = np.random.default_rng(11)
    for _ in range(3):
        x, y = _inputs(jcfg, rng, 32)
        before = _adam_state(opt_state)
        mu0 = traverse_util.flatten_dict(dict(before.mu))
        nu0 = traverse_util.flatten_dict(dict(before.nu))
        count, lr = int(before.count) + 1, ptx.learning_rate(ptx.count)
        params, stats, opt_state, want_loss = jstep(params, stats,
                                                    opt_state, x, y)
        loss = pstep(torch.from_numpy(x), torch.from_numpy(y))
        assert float(loss) == pytest.approx(float(want_loss), rel=1e-6)
        got = pmodel.variables()
        _assert_tree_close(got["batch_stats"], stats, "batch_stats",
                           **STAT_TOL)
        after = _adam_state(opt_state)
        mu = traverse_util.flatten_dict(dict(after.mu))
        nu = traverse_util.flatten_dict(dict(after.nu))
        assert ptx.count == int(after.count)
        flat_p = traverse_util.flatten_dict(dict(params))
        for i, k in enumerate(paths):
            # what Adam makes of the gradient tolerance, element by element,
            # around the gradient JAX's step used (read off its moments:
            # a gradient of rounding noise differs from call to call)
            m, n = np.asarray(mu0[k], np.float64), np.asarray(nu0[k],
                                                              np.float64)
            g = (np.asarray(mu[k], np.float64) - 0.9 * m) / 0.1
            dg = GRAD_TOL["atol"] + GRAD_TOL["rtol"] * np.abs(g)
            u = _adam_update(g, m, n, count)[0]
            du = np.max([np.abs(_adam_update(g + f * dg, m, n, count)[0] - u)
                         for f in np.linspace(-1.0, 1.0, 41)], axis=0)
            d = np.abs(got["params"][k[0]][k[1]] - np.asarray(flat_p[k]))
            tol = 1e-6 + lr * flat_s.get(k, 1.0) * du
            assert (d <= tol).all(), (k, d.max())
            np.testing.assert_allclose(ptx.mu[i].numpy(), np.asarray(mu[k]),
                                       rtol=1e-5, atol=0.1 * dg.max(),
                                       err_msg=str(k))
            np.testing.assert_allclose(
                ptx.nu[i].numpy(), np.asarray(nu[k]), rtol=1e-5,
                atol=1e-3 * (2 * np.abs(g) * dg + dg * dg).max(),
                err_msg=str(k))
            if pt._is_quant_kernel(k):
                assert np.abs(got["params"][k[0]][k[1]]).max() <= 1.0
        # the next step starts from JAX's state on both sides
        pmodel.load_variables(_numpy_tree(params), _numpy_tree(stats))
        with torch.no_grad():
            for i, k in enumerate(paths):
                ptx.mu[i].copy_(torch.from_numpy(np.array(mu[k])))
                ptx.nu[i].copy_(torch.from_numpy(np.array(nu[k])))


class _HostScalarAdam(pt.Adam):
    """Adam as the port computed it before its table: the learning rate
    and the bias corrections as host floats at each update (the same
    numpy float32 arithmetic), the moments and the update as before."""

    @torch.no_grad()
    def update(self, grads):
        b1, b2 = pt.ADAM_B1, pt.ADAM_B2
        lr = self.learning_rate(self.count)
        self.count += 1
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(self.count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(self.count))
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1 - b2))
        den = torch._foreach_sqrt(torch._foreach_div(self.nu, bc2))
        torch._foreach_add_(den, pt.ADAM_EPS)
        upd = torch._foreach_div(torch._foreach_div(self.mu, bc1), den)
        torch._foreach_mul_(upd, -lr)
        torch._foreach_mul_(upd, self.scales)
        torch._foreach_add_(self.params, upd)
        for p in self.clipped:
            p.clamp_(-1.0, 1.0)


@pytest.mark.parametrize("total,lr0,lr1", [(20, 0.05, 1e-4), (7, 0.05, 1e-4),
                                           (20, 3e-3, 3e-3)])
def test_device_table_adam_equals_host_scalar_adam_and_optax(total, lr0,
                                                             lr1):
    """20 updates from the first, on the same gradients (zeros and values
    far below eps among them), decaying (lr_end ≠ lr_start, past
    total_steps where the table grows) or constant: the table-driven Adam
    equals the host-scalar Adam bit for bit (parameters, moments, the
    device and host counters), and optax's chain within float32 rounding
    (rtol 1e-6, atol 1e-7; not bit for bit: XLA's pow rounds the learning
    rate one ulp off numpy's at some steps, and its fused arithmetic
    differs in the last bit on a few elements from the first step)."""
    _, _, variables, _, pmodel = _pair("cnv", 1, 1)
    ref_model = pm.QuantNet(tiny_cnv(pc))
    ref_model.load_variables(variables["params"], variables["batch_stats"])
    params = variables["params"]
    scales = jt._glorot_scale_tree(params)
    tx = optax.chain(optax.adam(optax.exponential_decay(lr0, total,
                                                        lr1 / lr0)),
                     jt._per_leaf_scale(scales))
    state = tx.init(params)
    ptx = pt.Adam(pmodel, total, lr0, lr1)
    host = _HostScalarAdam(ref_model, total, lr0, lr1)
    assert ptx.table.shape == (total, 3)
    paths = [pt._path(n) for n, _ in pmodel.named_parameters()]
    rng = np.random.default_rng(14)
    flat = traverse_util.flatten_dict(dict(params))
    for step in range(20):
        g = {k: (rng.normal(size=v.shape) * 10.0 ** rng.integers(
            -12, 0, size=v.shape) * (rng.random(v.shape) > 0.1))
            .astype(np.float32) for k, v in flat.items()}
        upd, state = tx.update(traverse_util.unflatten_dict(
            {k: jnp.asarray(v) for k, v in g.items()}), state,
            traverse_util.unflatten_dict(flat))
        flat = traverse_util.flatten_dict(optax.apply_updates(
            traverse_util.unflatten_dict(flat), upd))
        flat = {k: (jnp.clip(v, -1.0, 1.0) if jt._is_quant_kernel(k)
                    else v) for k, v in flat.items()}
        ptx.update([torch.from_numpy(g[k]) for k in paths])
        host.update([torch.from_numpy(g[k]) for k in paths])
        assert ptx.count == host.count == int(ptx.step) == step + 1
        for a, b in zip(ptx.params + ptx.mu + ptx.nu,
                        host.params + host.mu + host.nu):
            assert torch.equal(a, b), step
        got = pmodel.variables()["params"]
        for k in paths:
            np.testing.assert_allclose(got[k[0]][k[1]], np.asarray(flat[k]),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"{step} {k}")
    assert ptx.table.shape[0] >= 20
    adam = _adam_state(state)
    mu = traverse_util.flatten_dict(dict(adam.mu))
    for i, k in enumerate(paths):
        np.testing.assert_allclose(ptx.mu[i].numpy(), np.asarray(mu[k]),
                                   rtol=1e-6, atol=0, err_msg=str(k))


@pytest.mark.parametrize("net,wbits,abits", [("mlp", 1, 1), ("cnv", 1, 1),
                                             ("cnv", 2, 2), ("mlp", 1, 2)])
def test_epoch_equals_its_steps_and_jax_epoch(net, wbits, abits):
    """make_epoch_fn on JAX's permutation (the losses written into one
    [steps] tensor, the step object's buffers) against the same batches
    through the eager step, bit for bit, and against JAX's `lax.scan`
    epoch (`make_epoch_fn`, two steps, no state shared between them):
    losses within rtol 1e-6 and batch statistics within STAT_TOL, as a
    step is held; the parameters within what Adam can make of a gradient
    of rounding noise in either package, per step at most
    lr·scale·(1 − b1)/sqrt(1 − b2) (Kingma & Ba, §2.1), and equal within
    1e-6 for most elements (the median)."""
    jcfg, jmodel, variables, pcfg, pmodel = _pair(net, wbits, abits,
                                                  perturb=True)
    steps, bs, total, lr0, lr1 = 2, 32, 2, 3e-3, 1e-5
    params, stats = variables["params"], variables["batch_stats"]
    scales = jt._glorot_scale_tree(params)
    tx = optax.chain(optax.adam(optax.exponential_decay(lr0, total,
                                                        lr1 / lr0)),
                     jt._per_leaf_scale(scales))
    x, y = _inputs(jcfg, np.random.default_rng(5), steps * bs + 7)
    key = jax.random.PRNGKey(3)
    perm = np.asarray(jax.random.permutation(key, x.shape[0]))
    jparams, jstats, _, jlosses = jt.make_epoch_fn(
        jcfg, jmodel, tx, steps, bs)(params, stats, tx.init(params), x, y,
                                     key)

    twin = pm.QuantNet(pcfg)
    twin.load_variables(params, stats)
    ttx = pt.Adam(twin, total, lr0, lr1)
    tstep = pt.make_train_step(pcfg, twin, ttx)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y.astype(np.int64))
    order = torch.from_numpy(perm.astype(np.int64))
    want = torch.stack([tstep.eager(xt[order[i * bs:(i + 1) * bs]],
                                    yt[order[i * bs:(i + 1) * bs]])
                        for i in range(steps)])

    ptx = pt.Adam(pmodel, total, lr0, lr1)
    epoch = pt.make_epoch_fn(pcfg, pmodel, ptx, steps, bs)
    real = torch.randperm

    def jax_order(n, generator=None, device=None):
        assert n == x.shape[0]
        return order.clone()

    torch.randperm = jax_order
    try:
        losses = epoch(xt, yt, torch.Generator())
    finally:
        torch.randperm = real
    assert losses.shape == (steps,) and torch.equal(losses, want)
    for a, b in zip(pmodel.state_dict().values(), twin.state_dict().values()):
        assert torch.equal(a, b)
    assert ptx.count == steps and epoch.step.replays == 0     # the CPU

    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               rtol=1e-6)
    got = pmodel.variables()
    _assert_tree_close(got["batch_stats"], _numpy_tree(jstats),
                       "batch_stats", **STAT_TOL)
    adam_max = (1 - pt.ADAM_B1) / np.sqrt(1 - pt.ADAM_B2)
    lrs = sum(ptx.learning_rate(t) for t in range(steps))
    flat_s = traverse_util.flatten_dict(scales)
    flat_p = traverse_util.flatten_dict(_numpy_tree(jparams))
    for k, want_p in flat_p.items():
        d = np.abs(got["params"][k[0]][k[1]] - want_p)
        assert (d <= 1e-6 + 2 * lrs * flat_s.get(k, 1.0) * adam_max).all(), k
        assert np.median(d) <= 1e-6, (k, np.median(d))


def test_no_parameter_is_rebound_after_the_step_is_built(tmp_path,
                                                          monkeypatch):
    """A captured step holds the addresses of the parameters, statistics
    and Adam's buffers: `load_variables` copies in place, and
    `train(resume_from=...)` loads before the step is built, so the
    addresses the step records at its first call are the ones it sees at
    the end of the run, on the model `train` returns."""
    cfg = tiny_mlp(pc)
    ds = tiny_dataset(port_data, 128, 64)
    model = pm.QuantNet(cfg)
    before = [t.data_ptr() for t in itertools.chain(model.parameters(),
                                                    model.buffers())]
    v = pm.QuantNet(cfg, generator=torch.Generator().manual_seed(5)) \
        .variables()
    model.load_variables(v["params"], v["batch_stats"])
    assert [t.data_ptr() for t in itertools.chain(
        model.parameters(), model.buffers())] == before
    path = str(tmp_path / "ck.npz")
    pt.save_checkpoint(path, v["params"], v["batch_stats"])

    made = []
    real = pt.make_epoch_fn

    def recording(*a, **kw):
        epoch = real(*a, **kw)
        made.append((epoch.step, epoch.step._addresses()))
        return epoch

    monkeypatch.setattr(pt, "make_epoch_fn", recording)
    r = pt.train(cfg, ds, epochs=2, batch_size=32, resume_from=path,
                 device="cpu")
    (step, addresses), = made
    assert step.model is r.model and step._addresses() == addresses
    assert step.tx.count == 2 * (128 // 32)


# -- train() -------------------------------------------------------------------

@pytest.mark.parametrize("wbits,abits", [(1, 1), (2, 2)])
def test_train_learns_and_compiles(wbits, abits):
    """JAX's test on the port: learns tiny_dataset; the integer engine
    (runtime="ref") reproduces the float model's accuracy exactly."""
    cfg = tiny_mlp(pc, wbits, abits)
    ds = tiny_dataset(port_data)
    result = pt.train(cfg, ds, epochs=6, batch_size=64, lr_start=5e-3,
                      lr_end=1e-4, seed=0, device="cpu")
    assert result.best_val_acc > 0.8, result.history
    assert result.history[-1]["loss"] < result.history[0]["loss"]
    assert all(len(h["losses"]) == 512 // 64 for h in result.history)
    model = pm.QuantNet(cfg)
    float_acc = pt.evaluate(cfg, model, result.params, result.batch_stats,
                            port_data.to_bipolar(ds.x_test), ds.y_test)
    assert float_acc == result.best_val_acc
    engine = InferenceEngine.from_training(
        cfg, result.params, result.batch_stats, device="cpu", runtime="ref")
    int_acc = (engine.classify(ds.x_test) == ds.y_test).mean()
    assert abs(float_acc - int_acc) <= 1e-9


def test_train_is_deterministic_and_clips(tmp_path):
    cfg = tiny_mlp(pc)
    ds = tiny_dataset(port_data, 128, 64)
    kw = dict(epochs=2, batch_size=64, lr_start=0.1, seed=3, device="cpu")
    a = pt.train(cfg, ds, **kw)
    b = pt.train(cfg, ds, **kw)
    for kind in ("params", "batch_stats"):
        fa = traverse_util.flatten_dict(getattr(a, kind))
        fb = traverse_util.flatten_dict(getattr(b, kind))
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k])
    for k, v in traverse_util.flatten_dict(a.params).items():
        if pt._is_quant_kernel(k):
            assert np.abs(v).max() <= 1.0
    assert all(p.device.type == "cpu" for p in a.model.parameters())


def test_train_max_train_and_small_sets():
    cfg = tiny_mlp(pc)
    ds = tiny_dataset(port_data, 128, 64)
    r = pt.train(cfg, ds, epochs=1, batch_size=16, max_train=40,
                 device="cpu")
    assert len(r.history[0]["losses"]) == 2          # 40 // 16
    r = pt.train(cfg, ds, epochs=1, batch_size=1000, device="cpu")
    assert len(r.history[0]["losses"]) == 1          # clamped to 128


def test_cuda_is_the_default_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_mlp(pc)
    ds = tiny_dataset(port_data, 64, 32)
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.train(cfg, ds, epochs=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.train(cfg, ds, epochs=1, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["train", "sfc-w1a1", "--epochs", "1"])


def test_full_fp32_restores_the_flags():
    conv = torch.backends.cudnn.allow_tf32
    mm = torch.backends.cuda.matmul.allow_tf32
    with pm.full_fp32():
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cudnn.allow_tf32 == conv
    assert torch.backends.cuda.matmul.allow_tf32 == mm


# -- checkpoints and artifacts across the two packages -------------------------

def _flat_equal(a, b):
    fa, fb = traverse_util.flatten_dict(dict(a)), traverse_util.flatten_dict(
        dict(b))
    assert set(fa) == set(fb)
    for k in fa:
        assert np.asarray(fa[k]).tobytes() == np.asarray(fb[k]).tobytes(), k


def test_checkpoints_load_in_both_packages(tmp_path):
    cfg = tiny_mlp(pc)
    r = pt.train(cfg, tiny_dataset(port_data, 128, 64), epochs=1,
                 batch_size=64, device="cpu",
                 checkpoint_path=str(tmp_path / "port.npz"))
    meta = {"epoch": 0, "config": cfg.name, "val_acc": r.best_val_acc}
    # the port's file in JAX, with JAX's keys
    p, s, m = jt.load_checkpoint(str(tmp_path / "port.npz"))
    _flat_equal(p, r.params)
    _flat_equal(s, r.batch_stats)
    assert str(m["config"]) == cfg.name and int(m["epoch"]) == 0
    with np.load(str(tmp_path / "port.npz")) as z:
        assert "params/quant_0/kernel" in z.files
        assert "batch_stats/bn_0/mean" in z.files
    # JAX's file in the port, and written the same
    jt.save_checkpoint(str(tmp_path / "jax.npz"), r.params, r.batch_stats,
                       meta=meta)
    pt.save_checkpoint(str(tmp_path / "port2.npz"), r.params,
                       r.batch_stats, meta=meta)
    p2, s2, m2 = pt.load_checkpoint(str(tmp_path / "jax.npz"))
    _flat_equal(p2, r.params)
    _flat_equal(s2, r.batch_stats)
    with np.load(str(tmp_path / "jax.npz")) as zj, \
            np.load(str(tmp_path / "port2.npz")) as zp:
        assert sorted(zj.files) == sorted(zp.files)
        for k in zj.files:
            assert zj[k].tobytes() == zp[k].tobytes() and \
                zj[k].dtype == zp[k].dtype, k
    # resume from JAX's file: epochs=0 returns what was loaded
    r0 = pt.train(cfg, tiny_dataset(port_data, 64, 32), epochs=0,
                  device="cpu", resume_from=str(tmp_path / "jax.npz"))
    _flat_equal(r0.params, r.params)
    _flat_equal(r0.batch_stats, r.batch_stats)


@pytest.mark.parametrize("net,wbits,abits", [("mlp", 1, 1), ("cnv", 2, 2)])
def test_port_training_compiles_to_jax_bytes(tmp_path, net, wbits, abits):
    """A port-trained network: the port's compile_network + save_artifact
    and JAX's, on the same arrays, give equal arrays byte for byte, and
    the two engines equal logits."""
    pcfg, jcfg = NETS[net](pc, wbits, abits), NETS[net](jc, wbits, abits)
    rng = np.random.default_rng(12)
    shape = (96,) + pcfg.input_shape
    ds = port_data.Dataset("cifar10", rng.integers(0, 256, shape, np.uint8),
                           rng.integers(0, 4, 96).astype(np.int32),
                           rng.integers(0, 256, shape, np.uint8)[:32],
                           rng.integers(0, 4, 32).astype(np.int32), True)
    r = pt.train(pcfg, ds, epochs=2, batch_size=32, device="cpu")
    got = port_fin.compile_network(pcfg, r.params, r.batch_stats)
    want = jax_fin.compile_network(jcfg, r.params, r.batch_stats)
    port_art.save_artifact(str(tmp_path / "p.npz"), got)
    jax_art.save_artifact(str(tmp_path / "j.npz"), want)
    with np.load(str(tmp_path / "p.npz")) as zp, \
            np.load(str(tmp_path / "j.npz")) as zj:
        assert sorted(zp.files) == sorted(zj.files)
        for k in zj.files:
            assert zp[k].tobytes() == zj[k].tobytes(), k
    x = ds.x_test[:16]
    np.testing.assert_allclose(
        InferenceEngine(got, device="cpu").logits(x),
        JaxEngine(want, runtime="ref").logits(x), rtol=1e-5, atol=1e-5)


def test_jax_checkpoint_serves_equal_logits_in_the_port(tmp_path):
    jcfg, pcfg = tiny_cnv(jc), tiny_cnv(pc)
    rng = np.random.default_rng(13)
    x = rng.integers(0, 256, (64, 8, 8, 3), np.uint8)
    ds = jax_data.Dataset("cifar10", x, rng.integers(0, 4, 64)
                          .astype(np.int32), x[:16],
                          rng.integers(0, 4, 16).astype(np.int32), True)
    r = jt.train(jcfg, ds, epochs=1, batch_size=32, seed=0)
    path = str(tmp_path / "jax.npz")
    jt.save_checkpoint(path, r.params, r.batch_stats, meta={"epoch": 0})
    params, stats, _ = pt.load_checkpoint(path)
    port = InferenceEngine.from_training(pcfg, params, stats, device="cpu")
    jeng = JaxEngine.from_training(jcfg, r.params, r.batch_stats,
                                   runtime="ref")
    got, want = port.logits(ds.x_test), jeng.logits(ds.x_test)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (got.argmax(1) == want.argmax(1)).all()
    # the float models agree on the loaded checkpoint too
    pmodel = pm.QuantNet(pcfg)
    pmodel.load_variables(params, stats)
    xf = port_data.train_inputs("cifar10", ds.x_test, "int8")
    want_f = jm.QuantNet(jcfg).apply(
        {"params": r.params, "batch_stats": r.batch_stats}, xf)
    np.testing.assert_allclose(pmodel(torch.from_numpy(xf)).detach()
                               .numpy(), np.asarray(want_f), **LOGIT_TOL)


# -- the CLI -------------------------------------------------------------------

def _help(main, argv, capsys):
    with pytest.raises(SystemExit):
        main(argv + ["--help"])
    return capsys.readouterr().out


@pytest.mark.parametrize("cmd", ["train", "compile", "ingest", "gate-all"])
def test_cli_has_the_jax_flags(cmd, capsys):
    from bnn_pynq_tpu import cli as jax_cli
    import re
    flags = re.compile(r"(--[a-z-]+)")
    want = set(flags.findall(_help(jax_cli.main, [cmd], capsys)))
    got = set(flags.findall(_help(cli.main, [cmd], capsys)))
    assert want <= got, want - got
    if cmd in ("train", "gate-all"):
        assert "--device" in got
    assert cli.GATE_WORKLOADS == jax_cli.GATE_WORKLOADS


def test_cli_train_compile_classify(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("BNN_DATA_DIR", str(tmp_path / "nodata"))
    out_dir = str(tmp_path / "artifacts")
    cli.main(["train", "sfc-w1a1", "--epochs", "1", "--batch-size", "256",
              "--out", out_dir, "--device", "cpu"])
    assert "artifact:" in capsys.readouterr().out
    artifact = os.path.join(out_dir, "sfc-w1a1.npz")
    ckpt = os.path.join(out_dir, "sfc-w1a1-checkpoint.npz")
    cli.main(["compile", ckpt, "--out", str(tmp_path / "c2.npz")])
    assert "artifact:" in capsys.readouterr().out
    a, b = port_art.load_artifact(artifact), \
        port_art.load_artifact(str(tmp_path / "c2.npz"))
    for la, lb in zip(a.layers, b.layers):
        for k in la:
            assert la[k].tobytes() == lb[k].tobytes()
    # the JAX package takes the port's files
    jax_art.load_artifact(artifact)
    jt.load_checkpoint(ckpt)
    imgs = np.random.default_rng(0).integers(
        0, 256, size=(3, 28, 28, 1)).astype(np.uint8)
    np.save(str(tmp_path / "imgs.npy"), imgs)
    cli.main(["classify", artifact, str(tmp_path / "imgs.npy"),
              "--device", "cpu"])
    out = capsys.readouterr().out
    want = InferenceEngine(a, device="cpu").classify(imgs)
    for i, p in enumerate(want):
        assert f"{i}: {int(p)} " in out
    assert "usecPerImage" in out


def test_cli_gate_all_skips_without_data(tmp_path, capsys, monkeypatch):
    import json
    monkeypatch.setenv("BNN_DATA_DIR", str(tmp_path / "empty"))
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    cli.main(["gate-all", "--artifacts", str(tmp_path / "arts"),
              "--device", "cpu"])
    lines = [json.loads(line) for line in
             capsys.readouterr().out.strip().splitlines()]
    assert lines[-1] == {"summary": "skipped x10", "failed": False}
    assert all("skipped" in r["gate"] for r in lines[:-1])


def test_cli_gate_all_trains_on_real_data(tmp_path, capsys, monkeypatch):
    """With raw MNIST files present, `gate-all --train` ingests them,
    trains the three MNIST rows on the CPU, compiles, evaluates and gates
    (a model trained on 12 images fails the baseline: exit 1); the other
    rows stay skipped."""
    import json
    from test_datasets_raw import _write_idx
    rng = np.random.default_rng(15)
    for name, shape in (("train-images-idx3-ubyte", (12, 28, 28)),
                        ("train-labels-idx1-ubyte", (12,)),
                        ("t10k-images-idx3-ubyte", (5, 28, 28)),
                        ("t10k-labels-idx1-ubyte", (5,))):
        high = 256 if len(shape) == 3 else 10
        _write_idx(tmp_path / name, rng.integers(0, high, shape)
                   .astype(np.uint8))
    monkeypatch.setenv("BNN_DATA_DIR", str(tmp_path))
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as exit_info:
        cli.main(["gate-all", "--artifacts", str(tmp_path / "arts"),
                  "--train", "--epochs", "1", "--device", "cpu"])
    assert exit_info.value.code == 1
    rows = [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]
    mnist = [r for r in rows[:-1] if r["dataset"] == "mnist"]
    assert [r["network"] for r in mnist] == ["sfc-w1a1", "lfc-w1a1",
                                             "lfc-w1a2"]
    for r in mnist:
        assert "trained" in r and r["n_test"] == 5, r
        assert r["gate"] == "FAILED" and "error" not in r, r
        assert os.path.exists(tmp_path / "arts" / f"{r['network']}.npz")
    assert all("skipped" in r["gate"] for r in rows[:-1]
               if r["dataset"] != "mnist")
    assert rows[-1] == {"summary": "skipped x7", "failed": True}
