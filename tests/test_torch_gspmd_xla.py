"""The int8 products JAX leaves to XLA, on the port's int8 GEMM, and
make_gspmd_engine on JAX's decoded-integer layers, on the CPU, held
against the JAX package.

- The packed routes ('vpu', 'mxu', 'mxu_rm') and 'direct': CNV's 8-bit
  first conv (and on 'direct' every dense layer) runs
  `ops/int_dot.py::int_matmul`, where JAX runs XLA's int8 dot:
  `library_calls()` shows one `int_mm` a product and no `int_matmul_ref`
  outside the kernels' plain versions (which the CPU runs in place of
  the kernels, and which stay the oracles they are); the
  int32 accumulators equal JAX's `forward` / `forward_direct`, the
  logits JAX's within rtol=atol=1e-5 (tests/test_golden_fixtures.py:36),
  at batch 1 and 5.
- TPInferenceEngine ('vpu', 'mxu') and OverlapTPEngine (ring, blocking)
  on meshes (1, 2), (2, 1) and (2, 2): the same counts in every rank
  (the first conv of the one, the dense layers, ring partials and
  row-sharded last layer of the other), the logits JAX's; the mini CNV's
  first conv is 20 wide, a 10-wide column shard on a model axis of 2.
- make_gspmd_engine on the mini CNV and a mini LFC whose hidden widths
  are 48, 10 (a 5-wide column shard) and 45 (no multiple of 2:
  replicated), W1A1 and W2A2: every rank's decoded shards equal the
  blocks of JAX's own sharded arrays on the device at the rank's mesh
  position (the last layer whole), K-contiguous; the gathered logits
  JAX's make_gspmd_engine's on the CPU mesh, argmax equal; the int32
  accumulators (unit scale, zero bias) JAX's `forward_xla`'s exactly;
  one `int_mm` a conv or dense layer, no kernel launch, no
  `int_matmul_ref`, one all-gather a column-sharded layer.

`int_matmul` raises on any operand that is not int8, so every call site
above handing it int8 (image levels, `codes_to_values`, ±1 input) is
checked by the forwards running. The ranks run this file's module-level
job functions and import torch and the port only; JAX runs in the pytest
process. What only a card shows (cuBLASLt inside the graphs under NCCL)
is `chip_smoke.py` phases 8, 12, 17, 20 and 21.
"""

import collections

import numpy as np
import pytest
import torch

from bnn_pynq_tpu_torch.compiler.artifacts import CompiledNetwork
from bnn_pynq_tpu_torch.models import config as pc
from bnn_pynq_tpu_torch.models import network as port_net
from bnn_pynq_tpu_torch.models.params import params_from_numpy
from bnn_pynq_tpu_torch.ops import (conv_direct, conv_stack, fused_mlp,
                                    int_dot, matmul)
from bnn_pynq_tpu_torch.ops.conv import conv_weight_matrix
from bnn_pynq_tpu_torch.parallel import comm
from bnn_pynq_tpu_torch.parallel.overlap import (OverlapTPEngine,
                                                 shard_overlap_params)
from bnn_pynq_tpu_torch.parallel.tp import (TPInferenceEngine,
                                            make_gspmd_engine, shard_params)
from bnn_pynq_tpu_torch.runtime.engine import (InferenceEngine, _moved,
                                               kernel_launches,
                                               library_calls)
from tests.test_torch_parallel import TOL, jax_mesh, run_jobs

MESHES = [(1, 2), (2, 1), (2, 2)]
NETS = [("cnv", 1, 1), ("cnv", 2, 2), ("lfc", 1, 1), ("lfc", 2, 2)]
# (engine, wbits, abits): 'vpu' is W1A1 only
ENGINES = [("tp-vpu", 1, 1), ("tp-mxu", 2, 2), ("ring", 1, 1),
           ("ring", 2, 2), ("blocking", 1, 1), ("blocking", 2, 2)]
BATCHES = (5, 1)
BUCKETS = (1, 8)
# the kernels' plain versions, which the CPU runs in place of the kernels
PLAINS = ((matmul, "packed_matmul_plain"),
          (conv_direct, "conv2d_direct_plain"),
          (conv_direct, "conv_chain_direct_plain"),
          (conv_stack, "conv_chain_plain"),
          (conv_stack, "dense_block_plain"),
          (fused_mlp, "fused_mlp_forward_plain"))


def _config(mod, kind, wbits, abits):
    """The mini CNV (tests/test_finnthesizer.py's, its first conv 20
    wide) or a mini LFC of odd hidden widths, in `mod`'s classes."""
    if kind == "cnv":
        return mod.NetworkConfig(
            name=f"cnv-mini-w{wbits}a{abits}", wbits=wbits, abits=abits,
            input_kind="int8", input_shape=(10, 10, 3),
            layers=(mod.ConvSpec(20), mod.PoolSpec(), mod.ConvSpec(32),
                    mod.DenseSpec(24), mod.DenseSpec(10)),
            num_classes=10, dataset="cifar10")
    return mod.NetworkConfig(
        name=f"lfc-mini-w{wbits}a{abits}", wbits=wbits, abits=abits,
        input_kind="bipolar", input_shape=(12, 12, 1),
        layers=tuple(mod.DenseSpec(n) for n in (48, 10, 45, 10)),
        num_classes=10, dataset="mnist")


def _pair(kind, wbits, abits, seed=0, unit=False):
    """(JAX, port) CompiledNetwork of JAX's `init_random_params` with a
    seeded scale and bias (unit scale and zero bias with `unit`)."""
    from bnn_pynq_tpu.compiler.finnthesizer import \
        CompiledNetwork as JaxCompiled
    from bnn_pynq_tpu.models import config as jc
    from bnn_pynq_tpu.models.network import init_random_params
    jcfg = _config(jc, kind, wbits, abits)
    layers = [{k: np.asarray(v) for k, v in p.items()}
              for p in init_random_params(jcfg, seed=seed)]
    rng = np.random.default_rng(seed)
    scale = rng.uniform(0.01, 1.0, size=10).astype(np.float32)
    bias = rng.standard_normal(10).astype(np.float32)
    if unit:
        scale, bias = np.ones(10, np.float32), np.zeros(10, np.float32)
    return (JaxCompiled(jcfg, layers, scale, bias),
            CompiledNetwork(_config(pc, kind, wbits, abits), layers, scale,
                            bias))


def _inputs(cfg, batch, seed):
    """Seeded prepared input: ±1 for bipolar nets, int8 levels else."""
    rng = np.random.default_rng(seed)
    if cfg.input_kind == "bipolar":
        return rng.choice([-1, 1], size=(
            batch, int(np.prod(cfg.input_shape)))).astype(np.int8)
    return rng.integers(-128, 128, size=(batch,) + tuple(cfg.input_shape)
                        ).astype(np.int8)


def glue_calls(fn):
    """fn() with the library calls counted: returns (its result, the
    `library_calls()` it moved outside the kernels' plain versions, the
    `kernel_launches()` it moved)."""
    inside = collections.Counter()
    saved = [(mod, name, getattr(mod, name)) for mod, name in PLAINS]

    def counted(plain):
        def run(*a, **kw):
            before = library_calls()
            try:
                return plain(*a, **kw)
            finally:
                inside.update(_moved(before, library_calls()))
        return run

    for mod, name, plain in saved:
        setattr(mod, name, counted(plain))
    try:
        before, launched = library_calls(), kernel_launches()
        out = fn()
        moved = collections.Counter(_moved(before, library_calls()))
        moved.subtract(inside)
        return (out, {k: n for k, n in moved.items() if n},
                _moved(launched, kernel_launches()))
    finally:
        for mod, name, plain in saved:
            setattr(mod, name, plain)


def _padded(x, d):
    """x with zero rows up to a multiple of d, as the engine pads it."""
    return np.concatenate([x, np.zeros(((-len(x)) % d,) + x.shape[1:],
                                       x.dtype)])


def _products(config, route):
    """The int_mm calls of one forward on a single-card route: the 8-bit
    first conv, and on 'direct' every dense layer too."""
    kinds = [lp.kind for lp in port_net.make_plan(config)]
    return kinds.count("conv_int8") + \
        (kinds.count("dense") if route == "direct" else 0)


# -- job functions (they run in the ranks) -------------------------------

def job_gspmd(mesh, compiled, unit, xs):
    """make_gspmd_engine on one net: this rank's shards (and whether each
    weight is K-contiguous), the logits of each batch, the unit-scale
    engine's logits (its int32 accumulators as float32), and what one
    eager forward of this rank's rows called."""
    eng = make_gspmd_engine(compiled, mesh)
    shards = [{k: v.numpy() for k, v in p.items()} for p in eng.params]
    layout = [conv_weight_matrix(v).t().is_contiguous() if k == "w_hwio"
              else v.t().is_contiguous()
              for p in eng.params for k, v in p.items() if k != "thr"]
    out = {"shards": shards, "k_contiguous": layout,
           "logits": [eng(x) for x in xs],
           "acc": [make_gspmd_engine(unit, mesh)(x) for x in xs]}
    x = _padded(xs[0], mesh.shape["data"])
    rows = len(x) // mesh.shape["data"]
    xl = torch.from_numpy(x[mesh.coords[0] * rows:][:rows])
    comm.reset_counts()
    _, out["library"], out["launched"] = glue_calls(lambda: eng.forward(xl))
    out["gathers"] = comm.counts()["all_gather"]
    return out


def _parallel_engine(name, compiled, mesh):
    if name.startswith("tp-"):
        return TPInferenceEngine(compiled, mesh, route=name[3:],
                                 batch_buckets=BUCKETS)
    return OverlapTPEngine(compiled, mesh, arm=name, batch_buckets=BUCKETS)


def job_parallel(mesh, name, compiled, xs):
    """One parallel engine's eager forward of each batch: its logits, the
    library calls outside the plain versions."""
    eng = _parallel_engine(name, compiled, mesh)
    out = []
    for x in xs:
        xd = eng.upload(eng._pad_to_bucket(x)[0])
        logits, lib, _ = glue_calls(lambda: eng._eager(
            eng._state.params, eng._rows(xd), False, False))
        out.append({"logits": logits.numpy()[:len(x)], "library": lib,
                    "rows": eng._rows(xd).shape[0]})
    return out


# -- the worlds ------------------------------------------------------------

@pytest.fixture(scope="module")
def worlds():
    """One world a mesh: make_gspmd_engine on every net, and every
    parallel engine on the mini CNV."""
    out = {}
    for data, model in MESHES:
        jobs = []
        for net in NETS:
            _, pcomp = _pair(*net)
            xs = [_inputs(pcomp.config, b, 3) for b in BATCHES]
            jobs.append((f"gspmd{net}", job_gspmd,
                         (pcomp, _pair(*net, unit=True)[1], xs)))
        for name, wb, ab in ENGINES:
            _, pcomp = _pair("cnv", wb, ab, seed=1)
            xs = [_inputs(pcomp.config, b, 4) for b in BATCHES]
            jobs.append((f"{name}{wb}{ab}", job_parallel,
                         (name, pcomp, xs)))
        out[(data, model)] = run_jobs(data, model, jobs)
    return out


def _jax_decoded(jcomp):
    import jax.numpy as jnp
    from bnn_pynq_tpu.models.network import decode_params
    return decode_params(jcomp.config, [{k: jnp.asarray(v) for k, v in
                                         p.items()} for p in jcomp.layers])


def _jax_logits(jcomp, x):
    """JAX's single-device result on the decoded-integer route: int32
    accumulators of forward_xla, then scale and bias in float32."""
    import jax.numpy as jnp
    from bnn_pynq_tpu.models.network import forward_xla
    acc = np.asarray(forward_xla(jcomp.config, _jax_decoded(jcomp),
                                 jnp.asarray(x)))
    return acc, acc.astype(np.float32) * np.asarray(jcomp.out_scale) + \
        np.asarray(jcomp.out_bias)


def _jax_gspmd(jcomp, data, model):
    """JAX's make_gspmd_engine on the CPU mesh, and its sharded decoded
    arrays (the engine's own, from its closure)."""
    from bnn_pynq_tpu.parallel.tp import make_gspmd_engine as jax_gspmd
    mesh = jax_mesh(data, model)
    fn = jax_gspmd(jcomp, mesh)
    cells = dict(zip(fn.__code__.co_freevars,
                     (c.cell_contents for c in fn.__closure__)))
    return fn, cells["sharded"], mesh


# -- make_gspmd_engine -------------------------------------------------------

@pytest.mark.parametrize("net", NETS, ids=lambda n: f"{n[0]}-w{n[1]}a{n[2]}")
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_gspmd_shards_are_jax_slices(mesh, net, worlds):
    """Every rank's decoded shards equal the block of JAX's sharded array
    on the device at the rank's mesh position, array for array: N/m
    columns where the layer is not the last and N divides, else the whole
    array (the last layer; the LFC's 45-wide layer on m = 2); every
    weight stored K-contiguous after the cut."""
    jcomp, _ = _pair(*net)
    _, sharded, jmesh = _jax_gspmd(jcomp, *mesh)
    m = mesh[1]
    plan = port_net.make_plan(_config(pc, *net))
    for rank, res in enumerate(worlds[mesh]):
        got = res[f"gspmd{net}"]
        device = jmesh.devices[rank // m, rank % m]
        assert all(got["k_contiguous"]), rank
        assert len(got["shards"]) == len(sharded)
        for lp, g, want in zip(plan, got["shards"], sharded):
            assert set(g) == set(want)
            for k, arr in want.items():
                block, = [np.asarray(s.data) for s in arr.addressable_shards
                          if s.device == device]
                np.testing.assert_array_equal(g[k], block,
                                              err_msg=f"rank {rank} {k}")
                whole = lp.last or m == 1 or arr.shape[-1] % m
                assert g[k].shape == (arr.shape if whole else
                                      arr.shape[:-1] + (arr.shape[-1] // m,))


@pytest.mark.parametrize("net", NETS, ids=lambda n: f"{n[0]}-w{n[1]}a{n[2]}")
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_gspmd_logits_equal_jax(mesh, net, worlds):
    """At batch 5 and 1: the gathered logits JAX's make_gspmd_engine's on
    the same mesh within rtol=atol=1e-5, argmax equal, on every rank;
    the unit-scale engine's logits JAX's forward_xla accumulators
    exactly."""
    jcomp, pcomp = _pair(*net)
    junit, _ = _pair(*net, unit=True)
    fn, _, _ = _jax_gspmd(jcomp, *mesh)
    for i, b in enumerate(BATCHES):
        x = _inputs(pcomp.config, b, 3)
        want = np.asarray(fn(_padded(x, mesh[0])))[:b]
        acc, single = _jax_logits(jcomp, x)
        np.testing.assert_allclose(want, single, **TOL)
        want_acc, _ = _jax_logits(junit, x)
        for rank, res in enumerate(worlds[mesh]):
            got = res[f"gspmd{net}"]
            np.testing.assert_allclose(got["logits"][i], want, **TOL,
                                       err_msg=f"rank {rank} batch {b}")
            assert (got["logits"][i].argmax(1) == want.argmax(1)).all()
            assert np.array_equal(got["acc"][i],
                                  want_acc.astype(np.float32)), (rank, b)


@pytest.mark.parametrize("net", NETS, ids=lambda n: f"{n[0]}-w{n[1]}a{n[2]}")
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_gspmd_calls_the_library_only(mesh, net, worlds):
    """One eager forward: one int_mm a conv or dense layer and nothing
    else (no int_matmul_ref, no cuDNN conv, no kernel launch), one
    all-gather of the codes a column-sharded layer."""
    cfg = _config(pc, *net)
    plan = port_net.make_plan(cfg)
    compute = [lp for lp in plan if lp.kind != "pool"]
    m = mesh[1]
    cut = sum(1 for lp in compute
              if m > 1 and not lp.last and lp.n % m == 0)
    for res in worlds[mesh]:
        got = res[f"gspmd{net}"]
        assert got["library"] == {"int_mm": len(compute)}, got["library"]
        assert got["launched"] == {}
        assert got["gathers"] == cut


# -- the parallel engines' int8 products -------------------------------------

def _engine_products(name, config, m):
    """int_mm calls of one forward: TPInferenceEngine's first conv;
    OverlapTPEngine's dense layers (m ring partials for the first dense
    after the convs on a ring of m > 1) and its row-sharded last one."""
    if name.startswith("tp-"):
        return _products(config, "vpu")
    dense = [lp for lp in port_net.make_plan(config) if lp.kind == "dense"]
    ring = name == "ring" and m > 1
    return sum(m if ring and not lp.last else 1 for lp in dense)


@pytest.mark.parametrize("engine", ENGINES,
                         ids=lambda e: f"{e[0]}-w{e[1]}a{e[2]}")
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_parallel_engines_call_int_mm(mesh, engine, worlds):
    """At batch 5 and 1 (one row a rank on 'data' = 2): the int8 products
    JAX leaves to XLA are int_mm calls, none int_matmul_ref, on every
    rank; the logits JAX's within rtol=atol=1e-5, argmax equal."""
    name, wb, ab = engine
    jcomp, pcomp = _pair("cnv", wb, ab, seed=1)
    want_calls = {"int_mm": _engine_products(name, pcomp.config, mesh[1])}
    for i, b in enumerate(BATCHES):
        _, want = _jax_logits(jcomp, _inputs(pcomp.config, b, 4))
        for rank, res in enumerate(worlds[mesh]):
            got = res[f"{name}{wb}{ab}"][i]
            assert got["library"] == want_calls, (rank, b, got["library"])
            np.testing.assert_allclose(got["logits"], want, **TOL,
                                       err_msg=f"rank {rank} batch {b}")
            assert (got["logits"].argmax(1) == want.argmax(1)).all()
    assert [r[f"{name}{wb}{ab}"][1]["rows"] for r in worlds[mesh]] == \
        [1] * (mesh[0] * mesh[1])


# -- the single-card routes --------------------------------------------------

ROUTE_CASES = [(route, kind, wb, ab)
               for route in ("direct", "vpu", "mxu", "mxu_rm")
               for kind in ("cnv", "lfc")
               for wb, ab in ((1, 1), (2, 2))
               if route != "vpu" or wb == 1]


@pytest.mark.parametrize("case", ROUTE_CASES, ids=lambda c: "-".join(
    [c[0], c[1], f"w{c[2]}a{c[3]}"]))
def test_routes_call_int_mm_and_equal_jax(case):
    """At batch 5 and 1: the route's int32 accumulators equal JAX's
    forward (the packed routes, Pallas in interpret mode) or
    forward_direct exactly, its engine's logits JAX's within
    rtol=atol=1e-5 with argmax equal; one forward calls int_mm for the
    8-bit first conv (and on 'direct' each dense layer) and no
    int_matmul_ref outside the kernels' plain versions."""
    import jax.numpy as jnp
    from bnn_pynq_tpu.models import network as jax_net
    route, kind, wb, ab = case
    jcomp, pcomp = _pair(kind, wb, ab, seed=2)
    cfg = pcomp.config
    eng = InferenceEngine(pcomp, device="cpu", route=route,
                          batch_buckets=BUCKETS)
    jlayers = [{k: jnp.asarray(v) for k, v in p.items()}
               for p in jcomp.layers]
    for b in BATCHES:
        x = _inputs(cfg, b, 5)
        xd = torch.from_numpy(x)
        if route == "direct":
            want = jax_net.forward_direct(jcomp.config, _jax_decoded(jcomp),
                                          jnp.asarray(x), interpret=True)
            fwd = port_net.forward_direct
        else:
            want = jax_net.forward(jcomp.config, jlayers, jnp.asarray(x),
                                   impl="pallas", route=route,
                                   interpret=True)
            fwd = port_net.make_forward_fn(cfg, route=route)
        layers = eng._state.params[0]
        acc, lib, _ = glue_calls(lambda: fwd(cfg, layers, xd)
                                 if route == "direct" else fwd(layers, xd))
        assert acc.dtype == torch.int32
        np.testing.assert_array_equal(acc.numpy(), np.asarray(want))
        n = _products(cfg, route)
        assert lib == ({"int_mm": n} if n else {}), lib
        _, lib, _ = glue_calls(lambda: eng.logits(x, prepared=True))
        assert lib == ({"int_mm": n} if n else {}), lib
        logits = eng.logits(x, prepared=True)
        want_logits = np.asarray(want).astype(np.float32) * \
            pcomp.out_scale + pcomp.out_bias
        np.testing.assert_allclose(logits, want_logits, **TOL)
        assert (logits.argmax(1) == want_logits.argmax(1)).all()


def test_ref_runtime_keeps_int_matmul_ref():
    """runtime='ref' on the direct route still runs forward_ref's float64
    product, one int_matmul_ref a conv or dense layer, no int_mm."""
    _, pcomp = _pair("cnv", 1, 1, seed=2)
    eng = InferenceEngine(pcomp, device="cpu", route="direct",
                          runtime="ref")
    _, lib, _ = glue_calls(lambda: eng.logits(
        _inputs(pcomp.config, 2, 5), prepared=True))
    assert lib == {"int_matmul_ref": 4}, lib


# -- the weights, stored K-contiguous once -----------------------------------

class SecondColumn:
    """What the sharding functions read of a mesh: rank (0, 1) of a model
    axis of 2, on the CPU."""
    shape, coords = {"data": 1, "model": 2}, (0, 1)
    device = torch.device("cpu")


def _k_contiguous(w):
    return w.dtype == torch.int8 and w.t().is_contiguous()


def test_weights_are_stored_k_contiguous_at_load():
    """params_from_numpy's `w_int8` (decode_params' weights are views of
    it) and shard_params' `w_int8` column shards: int8 [K, N]
    K-contiguous, equal to the row-major levels, so int_matmul takes them
    as they are."""
    _, pcomp = _pair("cnv", 1, 1)
    cfg = pcomp.config
    layers = params_from_numpy(cfg, pcomp.layers, pcomp.out_scale,
                               pcomp.out_bias, "cpu")[0]
    decoded = port_net.decode_params(cfg, layers)
    for p, d in zip(layers, decoded):
        assert set(p) == set() or (_k_contiguous(p["w_int8"]) and
                                   torch.equal(p["w_int8"], p["w"].kn))
        for k, w in d.items():
            if k != "thr":
                assert w.data_ptr() == p["w_int8"].data_ptr(), k

    shards = shard_params(pcomp.layers, SecondColumn, cfg)
    assert _k_contiguous(shards[0]["w_int8"])
    np.testing.assert_array_equal(shards[0]["w_int8"].numpy(),
                                  pcomp.layers[0]["w_int8"][:, 10:])


def test_overlap_dense_shards_are_k_contiguous():
    """OverlapTPEngine's dense shards, ring blocks and row-sharded last
    layer on rank (0, 1) of a model axis of 2."""
    from bnn_pynq_tpu_torch.parallel.overlap import \
        reorder_dense_rows_for_csharding
    _, pcomp = _pair("cnv", 2, 2)
    weights, _, _, _ = shard_overlap_params(pcomp, SecondColumn)
    dense, last = weights[2], weights[3]
    levels = params_from_numpy(pcomp.config, pcomp.layers, pcomp.out_scale,
                               pcomp.out_bias, "cpu")[0]
    # the conv stack leaves a 2×2 map of 32 channels: K = 128
    kn = reorder_dense_rows_for_csharding(levels[3]["w"].kn.numpy(), 4, 32,
                                          2)[:, 12:]
    assert _k_contiguous(dense.full) and len(dense.blocks) == 2 and \
        all(map(_k_contiguous, dense.blocks))
    np.testing.assert_array_equal(dense.full.numpy(), kn)
    for i, block in enumerate(dense.blocks):
        np.testing.assert_array_equal(block.numpy(), kn[i * 64:(i + 1) * 64])
    assert _k_contiguous(last.full) and last.blocks == ()
    np.testing.assert_array_equal(last.full.numpy(),
                                  levels[4]["w"].kn.numpy()[12:])


@pytest.mark.parametrize("m,k,n", [(1, 27, 5), (1, 27, 10), (3, 288, 12),
                                   (17, 32, 16)])
def test_int_matmul_pads_column_shards(m, k, n):
    """A batch-1 row, conv0's K = 27, and column shards of 5, 10 and 12
    (no multiple of 8), cut from a K-contiguous matrix as the engines cut
    them: equal to the exact product."""
    rng = np.random.default_rng(m + k + n)
    a = rng.integers(-128, 128, size=(m, k)).astype(np.int8)
    w = rng.choice([-3, -1, 1, 3], size=(k, 2 * n)).astype(np.int8)
    full = int_dot.k_contiguous(torch.from_numpy(w))
    shard = full[:, n:].clone()
    assert _k_contiguous(shard)
    got = int_dot.int_matmul(torch.from_numpy(a), shard)
    assert got.dtype == torch.int32 and got.shape == (m, n)
    np.testing.assert_array_equal(
        got.numpy(), a.astype(np.int64) @ w[:, n:].astype(np.int64))
