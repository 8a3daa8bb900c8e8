"""The port's seven Mosaic probes (`bnn_pynq_tpu_torch/ops/probes.py`) on
the CPU, held against the JAX probes of `tools/mosaic_probes.py` run in
Pallas interpret mode: outputs exactly equal, at JAX's own inputs and at
seeded random ones. The tool is loaded by path and patched on its module
object only (`pl.pallas_call` with interpret=True; for random inputs its
`jnp.ones`/`jnp.arange` return seeded numpy arrays), so the same Pallas
bodies run on the same inputs the port gets; nothing in the repository
changes.

The CUDA kernels (`csrc/mosaic_probes.cu`) run only on a card:
chip_smoke.py holds each against its plain version there."""

import ast
import functools
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnn_pynq_tpu_torch.ops import conv, probes
from bnn_pynq_tpu_torch.tools import mosaic_probes as tool

REPO = Path(__file__).resolve().parents[1]
NAMES = [f.__name__ for f in probes.PROBES]


@functools.lru_cache(maxsize=None)
def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_mosaic_probes", REPO / "tools" / "mosaic_probes.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Proxy:
    """Forwards every attribute to `base`, except those in `over`."""

    def __init__(self, base, **over):
        self._base = base
        self.__dict__.update(over)

    def __getattr__(self, name):
        return getattr(self._base, name)


class _SeededInputs:
    """Stands in for `jnp.ones` / `jnp.arange` in the JAX tool: seeded
    arrays of the requested shape and dtype (int8 over its full range,
    int32 over ±2³⁰), recorded in call order for the port."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.made = []

    def _draw(self, shape, dtype):
        dtype = np.dtype(dtype)
        if dtype == np.int8:
            a = self.rng.integers(-128, 128, size=shape).astype(np.int8)
        else:
            a = self.rng.integers(-2 ** 30, 2 ** 30, size=shape) \
                .astype(dtype)
        self.made.append(a)
        return a

    def ones(self, shape, dtype):
        return self._draw(shape, dtype)

    def arange(self, n, dtype):
        # the pool probe casts arange(n) to int8: draw int8 values so the
        # cast keeps them, and hand the port the int8 array it sees
        a = self.rng.integers(-128, 128, size=n).astype(np.int8)
        self.made.append(a)
        return a.astype(dtype)


def _run_jax(monkeypatch, name, seeded=None):
    mod = _jax_tool()
    pl = mod.pl
    monkeypatch.setattr(mod, "pl", _Proxy(pl, pallas_call=functools.partial(
        pl.pallas_call, interpret=True)))
    if seeded is not None:
        monkeypatch.setattr(mod, "jnp", _Proxy(
            jnp, ones=seeded.ones, arange=seeded.arange))
    return np.asarray(getattr(mod, name)())


def _port_inputs(name, made):
    """The port probe's keyword inputs from the arrays the JAX probe
    drew."""
    t = [torch.from_numpy(a) for a in made]
    if name == "probe_pool_reshape_max":
        return dict(x=t[0].reshape(-1, probes.C))
    if name in ("probe_lane_concat", "probe_scratch_lane_store"):
        return dict(x=t[0], w=t[1])
    return dict(x=t[0])


@pytest.mark.parametrize("name", NAMES)
def test_probe_matches_jax_at_default_inputs(name, monkeypatch):
    want = _run_jax(monkeypatch, name)
    got = getattr(probes, name)(device="cpu")
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", NAMES)
def test_probe_matches_jax_at_random_inputs(name, seed, monkeypatch):
    seeded = _SeededInputs(seed)
    want = _run_jax(monkeypatch, name, seeded)
    assert seeded.made, "the JAX probe drew no inputs"
    got = getattr(probes, name)(**_port_inputs(name, seeded.made))
    np.testing.assert_array_equal(got.numpy(), want)


def test_plain_pool_equals_maxpool2d():
    x = torch.from_numpy(np.random.default_rng(3).integers(
        -128, 128, size=(4 * 16 * 16, 64)).astype(np.int8))
    want = conv.maxpool2d(x.reshape(4, 16, 16, 64), 2).reshape(-1, 64)
    assert torch.equal(probes.probe_pool_reshape_max(x), want)


def test_plain_slices_are_contiguous_copies():
    for fn, shape in ((probes.probe_mid_dim_index, (64, 64)),
                      (probes.probe_strided_row_slice, (64, 64)),
                      (probes.probe_lane_slice_64, (64, 256))):
        x = torch.ones(shape, dtype=torch.int8)
        out = fn(x)
        assert out.is_contiguous()
        out.zero_()                      # a view would write to its input
        assert bool((x == 1).all()), fn.__name__


def test_default_pool_input_wraps_like_jax():
    got = probes.pool_input(device="cpu").numpy()
    want = np.asarray(jnp.arange(1024 * 64, dtype=jnp.int32)
                      .astype(jnp.int8).reshape(1024, 64))
    np.testing.assert_array_equal(got, want)


def test_probes_reject_bad_shapes():
    with pytest.raises(ValueError):
        probes.probe_mid_dim_index(torch.ones((5, 64), dtype=torch.int8))
    with pytest.raises(ValueError):
        probes.probe_int32_acc_reshape(torch.ones((6, 64), dtype=torch.int32))
    with pytest.raises(ValueError):
        probes.probe_lane_slice_64(torch.ones((4, 100), dtype=torch.int8))
    with pytest.raises(ValueError):
        probes.probe_pool_reshape_max(torch.ones((100, 64),
                                                 dtype=torch.int8))
    with pytest.raises(ValueError):
        probes.probe_lane_concat(torch.ones((20, 64), dtype=torch.int8),
                                 m=16)
    with pytest.raises(ValueError):
        probes.probe_int32_acc_reshape(torch.ones((8, 64), dtype=torch.int8))


def test_cpu_runs_no_kernel():
    before = [f.launches.value for f in probes.PROBES]
    for f in probes.PROBES:
        f(device="cpu")
    assert [f.launches.value for f in probes.PROBES] == before


@pytest.mark.parametrize("name", NAMES)
def test_default_device_is_the_card(name, monkeypatch):
    """With no tensor and no device a probe makes its inputs on the card,
    as JAX's probes run on the default backend: with no CUDA it raises,
    naming device="cpu", and runs no plain version."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    plain = []
    monkeypatch.setattr(probes, name + "_plain",
                        lambda *a, **kw: plain.append(1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(probes, name)()
    assert not plain
    with pytest.raises(RuntimeError, match="device='cpu'"):
        probes.pool_input()


def test_tool_on_cpu_prints_seven_pass(capsys):
    assert tool.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "backend: cpu"
    assert [l.split(" ", 1)[0] for l in lines[1:]] == ["PASS"] * 7
    # JAX's labels, in JAX's order (tools/mosaic_probes.py:160-166)
    src = (REPO / "tools" / "mosaic_probes.py").read_text()
    for line, (label, _) in zip(lines[1:], tool.LABELS):
        assert line == f"PASS {label}"
        assert f'run("{label}"' in src


def test_tool_reports_a_failing_probe(capsys, monkeypatch):
    def broken(**kw):
        raise RuntimeError("no kernel\nsecond line")

    monkeypatch.setattr(tool, "LABELS",
                        (("broken", broken),) + tool.LABELS[1:])
    assert tool.main(["--device", "cpu"]) == 1
    out = capsys.readouterr().out.splitlines()
    assert out[1] == "FAIL broken: no kernel"
    assert out[2].startswith("PASS ")


def test_tool_cuda_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tool.main(["--device", "cuda"])


PORT_SOURCES = sorted(
    str(p.relative_to(REPO))
    for p in (REPO / "bnn_pynq_tpu_torch").rglob("*.py"))


@pytest.mark.parametrize("path", PORT_SOURCES)
def test_port_imports_no_jax(path):
    """No module of the port imports jax or the JAX package."""
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax",
                               "bnn_pynq_tpu"), f"{path} imports {n}"
