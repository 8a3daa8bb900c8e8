"""The plain reference against the port's own reference runtime, and the
benchmark's frozen arithmetic."""

import json
import os

import numpy as np
import pytest
import torch

from portbench import yardstick
from portbench.reference import bnn, judge

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIGS = os.path.join(os.path.dirname(HERE), "configs")


def _config(name):
    with open(os.path.join(CONFIGS, f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", ["cnv-w1a1", "lfc-w1a1"])
@pytest.mark.parametrize("kind", ["uint8", "int8"])
def test_reference_equals_port_ref_runtime(name, kind):
    """Logits bit for bit, at a small batch on the CPU, from uint8 images
    and from int8 frames (what the resident cell feeds)."""
    from bnn_pynq_tpu_torch.runtime.engine import InferenceEngine
    path = os.path.join(CONFIGS, f"{name}.npz")
    net = bnn.load(path)
    rng = np.random.default_rng(7)
    if kind == "uint8":
        x = rng.integers(0, 256, (12,) + net.input_shape, dtype=np.uint8)
    else:
        x = rng.integers(-128, 128, (12,) + net.input_shape,
                         dtype=np.int8)
    ours = bnn.logits(net, bnn.accumulators(net, torch.from_numpy(x),
                                            block=5)).numpy()
    eng = InferenceEngine.from_artifact(path, device="cpu", runtime="ref")
    theirs = eng.logits(x, prepared=(kind == "int8"))
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("name", ["cnv-w1a1", "lfc-w1a1"])
def test_config_file_states_the_artifact(name):
    cfg = _config(name)
    net = bnn.load(os.path.join(os.path.dirname(CONFIGS), "..",
                                cfg["artifact"]))
    assert (net.wbits, net.abits, net.input_kind, list(net.input_shape),
            net.num_classes) == (cfg["wbits"], cfg["abits"],
                                 cfg["input_kind"], cfg["input_shape"],
                                 cfg["num_classes"])
    assert cfg["reduced"] == []


def test_frozen_macs():
    assert yardstick.network_macs(_config("cnv-w1a1")) == 59_461_376
    assert yardstick.network_macs(_config("lfc-w1a1")) == \
        784 * 1024 + 2 * 1024 * 1024 + 1024 * 10


def test_conv_chain_bound():
    """conv0-1 and conv3-4 of CNV at batch 1024: 0.05777 ms by operations
    at the int8 peak."""
    ms = yardstick.conv_chain_bound_ms(_config("cnv-w1a1"), 1024, 0, 4)
    assert ms == pytest.approx(2 * 1024 * 55_819_008 / 1979e12 * 1e3)
    assert round(ms, 5) == 0.05777


def test_percentile_nearest_rank():
    v = np.arange(1, 101, dtype=float)
    assert yardstick.percentile(v, 99) == 99.0
    assert yardstick.percentile(v, 100) == 100.0
    assert yardstick.percentile([5.0], 99) == 5.0


def test_gaps():
    ref = np.array([[0.0, 2.0, 1.0], [3.0, 3.0, 0.0]], np.float32)
    g = judge.gaps(ref, np.array([0, 0, 1, 1, 0]),
                   np.array([1, 2, 1, 0, 7]))
    np.testing.assert_array_equal(g, [0.0, 1.0, 0.0, 0.0, np.inf])
    assert judge.widest_gap(ref, [(np.array([0, 0]), np.array([2, 5]))]) \
        == (1.0, 1)
