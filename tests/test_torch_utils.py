"""The port's utils (bnn_pynq_tpu_torch/utils/{metrics,profiling,
layerprof}.py) against the JAX package's: MAC counts equal for every
config, the H100 roofline, RunMetrics' JSON line, the timing helpers on
the CPU, and profile_layers' row contract on a mini CNV and MLP."""

import json
import time

import numpy as np
import pytest
import torch

from bnn_pynq_tpu_torch.compiler.artifacts import (CompiledNetwork,
                                                   config_from_json)
from bnn_pynq_tpu_torch.models.config import AVAILABLE_CONFIGS, get_config
from bnn_pynq_tpu_torch.models.network import init_random_params, make_plan
from bnn_pynq_tpu_torch.utils import layerprof, profiling
from bnn_pynq_tpu_torch.utils.metrics import (
    RunMetrics, chip_specs, mxu_roofline_images_per_sec, network_macs,
    roofline_fraction, vpu_bitop_roofline_images_per_sec)

JAX_ROW_KEYS = {"layer", "kind", "k", "n", "ms", "macs", "noise_ms",
                "suspect", "tops"}


def test_network_macs_cnv_exact():
    assert network_macs(get_config("cnv-w1a1")) == 59_461_376


def test_network_macs_lfc():
    assert network_macs(get_config("lfc-w1a1")) == \
        784 * 1024 + 2 * 1024 * 1024 + 1024 * 10


@pytest.mark.parametrize("name", sorted(AVAILABLE_CONFIGS))
def test_network_macs_equal_jax(name):
    from bnn_pynq_tpu.models import get_config as jax_config
    from bnn_pynq_tpu.utils.metrics import network_macs as jax_macs
    assert network_macs(get_config(name)) == jax_macs(jax_config(name))


def test_h100_roofline():
    cfg = get_config("cnv-w1a1")
    spec = chip_specs()
    assert spec == chip_specs("h100")
    assert spec.int8_ops_per_sec == 1979e12
    assert spec.hbm_bytes_per_sec == 3.35e12
    assert spec.vpu_lane_ops_per_sec == 8 * spec.int8_ops_per_sec
    sol = mxu_roofline_images_per_sec(cfg)
    assert sol == pytest.approx(1979e12 / (2 * 59_461_376))
    assert vpu_bitop_roofline_images_per_sec(cfg) == pytest.approx(8 * sol)
    assert 0 < roofline_fraction(cfg, sol / 2) <= 0.51
    with pytest.raises(ValueError, match="no spec for 'v5e'"):
        chip_specs("v5e")


def test_run_metrics_emit(tmp_path):
    m = RunMetrics("test").record(a=1.5, b=2)
    line = m.emit(str(tmp_path / "metrics.jsonl"))
    payload = json.loads(line)
    assert payload["a"] == 1.5 and payload["run"] == "test"
    assert payload["b"] == 2.0 and payload["wall_s"] >= 0
    assert (tmp_path / "metrics.jsonl").read_text() == line + "\n"


def test_steady_state_on_the_cpu():
    """A callable that sleeps 2 ms: the host clock reads at least that,
    with a half range, and one window agrees."""
    calls = []

    def launch():
        calls.append(1)
        time.sleep(0.002)
        return np.zeros(1)

    med, half = profiling.steady_state_stats(launch, iters=3, repeats=3,
                                             warmup=1)
    assert len(calls) == 1 + 3 * 3
    assert 0.002 <= med < 0.05 and 0 <= half < med
    assert 0.002 <= profiling.steady_state_time(launch, iters=2) < 0.05


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert (tmp_path / "trace.json").exists()
    assert any("mm" in e.key for e in prof.key_averages())
    with profiling.trace(str(tmp_path / "off"), enabled=False) as none:
        assert none is None
    assert not (tmp_path / "off").exists()


def _mini(kind, seed=0):
    from bnn_pynq_tpu.compiler.artifacts import config_to_json
    from tests.test_finnthesizer import mini_cnv, mini_mlp
    jcfg = {"cnv": mini_cnv, "mlp": mini_mlp}[kind](1, 1)
    cfg = config_from_json(config_to_json(jcfg))
    return jcfg, CompiledNetwork(
        cfg, init_random_params(cfg, seed),
        np.ones(cfg.num_classes, np.float32),
        np.zeros(cfg.num_classes, np.float32))


@pytest.mark.parametrize("kind", ["cnv", "mlp"])
def test_profile_layers_rows(kind):
    """JAX's row keys, one row per stage of the mega route, every layer of
    the plan in exactly one row, the MACs of the batch; JAX's rows (prefix
    differencing) carry the same MACs layer by layer."""
    from bnn_pynq_tpu.compiler.finnthesizer import \
        CompiledNetwork as JaxCompiled
    from bnn_pynq_tpu.utils.layerprof import profile_layers as jax_profile
    jcfg, compiled = _mini(kind)
    rows = layerprof.profile_layers(compiled, batch=4, iters=2,
                                    device="cpu")
    assert all(JAX_ROW_KEYS <= set(r) for r in rows)
    covered = sorted(i for r in rows for i in r["layers"])
    assert covered == list(range(len(make_plan(compiled.config))))
    assert sum(r["macs"] for r in rows) == \
        4 * network_macs(compiled.config)
    assert all(r["ms"] > 0 and r["noise_ms"] >= 0 for r in rows)
    assert [r["stage"] for r in rows] == (
        ["block0", "pool1", "block2", "mlp_tail"] if kind == "cnv"
        else ["mlp_tail"])
    jrows = jax_profile(JaxCompiled(
        config=jcfg, layers=compiled.layers, out_scale=compiled.out_scale,
        out_bias=compiled.out_bias), batch=4, iters=1)
    assert set(jrows[0]) == JAX_ROW_KEYS
    for r in rows:
        assert r["macs"] == sum(jrows[i]["macs"] for i in r["layers"])
        assert r["kind"] == "+".join(jrows[i]["kind"] for i in r["layers"])


def test_profile_layers_cnv_w1a1_stages():
    """At CNV-W1A1's widths the chains run two layers and the 2×2 pool
    after them a stage (the pool in the last conv's epilogue, as
    forward_mega runs them) and the MLP tail takes in the last conv (its
    kernel covers its map)."""
    cfg = get_config("cnv-w1a1")
    compiled = CompiledNetwork(cfg, init_random_params(cfg, 0),
                               np.ones(10, np.float32),
                               np.zeros(10, np.float32))
    rows = layerprof.profile_layers(compiled, batch=1, iters=1,
                                    device="cpu")
    assert [(r["stage"], r["layers"]) for r in rows] == [
        ("chain0-1+pool2", [0, 1, 2]), ("chain3-4+pool5", [3, 4, 5]),
        ("block6", [6]), ("mlp_tail", [7, 8, 9, 10])]
    assert rows[0]["kind"] == "conv_int8+conv+pool"
    assert (rows[0]["k"], rows[0]["n"]) == (27, 64)
    assert sum(r["macs"] for r in rows) == 59_461_376


@pytest.mark.parametrize("names,n_layers,want", [
    (["chain0-1+pool2", "chain3-4+pool5", "block6", "mlp_tail"], 11,
     [[0, 1, 2], [3, 4, 5], [6], [7, 8, 9, 10]]),
    (["chain0-1", "pool2", "chain3-4+pool5", "block6", "mlp_tail"], 11,
     [[0, 1], [2], [3, 4, 5], [6], [7, 8, 9, 10]]),
    (["im2col0", "chain0-1+pool2", "block3", "mlp_tail"], 6,
     [[0], [0, 1, 2], [3], [4, 5]])], ids=["cnv", "odd-map", "strided"])
def test_stage_layers_reads_pooled_chains(names, n_layers, want):
    """A pooled chain's stage spans its convs and the pool after them; an
    unpooled chain and its pool stage keep their own spans."""
    assert layerprof._stage_layers(names, n_layers) == want


def test_profile_layers_refuses(monkeypatch):
    _, compiled = _mini("mlp")
    with pytest.raises(ValueError, match="stage list is the mega"):
        layerprof.profile_layers(compiled, batch=2, device="cpu",
                                 route="vpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        layerprof.profile_layers(compiled, batch=2)
