"""The cell `resnet50-w1a2.resident` on the CPU: a sound run reads
correct and each fault a classifier cell can have reads not correct (the
kernels' plain versions, 2 images of the network at full size), and the
control through ResNet-50's reference reads above the limit 0 (on a copy
of the network at width 1/16 on 64x64 images with the cell's 1000
classes, 256 images); on a card, the control at the cell's own size.

The cell's CPU size also goes into `test_portbench_cells.CPU_SIZES`, the
table by which `test_every_cell_resolves` holds that every cell of
BENCHMARK.json has one."""

import json
import shutil
import time

import pytest
import torch

import test_portbench_cells as cells
from portbench import control, harness

CELL = "resnet50-w1a2.resident"
CPU_SIZE = {"pool_batches": 1, "batch": 2}
cells.CPU_SIZES.setdefault(CELL, CPU_SIZE)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A copy of the benchmark with a cell on ResNet-50 v1.5 W1A2 at width
    1/16, 64x64 images and 1000 classes (its artifact from the
    configuration's generator), 256 images in its pool: the control's size
    on the CPU."""
    from bnn_pynq_tpu_torch.compiler.artifacts import (config_to_json,
                                                       save_artifact)
    from bnn_pynq_tpu_torch.models.config import resnet50_v1_5
    d = tmp_path_factory.mktemp("bench_tiny")
    shutil.copytree(harness.BENCH_DIR, d / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    config = resnet50_v1_5(1 / 16, 1000, 64)
    gen = harness.load_module(
        harness.BENCH_DIR / "configs/make_resnet50_w1a2.py")
    artifact = d / "portbench/configs/tiny.npz"
    save_artifact(str(artifact), gen.build(config, calib=16))
    cfg = json.loads((d / "portbench/configs/resnet50-w1a2.json")
                     .read_text())
    # an absolute artifact path: control.readings resolves it from the
    # repository's root
    cfg.update(config_to_json(config), name="resnet50-w1a2-tiny",
               artifact=str(artifact))
    (d / "portbench/configs/resnet50-w1a2-tiny.json").write_text(
        json.dumps(cfg))
    (d / "portbench/traffic/resident-1x256.json").write_text(json.dumps(
        {"kind": "resident", "pool_batches": 1, "batch": 256,
         "in_flight": 2, "route": "mega"}))
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({
        "name": "resnet50-w1a2-tiny.resident",
        "config": "resnet50-w1a2-tiny", "traffic": "resident-1x256",
        "chips": 1, "why": "the control on the CPU"})
    (d / "BENCHMARK.json").write_text(json.dumps(bench))
    return d


def _run(fault=None):
    cell = harness.load_cell(CELL)
    res = harness.run(cell, cells.SEED, 1.0, False,
                      t_start=time.perf_counter(), device="cpu",
                      overrides=CPU_SIZE, fault=fault)
    return harness.report(res, False, "cpu", None)


def test_cell_resolves():
    cell = harness.load_cell(CELL)
    assert [m["name"] for m in cell.end_to_end] == ["resident_images_per_s",
                                                    "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["resblock_roofline",
                                                   "mfu.resnet50"]
    assert cell.config["reference"] == "resnet50"
    assert cell.traffic["batch"] == 256 and cell.chips == 1


def test_reference_checks_the_artifact(tmp_path):
    """The reference's check takes the committed artifact and refuses one
    that differs from the configuration file: a layer's width, the codes'
    signedness, a weight outside its width."""
    cell = harness.load_cell(CELL)
    ref = cell.reference
    path = str(harness.ROOT / cell.config["artifact"])
    ref.check(ref.load(path), cell.config)
    for change in ({"abits": 1}, {"unsigned": False},
                   {"layers": cell.config["layers"][:-1]}):
        with pytest.raises(ValueError):
            ref.check(ref.load(path), dict(cell.config, **change))
    net = ref.load(path)
    net.layers[0].w["w"][0, 0] = -128
    with pytest.raises(ValueError):
        ref.check(net, cell.config)


def test_sound_run_is_correct():
    line = _run()
    assert line["correct"], line["checks"]
    assert line["checks"]["widest_gap"]["value"] == 0.0
    assert line["attempted"] > 0 and line["failed"] == 0


@pytest.mark.parametrize("fault", [cells._alter_answer,
                                   cells._half_left_out])
def test_fault_is_not_correct(fault):
    line = _run(fault)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("seed", [cells.SEED, cells.SEED + 1,
                                  cells.SEED + 2])
def test_control_fails_cpu_resnet50(tiny, seed):
    """bfloat16 output arithmetic changes classes, so the control reads
    above the limit 0."""
    cell = harness.load_cell("resnet50-w1a2-tiny.resident", root=tiny)
    assert cell.config["reference"] == "resnet50"
    r = control.readings(cell, seed, "cpu")
    assert r["images"] == 256 and r["invalid_class"] == 0
    assert r["control_widest_gap"] > r["limit"] and r["control_changed"] > 0


@pytest.mark.card
def test_control_fails_at_cell_size(card):
    cell = harness.load_cell(CELL)
    for s in (cells.SEED, cells.SEED + 1, cells.SEED + 2):
        r = control.readings(cell, s, card)
        assert r["control_widest_gap"] > r["limit"], r
        assert r["invalid_class"] == 0
    torch.cuda.empty_cache()


def test_reference_imports_numpy_and_torch_only():
    """What `test_portbench_imports` holds of every reference, named for
    this one: it imports nothing of the program or of JAX."""
    import test_portbench_imports as imports
    names = set(imports._imports(harness.BENCH_DIR /
                                 "reference/resnet50.py"))
    assert names <= {"__future__", "json", "dataclasses", "typing",
                     "numpy", "torch"}
