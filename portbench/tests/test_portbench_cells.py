"""Cells found by name, a new cell, metric and reference added as files
only, and the comparison that decides `correct`: sound runs pass; the
judge and the control use the reference the configuration names; the
control and
each fault a classifier cell can have fail. (A step that leaves its state
unchanged needs a state, and an exchange between chips needs chips: no
cell here has either.) The CPU runs use the kernels' plain versions at
small sizes, on the cells of BENCHMARK.json and on the cells that
PERF.md keeps for later (`LATER`), added as entries of a copy;
`card` tests run the control at each cell's own size."""

import json
import shutil
import time

import numpy as np
import pytest
import torch

from portbench import control, harness
from portbench.reference import bnn, judge

CPU_SIZES = {
    "cnv-w1a1.resident": {"pool_batches": 2, "batch": 16},
    "lfc-w1a1.resident": {"pool_batches": 2, "batch": 32},
    "cnv-w1a1.bulk": {"pool_batches": 2, "batch": 16},
    "lfc-w1a1.serve": {"rate_per_s": 150, "pool_images": 64},
    "cnv-w1a1.serve": {"rate_per_s": 30, "pool_images": 32},
}
LATER = [
    {"name": "lfc-w1a1.resident", "config": "lfc-w1a1",
     "traffic": "resident-32x16384", "chips": 1, "why": "for later"},
    {"name": "lfc-w1a1.serve", "config": "lfc-w1a1",
     "traffic": "poisson-4800", "chips": 1, "why": "serving, for later"},
    {"name": "cnv-w1a1.serve", "config": "cnv-w1a1",
     "traffic": "poisson-4800", "chips": 1, "why": "serving, for later"},
]
SEED = 3_000_000_007                     # above 2**31, as the driver's


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A copy of the benchmark with the later cells added as entries."""
    d = tmp_path_factory.mktemp("bench")
    shutil.copytree(harness.BENCH_DIR, d / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = _bench()
    bench["workloads"] += LATER
    bench["configs"].append({"name": "lfc-w1a1", "source": "s",
                             "file": "portbench/configs/lfc-w1a1.json",
                             "reduced": [], "why": "for later"})
    names = [w["name"] for w in LATER if w["name"].endswith(".serve")]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "lfc-w1a1.resident" not in m.get("workloads", ["x"]) and \
                "cnv-w1a1.resident" in m.get("workloads", []):
            m["workloads"].append("lfc-w1a1.resident")
    bench["end_to_end"].insert(0, {
        "name": "latency_p99_ms", "unit": "ms", "better": "lower",
        "bound": 0.25, "source": "host_clock", "workloads": names})
    for m in ("loadgen_lag_p99_ms", "serve_mean_batch",
              "device_idle_share.serve", "latency_p95_ms"):
        bench["per_layer"].append({
            "name": m, "unit": "ms", "better": "lower",
            "source": "host_clock", "layer": "serving",
            "moves": "latency_p99_ms", "workloads": names})
    (d / "BENCHMARK.json").write_text(json.dumps(bench))
    return d


def _bench():
    with open(harness.ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_every_cell_resolves(root):
    names = {w["name"] for w in _bench()["workloads"]}
    assert names | {w["name"] for w in LATER} == set(CPU_SIZES)
    for name in CPU_SIZES:
        cell = harness.load_cell(name, root=root)
        e2e = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.end_to_end + cell.per_layer:
            assert callable(harness.metric_reader(m["name"], root))


def _copy_bench(tmp_path):
    """The benchmark copied under `tmp_path`, with a tiny resident mix
    added; returns the bytes of every file of `portbench/` before it."""
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    (tmp_path / "portbench/traffic/resident-tiny.json").write_text(
        json.dumps({"kind": "resident", "pool_batches": 1, "batch": 8,
                    "in_flight": 2, "route": "mega"}))
    return before


def _add_config(tmp_path, name, **changes):
    """A new configuration `name`: cnv-w1a1's file with `changes` (a
    value None drops the key), and a cell `<name>.tiny` on it."""
    bdir = tmp_path / "portbench"
    config = json.loads((bdir / "configs/cnv-w1a1.json").read_text())
    config.update(name=name, **changes)
    config = {k: v for k, v in config.items() if v is not None}
    (bdir / "configs" / f"{name}.json").write_text(json.dumps(config))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": name, "source": "s", "file":
                             f"portbench/configs/{name}.json",
                             "reduced": [], "why": "a test configuration"})
    bench["workloads"].append({"name": f"{name}.tiny", "config": name,
                               "traffic": "resident-tiny", "chips": 1,
                               "why": "a test cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return f"{name}.tiny"


def test_new_cell_and_metric_are_files_only(tmp_path):
    """A later change adds a traffic mix and a metric as new files and an
    entry in BENCHMARK.json; the harness finds both without an edit."""
    before = _copy_bench(tmp_path)
    (tmp_path / "portbench/metrics/dummy_images.py").write_text(
        "def read(rec):\n    return float(rec.window.images)\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "cnv-w1a1.tiny", "config":
                               "cnv-w1a1", "traffic": "resident-tiny",
                               "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({"name": "dummy_images", "unit": "images",
                               "better": "higher", "source": "host_clock",
                               "layer": "load generator",
                               "moves": "resident_images_per_s",
                               "workloads": ["cnv-w1a1.tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell("cnv-w1a1.tiny", root=tmp_path)
    assert [m["name"] for m in cell.per_layer] == ["dummy_images"]
    res = harness.run(cell, SEED, 0.3, True, t_start=time.perf_counter(),
                      device="cpu", root=tmp_path)
    line = harness.report(res, True, "cpu", None, root=tmp_path)
    assert line["correct"]
    assert line["metrics"]["dummy_images"]["value"] >= 8
    for rel, data in before.items():
        assert (tmp_path / rel).read_bytes() == data


# appended to a byte copy of bnn.py: its logits with the classes rolled
ROLLED = b'''

_forward = forward


def forward(net, x, *, device, dtype=torch.float32):
    return torch.roll(_forward(net, x, device=device, dtype=dtype), 1, 1)
'''


@pytest.mark.parametrize("tail,correct", [(b"", True), (ROLLED, False)],
                         ids=["copy", "rolled"])
def test_new_reference_is_files_only(tmp_path, tail, correct):
    """A later change adds a configuration that names a reference of its
    own, the reference and a cell on it as new files and entries; the
    judge uses that reference: a sound run reads correct against a byte
    copy of bnn.py and not correct against its logits rolled by one."""
    before = _copy_bench(tmp_path)
    ref_dir = tmp_path / "portbench/reference"
    (ref_dir / "bnn_copy.py").write_bytes(
        (ref_dir / "bnn.py").read_bytes() + tail)
    name = _add_config(tmp_path, "cnv-w1a1-copy", reference="bnn_copy")
    cell = harness.load_cell(name, root=tmp_path)
    assert cell.reference.__file__ == str(ref_dir / "bnn_copy.py")
    res = harness.run(cell, SEED, 0.3, False, t_start=time.perf_counter(),
                      device="cpu", root=tmp_path)
    line = harness.report(res, False, "cpu", None, root=tmp_path)
    assert line["correct"] is correct, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    for rel, data in before.items():
        assert (tmp_path / rel).read_bytes() == data


@pytest.mark.parametrize("changes,error,match", [
    ({"reference": None}, ValueError, "cnv-w1a1-bad.json names no plain"),
    ({"reference": "nonesuch"}, FileNotFoundError,
     "no such benchmark file: .*nonesuch.py"),
    ({"num_classes": 12}, ValueError, "is not the configuration"),
], ids=["no_key", "no_module", "other_artifact"])
def test_reference_fault_fails_before_setup(tmp_path, monkeypatch, changes,
                                            error, match):
    """A configuration that names no reference, or one that is not there,
    fails in load_cell; an artifact that is not the configuration the
    file states fails the reference's check in make_ctx. Neither reaches
    the kind's inputs or set-up."""
    _copy_bench(tmp_path)
    name = _add_config(tmp_path, "cnv-w1a1-bad", **changes)

    def reached(*args):
        raise AssertionError("set-up reached")
    with pytest.raises(error, match=match):
        cell = harness.load_cell(name, root=tmp_path)
        monkeypatch.setattr(cell.kind, "inputs", reached)
        monkeypatch.setattr(cell.kind, "setup", reached)
        harness.run(cell, SEED, 0.3, False, t_start=time.perf_counter(),
                    device="cpu", root=tmp_path)


def test_control_through_named_reference(root):
    """control.readings through the configuration's reference gives the
    numbers of the direct calls of bnn (accumulators, then logits in
    float32 and in bfloat16)."""
    cell = harness.load_cell("lfc-w1a1.serve", root=root)
    assert cell.config["reference"] == "bnn"
    r = control.readings(cell, SEED + 3, "cpu")
    ctx = harness.make_ctx(cell, SEED + 3, 1.0, "cpu")
    x = cell.kind.reference_inputs(cell.kind.inputs(ctx))
    net = bnn.load(ctx.artifact)
    acc = bnn.accumulators(net, x, device="cpu")
    ref = bnn.logits(net, acc).numpy()
    ctl = bnn.logits(net, acc, torch.bfloat16).float().argmax(1).numpy()
    widest, invalid = judge.widest_gap(ref, [(np.arange(len(x)), ctl)])
    assert r == {"seed": SEED + 3, "images": 16384,
                 "control_widest_gap": widest,
                 "control_changed": int((ctl != ref.argmax(1)).sum()),
                 "invalid_class": invalid, "limit": 0.0}
    assert widest > 0


def _run(root, name, fault=None, seconds=1.0):
    cell = harness.load_cell(name, root=root)
    res = harness.run(cell, SEED, seconds, False,
                      t_start=time.perf_counter(), device="cpu",
                      overrides=CPU_SIZES[name], fault=fault, root=root)
    return harness.report(res, False, "cpu", None, root=root)


def _alter_answer(eng):
    """One answer of every batch changed where it is produced."""
    launch = eng.launch_prepared

    def altered(xd, **kw):
        out = launch(xd, **kw)
        out[0] = (out[0] + 1) % eng.config.num_classes
        return out
    eng.launch_prepared = altered


def _half_left_out(eng):
    """The second half of every batch not computed: its answers left at
    zero (of the launch's rows, and of the true batch where the server
    pads a batch to its bucket)."""
    def wrap(fn):
        def half(x, **kw):
            out, b = fn(x, **kw)
            out[b // 2:b] = 0
            return out, b
        return half
    eng.logits_device = wrap(eng.logits_device)
    eng.words_device = wrap(eng.words_device)
    launch = eng.launch_prepared

    def launch_half(xd, **kw):
        out = launch(xd, **kw)
        out[xd.shape[0] // 2:] = 0
        return out
    eng.launch_prepared = launch_half


@pytest.mark.parametrize("name", sorted(CPU_SIZES))
def test_sound_run_is_correct(root, name):
    line = _run(root, name)
    assert line["correct"], line["checks"]
    assert line["checks"]["widest_gap"]["value"] == 0.0
    assert line["attempted"] > 0 and line["failed"] == 0


@pytest.mark.parametrize("name", sorted(CPU_SIZES))
@pytest.mark.parametrize("fault", [_alter_answer, _half_left_out])
def test_fault_is_not_correct(root, name, fault):
    line = _run(root, name, fault)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("seed", [SEED, SEED + 1, SEED + 2])
def test_control_fails_cpu(root, seed):
    """The control on the CPU at the 16384 images of the LFC serving
    mix (the resident cells' pools take a card)."""
    cell = harness.load_cell("lfc-w1a1.serve", root=root)
    r = control.readings(cell, seed, "cpu")
    assert r["images"] == 16384
    assert r["control_widest_gap"] > r["limit"]


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(CPU_SIZES))
def test_control_fails_at_cell_size(card, root, name):
    cell = harness.load_cell(name, root=root)
    for s in (SEED, SEED + 1, SEED + 2):
        r = control.readings(cell, s, card)
        assert r["control_widest_gap"] > r["limit"], r
        assert r["invalid_class"] == 0
    torch.cuda.empty_cache()
