"""The per-layer metrics that read the program's own spans
(`bnn_pynq_tpu_torch.utils.profiling.span_totals()`): each reader on a
synthetic registry, on an empty one and on a program without spans; a
traced CPU run of each cell reports its own and not the other's; each
entry in BENCHMARK.json names its cell."""

import json
import time

import pytest

from portbench import harness
from bnn_pynq_tpu_torch.utils import profiling
from test_portbench_cells import CPU_SIZES, SEED

# each metric, the cell that reports it, and its reading of `_registry()`
SPANS = {"to_batch_ms_per_kimg": ("cnv-w1a1.bulk", 2.5),
         "upload_ms_per_kimg": ("cnv-w1a1.bulk", 0.2),
         "launch_host_us": ("cnv-w1a1.resident", 50.0),
         "fetch_copy_us": ("cnv-w1a1.resident", 30.0)}


@pytest.fixture
def clean():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def _registry():
    """2.5 ms per 1024 rows in to_batch, 0.2 in upload, 50 us a call in
    launch and 30 in fetch."""
    return {"bnn.classifier.to_batch": {"calls": 2, "total_s": 0.005,
                                        "rows": 2048},
            "bnn.engine.upload": {"calls": 8, "total_s": 0.0016,
                                  "rows": 8192},
            "bnn.engine.launch": {"calls": 40, "total_s": 0.002,
                                  "rows": 40960},
            "bnn.engine.fetch": {"calls": 40, "total_s": 0.0012,
                                 "rows": 40960}}


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_reader_on_registry(metric, monkeypatch):
    read = harness.metric_reader(metric)
    monkeypatch.setattr(profiling, "span_totals", _registry)
    assert read(None) == pytest.approx(SPANS[metric][1])
    monkeypatch.setattr(profiling, "span_totals", dict)
    assert read(None) is None
    monkeypatch.delattr(profiling, "span_totals")   # a program without
    assert read(None) is None


@pytest.mark.parametrize("name", ["cnv-w1a1.bulk", "cnv-w1a1.resident"])
def test_traced_cpu_run_reports_its_metrics(name, clean):
    cell = harness.load_cell(name)
    res = harness.run(cell, SEED, 1.0, True, t_start=time.perf_counter(),
                      device="cpu", overrides=CPU_SIZES[name])
    line = harness.report(res, True, "cpu", None)
    assert line["correct"]
    got = {m: v["value"] for m, v in line["metrics"].items() if m in SPANS}
    assert set(got) == {m for m, (c, _) in SPANS.items() if c == name}
    assert all(v > 0 for v in got.values()), got
    untraced = harness.report(res, False, "cpu", None)["metrics"]
    assert not set(untraced) & set(SPANS)


def test_new_entries_name_their_cells():
    """Each new metric's entry in BENCHMARK.json lists the one cell whose
    traced runs report it."""
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    mine = {m["name"]: m["workloads"] for m in bench["per_layer"]
            if m["name"] in SPANS}
    assert mine == {k: [c] for k, (c, _) in SPANS.items()}
