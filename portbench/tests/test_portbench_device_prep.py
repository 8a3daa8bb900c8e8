"""`device_prep_share`, the share of the engine's rows prepared on the
device: its reader on a synthetic registry, an empty one and a program
without spans; 100 in a traced CPU run of `cnv-w1a1.bulk`; nothing in
one of `cnv-w1a1.resident`, whose frames go through `launch_prepared`."""

import time

import pytest

from portbench import harness
from bnn_pynq_tpu_torch.utils import profiling
from test_portbench_cells import CPU_SIZES, SEED

METRIC = "device_prep_share"


@pytest.fixture
def clean():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def test_reader_on_registry(monkeypatch):
    read = harness.metric_reader(METRIC)
    monkeypatch.setattr(profiling, "span_totals", lambda: {
        "bnn.engine.pad": {"calls": 5, "total_s": 0.001, "rows": 4100},
        "bnn.engine.raw_input": {"calls": 4, "total_s": 0.0001,
                                 "rows": 4096}})
    assert read(None) == pytest.approx(4096 * 100 / 4100)
    monkeypatch.setattr(profiling, "span_totals", lambda: {
        "bnn.engine.pad": {"calls": 5, "total_s": 0.001, "rows": 4100}})
    assert read(None) is None               # no chunk went up raw
    monkeypatch.setattr(profiling, "span_totals", dict)
    assert read(None) is None
    monkeypatch.delattr(profiling, "span_totals")   # a program without
    assert read(None) is None


@pytest.mark.parametrize("name,want", [("cnv-w1a1.bulk", 100.0),
                                       ("cnv-w1a1.resident", None)])
def test_traced_cpu_run(name, want, clean):
    cell = harness.load_cell(name)
    res = harness.run(cell, SEED, 1.0, True, t_start=time.perf_counter(),
                      device="cpu", overrides=CPU_SIZES[name])
    line = harness.report(res, True, "cpu", None)
    assert line["correct"]
    assert line["metrics"].get(METRIC, {}).get("value") == want
    assert harness.metric_reader(METRIC)(None) == want
