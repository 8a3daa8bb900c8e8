"""The port's spans (utils/profiling.py::span): off unless a profiler
records on the calling thread; under `profiling.trace` every step of
`Classifier.classify_images` (and of `Classifier.prepare`, the host
preparation it no longer runs) is in `span_totals()` with its calls and
rows, children within their parents, and in the exported trace.json each
child's interval inside its parent's."""

import json
import threading
import time

import numpy as np
import pytest
import torch

from bnn_pynq_tpu_torch.runtime.classifier import Classifier
from bnn_pynq_tpu_torch.utils import profiling

NETS = ("cnv-w1a1", "sfc-w1a1")         # image input, chunked; bipolar
BATCH = 6
BUCKETS = (2, 4)
# child → parent, as `classify_images` nests them
PARENT = {"bnn.classifier.to_batch": "bnn.classifier.prepare",
          "bnn.engine.pad": "bnn.engine.run",
          "bnn.engine.upload": "bnn.engine.run",
          "bnn.engine.launch": "bnn.engine.run",
          "bnn.engine.fetch": "bnn.engine.run",
          "bnn.program.copy_in": "bnn.engine.launch",
          "bnn.program.replay": "bnn.engine.launch",
          "bnn.program.clone": "bnn.engine.launch"}


@pytest.fixture
def clean():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def _classifier(net):
    return Classifier.from_artifact(net, device="cpu",
                                    batch_buckets=BUCKETS)


def _images(clf, n=BATCH):
    h, w, c = clf.config.input_shape
    return np.random.default_rng(7).integers(0, 256, (n, h, w, c),
                                             dtype=np.uint8)


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """Per net: one `classify_images` of BATCH images under
    `profiling.trace`: the span totals, the trace's `bnn.*` events and
    the engine's expected (calls, rows) of a chunk's spans."""
    out = {}
    for net in NETS:
        clf = _classifier(net)
        x = _images(clf)
        clf.classify_images(x)                 # programs made untraced
        d = tmp_path_factory.mktemp(net)
        profiling.reset_spans()
        with profiling.trace(str(d)):
            clf.classify_images(x)
        totals = profiling.span_totals()
        profiling.reset_spans()
        events = [e for e in json.loads((d / "trace.json").read_text())
                  ["traceEvents"] if e.get("ph") == "X"
                  and e.get("name", "").startswith("bnn.")]
        eng = clf.engine
        chunks = eng._chunks(BATCH)
        padded = sum(eng._bucket(hi - lo) for lo, hi in chunks)
        out[net] = totals, events, (len(chunks), padded)
    return out


@pytest.mark.parametrize("net", NETS)
def test_spans_off_record_nothing(net, clean):
    clf = _classifier(net)
    x = _images(clf)
    assert clf.classify_images(x).shape == (BATCH,)
    eng = clf.engine
    xd = torch.from_numpy(clf.prepare(x[:BUCKETS[-1]]))
    assert eng.fetch(eng.launch_prepared(xd, argmax=True)).shape == \
        (BUCKETS[-1],)
    assert profiling.span_totals() == {}


@pytest.mark.parametrize("net", NETS)
def test_span_totals_under_trace(traced, net):
    totals, _, (chunks, padded) = traced[net]
    want = {"bnn.classifier.prepare": (1, BATCH),
            "bnn.classifier.to_batch": (1, BATCH),
            "bnn.engine.run": (1, BATCH),
            "bnn.engine.pad": (chunks, BATCH),
            "bnn.engine.upload": (chunks, padded),
            "bnn.engine.launch": (chunks, padded),
            "bnn.engine.fetch": (chunks, padded),
            "bnn.program.copy_in": (chunks, 0),
            "bnn.program.replay": (chunks, 0),
            "bnn.program.clone": (chunks, 0)}
    assert set(totals) == set(want)
    for name, (calls, rows) in want.items():
        s = totals[name]
        assert (s["calls"], s["rows"]) == (calls, rows), name
        assert 0 < s["total_s"], name


@pytest.mark.parametrize("net", NETS)
def test_children_within_parents(traced, net):
    totals = traced[net][0]
    for child, parent in PARENT.items():
        assert totals[child]["total_s"] <= totals[parent]["total_s"], child
    kids = {p: sum(totals[c]["total_s"] for c, q in PARENT.items()
                   if q == p) for p in set(PARENT.values())}
    for parent, inner in kids.items():
        assert inner <= totals[parent]["total_s"], parent


@pytest.mark.parametrize("net", NETS)
def test_trace_file_nests_spans(traced, net):
    totals, events, _ = traced[net]
    by_name = {}
    for e in events:
        by_name.setdefault(e["name"], []).append(
            (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))))
    assert {k: len(v) for k, v in by_name.items()} == \
        {k: s["calls"] for k, s in totals.items()}
    eps = 1e-3                                  # us, the trace's rounding
    for child, parent in PARENT.items():
        for a, b in by_name[child]:
            assert any(p <= a + eps and b <= q + eps
                       for p, q in by_name[parent]), (child, a, b)


@pytest.mark.parametrize("net", NETS)
def test_prepare_spans_under_trace(net, clean, tmp_path):
    """`Classifier.prepare`, the host preparation, records `prepare` ⊃
    `to_batch`, `center`, each call with the batch's rows, the children
    within their parent."""
    clf = _classifier(net)
    x = _images(clf)
    with profiling.trace(str(tmp_path)):
        clf.prepare(x)
    totals = profiling.span_totals()
    names = ("bnn.classifier.prepare", "bnn.classifier.to_batch",
             "bnn.classifier.center")
    assert set(totals) == set(names)
    for name in names:
        assert (totals[name]["calls"], totals[name]["rows"]) == (1, BATCH)
    prep = totals["bnn.classifier.prepare"]["total_s"]
    assert 0 < totals["bnn.classifier.to_batch"]["total_s"] + \
        totals["bnn.classifier.center"]["total_s"] <= prep


def test_other_thread_records_nothing(clean, tmp_path):
    """A profiler started on this thread is not seen by another: the
    engine's spans there record nothing, this thread's do."""
    clf = _classifier("sfc-w1a1")
    eng = clf.engine
    xd = torch.from_numpy(clf.prepare(_images(clf, BUCKETS[-1])))
    eng.fetch(eng.launch_prepared(xd))
    done = []

    def work():
        with profiling.span("bnn.test.thread"):
            done.append(eng.fetch(eng.launch_prepared(xd)))
    with profiling.trace(str(tmp_path)):
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=60)
        with profiling.span("bnn.test.main", 3):
            pass
    assert not t.is_alive() and len(done) == 1
    assert set(profiling.span_totals()) == {"bnn.test.main"}
    assert profiling.span_totals()["bnn.test.main"]["rows"] == 3


def test_span_totals_and_rows(clean, tmp_path):
    """A span's seconds hold its children's; rows may be set inside the
    span; off, the span takes no rows and records nothing."""
    off = profiling.span("bnn.test.outer")
    with off as sp:
        sp.rows = 5
        assert sp.rows == 0
    assert profiling.span_totals() == {}
    with profiling.trace(str(tmp_path)):
        with profiling.span("bnn.test.outer") as sp:
            time.sleep(0.02)
            for _ in range(2):
                with profiling.span("bnn.test.inner", 2):
                    time.sleep(0.015)
            sp.rows = 7
    t = profiling.span_totals()
    outer, inner = t["bnn.test.outer"], t["bnn.test.inner"]
    assert (outer["calls"], outer["rows"]) == (1, 7)
    assert (inner["calls"], inner["rows"]) == (2, 4)
    assert set(outer) == {"calls", "total_s", "rows"}
    assert inner["total_s"] >= 0.03
    assert outer["total_s"] >= inner["total_s"] + 0.02
    t["bnn.test.outer"]["calls"] = 99               # a copy
    assert profiling.span_totals()["bnn.test.outer"]["calls"] == 1
    profiling.reset_spans()
    assert profiling.span_totals() == {}
