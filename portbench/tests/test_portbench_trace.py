"""The reduction of a profiler trace to busy time, idle gaps by host span
and per-layer readings, on a synthetic chrome trace."""

from types import SimpleNamespace

import pytest

from portbench import harness


def _trace():
    ev = [{"ph": "X", "cat": "user_annotation", "name": "pb.slice",
           "ts": 0.0, "dur": 1000.0},
          {"ph": "X", "cat": "user_annotation", "name": "pb.fetch",
           "ts": 100.0, "dur": 300.0},
          {"ph": "X", "cat": "user_annotation", "name": "pb.launch",
           "ts": 500.0, "dur": 450.0},
          {"ph": "X", "cat": "user_annotation", "name": "other.op",
           "ts": 0.0, "dur": 1000.0},
          {"ph": "X", "cat": "kernel", "name": "conv_kernel<0>(ConvArgs)",
           "ts": 0.0, "dur": 100.0},
          {"ph": "X", "cat": "kernel", "name": "mlp_kernel(MlpArgs)",
           "ts": 50.0, "dur": 100.0},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
           "ts": 700.0, "dur": 100.0},
          {"ph": "i", "cat": "kernel", "name": "instant", "ts": 5.0}]
    return harness._parse_trace({"traceEvents": ev}, 0.001,
                                {"forwards": 2, "images": 2048}, 1.0,
                                {"images": 4096})


def test_busy_and_idle():
    t = _trace()
    assert (t.t0, t.t1) == (0.0, 1000.0)
    assert harness.busy_intervals(t) == [(0.0, 150.0), (700.0, 800.0)]
    assert harness.busy_s(t) == pytest.approx(250e-6)
    b = harness.breakdown(t)
    assert b["device_ops"][0][0] == "conv_kernel<0>(ConvArgs)"
    assert b["device_ops"][0][1] == pytest.approx(1e-4)
    idle = dict(b["idle_gaps"])
    # the gap 150-700 has its middle (425) in no harness span; the gap
    # 800-1000 has its middle in pb.launch
    assert idle == {"other": pytest.approx(550e-6),
                    "launch": pytest.approx(200e-6)}


def test_readers():
    t = _trace()
    cfg = harness.load_cell("cnv-w1a1.resident").config
    rec = SimpleNamespace(trace=t, cell=SimpleNamespace(config=cfg),
                          window=SimpleNamespace(images=0, seconds=1.0))
    idle = harness.metric_reader("device_idle_share.resident")(rec)
    assert idle == pytest.approx(75.0)
    fwd = harness.metric_reader("forward_device_ms")(rec)
    assert fwd == pytest.approx(0.15)
    roof = harness.metric_reader("conv_chain_roofline")(rec)
    # 0.05 ms of conv_kernel a forward of 1024 images against 0.05777
    assert roof == pytest.approx(100 * 0.05777 / 0.05, rel=1e-3)
    mfu = harness.metric_reader("mfu.resident")(rec)
    assert mfu == pytest.approx(100 * 4096 * 2 * 59_461_376 / 1979e12)
    rec.trace = None
    assert harness.metric_reader("conv_chain_roofline")(rec) is None
