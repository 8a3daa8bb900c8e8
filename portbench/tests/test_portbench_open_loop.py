"""The open-loop generator: the same arrivals for every seed, each
request timed from when it was due, and a percentile over every
request, unanswered ones included."""

import threading
import time
from concurrent.futures import Future
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import harness
from portbench.yardstick import percentile

open_loop = harness.load_module(harness.BENCH_DIR / "traffic" /
                                "open_loop.py")


def _params(**kw):
    p = {"rate_per_s": 500, "sizes": [[1, 1.0]], "pool_images": 8,
         "drain_s": 1.0}
    p.update(kw)
    return p


def test_schedule_same_work_every_seed():
    a, sa = open_loop.schedule(_params(), 4.0, np.random.default_rng(1))
    b, sb = open_loop.schedule(_params(), 4.0, np.random.default_rng(2))
    assert len(a) == len(b) == 2000
    assert not np.array_equal(a, b)
    np.testing.assert_allclose(np.sort(np.diff(a, prepend=0)),
                               np.sort(np.diff(b, prepend=0)), atol=1e-9)
    assert a[-1] == pytest.approx(4.0) and (np.diff(a) > 0).all()
    sizes = _params(sizes=[[1, 3.0], [8, 1.0]])
    _, s1 = open_loop.schedule(sizes, 4.0, np.random.default_rng(1))
    _, s2 = open_loop.schedule(sizes, 4.0, np.random.default_rng(2))
    assert sorted(s1) == sorted(s2) and (s1 == 8).sum() == 500


def test_schedule_bursts():
    p = _params(burst={"period_s": 1.0, "on_s": 0.1, "factor": 5.0})
    due, _ = open_loop.schedule(p, 2.0, np.random.default_rng(3))
    assert len(due) == round(500 * 2 * (0.9 + 0.1 * 5))
    on = ((due % 1.0) < 0.1).sum()
    assert on == pytest.approx(len(due) * 0.5 / 1.4, rel=0.05)


class _Server:
    """Answers each request after `delay_s` on a thread; never answers
    request `never`; stalls the sender `stall_s` at request `stall`."""

    def __init__(self, delay_s, never=None, stall=None, stall_s=0.0):
        self.delay_s, self.never = delay_s, never
        self.stall, self.stall_s = stall, stall_s
        self.n = 0
        self.stats = SimpleNamespace(images=0, batches=0)
        self.threads = []

    def submit_many(self, x):
        f = Future()
        k, self.n = self.n, self.n + 1
        if k == self.stall:
            time.sleep(self.stall_s)
        if k != self.never:
            def answer():
                time.sleep(self.delay_s)
                self.stats.images += len(x)
                self.stats.batches += 1
                f.set_result(np.zeros(len(x), np.int32))
            t = threading.Thread(target=answer)
            t.start()
            self.threads.append(t)
        return f


def _window(server, seconds=0.4, rate=100):
    cell = SimpleNamespace(config={"input_shape": [2, 2, 1]})
    ctx = SimpleNamespace(cell=cell, params=_params(rate_per_s=rate,
                                                    drain_s=0.3),
                          seconds=seconds, rng=np.random.default_rng(5))
    sched, _ = open_loop.schedule(ctx.params, seconds, ctx.rng)
    n = len(sched)
    inp = open_loop.Inputs(np.zeros((8, 2, 2, 1), np.uint8), sched,
                           np.arange(n + 1), np.zeros(n, np.int64))
    eng = SimpleNamespace(prepare=lambda x: x)
    win = open_loop.window({"engine": eng, "server": server}, inp, ctx,
                           harness.Tracer(False, seconds))
    for t in server.threads:
        t.join(timeout=5)
    return win, sched


def test_latency_from_due_time():
    """A stall of the sender at one request delays every request due
    during it: their latency counts the wait from when each was due."""
    win, due = _window(_Server(0.002, stall=5, stall_s=0.1))
    assert win.failed == 0 and win.attempted == len(due)
    late = (due > due[5]) & (due < due[5] + 0.08)
    assert late.any()
    assert (win.latencies_ms[late] >= 0.1e3 - (due[late] - due[5]) * 1e3
            - 1.0).all()
    assert (win.lag_ms[late] > 10).all()
    assert win.latencies_ms.min() >= 2.0 - 0.5


def test_unanswered_counts_in_the_percentile():
    win, due = _window(_Server(0.001, never=3))
    assert win.failed == 1 and len(win.latencies_ms) == len(due)
    # the unanswered request reads the wait until the harness gave up
    assert win.latencies_ms[3] >= (0.4 + 0.3 - due[3]) * 1e3 - 1.0
    assert percentile(win.latencies_ms, 100) == win.latencies_ms[3]
    ids = np.concatenate([i for i, _ in win.answers])
    assert len(ids) == len(due) - 1
