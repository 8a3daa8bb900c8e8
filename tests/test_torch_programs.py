"""The engine's programs (`runtime/engine.py`: one per input shape and
variant, a CUDA graph on a card) on the CPU, where the same program
objects run the eager forward into the same fixed buffers. Held against
the JAX engine (its one jitted program per bucket) and against the
engine's own eager forward: logits within rtol=atol=1e-5, the JAX
tolerance (tests/test_golden_fixtures.py:36), classes equal; the eager
forward and the program bit for bit. What only a card shows (the graphs,
their launches and replays) is `chip_smoke.py` phase 20."""

import contextlib
import gc
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from bnn_pynq_tpu.compiler.artifacts import load_artifact as jax_load_artifact
from bnn_pynq_tpu.runtime.engine import InferenceEngine as JaxEngine
from bnn_pynq_tpu_torch.compiler.artifacts import load_artifact
from bnn_pynq_tpu_torch.ops._build import gc_paused
from bnn_pynq_tpu_torch.runtime import engine as engine_mod
from bnn_pynq_tpu_torch.runtime.engine import InferenceEngine, Program
from bnn_pynq_tpu_torch.runtime.http_server import serve

REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)    # tests/test_golden_fixtures.py:36
SFC = str(REPO / "pretrained" / "sfc-w1a1.npz")
CNV = str(REPO / "pretrained" / "cnv-w1a1.npz")


def _images(shape, seed):
    return np.random.default_rng(seed).integers(
        0, 256, size=shape).astype(np.uint8)


def _eager(eng, xd, argmax=False, words=False):
    return eng._eager(eng._state.params, xd, argmax, words)


@pytest.mark.parametrize("route", ["mega", "vpu", "mxu", "direct"])
def test_one_program_per_shape_and_variant_equals_jax(route):
    """A bucket's logits, argmax and packed-words launches each make one
    program, reused by every later launch of that shape and variant; the
    outputs equal the JAX engine's and the eager forward's."""
    x = _images((5, 28, 28), 1)
    eng = InferenceEngine.from_artifact(SFC, device="cpu", route=route,
                                        batch_buckets=(8, 32))
    jax = JaxEngine.from_artifact(SFC, route="xla" if route == "mega"
                                  else route, batch_buckets=(8, 32))
    logits = eng.logits(x)
    np.testing.assert_allclose(logits, jax.logits(x), **TOL)
    np.testing.assert_array_equal(eng.classify(x), jax.classify(x))
    np.testing.assert_array_equal(eng.logits_words(x), logits)
    eng.logits(_images((7, 28, 28), 2))           # the same bucket
    keys = sorted((k[0][0], k[2], k[3]) for k in eng.programs)
    assert keys == [(8, False, False), (8, False, True), (8, True, False)]
    xd = eng.upload(eng._pad_to_bucket(x)[0])     # raw, as logits sent it
    for argmax in (False, True):
        prog = eng.programs[(tuple(xd.shape), xd.dtype, argmax, False)]
        assert prog.graph is None and prog.launches == {}    # the CPU
        out = eng.launch_prepared(xd, argmax=argmax)
        assert torch.equal(out, _eager(eng, xd, argmax))
        assert out.data_ptr() != prog.out.data_ptr()        # a clone


def test_two_launches_in_flight_return_distinct_outputs():
    """Two launches of one bucket before any fetch (the server's pipeline,
    `_run`'s chunks): each output is its own batch's, though both ran the
    one program whose output buffer the second overwrote."""
    eng = InferenceEngine.from_artifact(CNV, device="cpu",
                                        batch_buckets=(4,))
    xa = eng.upload(eng.prepare(_images((4, 32, 32, 3), 3)))
    xb = eng.upload(eng.prepare(_images((4, 32, 32, 3), 4)))
    want_a, want_b = _eager(eng, xa), _eager(eng, xb)
    assert not torch.equal(want_a, want_b)
    a = eng.launch_prepared(xa)
    b = eng.launch_prepared(xb)
    assert len(eng.programs) == 1
    np.testing.assert_array_equal(eng.fetch(a), want_a.numpy())
    np.testing.assert_array_equal(eng.fetch(b), want_b.numpy())
    # a conv net above the largest bucket: every chunk launched, then
    # fetched, one program
    big = _images((12, 32, 32, 3), 5)
    want = np.concatenate([eng.logits(big[i:i + 4]) for i in (0, 4, 8)])
    np.testing.assert_array_equal(eng.logits(big), want)


def test_load_parameters_between_launches_gives_old_then_new():
    """A launch before load_parameters keeps the old parameters' output, a
    launch after it has the new ones', and the programs are made again on
    the new parameters before they are published (same keys, new
    objects)."""
    eng = InferenceEngine.from_artifact(SFC, device="cpu",
                                        batch_buckets=(8,))
    x = _images((8, 28, 28), 6)
    xd = eng.upload(eng.prepare(x))
    eng.warmup(8)
    old_programs = dict(eng.programs)
    old = _eager(eng, xd)
    before = eng.launch_prepared(xd)
    swapped = load_artifact(SFC)
    swapped.out_bias = swapped.out_bias + 1.0
    eng.load_parameters(swapped)
    after = eng.launch_prepared(xd)
    assert set(eng.programs) == set(old_programs)
    assert all(eng.programs[k] is not p for k, p in old_programs.items())
    assert torch.equal(before, old)
    torch.testing.assert_close(after, old + 1.0, **TOL)
    assert torch.equal(after, _eager(eng, xd))
    jax_swapped = jax_load_artifact(SFC)
    jax_swapped.out_bias = jax_swapped.out_bias + 1.0
    jax = JaxEngine(jax_swapped, batch_buckets=(8,))
    np.testing.assert_allclose(eng.logits(x), jax.logits(x), **TOL)


def test_launches_and_swaps_from_many_threads_never_mix():
    """Eight threads launch their own batches on one bucket while a ninth
    swaps the parameters back and forth: every output is its batch's
    logits under the old or the new parameters, whole. Without the
    engine's lock a thread's input or output buffer would be another's."""
    eng = InferenceEngine.from_artifact(SFC, device="cpu",
                                        batch_buckets=(4,))
    a = load_artifact(SFC)
    b = load_artifact(SFC)
    b.out_bias = b.out_bias + 3.0
    xs = [eng.upload(eng.prepare(_images((4, 28, 28), 10 + t)))
          for t in range(8)]
    wants = [_eager(eng, x) for x in xs]
    bad, done = [], threading.Event()

    def launcher(t):
        for _ in range(40):
            out = eng.launch_prepared(xs[t])
            if not (torch.allclose(out, wants[t], **TOL) or
                    torch.allclose(out, wants[t] + 3.0, **TOL)):
                bad.append(t)

    def swapper():
        i = 0
        while not done.is_set():
            eng.load_parameters(b if i % 2 == 0 else a)
            i += 1

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=launcher, args=(t,))
                   for t in range(8)]
        swap = threading.Thread(target=swapper)
        swap.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        done.set()
        swap.join(timeout=60)
        assert not swap.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert not bad, bad


def test_serve_warms_the_bucket_of_a_full_batch():
    """serve(max_batch=300): a full batch pads to the 1024 bucket, which
    is warmed (its programs made) before the first request, beside every
    bucket up to 300."""
    httpd, batcher = serve(SFC, device="cpu", port=0, block=False,
                           max_batch=300)
    try:
        eng = batcher.engine
        warmed = {(k[0][0], k[2], k[3]) for k in eng.programs}
        for b in (1, 16, 64, 256, 1024):
            for argmax in (False, True):
                for words in (False, True):
                    assert (b, argmax, words) in warmed, (b, argmax, words)
        assert eng._bucket(300) == 1024
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.stop()


@pytest.mark.parametrize("serving", [True, False])
@pytest.mark.parametrize("net", ["cnv", "sfc"])
def test_warmup_makes_one_program_a_dispatched_variant(net, serving):
    """warmup(5) on the mega route with buckets (4, 8): bucket 8's programs
    of prepared int8 logits and raw uint8 logits and classes; with
    serving also the int8 argmax launch and, on the bipolar SFC, the
    packed-words logits and argmax."""
    eng = InferenceEngine.from_artifact(CNV if net == "cnv" else SFC,
                                        device="cpu", batch_buckets=(4, 8))
    eng.warmup(5, serving=serving)
    pixels = (8, 32, 32, 3) if net == "cnv" else (8, 28, 28, 1)
    int8 = (8, 32, 32, 3) if net == "cnv" else (8, 784)
    want = {(int8, "torch.int8", False, False),
            (pixels, "torch.uint8", False, False),
            (pixels, "torch.uint8", True, False)}
    if serving:
        want.add((int8, "torch.int8", True, False))
        if net == "sfc":
            want |= {((8, 25), "torch.int32", a, True) for a in (False, True)}
    assert {(k[0], str(k[1]), k[2], k[3]) for k in eng.programs} == want
    assert len(eng.programs) == len(want)


def test_ref_runtime_keeps_the_eager_forward():
    eng = InferenceEngine.from_artifact(SFC, device="cpu", runtime="ref")
    x = _images((3, 28, 28), 7)
    np.testing.assert_allclose(
        eng.logits(x), InferenceEngine.from_artifact(
            SFC, device="cpu").logits(x), **TOL)
    assert not eng.programs


def test_a_failed_capture_names_the_bucket_and_variant():
    """A capture that fails raises (no eager fallback), naming what it was
    capturing."""
    class Broken:
        def wait_stream(self, other):
            raise RuntimeError("no capture here")

    prog = Program(lambda x: x + 1, torch.zeros(4, 3), "bucket 4 (input "
                   "(4, 3) torch.int8), variant argmax")
    with pytest.raises(RuntimeError, match=r"bucket 4 .* variant argmax"):
        prog.capture(Broken(), None)
    assert prog.graph is None
    # the engine's label: the bucket, its input shape and dtype, the variant
    eng = InferenceEngine.from_artifact(SFC, device="cpu",
                                        batch_buckets=(8,))
    eng.programs.execution, eng.programs.stream = "graphs", Broken()
    with pytest.raises(RuntimeError) as e:
        eng.logits(_images((5, 28, 28), 1))
    assert str(e.value).startswith(
        "CUDA graph capture of bucket 8 (input (8, 28, 28) torch.uint8), "
        "variant logits failed")
    assert not eng.programs


def test_kernel_launches_reads_every_wrapper():
    counts = engine_mod.kernel_launches()
    assert {"fused_mlp", "conv_chain", "dense_block", "conv2d_direct",
            "conv_chain_direct", "threshold_search",
            "pooled_epilogue"} <= set(counts)
    assert {k for k in counts if k.startswith("packed_matmul[")}


def test_a_capture_runs_with_the_garbage_collector_paused(monkeypatch):
    """A cyclic collection inside a capture can free another program's
    graph (an engine and its programs form a cycle), a call that
    invalidates the capture on a card: Program.capture pauses the
    collector from capture_begin to capture_end, then restores it."""
    seen = []

    class Graph:
        def capture_begin(self, pool=None, capture_error_mode=None):
            seen.append(gc.isenabled())

        def capture_end(self):
            seen.append(gc.isenabled())

    class Stream:
        def wait_stream(self, other):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "current_stream", Stream)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    prog = Program(lambda x: x + 1, torch.zeros(4, 3), "bucket 4")
    assert gc.isenabled()
    prog.capture(Stream(), None)
    assert seen == [False, False] and gc.isenabled()
    assert isinstance(prog.graph, Graph)
    assert torch.equal(prog.out, torch.ones(4, 3))


def test_gc_paused_restores_the_collector_as_it_was():
    with gc_paused():
        assert not gc.isenabled()
    assert gc.isenabled()
    gc.disable()
    try:
        with gc_paused():
            pass
        assert not gc.isenabled()
    finally:
        gc.enable()
