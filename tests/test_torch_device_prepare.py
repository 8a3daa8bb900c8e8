"""Raw uint8 input prepared inside the engine's program
(`engine.py::prepare_device`), held against the host preparation
(`prepare_host`): the same logits and classes bit for bit on every
route and net kind, above the largest bucket and on a padded chunk; a
uint8 batch gets programs of its own; `Classifier` hands the engine its
batch without a copy and keeps `prepare` as the host contract."""

import numpy as np
import pytest
import torch

from bnn_pynq_tpu_torch import native
from bnn_pynq_tpu_torch.runtime.classifier import Classifier
from bnn_pynq_tpu_torch.runtime.engine import (InferenceEngine,
                                               prepare_device, prepare_host)

BUCKETS = (2, 4)
# net, route, runtime: image input on four routes, bipolar input
CASES = [("cnv-w1a1", "mega", "kernels"), ("cnv-w1a1", "direct", "kernels"),
         ("cnv-w1a1", "xla", "kernels"), ("cnv-w1a1", "mega", "ref"),
         ("sfc-w1a1", "mega", "kernels"), ("lfc-w1a1", "mega", "kernels")]


def _engine(net, route="mega", runtime="kernels", buckets=BUCKETS):
    return Classifier.from_artifact(net, device="cpu", route=route,
                                    runtime=runtime,
                                    batch_buckets=buckets).engine


def _images(eng, n, seed):
    return np.random.default_rng(seed).integers(
        0, 256, (n,) + tuple(eng.config.input_shape), dtype=np.uint8)


@pytest.mark.parametrize("net,route,runtime", CASES,
                         ids=["-".join(c) for c in CASES])
@pytest.mark.parametrize("n", [3, 7], ids=["padded", "above-top"])
def test_raw_uint8_equals_host_prepared(net, route, runtime, n):
    """3 images pad to the top bucket; 7 run above it (a conv net in
    chunks of 4, the last one padded; an MLP in one forward padded to
    8)."""
    eng = _engine(net, route, runtime)
    x = _images(eng, n, n)
    host = prepare_host(eng.config, x)
    np.testing.assert_array_equal(eng.logits(x),
                                  eng.logits(host, prepared=True))
    np.testing.assert_array_equal(eng.classify(x),
                                  eng.classify(host, prepared=True))
    if runtime == "kernels":
        assert {k[1] for k in eng.programs} == {torch.uint8, torch.int8}


def test_uint8_gets_its_own_program():
    """A uint8 batch adds programs keyed by its dtype; the int8 batch's
    program stays the same object and its key the same."""
    eng = _engine("cnv-w1a1", buckets=(4,))
    x = _images(eng, 4, 1)
    eng.classify(prepare_host(eng.config, x), prepared=True)
    (key, prog), = eng.programs.items()
    assert key[1] == torch.int8
    eng.classify(x)
    assert set(eng.programs) == {key, ((4, 32, 32, 3), torch.uint8, True,
                                       False)}
    assert eng.programs[key] is prog


def test_classifier_batch_is_a_view():
    """A C-contiguous uint8 batch at the input size reaches the engine as
    a view of the caller's array; `classify_images` equals the host
    path."""
    clf = Classifier.from_artifact("cnv-w1a1", device="cpu",
                                   batch_buckets=BUCKETS)
    x = _images(clf.engine, 5, 2)
    assert np.shares_memory(clf._to_batch(x), x)
    np.testing.assert_array_equal(
        clf.classify_images(x), clf.engine.classify(clf.prepare(x),
                                                    prepared=True))
    np.testing.assert_array_equal(
        clf.classify_image_details(x[0]),
        clf.engine.logits(clf.prepare(x[:1]), prepared=True)[0])


@pytest.mark.parametrize("net", ["cnv-w1a1", "sfc-w1a1"])
def test_classifier_prepare_is_the_host_contract(net):
    clf = Classifier.from_artifact(net, device="cpu", batch_buckets=BUCKETS)
    x = _images(clf.engine, 3, 3)
    got = clf.prepare(x)
    assert got.dtype == np.int8
    if net == "cnv-w1a1":
        np.testing.assert_array_equal(got, native.center_int8(x))
    np.testing.assert_array_equal(got, prepare_host(clf.config, x))


@pytest.mark.parametrize("net", ["cnv-w1a1", "sfc-w1a1"])
def test_prepare_device_equals_prepare_host_on_every_value(net):
    cfg = _engine(net).config
    x = np.arange(256, dtype=np.uint8).reshape(4, 8, 8, 1)
    got = prepare_device(cfg, torch.from_numpy(x))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), prepare_host(cfg, x))


@pytest.mark.parametrize("net", ["cnv-w1a1", "sfc-w1a1"])
def test_warmup_makes_the_raw_programs(net):
    """After warmup, `Classifier`'s path (logits and classify of raw
    uint8) and the server's dispatch of prepared int8 add no program."""
    clf = Classifier.from_artifact(net, device="cpu", batch_buckets=BUCKETS)
    eng = clf.engine.warmup(4)
    keys = set(eng.programs)
    assert {k[1] for k in keys} >= {torch.uint8, torch.int8}
    x = _images(eng, 3, 4)
    clf.classify_images(x)
    eng.logits(x)
    eng.fetch(eng.logits_device(prepare_host(eng.config, x), prepared=True,
                                argmax=True)[0])
    assert set(eng.programs) == keys


def test_classifier_hands_raw_pixels_as_raw():
    """`Classifier` names prepared=False, so an engine whose default is
    prepared=True (the SPMD engine's) still takes its batch as pixels."""
    clf = Classifier.from_artifact("cnv-w1a1", device="cpu",
                                   batch_buckets=BUCKETS)
    seen = []
    for name in ("classify", "logits"):
        run = getattr(clf.engine, name)
        setattr(clf.engine, name,
                lambda x, prepared=True, run=run:
                seen.append(prepared) or run(x, prepared=prepared))
    x = _images(clf.engine, 2, 5)
    got = (clf.classify_images(x), clf.classify_image_details(x[0]))
    assert seen == [False, False]
    host = clf.prepare(x)
    np.testing.assert_array_equal(got[0],
                                  clf.engine.classify(host, prepared=True))
    np.testing.assert_array_equal(
        got[1], clf.engine.logits(host[:1], prepared=True)[0])
