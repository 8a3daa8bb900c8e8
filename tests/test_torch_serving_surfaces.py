"""The port's serving surfaces on the CPU (`device="cpu"`), held against
the JAX package: the JAX route names on the port's engine, the host ops of
`native.py`, `Classifier`, the HTTP server, `Frontend`, the server's
upload stage and the CLI. Logits agree within rtol=atol=1e-5, the JAX
tolerance (tests/test_golden_fixtures.py:36); classes and integer outputs
are equal. Every server is stopped in a `finally`."""

import io
import json
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import Future
from pathlib import Path

import numpy as np
import pytest
import torch

from bnn_pynq_tpu import cli as jax_cli
from bnn_pynq_tpu import native as jax_native
from bnn_pynq_tpu.compiler import compile_network, save_artifact
from bnn_pynq_tpu.runtime.classifier import Classifier as JaxClassifier
from bnn_pynq_tpu.runtime.engine import InferenceEngine as JaxEngine
from bnn_pynq_tpu.runtime.http_server import serve as jax_serve
from bnn_pynq_tpu_torch import cli, native
from bnn_pynq_tpu_torch.runtime import classifier as port_classifier
from bnn_pynq_tpu_torch.runtime.classifier import Classifier
from bnn_pynq_tpu_torch.runtime.engine import InferenceEngine
from bnn_pynq_tpu_torch.runtime.frontend import (BackendHandle,
                                                 BackpressureError, Frontend,
                                                 HttpBackend)
from bnn_pynq_tpu_torch.runtime.http_server import serve
from bnn_pynq_tpu_torch.runtime.serving import BatchingServer
from tests.test_finnthesizer import init_perturbed, mini_cnv

REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)    # tests/test_golden_fixtures.py:36


def _art(name):
    return str(REPO / "pretrained" / f"{name}.npz")


SFC, CNV, LFC = _art("sfc-w1a1"), _art("cnv-w1a1"), _art("lfc-w1a1")


def _images(shape, seed):
    return np.random.default_rng(seed).integers(
        0, 256, size=shape).astype(np.uint8)


def _mini_artifacts(tmp_path, *seeds):
    """Mini CNV artifacts (tests/test_finnthesizer.py) saved by the JAX
    compiler: [(path, JAX CompiledNetwork)]."""
    cfg = mini_cnv(1, 1)
    out = []
    for seed in seeds:
        _, params, stats = init_perturbed(cfg, seed=seed)
        compiled = compile_network(cfg, params, stats)
        path = str(tmp_path / f"mini{seed}.npz")
        save_artifact(path, compiled)
        out.append((path, compiled))
    return out


# -- fault 1: every JAX route name ---------------------------------------

@pytest.mark.parametrize("name,route", [
    ("sfc-w1a1", "s2d"), ("sfc-w1a1", "xla"), ("sfc-w1a1", "xlaconv"),
    ("sfc-w1a1", "fused"), ("cnv-w1a1", "s2d"), ("cnv-w1a1", "xla"),
    ("cnv-w1a1", "xlaconv")])
def test_jax_route_names_match_jax_engine(name, route):
    """The JAX engine's route names run on the port's engine and give the
    JAX engine's logits on that route: 's2d' and 'fused' the mega stage
    list, 'xla' and 'xlaconv' forward_xla on the decoded parameters
    (conv_mode 'patches' and 'native', as JAX maps them)."""
    path = _art(name)
    cfg_shape = (4, 28, 28) if path == SFC else (4, 32, 32, 3)
    x = _images(cfg_shape, 11)
    want = JaxEngine.from_artifact(path, runtime="interpret", route=route,
                                   batch_buckets=(4,)).logits(x)
    eng = InferenceEngine.from_artifact(path, device="cpu", route=route,
                                        batch_buckets=(4,))
    assert eng.route == route
    got = eng.logits(x)
    np.testing.assert_allclose(got, want, **TOL)
    assert (got.argmax(1) == want.argmax(1)).all()
    np.testing.assert_array_equal(eng.classify(x), want.argmax(1))


@pytest.mark.parametrize("runtime", ["auto", "tpu", "interpret", "kernels"])
def test_jax_runtime_names_are_the_kernels_runtime(runtime, capsys,
                                                   tmp_path):
    """The JAX engine's runtime names ('auto' is its default) name the
    port's kernels runtime: the engine, the Classifier, the HTTP server and
    the CLI take them, and an engine on the CPU gives the logits of
    runtime='kernels'. An unknown name still raises."""
    x = _images((3, 32, 32, 3), 12)
    want = InferenceEngine.from_artifact(CNV, device="cpu",
                                         runtime="kernels").logits(x)
    eng = InferenceEngine.from_artifact(CNV, device="cpu", runtime=runtime)
    assert eng.runtime == "kernels"
    np.testing.assert_array_equal(eng.logits(x), want)
    clf = Classifier.from_artifact(CNV, device="cpu", runtime=runtime)
    assert clf.engine.runtime == "kernels"
    httpd, batcher = serve(SFC, port=0, device="cpu",
                                       runtime=runtime, block=False,
                                       warmup=False)
    try:
        assert batcher.engine.runtime == "kernels"
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.stop()
    path = tmp_path / "x.npy"
    np.save(path, x)
    outs = []
    for rt in (runtime, "kernels"):
        cli.main(["classify", CNV, str(path), "--device", "cpu",
                  "--runtime", rt])
        outs.append(capsys.readouterr().out.splitlines()[:3])
    assert outs[0] == outs[1] and len(outs[0]) == 3
    with pytest.raises(ValueError, match="unknown runtime"):
        InferenceEngine.from_artifact(CNV, device="cpu", runtime="gpu")
    with pytest.raises(SystemExit):
        cli.main(["classify", CNV, str(path), "--runtime", "gpu"])
    capsys.readouterr()


def test_fused_route_rejects_conv_nets_as_jax_does():
    with pytest.raises(ValueError):
        JaxEngine.from_artifact(CNV, runtime="interpret", route="fused")
    with pytest.raises(ValueError, match="fused"):
        InferenceEngine.from_artifact(CNV, device="cpu", route="fused")
    # the reference runtime ignores the route, in both packages
    InferenceEngine.from_artifact(CNV, device="cpu", route="fused",
                                  runtime="ref")


# -- fault 2: the host ops of native.py ------------------------------------

@pytest.fixture(params=["lib", "numpy"])
def native_body(request, monkeypatch):
    """Run the port's native ops through the C++ library, then through the
    numpy bodies."""
    if request.param == "lib":
        if not native.available():
            monkeypatch.setattr(native, "_lib", None)
            assert native.build(), "native toolchain unavailable"
        assert native.available()
    else:
        monkeypatch.setattr(native, "_LIB_PATH", "/nonexistent")
        monkeypatch.setattr(native, "_lib", None)
        assert not native.available()
    return request.param


@pytest.mark.parametrize("shape,out_hw", [
    ((2, 37, 53, 3), (32, 32)), ((3, 64, 48, 1), (28, 28)),
    ((1, 8, 8, 3), (32, 32)), ((2, 32, 32, 3), (32, 32))])
def test_resize_nn_matches_jax(native_body, shape, out_hw):
    imgs = _images(shape, 12)
    got = native.resize_nn(imgs, *out_hw)
    assert got.dtype == np.uint8 and got.shape == shape[:1] + out_hw + \
        shape[3:]
    np.testing.assert_array_equal(got, jax_native.resize_nn(imgs, *out_hw))


def test_center_pack_argmax_match_jax(native_body):
    rng = np.random.default_rng(13)
    imgs = _images((3, 32, 32, 3), 13)
    got = native.center_int8(imgs)
    assert got.dtype == np.int8 and got.shape == imgs.shape
    np.testing.assert_array_equal(got, jax_native.center_int8(imgs))
    codes = rng.integers(0, 4, size=(9, 77)).astype(np.int8)
    got = native.pack_codes2(codes)
    assert got.dtype == np.uint32 and got.shape == (9, 5)
    np.testing.assert_array_equal(got, jax_native.pack_codes2(codes))
    logits = rng.normal(size=(100, 43)).astype(np.float32)
    got = native.argmax(logits)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jax_native.argmax(logits))


# -- Classifier ----------------------------------------------------------

class _FakePIL:
    """What Classifier reads of a PIL image: `.convert(mode)` to an array
    ('RGB' [H, W, 3] or 'L' [H, W])."""

    def __init__(self, rgb):
        self.rgb = rgb

    def convert(self, mode):
        if mode == "RGB":
            return self.rgb
        return self.rgb.mean(axis=-1).astype(np.uint8)


def _classifier_inputs(cfg):
    if cfg.input_kind == "bipolar":
        return [_images((28, 28), 14), _images((3, 28, 28, 1), 15),
                _images((2, 56, 40), 16), _FakePIL(_images((30, 30, 3), 17)),
                [_FakePIL(_images((28, 28, 3), 18))] * 2]
    return [_images((32, 32, 3), 19), _images((2, 37, 53, 3), 20),
            _images((40, 50), 21), _images((2, 32, 32, 1), 22),
            _FakePIL(_images((24, 20, 3), 23)),
            [_FakePIL(_images((32, 32, 3), 24 + i)) for i in range(3)]]


@pytest.mark.parametrize("name", ["sfc-w1a1", "cnv-w1a1"])
def test_classifier_matches_jax_classifier(name):
    path = _art(name)
    jc = JaxClassifier.from_artifact(path, runtime="ref")
    pc = Classifier.from_artifact(path, device="cpu")
    assert pc.classes == jc.classes
    assert pc.class_name(3) == jc.class_name(3)
    for images in _classifier_inputs(pc.config):
        prepared = pc.prepare(images)
        np.testing.assert_array_equal(prepared, jc.prepare(images))
        np.testing.assert_array_equal(pc.classify_images(images),
                                      jc.classify_images(images))
        first = images[0] if isinstance(images, list) else images
        if isinstance(first, np.ndarray) and first.ndim == \
                len(pc.config.input_shape) + 1:
            first = first[0]
        np.testing.assert_allclose(pc.classify_image_details(first),
                                   jc.classify_image_details(first), **TOL)
        assert pc.classify_image(first) == jc.classify_image(first)
    assert pc.usecPerImage is not None and pc.usecPerImage > 0


def test_classifier_from_artifact_passes_engine_options():
    clf = Classifier.from_artifact("sfc-w1a1", device="cpu", route="vpu",
                                   runtime="ref", batch_buckets=(2, 8))
    eng = clf.engine
    assert isinstance(eng, InferenceEngine)
    assert (eng.device.type, eng.route, eng.runtime, eng.batch_buckets) == \
        ("cpu", "vpu", "ref", (2, 8))
    if not torch.cuda.is_available():        # no fallback to the CPU
        with pytest.raises(RuntimeError, match="CUDA"):
            Classifier.from_artifact("sfc-w1a1", device="cuda")


def test_available_params_and_class_tables(tmp_path, monkeypatch):
    from bnn_pynq_tpu.runtime import classifier as jax_classifier
    monkeypatch.setenv("BNN_PARAMS_DIR", str(tmp_path))
    (tmp_path / "zz-custom.npz").write_bytes(b"x")
    names = port_classifier.available_params()
    assert "zz-custom.npz" in names and "cnv-w1a1.npz" in names
    assert port_classifier.available_params("zz") == ["zz-custom.npz"]
    assert port_classifier.available_params("cnv") == \
        jax_classifier.available_params("cnv")
    assert port_classifier.params_dirs() == jax_classifier.params_dirs()
    assert port_classifier.DATASET_CLASSES == jax_classifier.DATASET_CLASSES


def test_default_params_dir_equals_jax(tmp_path, monkeypatch):
    """The first directory of the search path, with and without
    $BNN_PARAMS_DIR, as in the JAX package."""
    from bnn_pynq_tpu.runtime import classifier as jax_classifier
    monkeypatch.delenv("BNN_PARAMS_DIR", raising=False)
    assert port_classifier.default_params_dir() == \
        jax_classifier.default_params_dir() == str(REPO / "artifacts")
    monkeypatch.setenv("BNN_PARAMS_DIR", str(tmp_path))
    assert port_classifier.default_params_dir() == \
        jax_classifier.default_params_dir() == str(tmp_path)


# -- the HTTP server -----------------------------------------------------

def _http(port, path, body=None):
    """(status, body) of one request; non-200 answers too."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _npz(x):
    buf = io.BytesIO()
    np.savez(buf, x=x)
    return buf.getvalue()


def _stop(httpd, batcher):
    httpd.shutdown()
    httpd.server_close()
    batcher.stop()


def test_http_server_behaves_as_jax_server():
    """The same requests to a JAX server (runtime 'ref') and to the
    port's: the same status codes, classes, names and reload answers."""
    kw = dict(port=0, block=False, max_batch=8, batch_buckets=(8,))
    servers = {"jax": jax_serve(SFC, runtime="ref", **kw),
               "port": serve(SFC, device="cpu", **kw)}
    try:
        ports = {k: h.server_address[1] for k, (h, _) in servers.items()}
        x = _images((5, 28, 28), 25)
        sfc_bytes = open(SFC, "rb").read()
        lfc_bytes = open(LFC, "rb").read()
        answers = {}
        for k, p in ports.items():
            answers[k] = [
                _http(p, "/healthz"),
                _http(p, "/classify", _npz(x)),
                _http(p, "/reload", sfc_bytes),
                _http(p, "/classify", _npz(x[:1])),
                _http(p, "/nowhere"),
                _http(p, "/reload", lfc_bytes),
                _http(p, "/reload", b"not an npz"),
                _http(p, "/classify", b"not an npz"),
            ]
            stats = json.loads(_http(p, "/stats")[1])
            assert stats["requests"] >= 2 and stats["images"] >= 6
        assert [c for c, _ in answers["port"]] == \
            [200, 200, 200, 200, 404, 409, 409, 400]
        for (cj, bj), (cp, bp) in zip(answers["jax"], answers["port"]):
            assert cj == cp
            if cj == 200 and bj.startswith(b"{"):
                assert json.loads(bj) == json.loads(bp)
            elif cj == 200:
                assert bj == bp
        classes = json.loads(answers["port"][1][1])["classes"]
        np.testing.assert_array_equal(
            classes, JaxEngine.from_artifact(SFC, runtime="ref").classify(x))
        # a stopped batcher answers 503, as the JAX server does
        for k, (_, batcher) in servers.items():
            batcher.stop()
            assert _http(ports[k], "/healthz")[0] == 503
            assert _http(ports[k], "/classify", _npz(x))[0] == 503
    finally:
        for s in servers.values():
            _stop(*s)


def test_http_server_cnv_and_warmup(monkeypatch):
    """A CNV server on the mega kernels' plain versions: every bucket up to
    max_batch is warmed before serving; /classify equals JAX's classes."""
    warmed = []
    warmup = InferenceEngine.warmup
    monkeypatch.setattr(InferenceEngine, "warmup",
                        lambda self, b=1, **kw: warmed.append(b) or
                        warmup(self, b, **kw))
    httpd, batcher = serve(CNV, device="cpu", port=0, block=False,
                           max_batch=4, batch_buckets=(1, 4, 16))
    try:
        assert warmed == [1, 4]
        x = _images((3, 32, 32, 3), 26)
        code, body = _http(httpd.server_address[1], "/classify", _npz(x))
        assert code == 200
        np.testing.assert_array_equal(
            json.loads(body)["classes"],
            JaxEngine.from_artifact(CNV, runtime="ref").classify(x))
    finally:
        _stop(httpd, batcher)


# -- Frontend: the cases of tests/test_frontend.py on the port ------------

class FakeServer:
    """Mimics BatchingServer.submit for one request at a time."""

    def __init__(self, name, fail=False, delay=0.0):
        self.name = name
        self.fail = fail
        self.delay = delay
        self.handled = 0

    def _run(self, f, value):
        def run():
            if self.delay:
                time.sleep(self.delay)
            if self.fail:
                f.set_exception(RuntimeError(f"{self.name} down"))
            else:
                self.handled += 1
                f.set_result(value())

        threading.Thread(target=run, daemon=True).start()
        return f

    def submit(self, x):
        return self._run(Future(), lambda: int(np.sum(x)) % 10)

    def submit_many(self, x):
        return self._run(Future(), lambda: np.asarray(
            [int(np.sum(r)) % 10 for r in x], np.int32))


def test_frontend_round_robin_fanout():
    servers = [FakeServer(f"h{i}") for i in range(3)]
    fe = Frontend([BackendHandle(s.name, s) for s in servers],
                  heartbeat_s=10.0)
    try:
        results = [fe.classify(np.full((4,), i), 10) for i in range(12)]
        assert all(isinstance(r, int) for r in results)
        assert all(s.handled == 4 for s in servers)
    finally:
        fe.stop()


def test_frontend_submit_many_and_failover():
    good, bad = FakeServer("good"), FakeServer("bad", fail=True)
    fe = Frontend([BackendHandle("good", good), BackendHandle("bad", bad)],
                  heartbeat_s=10.0)
    try:
        xs = np.stack([np.full((4,), i) for i in range(6)])
        np.testing.assert_array_equal(fe.submit_many(xs).result(10),
                                      [int(np.sum(r)) % 10 for r in xs])
        results = [fe.classify(np.full((4,), i), 10) for i in range(8)]
        assert len(results) == 8 and good.handled >= 8
        assert not fe.backends[1].healthy
    finally:
        fe.stop()


def test_frontend_heartbeat_recovers_and_all_down_raises():
    state = {"ok": False}

    def probe():
        if not state["ok"]:
            raise RuntimeError("not yet")

    h = BackendHandle("flaky", FakeServer("flaky"), probe=probe)
    h.healthy = False
    fe = Frontend([BackendHandle("good", FakeServer("good")), h],
                  heartbeat_s=0.05)
    try:
        assert fe.healthy_backends() == ["good"]
        state["ok"] = True
        deadline = time.time() + 10
        while len(fe.healthy_backends()) < 2 and time.time() < deadline:
            time.sleep(0.05)
        assert set(fe.healthy_backends()) == {"good", "flaky"}
    finally:
        fe.stop()
    down = BackendHandle("bad", FakeServer("bad", fail=True))
    down.healthy = False
    fe = Frontend([down], heartbeat_s=10.0)
    try:
        with pytest.raises(RuntimeError):
            fe.classify(np.zeros(4), 5)
    finally:
        fe.stop()


def test_http_backend_backpressure():
    hb = HttpBackend("http://127.0.0.1:9", max_workers=1, max_pending=1,
                     timeout_s=1.0)
    try:
        hb._pending.acquire()            # the one slot is taken
        f = hb.submit(np.zeros((4,), np.uint8))
        with pytest.raises(BackpressureError):
            f.result(5)
        with pytest.raises(ValueError):
            HttpBackend("https://127.0.0.1:9")
    finally:
        hb.close()


def test_frontend_http_failover_mid_stream(tmp_path):
    """Two port HTTP servers behind a Frontend; one is shut down mid-stream;
    every request completes on the survivor with JAX's classes, and the
    heartbeat marks the dead one unhealthy."""
    (path, compiled), = _mini_artifacts(tmp_path, 33)
    servers = [serve(path, device="cpu", port=0, block=False)
               for _ in range(2)]
    backends = []
    fe = None
    try:
        for name, (httpd, _) in zip("ab", servers):
            hb = HttpBackend(f"http://127.0.0.1:{httpd.server_address[1]}")
            backends.append(hb)
        fe = Frontend([BackendHandle(n, hb, probe=hb.probe)
                       for n, hb in zip("ab", backends)],
                      heartbeat_s=0.1, max_retries=3)
        imgs = _images((24, 10, 10, 3), 5)
        expected = JaxEngine(compiled, runtime="ref").classify(imgs)
        got = [f.result(30) for f in [fe.submit(imgs[i]) for i in range(8)]]
        _stop(*servers[1])
        got += [f.result(30)
                for f in [fe.submit(imgs[i]) for i in range(8, 24)]]
        np.testing.assert_array_equal(np.asarray(got), expected)
        deadline = time.time() + 10
        while fe.backends[1].healthy and time.time() < deadline:
            time.sleep(0.05)
        assert fe.healthy_backends() == ["a"]
    finally:
        if fe is not None:
            fe.stop()
        for hb in backends:
            hb.close()
        for s in servers:
            _stop(*s)


def test_frontend_reload_all(tmp_path):
    (a1, c1), (a2, c2) = _mini_artifacts(tmp_path, 60, 61)
    servers = [serve(a1, device="cpu", port=0, block=False)
               for _ in range(2)]
    backends = [HttpBackend(f"http://127.0.0.1:{h.server_address[1]}")
                for h, _ in servers]
    fe = Frontend([BackendHandle(f"b{i}", hb, probe=hb.probe)
                   for i, hb in enumerate(backends)], heartbeat_s=5.0)
    try:
        imgs = _images((4, 10, 10, 3), 62)
        want1 = JaxEngine(c1, runtime="ref").classify(imgs)
        want2 = JaxEngine(c2, runtime="ref").classify(imgs)
        assert not np.array_equal(want1, want2)
        np.testing.assert_array_equal(fe.submit_many(imgs).result(60), want1)
        out = fe.reload_all(open(a2, "rb").read())
        assert all(r.get("reloaded") == c2.config.name
                   for r in out.values()), out
        for hb in backends:
            np.testing.assert_array_equal(hb.submit_many(imgs).result(60),
                                          want2)
        assert backends[0].stats()["requests"] >= 1
    finally:
        fe.stop()
        for hb in backends:
            hb.close()
        for s in servers:
            _stop(*s)


# -- fault 3: the server's upload stage ------------------------------------

def test_upload_pipeline_answers_as_classify():
    """68 requests (64 single, 4 of 16) through a server with the upload
    stage: each answer is engine.classify's."""
    eng = InferenceEngine.from_artifact(SFC, device="cpu",
                                        batch_buckets=(16, 64))
    x = eng.prepare(_images((128, 28, 28), 27))
    want = eng.classify(x, prepared=True)
    launches = []
    launch_prepared = eng.launch_prepared
    eng.launch_prepared = lambda xd, **kw: launches.append(
        threading.current_thread().name) or launch_prepared(xd, **kw)
    server = BatchingServer(eng, max_batch=64, max_wait_ms=2.0,
                            upload_pipeline=True)
    try:
        assert server.upload_pipeline and server.packed_transport
        singles = [server.submit(x[i]) for i in range(64)]
        groups = [server.submit_many(x[64 + 16 * j:80 + 16 * j])
                  for j in range(4)]
        got = np.array([f.result(30) for f in singles])
        got_many = np.concatenate([f.result(30) for f in groups])
    finally:
        server.stop()
    np.testing.assert_array_equal(got, want[:64])
    np.testing.assert_array_equal(got_many, want[64:])
    assert launches and server._uploader.name in set(launches)
    assert server.stats.requests == 68


@pytest.mark.parametrize("name,shape", [("cnv-w1a1", (6, 32, 32, 3)),
                                        ("sfc-w1a1", (6, 28, 28))])
def test_upload_pipeline_logits_and_codes(name, shape):
    """int8 images (CNV) and packed words (SFC) through the upload stage;
    logits as engine.logits."""
    path = _art(name)
    eng = InferenceEngine.from_artifact(path, device="cpu",
                                        batch_buckets=(8,))
    x = eng.prepare(_images(shape, 28))
    want = eng.logits(x, prepared=True)
    server = BatchingServer(eng, max_batch=8, max_wait_ms=5.0,
                            return_logits=True, upload_pipeline=True)
    try:
        assert server.upload_pipeline
        got = server.submit_many(x).result(60)
    finally:
        server.stop()
    np.testing.assert_array_equal(got, want)


def test_upload_pipeline_turns_itself_off():
    class Minimal:
        def classify(self, x, prepared=True):
            return np.zeros(len(x), np.int32)

        def logits_device(self, x, prepared=True, argmax=True):
            return np.zeros(len(x), np.int32), len(x)

        def fetch(self, out):
            return np.asarray(out)

    # no upload/launch split, or no pipelined mode: the stage stays off
    sfc = InferenceEngine.from_artifact(SFC, device="cpu")
    for engine, depth in ((Minimal(), 2), (sfc, 1)):
        server = BatchingServer(engine, pipeline_depth=depth,
                                upload_pipeline=True)
        try:
            assert not server.upload_pipeline
            server.submit(np.ones(784, np.int8)).result(30)
        finally:
            server.stop()


class _SlowEngine:
    """The engine's upload/launch split with a slow upload: batches pile up
    in the upload queue, so stop() finds accepted, unlaunched batches."""

    def __init__(self):
        self.uploads = 0

    def _pad_to_bucket(self, x):
        return x, len(x)

    def upload(self, x):
        self.uploads += 1
        time.sleep(0.05)
        return torch.from_numpy(np.ascontiguousarray(x))

    def launch_prepared(self, xd, *, argmax=False, words=False):
        return xd.reshape(len(xd), -1)[:, 0].to(torch.int32)

    def logits_device(self, x, prepared=True, argmax=True):
        raise AssertionError("the upload stage launches")

    def fetch(self, out):
        return out.numpy()

    def classify(self, x, prepared=True):
        raise AssertionError("the upload stage launches")


def test_upload_pipeline_stop_under_load_strands_no_future():
    """stop() while batches wait for the uploader: every accepted request
    is answered with its result, none is left pending."""
    eng = _SlowEngine()
    server = BatchingServer(eng, max_batch=2, max_wait_ms=0.5,
                            upload_pipeline=True)
    futs = [server.submit(np.full(3, i % 100, np.int8)) for i in range(40)]
    time.sleep(0.1)
    server.stop()
    assert all(f.done() for f in futs)
    answered = [f for f in futs if f.exception() is None]
    for i, f in enumerate(futs):
        if f.exception() is None:
            assert f.result() == i % 100
        else:
            assert "stopped" in str(f.exception())
    assert len(answered) >= eng.uploads >= 3
    assert server.submit(np.zeros(3, np.int8)).exception(1) is not None


# -- the CLI -----------------------------------------------------------------

@pytest.mark.parametrize("argv", [["info"], ["info", "cnv-w2a2"],
                                  ["info", "lfc-w1a2"]])
def test_cli_info_equals_jax(argv, capsys):
    jax_cli.main(argv)
    want = capsys.readouterr().out
    cli.main(argv)
    assert capsys.readouterr().out == want


@pytest.mark.parametrize("name,shape", [("sfc-w1a1", (3, 28, 28, 1)),
                                        ("cnv-w1a1", (2, 32, 32, 3))])
def test_cli_classify_equals_jax(name, shape, tmp_path, capsys):
    path = _art(name)
    img_path = str(tmp_path / "imgs.npy")
    np.save(img_path, _images(shape, 29))
    jax_cli.main(["classify", path, img_path, "--runtime", "ref"])
    want = capsys.readouterr().out.splitlines()
    cli.main(["classify", path, img_path, "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert got[:-1] == want[:-1] and len(got) == shape[0] + 1
    assert got[-1].startswith("usecPerImage: ")


def test_cli_eval_equals_jax(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("BNN_DATA_DIR", str(tmp_path / "nodata"))
    monkeypatch.chdir(tmp_path)
    jax_cli.main(["eval", SFC, "--runtime", "ref", "--gate"])
    want = json.loads(capsys.readouterr().out)
    cli.main(["eval", SFC, "--device", "cpu", "--gate"])
    got = json.loads(capsys.readouterr().out)
    assert got == want and got["synthetic_data"] is True
    assert got["gate"] == "skipped (synthetic data)"


def test_cli_eval_gate_fails_on_real_data(tmp_path, capsys, monkeypatch):
    rng = np.random.default_rng(0)
    np.savez(tmp_path / "mnist.npz",
             x_train=rng.integers(0, 256, size=(4, 28, 28, 1)).astype(
                 np.uint8),
             y_train=np.zeros(4, np.int32),
             x_test=rng.integers(0, 256, size=(32, 28, 28, 1)).astype(
                 np.uint8),
             y_test=rng.integers(0, 10, size=32).astype(np.int32))
    monkeypatch.setenv("BNN_DATA_DIR", str(tmp_path))
    with pytest.raises(SystemExit):
        cli.main(["eval", SFC, "--device", "cpu", "--gate", "--batch", "16"])
    out = json.loads(capsys.readouterr().out)
    assert out["gate"] == "FAILED" and out["n_test"] == 32


@pytest.mark.parametrize("extra", [[], ["--classify", "--route", "s2d"],
                                   ["--runtime", "ref"]])
def test_cli_bench_prints_jax_keys(extra, capsys):
    cli.main(["bench", SFC, "--device", "cpu", "--batch", "16", "--iters",
              "2"] + extra)
    out = json.loads(capsys.readouterr().out)
    for key in ("network", "batch", "route", "path", "ms_per_batch",
                "images_per_sec", "usec_per_image"):
        assert key in out
    assert out["network"] == "sfc-w1a1" and out["batch"] == 16
    assert out["device"] == "cpu" and out["images_per_sec"] > 0
    assert out["path"] == ("classify" if "--classify" in extra else "logits")


def test_cli_takes_every_jax_route_and_no_cuda_fallback(capsys):
    for route in ("s2d", "xla", "xlaconv", "fused", "mega", "vpu", "mxu",
                  "mxu_rm", "direct"):
        cli.main(["bench", SFC, "--device", "cpu", "--batch", "2",
                  "--iters", "1", "--route", route])
        assert json.loads(capsys.readouterr().out)["route"] == route
    with pytest.raises(SystemExit):
        cli.main(["bench", SFC, "--route", "bogus"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["bench", SFC])          # --device cuda by default


def test_cli_reload_roundtrip(tmp_path, capsys):
    (a1, c1), (a2, c2) = _mini_artifacts(tmp_path, 70, 71)
    httpd, batcher = serve(a1, device="cpu", port=0, block=False)
    try:
        port = httpd.server_address[1]
        cli.main(["reload", a2, "--url", f"http://127.0.0.1:{port}"])
        assert json.loads(capsys.readouterr().out) == \
            {"reloaded": c2.config.name}
        imgs = _images((3, 10, 10, 3), 72)
        code, body = _http(port, "/classify", _npz(imgs))
        assert code == 200
        np.testing.assert_array_equal(
            json.loads(body)["classes"],
            JaxEngine(c2, runtime="ref").classify(imgs))
    finally:
        _stop(httpd, batcher)
