"""HTTP endpoint over the continuous-batching server: one per host; a
`runtime/frontend.Frontend` or any load balancer fans requests out.

    python -m bnn_pynq_tpu_torch.runtime.http_server pretrained/cnv-w1a1.npz

Port of `bnn_pynq_tpu/runtime/http_server.py`; the protocol is unchanged
(stdlib only on both sides):
  POST /classify   body = npz bytes with array 'x' (uint8 image batch)
                   → JSON {"classes": [...], "names": [...]}
  POST /reload     body = npz artifact bytes → hot-swaps the live engine's
                   parameters (queued and in-flight batches keep the old
                   ones, later batches get the new); 409 on a topology
                   mismatch.
  GET  /healthz    → 200 "ok" (the Frontend heartbeat probe)
  GET  /stats      → JSON batching stats
Once the batching server is stopped, /healthz and every POST answer 503.
"""

from __future__ import annotations

import io
import json
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from bnn_pynq_tpu_torch.compiler.artifacts import load_artifact
from bnn_pynq_tpu_torch.runtime.classifier import Classifier
from bnn_pynq_tpu_torch.runtime.engine import DEFAULT_BATCH_BUCKETS
from bnn_pynq_tpu_torch.runtime.serving import BatchingServer


def make_handler(classifier: Classifier, server: BatchingServer):
    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 with Content-Length on every response: keep-alive, so
        # HttpBackend's per-worker connections are reused
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            pass

        def _send(self, code: int, body: bytes,
                  ctype: str = "application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body(self) -> bytes:
            return self.rfile.read(int(self.headers.get("Content-Length",
                                                        "0")))

        def do_GET(self):
            if self.path == "/healthz":
                # a stopping server fails its health check even on an open
                # keep-alive connection, so that failover starts
                if server.stopped:
                    self.close_connection = True
                    self._send(503, b"stopping", "text/plain")
                    return
                self._send(200, b"ok", "text/plain")
            elif self.path == "/stats":
                self._send(200, json.dumps(
                    server.stats.summary()).encode())
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path not in ("/classify", "/reload"):
                self._send(404, b"not found", "text/plain")
                return
            if server.stopped:
                self.close_connection = True
                self._send(503, json.dumps(
                    {"error": "server stopped"}).encode())
                return
            if self.path == "/reload":
                try:
                    compiled = load_artifact(io.BytesIO(self._body()))
                    classifier.engine.load_parameters(compiled)
                    self._send(200, json.dumps(
                        {"reloaded": compiled.config.name}).encode())
                except ValueError as e:       # topology mismatch
                    self._send(409, json.dumps({"error": str(e)}).encode())
                except Exception as e:  # noqa: BLE001 — answered as a 400
                    self._send(400, json.dumps({"error": str(e)}).encode())
                return
            try:
                data = np.load(io.BytesIO(self._body()), allow_pickle=False)
                prepared = classifier.engine.prepare(
                    classifier._to_batch(data["x"]))
                # one POST = one multi-image request: one queue entry
                classes = [int(c) for c in
                           server.submit_many(prepared).result(60)]
                self._send(200, json.dumps({
                    "classes": classes,
                    "names": [classifier.class_name(c) for c in classes],
                }).encode())
            except Exception as e:  # noqa: BLE001 — answered as a 400
                self._send(400, json.dumps({"error": str(e)}).encode())

    return Handler


def serve(artifact: str, host: str = "127.0.0.1", port: int = 8476, *,
          device="cuda", runtime: str = "kernels", route: str = "mega",
          block: bool = True, warmup: bool = True, max_batch: int = 256,
          max_wait_ms: float = 3.0, batch_buckets=None):
    """Serve `artifact` over HTTP. block=False returns (httpd, batcher)
    with the server running on a daemon thread (port=0: an ephemeral port,
    `httpd.server_address[1]`); the caller stops both. warmup runs, before
    the server accepts traffic, every bucket a batch can pad to: each one
    up to max_batch and the one a full batch of max_batch pads to (a
    'kernels' engine captures its programs there, never under load)."""
    clf = Classifier.from_artifact(
        artifact, device=device, runtime=runtime, route=route,
        batch_buckets=tuple(batch_buckets or DEFAULT_BATCH_BUCKETS))
    batcher = BatchingServer(clf.engine, max_batch=max_batch,
                             max_wait_ms=max_wait_ms)
    try:
        if warmup:
            eng = clf.engine
            full = eng._bucket(batcher.max_batch)
            for b in sorted({b for b in eng.batch_buckets
                             if b <= batcher.max_batch} | {full}):
                eng.warmup(b)
        httpd = ThreadingHTTPServer((host, port), make_handler(clf, batcher))
    except BaseException:
        batcher.stop()
        raise
    if not block:
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        return httpd, batcher
    print(f"serving {clf.config.name} on http://{host}:"
          f"{httpd.server_address[1]}", flush=True)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        batcher.stop()


if __name__ == "__main__":
    serve(sys.argv[1] if len(sys.argv) > 1 else "pretrained/cnv-w1a1.npz",
          port=int(sys.argv[2]) if len(sys.argv) > 2 else 8476)
