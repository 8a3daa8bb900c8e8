"""Multi-host serving front end: request fan-out and failure re-dispatch.

Copied from `bnn_pynq_tpu/runtime/frontend.py`, which is framework-neutral
(numpy and the standard library): the port never imports the JAX package.

A `Frontend` owns several backends (one per host: in one process these are
BatchingServer instances; across hosts `HttpBackend`s over
`runtime/http_server.py`). Requests round-robin over healthy backends; a
heartbeat probe marks backends unhealthy, and requests in flight on a
failed backend are re-dispatched to the survivors.
"""

from __future__ import annotations

import itertools
import threading
import time
from concurrent.futures import Future
from typing import Callable, List, Optional, Sequence

import numpy as np


class BackendHandle:
    """A serving backend with liveness state."""

    def __init__(self, name: str, server, probe: Optional[Callable] = None):
        self.name = name
        self.server = server
        self.probe = probe
        self.healthy = True

    def check(self) -> bool:
        try:
            if self.probe is not None:
                self.probe()
            self.healthy = True
        except Exception:
            self.healthy = False
        return self.healthy


class BackpressureError(RuntimeError):
    """Raised (via the Future) when a backend's pending-request budget is
    exhausted; the Frontend treats it like any failure and re-dispatches
    to another healthy backend."""


class HttpBackend:
    """Adapter: a remote `http_server` endpoint as a Frontend backend.

    `submit(x)` POSTs one raw uint8 image to /classify (the server
    prepares it) and resolves the Future with the class index;
    `probe()` GETs /healthz (wire this as the BackendHandle probe).
    Standard library only on the client side.

    For continuous-batching load: a bounded worker pool (`max_workers`
    threads, not one thread per request) with per-thread persistent HTTP
    connections (keep-alive), and explicit backpressure — at most
    `max_pending` requests queued or in flight; beyond that `submit`
    resolves the Future at once with `BackpressureError`, so that the
    caller (Frontend) can shed to another backend instead of queueing
    without bound.
    """

    def __init__(self, base_url: str, timeout_s: float = 30.0,
                 max_workers: int = 8, max_pending: int = 256):
        from concurrent.futures import ThreadPoolExecutor
        from urllib.parse import urlsplit
        self.base_url = base_url.rstrip("/")
        parts = urlsplit(self.base_url)
        if parts.scheme != "http":
            raise ValueError(f"HttpBackend supports http:// URLs, got "
                             f"{self.base_url}")
        self._host = parts.hostname
        self._port = parts.port or 80
        self._path_prefix = parts.path.rstrip("/")
        self.timeout_s = timeout_s
        self.max_pending = max_pending
        self._pending = threading.BoundedSemaphore(max_pending)
        self._pool = ThreadPoolExecutor(
            max_workers=max_workers,
            thread_name_prefix=f"httpbackend-{self._host}:{self._port}")
        self._local = threading.local()

    # -- connection reuse --------------------------------------------------
    def _conn(self):
        import http.client
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = http.client.HTTPConnection(
                self._host, self._port, timeout=self.timeout_s)
            self._local.conn = conn
        return conn

    def _drop_conn(self):
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            try:
                conn.close()
            finally:
                self._local.conn = None

    def _request(self, method: str, path: str, body: bytes = None) -> bytes:
        """One request on this worker's persistent connection, with a
        single reconnect retry (the server may have closed an idle
        keep-alive connection between requests)."""
        import http.client
        for attempt in (0, 1):
            conn = self._conn()
            try:
                conn.request(method, self._path_prefix + path, body=body)
                resp = conn.getresponse()
                data = resp.read()
                if resp.status != 200:
                    raise RuntimeError(
                        f"HTTP {resp.status}: {data[:200]!r}")
                return data
            except (http.client.HTTPException, ConnectionError, OSError):
                self._drop_conn()
                if attempt:
                    raise
            except Exception:
                self._drop_conn()
                raise
        # unreachable today (attempt 1 always returns or raises), but an
        # edit to the except arms must never turn errors into an implicit
        # None return (json.loads(None) far from the cause)
        raise RuntimeError(f"{self.base_url}: request retry loop exhausted")

    def probe(self):
        self._request("GET", "/healthz")

    def reload(self, artifact_bytes: bytes) -> dict:
        """Hot-swap parameters on the remote host (POST /reload), with
        no downtime."""
        import json
        return json.loads(self._request("POST", "/reload", artifact_bytes))

    def stats(self) -> dict:
        import json
        pool_q = self._pool._work_queue.qsize()
        remote = json.loads(self._request("GET", "/stats"))
        return {"pending": self.max_pending - self._pending._value,
                "queued": pool_q, **remote}

    def _submit_array(self, batch: np.ndarray, single: bool) -> Future:
        import io
        import json

        f: Future = Future()
        if not self._pending.acquire(blocking=False):
            f.set_exception(BackpressureError(
                f"{self.base_url}: {self.max_pending} requests already "
                "pending"))
            return f
        buf = io.BytesIO()
        np.savez(buf, x=batch)
        body = buf.getvalue()

        def run():
            try:
                resp = json.loads(self._request("POST", "/classify", body))
                if "error" in resp:
                    raise RuntimeError(resp["error"])
                classes = resp["classes"]
                f.set_result(int(classes[0]) if single
                             else np.asarray(classes, np.int32))
            except Exception as e:  # noqa: BLE001 — Future carries it
                f.set_exception(e)
            finally:
                self._pending.release()

        self._pool.submit(run)
        return f

    def submit(self, x: np.ndarray) -> Future:
        return self._submit_array(np.asarray(x)[None], single=True)

    def submit_many(self, x: np.ndarray) -> Future:
        """One POST for a k-image batch; resolves to int32 [k] classes.
        The server side maps it to ONE multi-image BatchingServer
        request (serving.submit_many), so a remote client amortizes both
        the HTTP round trip and the per-request queue overhead."""
        x = np.asarray(x)
        if x.ndim == 0 or len(x) == 0:
            raise ValueError("submit_many needs a leading batch dim")
        return self._submit_array(x, single=False)

    def close(self):
        self._pool.shutdown(wait=False)


class Frontend:
    def __init__(self, backends: Sequence[BackendHandle],
                 heartbeat_s: float = 1.0, max_retries: int = 3):
        if not backends:
            raise ValueError("need at least one backend")
        self.backends = list(backends)
        self.max_retries = max_retries
        self._rr = itertools.count()
        self._stop = threading.Event()
        self._hb = threading.Thread(
            target=self._heartbeat_loop, args=(heartbeat_s,), daemon=True)
        self._hb.start()

    # -- dispatch ---------------------------------------------------------
    def _pick(self) -> BackendHandle:
        healthy = [b for b in self.backends if b.healthy]
        if not healthy:
            raise RuntimeError("no healthy backends")
        return healthy[next(self._rr) % len(healthy)]

    def submit(self, x: np.ndarray) -> Future:
        outer: Future = Future()
        self._dispatch(x, outer, tries=0)
        return outer

    def submit_many(self, x: np.ndarray) -> Future:
        """Batch request with the same failover semantics as submit():
        re-dispatched whole to another healthy backend on failure."""
        outer: Future = Future()
        self._dispatch(x, outer, tries=0, many=True)
        return outer

    def _dispatch(self, x, outer: Future, tries: int, many: bool = False):
        try:
            backend = self._pick()
        except RuntimeError as e:
            outer.set_exception(e)
            return
        inner = (backend.server.submit_many(x) if many
                 else backend.server.submit(x))

        def done(f: Future):
            err = f.exception()
            if err is None:
                if not outer.cancelled():
                    outer.set_result(f.result())
                return
            # backend failed mid-request: mark unhealthy, re-dispatch
            backend.healthy = False
            if tries + 1 >= self.max_retries:
                outer.set_exception(err)
            else:
                self._dispatch(x, outer, tries + 1, many=many)

        inner.add_done_callback(done)

    def classify(self, x: np.ndarray, timeout: float = 60.0):
        return self.submit(x).result(timeout)

    # -- liveness ---------------------------------------------------------
    def _heartbeat_loop(self, interval: float):
        while not self._stop.wait(interval):
            for b in self.backends:
                b.check()

    def healthy_backends(self) -> List[str]:
        return [b.name for b in self.backends if b.healthy]

    def reload_all(self, artifact_bytes: bytes) -> dict:
        """Roll new parameters across every healthy backend (the
        fleet-wide analogue of the reference's load_parameters, SURVEY
        §3.2): each host swaps live with zero downtime; traffic keeps
        flowing throughout. Returns {backend_name: result-or-error}."""
        results = {}
        for b in self.backends:
            if not b.healthy:
                results[b.name] = {"skipped": "unhealthy"}
                continue
            try:
                results[b.name] = b.server.reload(artifact_bytes)
            except Exception as e:  # noqa: BLE001 — report per-backend
                results[b.name] = {"error": str(e)[:200]}
        return results

    def stop(self):
        self._stop.set()
        self._hb.join(timeout=5)
