"""Continuous-batching classification server.

Port of `bnn_pynq_tpu/runtime/serving.py::BatchingServer`. Requests
enqueue individually; a dispatcher thread drains the queue into batches of
up to `max_batch` images (waiting at most `max_wait_ms` for stragglers),
runs the engine once per batch and resolves per-request futures. With
`pipeline_depth` >= 2 a collector thread fetches batch t while the
dispatcher launches batch t+1.

Packed transport: when the engine has `words_device` and its network
takes bipolar input (the MLPs), the dispatcher packs each batch's sign
bits into uint32 words on the host (`native.pack_bits`) and launches
through `engine.words_device`, which unpacks them on the device: 32×
fewer bytes host→device than int8 values. It needs the pipelined mode.

Upload stage (`upload_pipeline=True`, off by default as in JAX): the
dispatcher only packs and pads each batch; an uploader thread, two
batches ahead at most, copies it to the device (`engine.upload`) and
launches it (`engine.launch_prepared`); the collector fetches. It needs
the engine's upload/launch split and turns itself off without it.

Changes from the JAX version: results are fetched through
`engine.fetch(dev_out)` (a CUDA tensor does not go through `np.asarray`)
and the busy counter is guarded by a lock.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Deque, List, Optional

import numpy as np

from bnn_pynq_tpu_torch import native

# Latency samples kept for percentile estimation: bounded, so a long-lived
# server does not grow its stats without limit.
STATS_WINDOW = 65536


@dataclass
class ServerStats:
    requests: int = 0
    images: int = 0
    batches: int = 0
    latencies_ms: Deque[float] = field(
        default_factory=lambda: deque(maxlen=STATS_WINDOW))

    def percentile(self, p: float) -> float:
        if not self.latencies_ms:
            return float("nan")
        return float(np.percentile(np.fromiter(self.latencies_ms, float), p))

    def summary(self) -> dict:
        return {
            "requests": self.requests,
            "images": self.images,
            "batches": self.batches,
            "mean_batch": self.images / max(1, self.batches),
            "p50_ms": self.percentile(50),
            "p99_ms": self.percentile(99),
        }


class _Request:
    __slots__ = ("x", "n", "future", "t_enqueue")

    def __init__(self, x, n=0):
        self.x = x
        self.n = n                     # 0 = single image (no batch dim)
        self.future: Future = Future()
        self.t_enqueue = time.perf_counter()

    @property
    def n_images(self) -> int:
        return self.n if self.n else 1


class BatchingServer:
    """Continuous batching over an InferenceEngine (or any object with
    `classify(x, prepared=True)` / `logits`; `logits_device` + `fetch`
    enable the pipelined mode)."""

    def __init__(self, engine, max_batch: int = 256,
                 max_wait_ms: float = 2.0, return_logits: bool = False,
                 pipeline_depth: int = 2, adaptive_wait: bool = True,
                 upload_pipeline: bool = False):
        """pipeline_depth: batches in flight at once (1 = synchronous).

        upload_pipeline: {upload ∥ launch ∥ fetch} in three threads; needs
        the pipelined mode and the engine's `upload`, `launch_prepared`
        and `_pad_to_bucket`, else it is off.

        adaptive_wait: when no batch is in flight, the queue is empty and
        nothing was dispatched within the last max_wait, a lone request is
        sent at once instead of waiting max_wait for stragglers; under load
        batches still grow to max_batch."""
        self.engine = engine
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self.return_logits = return_logits
        self.adaptive_wait = adaptive_wait
        self.pipeline_depth = (
            pipeline_depth if hasattr(engine, "logits_device")
            and hasattr(engine, "fetch") else 1)
        # bipolar (MLP) engines: host-packed words, unpacked on the device
        self.packed_transport = bool(
            self.pipeline_depth > 1
            and getattr(getattr(engine, "config", None), "input_kind",
                        None) == "bipolar"
            and hasattr(engine, "words_device"))
        self.stats = ServerStats()
        self._q: "queue.Queue[Optional[_Request]]" = queue.Queue()
        # one-slot carry-over: a request _collect could not fit without
        # pushing the batch past max_batch (dispatcher-thread-only state)
        self._carry: Optional[_Request] = None
        # batches launched but not yet resolved — the adaptive_wait "device
        # idle" signal; updated from two threads, so under a lock
        self._busy = 0
        self._busy_lock = threading.Lock()
        self._last_dispatch = 0.0
        self._stop = threading.Event()
        self.upload_pipeline = bool(
            upload_pipeline and self.pipeline_depth > 1
            and hasattr(engine, "upload")
            and hasattr(engine, "launch_prepared")
            and hasattr(engine, "_pad_to_bucket"))
        if self.pipeline_depth > 1:
            self._inflight: "queue.Queue" = queue.Queue(
                maxsize=self.pipeline_depth - 1)
            self._collector = threading.Thread(target=self._collect_loop,
                                               daemon=True)
            self._collector.start()
        if self.upload_pipeline:
            # at most two padded batches queued ahead of the uploader
            self._upload_q: "queue.Queue" = queue.Queue(maxsize=2)
            self._uploader = threading.Thread(target=self._upload_loop,
                                              daemon=True)
            self._uploader.start()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # -- client API -------------------------------------------------------
    def submit(self, x_prepared: np.ndarray) -> Future:
        """Enqueue ONE prepared input (no batch dim); resolves to the class
        index (or logits). After stop(), resolves at once with an error."""
        req = _Request(np.asarray(x_prepared))
        if self._stop.is_set():
            req.future.set_exception(RuntimeError("server stopped"))
            return req.future
        self._q.put(req)
        return req.future

    def submit_many(self, x_prepared: np.ndarray) -> Future:
        """Enqueue a multi-image request (leading batch dim k >= 1); one
        future resolving to the k class indices (or logits). Requests
        larger than max_batch are split into max_batch chunks."""
        x = np.asarray(x_prepared)
        if x.ndim == 0 or len(x) == 0:
            raise ValueError("submit_many needs a leading batch dim")
        if self._stop.is_set():
            f: Future = Future()
            f.set_exception(RuntimeError("server stopped"))
            return f
        if len(x) <= self.max_batch:
            req = _Request(x, n=len(x))
            self._q.put(req)
            return req.future
        chunks = [x[i:i + self.max_batch]
                  for i in range(0, len(x), self.max_batch)]
        inner = []
        for c in chunks:
            req = _Request(c, n=len(c))
            self._q.put(req)
            inner.append(req.future)
        outer: Future = Future()
        remaining = [len(inner)]
        lock = threading.Lock()

        def on_done(fut):
            if outer.done():
                return
            err = fut.exception()
            if err is not None:
                outer.set_exception(err)
                return
            with lock:
                remaining[0] -= 1
                last = remaining[0] == 0
            if last:
                outer.set_result(np.concatenate(
                    [np.asarray(f.result()) for f in inner]))

        for f in inner:
            f.add_done_callback(on_done)
        return outer

    def classify(self, x_prepared: np.ndarray, timeout: float = 60.0):
        return self.submit(x_prepared).result(timeout)

    @property
    def stopped(self) -> bool:
        return self._stop.is_set()

    def stop(self):
        self._stop.set()
        self._q.put(None)
        self._thread.join(timeout=10)
        if self.upload_pipeline:
            try:
                self._upload_q.put(None, timeout=5)
            except queue.Full:
                pass
            self._uploader.join(timeout=30)
            # run the accepted batches that were never uploaded, so that
            # their requests get answers, not "server stopped"
            try:
                while True:
                    item = self._upload_q.get_nowait()
                    if item is None:
                        continue
                    batch, padded, b = item
                    try:
                        outs = self.engine.fetch(self._launch(padded))[:b]
                    except Exception as e:
                        self._fail(batch, e)
                        continue
                    self._resolve(batch, outs)
            except queue.Empty:
                pass
        if self.pipeline_depth > 1:
            # drop the sentinel rather than deadlock if the collector is
            # wedged inside a device fetch (it is a daemon thread)
            try:
                self._inflight.put(None, timeout=5)
            except queue.Full:
                pass
            self._collector.join(timeout=30)
            # the dispatcher's final put can land after the sentinel, so
            # resolve what is still in flight here
            try:
                while True:
                    item = self._inflight.get_nowait()
                    if item is None:
                        continue
                    batch, dev_out, b = item
                    try:
                        outs = self.engine.fetch(dev_out)[:b]
                    except Exception as e:
                        self._fail(batch, e)
                        continue
                    self._resolve(batch, outs)
            except queue.Empty:
                pass
        # fail anything still queued so no future is stranded
        if self._carry is not None:
            if not self._carry.future.done():
                self._carry.future.set_exception(
                    RuntimeError("server stopped"))
            self._carry = None
        try:
            while True:
                r = self._q.get_nowait()
                if r is not None and not r.future.done():
                    r.future.set_exception(RuntimeError("server stopped"))
        except queue.Empty:
            pass

    # -- dispatcher -------------------------------------------------------
    def _add_busy(self, delta: int) -> None:
        with self._busy_lock:
            self._busy += delta

    def _try_add(self, batch: List[_Request], n_imgs: int, r: _Request):
        """Append r unless it would push the batch past max_batch; an
        overflowing request goes to the carry-over slot. Returns the new
        image count, or None when r was carried (collection stops)."""
        if n_imgs + r.n_images > self.max_batch:
            self._carry = r
            return None
        batch.append(r)
        return n_imgs + r.n_images

    def _downstream_full(self) -> bool:
        if self.upload_pipeline and self._upload_q.full():
            return True
        return self.pipeline_depth > 1 and self._inflight.full()

    def _collect(self) -> List[_Request]:
        if self._carry is not None:
            first, self._carry = self._carry, None
        else:
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                return []
            if first is None:
                return []
        batch = [first]
        n_imgs = first.n_images
        deadline = time.perf_counter() + self.max_wait_s
        while n_imgs < self.max_batch:
            if self.adaptive_wait and self._busy == 0 and self._q.empty() \
                    and time.perf_counter() - self._last_dispatch \
                    >= self.max_wait_s:
                break
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                if self.adaptive_wait and self._downstream_full():
                    # every pipeline slot is busy: keep growing the batch
                    deadline = time.perf_counter() + self.max_wait_s
                    continue
                try:
                    while n_imgs < self.max_batch:
                        r = self._q.get_nowait()
                        if r is None:
                            return batch
                        n_imgs = self._try_add(batch, n_imgs, r)
                        if n_imgs is None:
                            return batch
                except queue.Empty:
                    pass
                break
            try:
                r = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if r is None:
                break
            n_imgs = self._try_add(batch, n_imgs, r)
            if n_imgs is None:
                break
        return batch

    def _resolve(self, batch, outs):
        now = time.perf_counter()
        off = 0
        for r in batch:
            k = r.n_images
            # a cancelled future raises on set_result; skip it
            if not r.future.done():
                r.future.set_result(outs[off:off + k] if r.n else outs[off])
            off += k
            self.stats.latencies_ms.append((now - r.t_enqueue) * 1e3)
        self.stats.requests += len(batch)
        self.stats.images += off
        self.stats.batches += 1
        self._add_busy(-1)

    def _fail(self, batch, err):
        """Resolve every live future in batch with err (cancel-safe)."""
        for r in batch:
            if not r.future.done():
                r.future.set_exception(err)
        self._add_busy(-1)

    def _put_bounded(self, q, item) -> bool:
        """Bounded put attempts that cannot deadlock shutdown; on stop one
        final attempt (stop() drains the queue after joining)."""
        while not self._stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        try:
            q.put(item, timeout=0.5)
            return True
        except queue.Full:
            return False

    def _launch(self, padded: np.ndarray):
        """Upload a padded batch and launch it; the device output."""
        return self.engine.launch_prepared(
            self.engine.upload(padded), argmax=not self.return_logits,
            words=self.packed_transport)

    def _upload_loop(self):
        """Upload stage: copy the next padded batch to the device and
        launch it while the collector waits on earlier fetches."""
        while True:
            item = self._upload_q.get()
            if item is None:
                return
            batch, padded, b = item
            try:
                dev_out = self._launch(padded)
            except Exception as e:
                self._fail(batch, e)
                continue
            if not self._put_bounded(self._inflight, (batch, dev_out, b)):
                self._fail(batch, RuntimeError("server stopped"))

    def _collect_loop(self):
        """Pipelined fetch stage: waits on batch t's device→host fetch
        while the dispatcher launches t+1."""
        while True:
            item = self._inflight.get()
            if item is None:
                return
            batch, dev_out, b = item
            try:
                outs = self.engine.fetch(dev_out)[:b]
            except Exception as e:
                self._fail(batch, e)
                continue
            self._resolve(batch, outs)

    def _loop(self):
        while not self._stop.is_set():
            batch = self._collect()
            if not batch:
                continue
            xs = np.concatenate(
                [r.x if r.n else r.x[None] for r in batch])
            self._add_busy(1)
            self._last_dispatch = time.perf_counter()
            try:
                if self.upload_pipeline:
                    # host side only: pack and pad, then hand the batch to
                    # the uploader (copy + launch) → collector (fetch)
                    arr = xs
                    if self.packed_transport:
                        arr = native.pack_bits(xs.reshape(len(xs), -1))
                    padded, b = self.engine._pad_to_bucket(arr)
                    if not self._put_bounded(self._upload_q,
                                             (batch, padded, b)):
                        self._fail(batch, RuntimeError("server stopped"))
                    continue
                if self.pipeline_depth > 1:
                    if self.packed_transport:
                        dev_out, b = self.engine.words_device(
                            native.pack_bits(xs.reshape(len(xs), -1)),
                            argmax=not self.return_logits)
                    else:
                        dev_out, b = self.engine.logits_device(
                            xs, prepared=True, argmax=not self.return_logits)
                    if not self._put_bounded(self._inflight,
                                             (batch, dev_out, b)):
                        self._fail(batch, RuntimeError("server stopped"))
                    continue
                if self.return_logits:
                    outs = self.engine.logits(xs, prepared=True)
                else:
                    outs = self.engine.classify(xs, prepared=True)
            except Exception as e:  # resolve the batch's futures with it
                self._fail(batch, e)
                continue
            self._resolve(batch, outs)
