"""Traffic kind `open_loop`: independent clients whose requests arrive on
a schedule fixed before the window, whatever the server does, through
`BatchingServer` as the HTTP handler drives it after parsing:
`engine.prepare(x)`, then `server.submit_many(prepared)`.

Mix parameters:
- `rate_per_s`: the arrival rate; with `burst` ({"period_s", "on_s",
  "factor"}) the rate is `factor` times higher for the first `on_s` of
  every `period_s`;
- `sizes`: [[images per request, weight], ...];
- `pool_images`: distinct uint8 images made from the seed, from which
  each request draws its images;
- `route` and `server` (BatchingServer's arguments);
- `drain_s`: how long past the window's close answers are waited for.

The schedule is the same for every seed: the arrivals are the quantiles
of the exponential gaps of a Poisson process at the rate (so the count
of requests is fixed), put in an order drawn from the seed and mapped
through the rate's integral; the sizes are a fixed multiset in an order
drawn from the seed. Each request is timed from when it was due: its
latency counts the generator's own lateness and every stall before it.
A request that fails or is never answered counts as answered at the
moment the harness gave up on it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from functools import partial

import numpy as np
import torch


@dataclass
class Inputs:
    images: np.ndarray                # uint8 [N, H, W, C], host
    due: np.ndarray                   # float64 [R], s from the window start
    offsets: np.ndarray               # int64 [R + 1] into ids
    ids: np.ndarray                   # int64, rows of images by request


def rate_integral(params: dict, seconds: float):
    """(knots t, the rate's integral at t) over [0, seconds]: piecewise
    linear, so np.interp inverts it exactly."""
    rate = float(params["rate_per_s"])
    burst = params.get("burst")
    if not burst:
        return np.array([0.0, seconds]), np.array([0.0, rate * seconds])
    period, on, factor = burst["period_s"], burst["on_s"], burst["factor"]
    ts = [0.0]
    t = 0.0
    while t < seconds:
        ts += [min(t + on, seconds), min(t + period, seconds)]
        t += period
    ts = np.array(ts)
    hi = ((ts[:-1] % period) < on - 1e-12)
    rates = np.where(hi, rate * factor, rate)
    lam = np.concatenate([[0.0], np.cumsum(rates * np.diff(ts))])
    return ts, lam


def schedule(params: dict, seconds: float, rng: np.random.Generator):
    """(due times [R], sizes [R]) for one window."""
    ts, lam = rate_integral(params, seconds)
    total = lam[-1]
    n = max(1, int(round(total)))
    q = (np.arange(n) + 0.5) / n
    gaps = rng.permutation(-np.log1p(-q))
    u = np.cumsum(gaps)
    u *= total / u[-1]
    due = np.interp(u, lam, ts)
    values = np.array([s for s, _ in params["sizes"]], dtype=np.int64)
    weights = np.array([w for _, w in params["sizes"]], dtype=np.float64)
    counts = np.floor(weights / weights.sum() * n).astype(np.int64)
    counts[np.argmax(weights)] += n - counts.sum()
    sizes = rng.permutation(np.repeat(values, counts))
    return due, sizes


def inputs(ctx) -> Inputs:
    p = ctx.params
    shape = (p["pool_images"],) + tuple(ctx.cell.config["input_shape"])
    imgs = torch.randint(0, 256, shape, dtype=torch.uint8,
                         device=ctx.device, generator=ctx.generator)
    due, sizes = schedule(p, ctx.seconds, ctx.rng)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    ids = ctx.rng.integers(0, p["pool_images"], size=int(offsets[-1]))
    return Inputs(imgs.cpu().numpy(), due, offsets, ids)


def setup(ctx, inp: Inputs):
    """The engine and the server, and the programs the server dispatches:
    the argmax variant of every bucket a batch of up to max_batch pads to
    (on the packed words for a bipolar net, as the server sends them)."""
    from bnn_pynq_tpu_torch import native
    from bnn_pynq_tpu_torch.runtime.engine import InferenceEngine
    from bnn_pynq_tpu_torch.runtime.serving import BatchingServer
    eng = InferenceEngine.from_artifact(ctx.artifact, device=ctx.device,
                                        route=ctx.params["route"])
    server = BatchingServer(eng, **ctx.params["server"])
    try:
        top = eng._bucket(server.max_batch)
        for b in sorted({b for b in eng.batch_buckets
                         if b <= server.max_batch} | {top}):
            x = eng.prepare(inp.images[:1].repeat(b, axis=0))
            if server.packed_transport:
                out, _ = eng.words_device(native.pack_bits(
                    x.reshape(b, -1)), argmax=True)
            else:
                out, _ = eng.logits_device(x, prepared=True, argmax=True)
            eng.fetch(out)
        if ctx.fault is not None:
            ctx.fault(eng)
    except BaseException:
        server.stop()
        raise
    return {"engine": eng, "server": server}


def _on_done(k: int, lo: int, hi: int, rec: dict, future) -> None:
    """A request's answer: its time, and its classes or its failure. Kept
    in preallocated arrays, so the window holds no future: the harness
    adds nothing to the heap that the program's garbage collections
    traverse."""
    rec["done"][k] = time.perf_counter()
    try:
        rec["served"][lo:hi] = np.asarray(future.result()).reshape(-1)
    except Exception:   # a failed request misses every limit
        rec["failed"][k] = True


def window(state, inp: Inputs, ctx, tr):
    from portbench.harness import Window
    eng, server = state["engine"], state["server"]
    prepare, submit = eng.prepare, server.submit_many
    images, ids, off, due = inp.images, inp.ids, inp.offsets, inp.due
    n = len(due)
    sent = np.zeros(n)
    rec = {"done": np.full(n, np.nan), "failed": np.zeros(n, bool),
           "served": np.full(int(off[-1]), -1, np.int64)}
    images0, batches0 = server.stats.images, server.stats.batches
    slice_at = ctx.seconds - tr.slice_s
    t0 = tr.start_window()
    for k in range(n):
        wait = t0 + due[k] - time.perf_counter()
        if wait > 0:
            with tr.span("pb.wait"):
                time.sleep(wait)
        if tr.enabled and due[k] >= slice_at:
            tr.begin_slice()
        lo, hi = int(off[k]), int(off[k + 1])
        sent[k] = time.perf_counter()
        with tr.span("pb.send"):
            f = submit(prepare(images[ids[lo:hi]]))
        f.add_done_callback(partial(_on_done, k, lo, hi, rec))
        tr.count("requests")
        tr.count("images", hi - lo)
    del f
    tr.end_slice()
    give_up = t0 + ctx.seconds + ctx.params["drain_s"]
    done = rec["done"]
    while np.isnan(done).any() and time.perf_counter() < give_up:
        time.sleep(0.005)
    never = np.isnan(done)
    missed = never | rec["failed"]
    done[never] = max(give_up, time.perf_counter())
    sizes = np.diff(off)
    failed = int(sizes[missed].sum())
    answered = int(off[-1]) - failed
    # the collector counts a batch just after it resolves its futures
    limit = time.perf_counter() + 1.0
    while server.stats.images - images0 < answered and \
            time.perf_counter() < limit:
        time.sleep(0.001)
    keep = np.repeat(~missed, sizes)
    answers = [(ids[keep], rec["served"][keep])] if keep.any() else []
    return Window(
        seconds=ctx.seconds, images=answered, attempted=int(off[-1]),
        failed=failed, answers=answers,
        latencies_ms=(done - (t0 + due)) * 1e3,
        lag_ms=(sent - (t0 + due)) * 1e3,
        counters={"server_images": server.stats.images - images0,
                  "server_batches": server.stats.batches - batches0})


def release(state) -> None:
    server = state.pop("server", None)
    if server is not None:
        server.stop()
    state.clear()


def reference_inputs(inp: Inputs) -> torch.Tensor:
    return torch.from_numpy(inp.images)
