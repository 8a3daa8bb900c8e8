"""forward_device_ms: device time per forward in the traced slice: the
durations of every kernel, copy and set the profiler saw, summed, over
the forwards the harness launched in it."""


def read(rec):
    t = rec.trace
    if t is None or not t.device or not t.counts.get("forwards"):
        return None
    return sum(d for _, _, _, d in t.device) * 1e-3 / t.counts["forwards"]
