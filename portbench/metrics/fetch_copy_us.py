"""fetch_copy_us: host-clock us that `InferenceEngine.fetch` takes per
call: the total seconds of the program's span `bnn.engine.fetch` (the
wait for the device's queued work, then the copy of the output to host
memory) over its calls (spans record only while the traced slice's
profiler runs)."""


def read(rec):
    try:
        from bnn_pynq_tpu_torch.utils.profiling import span_totals
    except ImportError:                 # a program without spans
        return None
    s = span_totals().get("bnn.engine.fetch")
    if not s or not s["calls"]:
        return None
    return s["total_s"] * 1e6 / s["calls"]
