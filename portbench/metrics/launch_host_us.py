"""launch_host_us: host-clock us that `InferenceEngine.launch_prepared`
takes per call (the lock, the program's lookup, its copy in, graph replay
and clone): the total seconds of the program's span `bnn.engine.launch`
over its calls (spans record only while the traced slice's profiler
runs)."""


def read(rec):
    try:
        from bnn_pynq_tpu_torch.utils.profiling import span_totals
    except ImportError:                 # a program without spans
        return None
    s = span_totals().get("bnn.engine.launch")
    if not s or not s["calls"]:
        return None
    return s["total_s"] * 1e6 / s["calls"]
