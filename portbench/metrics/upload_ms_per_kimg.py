"""upload_ms_per_kimg: host-clock ms that `InferenceEngine.upload` (the
host-to-device copy of a padded batch) takes per 1024 rows copied: the
total seconds of the program's span `bnn.engine.upload` over its rows
(spans record only while the traced slice's profiler runs)."""


def read(rec):
    try:
        from bnn_pynq_tpu_torch.utils.profiling import span_totals
    except ImportError:                 # a program without spans
        return None
    s = span_totals().get("bnn.engine.upload")
    if not s or not s["rows"]:
        return None
    return s["total_s"] * 1e3 / (s["rows"] / 1024)
