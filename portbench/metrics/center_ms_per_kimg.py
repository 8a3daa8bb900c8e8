"""center_ms_per_kimg: host-clock ms that the classifier's centring
(`native.center_int8`, or the bipolar threshold) takes per 1024 images:
the seconds of the program's span `bnn.classifier.center` over the
rows it handled (spans record only while the traced slice's profiler
runs)."""


def read(rec):
    try:
        from bnn_pynq_tpu_torch.utils.profiling import span_totals
    except ImportError:                 # a program without spans
        return None
    s = span_totals().get("bnn.classifier.center")
    if not s or not s["rows"]:
        return None
    return s["total_s"] * 1e3 / (s["rows"] / 1024)
