"""device_prep_share: the share of the rows the engine ran that went up
to the device as raw uint8 pixels, to be centred or binarized inside the
captured program, in %: the rows of the program's span
`bnn.engine.raw_input` over those of `bnn.engine.pad` (each chunk's true
rows). Spans record only while the traced slice's profiler runs; a
program without the raw path records no `bnn.engine.raw_input`."""


def read(rec):
    try:
        from bnn_pynq_tpu_torch.utils.profiling import span_totals
    except ImportError:                 # a program without spans
        return None
    t = span_totals()
    raw, ran = t.get("bnn.engine.raw_input"), t.get("bnn.engine.pad")
    if not raw or not ran or not ran["rows"]:
        return None
    return raw["rows"] * 100 / ran["rows"]
