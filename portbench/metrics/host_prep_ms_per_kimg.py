"""host_prep_ms_per_kimg: host-clock ms that `Classifier.prepare` takes
per 1024 images (the harness's span around each call in the window)."""


def read(rec):
    spans = rec.spans.get("pb.prepare")
    if not spans or not rec.window.images:
        return None
    return sum(spans) * 1e3 / (rec.window.images / 1024)
