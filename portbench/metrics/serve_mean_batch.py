"""serve_mean_batch: images per batch the server ran in the window, from
`BatchingServer.stats` (images and batches) differenced over it."""


def read(rec):
    c = rec.window.counters
    b = c.get("server_batches", 0)
    return c["server_images"] / b if b else None
