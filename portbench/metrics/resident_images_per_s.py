"""resident_images_per_s: images classified over the whole window, from
the first launch to the last fetch (device-resident frames)."""


def read(rec):
    w = rec.window
    return w.images / w.seconds if w.seconds > 0 and w.images else None
