"""images_per_s: uint8 images in host memory to class indices in host
memory, over the whole window, from the first call to the last answer."""


def read(rec):
    w = rec.window
    return w.images / w.seconds if w.seconds > 0 and w.images else None
