"""device_idle_share.serve: the share of the traced slice in which no
kernel, copy or set ran on the device (1 - the union of their intervals
over the slice's length)."""

from portbench.harness import busy_s


def read(rec):
    t = rec.trace
    if t is None or t.slice_s <= 0:
        return None
    return 100.0 * (1.0 - busy_s(t) / t.slice_s)
