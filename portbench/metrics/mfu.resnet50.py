"""mfu.resnet50: ResNet-50 v1.5's whole forward's share of the card's int8
peak: images x 2 x MACs per image (`yardstick_resnet50.network_macs`,
4,089,184,256 at width 1) over seconds x the peak, over the part of the
traced run's window before its traced slice (the profiler slows the
slice), or over the whole window."""

from portbench.yardstick import PEAK_INT8_OPS
from portbench.yardstick_resnet50 import network_macs


def read(rec):
    t = rec.trace
    if t is not None and t.pre_s > 0 and t.pre_counts.get("images"):
        images, seconds = t.pre_counts["images"], t.pre_s
    else:
        images, seconds = rec.window.images, rec.window.seconds
    if not images or seconds <= 0:
        return None
    ops = 2.0 * network_macs(rec.cell.config) * images
    return 100.0 * ops / (seconds * PEAK_INT8_OPS)
