"""resblock_roofline: the share of its roofline that ResNet-50's 16
block-closing 1x1 convs with their shortcut reach in the traced slice.
Bound: each block's last product (and its projection's, where it has one)
at the int8 peak or its codes read (the 3x3 conv's, the shortcut's) and
written at the memory rate, whichever is larger, summed
(`yardstick_resnet50.resblock_bound_ms`), at the images a forward holds;
time: the device time of the kernels named with a residual template
argument, `dense_kernel<…, 1>` (the identity's codes added in the
epilogue) and `dense_kernel<…, 2>` (the projection in the K loop;
csrc/dense_block.cu), per forward. No such kernel: nothing read."""

import re

from portbench.yardstick_resnet50 import resblock_bound_ms

KERNELS = re.compile(r"\bdense_kernel<\s*(?:true|false)\s*,\s*[12]\s*>")


def read(rec):
    t = rec.trace
    forwards = t.counts.get("forwards") if t is not None else None
    if not forwards:
        return None
    ms = sum(d for name, _, _, d in t.device if KERNELS.search(name)) \
        * 1e-3 / forwards
    if ms <= 0:
        return None
    batch = t.counts["images"] / forwards
    return 100.0 * resblock_bound_ms(rec.cell.config, batch) / ms
