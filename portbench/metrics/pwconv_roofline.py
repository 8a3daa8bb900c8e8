"""pwconv_roofline: the share of their roofline that MobileNet-v1's 13
pointwise (1x1) convs reach in the traced slice. Bound: each layer's
operations at the int8 peak or its codes read and written at the memory
rate, whichever is larger, summed (`yardstick_mobilenet.kind_bound_ms`),
at the images a forward holds; time: the device time of the kernels named
`dense_kernel` (csrc/dense_block.cu, which in this network runs the 1x1
convs and nothing else), per forward. No such kernel: nothing read."""

import re

from portbench.yardstick_mobilenet import kind_bound_ms

KERNELS = re.compile(r"\bdense_kernel\b")


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
    return 100.0 * kind_bound_ms(rec.cell.config, "pwconv", batch) / ms
