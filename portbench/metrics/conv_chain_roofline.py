"""conv_chain_roofline: the share of its roofline that the kernels
computing the first four convs of CNV (layers 0, 1, 3, 4) reach in the
traced slice. Bound: their operations at the int8 peak or their bytes at
the memory rate, whichever is larger (`yardstick.conv_chain_bound_ms`),
at the images a forward holds; time: the device time of the kernels whose
name matches KERNELS, per forward. No matching kernel: nothing read."""

import re

from portbench.yardstick import conv_chain_bound_ms

KERNELS = re.compile(r"\bconv_kernel\b")
FIRST, LAST = 0, 4                 # `layers` indices: conv0-1, conv3-4


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
    return 100.0 * conv_chain_bound_ms(rec.cell.config, batch, FIRST,
                                       LAST) / ms
