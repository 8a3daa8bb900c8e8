"""fused_mlp_roofline: the share of its roofline that `fused_mlp` reaches
on an all-dense network (LFC, SFC: the whole net is one launch) in the
traced slice. Bound: every dense layer's operations at the int8 peak or
the first layer's input and the logits' bytes at the memory rate,
whichever is larger, at the images a forward holds; time: the device
time of the kernels whose name matches KERNELS, per forward. No matching
kernel, or a network with convs: nothing read."""

import re

from portbench.yardstick import bound_ms, layer_macs

KERNELS = re.compile(r"\bmlp_kernel\b")


def read(rec):
    t = rec.trace
    layers = layer_macs(rec.cell.config)
    forwards = t.counts.get("forwards") if t is not None else None
    if not forwards or any(x["kind"] != "dense" for x in layers):
        return None
    ms = sum(d for name, _, _, d in t.device if KERNELS.search(name)) \
        * 1e-3 / forwards
    if ms <= 0:
        return None
    batch = t.counts["images"] / forwards
    ops = 2 * batch * sum(x["macs"] for x in layers)
    nbytes = batch * (layers[0]["in"] + 4 * layers[-1]["out"])
    return 100.0 * bound_ms(ops, nbytes) / ms
