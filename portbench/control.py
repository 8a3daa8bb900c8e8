"""The control of `correct`: the configuration's plain reference (its
`reference` module) put in the program's place, with its float32 output
arithmetic (for `bnn`, scale and bias on the int32 accumulators) computed
in bfloat16, the nearest precision below.

    python3 portbench/control.py --workload cnv-w1a1.resident \\
        --seeds 11,12,13

For each seed it makes the cell's inputs as a run does and reads, over
every image of the cell's pool (every input a run's window answers,
each once), the same numbers a run compares: the widest gap of the
control's class below the reference's best, and how many of its classes
differ from the reference's. A control that does not fail a run's limit
is no control: the limit must lie below its smallest reading.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(cell, seed: int, device: str) -> dict:
    import torch
    from portbench import harness
    from portbench.reference import judge
    ctx = harness.make_ctx(cell, seed, 1.0, device)
    inp = cell.kind.inputs(ctx)
    x = cell.kind.reference_inputs(inp)
    reference = cell.reference
    net = reference.load(ctx.artifact)
    ref = reference.forward(net, x, device=device).cpu().numpy()
    ctl = reference.forward(net, x, device=device, dtype=torch.bfloat16) \
        .float().argmax(1).cpu()
    ids = torch.arange(x.shape[0]).numpy()
    widest, invalid = judge.widest_gap(ref, [(ids, ctl.numpy())])
    return {"seed": seed, "images": int(x.shape[0]),
            "control_widest_gap": widest,
            "control_changed": int((ctl.numpy() != ref.argmax(1)).sum()),
            "invalid_class": invalid,
            "limit": cell.config["limits"]["widest_gap"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    from portbench import harness
    cell = harness.load_cell(args.workload)
    for s in args.seeds.split(","):
        print(json.dumps(dict(readings(cell, int(s), "cuda"),
                              workload=args.workload)), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = ROOT
    sys.exit(main())
