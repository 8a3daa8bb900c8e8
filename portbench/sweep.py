"""Find the knee of a serving cell: its open-loop window at each of a
list of rates, in one process (one set-up), with the cell's traffic mix
otherwise unchanged.

    python3 portbench/sweep.py --workload lfc-w1a1.serve --seed 7 \\
        --seconds 8 --rates 1000,2000,4000

Prints one JSON line per rate: requests, unanswered, p50 / p99 latency
from the due time, the generator's lag (p50, p99), the mean batch, and
`growth_ms`: the median latency of the window's last quarter of requests
minus its first quarter's (a backlog that grows shows here). The knee is
the highest rate below the first at which a request goes unanswered, the
growth passes 1 ms or the generator's p99 lag passes 5 ms.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    from portbench import harness
    cell = harness.load_cell(args.workload)
    kind = cell.kind
    harness.build_program()
    rates = [float(r) for r in args.rates.split(",")]
    state_box = [None]                  # the server, once set up
    try:
        _sweep(cell, kind, args, rates, state_box)
    finally:
        if state_box[0] is not None:
            kind.release(state_box[0])
    return 0


def _sweep(cell, kind, args, rates, state_box):
    import numpy as np
    from portbench import harness
    from portbench.yardstick import percentile
    for i, rate in enumerate(rates):
        ctx = harness.make_ctx(cell, args.seed + i, args.seconds,
                               "cuda", {"rate_per_s": rate})
        inp = kind.inputs(ctx)
        if state_box[0] is None:
            state_box[0] = kind.setup(ctx, inp)
        win = kind.window(state_box[0], inp, ctx,
                          harness.Tracer(False, args.seconds))
        lat, lag = win.latencies_ms, win.lag_ms
        q = max(1, len(lat) // 4)
        c = win.counters
        print(json.dumps({
            "rate_per_s": rate, "requests": len(lat),
            "unanswered": win.failed,
            "p50_ms": percentile(lat, 50), "p99_ms": percentile(lat, 99),
            "lag_p50_ms": percentile(lag, 50),
            "lag_p99_ms": percentile(lag, 99),
            "mean_gap_ms": 1e3 / rate,
            "growth_ms": float(np.median(lat[-q:]) - np.median(lat[:q])),
            "mean_batch": c["server_images"] / max(1, c["server_batches"]),
        }), flush=True)
        time.sleep(0.5)


if __name__ == "__main__":
    sys.path[0] = ROOT
    sys.exit(main())
