"""Run one cell of BENCHMARK.json once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

From the root of a checkout that holds the port (`bnn_pynq_tpu_torch`),
on a machine with the CUDA devices the cell asks for; without them it
exits with code 2 and prints no result. The last line of standard output
is the result's JSON object; the last lines of standard error are the
compared numbers, each beside its limit.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from portbench import harness
    return harness.main(args, T_START)


if __name__ == "__main__":
    sys.path[0] = ROOT
    sys.exit(main())
