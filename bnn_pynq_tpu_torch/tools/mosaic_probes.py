"""Run the seven Mosaic probes on the port's kernels: one PASS or FAIL line
each, after the backend's name.

    python -m bnn_pynq_tpu_torch.tools.mosaic_probes [--device cuda|cpu]

Port of `tools/mosaic_probes.py`'s entry point, with its labels. On the
TPU a probe passed when its Pallas kernel lowered and ran; here when its
CUDA kernel (`csrc/mosaic_probes.cu`) built, launched and its output
reached the host. `--device cpu` runs the plain versions. A probe's error
is caught and printed as its FAIL line, as the JAX tool does; a device
that is not there raises before any probe runs. Exits 1 if a probe
failed.
"""

from __future__ import annotations

import argparse
import sys
from functools import partial

import torch

from bnn_pynq_tpu_torch.ops import probes

LABELS = (
    ("lane_concat(9x[M,64] -> [M,576] + dot)", probes.probe_lane_concat),
    ("scratch_lane_store(64-lane offsets)", probes.probe_scratch_lane_store),
    ("mid_dim_index(reshape+[:,0,:])", probes.probe_mid_dim_index),
    ("pool_reshape_max(full 2x2 pool)", probes.probe_pool_reshape_max),
    ("strided_row_slice(stride 2)", probes.probe_strided_row_slice),
    ("lane_slice_64(read [:,64:128])", probes.probe_lane_slice_64),
    ("int32_acc_reshape(max over mid dim)", probes.probe_int32_acc_reshape),
)


def run(name: str, fn) -> bool:
    """Run one probe to its host copy; print PASS, or FAIL and the first
    line of the error."""
    try:
        fn().cpu()
        print(f"PASS {name}")
        return True
    except Exception as e:  # noqa: BLE001 — the tool reports every probe
        msg = str(e).split("\n")[0][:200]
        print(f"FAIL {name}: {msg}")
        return False


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="bnn_pynq_tpu_torch.tools.mosaic_probes")
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (the plain versions)")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda but CUDA is not available; "
                               "pass --device cpu for the plain versions")
        backend = torch.cuda.get_device_name(device)
    elif device.type == "cpu":
        backend = "cpu"
    else:
        raise ValueError(f"unsupported device {device}")
    print("backend:", backend)
    passed = [run(name, partial(fn, device=device)) for name, fn in LABELS]
    return 0 if all(passed) else 1


if __name__ == "__main__":
    sys.exit(main())
