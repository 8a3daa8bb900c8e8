"""Reference accuracy table (BASELINE.md) and the Δ≤0.1% gate.

Copied from `bnn_pynq_tpu/utils/baseline.py` (no framework code). Values
are the upstream Xilinx/BNN-PYNQ README / FINN-paper accuracies (see
BASELINE.md for their provenance).
"""

from __future__ import annotations

# (network base, dataset) -> published top-1 accuracy
REFERENCE_TOP1 = {
    ("lfc-w1a1", "mnist"): 0.984,
    ("lfc-w1a2", "mnist"): 0.985,
    ("sfc-w1a1", "mnist"): 0.958,
    ("cnv-w1a1", "cifar10"): 0.795,
    ("cnv-w1a2", "cifar10"): 0.827,
    ("cnv-w2a2", "cifar10"): 0.843,
    ("cnv-w1a1", "svhn"): 0.949,
    ("cnv-w2a2", "svhn"): 0.970,
    ("cnv-w1a1", "gtsrb"): 0.965,
    ("cnv-w2a2", "gtsrb"): 0.984,
}

GATE_DELTA = 0.001   # Δ≤0.1% (BASELINE.md "Targets for the rebuild")


def network_base(name: str) -> str:
    """'cnv-w1a1-svhn' → 'cnv-w1a1'."""
    parts = name.split("-")
    return "-".join(parts[:2]) if len(parts) >= 2 else name


def baseline_top1(network_name: str, dataset: str):
    return REFERENCE_TOP1.get((network_base(network_name), dataset))


def gate(network_name: str, dataset: str, top1: float):
    """Returns (passed: bool | None, baseline: float | None, delta).
    passed is None when no baseline exists for this pair."""
    ref = baseline_top1(network_name, dataset)
    if ref is None:
        return None, None, None
    delta = top1 - ref
    return delta >= -GATE_DELTA, ref, delta
