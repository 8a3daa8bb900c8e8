"""MultiThreshold activation — integer threshold compare.

Port of `bnn_pynq_tpu/ops/thresholds.py`. Given an integer accumulator
`acc` and per-channel ascending thresholds `thr[nthr, N]`, the output code
is `code[..., n] = Σ_t (acc[..., n] >= thr[t, n])`, in {0..nthr}:
1-bit activations have nthr=1 (level 2c-1), 2-bit ones nthr=3 (level
2c-3), and MobileNet's unsigned 4-bit ones nthr=15 (level = code, the
output of a `QuantReLU`). Every compare is int32 against int32; nothing
goes through float.

The code is a count, so it does not depend on the order of a channel's
thresholds; the kernels' 15-threshold epilogue (`csrc/mma_tile.cuh`)
relies on the order all the same: it searches each channel's thresholds,
4 compares in place of 15, and needs them ascending. `sort_thresholds`
puts them so where parameters go onto a device (`models/params.py`), and
`threshold_search` counts the launches that search, and
`pooled_epilogue` those whose epilogue max-pooled 2×2 windows before
thresholding (exact for the same reason: a code never falls as its
accumulator grows).
"""

from __future__ import annotations

import numpy as np
import torch

from bnn_pynq_tpu_torch.ops._build import LaunchCounter

# The threshold count the kernels search instead of comparing each (4-bit
# codes); 1-3 thresholds are compared one by one, in any order.
SEARCHED_THRESHOLDS = 15

# Sentinel thresholds for degenerate channels (gamma == 0 in BN folding):
# acc is always < THR_NEVER and always >= THR_ALWAYS for any realistic
# accumulator magnitude (|acc| <= 3 * 128 * K_max << 2^30).
THR_NEVER = (1 << 30)
THR_ALWAYS = -(1 << 30)


def level_offset(abits: int) -> int:
    """Level = level_scale·code − offset: {0,1} → ±1 (abits=1), {0..3} →
    ±1, ±3 (abits=2), {0..15} → itself (abits=4, unsigned)."""
    if abits == 1:
        return 1
    if abits == 2:
        return 3
    if abits == 4:
        return 0
    raise ValueError(f"unsupported abits={abits}")


def level_scale(abits: int) -> int:
    """The code's multiplier in its level: 2 for the bipolar 1- and 2-bit
    codes, 1 for unsigned 4-bit ones."""
    level_offset(abits)               # raises on an unsupported width
    return 1 if abits == 4 else 2


def sort_thresholds(thr: np.ndarray) -> np.ndarray:
    """int32 [nthr, N] → the same table with each channel's thresholds
    ascending where nthr is SEARCHED_THRESHOLDS; any other table as it is.
    Gives the same codes as `thr` under `multithreshold`."""
    thr = np.array(thr, dtype=np.int32)
    if thr.ndim == 2 and thr.shape[0] == SEARCHED_THRESHOLDS:
        thr.sort(axis=0)
    return thr


# Kernel launches whose epilogue searched 15 sorted thresholds a channel
# (`conv_stack.conv_chain`, `conv_stack.dense_block`,
# `conv_direct.conv2d_direct`, `fused_mlp.fused_mlp_forward`);
# runtime/engine.py::kernel_launches reports it.
threshold_search = LaunchCounter()


# Kernel launches whose epilogue pooled each 2×2 window's accumulators
# before the thresholds (`conv_stack.conv_chain(pool=True)`'s last layer);
# runtime/engine.py::kernel_launches reports it.
pooled_epilogue = LaunchCounter()


def count_search(thr: torch.Tensor) -> None:
    """Count one kernel launch on `thr`, if its epilogue searches it."""
    if thr.shape[0] == SEARCHED_THRESHOLDS:
        threshold_search.add()


def multithreshold(acc: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """acc: int32 [..., N]; thr: int32 [nthr, N] → int8 codes [..., N]."""
    if acc.dtype != torch.int32 or thr.dtype != torch.int32:
        raise TypeError(f"multithreshold compares int32 with int32, got "
                        f"{acc.dtype} and {thr.dtype}")
    code = (acc >= thr[0]).to(torch.int8)
    for i in range(1, thr.shape[0]):
        code += (acc >= thr[i]).to(torch.int8)
    return code


def codes_to_values(codes: torch.Tensor, abits: int) -> torch.Tensor:
    """Codes → the integer levels the next layer consumes (int8):
    abits=1: {0,1} → {-1,+1}; abits=2: {0..3} → {-3,-1,1,3}; abits=4:
    {0..15} → themselves."""
    off = level_offset(abits)
    return (level_scale(abits) * codes.to(torch.int8) - off).to(torch.int8)
