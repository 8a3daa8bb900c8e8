"""MultiThreshold activation — integer threshold compare.

Port of `bnn_pynq_tpu/ops/thresholds.py`. Given an integer accumulator
`acc` and per-channel ascending thresholds `thr[nthr, N]`, the output code
is `code[..., n] = Σ_t (acc[..., n] >= thr[t, n])`, in {0..nthr}:
1-bit activations have nthr=1 (level 2c-1), 2-bit ones nthr=3 (level
2c-3), and MobileNet's unsigned 4-bit ones nthr=15 (level = code, the
output of a `QuantReLU`). ResNet-50's 2-bit codes are unsigned too (level
= code, nthr=3), which the width does not say: its config states it
(`NetworkConfig.unsigned`), and `codes_are_levels` of the width and that
flag is the one rule. Every compare is int32 against int32; nothing goes
through float.

The code is a count, so it does not depend on the order of a channel's
thresholds; the kernels' 15-threshold epilogue (`csrc/mma_tile.cuh`)
relies on the order all the same: it searches each channel's thresholds,
4 compares in place of 15, and needs them ascending. `sort_thresholds`
puts them so where parameters go onto a device (`models/params.py`), and
`threshold_search` counts the launches that search,
`pooled_epilogue` those whose epilogue max-pooled 2×2 windows before
thresholding (exact for the same reason: a code never falls as its
accumulator grows), and `residual_epilogue` those whose accumulator took
a bottleneck block's shortcut before thresholding.
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


def level_offset(abits: int, unsigned: bool = False) -> int:
    """Level = level_scale·code − offset: bipolar {0,1} → ±1 (abits=1),
    {0..3} → ±1, ±3 (abits=2); unsigned codes are their own levels
    (offset 0): {0..3} (abits=2, `unsigned`) and {0..15} (abits=4, which
    is unsigned only)."""
    if abits == 1:
        if unsigned:
            raise ValueError("1-bit codes are bipolar only")
        return 1
    if abits == 2:
        return 0 if unsigned else 3
    if abits == 4:
        return 0
    raise ValueError(f"unsupported abits={abits}")


def level_scale(abits: int, unsigned: bool = False) -> int:
    """The code's multiplier in its level: 2 for bipolar codes, 1 for
    unsigned ones."""
    return 1 if codes_are_levels(abits, unsigned) else 2


def codes_are_levels(abits: int, unsigned: bool = False) -> bool:
    """Codes of this width and signedness are their own levels: the
    kernels then take them as levels, with no correction (raises on an
    unsupported width)."""
    return level_offset(abits, unsigned) == 0


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


# Kernel launches that added a bottleneck block's shortcut to the
# accumulator before the thresholds (`conv_stack.dense_residual`: the
# identity's codes in the epilogue, or the projection's product in the
# K loop): 16 a ResNet-50 forward; runtime/engine.py::kernel_launches
# reports it.
residual_epilogue = LaunchCounter()


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


def codes_to_values(codes: torch.Tensor, abits: int,
                    unsigned: bool = False) -> torch.Tensor:
    """Codes → the integer levels the next layer consumes (int8):
    abits=1: {0,1} → {-1,+1}; abits=2: {0..3} → {-3,-1,1,3}, or with
    `unsigned` themselves; abits=4: {0..15} → themselves."""
    off = level_offset(abits, unsigned)
    return (level_scale(abits, unsigned) * codes.to(torch.int8)
            - off).to(torch.int8)
