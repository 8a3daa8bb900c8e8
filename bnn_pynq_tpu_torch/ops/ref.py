"""Exact integer matmul and conv — the reference the kernels are held
against.

Port of `bnn_pynq_tpu/ops/ref.py`: `int_matmul_ref`, `binary_matmul_ref`
(the same dot on ±1 operands) and `conv2d_int_ref`. Operands are small
integers: |a| ≤ 128 (raw image) or ≤ 3 (levels), |w| ≤ 3, so
|acc| ≤ 27·128·3 for CNV's first conv and ≤ 2304·9 elsewhere.

- CPU: an int32 matmul, accumulating in int32 as the JAX reference does
  (`preferred_element_type=int32`); no partial sum comes near 2^31.
  (int64 is as exact and about 5× slower here.)
- CUDA: torch has no integer matmul there, so a float64 matmul rounded
  back to int32. Every product and partial sum is an integer far below
  2^53, so float64 holds it exactly (TF32 does not apply to float64).
"""

from __future__ import annotations

import torch


def int_matmul_ref(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a [M, K] integer · w [K, N] integer → int32 [M, N], exact."""
    if a.device.type == "cuda":
        return torch.matmul(a.to(torch.float64),
                            w.to(torch.float64)).round_().to(torch.int32)
    return torch.matmul(a.to(torch.int32), w.to(torch.int32))


def binary_matmul_ref(a_pm1: torch.Tensor,
                      w_pm1: torch.Tensor) -> torch.Tensor:
    """Binary (±1) matmul reference: int32 exact dot of ±1 operands."""
    return int_matmul_ref(a_pm1, w_pm1)


def conv2d_int_ref(x_vals: torch.Tensor, w_vals: torch.Tensor,
                   stride: int = 1) -> torch.Tensor:
    """Exact integer VALID conv: x [B, H, W, C] integer levels · w
    [kh, kw, C, O] (HWIO) integer levels → int32 [B, OH, OW, O].

    A sliding window and `int_matmul_ref`, not a float conv: cuDNN runs a
    float32 conv in TF32 by default, which is not exact."""
    # conv.py imports this module (through matmul.py), so not at the top
    from bnn_pynq_tpu_torch.ops.conv import sliding_window
    kh, kw, c, o = w_vals.shape
    patches = sliding_window(x_vals, kh, kw, stride)
    b, oh, ow, k = patches.shape
    acc = int_matmul_ref(patches.reshape(b * oh * ow, k),
                         w_vals.reshape(k, o))
    return acc.reshape(b, oh, ow, o)
